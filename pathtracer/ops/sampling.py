"""Monte Carlo sampling routines, vectorized over lanes.

Array forms of the reference's per-thread device sampling
(reference montecarlo.h:76-159). Where the reference branches per CUDA
thread, we compute all regions and select with `jnp.where` — branch-free
lane math.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from pathtracer.ops import vecmath as vm

PI = jnp.pi
INV_PI = 1.0 / jnp.pi


def concentric_sample_disk(u1: Array, u2: Array) -> tuple[Array, Array]:
    """Shirley square->disk mapping (reference montecarlo.h:76-118).

    Same four-region mapping, expressed as masked lane selects. The
    reference's `8 + sy/r` region offset is a full turn (8 * pi/4 = 2*pi),
    so it is dropped — cos/sin are unchanged.
    """
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0

    def safe_div(a, b):
        return a / jnp.where(jnp.abs(b) > 0.0, b, 1.0)

    in_r12 = sx >= -sy
    in_r1 = in_r12 & (sx > sy)
    in_r2 = in_r12 & ~in_r1
    in_r3 = ~in_r12 & (sx <= sy)
    in_r4 = ~in_r12 & ~(sx <= sy)

    r = jnp.where(in_r1, sx, 0.0)
    r = jnp.where(in_r2, sy, r)
    r = jnp.where(in_r3, -sx, r)
    r = jnp.where(in_r4, -sy, r)

    theta = jnp.where(in_r1, safe_div(sy, sx), 0.0)
    theta = jnp.where(in_r2, 2.0 - safe_div(sx, sy), theta)
    theta = jnp.where(in_r3, 4.0 + safe_div(sy, sx), theta)
    theta = jnp.where(in_r4, 6.0 - safe_div(sx, sy), theta)
    theta = theta * (PI / 4.0)

    degenerate = (sx == 0.0) & (sy == 0.0)
    dx = jnp.where(degenerate, 0.0, r * jnp.cos(theta))
    dy = jnp.where(degenerate, 0.0, r * jnp.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1: Array, u2: Array, n: Array) -> Array:
    """Cosine-weighted hemisphere sample around normal n, pdf = cos(theta)/pi.

    Reference montecarlo.h:127-133 semantics, with a properly normalized
    tangent frame (see vecmath.orthonormal_basis).
    """
    dx, dy = concentric_sample_disk(u1, u2)
    dz = vm.safe_sqrt(1.0 - dx * dx - dy * dy)
    local = jnp.stack([dx, dy, dz], axis=-1)
    return vm.normalize(vm.to_world(local, n))


def uniform_sample_sphere(u1: Array, u2: Array) -> Array:
    """Uniform direction on S^2 (reference montecarlo.h:135-142)."""
    z = 1.0 - 2.0 * u1
    r = vm.safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf() -> float:
    return 1.0 / (4.0 * PI)


def uniform_sample_cone(
    u1: Array, u2: Array, cos_theta_max: Array, x: Array, y: Array, z: Array
) -> Array:
    """Uniform direction in the cone around z with half-angle acos(cos_theta_max).

    Reference montecarlo.h:144-150. x,y,z are the (...,3) cone frame axes;
    cos_theta_max broadcasts over leading dims.
    """
    cos_t = vm.lerp(u1, cos_theta_max, jnp.ones_like(cos_theta_max))
    sin_t = vm.safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2
    return (
        x * (jnp.cos(phi) * sin_t)[..., None]
        + y * (jnp.sin(phi) * sin_t)[..., None]
        + z * cos_t[..., None]
    )


def uniform_cone_pdf(cos_theta_max: Array) -> Array:
    """Solid-angle pdf of the uniform cone (reference montecarlo.h:152-154)."""
    return 1.0 / (2.0 * PI * jnp.maximum(1.0 - cos_theta_max, 1e-12))


def make_distribution_1d(weights: Array) -> tuple[Array, Array]:
    """Build a 1D sampling distribution from nonnegative weights.

    Live implementation of the reference's fully-commented-out pbrt
    `Distribution1D` (montecarlo.h:28-74): returns (cdf, pdf) with
    cdf[0]=0, cdf[n]=1. All-zero weights degrade to uniform, like the
    reference's funcInt==0 branch.
    """
    w = jnp.maximum(weights, 0.0)
    total = jnp.sum(w)
    n = w.shape[0]
    uniform = jnp.full((n,), 1.0 / n)
    pdf = jnp.where(total > 0.0, w / jnp.where(total > 0.0, total, 1.0), uniform)
    cdf = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(pdf)])
    return cdf, pdf


def sample_distribution_1d(cdf: Array, pdf: Array, u: Array) -> tuple[Array, Array]:
    """Sample indices from a make_distribution_1d table.

    u: (...,) uniforms. Returns (index, pdf[index]) — the reference's
    SampleDiscrete (montecarlo.h:59-64), vectorized (the lower_bound
    becomes a comparison count, branch-free lane math).
    """
    n = pdf.shape[0]
    # index = #{ k : cdf[k+1] <= u }  == lower_bound(cdf, u) - 1, clamped
    idx = jnp.sum(
        (cdf[1:][None, :] <= u[..., None]).astype(jnp.int32), axis=-1
    )
    idx = jnp.clip(idx, 0, n - 1)
    return idx, jnp.take(pdf, idx)


def power_heuristic(nf: Array, f_pdf: Array, ng: Array, g_pdf: Array) -> Array:
    """Beta=2 power heuristic for MIS (reference montecarlo.h:156-159)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, f * f / jnp.where(denom > 0.0, denom, 1.0), 0.0)


def stratified_pixel_jitter(u: Array, v: Array, spp: int) -> tuple[Array, Array]:
    """Map per-sample uniforms to stratified sub-pixel offsets in [-0.5, 0.5].

    Generalizes the reference's hard-coded 2x2 quadrant jitter
    (reference pathtracer.cu:33-54): for spp = k*k the pixel is split into a
    k x k grid and sample s jitters uniformly within its cell; non-square spp
    falls back to plain center jitter. For spp=4 this covers exactly the four
    quadrants the reference's sign table does.

    u, v: (..., spp) uniforms in [0,1). Returns offsets of the same shape.
    """
    k = int(round(spp ** 0.5))
    if k * k == spp and k > 1:
        s = jnp.arange(spp)
        cx = (s % k).astype(u.dtype)
        cy = (s // k).astype(u.dtype)
        ox = (cx + u) / k - 0.5
        oy = (cy + v) / k - 0.5
        return ox, oy
    return u - 0.5, v - 0.5


def stratified_jitter_for_sample(
    u: Array, v: Array, s: Array, spp: int
) -> tuple[Array, Array]:
    """Per-lane form of `stratified_pixel_jitter`: s is the (n,) subsample
    index of each lane (lane layout is defined in integrator.trace_pixels)."""
    k = int(round(spp ** 0.5))
    if k * k == spp and k > 1:
        cx = (s % k).astype(u.dtype)
        cy = (s // k).astype(u.dtype)
        return (cx + u) / k - 0.5, (cy + v) / k - 0.5
    return u - 0.5, v - 0.5
