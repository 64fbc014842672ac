"""Batched ray-scene intersection: the framework's hottest op.

An array form of the reference's per-thread linear scan over primitives
(reference scene.h:71-94 calling primitive.h:39-45 per sphere): instead of
one ray walking all spheres sequentially, ALL rays test ALL spheres at
once, with the two ray-dependent dot products phrased as (N,3)x(3,P)
contractions:

    b      = (c - o)·d        = d @ cᵀ - (o·d)
    |op|²  = |c - o|²         = |c|² - 2·(o @ cᵀ) + |o|²
    det    = b² - |op|² + r²

In float32 every form of this quadratic loses ~1e-2 in t on the
reference's 1e5-radius wall spheres, and different forms lose it
differently: on the Cornell scene, computing op = c - o first instead
shifts the image mean by -0.25% (measured on an H100). The persistent
kernel (ops/pallas/persistent.py) therefore evaluates this same expanded
form, so the two render paths agree in distribution.

The closest-hit reduction (the scan's shrinking tmax, scene.h:78-80)
becomes a min/argmin over the primitive axis. Hit-attribute lookup uses
one-hot contractions over the (small) primitive table.

The sphere quadratic root selection replicates primitive.h:44 exactly:
take t0=b-sqrt(det) if tmin<t0<tmax, else t1=b+sqrt(det) if tmin<t1<tmax
(note: t0>tmax does NOT fall through to t1 — reference semantics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from pathtracer.utils.pytree import pytree_dataclass
from pathtracer.models.scene import EPSILON, PrimAttrs, Scene
from pathtracer.ops import vecmath as vm

# Finite stand-in for FLT_MAX (reference globals.h:59); keeps inf-inf NaNs
# out of reverse-mode autodiff.
BIG = 1e30


def _mm(a: Array, b: Array) -> Array:
    """f32-accurate matmul. JAX's default matmul precision may run a float32
    product in TF32 on the GPU; the sphere quadratic (and exact one-hot
    gathers) need full float32, so these contractions explicitly request
    HIGHEST precision."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@pytree_dataclass
class Hit:
    """SoA intersection record (reference scene.h:45-64 `Intersection`)."""

    t: Array  # (N,) hit distance, BIG on miss
    prim: Array  # (N,) int32 primitive index (0 on miss)
    hit: Array  # (N,) bool
    p: Array  # (N, 3) hit point
    n: Array  # (N, 3) outward geometric normal
    center: Array  # (N, 3) hit sphere center (for area-light pdfs)
    radius: Array  # (N,) hit sphere radius
    albedo: Array  # (N, 3) material color
    coef: Array  # (N,) material coefficient (specular scale / IOR)
    mtype: Array  # (N,) int32 material type
    emission: Array  # (N, 3) emitted radiance of the hit prim
    mat: Array  # (N,) int32 material id (tri-light MIS routing)


def ray_sphere_t(
    scene: Scene, o: Array, d: Array, tmin: float = EPSILON, tmax: float = BIG
) -> Array:
    """Per (ray, prim) hit distance, (N, P); BIG where missed."""
    c = scene.centers  # (P,3)
    r2 = scene.radii * scene.radii  # (P,)

    dc = _mm(d, c.T)  # (N,P)
    oc = _mm(o, c.T)  # (N,P)
    od = vm.dot(o, d)[:, None]  # (N,1)
    o2 = vm.length_sq(o)[:, None]  # (N,1)
    c2 = vm.length_sq(c)[None, :]  # (1,P)

    b = dc - od
    op2 = c2 - 2.0 * oc + o2
    det = b * b - op2 + r2[None, :]
    sq = vm.safe_sqrt(det)
    t0 = b - sq
    t1 = b + sq

    t = jnp.where(
        t0 > tmin,
        jnp.where(t0 < tmax, t0, BIG),
        jnp.where((t1 > tmin) & (t1 < tmax), t1, BIG),
    )
    miss = (det < 0.0) | ~scene.prim_valid[None, :]
    return jnp.where(miss, BIG, t)


def intersect_p(
    scene: Scene, o: Array, d: Array, tmin: float = EPSILON,
    tmax: Array | float = BIG,
) -> Array:
    """Any-hit shadow test (reference scene.h:101-108 IntersectP).

    tmax may be per-ray (N,) for visibility segments (light.h:23-32).
    Returns (N,) bool: True if anything occludes.
    """
    tmax_arr = jnp.asarray(tmax)
    if tmax_arr.ndim == 0:
        tmax_arr = jnp.full(o.shape[:-1], tmax_arr)
    t = ray_sphere_t(scene, o, d, tmin=tmin)
    occluded = jnp.any(t < tmax_arr[:, None], axis=-1)
    if scene.mesh is not None:
        from pathtracer.ops.triangle import intersect_mesh

        th = intersect_mesh(
            scene.mesh, o, d, tmin=tmin, tmax=tmax_arr, any_hit=True
        )
        occluded = occluded | (th.t < tmax_arr)
    return occluded


def intersect(
    scene: Scene,
    attrs: PrimAttrs,
    o: Array,
    d: Array,
    tmin: float = EPSILON,
    tmax: float = BIG,
) -> Hit:
    """Closest-hit query with gathered shading attributes.

    o, d: (N,3) ray origins/directions. Equivalent to scene.h:71-94 plus the
    attribute lookups the megakernel did through pointers
    (pathtracer.cu:126-129).
    """
    t_np = ray_sphere_t(scene, o, d, tmin=tmin, tmax=tmax)  # (N,P)
    t = jnp.min(t_np, axis=-1)
    idx = jnp.argmin(t_np, axis=-1).astype(jnp.int32)
    hit = t < (0.5 * BIG)

    # One-hot gather of per-prim data as a contraction.
    P = scene.centers.shape[0]
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (o.shape[0], P), 1) == idx[:, None]
    ).astype(o.dtype)

    center = _mm(one_hot, scene.centers)  # (N,3)
    radius = _mm(one_hot, scene.radii)  # (N,)
    albedo = _mm(one_hot, attrs.albedo)
    emission = _mm(one_hot, attrs.emission)
    coef = _mm(one_hot, attrs.coef)
    mtype = _mm(one_hot, attrs.mtype.astype(o.dtype)).astype(jnp.int32)
    mat = _mm(one_hot, scene.material_id.astype(o.dtype)).astype(jnp.int32)

    # Miss lanes get a unit-distance dummy point instead of o + d*BIG: the
    # huge coordinate would overflow (inf) in downstream distance math and
    # poison gradients through jnp.where (NaN * 0); all its contributions
    # are masked by `hit` anyway.
    p = o + d * jnp.where(hit, t, 1.0)[:, None]
    # Outward normal (p-c)/r (reference primitive.h:74); safe on miss lanes.
    n = (p - center) / jnp.maximum(radius, 1e-12)[:, None]

    if scene.mesh is not None:
        (t, idx, hit, p, n, center, radius, albedo, coef, mtype,
         emission, mat) = _merge_mesh_hit(
            scene, o, d, tmin,
            t, idx, hit, p, n, center, radius, albedo, coef, mtype, emission,
            mat,
        )

    return Hit(
        t=t, prim=idx, hit=hit, p=p, n=n, center=center, radius=radius,
        albedo=albedo, coef=coef, mtype=mtype, emission=emission, mat=mat,
    )


def _merge_mesh_hit(scene, o, d, tmin,
                    t, idx, hit, p, n, center, radius,
                    albedo, coef, mtype, emission, mat):
    """Fold triangle-mesh hits into the sphere hit record (closest wins).

    Triangle shading attributes come from the material tables via the
    per-triangle material id; textured materials resolve albedo through the
    texture atlas (config 4). Triangles whose material backs a TRI_LIGHT
    emit that light's intensity from their front face (a superset of the
    reference's sphere-only light model, light.h:40-44).
    """
    from pathtracer.ops.texture import sample_bilinear

    mesh = scene.mesh
    from pathtracer.ops.triangle import intersect_mesh

    th = intersect_mesh(mesh, o, d, tmin=tmin)
    closer = th.t < t
    tn = jnp.take(mesh.n_geom, th.tri, axis=0)
    tmat = jnp.take(mesh.material_id, th.tri, axis=0)
    th_t = th.t
    th_tri = th.tri
    uv = (
        jnp.take(mesh.uv0, th.tri, axis=0)
        + th.u[:, None] * jnp.take(mesh.uv_e1, th.tri, axis=0)
        + th.v[:, None] * jnp.take(mesh.uv_e2, th.tri, axis=0)
    )

    t_albedo = scene.mat_color[tmat]
    t_coef = scene.mat_coef[tmat]
    t_mtype = scene.mat_type[tmat]
    if scene.textures is not None:
        # Texture MODULATES the material's base color (tex * A): standard
        # base-color semantics, and it keeps the albedo linear in
        # mat_color so the replay adjoint's dw/dA = w/A identity holds on
        # textured vertices too (diff/replay.py).
        tex_id = scene.mat_texture[tmat]
        tex_rgb = sample_bilinear(scene.textures, tex_id, uv)
        t_albedo = jnp.where(
            (tex_id >= 0)[:, None], tex_rgb * t_albedo, t_albedo
        )

    cl = closer[:, None]
    tp = o + d * jnp.where(th_t < 0.5 * BIG, th_t, 1.0)[:, None]
    t_out = jnp.where(closer, th_t, t)
    # mesh prims live in a separate index space; offset past the spheres
    idx_out = jnp.where(closer, scene.centers.shape[0] + th_tri, idx)
    hit_out = hit | closer
    p_out = jnp.where(cl, tp, p)
    n_out = jnp.where(cl, tn, n)
    center_out = jnp.where(cl, tp, center)  # degenerate sphere for tri hits
    radius_out = jnp.where(closer, 0.0, radius)
    albedo_out = jnp.where(cl, t_albedo, albedo)
    coef_out = jnp.where(closer, t_coef, coef)
    mtype_out = jnp.where(closer, t_mtype, mtype)
    mat_out = jnp.where(closer, tmat, mat)
    if scene.has_tri_lights:
        # emission-by-material map, differentiable w.r.t. light_intensity
        # (inverse rendering of emitter power works on tri lights too)
        from pathtracer.models.scene import TRI_LIGHT

        is_tl = ((scene.light_type == TRI_LIGHT)
                 & scene.light_valid)[:, None].astype(emission.dtype)
        M = scene.mat_color.shape[0]
        lm = jnp.clip(scene.light_mat, 0, M - 1)
        em_by_mat = jnp.zeros((M, 3), emission.dtype).at[lm].add(
            scene.light_intensity * is_tl
        )
        t_emission = em_by_mat[tmat]
    else:
        t_emission = jnp.zeros_like(emission)
    emission_out = jnp.where(cl, t_emission, emission)
    return (t_out, idx_out, hit_out, p_out, n_out, center_out, radius_out,
            albedo_out, coef_out, mtype_out, emission_out, mat_out)
