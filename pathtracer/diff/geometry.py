r"""Geometry gradients: sphere centers / radii via silhouette edge sampling.

The detached-sampling estimators (diff/replay.py, diff/score.py) cover
parameters the integrand is SMOOTH in (albedo, emission, IOR direction
term). Geometry is different: moving a sphere moves visibility
discontinuities, and the pixel integral's derivative picks up a boundary
term that pointwise autodiff cannot see (the reference renderer, being
forward-only, has no counterpart — this fills the "geometry: not
estimated" row of the estimator table).

For a pixel with a box filter (the renderer's mean-over-jitter estimator),

    d/dpi I_p = \int_pixel dL/dpi dx dy                (interior term)
              + \oint_{edges in pixel} (L_in - L_out) (v . n_hat) ds
                                                       (boundary term)

  - interior: jax.grad through the wavefront integrator with the
    intersection ATTACHED (t(c, r) differentiable; sampling decisions
    stay detached) — the reparameterized "shading moves with the sphere"
    part.
  - boundary: Monte Carlo over the PRIMARY silhouette of each sphere.
    From eye e, a sphere (c, r) with D = |c - e| > r has silhouette
    circle: center c0 = c - (r^2/D) d_hat, radius rs = r sqrt(1 - r^2/D^2),
    in the plane normal to d_hat = (c - e)/D. The map
    theta -> q(theta; c, r) -> x_s (raster) is smooth in (c, r), so the
    screen-space edge velocity v = dx_s/dpi, tangent t = dx_s/dtheta and
    outward normal n_hat all come from jax.jacfwd — no hand-derived
    Jacobians. L_in/L_out are traced a hair inside/outside the silhouette
    (same lane streams, so occluded edge samples cancel: both rays hit
    the occluder and L_in - L_out = 0).

Scope (documented estimator boundary): PRIMARY silhouettes only.
Secondary-visibility boundaries (shadow edges, reflected/refracted
silhouettes) are not sampled; with direct-dominant lighting the primary
term dominates. Cameras inside a sphere (D <= r, e.g. the Cornell wall
spheres) contribute no primary silhouette and are skipped exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax import Array, lax

from pathtracer.models.camera import Camera
from pathtracer.models.integrator import RenderConfig, render, trace
from pathtracer.models.scene import Scene
from pathtracer.ops import vecmath as vm
from pathtracer.utils import rng


def _raster_of(cam: Camera, q: Array) -> Array:
    """World point -> raster coordinates (sx, sy), batched over q (..., 3).

    Inverts generate_rays' map d = first_ray_dir + sx*px_x - sy*px_y
    (camera.h:66-72 semantics): solve M [a, b, l] = q - pos with
    M = [px_x | -px_y | first_ray_dir]; then (sx, sy) = (a/l, b/l).
    """
    M = jnp.stack([cam.px_x, -cam.px_y, cam.first_ray_dir], axis=-1)
    Minv = jnp.linalg.inv(M)
    abl = jnp.matmul(q - cam.pos, Minv.T, precision=lax.Precision.HIGHEST)
    return abl[..., :2] / abl[..., 2:3]


def _silhouette_raster(cam: Camera, center: Array, radius: Array,
                       theta: Array) -> Array:
    """Raster position of the silhouette point at angle theta — smooth in
    (center, radius), so jacfwd gives edge velocity and tangent."""
    d = center - cam.pos
    D = vm.length(d)
    d_hat = d / D
    sin2 = (radius * radius) / (D * D)
    rs = radius * jnp.sqrt(jnp.maximum(1.0 - sin2, 1e-12))
    c0 = center - (radius * radius / D) * d_hat
    e1, e2 = vm.orthonormal_basis(d_hat)
    q = c0 + rs * (jnp.cos(theta)[..., None] * e1
                   + jnp.sin(theta)[..., None] * e2)
    return _raster_of(cam, q)


def _edge_term_one_sphere(
    scene: Scene,
    cam: Camera,
    it_key: Array,
    config: RenderConfig,
    d_loss_d_image: Array,  # (H, W, 3)
    prim: int,
    thetas: Array,  # (N,)
    eps_px: float,
    lane_base: int,
) -> tuple[Array, Array]:
    """Boundary-term gradients (d_center (3,), d_radius ()) for one sphere."""
    center = scene.centers[prim]
    radius = scene.radii[prim]
    N = thetas.shape[0]
    W, H = cam.width, cam.height

    def xs_fn(c, r, th):
        return _silhouette_raster(cam, c, r, th)

    xs = xs_fn(center, radius, thetas)  # (N, 2)
    # screen-space tangent and parameter velocities, all via jacfwd
    t_vec = jax.vmap(jax.jacfwd(xs_fn, argnums=2),
                     in_axes=(None, None, 0))(center, radius, thetas)
    v_c = jax.vmap(jax.jacfwd(xs_fn, argnums=0),
                   in_axes=(None, None, 0))(center, radius, thetas)  # (N,2,3)
    v_r = jax.vmap(jax.jacfwd(xs_fn, argnums=1),
                   in_axes=(None, None, 0))(center, radius, thetas)  # (N,2)

    speed = jnp.sqrt(jnp.sum(t_vec * t_vec, axis=-1))  # |dx_s/dtheta|
    # outward normal: rotate tangent 90deg, orient away from the sphere's
    # screen projection (raster of the center)
    n_raw = jnp.stack([t_vec[:, 1], -t_vec[:, 0]], axis=-1)
    n_hat = n_raw / jnp.maximum(speed, 1e-12)[:, None]
    c_s = _raster_of(cam, center)  # (2,)
    flip = jnp.sign(jnp.sum(n_hat * (xs - c_s), axis=-1))
    n_hat = n_hat * flip[:, None]

    # radiance a hair inside / outside the silhouette (same lane streams:
    # occluded samples cancel exactly)
    x_in = xs - eps_px * n_hat
    x_out = xs + eps_px * n_hat
    lane_ids = lane_base + jnp.arange(N, dtype=jnp.int32)

    def shade(x):
        d = (cam.first_ray_dir
             + cam.px_x * x[:, 0:1] - cam.px_y * x[:, 1:2])
        d = vm.normalize(d)
        o = jnp.broadcast_to(cam.pos, d.shape)
        return trace(scene, o, d, lane_ids, it_key, config)

    dL = shade(x_in) - shade(x_out)  # (N, 3)

    # pixel under the sample (box filter: pixel p covers [p-0.5, p+0.5))
    pix = jnp.floor(xs + 0.5).astype(jnp.int32)
    inside = ((pix[:, 0] >= 0) & (pix[:, 0] < W)
              & (pix[:, 1] >= 0) & (pix[:, 1] < H))
    pix_x = jnp.clip(pix[:, 0], 0, W - 1)
    pix_y = jnp.clip(pix[:, 1], 0, H - 1)
    w_pix = d_loss_d_image[pix_y, pix_x]  # (N, 3)

    # silhouette exists only when the eye is outside the sphere
    D = vm.length(center - cam.pos)
    valid = (inside & (D > radius)).astype(jnp.float32)

    common = jnp.sum(w_pix * dL, axis=-1) * valid * (2.0 * jnp.pi / N)
    vn_c = jnp.einsum("nkc,nk->nc", v_c, n_hat,
                      precision=lax.Precision.HIGHEST)  # (N, 3)
    vn_r = jnp.sum(v_r * n_hat, axis=-1)  # (N,)
    g_c = jnp.sum(common[:, None] * vn_c * speed[:, None], axis=0)
    g_r = jnp.sum(common * vn_r * speed)
    return g_c, g_r


@functools.partial(
    jax.jit, static_argnames=("config", "n_edge_samples", "eps_px"),
)
def geometry_grads(
    scene: Scene,
    cam: Camera,
    key: Array,
    config: RenderConfig,
    d_loss_d_image: Array,  # (H, W, 3) cotangent of the rendered image
    iteration: Array | int = 0,
    n_edge_samples: int = 512,
    eps_px: float = 0.05,
) -> dict:
    """Combined geometry gradient d loss / d {centers, radii}.

    interior: autodiff of the render with intersection attached (sampling
    decisions stay detached per RenderConfig.detach_sampling);
    boundary: silhouette edge sampling, one circle per non-degenerate
    sphere. Returns {"centers": (P, 3), "radii": (P,)}.
    """
    it_key = rng.iteration_key(key, iteration)

    # ---- interior term: attached-intersection autodiff (attached_geom
    # keeps the diffuse cosine's normal-dependence; primal unchanged)
    int_config = dataclasses.replace(config, attached_geom=True)

    def img_loss(centers, radii):
        s = dataclasses.replace(scene, centers=centers, radii=radii)
        img = render(s, cam, key, int_config, iteration=iteration)
        return jnp.sum(img * d_loss_d_image)

    g_c_int, g_r_int = jax.grad(img_loss, argnums=(0, 1))(
        scene.centers, scene.radii
    )

    # ---- boundary term: stratified thetas, decorrelated per sphere
    n_prims = int(scene.num_prims)
    g_c = jnp.zeros_like(scene.centers)
    g_r = jnp.zeros_like(scene.radii)
    ekey = jax.random.fold_in(it_key, 0x51100E77)
    base = jnp.arange(n_edge_samples, dtype=jnp.float32) / n_edge_samples
    for p in range(n_prims):
        u = jax.random.uniform(jax.random.fold_in(ekey, p), ())
        thetas = (base + u) * (2.0 * jnp.pi)
        gc_p, gr_p = _edge_term_one_sphere(
            scene, cam, it_key, config, d_loss_d_image, p, thetas,
            eps_px, lane_base=(p + 1) * 0x100000,
        )
        g_c = g_c.at[p].add(gc_p)
        g_r = g_r.at[p].add(gr_p)

    return {"centers": g_c_int + g_c, "radii": g_r_int + g_r}


def _translate_mesh(scene: Scene, delta: Array,
                    mats: tuple | None = None) -> Scene:
    """Scene with the mesh (or the triangles of the given material ids)
    rigidly translated by delta, differentiably.

    Only the VALUE path must be exact: triangle rows (v0, tris_packed)
    and the tri-light tables move by delta; BVH node boxes are PADDED by
    |delta| instead of translated — boxes only cull, so padding leaves
    the primal at delta = 0 bit-identical while keeping finite-difference
    probes (delta != 0) conservative even for per-object translation
    (whose exact per-node bounds are unknowable without a rebuild).
    Forward-mode JVP flows through the traversal's lax.while_loop where
    reverse-mode cannot."""
    m = scene.mesh
    if mats is None:
        sel = jnp.ones((m.v0.shape[0],), jnp.float32)
    else:
        sel = jnp.zeros((m.v0.shape[0],), jnp.float32)
        for mi in mats:
            sel = jnp.where(m.material_id == mi, 1.0, sel)
    shift = sel[:, None] * delta
    pad = jnp.max(jnp.abs(delta))
    nodes_packed = m.nodes_packed.at[:, 0:3].add(-pad)
    nodes_packed = nodes_packed.at[:, 3:6].add(pad)
    mesh = dataclasses.replace(
        m, v0=m.v0 + shift,
        tris_packed=m.tris_packed.at[:, 0:3].add(shift),
        node_min=m.node_min - pad,
        node_max=m.node_max + pad,
        nodes_packed=nodes_packed,
    )
    scene = dataclasses.replace(scene, mesh=mesh)
    if scene.tl_v0 is not None:
        # tl tables are padded past the real light count; light_mats is
        # the unpadded static tuple
        tshift = jnp.zeros_like(scene.tl_v0)
        for li, lm in enumerate(scene.light_mats):
            if mats is None or int(lm) in mats:
                tshift = tshift.at[li].add(delta)
        scene = dataclasses.replace(scene, tl_v0=scene.tl_v0 + tshift)
    return scene


@functools.partial(
    jax.jit, static_argnames=("config", "objects"),
)
def mesh_translation_grads(
    scene: Scene,
    cam: Camera,
    key: Array,
    config: RenderConfig,
    d_loss_d_image: Array,  # (H, W, 3) cotangent of the rendered image
    iteration: Array | int = 0,
    objects: tuple | None = None,  # material ids; None = whole mesh
) -> Array:
    """d loss / d (rigid mesh translation) at delta = 0 — the (3,)
    gradient of sum(d_loss_d_image * image) w.r.t. translating the mesh
    (or the listed materials' triangles) as a rigid body.

    Estimator (the mesh row of the per-parameter table): ATTACHED
    interior term only — the intersection t, hit point, interpolated uv
    and the diffuse cosine all move with the vertices (attached_geom
    reparameterization; flat triangles keep dn = 0 under translation),
    propagated by forward-mode JVP through the XLA BVH traversal (one
    tangent per component; lax.while_loop admits JVP where reverse-mode
    does not). Visibility BOUNDARY terms — mesh silhouette and shadow
    edges sweeping across pixels — are NOT sampled (documented scope, as
    for camera pose; sphere primaries have them via geometry_grads'
    silhouette MC). FD validation on an edge-free fixture:
    tests/test_geometry.py::test_mesh_translation_grad_matches_fd."""
    if scene.mesh is None:
        raise ValueError("mesh_translation_grads: scene has no mesh")
    int_config = dataclasses.replace(config, attached_geom=True)

    def loss(delta):
        s = _translate_mesh(scene, delta, objects)
        img = render(s, cam, key, int_config, iteration=iteration)
        return jnp.sum(img * d_loss_d_image)

    return jax.jacfwd(loss)(jnp.zeros(3))
