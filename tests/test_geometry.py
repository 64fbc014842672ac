"""Geometry gradients (diff/geometry.py): silhouette edge sampling + the
attached-geom interior term, validated against finite differences.

FD caveat: with fixed jitters the rendered functional is a STAIRCASE in
geometry parameters (a sample either crosses the moving silhouette or it
doesn't), so a SINGLE-iteration central difference carries large
staircase noise — that noise, not estimator variance, set an earlier
loose rtol 0.1-0.15. Measured evidence (offline experiment on this exact
fixture):

    estimator, radius d/dr over 6 edge-seed replicates:
        n_edge  4096: 394.31 +- 0.07
        n_edge 16384: 394.32 +- 0.005
        n_edge 65536: 394.33 +- 0.004     (variance ~ 1/n_edge, tiny)
    FD averaged over 16 jitter iterations: 394.76 +- 2.19 (sem)
        -> relative gap 0.11% (radius), 0.84% (center z, 52.22 +- 0.88)

So the tests below average FD over several iterations and assert at
rtol 2e-2 (radius) / 5e-2 (center z) — an order tighter than before,
bounded by the remaining FD sem, not the estimator.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pathtracer.models.scene as sc
import pathtracer.models.camera as cm
from pathtracer.models.integrator import RenderConfig, render
from pathtracer.diff.geometry import geometry_grads

W, H = 48, 36


@pytest.fixture(scope="module")
def coverage_case():
    """One emissive sphere on black: gradient is 100% boundary term."""
    mats = [sc.diffuse([0.0, 0.0, 0.0])]
    prims = [sc.sphere([0.0, 0.0, 0.0], 8.0, 0, 0)]
    scene = sc.make_scene(prims, mats, [sc.area_light(0, [5.0] * 3)])
    cam = cm.make_camera([0.0, 5.0, 60.0], [0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], W, H, 45.0)
    config = RenderConfig(spp=48, max_bounces=0)
    key = jax.random.key(3)
    wimg = jnp.asarray(
        np.random.default_rng(11).random((H, W, 3), np.float32)
    )

    def J(centers, radii, it=0):
        s = dataclasses.replace(scene, centers=centers, radii=radii)
        return float(jnp.sum(render(s, cam, key, config, iteration=it)
                             * wimg))

    return scene, cam, config, key, wimg, J


def test_boundary_radius_matches_fd(coverage_case):
    scene, cam, config, key, wimg, J = coverage_case
    g = geometry_grads(scene, cam, key, config, wimg, n_edge_samples=8192)
    h = 0.25
    # FD averaged over jitter iterations: kills the staircase noise that
    # forced the earlier rtol 0.1 (see module docstring evidence)
    fds = [
        (J(scene.centers, scene.radii.at[0].add(h), it)
         - J(scene.centers, scene.radii.at[0].add(-h), it)) / (2 * h)
        for it in range(8)
    ]
    fd = float(np.mean(fds))
    assert fd > 0  # growing an emitter on black must increase J
    np.testing.assert_allclose(float(g["radii"][0]), fd, rtol=2e-2)


def test_boundary_center_matches_fd(coverage_case):
    scene, cam, config, key, wimg, J = coverage_case
    g = geometry_grads(scene, cam, key, config, wimg, n_edge_samples=8192)
    # z (toward/away from camera) has the largest, most FD-stable
    # component: moving closer grows the projection.
    h = 0.4
    fds = [
        (J(scene.centers.at[0, 2].add(h), scene.radii, it)
         - J(scene.centers.at[0, 2].add(-h), scene.radii, it)) / (2 * h)
        for it in range(10)
    ]
    fd = float(np.mean(fds))
    np.testing.assert_allclose(float(g["centers"][0, 2]), fd, rtol=5e-2)


def test_wall_spheres_contribute_no_boundary():
    """Camera inside a sphere (Cornell walls): silhouette term is zero and
    finite — the D > r guard, not NaNs."""
    scene, cs = sc.cornell_spheres()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 32, 24,
                         cs["fov"])
    config = RenderConfig(spp=4, max_bounces=2)
    wimg = jnp.ones((24, 32, 3), jnp.float32)
    g = geometry_grads(scene, cam, jax.random.key(0), config, wimg,
                       n_edge_samples=256)
    assert np.isfinite(np.asarray(g["centers"])).all()
    assert np.isfinite(np.asarray(g["radii"])).all()


def test_attached_geom_primal_identical():
    """attached_geom must not change the rendered image (cos/sg(cos) == 1)."""
    scene, cs = sc.cornell_spheres()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 32, 24,
                         cs["fov"])
    key = jax.random.key(5)
    img_a = render(scene, cam, key, RenderConfig(spp=4, max_bounces=4),
                   iteration=0)
    img_b = render(scene, cam, key,
                   RenderConfig(spp=4, max_bounces=4, attached_geom=True),
                   iteration=0)
    np.testing.assert_array_equal(np.asarray(img_a), np.asarray(img_b))


# ---- mesh translation: attached interior term via
# forward-mode JVP through the XLA BVH traversal; visibility boundary
# terms documented out of scope (diff/geometry.mesh_translation_grads)

def _floor_mesh_scene(dy=0.0, with_ceiling=False, ceiling_dy=0.0):
    """Edge-free mesh fixture: a huge quad floor at y=dy fills the whole
    frame from a steeply-down-looking camera (every ray hits it, its rim
    projects outside the frustum), lit by a point light — translating it
    is a smooth functional, so per-seed FD is well-defined. Optional far
    ceiling quad (material 1) for the per-object path."""
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([-40, dy, -40], [-40, dy, 40],
                           [40, dy, 40], [40, dy, -40])
    mats = [sc.diffuse([0.8, 0.7, 0.6])]
    if with_ceiling:
        v2, f2, uv2 = meshes.quad(
            [-40, 30 + ceiling_dy, -40], [40, 30 + ceiling_dy, -40],
            [40, 30 + ceiling_dy, 40], [-40, 30 + ceiling_dy, 40])
        v = np.concatenate([v, v2])
        f = np.concatenate([f, f2 + 4])
        uv = np.concatenate([uv, uv2])
        fm = np.array([0, 0, 1, 1], np.int32)
        mesh = build_bvh(v, f, uv, fm)
        mats.append(sc.diffuse([0.3, 0.3, 0.3]))
    else:
        mesh = build_bvh(v, f, uv, 0)
    scene = sc.make_scene(
        [], mats, [sc.point_light([2, 6, 1], [60, 60, 60])], mesh=mesh
    )
    cam = cm.make_camera([0, 5, 0.1], [0, 0, 0], [0, 0, -1], W, H, 45.0)
    return scene, cam


def test_mesh_translation_grad_matches_fd():
    scene, cam = _floor_mesh_scene()
    config = RenderConfig(spp=4, max_bounces=1, use_nee=True)
    key = jax.random.key(5)
    wimg = jnp.asarray(
        np.random.default_rng(2).random((H, W, 3), np.float32))
    from pathtracer.diff.geometry import mesh_translation_grads

    g = mesh_translation_grads(scene, cam, key, config, wimg)
    g = np.asarray(g)
    assert np.isfinite(g).all() and abs(g[1]) > 0.1

    h = 2e-2
    def J(dy, it):
        s, c = _floor_mesh_scene(dy)
        return float(jnp.sum(render(s, c, key, config, iteration=it)
                             * wimg))
    fds = [(J(h, it) - J(-h, it)) / (2 * h) for it in range(6)]
    np.testing.assert_allclose(g[1], np.mean(fds), rtol=2e-2)


def test_mesh_translation_grad_per_object():
    """objects=(0,) moves only the floor: the gradient matches FD of
    rebuilding the scene with the floor (and only the floor) moved."""
    scene, cam = _floor_mesh_scene(with_ceiling=True)
    config = RenderConfig(spp=4, max_bounces=1, use_nee=True)
    key = jax.random.key(7)
    wimg = jnp.asarray(
        np.random.default_rng(4).random((H, W, 3), np.float32))
    from pathtracer.diff.geometry import mesh_translation_grads

    g = mesh_translation_grads(scene, cam, key, config, wimg,
                               objects=(0,))
    g = np.asarray(g)
    assert np.isfinite(g).all() and abs(g[1]) > 0.1

    h = 2e-2
    def J(dy, it):
        s, c = _floor_mesh_scene(dy, with_ceiling=True)
        return float(jnp.sum(render(s, c, key, config, iteration=it)
                             * wimg))
    fds = [(J(h, it) - J(-h, it)) / (2 * h) for it in range(6)]
    np.testing.assert_allclose(g[1], np.mean(fds), rtol=2e-2)


def test_mesh_translation_grad_finite_on_cornell():
    """The production mesh scene (triangle-quad Cornell + tri light):
    RR-deep paths, mixed materials, TRI_LIGHT NEE — gradient finite."""
    scene, cs = sc.cornell_quad()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 18,
                         cs["fov"])
    config = RenderConfig(spp=2, max_bounces=4, use_nee=True)
    wimg = jnp.ones((18, 24, 3)) / (18 * 24 * 3)
    from pathtracer.diff.geometry import mesh_translation_grads

    g = mesh_translation_grads(scene, cam, jax.random.key(1), config,
                               wimg)
    assert np.isfinite(np.asarray(g)).all()
