"""Finite-difference checks of the XLA gradient routes, with NEE off and on.

Texture atlases differentiate through XLA autodiff of the wavefront
integrator (ops/texture.sample_bilinear's gathers); rigid mesh
translation through forward-mode JVP of the attached interior term
(diff/geometry.mesh_translation_grads). (IOR: tests/test_score.py, both
transport modes.) Fixtures are boundary-free — every path ends on a
huge sky emitter and the camera sees only the floor — and Russian
roulette never starts (max_bounces <= rr_start), so with common random
numbers the estimator is smooth in the parameter and central differences
are exact up to float error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.diff.geometry import mesh_translation_grads
from pathtracer.models import camera as cm, meshes, scene as sc
from pathtracer.models.integrator import RenderConfig, render
from pathtracer.models.mesh import build_bvh

W, H = 12, 10


def _floor_scene(dy=0.0):
    """A textured floor quad at y=dy under a sky: a 1e5-radius emitter
    sphere whose underside is a plane at y=60."""
    v, f, uv = meshes.quad([-40, dy, -40], [-40, dy, 40], [40, dy, 40],
                           [40, dy, -40])
    scene = sc.make_scene(
        [sc.sphere([0, 1e5 + 60, 0], 1e5, 1, 0)],
        [sc.diffuse([0.9, 0.8, 0.7]), sc.diffuse([0.0, 0.0, 0.0])],
        [sc.area_light(0, [1.5, 1.5, 1.5])],
        mesh=build_bvh(v, f, uv, 0),
        textures=meshes.checker_texture(32, tiles=8, c0=(0.9, 0.3, 0.2),
                                        c1=(0.2, 0.7, 0.9)),
        mat_texture=[0, -1],
    )
    cam = cm.make_camera([0, 6, 0.1], [0, 0, 0], [0, 0, -1], W, H, 50.0)
    return scene, cam


@pytest.mark.parametrize("use_nee", [False, True], ids=["brute", "nee"])
def test_atlas_gradient_matches_fd(use_nee):
    scene, cam = _floor_scene()
    cfg = RenderConfig(spp=4, max_bounces=2, use_nee=use_nee)
    key = jax.random.key(8)
    w = jnp.asarray(np.random.default_rng(1).random((H, W, 3), np.float32))

    def loss(tex):
        return jnp.sum(render(dataclasses.replace(scene, textures=tex), cam,
                              key, cfg) * w)

    g = np.asarray(jax.jit(jax.grad(loss))(scene.textures))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    lf = jax.jit(loss)
    tex0 = np.asarray(scene.textures)
    h = 1e-2
    for idx in np.argsort(-np.abs(g).reshape(-1))[:3]:
        k, y, x, c = np.unravel_index(idx, g.shape)
        tp, tm = tex0.copy(), tex0.copy()
        tp[k, y, x, c] += h
        tm[k, y, x, c] -= h
        fd = (float(lf(jnp.asarray(tp))) - float(lf(jnp.asarray(tm)))) / (
            2 * h)
        np.testing.assert_allclose(g[k, y, x, c], fd, rtol=2e-2)


@pytest.mark.parametrize("use_nee", [False, True], ids=["brute", "nee"])
def test_mesh_translation_matches_fd(use_nee):
    """Moving the textured floor vertically slides every camera ray's hit
    point (and its texel lookup, and under NEE its distance to the sky):
    the attached interior term must match central differences."""
    scene, cam = _floor_scene()
    cfg = RenderConfig(spp=4, max_bounces=1, use_nee=use_nee)
    key = jax.random.key(5)
    w = jnp.asarray(np.random.default_rng(2).random((H, W, 3), np.float32))
    g = np.asarray(mesh_translation_grads(scene, cam, key, cfg, w))
    assert np.isfinite(g).all() and abs(g[1]) > 1e-3

    h = 2e-2

    def J(dy):
        s, c = _floor_scene(dy)
        return float(jnp.sum(render(s, c, key, cfg) * w))

    fd = (J(h) - J(-h)) / (2 * h)
    np.testing.assert_allclose(g[1], fd, rtol=3e-2)
