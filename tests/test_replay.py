"""Path-replay backprop vs the autodiff estimator.

Both differentiate the SAME detached-sampling estimator, so their
gradients must agree to float tolerance — but replay stores no per-bounce
residuals (its backward is a second forward walk).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.diff.replay import render_replay, trace_replay
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render


def setup(name="cornell", w=12, h=10, spp=2, bounces=3, nee=False):
    scene, cs = sc.BUILTIN_SCENES[name]()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    cfg = RenderConfig(spp=spp, max_bounces=bounces, detach_sampling=True,
                       use_nee=nee)
    return scene, cam, cfg


def grads_autodiff(scene, cam, cfg, key, weights):
    def f(params):
        s = dataclasses.replace(scene, mat_color=params[0], light_intensity=params[1])
        return jnp.sum(render(s, cam, key, cfg) * weights)

    return jax.grad(f)((scene.mat_color, scene.light_intensity))


def grads_replay(scene, cam, cfg, key, weights):
    def f(params):
        s = dataclasses.replace(scene, mat_color=params[0], light_intensity=params[1])
        return jnp.sum(render_replay(s, cam, key, cfg) * weights)

    return jax.grad(f)((scene.mat_color, scene.light_intensity))


@pytest.mark.parametrize("bounces,nee", [(1, False), (3, False), (6, False),
                                         (1, True), (3, True)])
def test_replay_matches_autodiff(bounces, nee):
    scene, cam, cfg = setup(bounces=bounces, nee=nee)
    key = jax.random.key(4)
    rng = np.random.default_rng(0)
    weights = jnp.asarray(
        rng.random((cam.height, cam.width, 3), np.float32)
    )
    gA_a, gI_a = grads_autodiff(scene, cam, cfg, key, weights)
    gA_r, gI_r = grads_replay(scene, cam, cfg, key, weights)
    np.testing.assert_allclose(
        np.array(gA_r), np.array(gA_a), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.array(gI_r), np.array(gI_a), rtol=2e-3, atol=2e-5
    )
    assert np.abs(np.array(gA_r)).max() > 0
    assert np.abs(np.array(gI_r)).max() > 0


@pytest.mark.parametrize("name,nee", [
    ("cornell-boxes", False), ("cornell-boxes", True),
    ("cornell-quad", False), ("cornell-quad", True),
])
def test_replay_matches_autodiff_mesh(name, nee):
    """Mesh scenes route the albedo adjoint through the unified Hit.mat id
    and TRI_LIGHT emitter hits through the material->light map — gradients
    must equal autodiff of the same detached estimator (XLA traversal)."""
    scene, cam, cfg = setup(name=name, bounces=3, nee=nee)
    key = jax.random.key(9)
    rng = np.random.default_rng(1)
    weights = jnp.asarray(
        rng.random((cam.height, cam.width, 3), np.float32)
    )
    gA_a, gI_a = grads_autodiff(scene, cam, cfg, key, weights)
    gA_r, gI_r = grads_replay(scene, cam, cfg, key, weights)
    np.testing.assert_allclose(
        np.array(gA_r), np.array(gA_a), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.array(gI_r), np.array(gI_a), rtol=2e-3, atol=2e-5
    )
    assert np.abs(np.array(gA_r)).max() > 0
    assert np.abs(np.array(gI_r)).max() > 0


def _textured_setup():
    """Tinted checker floor (tex * mat_color) + emissive sphere."""
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([-10, 0, -10], [-10, 0, 10], [10, 0, 10],
                           [10, 0, -10])
    mesh = build_bvh(v, f, uv, 0)
    tex = meshes.checker_texture(8, tiles=2, c0=(0.9, 0.3, 0.2),
                                 c1=(0.15, 0.8, 0.9))
    scene = sc.make_scene(
        [sc.sphere([0.0, 9.0, 0.0], 2.0, 1, 0)],
        [sc.diffuse([0.6, 1.0, 0.8]), sc.diffuse([1.0, 1.0, 1.0])],
        [sc.area_light(0, [14.0, 14.0, 14.0])],
        mesh=mesh, textures=tex, mat_texture=[0, -1],
    )
    cam = cm.make_camera([0, 12, 9], [0, 0, 0], [0, 1, 0], 12, 10, 60.0)
    cfg = RenderConfig(spp=4, max_bounces=2, detach_sampling=True,
                       use_nee=True)
    return scene, cam, cfg


def test_replay_matches_autodiff_textured():
    """Textured materials: the texel MODULATES mat_color (tex * A), so
    the replay identity dw/dA = w/A holds on textured vertices and the
    textured material's color gradient is the tex-weighted transport —
    must equal autodiff. (Under the old replace semantics autodiff gives
    ZERO for the textured material's color while replay divides the
    suffix by the table color — this test pins the fix.)"""
    scene, cam, cfg = _textured_setup()
    key = jax.random.key(3)
    rng = np.random.default_rng(5)
    weights = jnp.asarray(rng.random((cam.height, cam.width, 3), np.float32))
    gA_a, gI_a = grads_autodiff(scene, cam, cfg, key, weights)
    gA_r, gI_r = grads_replay(scene, cam, cfg, key, weights)
    np.testing.assert_allclose(
        np.array(gA_r), np.array(gA_a), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.array(gI_r), np.array(gI_a), rtol=2e-3, atol=2e-5
    )
    # the TEXTURED material's own color gradient is nonzero (tinting)
    assert np.abs(np.array(gA_a)[0]).max() > 1e-4


def test_texture_atlas_gradients_fd():
    """The texture ATLAS is a differentiable scene parameter through the
    autodiff estimator (sample_bilinear's gathers): d(loss)/d(texel)
    matches central finite differences — inverse rendering can recover
    textures, not just flat colors."""
    scene, cam, cfg = _textured_setup()
    key = jax.random.key(4)

    def loss(tex):
        s = dataclasses.replace(scene, textures=tex)
        return jnp.mean(render(s, cam, key, cfg))

    g = jax.jit(jax.grad(loss))(scene.textures)
    g = np.asarray(g)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    lf = jax.jit(loss)
    h = 2e-2
    checked = 0
    tex0 = np.asarray(scene.textures)
    flat_order = np.argsort(-np.abs(g).reshape(-1))
    for idx in flat_order[:4]:
        k, y, x, c = np.unravel_index(idx, g.shape)
        tp = tex0.copy()
        tp[k, y, x, c] += h
        tm = tex0.copy()
        tm[k, y, x, c] -= h
        fd = (float(lf(jnp.asarray(tp))) - float(lf(jnp.asarray(tm)))) / (
            2 * h
        )
        np.testing.assert_allclose(g[k, y, x, c], fd, rtol=5e-2,
                                   atol=1e-7)
        checked += 1
    assert checked == 4


@pytest.mark.parametrize("nee", [False, True])
def test_replay_primal_matches_render(nee):
    scene, cam, cfg = setup(bounces=5, nee=nee)
    key = jax.random.key(7)
    a = np.array(render(scene, cam, key, cfg))
    b = np.array(render_replay(scene, cam, key, cfg))
    # Same estimator, same streams — but separately-fused XLA programs
    # (render's scan is intersect-first), so float contraction differs at
    # the last few ulps of the accumulated radiance.
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_replay_with_rr_finite():
    """Deep bounces with Russian roulette active: gradients stay finite and
    match autodiff (both use the same detached RR decisions)."""
    scene, cam, cfg = setup(bounces=8)
    key = jax.random.key(2)
    weights = jnp.ones((cam.height, cam.width, 3))
    gA_a, gI_a = grads_autodiff(scene, cam, cfg, key, weights)
    gA_r, gI_r = grads_replay(scene, cam, cfg, key, weights)
    assert np.all(np.isfinite(np.array(gA_r)))
    np.testing.assert_allclose(np.array(gA_r), np.array(gA_a), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.array(gI_r), np.array(gI_a), rtol=5e-3, atol=5e-5)
