"""Distributed tests on the fake 8-device CPU mesh (SURVEY.md §4).

Asserts the core distributed invariant: sharded render == single-device
render bit-for-bit at a fixed seed (possible because RNG is keyed on
global lane ids), and that the sharded inverse-rendering step produces
finite psum'd gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.diff import inverse
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.parallel.mesh import make_mesh
from pathtracer.parallel.sharding import render_sharded_jit


def setup(w=16, h=16, spp=4, bounces=4):
    scene, cs = sc.cornell_spheres()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    cfg = RenderConfig(spp=spp, max_bounces=bounces)
    return scene, cam, cfg


def test_eight_devices_available():
    assert len(jax.devices()) == 8  # conftest forces the fake backend


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_equals_single_device(shape):
    n = shape[0] * shape[1]
    scene, cam, cfg = setup(spp=8)
    mesh = make_mesh(jax.devices()[:n], n_tile=shape[0], n_sample=shape[1])
    key = jax.random.key(3)
    single = np.array(render_image(scene, cam, key, cfg))
    sharded = np.array(render_sharded_jit(scene, cam, key, cfg, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_equals_single_device_mesh_scene():
    """Triangle geometry shards like spheres: the mesh pytree is
    replicated and lane-keyed RNG is partition-invariant. Unlike the
    sphere path (bit-exact above), the BVH traversal's gather/lerp
    chains fuse differently per partition shape, so the agreement is
    1-ulp, not bitwise (observed max diff 6e-8)."""
    scene, cs = sc.cornell_boxes()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 12,
                         cs["fov"])
    cfg = RenderConfig(spp=4, max_bounces=3, use_nee=True)
    mesh = make_mesh(jax.devices(), n_tile=4, n_sample=2)
    key = jax.random.key(6)
    single = np.array(render_image(scene, cam, key, cfg))
    sharded = np.array(render_sharded_jit(scene, cam, key, cfg, mesh))
    np.testing.assert_allclose(sharded, single, rtol=1e-6, atol=1e-7)


def test_sharded_loss_matches_unsharded_mse():
    scene, cam, cfg = setup(spp=4)
    mesh = make_mesh(jax.devices(), n_tile=4, n_sample=2)
    key = jax.random.key(0)
    target = jnp.zeros((cam.height * cam.width, 3))
    loss = float(
        inverse.sharded_loss(
            inverse.params_of(scene), scene, cam, target, key, cfg, mesh, 0
        )
    )
    img = np.array(render_image(scene, cam, key, cfg)).reshape(-1, 3)
    want = float(np.mean(img**2))
    np.testing.assert_allclose(loss, want, rtol=1e-5)


def test_sharded_grads_finite_and_match_unsharded():
    scene, cam, cfg = setup(w=8, h=8, spp=4, bounces=3)
    key = jax.random.key(1)
    target = jnp.full((cam.height * cam.width, 3), 0.25)
    params = inverse.params_of(scene)

    def loss_mesh(mesh):
        return jax.grad(
            lambda p: inverse.sharded_loss(
                p, scene, cam, target, key, cfg, mesh, 0
            )
        )(params)

    g_11 = loss_mesh(make_mesh(jax.devices()[:1], n_tile=1, n_sample=1))
    g_42 = loss_mesh(make_mesh(jax.devices(), n_tile=4, n_sample=2))
    for k in params:
        a, b = np.array(g_11[k]), np.array(g_42[k])
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b)), k
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    # Gradients are actually nonzero somewhere.
    assert np.abs(np.array(g_11["mat_color"])).max() > 0


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    jitted = jax.jit(fn)
    lowered = jitted.lower(*args)
    assert lowered is not None  # compile-check only; full run is the bench
