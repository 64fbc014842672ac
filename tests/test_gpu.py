"""Tests that need an NVIDIA GPU: the persistent kernel as Triton compiles
it for the card (no interpret mode), against the interpreter and against
the wavefront integrator. Each takes the `gpu` fixture, which skips it
where JAX finds no GPU; `python chip_smoke.py` runs this file on the card
(with `--noconftest`, so the suite's CPU set-up stays out of the way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.models.progressive import choose_backend
from pathtracer.ops.pallas.persistent import (
    init_state, persistent_step, state_image,
)

W, H = 64, 48


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return devices[0]


def _cornell():
    scene, cs = sc.cornell_spheres()
    return scene, cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H,
                                 cs["fov"])


def _run(scene, camera, interpret, **kw):
    st = init_state(W, H)
    st, n = persistent_step(scene, camera, jnp.asarray([7, 1], jnp.int32),
                            st, interpret=interpret, **kw)
    return st, int(n)


@pytest.mark.gpu
def test_compiled_emitter_only_matches_interpreter(gpu):
    """max_bounces=0 leaves no room for float drift to steer a path: the
    compiled kernel's counts and radiance equal the interpreter's, so the
    compiled counter hash draws the same streams."""
    scene, camera = _cornell()
    kw = dict(budget=8, max_bounces=0)
    a, na = _run(scene, camera, False, **kw)
    b, nb = _run(scene, camera, True, **kw)
    assert na == nb
    np.testing.assert_array_equal(np.asarray(a.n_samp), np.asarray(b.n_samp))
    np.testing.assert_allclose(np.asarray(a.lr), np.asarray(b.lr),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("use_nee", [False, True])
def test_compiled_matches_interpreter(gpu, use_nee):
    """Full transport, compiled vs interpreted on identical streams: paths
    may part where the compiler's transcendentals differ in the last bit,
    so >= 98% of pixels must agree to 1e-4."""
    scene, camera = _cornell()
    kw = dict(budget=24, max_bounces=10, use_nee=use_nee)
    a, _ = _run(scene, camera, False, **kw)
    b, _ = _run(scene, camera, True, **kw)
    ia = np.asarray(state_image(a, W, H))
    ib = np.asarray(state_image(b, W, H))
    agree = (np.abs(ia - ib).max(axis=-1) < 1e-4).mean()
    assert agree >= 0.98, agree


@pytest.mark.gpu
def test_compiled_matches_wavefront_mean(gpu):
    """Compiled kernel vs the wavefront integrator at 64 spp, image mean
    within 3%."""
    scene, camera = _cornell()
    st = init_state(W, H)
    for i in range(4):
        st, _ = persistent_step(scene, camera, jnp.asarray([3, 0], jnp.int32),
                                st, budget=64)
    k = float(state_image(st, W, H).mean())
    x = float(render_image(scene, camera, jax.random.key(0),
                           RenderConfig(spp=64)).mean())
    assert abs(k - x) / x < 0.03, (k, x)


@pytest.mark.gpu
def test_choice_on_the_card(gpu):
    assert gpu.platform == "gpu"
    assert choose_backend(sc.cornell_spheres()[0]) == "pallas"
    assert choose_backend(sc.cornell_boxes()[0]) == "xla"
