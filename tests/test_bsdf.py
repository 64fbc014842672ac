"""BSDF sampling tests, including per-lobe furnace tests (SURVEY.md §4)."""
import jax.numpy as jnp
import numpy as np

from pathtracer.models.scene import DIFFUSE, SPECULAR, TRANSMISSIVE
from pathtracer.ops import bsdf, vecmath as vm

N = 100_000


def setup(mtype, seed=0, albedo=(1.0, 1.0, 1.0), coef=1.0):
    rng = np.random.default_rng(seed)
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    wo = jnp.tile(vm.normalize(jnp.asarray([[0.4, 0.2, -0.9]])), (N, 1))
    u1 = jnp.asarray(rng.random(N, np.float32))
    u2 = jnp.asarray(rng.random(N, np.float32))
    mt = jnp.full((N,), mtype, jnp.int32)
    alb = jnp.tile(jnp.asarray([albedo], jnp.float32), (N, 1))
    cf = jnp.full((N,), coef, jnp.float32)
    return mt, alb, cf, wo, n, u1, u2


def setup_wo(mtype, wo_vec, seed=0, albedo=(1.0, 1.0, 1.0), coef=1.0):
    mt, alb, cf, _, n, u1, u2 = setup(mtype, seed, albedo, coef)
    wo = jnp.tile(vm.normalize(jnp.asarray([wo_vec])), (N, 1))
    return mt, alb, cf, wo, n, u1, u2


def test_diffuse_furnace():
    """E[f * |wi.n| / pdf] equals the albedo at normal incidence.

    At normal incidence the reference's wo.wi<0 gate (scene.h:184) never
    fires, so the estimator is exactly energy-conserving.
    """
    mt, alb, cf, wo, n, u1, u2 = setup_wo(
        DIFFUSE, [0.0, 0.0, -1.0], albedo=(0.8, 0.5, 0.3), coef=0.0
    )
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    w = np.array(f) * (np.abs(np.array(vm.dot(wi, n))) / np.maximum(np.array(pdf), 1e-12))[:, None]
    ok = np.array(pdf) > 0
    est = (w * ok[:, None]).sum(0) / N
    np.testing.assert_allclose(est, [0.8, 0.5, 0.3], rtol=2e-2)


def test_diffuse_grazing_gate_reference_parity():
    """The reference gates the diffuse pdf on wo.wi < 0 (scene.h:184), which
    rejects a few percent of grazing-angle samples. We replicate that
    semantic for image parity; this test pins it down so a future change is
    deliberate."""
    mt, alb, cf, wo, n, u1, u2 = setup(DIFFUSE, albedo=(1.0, 1.0, 1.0), coef=0.0)
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    rejected = (np.array(pdf) == 0.0) & (np.array(vm.dot(wo, wi)) >= 0)
    zero = np.array(pdf) == 0.0
    assert zero.sum() > 0  # the gate does fire at this grazing wo
    assert np.array_equal(zero, rejected)  # and only via the wo.wi rule


def test_diffuse_sampled_same_hemisphere_as_normal():
    mt, alb, cf, wo, n, u1, u2 = setup(DIFFUSE)
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    ct = np.array(vm.dot(wi, n))
    assert np.all(ct > -1e-5)
    # pdf formula check: cos/pi where wo.wi < 0 (reference scene.h:184).
    expect = np.where(np.array(vm.dot(wo, wi)) < 0, np.abs(ct) / np.pi, 0.0)
    np.testing.assert_allclose(np.array(pdf), expect, atol=1e-5)


def test_specular_deterministic_mirror():
    mt, alb, cf, wo, n, u1, u2 = setup(SPECULAR, albedo=(0.9, 0.9, 0.9), coef=1.0)
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    wo1, n1 = np.array(wo[0]), np.array(n[0])
    expect = wo1 - 2 * wo1.dot(n1) * n1
    np.testing.assert_allclose(np.array(wi), np.tile(expect, (N, 1)), atol=1e-5)
    np.testing.assert_allclose(np.array(pdf), np.ones(N), atol=1e-6)
    np.testing.assert_allclose(np.array(f), np.full((N, 3), 0.9), rtol=1e-5)


def test_transmissive_splits_by_fresnel():
    mt, alb, cf, wo, n, u1, u2 = setup(TRANSMISSIVE, coef=1.5)
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    up = np.array(vm.dot(wi, n)) > 0  # reflected lanes leave upward
    frac_reflected = up.mean()
    # Fresnel reflectance at this incidence angle for IOR 1.5:
    from pathtracer.ops import optics
    r = float(optics.fresnel_reflectance(wo[:1], n[:1], jnp.ones(1), jnp.full(1, 1.5))[0])
    np.testing.assert_allclose(frac_reflected, r, atol=0.01)
    np.testing.assert_allclose(np.array(pdf), np.ones(N), atol=1e-6)
    # Refracted lanes obey Snell's law.
    down = ~up
    wt = np.array(wi)[down]
    sin_t = np.linalg.norm(wt[:, :2], axis=-1)
    sin_i = np.linalg.norm(np.array(wo[0])[:2])
    np.testing.assert_allclose(sin_t, sin_i / 1.5, rtol=1e-4)


def test_transmissive_from_inside_flips_normal():
    """Ray travelling outward from inside the glass (wo.n > 0)."""
    rng = np.random.default_rng(1)
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    wo = jnp.tile(vm.normalize(jnp.asarray([[0.2, 0.1, 0.95]])), (N, 1))
    u1 = jnp.asarray(rng.random(N, np.float32))
    u2 = jnp.asarray(rng.random(N, np.float32))
    mt = jnp.full((N,), TRANSMISSIVE, jnp.int32)
    alb = jnp.ones((N, 3))
    cf = jnp.full((N,), 1.5, jnp.float32)
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    assert np.all(np.isfinite(np.array(wi)))
    # Refracted lanes exit upward, reflected lanes bounce back down.
    sgn = np.array(vm.dot(wi, n))
    assert (sgn > 0).any() and (sgn < 0).any()


def test_mixed_lane_dispatch():
    """Different material types in one batch resolve independently."""
    rng = np.random.default_rng(2)
    k = 300
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (k, 1))
    wo = jnp.tile(vm.normalize(jnp.asarray([[0.3, -0.1, -0.95]])), (k, 1))
    mt = jnp.asarray(rng.integers(0, 3, k).astype(np.int32))
    alb = jnp.ones((k, 3)) * 0.7
    cf = jnp.where(mt == TRANSMISSIVE, 1.5, 1.0)
    u1 = jnp.asarray(rng.random(k, np.float32))
    u2 = jnp.asarray(rng.random(k, np.float32))
    f, wi, pdf = bsdf.sample(mt, alb, cf, wo, n, u1, u2)
    mtn = np.array(mt)
    # Specular lanes all equal the mirror direction.
    wo1, n1 = np.array(wo[0]), np.array(n[0])
    mirror = wo1 - 2 * wo1.dot(n1) * n1
    np.testing.assert_allclose(np.array(wi)[mtn == SPECULAR],
                               np.tile(mirror, ((mtn == SPECULAR).sum(), 1)), atol=1e-5)
    # Diffuse lanes in upper hemisphere.
    assert np.all(np.array(vm.dot(wi, n))[mtn == DIFFUSE] > -1e-5)
    # f finite everywhere.
    assert np.all(np.isfinite(np.array(f)))


def test_bsdf_f_and_pdf_eval():
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    wo = vm.normalize(jnp.asarray([[0.5, 0.0, -0.8]]))
    wi = vm.normalize(jnp.asarray([[-0.3, 0.2, 0.9]]))
    alb = jnp.asarray([[0.6, 0.6, 0.6]])
    f_d = bsdf.f(jnp.asarray([DIFFUSE]), alb, wo, wi, n)
    np.testing.assert_allclose(np.array(f_d[0]), 0.6 / np.pi, rtol=1e-5)
    p_d = bsdf.pdf(jnp.asarray([DIFFUSE]), wo, wi, n)
    np.testing.assert_allclose(float(p_d[0]), float(vm.dot(wi, n)[0]) / np.pi, rtol=1e-5)
    f_s = bsdf.f(jnp.asarray([SPECULAR]), alb, wo, wi, n)
    np.testing.assert_allclose(np.array(f_s[0]), 0.0, atol=1e-7)
