"""Statistical tests for the Monte Carlo sampling library.

The SURVEY.md §4 unit-test plan: chi-square / moment tests on the samplers
the reference implements per-thread (montecarlo.h:76-159).
"""
import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.ops import sampling, vecmath as vm

N = 200_000


def uniforms(seed, n=N, d=2):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.random(n, np.float32)) for _ in range(d)]


def test_concentric_disk_inside_and_uniform():
    u1, u2 = uniforms(0)
    dx, dy = sampling.concentric_sample_disk(u1, u2)
    r2 = np.array(dx) ** 2 + np.array(dy) ** 2
    assert np.all(r2 <= 1.0 + 1e-5)
    # Uniform density on the disk: E[x]=E[y]=0, E[r^2]=1/2.
    assert abs(np.mean(np.array(dx))) < 5e-3
    assert abs(np.mean(np.array(dy))) < 5e-3
    np.testing.assert_allclose(np.mean(r2), 0.5, atol=5e-3)
    # Quadrant counts ~ equal (the four-region Shirley mapping covers all).
    quad = (np.array(dx) > 0).astype(int) * 2 + (np.array(dy) > 0).astype(int)
    counts = np.bincount(quad, minlength=4) / len(r2)
    np.testing.assert_allclose(counts, 0.25, atol=0.01)


def test_concentric_disk_degenerate_origin():
    dx, dy = sampling.concentric_sample_disk(jnp.array([0.5]), jnp.array([0.5]))
    np.testing.assert_allclose([dx[0], dy[0]], [0.0, 0.0], atol=1e-7)


def test_cosine_hemisphere_moments():
    u1, u2 = uniforms(1)
    n = jnp.tile(jnp.asarray([[0.3, 0.9, -0.3086]]) / np.linalg.norm([0.3, 0.9, -0.3086]), (N, 1))
    wi = sampling.cosine_sample_hemisphere(u1, u2, n)
    np.testing.assert_allclose(vm.length(wi), np.ones(N), atol=1e-4)
    ct = np.array(vm.dot(wi, n))
    assert np.all(ct >= -1e-5)  # hemisphere around n
    # For pdf = cos/pi: E[cos] = 2/3, E[cos^2] = 1/2.
    np.testing.assert_allclose(ct.mean(), 2.0 / 3.0, atol=3e-3)
    np.testing.assert_allclose((ct**2).mean(), 0.5, atol=3e-3)


def test_cosine_hemisphere_histogram_matches_pdf():
    """Chi-square-style check: bin cos(theta), compare to analytic mass."""
    u1, u2 = uniforms(7)
    n = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    wi = sampling.cosine_sample_hemisphere(u1, u2, n)
    ct = np.clip(np.array(wi[:, 2]), 0, 1)
    bins = np.linspace(0, 1, 11)
    hist, _ = np.histogram(ct, bins=bins)
    # P(cos in [a,b]) for pdf cos/pi over hemisphere = b^2 - a^2.
    expected = (bins[1:] ** 2 - bins[:-1] ** 2) * N
    chi2 = np.sum((hist - expected) ** 2 / expected)
    assert chi2 < 30.0, f"chi2={chi2}, hist={hist}"


def test_uniform_sphere():
    u1, u2 = uniforms(2)
    w = sampling.uniform_sample_sphere(u1, u2)
    np.testing.assert_allclose(vm.length(w), np.ones(N), atol=1e-4)
    m = np.array(w).mean(0)
    np.testing.assert_allclose(m, np.zeros(3), atol=6e-3)
    # z uniform in [-1,1]
    z = np.array(w[:, 2])
    np.testing.assert_allclose(z.mean(), 0.0, atol=6e-3)
    np.testing.assert_allclose((z**2).mean(), 1.0 / 3.0, atol=5e-3)


def test_uniform_cone_within_angle_and_pdf():
    u1, u2 = uniforms(3)
    ctm = jnp.float32(0.8)
    z = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (N, 1))
    x = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (N, 1))
    y = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (N, 1))
    w = sampling.uniform_sample_cone(u1, u2, jnp.full((N,), ctm), x, y, z)
    ct = np.array(vm.dot(w, z))
    assert np.all(ct >= 0.8 - 1e-4)
    # cos(theta) uniform in [ctm, 1]
    np.testing.assert_allclose(ct.mean(), 0.9, atol=2e-3)
    np.testing.assert_allclose(
        float(sampling.uniform_cone_pdf(ctm)), 1.0 / (2 * np.pi * 0.2), rtol=1e-5
    )


def test_power_heuristic():
    np.testing.assert_allclose(
        sampling.power_heuristic(1.0, 2.0, 1.0, 2.0), 0.5, rtol=1e-6
    )
    np.testing.assert_allclose(
        sampling.power_heuristic(1.0, 1.0, 1.0, 0.0), 1.0, rtol=1e-6
    )
    assert float(sampling.power_heuristic(1.0, 0.0, 1.0, 0.0)) == 0.0


def test_stratified_jitter_covers_cells():
    u = jnp.full((4,), 0.5)
    s = jnp.arange(4)
    ox, oy = sampling.stratified_jitter_for_sample(u, u, s, 4)
    # Cell centers of a 2x2 grid: +-0.25 in each axis.
    got = sorted(zip(np.array(ox).tolist(), np.array(oy).tolist()))
    expect = sorted([(-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25)])
    np.testing.assert_allclose(got, expect, atol=1e-6)
    # Offsets always within the pixel.
    rng = np.random.default_rng(0)
    uu = jnp.asarray(rng.random(1000, np.float32))
    vv = jnp.asarray(rng.random(1000, np.float32))
    ss = jnp.asarray(rng.integers(0, 4, 1000).astype(np.int32))
    ox, oy = sampling.stratified_jitter_for_sample(uu, vv, ss, 4)
    assert np.all(np.abs(np.array(ox)) <= 0.5) and np.all(np.abs(np.array(oy)) <= 0.5)
