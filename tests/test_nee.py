"""Tests for next-event estimation + MIS (the reference's dead machinery,
scene.h:110-170 / montecarlo.h:156-159, implemented live)."""
import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.ops import lights, vecmath as vm


def avg_render(scene, cam, cfg, iters, key=None):
    key = key if key is not None else jax.random.key(0)
    acc = 0
    for it in range(iters):
        acc = acc + np.array(render_image(scene, cam, key, cfg, iteration=it))
    return acc / iters


def test_nee_matches_brute_force_diffuse_scenes():
    """NEE and brute force estimate the same integral (MC tolerance)."""
    for name, tol in [("single-sphere", 0.02), ("small", 0.02)]:
        scene, cs = sc.BUILTIN_SCENES[name]()
        cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 24, cs["fov"])
        bf = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=5), 24)
        ne = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=5, use_nee=True), 24)
        ratio = ne.mean() / bf.mean()
        assert abs(ratio - 1.0) < tol, (name, ratio)


def test_nee_matches_brute_force_cornell_loose():
    """Cornell (mirror+glass+giant interpenetrating emitter): heavier MC
    tails, looser tolerance; NEE(B-1) compared against brute(B) to account
    for NEE's extra segment of light transport at the final vertex."""
    scene, cs = sc.cornell_spheres()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 24, cs["fov"])
    bf = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4), 24)
    ne = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=3, use_nee=True), 24)
    ratio = ne.mean() / bf.mean()
    assert abs(ratio - 1.0) < 0.08, ratio


def test_nee_reduces_variance():
    scene, cs = sc.BUILTIN_SCENES["small"]()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 24, cs["fov"])
    ref_b = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=5), 24)
    ref_n = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=5, use_nee=True), 24)
    one_b = np.array(render_image(scene, cam, jax.random.key(0), RenderConfig(spp=8, max_bounces=5), iteration=77))
    one_n = np.array(render_image(scene, cam, jax.random.key(0), RenderConfig(spp=8, max_bounces=5, use_nee=True), iteration=77))
    err_b = np.abs(one_b - ref_b).mean()
    err_n = np.abs(one_n - ref_n).mean()
    assert err_n < 0.6 * err_b, (err_b, err_n)


def test_point_light_requires_nee():
    """Point lights are delta emitters: brute-force emitter-hit transport
    cannot see them (the reference's active integrator also could not —
    its point light is commented out, main.cpp:165). NEE renders them."""
    scene = sc.make_scene(
        [sc.sphere([0, -1e4 - 1, 0], 1e4, 0)],  # floor
        [sc.diffuse([0.7, 0.7, 0.7])],
        [sc.point_light([0, 3, 0], [40.0, 40.0, 40.0])],
    )
    cam = cm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], 16, 16, 60.0)
    brute = avg_render(scene, cam, RenderConfig(spp=4, max_bounces=3), 4)
    nee = avg_render(scene, cam, RenderConfig(spp=4, max_bounces=3, use_nee=True), 4)
    assert brute.max() == 0.0
    assert nee.max() > 0.1
    # Inverse-square falloff: the floor point under the light is brightest.
    img = nee.mean(axis=-1)
    bright_row = img[img.sum(axis=1).argmax()]
    assert bright_row.argmax() in range(6, 10)  # center-ish column


def test_point_light_inverse_square():
    """Direct lighting from a point light follows I*cos/d^2 (scene.h:153-158)."""
    scene = sc.make_scene(
        [sc.sphere([0, -1e4, 0], 1e4, 0)],  # plane y=0
        [sc.diffuse([1.0, 1.0, 1.0])],
        [sc.point_light([0, 2, 0], [10.0, 10.0, 10.0])],
    )
    # Straight-down camera view of the plane around the origin.
    cam = cm.make_camera([0, 5, 1e-4], [0, 0, 0], [0, 1, 0], 9, 9, 40.0)
    img = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=1, use_nee=True), 8)
    # Analytic: L = albedo/pi * I * cos(theta) / d^2 at the point below the
    # light: d=2, cos=1 -> (1/pi)*10/4 = 0.7958
    center = img[4, 4].mean()
    np.testing.assert_allclose(center, 10.0 / (np.pi * 4.0), rtol=0.08)


def test_light_sample_geometry():
    """Cone samples land on the sphere, pdf matches the analytic cone pdf."""
    scene = sc.make_scene(
        [sc.sphere([0, 5, 0], 1.0, 0, 0)],
        [sc.diffuse([1, 1, 1])],
        [sc.area_light(0, [5.0, 5.0, 5.0])],
    )
    rng = np.random.default_rng(0)
    n = 5000
    p = jnp.asarray(np.stack([rng.uniform(-1, 1, n), np.zeros(n), rng.uniform(-1, 1, n)], -1), jnp.float32)
    u = jnp.asarray(rng.random((n, 3), np.float32))
    ls = lights.sample_lights(scene, p, u)
    ps = np.array(p) + np.array(ls.wi) * np.array(ls.dist)[:, None]
    # On the sphere surface:
    r_err = np.abs(np.linalg.norm(ps - np.array([0, 5, 0]), axis=-1) - 1.0)
    assert np.percentile(r_err, 95) < 1e-2
    # pdf equals the cone pdf for the receiver's aperture:
    d2 = np.sum((np.array(p) - np.array([0, 5, 0])) ** 2, -1)
    ctm = np.sqrt(1 - np.clip(1.0 / d2, 0, 1))
    expect = 1.0 / (2 * np.pi * (1 - ctm))
    np.testing.assert_allclose(np.array(ls.pdf), expect, rtol=1e-3)
    assert bool(np.all(np.array(ls.valid)))


def test_mis_weights_sum_to_one():
    from pathtracer.ops.sampling import power_heuristic
    pf = jnp.asarray([0.5, 2.0, 0.1])
    pg = jnp.asarray([0.3, 0.3, 3.0])
    w1 = power_heuristic(1.0, pf, 1.0, pg)
    w2 = power_heuristic(1.0, pg, 1.0, pf)
    np.testing.assert_allclose(np.array(w1 + w2), np.ones(3), rtol=1e-6)


def test_distribution_1d():
    import jax.numpy as jnp
    from pathtracer.ops.sampling import (
        make_distribution_1d, sample_distribution_1d,
    )
    w = jnp.asarray([1.0, 3.0, 0.0, 4.0])
    cdf, pdf = make_distribution_1d(w)
    np.testing.assert_allclose(np.array(pdf), [0.125, 0.375, 0.0, 0.5], rtol=1e-6)
    np.testing.assert_allclose(float(cdf[-1]), 1.0, rtol=1e-6)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.random(20000, np.float32))
    idx, p = sample_distribution_1d(cdf, pdf, u)
    counts = np.bincount(np.array(idx), minlength=4) / 20000
    np.testing.assert_allclose(counts, np.array(pdf), atol=0.01)
    assert counts[2] == 0.0  # zero-weight bucket never sampled
    np.testing.assert_allclose(np.array(p), np.array(pdf)[np.array(idx)])
    # all-zero weights -> uniform fallback (reference funcInt==0 branch)
    _, pdf0 = make_distribution_1d(jnp.zeros(4))
    np.testing.assert_allclose(np.array(pdf0), 0.25)


def test_power_weighted_two_lights_unbiased():
    """Two area lights with very different power: the power-weighted
    selector must sample them ~proportionally AND keep the estimator
    unbiased (same mean as brute force)."""
    spheres = [
        sc.sphere([0, -1e4, 0], 1e4, 0),          # floor
        sc.sphere([-4, 6, 0], 1.5, 0, 0),         # bright light
        sc.sphere([4, 6, 0], 1.5, 0, 1),          # dim light
    ]
    mats = [sc.diffuse([0.7, 0.7, 0.7])]
    lgts = [sc.area_light(1, [50, 50, 50]), sc.area_light(2, [2, 2, 2])]
    scene = sc.make_scene(spheres, mats, lgts)
    cam = cm.make_camera([0, 6, 14], [0, 1, 0], [0, 1, 0], 24, 18, 60.0)
    bf = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4), 24)
    ne = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4, use_nee=True), 24)
    ratio = ne.mean() / bf.mean()
    assert abs(ratio - 1.0) < 0.05, ratio
    # selection distribution really is power-weighted
    from pathtracer.ops import lights as lt
    import jax.numpy as jnp
    u = jnp.asarray(np.random.default_rng(1).random((4000, 3), np.float32))
    p = jnp.tile(jnp.asarray([[0.0, 0.5, 3.0]]), (4000, 1))
    ls = lt.sample_lights(scene, p, u)
    to_bright = np.array(ls.wi)[:, 0] < 0
    assert 0.9 < to_bright.mean() < 1.0  # ~25/26 of samples go to the bright one
