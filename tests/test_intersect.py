"""Ray-sphere intersection vs a float64 NumPy oracle.

The oracle mirrors the reference's quadratic + root selection
(reference primitive.h:39-45) and closest-hit scan (scene.h:71-94) in
float64; the expanded contraction form (ops/intersect.py) must agree within
float32 tolerance, including on the 1e5-radius "wall" spheres where the
quadratic cancellation is worst.
"""
import jax.numpy as jnp
import numpy as np

from pathtracer.models import scene as sc
from pathtracer.ops.intersect import BIG, intersect, intersect_p, ray_sphere_t
from pathtracer.models.scene import EPSILON, prim_attrs


def oracle_t(centers, radii, o, d, tmin=EPSILON, tmax=None):
    """float64 reference root selection, per (ray, prim)."""
    if tmax is None:
        tmax = np.inf
    op = centers[None, :, :] - o[:, None, :]
    b = np.sum(op * d[:, None, :], -1)
    det = b * b - np.sum(op * op, -1) + (radii**2)[None, :]
    sq = np.sqrt(np.maximum(det, 0.0))
    t0, t1 = b - sq, b + sq
    t = np.where(
        t0 > tmin,
        np.where(t0 < tmax, t0, np.inf),
        np.where((t1 > tmin) & (t1 < tmax), t1, np.inf),
    )
    return np.where(det < 0, np.inf, t)


def random_rays(n, seed, scale=100.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_unit_sphere_basic_cases():
    scene = sc.make_scene([sc.sphere([0, 0, 0], 1.0, 0)], [sc.diffuse([1, 1, 1])])
    o = jnp.asarray([[0, 0, 5.0], [0, 0, 5.0], [0, 0, 0.0], [0, 3, 5.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0, 0, 1.0], [1, 0, 0.0], [0, 0, -1.0]], jnp.float32)
    t = np.array(ray_sphere_t(scene, o, d)).min(-1)
    np.testing.assert_allclose(t[0], 4.0, rtol=1e-5)  # outside hit
    assert t[1] >= BIG * 0.5  # pointing away -> miss
    np.testing.assert_allclose(t[2], 1.0, rtol=1e-5)  # inside -> far root
    assert t[3] >= BIG * 0.5  # parallel miss


def test_matches_oracle_on_cornell():
    scene, _ = sc.cornell_spheres()
    centers = np.array(scene.centers, np.float64)[: scene.num_prims]
    radii = np.array(scene.radii, np.float64)[: scene.num_prims]
    o, d = random_rays(2000, 0, scale=60.0)
    t_ref = oracle_t(centers, radii, o, d).min(-1)
    idx_ref = oracle_t(centers, radii, o, d).argmin(-1)

    t_jax = np.array(
        ray_sphere_t(scene, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32))
    )[:, : scene.num_prims]
    t_min = t_jax.min(-1)
    hit_ref = np.isfinite(t_ref)
    hit_jax = t_min < BIG * 0.5
    # f32 quadratic on 1e5-scale spheres: allow a small fraction of edge
    # disagreements near tmin boundaries.
    agree = hit_ref == hit_jax
    assert agree.mean() > 0.995, f"hit agreement {agree.mean()}"
    both = hit_ref & hit_jax & agree
    # Hit distance: relative tolerance scaled for f32 catastrophic
    # cancellation on giant spheres (same error class as the reference).
    np.testing.assert_allclose(t_min[both], t_ref[both], rtol=5e-3, atol=5e-2)
    # Same prim chosen where distances are well-separated.
    sep = both.copy()
    idx_jax = t_jax.argmin(-1)
    same = (idx_jax == idx_ref)[sep]
    assert same.mean() > 0.99


def test_closest_hit_and_attrs():
    scene = sc.make_scene(
        [
            sc.sphere([0, 0, -5], 1.0, 0),
            sc.sphere([0, 0, -10], 1.0, 1, 0),
        ],
        [sc.diffuse([0.9, 0.1, 0.1]), sc.diffuse([0.1, 0.9, 0.1])],
        [sc.area_light(1, [7.0, 7.0, 7.0])],
    )
    attrs = prim_attrs(scene)
    o = jnp.asarray([[0, 0, 0.0], [3, 0, -10.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [-1, 0, 0.0]], jnp.float32)
    h = intersect(scene, attrs, o, d)
    assert bool(h.hit[0]) and bool(h.hit[1])
    np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
    assert int(h.prim[0]) == 0 and int(h.prim[1]) == 1
    np.testing.assert_allclose(np.array(h.n[0]), [0, 0, 1.0], atol=1e-5)
    np.testing.assert_allclose(np.array(h.albedo[0]), [0.9, 0.1, 0.1], rtol=1e-6)
    np.testing.assert_allclose(np.array(h.emission[0]), [0, 0, 0], atol=1e-7)
    np.testing.assert_allclose(np.array(h.emission[1]), [7.0, 7.0, 7.0], rtol=1e-6)
    np.testing.assert_allclose(np.array(h.p[1]), [1.0, 0.0, -10.0], atol=1e-4)


def test_tmin_respected_no_self_hit():
    scene = sc.make_scene([sc.sphere([0, 0, 0], 1.0, 0)], [sc.diffuse([1, 1, 1])])
    attrs = prim_attrs(scene)
    # Origin on the surface, pointing away: must miss (epsilon shield).
    o = jnp.asarray([[0, 0, 1.0]], jnp.float32)
    d = jnp.asarray([[0, 0, 1.0]], jnp.float32)
    h = intersect(scene, attrs, o, d)
    assert not bool(h.hit[0])


def test_intersect_p_segments():
    scene = sc.make_scene([sc.sphere([0, 0, -5], 1.0, 0)], [sc.diffuse([1, 1, 1])])
    o = jnp.asarray([[0, 0, 0.0], [0, 0, 0.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0, 0, -1.0]], jnp.float32)
    # Full segment sees the occluder; a short segment (tmax=2) does not.
    occ = np.array(intersect_p(scene, o, d, tmax=jnp.asarray([BIG, 2.0])))
    assert bool(occ[0]) and not bool(occ[1])


def test_padding_prims_never_hit():
    scene = sc.make_scene([sc.sphere([0, 0, -5], 1.0, 0)], [sc.diffuse([1, 1, 1])])
    o, d = random_rays(500, 3, scale=20.0)
    t = np.array(ray_sphere_t(scene, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)))
    assert np.all(t[:, 1:] >= BIG * 0.5)  # all padded rows miss
