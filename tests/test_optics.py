"""Unit tests for reflection/refraction/Fresnel (reference globals.h:107-126)."""
import jax.numpy as jnp
import numpy as np

from pathtracer.ops import optics, vecmath as vm


def test_reflect_mirror_law():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    wo = vm.normalize(jnp.asarray([[1.0, -1.0, 0.0]]))  # toward surface
    wi = optics.reflect(wo, n)
    np.testing.assert_allclose(np.array(wi[0]), [2**-0.5, 2**-0.5, 0.0], atol=1e-6)
    # Angle of incidence == angle of reflection, length preserved.
    np.testing.assert_allclose(vm.length(wi), [1.0], atol=1e-6)
    np.testing.assert_allclose(vm.dot(-wo, n), vm.dot(wi, n), atol=1e-6)


def test_refract_snells_law():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    theta_i = 0.5
    wo = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], dtype=jnp.float32)
    eta = jnp.asarray([1.0 / 1.5])
    wt = optics.refract(wo, n, eta)
    sin_t = float(jnp.abs(wt[0, 0]))
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, rtol=1e-5)
    assert float(wt[0, 1]) < 0  # continues into the surface
    np.testing.assert_allclose(vm.length(wt), [1.0], atol=1e-6)


def test_refract_normal_incidence_straight_through():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    wo = jnp.asarray([[0.0, -1.0, 0.0]])
    wt = optics.refract(wo, n, jnp.asarray([1.0 / 1.5]))
    np.testing.assert_allclose(np.array(wt[0]), [0.0, -1.0, 0.0], atol=1e-6)


def test_fresnel_normal_incidence():
    # R0 = ((n1-n2)/(n1+n2))^2 = (0.5/2.5)^2 = 0.04 for glass.
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    inc = jnp.asarray([[0.0, -1.0, 0.0]])
    r = optics.fresnel_reflectance(inc, n, jnp.asarray([1.0]), jnp.asarray([1.5]))
    np.testing.assert_allclose(float(r[0]), 0.04, rtol=1e-4)


def test_fresnel_grazing_goes_to_one():
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    inc = vm.normalize(jnp.asarray([[1.0, -1e-3, 0.0]]))
    r = optics.fresnel_reflectance(inc, n, jnp.asarray([1.0]), jnp.asarray([1.5]))
    assert float(r[0]) > 0.98


def test_fresnel_tir():
    # From dense to rare beyond the critical angle: R = 1.
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    crit = np.arcsin(1.0 / 1.5)
    theta = crit + 0.1
    inc = jnp.asarray([[np.sin(theta), -np.cos(theta), 0.0]], dtype=jnp.float32)
    r = optics.fresnel_reflectance(inc, n, jnp.asarray([1.5]), jnp.asarray([1.0]))
    np.testing.assert_allclose(float(r[0]), 1.0, atol=1e-6)


def test_fresnel_energy_range():
    rng = np.random.default_rng(0)
    dirs = vm.normalize(jnp.asarray(rng.normal(size=(1000, 3)).astype(np.float32)))
    # Point all directions downward (toward surface with +y normal).
    d = np.array(dirs)
    d[:, 1] = -np.abs(d[:, 1]) - 1e-3
    dirs = vm.normalize(jnp.asarray(d))
    n = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (1000, 1))
    r = optics.fresnel_reflectance(dirs, n, jnp.ones(1000), jnp.full(1000, 1.5))
    arr = np.array(r)
    assert np.all(arr >= 0.0 - 1e-6) and np.all(arr <= 1.0 + 1e-6)
