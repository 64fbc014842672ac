"""Unit tests for the vector-math foundation (reference geometry.h parity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops import vecmath as vm


def rand(shape, seed=0, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))


def test_dot_cross_against_numpy():
    a, b = rand((64, 3), 1), rand((64, 3), 2)
    np.testing.assert_allclose(vm.dot(a, b), np.sum(np.array(a) * np.array(b), -1), rtol=1e-6)
    np.testing.assert_allclose(vm.cross(a, b), np.cross(np.array(a), np.array(b)), rtol=1e-5, atol=1e-6)


def test_normalize_unit_length_and_zero_safe():
    a = rand((128, 3), 3, -5, 5)
    n = vm.normalize(a)
    np.testing.assert_allclose(vm.length(n), np.ones(128), rtol=1e-5)
    z = vm.normalize(jnp.zeros((4, 3)))
    assert not np.any(np.isnan(np.array(z)))
    np.testing.assert_array_equal(np.array(z), np.zeros((4, 3)))


def test_safe_sqrt_value_and_grad():
    x = jnp.array([4.0, 0.0, -1.0])
    np.testing.assert_allclose(vm.safe_sqrt(x), [2.0, 0.0, 0.0])
    g = jax.grad(lambda v: jnp.sum(vm.safe_sqrt(v)))(x)
    assert np.all(np.isfinite(np.array(g)))
    np.testing.assert_allclose(g[0], 0.25, rtol=1e-6)


def test_orthonormal_basis():
    n = vm.normalize(rand((256, 3), 4, -1, 1))
    u, v = vm.orthonormal_basis(n)
    for vec in (u, v):
        np.testing.assert_allclose(vm.length(vec), np.ones(256), rtol=1e-5)
    np.testing.assert_allclose(vm.dot(u, n), np.zeros(256), atol=1e-5)
    np.testing.assert_allclose(vm.dot(v, n), np.zeros(256), atol=1e-5)
    np.testing.assert_allclose(vm.dot(u, v), np.zeros(256), atol=1e-5)
    # Right-handed: u x v == n
    np.testing.assert_allclose(vm.cross(u, v), np.array(n), atol=1e-5)


def test_to_world_preserves_z_as_normal():
    n = vm.normalize(rand((32, 3), 5))
    local = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (32, 1))
    w = vm.to_world(local, n)
    np.testing.assert_allclose(np.array(w), np.array(n), atol=1e-5)


def test_max_component_is_black_luminance():
    c = jnp.array([[0.1, 0.5, 0.2], [0.0, 0.0, 0.0]])
    np.testing.assert_allclose(vm.max_component(c), [0.5, 0.0])
    np.testing.assert_array_equal(np.array(vm.is_black(c)), [False, True])
    np.testing.assert_allclose(vm.luminance(jnp.ones((3,))), 1.0, rtol=1e-4)


def test_lerp():
    np.testing.assert_allclose(vm.lerp(jnp.float32(0.25), 2.0, 6.0), 3.0)
