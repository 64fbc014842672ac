"""The persistent kernel's counter-based random numbers
(ops/pallas/persistent: hash_u32, stream_key, lane_base, uniform).

The kernel calls these same functions in interpret mode and compiled, so
their statistics here are the kernel's statistics on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import stats

from pathtracer.ops.pallas.persistent import (
    hash_u32, lane_base, stream_key, uniform,
)

N = 1 << 16


def _draws(seed=1, salt=0, frame=0, lanes=None, n_draw=8):
    key = stream_key(jnp.int32(seed), jnp.int32(salt), jnp.int32(frame))
    lanes = jnp.arange(N, dtype=jnp.int32) if lanes is None else lanes
    base = lane_base(key, lanes)
    return np.stack([np.asarray(uniform(base, j)) for j in range(n_draw)])


def test_range_and_resolution():
    u = _draws()
    assert u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0
    # 24-bit mantissa draws: all values are multiples of 2^-24
    assert np.all(u * (1 << 24) == np.floor(u * (1 << 24)))


@pytest.mark.parametrize("draw", [0, 3, 7])
def test_uniformity_chi_square(draw):
    """64-bin chi-square per draw index, p > 1e-4."""
    u = _draws()[draw]
    counts, _ = np.histogram(u, bins=64, range=(0.0, 1.0))
    assert stats.chisquare(counts).pvalue > 1e-4
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / N)


def test_independence_across_lanes_and_draws():
    """Neighbouring lanes, and successive draws of one lane, are
    uncorrelated (|r| < 5 / sqrt(N))."""
    u = _draws()
    tol = 5 / np.sqrt(N)
    assert abs(np.corrcoef(u[0, :-1], u[0, 1:])[0, 1]) < tol
    assert abs(np.corrcoef(u[0], u[1])[0, 1]) < tol
    assert abs(np.corrcoef(u[2], u[5])[0, 1]) < tol
    # pairs of (lane, lane + 1) fill the unit square evenly
    h, _, _ = np.histogram2d(u[0, :-1], u[0, 1:], bins=8)
    assert stats.chisquare(h.ravel()).pvalue > 1e-4


def test_streams_differ_by_seed_salt_and_frame():
    a = _draws(seed=1)
    for other in (_draws(seed=2), _draws(salt=1), _draws(frame=1)):
        assert np.mean(a == other) < 1e-3
        assert abs(np.corrcoef(a[0], other[0])[0, 1]) < 5 / np.sqrt(N)


def test_addressed_by_global_lane():
    """A shard holding lanes [off, off + n) draws exactly what the full
    range draws there: streams depend on the global lane id alone."""
    full = _draws()
    off = 12345
    part = _draws(lanes=jnp.arange(off, off + 1000, dtype=jnp.int32))
    np.testing.assert_array_equal(part, full[:, off:off + 1000])


def test_hash_is_a_bijection_on_a_window():
    """lowbias32 is invertible, so distinct inputs never collide."""
    x = jnp.arange(N, dtype=jnp.uint32) * jnp.uint32(2654435761)
    h = np.asarray(hash_u32(x))
    assert len(np.unique(h)) == N
