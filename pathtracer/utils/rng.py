"""Counter-based RNG discipline for the path tracer.

The reference regenerates one giant cuRAND uniform batch every frame
(w*h*8*maxBounces*3 floats, reference pathtracer.cu:206-208,223-225) and
indexes it per pixel/bounce (pathtracer.cu:92,141,155). Here we instead
derive every uniform from a threefry key by structured `fold_in`: no giant
buffer, perfectly reproducible, and — crucially for path-replay
differentiation and for sharding — any draw is regenerable from
(seed, iteration, stream, bounce, global lane id) alone.

Because draws are keyed on the GLOBAL lane index (not array position), a
render sharded over any device mesh produces bit-identical uniforms to the
single-device render — the property the distributed tests assert
(SURVEY.md §4 "sharded render == single-device render for a given seed").

Stream layout per render iteration (mirrors the reference's sample layout,
reference pathtracer.cu:92,141,155 / globals.h:50-51):
  - CAMERA stream: 2 uniforms per path sample (sub-pixel jitter);
  - BOUNCE stream, per bounce: 3 uniforms per path sample —
    (bsdf u, bsdf v, russian roulette);
  - LIGHT stream, per bounce: 3 uniforms for NEE (live extension of the
    reference's dead NEE code path);
  - LENS stream: 2 uniforms for thin-lens DOF (reference TODO camera.h:68).

Unlike the reference, each of the spp subsamples is an independent lane
with its own stream (the reference shares one stream across its 4
subsamples, a defect noted in SURVEY.md §3.6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

CAMERA_STREAM = 0
BOUNCE_STREAM = 1
LIGHT_STREAM = 2
LENS_STREAM = 3


def iteration_key(base_key: Array, iteration: Array | int) -> Array:
    """Key for one progressive-rendering iteration (frame)."""
    return jax.random.fold_in(base_key, iteration)


def _lane_keys(stream_key: Array, lane_ids: Array) -> Array:
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(stream_key, lane_ids)


def lane_uniforms(
    it_key: Array,
    stream: int,
    bounce: Array | int,
    lane_ids: Array,
    n: int,
) -> Array:
    """n uniforms per lane, shape (len(lane_ids), n), in [0, 1).

    Deterministic in (it_key, stream, bounce, lane_id): lane layout,
    sharding, and batch size never change the values.
    """
    k = jax.random.fold_in(jax.random.fold_in(it_key, stream), bounce)
    keys = _lane_keys(k, lane_ids)
    return jax.vmap(lambda kk: jax.random.uniform(kk, (n,), jnp.float32))(keys)


def camera_uniforms(it_key: Array, lane_ids: Array) -> Array:
    """(u, v) sub-pixel jitter uniforms, (n_lanes, 2)."""
    return lane_uniforms(it_key, CAMERA_STREAM, 0, lane_ids, 2)


def lens_uniforms(it_key: Array, lane_ids: Array) -> Array:
    """(u, v) thin-lens aperture uniforms, (n_lanes, 2)."""
    return lane_uniforms(it_key, LENS_STREAM, 0, lane_ids, 2)


def bounce_uniforms(it_key: Array, bounce: Array | int, lane_ids: Array) -> Array:
    """Per-bounce (bsdf u, bsdf v, russian roulette), (n_lanes, 3)."""
    return lane_uniforms(it_key, BOUNCE_STREAM, bounce, lane_ids, 3)


def light_uniforms(it_key: Array, bounce: Array | int, lane_ids: Array) -> Array:
    """Per-bounce NEE uniforms (light u, light v, select), (n_lanes, 3)."""
    return lane_uniforms(it_key, LIGHT_STREAM, bounce, lane_ids, 3)
