"""Device-mesh construction for multi-chip / multi-host rendering.

The reference is single-process single-GPU with no distribution of any
kind (SURVEY.md §2 "Parallelism strategies"). This module adds two scaling
axes as first-class:

  - ``tile``   : pixel-space data parallelism (image tiles across devices)
                 — "one CUDA thread per pixel" (reference
                 pathtracer.cu:227-230) generalized across cards;
  - ``sample`` : samples-per-pixel parallelism (independent MC estimates of
                 the same pixels, psum-reduced) — the distributed analogue
                 of the in-thread 4x subsample loop (pathtracer.cu:96-100).

The cards of one host are joined all to all by NVLink, so the mesh shape
follows the algorithm alone; XLA hands the collectives to NCCL.
Multi-host process coordination uses jax.distributed as usual.
"""
from __future__ import annotations

import math
from typing import Sequence

import jax
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def _factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b) with a*b = n, a >= b, as square as possible."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def make_mesh(
    devices: Sequence[jax.Device] | None = None,
    n_tile: int | None = None,
    n_sample: int | None = None,
) -> Mesh:
    """Build a (tile, sample) mesh over the given (default: all) devices.

    With no explicit split, devices are factored ~square between the two
    axes so both pixel- and sample-parallelism are exercised.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_tile is None and n_sample is None:
        n_tile, n_sample = _factor2(n)
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    if n_tile * n_sample != n:
        raise ValueError(f"mesh {n_tile}x{n_sample} != {n} devices")
    import numpy as np

    return Mesh(
        np.asarray(devices).reshape(n_tile, n_sample),
        (TILE_AXIS, SAMPLE_AXIS),
    )
