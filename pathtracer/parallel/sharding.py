"""Sharded rendering via shard_map over a (tile, sample) mesh.

The distribution the reference lacks entirely (SURVEY.md §5 "Distributed
communication backend: none"): pixels and sample batches are sharded over
the mesh axes with the scene pytree replicated on every device (it is
KB-scale, like the reference's device copy at pathtracer.cu:176-204), and
sample-axis reductions are XLA collectives (pmean/psum), not
point-to-point traffic.

Because the RNG is keyed on global lane ids (utils/rng.py), the sharded
render is BIT-IDENTICAL to the single-device render for any mesh shape —
asserted by tests/test_sharding.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array
from jax.sharding import PartitionSpec as P
from jax import shard_map

from pathtracer.models.camera import Camera
from pathtracer.models.integrator import RenderConfig, trace_pixels
from pathtracer.models.scene import Scene
from pathtracer.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from pathtracer.utils import rng


def _lane_matrix(camera: Camera, spp: int) -> Array:
    """Global lane ids laid out (n_pixels, spp): lane = pix*spp + s."""
    n_pix = camera.height * camera.width
    pix = jnp.arange(n_pix, dtype=jnp.int32)[:, None]
    s = jnp.arange(spp, dtype=jnp.int32)[None, :]
    return pix * spp + s


def render_sharded(
    scene: Scene,
    camera: Camera,
    key: Array,
    config: RenderConfig,
    mesh: jax.sharding.Mesh,
    iteration: Array | int = 0,
) -> Array:
    """Render one iteration sharded over the mesh; returns (H, W, 3).

    Pixels shard over the ``tile`` axis, spp over ``sample``; the per-pixel
    sample mean is an on-mesh pmean over ``sample`` (an all-reduce — the
    distributed form of the in-thread subsample average at
    pathtracer.cu:96-101).
    """
    H, W, spp = camera.height, camera.width, config.spp
    it_key = rng.iteration_key(key, iteration)
    lanes = _lane_matrix(camera, spp)  # (H*W, spp)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS, SAMPLE_AXIS)),
        out_specs=P(TILE_AXIS),
    )
    def shard_render(scene_rep: Scene, camera_rep: Camera, lane_block: Array):
        block_shape = lane_block.shape  # (pix_local, spp_local)
        rad = trace_pixels(
            scene_rep, camera_rep, lane_block.reshape(-1), it_key, config
        ).reshape(block_shape + (3,))
        # Mean over the full sample axis: local mean then pmean over shards.
        local_mean = rad.mean(axis=1)
        return jax.lax.pmean(local_mean, SAMPLE_AXIS)

    img = shard_render(scene, camera, lanes)  # (H*W, 3), tile-sharded
    return img.reshape(H, W, 3)


@partial(jax.jit, static_argnames=("config", "mesh"))
def _render_sharded_compiled(scene, camera, key, config, mesh, iteration):
    return render_sharded(scene, camera, key, config, mesh, iteration)


def render_sharded_jit(
    scene: Scene,
    camera: Camera,
    key: Array,
    config: RenderConfig,
    mesh: jax.sharding.Mesh,
    iteration: Array | int = 0,
) -> Array:
    """Jitted sharded render (config and mesh are compile-time static)."""
    return _render_sharded_compiled(scene, camera, key, config, mesh, iteration)
