"""The persistent path-regeneration kernel under shard_map.

The per-lane `PathState` (ops/pallas/persistent.py) is sharded over the
flattened (tile, sample) device mesh, and every shard runs the SAME kernel
one device would run on its lanes. Each shard passes the global id of its
first lane as `lane_offset`, so the lane -> pixel map and the counter-based
random streams are functions of the GLOBAL lane alone: a sharded run is
bit-identical to the single-device run for any mesh shape — the property
tests/test_sharding.py asserts for the XLA path, here for the kernel path
(tests/test_persistent.py).

The scene, camera and seed are replicated (KB-scale, like the reference's
device copy at pathtracer.cu:176-204); the only collective is a psum of
the live-ray counter.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
from jax import Array, shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from pathtracer.models.camera import Camera
from pathtracer.models.scene import Scene
from pathtracer.ops.pallas.persistent import (
    BLOCK, PathState, init_state, persistent_step,
)
from pathtracer.parallel.mesh import SAMPLE_AXIS, TILE_AXIS

_AXES = (TILE_AXIS, SAMPLE_AXIS)


@lru_cache(maxsize=None)
def _init_program(width: int, height: int, mesh: jax.sharding.Mesh,
                  block: int):
    # one compiled program per shape and mesh: a fresh jit per call would
    # compile again every time a render restarts
    make = partial(init_state, width, height, block,
                   blocks_multiple=mesh.devices.size)
    lanes = NamedSharding(mesh, P(_AXES))
    rep = NamedSharding(mesh, P())
    shardings = jax.tree.map(lambda x: rep if x.ndim == 0 else lanes,
                             jax.eval_shape(make))
    return jax.jit(make, out_shardings=shardings)


def init_state_sharded(width: int, height: int, mesh: jax.sharding.Mesh,
                       block: int = BLOCK) -> PathState:
    """A PathState whose lanes are placed shard-major over the mesh, built
    on the devices (no host transfer)."""
    return _init_program(width, height, mesh, block)()


def persistent_step_sharded(
    scene: Scene,
    camera: Camera,
    seed: Array,
    state: PathState,
    mesh: jax.sharding.Mesh,
    **kw,
) -> tuple[PathState, Array]:
    """One persistent_step per shard (keyword arguments as there).
    Returns (new_state, total live rays), bit-identical to the
    single-device step for any mesh shape."""
    n_pad = state.lr.shape[0]
    n_dev = mesh.devices.size
    block = kw.get("block", BLOCK)
    if n_pad % (n_dev * block):
        raise ValueError(
            f"{n_pad} lanes are not whole blocks on {n_dev} devices; build "
            "the state with init_state_sharded(..., mesh)")
    lanes_local = n_pad // n_dev
    specs = jax.tree.map(lambda x: P() if x.ndim == 0 else P(_AXES), state)

    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P(), specs),
             out_specs=(specs, P()), check_vma=False)
    def sharded(scene_rep, cam_rep, seed_rep, st):
        shard = (jax.lax.axis_index(TILE_AXIS) * mesh.shape[SAMPLE_AXIS]
                 + jax.lax.axis_index(SAMPLE_AXIS))
        new_st, nrays = persistent_step(
            scene_rep, cam_rep, seed_rep, st,
            lane_offset=shard * lanes_local, **kw)
        return new_st, jax.lax.psum(nrays, _AXES)

    return sharded(scene, camera, seed, state)


@partial(
    jax.jit,
    static_argnames=("mesh", "budget", "max_bounces", "rr_start", "use_nee",
                     "strat_k", "block", "interpret"),
    donate_argnames=("state",),
)
def persistent_step_sharded_jit(scene, camera, seed, state, mesh, **kw):
    return persistent_step_sharded(scene, camera, seed, state, mesh, **kw)
