"""Multi-host process coordination.

The reference is one process on one GPU (SURVEY.md §5 "Distributed
communication backend: none"). Scaling past a single host uses JAX's
standard recipe: `jax.distributed.initialize` for process coordination
across hosts, then the SAME (tile, sample) mesh code (parallel/mesh.py,
parallel/sharding.py) spanning all hosts' devices — the collectives are
inserted by XLA (NCCL on GPUs), with no explicit communication calls
anywhere in this codebase.

Typical multi-host entry:

    from pathtracer.parallel import multihost, mesh
    multihost.initialize(coord, n, i)   # "host:port", process count, rank
    m = mesh.make_mesh()                # global mesh over ALL hosts' chips
    img = render_sharded_jit(scene, cam, key, cfg, m)   # unchanged code

Local multi-process testing (SURVEY.md §4): run N processes with
`initialize(coordinator, n, i)` on CPU and the sharding tests' math is
exercised across real process boundaries; see
tests/test_multihost_launcher.py.
"""
from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join (or start) the distributed runtime.

    With no arguments, relies on JAX's cluster auto-detection (which needs
    a cluster environment that announces itself). No-op if already
    initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def is_primary() -> bool:
    """True on the process that should write checkpoints/images."""
    return jax.process_index() == 0


def process_info() -> tuple[int, int]:
    return jax.process_index(), jax.process_count()
