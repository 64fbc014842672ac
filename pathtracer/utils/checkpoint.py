"""Checkpoint / resume for progressive renders and inverse-rendering runs.

The reference's only persistent state is the in-GPU accumulation buffer +
iteration counter, lost on exit (SURVEY.md §5 "Checkpoint/resume: none on
disk; there is no image save at all"). Here both long-running workloads
snapshot any state pytree to a NumPy `.npz` file per step:

  - progressive rendering: AccumulatorState (radiance sum + iteration) or
    the persistent kernel's PathState — every snapshot is a valid partial
    result, and a resumed render continues exactly where it stopped,
    bit-for-bit (counter-based RNG keys off the iteration / frame);
  - inverse rendering: TrainState (params + optimizer state + step).

The leaves are stored in tree order; restoring needs a template of the
same structure (e.g. a freshly initialized state).
"""
from __future__ import annotations

import os
import re
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}.npz")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                os.listdir(directory)) if m)


def save_state(directory: str, step: int, state: Any,
               max_to_keep: int = 3) -> None:
    """Snapshot any pytree at `step`, keeping the newest `max_to_keep`."""
    os.makedirs(directory, exist_ok=True)
    leaves = [np.asarray(x) for x in jax.tree.leaves(state)]
    tmp = _path(directory, step) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, *leaves)
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_state(directory: str, template: Any, step: int | None = None) -> Any:
    """Restore a pytree saved by save_state; `template` supplies the
    structure (and is checked against the stored shapes)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    leaves, treedef = jax.tree.flatten(template)
    with np.load(_path(directory, step)) as data:
        stored = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(stored) != len(leaves):
        raise ValueError(f"checkpoint has {len(stored)} arrays, template "
                         f"{len(leaves)}")
    for i, (a, t) in enumerate(zip(stored, leaves)):
        if a.shape != np.shape(t):
            raise ValueError(f"leaf {i}: stored shape {a.shape} != "
                             f"template {np.shape(t)}")
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in stored])
