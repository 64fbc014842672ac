"""Profiling hooks: device traces and compiled-cost introspection.

SURVEY.md §5 tracing plan: wall-clock counters live in utils/metrics.py;
this module adds the two deeper tools —

  - `trace(logdir)`: jax.profiler device trace around a render section,
    viewable in Perfetto/TensorBoard (`tensorboard --logdir ...` or
    ui.perfetto.dev on the generated .trace files);
  - `cost_report(fn, *args)`: XLA's static cost analysis of the compiled
    executable (flops, bytes accessed, peak memory) — the per-kernel cost
    breakdown the reference never had beyond a title-bar FPS readout.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace for everything run inside the scope."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def cost_report(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Compile fn for the given args and return XLA's cost analysis."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):  # per-device list on some backends
        cost = cost[0] if cost else {}
    mem = compiled.memory_analysis()
    out = {k: v for k, v in dict(cost or {}).items()}
    if mem is not None:
        for attr in ("temp_size_in_bytes", "argument_size_in_bytes",
                     "output_size_in_bytes", "generated_code_size_in_bytes"):
            if hasattr(mem, attr):
                out[attr] = getattr(mem, attr)
    return out
