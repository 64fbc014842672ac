"""Debug / sanitizer configuration.

The reference had no sanitizers and no races to find — each CUDA thread
owned its pixel (SURVEY.md §5 "Race detection"). JAX's functional purity
removes data races by construction; what remains worth catching is
numerical poison (NaN/Inf from the sqrt/rsqrt/division heavy integrator)
and out-of-range indexing. This module centralizes those switches:

  with debug_mode():            # NaN/Inf checking on every jit output
      render(...)

  checked = checkify_render(render_fn)   # functional error values
  img, err = checked(...)
  err.throw()

Kernel debugging: run the Pallas kernel through the interpreter by passing
interpret=True (ops/pallas/persistent.persistent_step).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import jax
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Enable jax_debug_nans / jax_debug_infs within the scope."""
    old_nans = jax.config.jax_debug_nans
    old_infs = jax.config.jax_debug_infs
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_debug_infs", infs)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)
        jax.config.update("jax_debug_infs", old_infs)


def checkify_render(fn: Callable, errors=None) -> Callable:
    """Wrap a render/step function with checkify error tracking.

    Returns a function producing (error, output); call error.throw() to
    surface float (NaN/Inf) and index errors raised inside jit.
    """
    if errors is None:
        errors = checkify.float_checks | checkify.index_checks
    return checkify.checkify(fn, errors=errors)
