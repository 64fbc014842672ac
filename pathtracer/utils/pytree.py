"""Frozen dataclasses registered as JAX pytrees.

`pytree_dataclass` turns a class into a frozen dataclass whose fields are
pytree children, except those declared with `static_field`, which become
compile-time metadata (part of the treedef, hashed by `jit`). Update a
value with `dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses

import jax

_STATIC = "static"


def static_field(default=dataclasses.MISSING):
    """A field kept out of the pytree leaves (value-free metadata)."""
    return dataclasses.field(default=default, metadata={_STATIC: True})


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get(_STATIC)],
        meta_fields=[f.name for f in fields if f.metadata.get(_STATIC)],
    )
