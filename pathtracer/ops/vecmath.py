"""Batched 3D vector math on trailing-dimension-3 arrays.

Array replacement for the reference's scalar `Vec`/`Point`/`Color`
structs (reference geometry.h:28-546). Instead of an array-of-structs, every
vector quantity in this framework is a `(..., 3)` float32 array (SoA-style
batching), so all ops vectorize over lanes.

All functions are shape-polymorphic over leading batch dims.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array, lax


def dot(a: Array, b: Array) -> Array:
    """Batched dot product over the trailing axis. (...,3),(...,3) -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: Array, b: Array) -> Array:
    """Batched cross product (reference geometry.h Vec::Cross semantics)."""
    return jnp.cross(a, b)


def length_sq(a: Array) -> Array:
    return jnp.sum(a * a, axis=-1)


def length(a: Array) -> Array:
    return safe_sqrt(length_sq(a))


def safe_sqrt(x: Array) -> Array:
    """sqrt clamped at zero, with a finite gradient at x<=0.

    jnp.sqrt has an infinite gradient at 0 and NaN below; masking with
    `where` on both the primal and the operand keeps reverse-mode clean
    (needed because the whole integrator is differentiated end-to-end).
    """
    safe = jnp.where(x > 0.0, x, 1.0)
    return jnp.where(x > 0.0, jnp.sqrt(safe), 0.0)


def normalize(a: Array, eps: float = 1e-20) -> Array:
    """Unit vector along a; returns 0 for (near-)zero input instead of NaN."""
    sq = length_sq(a)[..., None]
    inv = jnp.where(sq > eps, lax.rsqrt(jnp.where(sq > eps, sq, 1.0)), 0.0)
    return a * inv


def distance_sq(a: Array, b: Array) -> Array:
    return length_sq(a - b)


def distance(a: Array, b: Array) -> Array:
    return length(a - b)


def lerp(t: Array, v1: Array, v2: Array) -> Array:
    """(1-t)*v1 + t*v2 (reference globals.h:103-105)."""
    return (1.0 - t) * v1 + t * v2


def luminance(c: Array) -> Array:
    """Rec.601 luma, reference geometry.h Color::Y() semantics."""
    w = jnp.array([0.212671, 0.715160, 0.072169], dtype=c.dtype)
    return jnp.sum(c * w, axis=-1)


def max_component(c: Array) -> Array:
    """Max RGB component (reference Color::Max; drives Russian roulette)."""
    return jnp.max(c, axis=-1)


def is_black(c: Array, eps: float = 0.0) -> Array:
    """True where a color has no contribution (reference Color::IsBlack)."""
    return jnp.all(c <= eps, axis=-1)


def orthonormal_basis(n: Array) -> tuple[Array, Array]:
    """Build (u, v) completing unit normal n to a right-handed ONB.

    Same branch structure as the reference's RotateByNormal
    (montecarlo.h:120-125) but with the tangent normalized — the reference
    omits the normalization, which skews its cosine-hemisphere distribution;
    we build the correct frame (SURVEY.md §3.6: don't replicate defects).
    """
    cond = (jnp.abs(n[..., 0]) > jnp.abs(n[..., 2]))[..., None]
    u = jnp.where(
        cond,
        jnp.stack([-n[..., 1], n[..., 0], jnp.zeros_like(n[..., 0])], axis=-1),
        jnp.stack([jnp.zeros_like(n[..., 0]), -n[..., 2], n[..., 1]], axis=-1),
    )
    u = normalize(u)
    v = cross(n, u)
    return u, v


def to_world(local: Array, n: Array) -> Array:
    """Rotate a z-up local-frame vector into the frame around normal n."""
    u, v = orthonormal_basis(n)
    return (
        u * local[..., 0:1] + v * local[..., 1:2] + n * local[..., 2:3]
    )
