"""Texture sampling: bilinear lookup from a stacked texture atlas.

Supports BASELINE config 4's "textured triangle-mesh scene". Textures are
stored as one (K, TH, TW, 3) stack (all the same resolution); materials
reference a texture index (-1 = untextured), and the sampled texel
MODULATES the material's base color (tex * mat_color) — keeping albedo
linear in mat_color for every adjoint, and making the atlas itself a
differentiable parameter through this sampler's gathers (autodiff path).
Lookups are XLA gathers over flattened indices.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def sample_bilinear(textures: Array, tex_id: Array, uv: Array) -> Array:
    """Bilinear sample. textures (K,TH,TW,3); tex_id (N,); uv (N,2) in [0,1]
    (wrapped). Returns (N,3); lanes with tex_id < 0 return 0 (caller
    selects its fallback color)."""
    K, TH, TW, _ = textures.shape
    flat = textures.reshape(-1, 3)

    u = uv[:, 0] % 1.0
    v = uv[:, 1] % 1.0
    x = u * TW - 0.5
    y = v * TH - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    k = jnp.clip(tex_id, 0, K - 1)

    def at(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), TW)
        yi = jnp.mod(yi.astype(jnp.int32), TH)
        idx = (k * TH + yi) * TW + xi
        return jnp.take(flat, idx, axis=0)

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy
    return out * (tex_id >= 0)[:, None]
