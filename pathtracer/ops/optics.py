"""Geometric optics: mirror reflection, Snell refraction, Fresnel dielectric.

Array forms of reference globals.h:107-126, vectorized and made
safe for reverse-mode autodiff (no NaN paths under TIR).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from pathtracer.ops import vecmath as vm


def reflect(wo: Array, n: Array) -> Array:
    """Mirror reflection of incident direction wo about normal n.

    Reference globals.h:107-109: wo points TOWARD the surface (ray.d), so
    the reflected direction is wo - 2(wo.n)n.
    """
    return wo - 2.0 * vm.dot(wo, n)[..., None] * n


def refract(wo: Array, n: Array, eta: Array) -> Array:
    """Snell refraction of wo through interface with relative IOR eta = n1/n2.

    Reference globals.h:111-115. Under total internal reflection the
    reference would sqrt a negative; here the radicand is clamped (the
    Fresnel term routes TIR lanes to `reflect`, so clamped lanes are
    never selected).
    """
    cos_i = vm.dot(wo, n)
    cos2_t = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    cos_t = vm.safe_sqrt(cos2_t)
    return vm.normalize(
        wo * eta[..., None] - ((eta * cos_i + cos_t))[..., None] * n
    )


def fresnel_reflectance(inc: Array, nor: Array, n1: Array, n2: Array) -> Array:
    """Unpolarized Fresnel reflectance for a dielectric interface, with TIR.

    Reference globals.h:117-126: full (not Schlick) Fresnel; returns 1 for
    total internal reflection. `inc` points toward the surface; `nor` is the
    normal on the incident side (so nor.inc <= 0).
    """
    n = n1 / n2
    cos_i = -vm.dot(nor, inc)
    sin2_t = n * n * (1.0 - cos_i * cos_i)
    cos_t = vm.safe_sqrt(1.0 - sin2_t)
    r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
    r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
    refl = 0.5 * (r_orth * r_orth + r_par * r_par)
    return jnp.where(sin2_t > 1.0, 1.0, refl)
