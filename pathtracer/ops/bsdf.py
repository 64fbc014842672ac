"""BSDF evaluation and sampling with masked lane dispatch.

Array form of the reference's type-switched device functions
(`SampleMaterial` scene.h:177-221, `Material::F` material.h:37-43,
`Pdf` scene.h:136-144). The per-thread `if (type == ...)` chains become
branch-free `jnp.where` selects over SoA lanes: every lane computes all
three BSDF branches cheaply and keeps the one matching its
material type — the wavefront answer to megakernel divergence
(SURVEY.md §7 "architectural inversion").

Conventions (identical to the reference): `wo` is the incoming ray
direction pointing TOWARD the surface; `wi` is the sampled outgoing
direction; `n` the outward geometric normal.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array, lax

from pathtracer.models.scene import DIFFUSE, SPECULAR, TRANSMISSIVE
from pathtracer.ops import optics, sampling, vecmath as vm

INV_PI = 1.0 / jnp.pi


def _diffuse_support(wo: Array, wi: Array, n: Array) -> Array:
    """Directions the diffuse sampler can actually produce: the +n
    hemisphere (cosine sampling around n, scene.h:183) intersected with the
    reference's wo.wi < 0 gate (scene.h:184).

    The reference's `Material::F` (material.h:37-43) returns albedo/pi with
    NO support check — harmless in its megakernel, which only ever
    evaluates F on sampled directions, but a light-leak enabler for NEE:
    a shadow ray leaving the back side of a surface would be credited
    (e.g. ceiling points lit by emitter points embedded inside the ceiling
    sphere in the reference's own Cornell scene, where the giant emitter
    interpenetrates the walls). f/pdf here are honest functions with the
    sampler's support, which also keeps MIS weights consistent.
    """
    return (vm.dot(wi, n) > 0.0) & (vm.dot(wo, wi) < 0.0)


def f(mtype: Array, albedo: Array, wo: Array, wi: Array, n: Array) -> Array:
    """BSDF value for a given direction pair (material.h:37-43 + support).

    Only the diffuse lobe has a finite directional density; specular and
    transmissive lanes return 0 (their transport happens only via sampling).
    """
    sup = _diffuse_support(wo, wi, n)
    diffuse_f = albedo * INV_PI * sup[..., None]
    return jnp.where((mtype == DIFFUSE)[..., None], diffuse_f, 0.0)


def pdf(mtype: Array, wo: Array, wi: Array, n: Array) -> Array:
    """Directional pdf of `sample` for non-delta lobes (scene.h:136-144,
    restricted to the sampler's support so it is a valid density)."""
    sup = _diffuse_support(wo, wi, n)
    diffuse_pdf = jnp.where(sup, vm.dot(wi, n) * INV_PI, 0.0)
    return jnp.where(mtype == DIFFUSE, diffuse_pdf, 0.0)


def sample(
    mtype: Array,
    albedo: Array,
    coef: Array,
    wo: Array,
    n: Array,
    u1: Array,
    u2: Array,
) -> tuple[Array, Array, Array]:
    """Importance-sample the BSDF: returns (f, wi, pdf).

    Masked-lane port of scene.h:177-221:
      DIFFUSE      cosine hemisphere around n; pdf = |wi·n|/pi gated on
                   wo·wi < 0 (reference's same-side check, scene.h:184)
      SPECULAR     deterministic mirror; f = coef*color, pdf = 1
      TRANSMISSIVE Fresnel-weighted choice between reflection and
                   refraction using u1 (scene.h:194-218); f = color, pdf = 1
    """
    is_diffuse = mtype == DIFFUSE
    is_specular = mtype == SPECULAR
    is_transmissive = mtype == TRANSMISSIVE

    # --- diffuse branch -----------------------------------------------------
    wi_d = sampling.cosine_sample_hemisphere(u1, u2, n)
    pdf_d = jnp.where(
        vm.dot(wo, wi_d) < 0.0, jnp.abs(vm.dot(wi_d, n)) * INV_PI, 0.0
    )
    f_d = albedo * INV_PI

    # --- perfect mirror -----------------------------------------------------
    wi_s = optics.reflect(wo, n)
    f_s = coef[..., None] * albedo

    # --- dielectric ---------------------------------------------------------
    entering = vm.dot(wo, n) < 0.0  # ray hits the outside (scene.h:199)
    ior = jnp.maximum(coef, 1.0)  # guard padding lanes (coef=0) against /0
    n1 = jnp.where(entering, 1.0, ior)
    n2 = jnp.where(entering, ior, 1.0)
    nnor = jnp.where(entering[..., None], n, -n)
    # The reflectance only gates the branch CHOICE (u1 < refl) — a
    # comparison with no gradient — so detach it: at exact-grazing hits
    # the Fresnel quotient is 0/0 in the TIR-masked branch and its NaN
    # partial would otherwise leak through the bounce scan's transpose
    # under attached sampling (diff/score.py).
    refl = lax.stop_gradient(optics.fresnel_reflectance(wo, nnor, n1, n2))
    wi_t = jnp.where(
        (u1 < refl)[..., None],
        optics.reflect(wo, nnor),
        optics.refract(wo, nnor, n1 / n2),
    )
    f_t = albedo

    # --- lane select --------------------------------------------------------
    wi = jnp.where(is_diffuse[..., None], wi_d,
                   jnp.where(is_specular[..., None], wi_s, wi_t))
    f_val = jnp.where(is_diffuse[..., None], f_d,
                      jnp.where(is_specular[..., None], f_s,
                                jnp.where(is_transmissive[..., None], f_t, 0.0)))
    pdf_val = jnp.where(is_diffuse, pdf_d,
                        jnp.where(is_specular | is_transmissive, 1.0, 0.0))
    return f_val, wi, pdf_val


def is_specular_type(mtype: Array) -> Array:
    """Delta-distribution lobes (no NEE/MIS weight; pathtracer.cu:148)."""
    return (mtype == SPECULAR) | (mtype == TRANSMISSIVE)
