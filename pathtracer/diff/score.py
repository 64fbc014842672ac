"""Score-function gradients for the discrete Fresnel choice: d/d(IOR).

The index of refraction is the one material parameter plain
autodiff gives NO usable gradient estimator for,
because it enters the transport in two ways autodiff alone cannot see
together:

  1. CONTINUOUSLY through the refracted direction (Snell, optics.refract)
     — reparameterizable: attached sampling (RenderConfig.detach_sampling
     = False) lets plain autodiff carry d(wi)/d(ior) through the
     downstream intersections (the same interior/edge-free estimator used
     for camera pose, tests/test_gradients.py).
  2. DISCRETELY through the reflect-vs-refract coin flip `u < R(ior)`
     (reference scene.h:202-213). The estimator's f/pdf formulation
     cancels R out of the throughput (f = albedo, pdf = 1 — material.h /
     scene.h semantics), so the ONLY remaining dependence is the choice
     probability itself: the textbook score-function (REINFORCE) case.

For a path with transmissive vertices b and choices c_b:

    dL/dior = E[ dL/dior |choices fixed ]                (attached part)
            + E[ sum_b suffix_b * dlog p(c_b)/dior ]     (score part)

    dlog p/dior = R'/R (reflect)  |  -R'/(1-R) (refract)
    suffix_b    = radiance collected strictly AFTER the choice at b
                = L_total - L_prefix_after_b   (path-replay recurrence,
                  diff/replay.py)

R' = dR/d(ior) comes from one jvp of the Fresnel formula. The score walk
replays the SAME paths (same streams, same detached decisions) as the
primal, so it composes with the replay machinery: pass 1 is replay's
forward walk (L_total per lane), pass 2 accumulates the score adjoint.

Estimator notes (north-star documentation): the attached part assumes
edge-free integrands (silhouette terms of moving refracted rays are not
estimated — same assumption as camera-pose gradients); the score part is
unbiased but higher-variance, concentrate samples on the glass (FD
validation: tests/test_score.py, glass-ball Cornell fixture).

Both transport modes are supported. Under NEE (config.use_nee) the NEE
terms are linear in light intensity and carry no ior dependence at the
transmissive vertex (dielectrics take no NEE, ops/bsdf.f; MIS weights
through delta lobes are identically 1), so the score FACTOR is unchanged
— only the radiance prefix must track the NEE transport so the suffix
recurrence splits the estimate at the right vertex.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax

from pathtracer.models.integrator import RenderConfig, render
from pathtracer.models.scene import (
    EPSILON, TRANSMISSIVE, Scene, prim_attrs,
)
from pathtracer.ops import bsdf, lights, optics, sampling, vecmath as vm
from pathtracer.ops.intersect import intersect, intersect_p
from pathtracer.utils import rng


def _fresnel_R_and_dR(coef: Array, wo: Array, n: Array) -> tuple[Array, Array]:
    """Reflectance R and dR/d(coef) for the transmissive branch, exactly
    as bsdf.sample computes R (entering test, ior clamp, full unpolarized
    Fresnel with TIR)."""

    def R_of(c):
        entering = vm.dot(wo, n) < 0.0
        ior = jnp.maximum(c, 1.0)
        n1 = jnp.where(entering, 1.0, ior)
        n2 = jnp.where(entering, ior, 1.0)
        nnor = jnp.where(entering[..., None], n, -n)
        return optics.fresnel_reflectance(wo, nnor, n1, n2)

    return jax.jvp(R_of, (coef,), (jnp.ones_like(coef),))


def _score_walk(scene: Scene, o: Array, d: Array, lane_ids: Array,
                it_key: Array, config: RenderConfig, L_total: Array,
                g: Array) -> Array:
    """Accumulate the score-function adjoint: returns d(sum g*L)/d mat_coef
    (M,) — the DISCRETE-choice part only. Walks the same paths as
    diff/replay._walk (identical streams and detached decisions)."""
    attrs = prim_attrs(scene)
    P = scene.centers.shape[0]
    M = scene.mat_color.shape[0]

    hit0 = intersect(scene, attrs, o, d, tmin=config.tmin)
    prev_pdf0 = o[:, 0] * 0.0
    carry0 = (
        jnp.zeros_like(o),  # L prefix
        jnp.ones_like(o),  # T (for RR parity with the primal walk)
        hit0.hit,
        hit0,
        d,
        prev_pdf0,  # MIS: pdf of the BSDF draw that produced this hit
        prev_pdf0 <= 0.0,  # MIS: delta-lobe flag
        o,  # MIS: previous vertex position
        jnp.zeros((M,)),
    )

    def body(carry, bounce):
        L, T, alive, hit, wo, prev_pdf, prev_delta, prev_o, gC = carry
        u = rng.bounce_uniforms(it_key, bounce, lane_ids)

        one_sided = vm.dot(hit.n, -wo) > 0.0
        take_le = alive & one_sided
        # NEE adds terms that are linear in intensity and carry NO extra
        # ior dependence at the transmissive vertex (dielectrics have no
        # NEE support, ops/bsdf.f; MIS weights at/through delta lobes are
        # sampling quantities with prev_delta=1 -> w=1). The score factor
        # is therefore UNCHANGED under NEE — only the radiance prefix L
        # must track the NEE transport so suffix_b = L_total - L_prefix
        # splits the estimate at the right vertex. This block mirrors
        # diff/replay._walk's NEE+MIS exactly (same streams).
        if config.use_nee:
            is_light = ~vm.is_black(hit.emission)
            lp = lights.light_dir_pdf(
                scene, prev_o, wo, hit.center, hit.radius, is_light,
                hit_prim=hit.prim,
            )
            if scene.has_tri_lights:
                is_tri_hit = hit.prim >= P
                fac = jnp.take(
                    lights.tri_sel_over_area_by_mat(scene, lp.dtype),
                    jnp.clip(hit.mat, 0, M - 1),
                )
                tt = jnp.minimum(hit.t, 1e6)
                cos_l = jnp.abs(vm.dot(hit.n, wo))
                lp_tri = tt * tt / jnp.maximum(cos_l, 1e-9) * fac
                lp = jnp.where(is_tri_hit, lax.stop_gradient(lp_tri), lp)
            w_emit = jnp.where(
                prev_delta, 1.0,
                sampling.power_heuristic(1.0, prev_pdf, 1.0, lp),
            )
        else:
            w_emit = jnp.ones_like(prev_pdf)
        take = (take_le.astype(T.dtype) * w_emit)[:, None]
        L = L + T * hit.emission * take

        if config.use_nee:
            ul = rng.light_uniforms(it_key, bounce, lane_ids)
            ls = lights.sample_lights(scene, hit.p, ul, tmin=config.tmin)
            f_l = bsdf.f(hit.mtype, hit.albedo, wo, ls.wi, hit.n)
            pdf_b = bsdf.pdf(hit.mtype, wo, ls.wi, hit.n)
            vis_tmax = ls.dist * (1.0 - 1e-3) - EPSILON
            occluded = intersect_p(
                scene, hit.p, ls.wi, tmin=config.tmin, tmax=vis_tmax
            )
            w_l = jnp.where(
                ls.is_delta,
                1.0,
                sampling.power_heuristic(1.0, ls.pdf, 1.0, pdf_b),
            )
            cos_l = jnp.abs(vm.dot(ls.wi, hit.n))
            take_nee = alive & ls.valid & ~occluded
            L = L + (
                T * f_l * ls.radiance
                * jnp.where(
                    ls.pdf > 0.0,
                    cos_l * w_l / jnp.where(ls.pdf > 0.0, ls.pdf, 1.0),
                    0.0,
                )[:, None]
                * take_nee[:, None].astype(T.dtype)
            )

        f_val, wi, pdf = bsdf.sample(
            hit.mtype, hit.albedo, hit.coef, wo, hit.n, u[:, 0], u[:, 1]
        )
        wi = lax.stop_gradient(wi)
        pdf = lax.stop_gradient(pdf)
        contrib_ok = ~vm.is_black(f_val) & (pdf > 0.0)
        cos_wi = jnp.abs(vm.dot(wi, hit.n))
        weight = f_val * (cos_wi / jnp.maximum(pdf, 1e-20))[:, None]
        step_ok = alive & contrib_ok

        # ---- the score term at transmissive vertices
        is_t = (hit.mtype == TRANSMISSIVE) & (hit.prim < P) & alive
        R, dR = _fresnel_R_and_dR(hit.coef, wo, hit.n)
        chose_reflect = u[:, 0] < R
        score = jnp.where(
            chose_reflect,
            dR / jnp.maximum(R, 1e-6),
            -dR / jnp.maximum(1.0 - R, 1e-6),
        )
        score = jnp.where(is_t, score, 0.0)

        T = jnp.where(step_ok[:, None], T * weight, T)

        do_rr = bounce > config.rr_start
        p_cont = lax.stop_gradient(jnp.minimum(0.5, vm.max_component(T)))
        survive = u[:, 2] <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        T = jnp.where(boost[:, None],
                      T / jnp.maximum(p_cont, 1e-20)[:, None], T)
        rr_ok = jnp.logical_or(~do_rr, survive)
        alive = step_ok & rr_ok & (bounce < config.max_bounces)
        # park dead lanes on a finite ray (see integrator.py)
        av = alive[:, None]
        safe_o = jnp.where(av, hit.p, jnp.zeros_like(hit.p))
        wi = jnp.where(av, wi, jnp.zeros_like(wi).at[:, 2].set(1.0))
        new_hit = intersect(scene, attrs, safe_o, wi, tmin=config.tmin)
        alive = alive & new_hit.hit
        new_prev_delta = bsdf.is_specular_type(hit.mtype)

        # suffix_b = L_total - L_prefix (radiance gathered at vertices > b;
        # under NEE, L already holds this vertex's NEE term, which does NOT
        # depend on the Fresnel choice made here — dielectrics take no NEE)
        from pathtracer.diff.replay import _hot, _mm

        suffix = jnp.sum(g * (L_total - L), axis=-1)
        contrib = suffix * score
        mid = _mm(_hot(hit.prim, P, jnp.float32),
                  scene.material_id.astype(jnp.float32)).astype(jnp.int32)
        mat_hot = _hot(mid, M, jnp.float32)
        gC = gC + _mm(contrib[None, :], mat_hot)[0]

        return (L, T, alive, new_hit, wi, pdf, new_prev_delta, safe_o,
                gC), None

    bounces = jnp.arange(config.max_bounces + 1)
    out, _ = lax.scan(body, carry0, bounces)
    return out[-1]


def ior_value_and_grad(
    scene: Scene,
    camera,
    key: Array,
    config: RenderConfig,
    weights: Array,  # (H, W, 3) adjoint image (e.g. dLoss/dpixel)
    iteration: Array | int = 0,
) -> tuple[Array, Array]:
    """sum(weights * image) and its gradient w.r.t. scene.mat_coef (M,).

    Combined estimator: attached autodiff (continuous refraction bending,
    edge-free) + score function (the discrete Fresnel choice), in either
    transport mode (brute-force or NEE+MIS via config.use_nee)."""
    from pathtracer.models import camera as cam_mod
    from pathtracer.ops import sampling

    cfg_att = dataclasses.replace(config, detach_sampling=False)

    def val(mat_coef):
        s = dataclasses.replace(scene, mat_coef=mat_coef)
        img = render(s, camera, key, cfg_att, iteration=iteration)
        return jnp.sum(weights * img)

    value, g_attached = jax.value_and_grad(val)(scene.mat_coef)

    # ---- score part: replay the same paths
    H, W, spp = camera.height, camera.width, config.spp
    it_key = rng.iteration_key(key, iteration)
    lane_ids = jnp.arange(H * W * spp, dtype=jnp.int32)
    s_id = lane_ids % spp
    pix = lane_ids // spp
    px = pix % W
    py = pix // W
    u = rng.camera_uniforms(it_key, lane_ids)
    ox, oy = sampling.stratified_jitter_for_sample(u[:, 0], u[:, 1], s_id, spp)
    o, d = cam_mod.generate_rays(camera, px, py, ox, oy)

    from pathtracer.diff.replay import _walk

    L_lanes = _walk(scene, o, d, lane_ids, it_key, config, adjoint=False)
    g_lanes = jnp.repeat(weights.reshape(-1, 3), spp, axis=0) / spp
    g_score = _score_walk(
        scene, o, d, lane_ids, it_key, config, L_lanes, g_lanes
    )
    return value, g_attached + g_score
