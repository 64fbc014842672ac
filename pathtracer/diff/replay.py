"""Path-replay backprop: O(1)-memory gradients by re-tracing paths.

The north-star differentiation technique (BASELINE.json: "detached-sampling
/ path-replay backprop"; SURVEY.md §7 stage 6): because every random draw
is regenerable from (seed, iteration, stream, bounce, lane) — utils/rng.py
— the backward pass RE-TRACES the exact same paths instead of storing
per-bounce residuals. Plain autodiff through the bounce scan keeps O(depth
x lanes) intermediates (bounded only by remat); this custom_vjp's backward
stores nothing beyond the primal inputs and the per-lane radiance totals.

Math (detached sampling, so sampling decisions are constants):

    L   = sum_b E_b,   E_b = T_b * e_b,   T_b = prod_{k<b} w_k
    w_k = f_k * cos_k / pdf_k  (+ detached RR boosts)

Every BSDF factor is LINEAR in its material color (diffuse A/pi, mirror
coef*A, dielectric A — material.h:37-43 / scene.h:188-218), and emission is
linear in the light intensity, so with suffix_k = sum_{b>k} E_b:

    dL/dA[m]  = sum_k 1[m_k = m] * suffix_k / A[m]      (per channel)
    dL/dI[l]  = sum_b 1[light_b = l, front] * T_b

The replay walks the identical path maintaining the prefix sum
(suffix_k = L_total - prefix_k — Vicini et al.'s PRB recurrence) and
routes per-bounce adjoints to the tables with one-hot contractions
(no scatters).

NEE (config.use_nee) is fully supported: the walk mirrors
models/integrator.py's live NEE+MIS (same rng.light_uniforms stream, same
power-proportional selection, same MIS weights), so the primal equals
integrator.render in either mode. The NEE term at vertex k,
NEE_k = T_k * (A_k/pi) * Le * G, is linear in BOTH the upstream albedos
(through T_k, handled by the suffix recurrence) and A_k itself (the direct
f factor), so the adjoint adds NEE_k/A_k at vertex k and folds NEE_k into
the running prefix; MIS weights/pdfs are sampling quantities (detached).
Emission adjoints divide the accumulated term by the light's intensity
(both the emitter-hit and NEE terms are linear in I), guarded at 0.

Scope: gradients w.r.t. scene.mat_color and scene.light_intensity — the
inverse-rendering parameters (config 5) — for sphere AND mesh hits: the
unified Hit.mat id routes every vertex's albedo adjoint to its material
table row (texture factors cancel: w = tex*A*(...) so dw/dA = w/A — the
adjoint divides by the TABLE color, not the texture-modulated albedo),
and TRI_LIGHT emitter hits route to the owning light via the
material->light map (one tri-light per material; a material shared by
several TRI_LIGHT rows credits the first). Geometry/camera derivatives
are not represented in this estimator; use the autodiff path
(RenderConfig.remat) for those. The albedo division is guarded and
zero-color channels transport zero radiance, so their gradients vanish
correctly.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from pathtracer.models.integrator import RenderConfig
from pathtracer.models.scene import EPSILON, Scene, prim_attrs
from pathtracer.ops import bsdf, lights, sampling, vecmath as vm
from pathtracer.ops.intersect import intersect, intersect_p
from pathtracer.utils import rng


def _hot(idx: Array, width: int, dtype) -> Array:
    """(N,) int -> (N, width) one-hot (out-of-range rows are all-zero)."""
    n = idx.shape[0]
    return (
        jax.lax.broadcasted_iota(jnp.int32, (n, width), 1) == idx[:, None]
    ).astype(dtype)


def _mm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _walk(scene: Scene, o: Array, d: Array, lane_ids: Array, it_key: Array,
          config: RenderConfig, adjoint: bool,
          L_total: Array | None = None, g: Array | None = None):
    """One pass over the paths. adjoint=False -> per-lane radiance.
    adjoint=True -> (grad mat_color, grad light_intensity) against g."""
    attrs = prim_attrs(scene)
    P = scene.centers.shape[0]
    M = scene.mat_color.shape[0]
    NL = scene.light_intensity.shape[0]

    hit0 = intersect(scene, attrs, o, d, tmin=config.tmin)
    prev_pdf0 = o[:, 0] * 0.0
    carry0 = (
        jnp.zeros_like(o),  # L prefix
        jnp.ones_like(o),  # T
        hit0.hit,  # alive
        hit0,
        d,  # wo
        prev_pdf0,  # MIS: pdf of the BSDF draw that produced this hit
        prev_pdf0 <= 0.0,  # MIS: delta-lobe flag (primaries count as delta)
        o,  # MIS: previous vertex position
        jnp.zeros((M, 3)),
        jnp.zeros((NL, 3)),
    )

    def body(carry, bounce):
        L, T, alive, hit, wo, prev_pdf, prev_delta, prev_o, gA, gI = carry
        u = rng.bounce_uniforms(it_key, bounce, lane_ids)

        one_sided = vm.dot(hit.n, -wo) > 0.0
        take_le = alive & one_sided
        if config.use_nee:
            # MIS against the light sampler (integrator.py's live weights).
            is_light = ~vm.is_black(hit.emission)
            lp = lights.light_dir_pdf(
                scene, prev_o, wo, hit.center, hit.radius, is_light,
                hit_prim=hit.prim,
            )
            if scene.has_tri_lights:
                # TRI_LIGHT emitter hits: solid-angle pdf of the light
                # sampler for this direction (same math + clamps as
                # models/integrator.py).
                is_tri_hit = hit.prim >= P
                fac = jnp.take(
                    lights.tri_sel_over_area_by_mat(scene, lp.dtype),
                    jnp.clip(hit.mat, 0, M - 1),
                )
                tt = jnp.minimum(hit.t, 1e6)
                cos_l = jnp.abs(vm.dot(hit.n, wo))
                lp_tri = tt * tt / jnp.maximum(cos_l, 1e-9) * fac
                lp = jnp.where(
                    is_tri_hit, lax.stop_gradient(lp_tri), lp
                )
            w_emit = jnp.where(
                prev_delta, 1.0,
                sampling.power_heuristic(1.0, prev_pdf, 1.0, lp),
            )
        else:
            w_emit = jnp.ones_like(prev_pdf)
        take = (take_le.astype(T.dtype) * w_emit)[:, None]
        L = L + T * hit.emission * take

        if adjoint:
            # emission adjoint: the emitter-hit term is T*I*take (linear in
            # the owning light's intensity) -> route T*take. Sphere lanes
            # map prim -> light_id; TRI_LIGHT lanes map the hit material to
            # the (first) TRI_LIGHT row that owns it.
            is_sphere = hit.prim < P
            prim_hot = _hot(hit.prim, P, T.dtype)
            lid = _mm(prim_hot, scene.light_id.astype(T.dtype)).astype(jnp.int32)
            emit_valid = ~vm.is_black(hit.emission)
            if scene.has_tri_lights:
                from pathtracer.models.scene import TRI_LIGHT

                is_tl = (scene.light_type == TRI_LIGHT) & scene.light_valid
                owns = (scene.light_mat[None, :] == hit.mat[:, None]) \
                    & is_tl[None, :]  # (N, NL)
                lid_tri = jnp.argmax(owns, axis=1).astype(jnp.int32)
                has_owner = jnp.any(owns, axis=1)
                lid = jnp.where(is_sphere, lid, lid_tri)
                emit_valid = emit_valid & (is_sphere | has_owner)
            else:
                emit_valid = emit_valid & is_sphere
            lit = take * emit_valid.astype(T.dtype)[:, None]
            light_hot = _hot(lid, NL, T.dtype)
            gI = gI + _mm(light_hot.T, g * T * lit)

        # -- next-event estimation (same math + streams as integrator.py)
        nee_term = jnp.zeros_like(T)
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
            nee_term = (
                T * f_l * ls.radiance
                * jnp.where(
                    ls.pdf > 0.0,
                    cos_l * w_l / jnp.where(ls.pdf > 0.0, ls.pdf, 1.0),
                    0.0,
                )[:, None]
                * take_nee[:, None].astype(T.dtype)
            )
            L = L + nee_term
            if adjoint:
                # NEE is linear in the SELECTED light's intensity:
                # nee_term = I * (rest) -> adjoint = g * nee_term / I.
                # Routes by the light index, so mesh-surface vertices and
                # TRI_LIGHT sources work unchanged.
                li_hot = _hot(ls.index, NL, T.dtype)
                I_l = _mm(li_hot, scene.light_intensity)
                contrib_I = g * nee_term / jnp.maximum(I_l, 1e-8)
                gI = gI + _mm(li_hot.T, contrib_I)

        f_val, wi, pdf = bsdf.sample(
            hit.mtype, hit.albedo, hit.coef, wo, hit.n, u[:, 0], u[:, 1]
        )
        wi = lax.stop_gradient(wi)
        pdf = lax.stop_gradient(pdf)
        contrib_ok = ~vm.is_black(f_val) & (pdf > 0.0)
        cos_wi = jnp.abs(vm.dot(wi, hit.n))
        # per-lobe closed form of f*cos/pdf (see integrator.py) — still
        # linear in the material color, so the adjoint identity holds
        weight = jnp.where(
            bsdf.is_specular_type(hit.mtype)[:, None],
            f_val * cos_wi[:, None],
            hit.albedo,
        )
        step_ok = alive & contrib_ok

        if adjoint:
            # albedo adjoint: every lobe's f is linear in the material
            # color, so d w_k/dA = w_k/A and the factor's adjoint is the
            # radiance it transports: suffix = L_total - L_prefix (all
            # emitter-hit and NEE terms accumulated at DEEPER vertices).
            # The NEE term at THIS vertex depends on A directly through its
            # f factor, so it contributes nee_term/A in addition. Routing
            # goes through the unified Hit.mat id (sphere AND mesh lanes),
            # and divides by the TABLE color — textured albedos factor as
            # tex*A, so dw/dA = w/A, not w/(tex*A).
            suffix = L_total - L
            ok = step_ok.astype(T.dtype)[:, None]
            nee_ok = alive.astype(T.dtype)[:, None]
            mat_hot = _hot(jnp.clip(hit.mat, 0, M - 1), M, T.dtype)
            A_tab = _mm(mat_hot, scene.mat_color)
            contrib_A = (
                g * (suffix * ok + nee_term * nee_ok)
                / jnp.maximum(A_tab, 1e-8)
            )
            gA = gA + _mm(mat_hot.T, contrib_A)

        T = jnp.where(step_ok[:, None], T * weight, T)

        do_rr = bounce > config.rr_start
        p_cont = lax.stop_gradient(jnp.minimum(0.5, vm.max_component(T)))
        survive = u[:, 2] <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        T = jnp.where(boost[:, None], T / jnp.maximum(p_cont, 1e-20)[:, None], T)
        rr_ok = jnp.logical_or(~do_rr, survive)

        alive = step_ok & rr_ok & (bounce < config.max_bounces)
        # park dead lanes on a finite ray (see integrator.py: their
        # garbage state otherwise grows to overflow across bounces)
        av = alive[:, None]
        safe_o = jnp.where(av, hit.p, jnp.zeros_like(hit.p))
        safe_d = jnp.where(av, wi, jnp.zeros_like(wi).at[:, 2].set(1.0))
        new_hit = intersect(scene, attrs, safe_o, safe_d, tmin=config.tmin)
        alive = alive & new_hit.hit
        new_prev_delta = bsdf.is_specular_type(hit.mtype)
        return (
            (L, T, alive, new_hit, safe_d, pdf, new_prev_delta, safe_o,
             gA, gI),
            None,
        )

    bounces = jnp.arange(config.max_bounces + 1)
    out, _ = lax.scan(body, carry0, bounces)
    L, gA, gI = out[0], out[-2], out[-1]
    if adjoint:
        return gA, gI
    return L


def _zero_tangent(x):
    if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.zeros_like(x)
    if hasattr(x, "shape"):
        return np.zeros(x.shape, dtype=jax.dtypes.float0)
    return None


@partial(jax.custom_vjp, nondiff_argnums=(5,))
def trace_replay(mat_color: Array, light_intensity: Array, scene: Scene,
                 o: Array, d: Array, config: RenderConfig,
                 lane_ids: Array, it_key: Array) -> Array:
    """Per-lane radiance (N,3), differentiable w.r.t. (mat_color,
    light_intensity) via path replay, in brute-force or NEE+MIS mode
    (config.use_nee — same estimator and streams as integrator.trace).
    `scene`'s own tables are ignored in favor of the explicit first two
    args."""
    s = dataclasses.replace(scene, mat_color=mat_color, light_intensity=light_intensity)
    return _walk(s, o, d, lane_ids, it_key, config, adjoint=False)


def _fwd(mat_color, light_intensity, scene, o, d, config, lane_ids, it_key):
    s = dataclasses.replace(scene, mat_color=mat_color, light_intensity=light_intensity)
    L = _walk(s, o, d, lane_ids, it_key, config, adjoint=False)
    return L, (mat_color, light_intensity, scene, o, d, lane_ids, it_key, L)


def _bwd(config, res, g):
    mat_color, light_intensity, scene, o, d, lane_ids, it_key, L_total = res
    s = dataclasses.replace(scene, mat_color=mat_color, light_intensity=light_intensity)
    gA, gI = _walk(s, o, d, lane_ids, it_key, config, adjoint=True,
                   L_total=L_total, g=g)
    return (
        gA,
        gI,
        jax.tree.map(_zero_tangent, s),
        jnp.zeros_like(o),
        jnp.zeros_like(d),
        _zero_tangent(lane_ids),
        _zero_tangent(it_key),
    )


trace_replay.defvjp(_fwd, _bwd)


def render_replay(scene: Scene, camera, key: Array, config: RenderConfig,
                  iteration: Array | int = 0) -> Array:
    """(H, W, 3) render whose gradients w.r.t. the scene tables flow via
    path replay (drop-in for integrator.render in inverse rendering)."""
    from pathtracer.models import camera as cam_mod
    from pathtracer.ops import sampling

    H, W, spp = camera.height, camera.width, config.spp
    it_key = rng.iteration_key(key, iteration)
    lane_ids = jnp.arange(H * W * spp, dtype=jnp.int32)
    s = lane_ids % spp
    pix = lane_ids // spp
    px = pix % W
    py = pix // W
    u = rng.camera_uniforms(it_key, lane_ids)
    ox, oy = sampling.stratified_jitter_for_sample(u[:, 0], u[:, 1], s, spp)
    o, d = cam_mod.generate_rays(camera, px, py, ox, oy)
    L = trace_replay(
        scene.mat_color, scene.light_intensity, scene, o, d, config,
        lane_ids, it_key,
    )
    return L.reshape(H, W, spp, 3).mean(axis=2)
