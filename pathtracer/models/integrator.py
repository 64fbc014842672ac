"""Wavefront path-tracing integrator.

A wavefront form of the reference's megakernel `Trace`
(reference pathtracer.cu:112-170): instead of a divergent per-thread bounce
loop, ALL paths advance in lockstep through a bounded `lax.scan` over
bounce index, with liveness tracked as a lane mask. Dead lanes keep
computing (masked out) — the price of expressing the bounce loop as plain
XLA array code (SURVEY.md §7). This module is the repository's plain
reference: every kernel is checked against it.

Math parity with the reference integrator, bounce by bounce:
  - brute-force emitter-hit accumulation: L += T * Le on every light hit
    (pathtracer.cu:134-137; NEE/MIS was dead code in the reference and is
    implemented live here behind `use_nee`);
  - BSDF importance sampling + throughput update T *= f*|wi·n|/pdf
    (pathtracer.cu:141-149);
  - Russian roulette after bounce 3 with p = min(0.5, max(T)) and
    throughput compensation (pathtracer.cu:152-159);
  - hard bounce cap (pathtracer.cu:160-161), miss termination
    (pathtracer.cu:163-165).

RNG uses counter-based streams per (sample, bounce) — see utils/rng.py —
so the backward pass can replay paths without storing the sample buffer.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array, lax

from pathtracer.utils.pytree import pytree_dataclass, static_field
from pathtracer.models import camera as cam_mod
from pathtracer.models.camera import Camera
from pathtracer.models.scene import EPSILON, Scene, prim_attrs
from pathtracer.ops import bsdf, lights, sampling, vecmath as vm
from pathtracer.ops.intersect import intersect, intersect_p
from pathtracer.utils import rng


@pytree_dataclass
class RenderConfig:
    """Static render settings (the reference's #defines and ctor args,
    globals.h:49-54 / main.cpp:177, as data)."""

    spp: int = static_field(4)
    max_bounces: int = static_field(10)
    rr_start: int = static_field(3)
    tmin: float = static_field(EPSILON)
    # Detach sampling decisions/pdfs from the autodiff graph
    # (detached-sampling estimator; BASELINE.json north star).
    detach_sampling: bool = static_field(True)
    # Next-event estimation + MIS (live implementation of the reference's
    # dead machinery, scene.h:110-170). Off = reference-parity brute force.
    use_nee: bool = static_field(False)
    # Remat the bounce body to bound autodiff memory on large renders.
    remat: bool = static_field(True)
    # Make trace() also return the traced-segment count: path segments
    # plus NEE shadow segments (bench instrumentation).
    count_rays: bool = static_field(False)
    # Keep the |wi.n| cosine ATTACHED in the diffuse throughput update
    # (as cos/sg(cos): primal-identical, so images don't change). The
    # default closed form bakes cos/pdf = pi, which is exact but erases
    # the shading normal's parameter dependence — geometry gradients
    # (diff/geometry.py interior term) need it kept.
    attached_geom: bool = static_field(False)


def _maybe_detach(x: Array, detach: bool) -> Array:
    return lax.stop_gradient(x) if detach else x


def trace(
    scene: Scene,
    o: Array,
    d: Array,
    lane_ids: Array,
    it_key: Array,
    config: RenderConfig,
) -> Array:
    """Estimate radiance along N rays. o, d: (N,3); lane_ids: (N,) global
    path-sample indices that key the per-lane RNG streams. Returns (N,3).

    Wavefront equivalent of __device__ Trace (pathtracer.cu:112-170).
    """
    attrs = prim_attrs(scene)
    detach = config.detach_sampling

    # Derive every initial carry from lane_ids (not fresh constants) so the
    # values carry shard_map's varying-axes tag and match the scan body's
    # output types (the pinhole origin alone is not lane-dependent).
    zero = (lane_ids * 0).astype(o.dtype)
    o = o + zero[:, None]
    L0 = jnp.zeros_like(o) + zero[:, None]
    T0 = jnp.ones_like(o) + zero[:, None]
    # MIS state: pdf of the BSDF sample that produced the current hit, and
    # whether it was a delta lobe (primary rays count as delta: full emitter
    # credit at bounce 0 — the reference's commented specularBounce logic,
    # pathtracer.cu:117,133,148, implemented live).
    prev_pdf0 = zero
    alive0 = prev_pdf0 <= 0.0  # all-True, varying
    prev_delta0 = alive0
    carry0 = (L0, T0, alive0, o, d, prev_pdf0, prev_delta0)

    def body(carry, bounce):
        # Intersect-FIRST structure: the segment produced by the previous
        # bounce (or the primary rays) is traced at the top, so the scan
        # performs exactly max_bounces+1 scene traversals — the trailing
        # never-shaded intersect of the hit-carrying formulation is gone
        # (one whole BVH wave saved per frame on mesh scenes).
        L, T, alive_in, prev_o, wo, prev_pdf, prev_delta = carry
        hit = intersect(scene, attrs, prev_o, wo, tmin=config.tmin)
        # Segments actually traced this bounce (honest rays/sec metric).
        live_rays = jnp.sum(alive_in.astype(jnp.int32))
        alive = alive_in & hit.hit
        u = rng.bounce_uniforms(it_key, bounce, lane_ids)

        # -- emitter-hit contribution (pathtracer.cu:134-137 + light.h:43-45)
        one_sided = vm.dot(hit.n, -wo) > 0.0
        take_le = alive & one_sided
        if config.use_nee:
            # MIS: weight BSDF-sampled emitter hits against the light
            # sampler's pdf for the same direction (PowerHeuristic,
            # montecarlo.h:156-159 — dead in the reference, live here).
            is_light = ~vm.is_black(hit.emission)
            lp = lights.light_dir_pdf(
                scene, prev_o, wo, hit.center, hit.radius, is_light,
                hit_prim=hit.prim,
            )
            if scene.has_tri_lights:
                # TRI_LIGHT emitter hits: the light sampler's solid-angle
                # pdf for this direction is t^2/cos_l * sel_pdf/A_total
                # (area-to-solid-angle; tri_sel_over_area_by_mat). Detached
                # like every MIS pdf; t clamped so miss lanes (t=BIG)
                # cannot overflow f32 in the untaken where branch.
                is_tri_hit = hit.prim >= scene.centers.shape[0]
                fac = jnp.take(
                    lights.tri_sel_over_area_by_mat(scene, lp.dtype),
                    jnp.clip(hit.mat, 0, scene.mat_color.shape[0] - 1),
                )
                tt = jnp.minimum(hit.t, 1e6)
                cos_l = jnp.abs(vm.dot(hit.n, wo))
                lp_tri = tt * tt / jnp.maximum(cos_l, 1e-9) * fac
                lp = jnp.where(
                    is_tri_hit, lax.stop_gradient(lp_tri), lp
                )
            w_emit = jnp.where(
                prev_delta, 1.0, sampling.power_heuristic(1.0, prev_pdf, 1.0, lp)
            )
        else:
            w_emit = jnp.ones_like(prev_pdf)
        L = L + T * hit.emission * (
            take_le.astype(T.dtype) * w_emit
        )[:, None]

        # -- next-event estimation (live version of scene.h:150-170)
        if config.use_nee:
            ul = rng.light_uniforms(it_key, bounce, lane_ids)
            ls = lights.sample_lights(scene, hit.p, ul, tmin=config.tmin)
            f_l = bsdf.f(hit.mtype, hit.albedo, wo, ls.wi, hit.n)
            pdf_b = bsdf.pdf(hit.mtype, wo, ls.wi, hit.n)
            # Visibility segment. The reference's dead code shrinks the far
            # end RELATIVELY (maxt = dist*(1-eps), light.h:27) — at its
            # Cornell scale that cuts 3% of a ~500-unit segment and would
            # miss occluders hugging the light (the ceiling the emitter
            # pokes through). Use a tight shrink instead: enough to exclude
            # the light surface itself (f32 quadratic error on giant
            # spheres), not enough to skip real occluders.
            vis_tmax = ls.dist * (1.0 - 1e-3) - EPSILON
            occluded = intersect_p(
                scene, hit.p, ls.wi, tmin=config.tmin, tmax=vis_tmax,
            )
            # shadow segments are traced rays too (bench's segment count)
            live_rays = live_rays + jnp.sum(
                (alive & ls.valid).astype(jnp.int32))
            w_l = jnp.where(
                ls.is_delta,
                1.0,
                sampling.power_heuristic(1.0, ls.pdf, 1.0, pdf_b),
            )
            cos_l = jnp.abs(vm.dot(ls.wi, hit.n))
            take_nee = alive & ls.valid & ~occluded
            contrib = (
                f_l
                * ls.radiance
                * jnp.where(
                    ls.pdf > 0.0,
                    cos_l * w_l / jnp.where(ls.pdf > 0.0, ls.pdf, 1.0),
                    0.0,
                )[:, None]
            )
            L = L + T * contrib * take_nee[:, None].astype(T.dtype)

        # -- BSDF sampling (pathtracer.cu:141-149)
        f_val, wi, pdf = bsdf.sample(
            hit.mtype, hit.albedo, hit.coef, wo, hit.n, u[:, 0], u[:, 1]
        )
        wi = _maybe_detach(wi, detach)
        pdf = _maybe_detach(pdf, detach)
        contrib_ok = ~vm.is_black(f_val) & (pdf > 0.0)
        cos_wi = jnp.abs(vm.dot(wi, hit.n))
        # Per-lobe CLOSED FORM of f*|wi.n|/pdf — no division:
        #   diffuse    (albedo/pi)*cos / (cos/pi) = albedo
        #   specular / transmissive: pdf = 1       -> f*cos
        # The generic ratio is exact only analytically; numerically its
        # backward blows up (-cos/pdf^2 -> inf at denormal grazing cos)
        # and poisons attached-sampling gradients (tests/test_score.py).
        # Masked lanes (pdf == 0) are excluded by step_ok as before.
        if config.attached_geom:
            # detached-pdf estimator with the cosine attached: the pdf is
            # the sampling-time constant cos0/pi, so the diffuse weight is
            # (albedo/pi) * cos / (cos0/pi) = albedo * cos/cos0 with
            # cos0 = sg(cos). Primal ratio is exactly 1; the gradient
            # carries d cos(wi, n)/d geometry (diff/geometry.py interior).
            cos0 = jnp.maximum(lax.stop_gradient(cos_wi), 1e-6)
            diff_w = hit.albedo * jnp.where(
                lax.stop_gradient(cos_wi) > 1e-6, cos_wi / cos0, 1.0
            )[:, None]
        else:
            diff_w = hit.albedo
        weight = jnp.where(
            bsdf.is_specular_type(hit.mtype)[:, None],
            f_val * cos_wi[:, None],
            diff_w,
        )
        step_ok = alive & contrib_ok
        T = jnp.where(step_ok[:, None], T * weight, T)

        # -- Russian roulette (pathtracer.cu:152-159)
        do_rr = bounce > config.rr_start
        # RR is ALWAYS detached, even in attached-sampling mode: the
        # continuation probability is a discrete decision's parameter (the
        # documented estimator treats RR decisions as fixed), and an
        # attached p_cont additionally leaks inf into the backward through
        # the masked 1/p boost on near-dead lanes.
        p_cont = lax.stop_gradient(
            jnp.minimum(0.5, vm.max_component(T))
        )
        survive = u[:, 2] <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        T = jnp.where(
            boost[:, None], T / jnp.maximum(p_cont, 1e-20)[:, None], T
        )
        rr_ok = jnp.logical_or(~do_rr, survive)

        # -- termination + next segment (pathtracer.cu:160-168)
        alive = step_ok & rr_ok & (bounce < config.max_bounces)
        new_prev_delta = bsdf.is_specular_type(hit.mtype)
        # Dead lanes park on a fixed finite ray instead of carrying their
        # garbage state forward: a miss-lane normal (p-center)/r grows the
        # ray coordinates exponentially bounce over bounce until f32
        # overflow, and the resulting inf/NaN — though masked out of L —
        # poisons gradients through the masked where-branches (found by
        # tests/test_score.py at depth >= 5).
        av = alive[:, None]
        park_d = jnp.zeros_like(wi).at[:, 2].set(1.0)
        safe_o = jnp.where(av, hit.p, jnp.zeros_like(hit.p))
        safe_d = jnp.where(av, wi, park_d)
        # The MIS-state pdf is a sampling quantity: detached in the carry
        # even under attached sampling (the next bounce's power-heuristic
        # weight must not be differentiated).
        return (
            (L, T, alive, safe_o, safe_d, lax.stop_gradient(pdf),
             new_prev_delta),
            live_rays,
        )

    if config.remat:
        body = jax.checkpoint(body)

    bounces = jnp.arange(config.max_bounces + 1)
    if config.detach_sampling:
        (L, *_), live_counts = lax.scan(body, carry0, bounces)
    else:
        # Attached sampling unrolls the bounce loop: lax.scan's transpose
        # materializes zero cotangents for every carry element and
        # multiplies them against the full body Jacobian — whose masked
        # branches contain inf/NaN partials at degenerate lanes (grazing
        # Fresnel, near-zero pdfs). The unrolled loop lets reverse-mode
        # keep those cotangents symbolically zero. Depth is <= ~10, so
        # code size stays bounded; detached mode (the default, hot path)
        # keeps the scan.
        carry, ys = carry0, []
        for b in range(config.max_bounces + 1):
            carry, y = body(carry, bounces[b])
            ys.append(y)
        L = carry[0]
        live_counts = jnp.stack(ys)
    if config.count_rays:
        # every traced segment, primaries included (counted at the top of
        # each scan body — the bounce-b count IS the segments bounce b
        # traces, so nothing wasted is counted and nothing traced is not)
        return L, jnp.sum(live_counts)
    return L


def render(
    scene: Scene,
    camera: Camera,
    key: Array,
    config: RenderConfig,
    iteration: Array | int = 0,
) -> Array:
    """Render one progressive iteration: (H, W, 3) mean radiance over spp.

    Equivalent of one GenerateRayPool + RenderKernel pass
    (pathtracer.cu:62-110) minus the running-mean accumulation, which lives
    in models/progressive.py.
    """
    H, W, spp = camera.height, camera.width, config.spp
    it_key = rng.iteration_key(key, iteration)
    lane_ids = jnp.arange(H * W * spp, dtype=jnp.int32)

    out = trace_pixels(scene, camera, lane_ids, it_key, config)
    if config.count_rays:
        radiance, n_rays = out
        return radiance.reshape(H, W, spp, 3).mean(axis=2), n_rays
    return out.reshape(H, W, spp, 3).mean(axis=2)


def trace_pixels(
    scene: Scene,
    camera: Camera,
    lane_ids: Array,
    it_key: Array,
    config: RenderConfig,
) -> Array:
    """Generate primary rays for the given lanes and trace them.

    A "lane" is one path sample: lane = (py*W + px)*spp + s. Because ray
    setup and RNG depend only on the global lane id, this function can be
    `shard_map`ped over any partition of the lane axis (see
    parallel/sharding.py) with results identical to a single-device run.
    """
    W, spp = camera.width, config.spp
    s = lane_ids % spp
    pix = lane_ids // spp
    px = pix % W
    py = pix // W

    u = rng.camera_uniforms(it_key, lane_ids)  # (n,2)
    ox, oy = sampling.stratified_jitter_for_sample(u[:, 0], u[:, 1], s, spp)
    if camera.use_dof:
        lu = rng.lens_uniforms(it_key, lane_ids)
        o, d = cam_mod.generate_rays(camera, px, py, ox, oy, lu[:, 0], lu[:, 1])
    else:
        o, d = cam_mod.generate_rays(camera, px, py, ox, oy)
    return trace(scene, o, d, lane_ids, it_key, config)


@partial(jax.jit, static_argnames=("config",))
def render_image(
    scene: Scene,
    camera: Camera,
    key: Array,
    config: RenderConfig,
    iteration: Array | int = 0,
) -> Array:
    """Jitted single-iteration render."""
    return render(scene, camera, key, config, iteration)
