"""Persistent path-regeneration kernel for the GPU (Pallas, Triton route).

This is the reference's megakernel (one thread per pixel, the whole bounce
loop in registers — pathtracer.cu:62-170) with path regeneration added:
each lane owns one PIXEL, and the moment its path dies (miss, black BSDF,
Russian roulette, bounce cap) the same lane starts that pixel's next
sample. The wavefront integrator (models/integrator.py) instead scans
`max_bounces + 1` full-width waves, dead lanes included, and sends the
path state through device memory on every wave.

Layout: every per-lane quantity is a flat (n_pad,) array. One program
takes a 1-D run of `block` consecutive lanes (a power of two) and keeps
its path state in loop carries (registers) for `budget` iterations; the
state goes back to device memory once per launch and is carried across
launches in place (`input_output_aliases`). Scene tables (spheres,
lights, camera) are plain loads inside the kernel; the loops over
spheres and lights are unrolled on the scene's static structure.

Accumulation: a path deposits emitter/NEE radiance into a per-PATH sum
(cr/cg/cb); only when the path completes is it flushed into the per-pixel
sum (lr/lg/lb) and the pixel's sample count bumped. The image is
sum / count, so in-flight paths are never partially counted. A `limit`
stops each pixel from starting more than that many samples: a render run
until every pixel has completed `limit` samples is then the plain mean of
exactly `limit` independent, fully stratified samples per pixel — the
reference's running mean (pathtracer.cu:104-109) over the same sample
count. Without a limit (the interactive viewer), a pixel's estimate is
the completed paths of a fixed iteration budget, which under-represents
long paths by O(1 / samples) — the price of never idling a lane. A block
whose lanes are all idle leaves its loop early.

Random numbers: a counter-based hash of (seed, salt, frame, global lane,
draw) — the same function in interpret mode and compiled — so a sharded
run draws exactly what one device draws for the same lanes.

Integrator math matches models/integrator.py (emitter hits with optional
NEE + MIS, diffuse / mirror / dielectric BSDFs, Russian roulette after
rr_start with p = min(0.5, max(T)), bounce cap, miss termination), with
two deliberate differences: bounce-indexed decisions are per-lane compares
(lanes sit at different depths), and the cosine-hemisphere and lens-disk
draws use the polar disk map instead of the concentric map — the same
distribution through a different warping. The kernel therefore agrees
with the wavefront integrator in distribution, not sample for sample.

Sphere scenes only: the choice function (models/progressive.py
`choose_backend`) sends mesh scenes to the wavefront integrator.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from pathtracer.models.camera import Camera
from pathtracer.models.scene import (
    AREA_LIGHT, EPSILON, POINT_LIGHT, SPECULAR, TRANSMISSIVE, Scene,
    prim_attrs,
)
from pathtracer.utils.pytree import pytree_dataclass

BLOCK = 128  # lanes per program (a power of two); one lane per thread
NO_LIMIT = 2**31 - 1  # per-pixel sample limit that never binds
BIG = 1e30
INV_PI = 1.0 / math.pi


# ---------------------------------------------------------------------------
# Counter-based random numbers
# ---------------------------------------------------------------------------

def hash_u32(x: Array) -> Array:
    """A 32-bit integer hash with full avalanche (C. Wellons' "lowbias32")."""
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> jnp.uint32(16))


def stream_key(seed: Array, salt: Array, frame: Array) -> Array:
    """One uint32 key per (seed, salt, frame); int32 scalars in."""
    k = hash_u32(seed.astype(jnp.uint32))
    k = hash_u32(k ^ (salt.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)))
    return hash_u32(k ^ (frame.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)))


def lane_base(key: Array, lane: Array) -> Array:
    """Per-lane stream base from the frame key and the GLOBAL lane id."""
    return hash_u32(key ^ (lane.astype(jnp.uint32) * jnp.uint32(0xC2B2AE35)))


def uniform(base: Array, draw: Array | int) -> Array:
    """The draw-th uniform in [0, 1) of each lane's stream (float32)."""
    h = hash_u32(base + jnp.asarray(draw).astype(jnp.uint32)
                 * jnp.uint32(0x9E3779B9))
    return (h >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / (1 << 24))


def n_draws(use_nee: bool, use_dof: bool) -> int:
    """Uniforms one lane consumes per wavefront iteration."""
    return (4 if use_dof else 2) + 3 + (3 if use_nee else 0)


# ---------------------------------------------------------------------------
# Scene tables
# ---------------------------------------------------------------------------

def pack_camera(camera: Camera) -> Array:
    """(24,) f32: first_ray_dir[0:3], px_x[3:6], px_y[6:9], pos[9:12],
    lens_radius[12], focal_distance[13], view rows u[14:17], v[17:20],
    w[20:23], pad[23] (models/camera.generate_rays semantics)."""
    return jnp.concatenate(
        [
            camera.first_ray_dir, camera.px_x, camera.px_y, camera.pos,
            camera.lens_radius[None], camera.focal_distance[None],
            camera.view[0], camera.view[1], camera.view[2],
            jnp.zeros((1,), jnp.float32),
        ]
    ).astype(jnp.float32)


def pack_prims(scene: Scene) -> Array:
    """(P, 13) f32 per real sphere: cx cy cz r ar ag ab coef mtype er eg eb
    |c|^2."""
    attrs = prim_attrs(scene)
    n = int(scene.num_prims)
    c = scene.centers[:n]
    return jnp.concatenate(
        [
            c, scene.radii[:n, None], attrs.albedo[:n],
            attrs.coef[:n, None], attrs.mtype[:n, None].astype(jnp.float32),
            attrs.emission[:n], jnp.sum(c * c, axis=-1, keepdims=True),
        ],
        axis=1,
    )


def pack_lights(scene: Scene) -> Array:
    """(L, 8) f32 per real light: pos3 intensity3 cdf_lo sel_pdf, with the
    power-proportional selection of ops/lights.light_selection_dist."""
    if not scene.light_structure:
        return jnp.zeros((1, 8), jnp.float32)
    lum_w = jnp.asarray([0.212671, 0.715160, 0.072169])
    rows, powers = [], []
    for li, (ltype, lprim) in enumerate(scene.light_structure):
        inten = scene.light_intensity[li]
        lum = jnp.sum(inten * lum_w)
        if ltype == AREA_LIGHT and lprim >= 0:
            r = scene.radii[lprim]
            powers.append(lum * 4.0 * jnp.pi * r * r)
            pos = scene.centers[lprim]
        else:
            powers.append(lum)
            pos = scene.light_pos[li]
        rows.append((pos, inten))
    pw = jnp.stack(powers)
    sel = pw / jnp.maximum(jnp.sum(pw), 1e-20)
    cdf_lo = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(sel)[:-1]])
    return jnp.stack(
        [
            jnp.concatenate([pos, inten, cdf_lo[li, None], sel[li, None]])
            for li, (pos, inten) in enumerate(rows)
        ]
    ).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Persistent state
# ---------------------------------------------------------------------------

_STATE_FIELDS = (
    "lr", "lg", "lb", "n_samp",
    "ox", "oy", "oz", "dx", "dy", "dz",
    "tr", "tg", "tb", "cr", "cg", "cb",
    "bounce", "alive", "prev_pdf", "prev_delta",
)
_INT_FIELDS = ("n_samp", "bounce", "alive", "prev_delta")


@pytree_dataclass
class PathState:
    """Per-lane persistent state, each field (n_pad,); lane == pixel index
    (py * width + px). Lanes >= width * height are padding and never
    activate."""

    # per-pixel accumulators (the progressive framebuffer)
    lr: Array
    lg: Array
    lb: Array
    n_samp: Array  # int32 — COMPLETED paths per pixel
    # in-flight path state
    ox: Array
    oy: Array
    oz: Array  # pending-ray origin (also the MIS previous vertex)
    dx: Array
    dy: Array
    dz: Array  # pending-ray direction
    tr: Array
    tg: Array
    tb: Array  # throughput
    cr: Array
    cg: Array
    cb: Array  # current-path radiance (flushed into lr.. on completion)
    bounce: Array  # int32 bounce depth of the pending ray
    alive: Array  # int32 0/1 — pending ray valid
    prev_pdf: Array  # BSDF pdf that produced the pending ray (MIS)
    prev_delta: Array  # int32 0/1 — pending ray came from a delta lobe
    frame: Array  # () int32 — launches so far (the RNG frame index)


def padded_lanes(width: int, height: int, block: int = BLOCK,
                 blocks_multiple: int = 1) -> int:
    """Lane count rounded up to whole blocks, and to a multiple of
    `blocks_multiple` blocks (so the lanes divide evenly over shards)."""
    n_blocks = -(-(width * height) // block)
    return -(-n_blocks // blocks_multiple) * blocks_multiple * block


def init_state(width: int, height: int, block: int = BLOCK,
               blocks_multiple: int = 1) -> PathState:
    """Fresh all-dead state."""
    n = padded_lanes(width, height, block, blocks_multiple)
    return PathState(
        **{f: jnp.zeros((n,), jnp.int32 if f in _INT_FIELDS
                        else jnp.float32) for f in _STATE_FIELDS},
        frame=jnp.zeros((), jnp.int32),
    )


def state_image(state: PathState, width: int, height: int) -> Array:
    """Progressive estimate: per-pixel completed-path mean, (H, W, 3)."""
    n = jnp.maximum(state.n_samp, 1).astype(jnp.float32)
    img = jnp.stack([state.lr / n, state.lg / n, state.lb / n], axis=-1)
    return img[: width * height].reshape(height, width, 3)


def state_min_samples(state: PathState, width: int, height: int) -> Array:
    """Minimum completed sample count over real (non-padding) pixels."""
    return jnp.min(state.n_samp[: width * height])


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def _kernel(params_ref, prims_ref, cam_ref, lights_ref, *refs, block: int,
            budget: int, n_prims: int, emissive: tuple, spec_prims: tuple,
            trans_prims: tuple, lights_static: tuple, use_nee: bool,
            use_dof: bool, strat_k: int, width: int, n_lanes: int,
            max_bounces: int, rr_start: int, tmin: float):
    n_state = len(_STATE_FIELDS)
    state_in = refs[:n_state]
    state_out = refs[n_state:2 * n_state]
    nrays_ref = refs[2 * n_state]

    pid = pl.program_id(0)
    # params: [seed, salt, frame, first global lane, per-pixel sample limit]
    lane = params_ref[3] + pid * block + jnp.arange(block, dtype=jnp.int32)
    in_domain = lane < n_lanes
    px = (lane % width).astype(jnp.float32)
    py = (lane // width).astype(jnp.float32)
    base = lane_base(stream_key(params_ref[0], params_ref[1], params_ref[2]),
                     lane)
    limit = params_ref[4]
    n_draw = n_draws(use_nee, use_dof)
    zeros = jnp.zeros((block,), jnp.float32)
    any_spec = bool(spec_prims)
    any_trans = bool(trans_prims)
    kk = strat_k * strat_k

    def prim(p, k):
        return prims_ref[p, k]

    def sphere_t(p, ox, oy, oz, dx, dy, dz, od, o2):
        """Ray parameter of sphere p's first root past tmin (BIG on a miss),
        with reference primitive.h:44 root selection. The quadratic is
        expanded as ops/intersect.ray_sphere_t expands it
        (|c - o|^2 = |c|^2 - 2 o.c + |o|^2), so both render paths round
        alike on the 1e5-radius wall spheres."""
        r = prim(p, 3)
        b = _dot3(dx, dy, dz, prim(p, 0), prim(p, 1), prim(p, 2)) - od
        op2 = prim(p, 12) - 2.0 * _dot3(ox, oy, oz, prim(p, 0), prim(p, 1),
                                        prim(p, 2)) + o2
        det = b * b - op2 + r * r
        sq = jnp.sqrt(jnp.maximum(det, 0.0))
        t0 = b - sq
        t = jnp.where(t0 > tmin, t0, b + sq)
        return jnp.where((det >= 0.0) & (t > tmin), t, BIG)

    def intersect(ox, oy, oz, dx, dy, dz):
        """Closest hit over the unrolled sphere list (scene.h:71-94). The
        winner is re-identified by `t_p == best_t`; on exact f32 ties the
        LAST matching sphere wins the attribute selects (the reference's
        first-closer-wins differs only on coincident surfaces)."""
        best_t = zeros + BIG
        od = _dot3(ox, oy, oz, dx, dy, dz)
        o2 = _dot3(ox, oy, oz, ox, oy, oz)
        ts = []
        for p in range(n_prims):
            tv = sphere_t(p, ox, oy, oz, dx, dy, dz, od, o2)
            ts.append(tv)
            best_t = jnp.minimum(best_t, tv)
        hit = best_t < (0.5 * BIG)
        hx = ox + dx * best_t
        hy = oy + dy * best_t
        hz = oz + dz * best_t
        cx = cy = cz = inv_r = ar = ag = ab = zeros
        is_ps = []
        for p in range(n_prims):
            is_p = ts[p] == best_t
            is_ps.append(is_p)
            cx = jnp.where(is_p, prim(p, 0), cx)
            cy = jnp.where(is_p, prim(p, 1), cy)
            cz = jnp.where(is_p, prim(p, 2), cz)
            inv_r = jnp.where(is_p, 1.0 / prim(p, 3), inv_r)
            ar = jnp.where(is_p, prim(p, 4), ar)
            ag = jnp.where(is_p, prim(p, 5), ag)
            ab = jnp.where(is_p, prim(p, 6), ab)
        nx = (hx - cx) * inv_r
        ny = (hy - cy) * inv_r
        nz = (hz - cz) * inv_r
        coef = zeros
        for p in (*spec_prims, *trans_prims):
            coef = jnp.where(is_ps[p], prim(p, 7), coef)
        er = eg = eb = zeros
        for p in emissive:
            er = jnp.where(is_ps[p], prim(p, 9), er)
            eg = jnp.where(is_ps[p], prim(p, 10), eg)
            eb = jnp.where(is_ps[p], prim(p, 11), eb)
        is_s = jnp.zeros((block,), jnp.bool_)
        for p in spec_prims:
            is_s = is_s | is_ps[p]
        is_t = jnp.zeros((block,), jnp.bool_)
        for p in trans_prims:
            is_t = is_t | is_ps[p]
        return (hit, is_ps, hx, hy, hz, nx, ny, nz, ar, ag, ab, coef,
                is_s, is_t, er, eg, eb)

    def occluded(hx, hy, hz, wlx, wly, wlz, smax, skip):
        """Any-hit over the segment (tmin, smax) (scene.h:101-108), with
        the closest-hit root selection (ops/intersect.intersect_p)."""
        od = _dot3(hx, hy, hz, wlx, wly, wlz)
        o2 = _dot3(hx, hy, hz, hx, hy, hz)
        occ = jnp.zeros((block,), jnp.bool_)
        for p in range(n_prims):
            if p != skip:
                occ = occ | (sphere_t(p, hx, hy, hz, wlx, wly, wlz, od, o2)
                             < smax)
        return occ

    def active(carry):
        """Lanes with a path in flight or a sample still to start."""
        n_samp, alive = carry[4], carry[18]
        return (alive != 0) | (in_domain & (n_samp < limit))

    def iteration(carry):
        (it, Lr, Lg, Lb, n_samp, ox, oy, oz, dx, dy, dz, Tr, Tg, Tb,
         Cr, Cg, Cb, bounce, alive, prev_pdf, prev_delta, n_live) = carry
        alive = alive != 0
        prev_delta = prev_delta != 0
        draw0 = it * n_draw

        def u(j):
            return uniform(base, draw0 + j)

        # ---- regenerate: dead lanes start their pixel's next sample
        regen = (~alive) & in_domain & (n_samp < limit)
        u_cam, v_cam = u(0), u(1)
        if strat_k > 1:
            cell = n_samp % kk
            jx = ((cell % strat_k).astype(jnp.float32) + u_cam) * (
                1.0 / strat_k) - 0.5
            jy = ((cell // strat_k).astype(jnp.float32) + v_cam) * (
                1.0 / strat_k) - 0.5
        else:
            jx = u_cam - 0.5
            jy = v_cam - 0.5
        sx = px + jx
        sy = py + jy
        gdx, gdy, gdz = _normalize3(
            cam_ref[0] - cam_ref[6] * sy + cam_ref[3] * sx,
            cam_ref[1] - cam_ref[7] * sy + cam_ref[4] * sx,
            cam_ref[2] - cam_ref[8] * sy + cam_ref[5] * sx,
        )
        gox = zeros + cam_ref[9]
        goy = zeros + cam_ref[10]
        goz = zeros + cam_ref[11]
        off = 2
        if use_dof:
            # thin lens: uniform disk via the polar map, origin on the lens,
            # direction re-aimed at the focal-plane point
            lens_r = cam_ref[12] * jnp.sqrt(u(2))
            phi_l = (2.0 * math.pi) * u(3)
            ldu = lens_r * jnp.cos(phi_l)
            ldv = lens_r * jnp.sin(phi_l)
            cos_w = gdx * cam_ref[20] + gdy * cam_ref[21] + gdz * cam_ref[22]
            ft = cam_ref[13] / jnp.maximum(cos_w, 1e-6)
            fpx = gox + gdx * ft
            fpy = goy + gdy * ft
            fpz = goz + gdz * ft
            gox = gox + cam_ref[14] * ldu + cam_ref[17] * ldv
            goy = goy + cam_ref[15] * ldu + cam_ref[18] * ldv
            goz = goz + cam_ref[16] * ldu + cam_ref[19] * ldv
            gdx, gdy, gdz = _normalize3(fpx - gox, fpy - goy, fpz - goz)
            off = 4
        u1, u2, u3 = u(off), u(off + 1), u(off + 2)

        ox = jnp.where(regen, gox, ox)
        oy = jnp.where(regen, goy, oy)
        oz = jnp.where(regen, goz, oz)
        dx = jnp.where(regen, gdx, dx)
        dy = jnp.where(regen, gdy, dy)
        dz = jnp.where(regen, gdz, dz)
        Tr = jnp.where(regen, 1.0, Tr)
        Tg = jnp.where(regen, 1.0, Tg)
        Tb = jnp.where(regen, 1.0, Tb)
        Cr = jnp.where(regen, 0.0, Cr)
        Cg = jnp.where(regen, 0.0, Cg)
        Cb = jnp.where(regen, 0.0, Cb)
        bounce = jnp.where(regen, 0, bounce)
        prev_pdf = jnp.where(regen, 0.0, prev_pdf)
        prev_delta = prev_delta | regen
        alive = alive | regen
        n_live = n_live + jnp.sum(alive.astype(jnp.int32))

        # ---- trace the pending segment
        (hit, is_ps, hx, hy, hz, nx, ny, nz, ar, ag, ab, coef, is_s, is_t,
         er, eg, eb) = intersect(ox, oy, oz, dx, dy, dz)
        act = alive & hit
        # Park non-acting lanes on the origin: a miss lane's hit point is
        # o + d*BIG, whose square overflows f32 in the NEE distance math.
        actf = act.astype(jnp.float32)
        hx = hx * actf
        hy = hy * actf
        hz = hz * actf
        wox, woy, woz = dx, dy, dz

        # ---- emitter-hit accumulation (pathtracer.cu:134-137 + MIS)
        take = (act & (_dot3(nx, ny, nz, -wox, -woy, -woz) > 0.0)).astype(
            jnp.float32)
        if use_nee:
            ldp = zeros
            for li, (ltype, lprim) in enumerate(lights_static):
                if ltype != AREA_LIGHT or lprim < 0:
                    continue
                dlx = prim(lprim, 0) - ox
                dly = prim(lprim, 1) - oy
                dlz = prim(lprim, 2) - oz
                d2l = _dot3(dlx, dly, dlz, dlx, dly, dlz)
                rl = prim(lprim, 3)
                sin2 = jnp.minimum(rl * rl / jnp.maximum(d2l, 1e-12), 1.0)
                ctm = jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))
                pc = 1.0 / (2.0 * math.pi * jnp.maximum(1.0 - ctm, 1e-12))
                pc = jnp.where(d2l > rl * rl, pc, 0.0)
                ldp = jnp.where(is_ps[lprim], pc * lights_ref[li, 7], ldp)
            pp2 = prev_pdf * prev_pdf
            take = take * jnp.where(
                prev_delta, 1.0, pp2 / jnp.maximum(pp2 + ldp * ldp, 1e-20))
        Cr = Cr + Tr * er * take
        Cg = Cg + Tg * eg * take
        Cb = Cb + Tb * eb * take

        # ---- next-event estimation (live scene.h:150-170)
        is_d = ~(is_s | is_t)
        if use_nee:
            ul1, ul2, usel = u(off + 3), u(off + 4), u(off + 5)
            for li, (ltype, lprim) in enumerate(lights_static):
                lo = lights_ref[li, 6]
                sel = lights_ref[li, 7]
                if li == len(lights_static) - 1:
                    m_l = usel >= lo
                else:
                    m_l = (usel >= lo) & (usel < lo + sel)
                if ltype == AREA_LIGHT and lprim >= 0:
                    # cone sampling toward the sphere (primitive.h:55-72)
                    wrx = prim(lprim, 0) - hx
                    wry = prim(lprim, 1) - hy
                    wrz = prim(lprim, 2) - hz
                    rl = prim(lprim, 3)
                    d2l = _dot3(wrx, wry, wrz, wrx, wry, wrz)
                    inv_dc = jax.lax.rsqrt(jnp.maximum(d2l, 1e-20))
                    wcx, wcy, wcz = wrx * inv_dc, wry * inv_dc, wrz * inv_dc
                    sin2 = jnp.minimum(rl * rl / jnp.maximum(d2l, 1e-12), 1.0)
                    ctm = jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))
                    cth = 1.0 - ul1 * (1.0 - ctm)
                    sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 0.0))
                    phi = (2.0 * math.pi) * ul2
                    usex = jnp.abs(wcx) > jnp.abs(wcz)
                    ax, ay, az = _normalize3(
                        jnp.where(usex, -wcy, 0.0),
                        jnp.where(usex, wcx, -wcz),
                        jnp.where(usex, 0.0, wcy),
                    )
                    bx = wcy * az - wcz * ay
                    by = wcz * ax - wcx * az
                    bz = wcx * ay - wcy * ax
                    cp = jnp.cos(phi) * sth
                    sp = jnp.sin(phi) * sth
                    wlx = ax * cp + bx * sp + wcx * cth
                    wly = ay * cp + by * sp + wcy * cth
                    wlz = az * cp + bz * sp + wcz * cth
                    bq = _dot3(wrx, wry, wrz, wlx, wly, wlz)
                    detq = bq * bq - d2l + rl * rl
                    dist_l = bq - jnp.sqrt(jnp.maximum(detq, 0.0))
                    inv_rl = 1.0 / rl
                    nsx = (hx + wlx * dist_l - prim(lprim, 0)) * inv_rl
                    nsy = (hy + wly * dist_l - prim(lprim, 1)) * inv_rl
                    nsz = (hz + wlz * dist_l - prim(lprim, 2)) * inv_rl
                    valid = ((detq >= 0.0) & (dist_l > tmin) & (d2l > rl * rl)
                             & (_dot3(nsx, nsy, nsz, -wlx, -wly, -wlz) > 0.0))
                    pdf_l = sel / (2.0 * math.pi * jnp.maximum(1.0 - ctm,
                                                               1e-12))
                    rad_r = lights_ref[li, 3]
                    rad_g = lights_ref[li, 4]
                    rad_b = lights_ref[li, 5]
                    is_delta = False
                    skip = lprim  # a valid cone sample never hits it first
                elif ltype == POINT_LIGHT:
                    wrx = lights_ref[li, 0] - hx
                    wry = lights_ref[li, 1] - hy
                    wrz = lights_ref[li, 2] - hz
                    d2l = _dot3(wrx, wry, wrz, wrx, wry, wrz)
                    inv_dl = jax.lax.rsqrt(jnp.maximum(d2l, 1e-20))
                    dist_l = d2l * inv_dl
                    wlx, wly, wlz = wrx * inv_dl, wry * inv_dl, wrz * inv_dl
                    inv_d2 = inv_dl * inv_dl
                    rad_r = lights_ref[li, 3] * inv_d2
                    rad_g = lights_ref[li, 4] * inv_d2
                    rad_b = lights_ref[li, 5] * inv_d2
                    pdf_l = sel + zeros
                    valid = dist_l > tmin
                    is_delta = True
                    skip = -1
                else:
                    raise ValueError(f"light type {ltype} needs a mesh")
                smax = dist_l * (1.0 - 1e-3) - tmin
                occ = occluded(hx, hy, hz, wlx, wly, wlz, smax, skip)
                cos_l = _dot3(wlx, wly, wlz, nx, ny, nz)
                support = ((cos_l > 0.0)
                           & (_dot3(wox, woy, woz, wlx, wly, wlz) < 0.0)
                           & is_d)
                if is_delta:
                    w_mis = 1.0
                else:
                    pdf_b_l = jnp.where(support, cos_l * INV_PI, 0.0)
                    w_mis = (pdf_l * pdf_l) / jnp.maximum(
                        pdf_l * pdf_l + pdf_b_l * pdf_b_l, 1e-20)
                shadow = act & m_l & valid & support
                # every needed shadow segment counts as a traced ray
                n_live = n_live + jnp.sum(shadow.astype(jnp.int32))
                scale = ((shadow & ~occ).astype(jnp.float32) * cos_l * w_mis
                         / jnp.maximum(pdf_l, 1e-20))
                Cr = Cr + Tr * (ar * INV_PI) * rad_r * scale
                Cg = Cg + Tg * (ag * INV_PI) * rad_g * scale
                Cb = Cb + Tb * (ab * INV_PI) * rad_b * scale

        # ---- BSDF sampling (scene.h:177-221). Cosine hemisphere via the
        # polar disk map in the (u, v, n) frame: (ldx, ldy, ldz) is unit, so
        # the world direction needs no re-normalize and its cosine is ldz.
        r_d = jnp.sqrt(u1)
        th = (2.0 * math.pi) * u2
        ldx = r_d * jnp.cos(th)
        ldy = r_d * jnp.sin(th)
        ldz = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        use_x = jnp.abs(nx) > jnp.abs(nz)
        ux, uy, uz = _normalize3(
            jnp.where(use_x, -ny, 0.0),
            jnp.where(use_x, nx, -nz),
            jnp.where(use_x, 0.0, ny),
        )
        vx = ny * uz - nz * uy
        vy = nz * ux - nx * uz
        vz = nx * uy - ny * ux
        wix = ux * ldx + vx * ldy + nx * ldz
        wiy = uy * ldx + vy * ldy + ny * ldz
        wiz = uz * ldx + vz * ldy + nz * ldz
        pdf = jnp.where(_dot3(wox, woy, woz, wix, wiy, wiz) < 0.0,
                        ldz * INV_PI, 0.0)
        fr, fg, fb = ar * INV_PI, ag * INV_PI, ab * INV_PI

        won = _dot3(wox, woy, woz, nx, ny, nz)
        # mirror reflection is invariant under n -> -n, so one reflect
        # serves the specular lobe and the dielectric's reflected branch
        wsx = wox - 2.0 * won * nx
        wsy = woy - 2.0 * won * ny
        wsz = woz - 2.0 * won * nz
        if any_spec:
            wix = jnp.where(is_s, wsx, wix)
            wiy = jnp.where(is_s, wsy, wiy)
            wiz = jnp.where(is_s, wsz, wiz)
            fr = jnp.where(is_s, coef * ar, fr)
            fg = jnp.where(is_s, coef * ag, fg)
            fb = jnp.where(is_s, coef * ab, fb)
        if any_trans:
            entering = won < 0.0
            ior = jnp.maximum(coef, 1.0)
            n1 = jnp.where(entering, 1.0, ior)
            n2 = jnp.where(entering, ior, 1.0)
            sgn = jnp.where(entering, 1.0, -1.0)
            nnx, nny, nnz = nx * sgn, ny * sgn, nz * sgn
            cos_i = -(wox * nnx + woy * nny + woz * nnz)
            eta = n1 / n2
            sin2t = eta * eta * (1.0 - cos_i * cos_i)
            cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2t, 0.0))
            r_orth = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
            r_par = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
            refl = jnp.where(sin2t > 1.0, 1.0,
                             0.5 * (r_orth * r_orth + r_par * r_par))
            do_reflect = u1 < refl
            # unit by construction when sin2t <= 1; total internal
            # reflection always takes the reflected branch
            k = eta * cos_i - cos_t
            wix = jnp.where(is_t, jnp.where(do_reflect, wsx,
                                            wox * eta + k * nnx), wix)
            wiy = jnp.where(is_t, jnp.where(do_reflect, wsy,
                                            woy * eta + k * nny), wiy)
            wiz = jnp.where(is_t, jnp.where(do_reflect, wsz,
                                            woz * eta + k * nnz), wiz)
            fr = jnp.where(is_t, ar, fr)
            fg = jnp.where(is_t, ag, fg)
            fb = jnp.where(is_t, ab, fb)
        if any_spec or any_trans:
            pdf = jnp.where(is_d, pdf, 1.0)
            # diffuse: cos/pdf == pi exactly; delta lobes: pdf == 1
            wgt = jnp.where(is_d, math.pi,
                            jnp.abs(_dot3(wix, wiy, wiz, nx, ny, nz)))
        else:
            wgt = math.pi
        f_black = (fr <= 0.0) & (fg <= 0.0) & (fb <= 0.0)
        step_ok = act & ~f_black & (pdf > 0.0)
        Tr = jnp.where(step_ok, Tr * fr * wgt, Tr)
        Tg = jnp.where(step_ok, Tg * fg * wgt, Tg)
        Tb = jnp.where(step_ok, Tb * fb * wgt, Tb)

        # ---- Russian roulette, gated per lane on its own bounce depth
        do_rr = bounce > rr_start
        p_cont = jnp.minimum(0.5, jnp.maximum(Tr, jnp.maximum(Tg, Tb)))
        survive = u3 <= p_cont
        boost = step_ok & do_rr & survive & (p_cont > 0.0)
        inv_p = 1.0 / jnp.maximum(p_cont, 1e-20)
        Tr = jnp.where(boost, Tr * inv_p, Tr)
        Tg = jnp.where(boost, Tg * inv_p, Tg)
        Tb = jnp.where(boost, Tb * inv_p, Tb)
        alive_next = step_ok & (survive | ~do_rr) & (bounce < max_bounces)

        # ---- path completion: flush the path's radiance into the pixel
        died = alive & ~alive_next
        diedf = died.astype(jnp.float32)
        Lr = Lr + Cr * diedf
        Lg = Lg + Cg * diedf
        Lb = Lb + Cb * diedf
        n_samp = n_samp + died.astype(jnp.int32)

        # ---- pending ray for the next iteration
        ox = jnp.where(act, hx, ox)
        oy = jnp.where(act, hy, oy)
        oz = jnp.where(act, hz, oz)
        dx = jnp.where(act, wix, dx)
        dy = jnp.where(act, wiy, dy)
        dz = jnp.where(act, wiz, dz)
        prev_pdf = jnp.where(act, pdf, prev_pdf)
        prev_delta = jnp.where(act, ~is_d, prev_delta)
        bounce = jnp.where(act, bounce + 1, bounce)
        return (it + 1, Lr, Lg, Lb, n_samp, ox, oy, oz, dx, dy, dz, Tr, Tg,
                Tb, Cr, Cg, Cb, bounce, alive_next.astype(jnp.int32),
                prev_pdf, prev_delta.astype(jnp.int32), n_live)

    carry = ((jnp.int32(0),) + tuple(r[...] for r in state_in)
             + (jnp.int32(0),))
    carry = jax.lax.while_loop(
        lambda c: (c[0] < budget) & (jnp.sum(active(c).astype(jnp.int32)) > 0),
        iteration, carry)
    for r, v in zip(state_out, carry[1:-1]):
        r[...] = v
    nrays_ref[pid] = carry[-1]


@functools.partial(
    jax.jit,
    static_argnames=("budget", "max_bounces", "rr_start", "use_nee",
                     "strat_k", "block", "interpret"),
    donate_argnames=("state",),
)
def persistent_step(
    scene: Scene,
    camera: Camera,
    seed: Array,  # (2,) int32 [seed, salt]
    state: PathState,
    *,
    budget: int = 512,
    max_bounces: int = 10,
    rr_start: int = 3,
    use_nee: bool = False,
    strat_k: int = 2,
    block: int = BLOCK,
    limit: Array | int = NO_LIMIT,
    lane_offset: Array | int = 0,
    interpret: bool = False,
) -> tuple[PathState, Array]:
    """Advance every lane by up to `budget` wavefront iterations.

    Returns (new_state, live ray segments traced). Completed paths flush
    into the per-pixel sums inside `state`; read the image with
    `state_image`. `limit` (traced) caps the samples a pixel starts.
    `lane_offset` (traced) is the global id of the state's first lane, so
    a shard of a sharded state draws the random numbers and pixel
    coordinates one device would (parallel/persistent_sharded).
    `interpret=True` runs the kernel through the Pallas interpreter (CPU
    tests); it is never chosen implicitly.
    """
    if scene.mesh is not None:
        raise ValueError("the persistent kernel traces sphere scenes only; "
                         "render mesh scenes with the wavefront integrator")
    n_pad = state.lr.shape[0]
    if n_pad % block:
        raise ValueError(f"state of {n_pad} lanes is not whole blocks of "
                         f"{block}")
    n_blocks = n_pad // block
    prims = pack_prims(scene)
    kernel = functools.partial(
        _kernel,
        block=block,
        budget=budget,
        n_prims=int(scene.num_prims),
        emissive=tuple(scene.emissive_prims),
        spec_prims=tuple(i for i, t in enumerate(scene.prim_mtypes)
                         if t == SPECULAR),
        trans_prims=tuple(i for i, t in enumerate(scene.prim_mtypes)
                          if t == TRANSMISSIVE),
        lights_static=tuple(scene.light_structure),
        use_nee=use_nee,
        use_dof=camera.use_dof,
        strat_k=strat_k,
        width=camera.width,
        n_lanes=camera.width * camera.height,
        max_bounces=max_bounces,
        rr_start=rr_start,
        tmin=EPSILON,
    )
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    n_state = len(_STATE_FIELDS)
    params = jnp.stack([
        seed[0], seed[1], state.frame, jnp.asarray(lane_offset, jnp.int32),
        jnp.asarray(limit, jnp.int32)]).astype(jnp.int32)
    outs = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.no_block_spec] * 4 + [lane_spec] * n_state,
        out_specs=[lane_spec] * n_state + [pl.no_block_spec],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), getattr(state, f).dtype)
            for f in _STATE_FIELDS
        ] + [jax.ShapeDtypeStruct((n_blocks,), jnp.int32)],
        input_output_aliases={4 + i: i for i in range(n_state)},
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=max(1, block // 32),
                                           num_stages=1),
        interpret=interpret,
        name="persistent_path_regeneration",
    )(params, prims, pack_camera(camera), pack_lights(scene),
      *(getattr(state, f) for f in _STATE_FIELDS))
    new_state = PathState(**dict(zip(_STATE_FIELDS, outs[:-1])),
                          frame=state.frame + 1)
    return new_state, jnp.sum(outs[-1])


def strat_k_for(spp: int) -> int:
    """Side of the stratification grid the XLA path uses for `spp`
    (ops/sampling.stratified_jitter_for_sample): sqrt(spp) when square."""
    k = int(round(spp ** 0.5))
    return k if k * k == spp and k > 1 else 1
