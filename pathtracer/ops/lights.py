"""Light sampling for next-event estimation (NEE) + MIS support.

Live, corrected implementation of the reference's DEAD direct-lighting
machinery (SURVEY.md §2 "Light sampling / NEE machinery is dead code"):
`SampleLight` (reference scene.h:150-170), sphere-light solid-angle `Pdf`
(scene.h:110-130), cone sampling toward a sphere (primitive.h:55-72), and
the `VisibilityTester` segment convention (light.h:23-32).

Deviations from the reference's dead code, on purpose (SURVEY.md §3.6):
  - emission one-sidedness: the reference's `SampleLight` calls
    `L(p, -wi, ns)` which tests ns·wi > 0 — backwards for a point on the
    near side of the light sphere (its dead NEE would return 0). We use
    ns·(-wi) > 0: the light contributes if its surface faces the receiver,
    matching the emitter-hit convention (light.h:43-45 with w = ray dir).
  - the `thit = Intersect(r) > 0` precedence bug (primitive.h:67) is not
    reproduced: the cone-sampled point is projected onto the sphere with
    the chord formula directly.

All functions are batched over N shading points with masked lane selects.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from pathtracer.utils.pytree import pytree_dataclass
from pathtracer.models.scene import (
    AREA_LIGHT, EPSILON, POINT_LIGHT, TRI_LIGHT, Scene,
)
from pathtracer.ops import sampling, vecmath as vm


def _mm(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def light_selection_dist(scene: Scene) -> tuple[Array, Array]:
    """Power-proportional light-selection distribution (cdf, pdfs).

    Shared by the sampler (sample_lights) and every MIS counterweight
    (light_dir_pdf / tri_sel_over_area_by_mat) — they MUST agree for MIS
    to stay unbiased. Live use of the reference's dead Distribution1D
    (montecarlo.h:28-74); power = luminance x surface area for area
    lights (sphere or triangle), luminance for point lights. Detached:
    a sampling decision, like the BSDF draws."""
    L = scene.light_type.shape[0]
    P0 = scene.centers.shape[0]
    lp_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (L, P0), 1)
        == scene.light_prim[:, None]
    ).astype(scene.light_intensity.dtype)
    l_radius = _mm(lp_hot, scene.radii)  # (L,)
    lum = vm.luminance(scene.light_intensity)
    w = jnp.where(
        scene.light_type == AREA_LIGHT,
        4.0 * jnp.pi * l_radius * l_radius, 1.0,
    )
    if scene.has_tri_lights:
        w = jnp.where(scene.light_type == TRI_LIGHT, scene.tl_area, w)
    power = lum * w * scene.light_valid
    return sampling.make_distribution_1d(jax.lax.stop_gradient(power))


@pytree_dataclass
class LightSample:
    """One light sample per lane (reference SampleLight out-params)."""

    radiance: Array  # (N, 3) emitted radiance toward the receiver (pre-vis)
    wi: Array  # (N, 3) direction receiver -> light sample
    pdf: Array  # (N,) solid-angle pdf (includes light-selection prob)
    dist: Array  # (N,) distance to the sampled point
    is_delta: Array  # (N,) bool — point lights (no MIS)
    valid: Array  # (N,) bool — a real light was sampled
    index: Array  # (N,) int32 — which light was selected (adjoint routing)


def sample_lights(
    scene: Scene,
    p: Array,
    u: Array,
    tmin: float = EPSILON,
) -> LightSample:
    """Sample one light uniformly among the scene's lights, per lane.

    p: (N,3) shading points; u: (N,3) uniforms (area u, area v, select).
    Mirrors reference scene.h:150-170 with the corrections noted above.
    """
    L = scene.light_type.shape[0]
    n = p.shape[0]

    # --- power-proportional light selection (light_selection_dist) ---------
    cdf, sel_pdfs = light_selection_dist(scene)
    li, sel_pdf = sampling.sample_distribution_1d(cdf, sel_pdfs, u[:, 2])
    one_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (n, L), 1) == li[:, None]
    ).astype(p.dtype)
    l_type = _mm(one_hot, scene.light_type.astype(p.dtype)).astype(jnp.int32)
    l_pos = _mm(one_hot, scene.light_pos)
    l_int = _mm(one_hot, scene.light_intensity)
    l_valid = _mm(one_hot, scene.light_valid.astype(p.dtype)) > 0.5

    # Area lights reference a primitive; gather its sphere.
    l_prim = _mm(one_hot, scene.light_prim.astype(p.dtype)).astype(jnp.int32)
    P = scene.centers.shape[0]
    prim_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (n, P), 1) == l_prim[:, None]
    ).astype(p.dtype)
    c = _mm(prim_hot, scene.centers)  # (N,3)
    r = _mm(prim_hot, scene.radii)  # (N,)

    # --- point-light branch (scene.h:153-158) ------------------------------
    to_l = l_pos - p
    d2_point = vm.length_sq(to_l)
    dist_point = vm.safe_sqrt(d2_point)
    wi_point = to_l / jnp.maximum(dist_point, 1e-12)[:, None]
    rad_point = l_int / jnp.maximum(d2_point, 1e-12)[:, None]

    # --- area-light branch: cone sampling toward the sphere
    # (primitive.h:55-72 + scene.h:160-168) ---------------------------------
    wc_raw = c - p
    d2 = vm.length_sq(wc_raw)
    dist_c = vm.safe_sqrt(d2)
    wc = wc_raw / jnp.maximum(dist_c, 1e-12)[:, None]
    wc_x, wc_y = vm.orthonormal_basis(wc)

    inside = d2 - r * r < 1e-4  # degenerate: receiver inside the light
    sin2_tmax = jnp.clip(r * r / jnp.maximum(d2, 1e-12), 0.0, 1.0)
    cos_tmax = vm.safe_sqrt(1.0 - sin2_tmax)

    wi_cone = sampling.uniform_sample_cone(u[:, 0], u[:, 1], cos_tmax, wc_x, wc_y, wc)
    # Project the cone ray onto the sphere: nearest root of the chord.
    b = vm.dot(wc_raw, wi_cone)  # = dot(c - p, wi)
    det = b * b - d2 + r * r
    thit = b - vm.safe_sqrt(jnp.maximum(det, 0.0))
    # Grazing rays can numerically miss; fall back to the tangent distance
    # (the reference's dead code had a precedence bug here, primitive.h:67).
    thit = jnp.where(det >= 0.0, thit, b)
    ps_cone = p + wi_cone * thit[:, None]

    # Inside the sphere: uniform surface sampling (primitive.h:50-54).
    sph = sampling.uniform_sample_sphere(u[:, 0], u[:, 1])
    ps_inside = c + sph * r[:, None]

    ps = jnp.where(inside[:, None], ps_inside, ps_cone)
    ns = (ps - c) / jnp.maximum(r, 1e-12)[:, None]
    to_s = ps - p
    dist_area = vm.length(to_s)
    wi_area = to_s / jnp.maximum(dist_area, 1e-12)[:, None]

    # pdf in solid angle (scene.h:110-130 semantics):
    #   outside: uniform cone pdf; inside: area pdf converted to solid angle.
    pdf_cone = sampling.uniform_cone_pdf(cos_tmax)
    area = 4.0 * jnp.pi * r * r
    cos_at_light = jnp.abs(vm.dot(ns, -wi_area))
    pdf_inside = (dist_area * dist_area) / jnp.maximum(
        cos_at_light * area, 1e-12
    )
    pdf_area = jnp.where(inside, pdf_inside, pdf_cone)

    # One-sided emission: light front face must see the receiver (corrected
    # sign, see module docstring).
    front = vm.dot(ns, -wi_area) > 0.0
    rad_area = l_int * front[:, None]

    # --- triangle-light branch (TRI_LIGHT; beyond the reference's model) ---
    is_tri = l_type == TRI_LIGHT
    if scene.has_tri_lights:
        (wi_tri, rad_tri, pdf_tri, dist_tri, valid_tri) = _sample_tri_light(
            scene, p, u, one_hot, l_int, tmin,
        )

    # --- select branch ------------------------------------------------------
    is_point = l_type == POINT_LIGHT
    is_area = l_type == AREA_LIGHT
    radiance = jnp.where(is_point[:, None], rad_point, rad_area)
    wi = jnp.where(is_point[:, None], wi_point, wi_area)
    # pdf includes the (power-proportional) selection probability: the
    # estimator divides by pdf_dir * P(select this light).
    pdf = jnp.where(is_point, 1.0, pdf_area)
    dist = jnp.where(is_point, dist_point, dist_area)
    branch_ok = is_point | is_area
    if scene.has_tri_lights:
        radiance = jnp.where(is_tri[:, None], rad_tri, radiance)
        wi = jnp.where(is_tri[:, None], wi_tri, wi)
        pdf = jnp.where(is_tri, pdf_tri, pdf)
        dist = jnp.where(is_tri, dist_tri, dist)
        branch_ok = branch_ok | (is_tri & valid_tri)
    pdf = pdf * sel_pdf
    valid = l_valid & branch_ok & (pdf > 0.0)
    # Tangent hygiene (mesh-translation / attached-geometry JVPs):
    # INVALID lanes' branch math can carry unbounded derivatives — e.g.
    # a receiver in the light quad's plane gives cos_at -> 0 and a
    # d2/max(cos*area, eps) pdf whose clamped primal is finite but whose
    # tangent overflows f32. Consumers multiply contributions by
    # `valid`, but inf/NaN tangents survive multiplication by zero; a
    # where-select kills the untaken branch's tangent exactly while
    # leaving valid lanes bit-identical.
    vf = valid[:, None]
    wi = jnp.where(vf, wi, jnp.zeros_like(wi).at[:, 2].set(1.0))
    radiance = jnp.where(vf, radiance, 0.0)
    pdf = jnp.where(valid, pdf, 1.0)
    dist = jnp.where(valid, dist, 1.0)
    return LightSample(
        radiance=radiance, wi=wi, pdf=pdf, dist=dist,
        is_delta=is_point, valid=valid, index=li,
    )


def _sample_tri_light(
    scene: Scene, p: Array, u: Array, one_hot: Array, l_int: Array,
    tmin: float,
) -> tuple[Array, Array, Array, Array, Array]:
    """Sample a point on the selected TRI_LIGHT, per lane.

    one_hot: (N, L) selector of the chosen light. Triangle choice is
    area-weighted via the per-light cdf with u[:,0] re-uniformized within
    the chosen cdf segment (the standard Distribution1D remap), then a
    uniform point via the sqrt warp. The solid-angle pdf of the sampled
    direction is d^2 / (cos_l * A_total) — area-weighted triangle
    selection cancels the per-triangle area.
    """
    n = p.shape[0]
    L, K = scene.tl_cdf.shape
    dt = p.dtype
    # per-lane tables of the selected light
    cdf = _mm(one_hot, scene.tl_cdf)  # (N, K)
    v0 = _mm(one_hot, scene.tl_v0.reshape(L, K * 3)).reshape(n, K, 3)
    e1 = _mm(one_hot, scene.tl_e1.reshape(L, K * 3)).reshape(n, K, 3)
    e2 = _mm(one_hot, scene.tl_e2.reshape(L, K * 3)).reshape(n, K, 3)
    nrm = _mm(one_hot, scene.tl_n.reshape(L, K * 3)).reshape(n, K, 3)
    area = _mm(one_hot, scene.tl_area)  # (N,)

    u0 = u[:, 0]
    k = jnp.sum((u0[:, None] > cdf).astype(jnp.int32), axis=-1)
    k = jnp.clip(k, 0, K - 1)
    hot_k = (
        jax.lax.broadcasted_iota(jnp.int32, (n, K), 1) == k[:, None]
    ).astype(dt)
    cdf_prev = jnp.concatenate(
        [jnp.zeros((n, 1), dt), cdf[:, :-1]], axis=1
    )
    c_lo = jnp.sum(hot_k * cdf_prev, axis=-1)
    c_hi = jnp.sum(hot_k * cdf, axis=-1)
    u0r = jnp.clip(
        (u0 - c_lo) / jnp.maximum(c_hi - c_lo, 1e-12), 0.0, 1.0
    )
    sel = lambda tab: jnp.sum(hot_k[:, :, None] * tab, axis=1)  # (N,3)
    tv0, te1, te2, tn = sel(v0), sel(e1), sel(e2), sel(nrm)

    su = jnp.sqrt(u0r)
    b1 = 1.0 - su
    b2 = u[:, 1] * su
    ps = tv0 + b1[:, None] * te1 + b2[:, None] * te2
    to_s = ps - p
    d2 = vm.length_sq(to_s)
    dist = vm.safe_sqrt(d2)
    wi = to_s / jnp.maximum(dist, 1e-12)[:, None]
    cos_l = vm.dot(tn, -wi)
    front = cos_l > 0.0  # one-sided: emits from the normal side
    pdf = d2 / jnp.maximum(
        jnp.abs(cos_l) * jnp.maximum(area, 1e-20), 1e-12
    )
    radiance = l_int * front[:, None]
    valid = front & (dist > tmin) & (area > 0.0)
    return wi, radiance, pdf, dist, valid


def light_dir_pdf(
    scene: Scene,
    p: Array,
    wi: Array,
    hit_center: Array,
    hit_radius: Array,
    hit_is_light: Array,
    hit_prim: Array | None = None,
) -> Array:
    """pdf (solid angle, incl. selection) of sampling direction wi from p
    via `sample_lights`, given that wi hits the light sphere described by
    (hit_center, hit_radius). The MIS counterweight for emitter hits
    (scene.h:110-130 `Pdf`).
    """
    d2 = vm.distance_sq(p, hit_center)
    sin2_tmax = jnp.clip(
        hit_radius * hit_radius / jnp.maximum(d2, 1e-12), 0.0, 1.0
    )
    inside = d2 - hit_radius * hit_radius < 1e-4
    cos_tmax = vm.safe_sqrt(1.0 - sin2_tmax)
    pdf = sampling.uniform_cone_pdf(cos_tmax)
    # Inside-the-sphere receivers: area-pdf conversion is direction-dependent;
    # approximate with the cone limit (cos_tmax -> 0 => uniform sphere pdf),
    # matching the reference's intent for this rare case.
    pdf = jnp.where(inside, 1.0 / (4.0 * jnp.pi), pdf)
    pdf = pdf * selection_pdf_for_prim(scene, hit_prim, p.dtype)
    return jnp.where(hit_is_light, pdf, 0.0)


def selection_pdf_for_prim(scene: Scene, hit_prim: Array | None, dtype) -> Array:
    """P(sample_lights picks the light owning prim `hit_prim`) — must match
    the power-proportional table built in sample_lights for MIS to be
    consistent (light_selection_dist is the single source of truth)."""
    L = scene.light_type.shape[0]
    P0 = scene.centers.shape[0]
    _, sel_pdfs = light_selection_dist(scene)
    if hit_prim is None:
        return jnp.asarray(1.0, dtype)
    n = hit_prim.shape[0]
    # prim -> owning light id (from the scene's light table)
    prim_hot = (
        jax.lax.broadcasted_iota(jnp.int32, (n, P0), 1) == hit_prim[:, None]
    ).astype(dtype)
    lid = _mm(prim_hot, scene.light_id.astype(dtype)).astype(jnp.int32)
    lid = jnp.clip(lid, 0, L - 1)
    return jnp.take(sel_pdfs, lid)


def tri_sel_over_area_by_mat(scene: Scene, dtype) -> Array:
    """(M,) map: material id -> P(select its tri light) / total area.

    The emitter-hit MIS counterweight for TRI_LIGHT hits is
    pdf = t^2 / cos_l * table[hit material] (area pdf to solid angle,
    times the same selection probability sample_lights uses)."""
    _, sel_pdfs = light_selection_dist(scene)
    is_tri = (scene.light_type == TRI_LIGHT) & scene.light_valid
    vals = jnp.where(
        is_tri, sel_pdfs / jnp.maximum(scene.tl_area, 1e-20), 0.0
    ).astype(dtype)
    M = scene.mat_color.shape[0]
    lm = jnp.clip(scene.light_mat, 0, M - 1)
    return jnp.zeros((M,), dtype).at[lm].add(
        jnp.where(is_tri, vals, 0.0)
    )
