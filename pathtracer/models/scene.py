"""Scene data model: SoA arrays in a JAX pytree.

A redesign of the reference's device-pointer object graph
(`Scene{MaterialList, PrimitiveList, LightList}`, reference scene.h:35-43,
primitive.h:87-96, material.h:83-92, light.h:58-65). Instead of
arrays-of-structs chased through pointers, the scene is a pytree of flat
arrays padded to multiples of 8, replicated on every device when sharded
(SURVEY.md §5 "Distributed communication backend").

Materials and lights are kept as *normalized tables* (colors/intensities
indexed by id). `prim_attrs` denormalizes them into per-primitive arrays
inside the traced computation, so gradients from inverse rendering flow
back to the tables — the differentiable analogue of the reference's
`materialId`/`lightId` indirection (primitive.h:79-81).

Primitives are spheres, like the reference (primitive.h:26 "will be changed
to triangle later" — triangle+BVH support is the planned config-4 stage).
"""
from __future__ import annotations

from typing import Any, Sequence

import jax.numpy as jnp
import numpy as np
from jax import Array
from pathtracer.utils.pytree import pytree_dataclass, static_field

# Material types (reference material.h:25)
DIFFUSE = 0
SPECULAR = 1
TRANSMISSIVE = 2

# Light types (reference light.h:34; TRI_LIGHT is a superset capability —
# the reference's light model only knows point + sphere-area, light.h:40-44)
POINT_LIGHT = 0
AREA_LIGHT = 1
TRI_LIGHT = 2  # mesh-triangle area light: every triangle of a material emits

# Reference globals.h:49 — shadow/self-intersection epsilon.
EPSILON = 3e-2


def _pad_to(n: int, m: int = 8) -> int:
    return max(m, ((n + m - 1) // m) * m)


@pytree_dataclass
class Scene:
    # Primitives (P = padded primitive count)
    centers: Array  # (P, 3)
    radii: Array  # (P,)
    material_id: Array  # (P,) int32
    light_id: Array  # (P,) int32, -1 = not emissive (primitive.h:75)
    prim_valid: Array  # (P,) bool — False on padding rows

    # Material table (M = padded material count)
    mat_color: Array  # (M, 3)
    mat_coef: Array  # (M,) — specular scale or IOR (material.h:46)
    mat_type: Array  # (M,) int32

    # Light table (L = padded light count)
    light_type: Array  # (L,) int32
    light_pos: Array  # (L, 3) — point lights only
    light_prim: Array  # (L,) int32 — area lights only
    light_intensity: Array  # (L, 3)
    light_valid: Array  # (L,) bool

    num_prims: int = static_field(0)
    num_lights: int = static_field(0)
    # Static scene STRUCTURE (which prims emit / which BSDF type each prim
    # has) — value-free metadata that lets kernels specialize their
    # unrolled loops per scene (e.g. emission gathers only over emissive
    # prims, dielectric math skipped in glass-free scenes).
    emissive_prims: tuple = static_field(())
    prim_mtypes: tuple = static_field(())
    # ((light_type, prim_index_or_-1), ...) per light — static structure
    light_structure: tuple = static_field(())
    # Emissive material id per light (-1 for non-TRI_LIGHT lights).
    light_mats: tuple = static_field(())

    # Triangle mesh + BVH (None = sphere-only scene, the reference's world).
    # See models/mesh.py; fills primitive.h:26 / scene.h:33 TODOs.
    mesh: Any = None
    # Texture atlas (K, TH, TW, 3) and per-material texture index (-1 =
    # plain color); config-4 textured scenes.
    textures: Any = None
    mat_texture: Any = None

    # Triangle-emitter area lights (TRI_LIGHT): per-light sampling tables,
    # built host-side from the post-BVH-reorder mesh (make_scene). None for
    # scenes without tri lights. Shapes: (L, K, ...) where K = padded max
    # triangle count over the scene's tri lights.
    light_mat: Any = None  # (L,) int32 — emissive material id (-1 = not tri)
    tl_v0: Any = None  # (L, K, 3)
    tl_e1: Any = None  # (L, K, 3)
    tl_e2: Any = None  # (L, K, 3)
    tl_n: Any = None  # (L, K, 3) unit geometric normal (emission side)
    tl_cdf: Any = None  # (L, K) area-weighted triangle-selection CDF
    tl_area: Any = None  # (L,) total emissive area (0 = not a tri light)
    has_tri_lights: bool = static_field(False)


@pytree_dataclass
class PrimAttrs:
    """Per-primitive shading attributes, denormalized from the tables."""

    albedo: Array  # (P, 3)
    coef: Array  # (P,)
    mtype: Array  # (P,) int32
    emission: Array  # (P, 3) — area-light radiance, 0 for non-emitters


def prim_attrs(scene: Scene) -> PrimAttrs:
    """Denormalize material/light tables to per-primitive arrays (in-jit).

    Gradients w.r.t. `mat_color` / `light_intensity` flow through the
    gathers/scatters here, which is what makes the scene tables the
    optimizable parameters in inverse rendering.
    """
    albedo = scene.mat_color[scene.material_id]
    coef = scene.mat_coef[scene.material_id]
    mtype = scene.mat_type[scene.material_id]

    # Area-light emission scattered onto the owning primitive
    # (reference light.h:40-44: AREA_LIGHT references primId and the
    # integrator reads intensity through prim->lightId).
    is_area = (scene.light_type == AREA_LIGHT) & scene.light_valid
    contrib = scene.light_intensity * is_area[:, None]
    emission = (
        jnp.zeros_like(scene.centers).at[scene.light_prim].add(contrib)
    )
    # Padding prims carry no emission.
    emission = emission * scene.prim_valid[:, None]
    return PrimAttrs(albedo=albedo, coef=coef, mtype=mtype, emission=emission)


# ---------------------------------------------------------------------------
# Host-side construction helpers (the reference's factory functions,
# material.h:55-77 / main.cpp:128-166, as plain data).
# ---------------------------------------------------------------------------

def diffuse(color: Sequence[float], coef: float = 0.0) -> dict:
    return {"type": DIFFUSE, "color": list(color), "coef": coef}


def specular(color: Sequence[float], coef: float = 1.0) -> dict:
    return {"type": SPECULAR, "color": list(color), "coef": coef}


def transmissive(color: Sequence[float], ior: float = 1.5) -> dict:
    return {"type": TRANSMISSIVE, "color": list(color), "coef": ior}


def sphere(center: Sequence[float], radius: float, material: int,
           light: int = -1) -> dict:
    return {"center": list(center), "radius": radius, "material": material,
            "light": light}


def point_light(pos: Sequence[float], intensity: Sequence[float]) -> dict:
    return {"type": POINT_LIGHT, "pos": list(pos), "intensity": list(intensity)}


def area_light(prim: int, intensity: Sequence[float]) -> dict:
    return {"type": AREA_LIGHT, "prim": prim, "intensity": list(intensity)}


def tri_light(material: int, intensity: Sequence[float]) -> dict:
    """Triangle-mesh area light: every mesh triangle carrying `material`
    emits `intensity` from its front (geometric-normal) side. Beyond the
    reference's light model (light.h:40-44 knows only point + sphere-area);
    lets real Cornell boxes use a ceiling quad as the emitter."""
    return {"type": TRI_LIGHT, "material": material,
            "intensity": list(intensity)}


def make_scene(
    spheres: Sequence[dict],
    materials: Sequence[dict],
    lights: Sequence[dict] = (),
    mesh: Any = None,
    textures: Any = None,
    mat_texture: Sequence[int] | None = None,
) -> Scene:
    """Build a padded SoA Scene from declarative python data.

    This is the data-driven scene construction the reference lists as a TODO
    ("configuration file parsing", main.cpp:126); see io/scene_io.py for the
    JSON front end.
    """
    n_p, n_m, n_l = len(spheres), len(materials), len(lights)
    # Host-side validation: out-of-range ids would otherwise clamp silently
    # inside jit gathers and render black (the reference had the same class
    # of bug live, SURVEY.md §3.6 material-count UB — fail fast instead).
    for i, s in enumerate(spheres):
        if not 0 <= s["material"] < n_m:
            raise ValueError(
                f"sphere {i}: material id {s['material']} out of range "
                f"(have {n_m} materials)")
    for i, l in enumerate(lights):
        if l["type"] == AREA_LIGHT and not 0 <= l["prim"] < n_p:
            raise ValueError(
                f"light {i}: area-light prim {l['prim']} out of range "
                f"(have {n_p} primitives)")
        if l["type"] == TRI_LIGHT:
            if mesh is None:
                raise ValueError(
                    f"light {i}: TRI_LIGHT requires a mesh")
            if not 0 <= l["material"] < n_m:
                raise ValueError(
                    f"light {i}: tri-light material {l['material']} out of "
                    f"range (have {n_m} materials)")
            if not bool(np.any(np.asarray(mesh.material_id)
                               == l["material"])):
                raise ValueError(
                    f"light {i}: no mesh triangle uses material "
                    f"{l['material']}")
    for i, s in enumerate(spheres):
        li = s.get("light", -1)
        if li >= n_l:
            raise ValueError(
                f"sphere {i}: light id {li} out of range (have {n_l} lights)")
    if mesh is not None:
        mids = np.asarray(mesh.material_id)
        # padding rows carry id 0 by construction; real triangles must
        # reference a declared material (same fail-fast policy as spheres)
        if mids.size and (mids.min() < 0 or mids.max() >= n_m):
            bad = int(mids.min()) if mids.min() < 0 else int(mids.max())
            raise ValueError(
                f"mesh: triangle material id {bad} out of range "
                f"(have {n_m} materials)")
    P, M, L = _pad_to(n_p), _pad_to(n_m), _pad_to(max(n_l, 1))

    centers = np.zeros((P, 3), np.float32)
    radii = np.zeros((P,), np.float32)
    mat_id = np.zeros((P,), np.int32)
    light_id = np.full((P,), -1, np.int32)
    valid = np.zeros((P,), bool)
    for i, s in enumerate(spheres):
        centers[i] = s["center"]
        radii[i] = s["radius"]
        mat_id[i] = s["material"]
        light_id[i] = s.get("light", -1)
        valid[i] = True

    mat_color = np.zeros((M, 3), np.float32)
    mat_coef = np.zeros((M,), np.float32)
    mat_type = np.zeros((M,), np.int32)
    for i, m in enumerate(materials):
        mat_color[i] = m["color"]
        mat_coef[i] = m["coef"]
        mat_type[i] = m["type"]

    l_type = np.zeros((L,), np.int32)
    l_pos = np.zeros((L, 3), np.float32)
    # Padding rows point at padding prim P-1 (always invalid, non-emissive),
    # so the emission scatter in prim_attrs is a no-op for them.
    l_prim = np.full((L,), P - 1, np.int32)
    l_int = np.zeros((L, 3), np.float32)
    l_valid = np.zeros((L,), bool)
    l_mat = np.full((L,), -1, np.int32)
    for i, l in enumerate(lights):
        l_type[i] = l["type"]
        l_valid[i] = True
        l_int[i] = l["intensity"]
        if l["type"] == POINT_LIGHT:
            l_pos[i] = l["pos"]
        elif l["type"] == TRI_LIGHT:
            l_mat[i] = l["material"]
        else:
            l_prim[i] = l["prim"]

    # --- triangle-light sampling tables (host-side, post-BVH tri order) ---
    tri_tabs = _build_tri_light_tables(mesh, l_type, l_mat, l_valid, L)

    mat_tex = np.full((M,), -1, np.int32)
    if mat_texture is not None:
        for i, t in enumerate(mat_texture):
            mat_tex[i] = t
    if textures is not None:
        textures = jnp.asarray(np.asarray(textures, np.float32))
        if textures.ndim == 3:
            textures = textures[None]

    return Scene(
        centers=jnp.asarray(centers),
        radii=jnp.asarray(radii),
        material_id=jnp.asarray(mat_id),
        light_id=jnp.asarray(light_id),
        prim_valid=jnp.asarray(valid),
        mat_color=jnp.asarray(mat_color),
        mat_coef=jnp.asarray(mat_coef),
        mat_type=jnp.asarray(mat_type),
        light_type=jnp.asarray(l_type),
        light_pos=jnp.asarray(l_pos),
        light_prim=jnp.asarray(l_prim),
        light_intensity=jnp.asarray(l_int),
        light_valid=jnp.asarray(l_valid),
        num_prims=n_p,
        num_lights=n_l,
        emissive_prims=tuple(
            i for i, s in enumerate(spheres) if s.get("light", -1) >= 0
        ),
        prim_mtypes=tuple(
            int(materials[s["material"]]["type"]) for s in spheres
        ),
        light_structure=tuple(
            (int(l["type"]), int(l.get("prim", -1))) for l in lights
        ),
        light_mats=tuple(
            int(l["material"]) if l["type"] == TRI_LIGHT else -1
            for l in lights
        ),
        mesh=mesh,
        textures=textures,
        mat_texture=jnp.asarray(mat_tex),
        light_mat=jnp.asarray(l_mat),
        **tri_tabs,
    )


def _build_tri_light_tables(mesh, l_type, l_mat, l_valid, L: int) -> dict:
    """Per-light triangle sampling tables for TRI_LIGHT lights.

    For each tri light, gathers the mesh triangles carrying its material
    (post-BVH-reorder ids — MeshData.material_id follows the reordered
    triangles, models/mesh.py), their unit front normals, and an
    area-weighted selection CDF. All lights pad to a common K so the
    tables are rectangular (L, K, ...); ops/lights.py samples them with
    one-hot gathers."""
    is_tri = (l_type == TRI_LIGHT) & l_valid
    if mesh is None or not bool(is_tri.any()):
        return dict(tl_v0=None, tl_e1=None, tl_e2=None, tl_n=None,
                    tl_cdf=None, tl_area=None, has_tri_lights=False)
    v0 = np.asarray(mesh.v0, np.float64)
    e1 = np.asarray(mesh.e1, np.float64)
    e2 = np.asarray(mesh.e2, np.float64)
    mat = np.asarray(mesh.material_id)
    per_light = [np.nonzero(mat == l_mat[i])[0] if is_tri[i]
                 else np.zeros((0,), np.int64) for i in range(L)]
    K = max(1, max(len(ids) for ids in per_light))
    tv0 = np.zeros((L, K, 3), np.float32)
    te1 = np.zeros((L, K, 3), np.float32)
    te2 = np.zeros((L, K, 3), np.float32)
    tn = np.zeros((L, K, 3), np.float32)
    tcdf = np.ones((L, K), np.float32)  # padding: cdf saturated at 1
    tarea = np.zeros((L,), np.float32)
    for i, ids in enumerate(per_light):
        k = len(ids)
        if k == 0:
            continue
        cr = np.cross(e1[ids], e2[ids])
        a = 0.5 * np.linalg.norm(cr, axis=-1)
        total = float(a.sum())
        if total <= 0.0:
            raise ValueError(f"tri light {i}: degenerate emissive triangles")
        tv0[i, :k] = v0[ids]
        te1[i, :k] = e1[ids]
        te2[i, :k] = e2[ids]
        tn[i, :k] = cr / np.maximum(
            np.linalg.norm(cr, axis=-1, keepdims=True), 1e-20)
        tcdf[i, :k] = np.cumsum(a) / total
        tcdf[i, k - 1:] = 1.0
        tarea[i] = total
    return dict(
        tl_v0=jnp.asarray(tv0), tl_e1=jnp.asarray(te1),
        tl_e2=jnp.asarray(te2), tl_n=jnp.asarray(tn),
        tl_cdf=jnp.asarray(tcdf), tl_area=jnp.asarray(tarea),
        has_tri_lights=True,
    )


# ---------------------------------------------------------------------------
# Built-in scenes
# ---------------------------------------------------------------------------

def reference_materials() -> list[dict]:
    """The reference's six materials (main.cpp:133-138)."""
    return [
        diffuse([1.0, 1.0, 1.0]),          # 0 default
        diffuse([0.75, 0.25, 0.25]),       # 1 red
        diffuse([0.25, 0.25, 0.75]),       # 2 blue
        diffuse([0.75, 0.75, 0.75]),       # 3 grey
        specular([0.999, 0.999, 0.999]),   # 4 mirror
        transmissive([0.999, 0.999, 0.999], 1.5),  # 5 glass
    ]


def cornell_spheres() -> tuple[Scene, dict]:
    """The reference's active "scene 2" (main.cpp:152-164): a Cornell box
    built from giant spheres + mirror + glass + a huge emissive sphere.

    Returns (scene, camera_spec) where camera_spec mirrors main.cpp:129.
    """
    e5 = 1e5
    spheres = [
        sphere([e5 + 50, 40, 0], e5, 2),      # left (blue)
        sphere([-e5 - 50, 40, 0], e5, 1),     # right (red)
        sphere([0, 40, -e5 - 80], e5, 3),     # back
        sphere([0, 40, e5 + 80], e5, 3),      # front
        sphere([0, -e5, 0], e5, 3),           # bottom
        sphere([0, e5 + 80, 0], e5, 3),       # top
        sphere([-25, 16.5, -50], 16.5, 4),    # mirror ball
        sphere([25, 16.5, -25], 16.5, 5),     # glass ball
        sphere([0, 579.6, -40], 500, 1, 0),   # emitter
    ]
    lights = [area_light(8, [12.0, 12.0, 12.0])]
    cam = dict(eye=[0, 45, 79.5], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights), cam


def small_spheres() -> tuple[Scene, dict]:
    """The reference's commented-out "scene 1" (main.cpp:142-150): a small
    box of giant spheres with mirror+glass balls and a small emitter."""
    e5 = 1e5
    spheres = [
        sphere([0, -e5 - 1, 0], e5, 1),       # floor
        sphere([0, e5 + 3, 0], e5, 1),        # ceiling
        sphere([0, 0, -e5 - 7], e5, 1),       # back
        sphere([0, 0, e5 + 7], e5, 1),        # front
        sphere([-e5 - 4, 0, 0], e5, 2),       # left
        sphere([e5 + 4, 0, 0], e5, 3),        # right
        sphere([-1.5, 0, 0], 1.0, 4),
        sphere([1.5, 0, 0], 1.0, 5),
        sphere([0, 2.0, 0], 0.5, 1, 0),
    ]
    lights = [area_light(8, [12.0, 12.0, 12.0])]
    cam = dict(eye=[0, 1, 6.5], look_at=[0, 1, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights), cam


def single_sphere() -> tuple[Scene, dict]:
    """BASELINE.json config 1: single diffuse sphere + area light.

    CPU-runnable golden-image fixture (SURVEY.md §4 integration tests).
    """
    spheres = [
        sphere([0, 0, 0], 1.0, 0),
        sphere([0, 3.0, 0], 0.5, 0, 0),
    ]
    mats = [diffuse([0.8, 0.6, 0.4])]
    lights = [area_light(1, [20.0, 20.0, 20.0])]
    cam = dict(eye=[0, 1.0, 4.0], look_at=[0, 0.5, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, mats, lights), cam


def cornell_glass() -> tuple[Scene, dict]:
    """BASELINE.json config 3: Cornell box + mirror/glass spheres — a
    DISTINCT fixture (not the cornell_spheres alias): triangle-quad
    Cornell walls (real mesh geometry through the BVH path) with a
    mirror sphere and a dielectric glass sphere inside, under a sphere
    area emitter. The only fixture exercising mesh + dielectric
    together — paths refract through the glass ball and then intersect
    triangle walls.

    Geometry family: the reference's "scene 2" layout (main.cpp:152-161:
    blue left / red right / grey box, mirror at (-25,16.5,-50), glass at
    (25,16.5,-25)) with its giant-sphere walls replaced by actual quads.
    """
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    grey, red, blue = 3, 1, 2
    walls = [
        (*meshes.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80],
                      [-50, 0, -80]), grey),             # floor (+y)
        (*meshes.quad([-50, 80, -80], [50, 80, -80], [50, 80, 80],
                      [-50, 80, 80]), grey),             # ceiling (-y)
        (*meshes.quad([50, 0, -80], [50, 80, -80], [-50, 80, -80],
                      [-50, 0, -80]), grey),             # back (+z)
        (*meshes.quad([-50, 0, 80], [-50, 80, 80], [50, 80, 80],
                      [50, 0, 80]), grey),               # front (-z)
        (*meshes.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80],
                      [-50, 0, 80]), red),               # left (+x)
        (*meshes.quad([50, 0, 80], [50, 80, 80], [50, 80, -80],
                      [50, 0, -80]), blue),              # right (-x)
    ]
    v, f, uv, m = meshes.merge(*walls)
    mesh = build_bvh(v, f, uv, m)

    spheres = [
        sphere([-25, 16.5, -50], 16.5, 4),   # mirror ball
        sphere([25, 16.5, -25], 16.5, 5),    # glass ball
        sphere([0, 86, -20], 10.0, 1, 0),    # emitter pokes below ceiling
    ]
    lights = [area_light(2, [60.0, 60.0, 60.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, reference_materials(), lights, mesh=mesh), cam


def cornell_boxes() -> tuple[Scene, dict]:
    """BASELINE config 2 proper: Cornell box with diffuse walls + two
    boxes — REAL geometry (triangle quads/boxes via the mesh+BVH path),
    not the reference's giant-sphere approximation (main.cpp:152-161).
    The light stays a sphere emitter (light.h:40-44 model) so NEE works.
    """
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    # Interior 100 x 80 x 160, matching the reference's implied box.
    white, red, blue = 0, 1, 2
    walls = [
        # floor (+y normal)
        (*meshes.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80], [-50, 0, -80]), white),
        # ceiling (-y)
        (*meshes.quad([-50, 80, -80], [50, 80, -80], [50, 80, 80], [-50, 80, 80]), white),
        # back (+z)
        (*meshes.quad([50, 0, -80], [50, 80, -80], [-50, 80, -80], [-50, 0, -80]), white),
        # front (-z), behind the camera
        (*meshes.quad([-50, 0, 80], [-50, 80, 80], [50, 80, 80], [50, 0, 80]), white),
        # left x=-50 (+x)
        (*meshes.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80], [-50, 0, 80]), red),
        # right x=50 (-x)
        (*meshes.quad([50, 0, 80], [50, 80, 80], [50, 80, -80], [50, 0, -80]), blue),
        # tall box + short box
        (*meshes.box([-18, 30, -35], [30, 60, 30], rotation_y=0.3), white),
        (*meshes.box([20, 14, -5], [28, 28, 28], rotation_y=-0.25), white),
    ]
    v, f, uv, m = meshes.merge(*walls)
    mesh = build_bvh(v, f, uv, m)

    spheres = [sphere([0, 86, -20], 10.0, 3, 0)]  # emitter pokes below ceiling
    mats = [
        diffuse([0.75, 0.75, 0.75]),
        diffuse([0.75, 0.25, 0.25]),
        diffuse([0.25, 0.25, 0.75]),
        diffuse([1.0, 1.0, 1.0]),
    ]
    lights = [area_light(0, [60.0, 60.0, 60.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene(spheres, mats, lights, mesh=mesh), cam


def cornell_quad() -> tuple[Scene, dict]:
    """Cornell box lit by an EMISSIVE CEILING QUAD (TRI_LIGHT): the classic
    Cornell configuration the reference could not express — its light model
    only knows point + sphere-area emitters (light.h:40-44). Pure mesh
    scene (no spheres at all); NEE samples the quad by area.
    """
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    white, red, blue, emit = 0, 1, 2, 3
    walls = [
        (*meshes.quad([-50, 0, 80], [50, 0, 80], [50, 0, -80],
                      [-50, 0, -80]), white),            # floor (+y)
        (*meshes.quad([-50, 80, -80], [50, 80, -80], [50, 80, 80],
                      [-50, 80, 80]), white),            # ceiling (-y)
        (*meshes.quad([50, 0, -80], [50, 80, -80], [-50, 80, -80],
                      [-50, 0, -80]), white),            # back (+z)
        (*meshes.quad([-50, 0, 80], [-50, 80, 80], [50, 80, 80],
                      [50, 0, 80]), white),              # front (-z)
        (*meshes.quad([-50, 0, -80], [-50, 80, -80], [-50, 80, 80],
                      [-50, 0, 80]), red),               # left (+x)
        (*meshes.quad([50, 0, 80], [50, 80, 80], [50, 80, -80],
                      [50, 0, -80]), blue),              # right (-x)
        # light quad just below the ceiling, normal -y (faces the floor)
        (*meshes.quad([-15, 79.5, -35], [15, 79.5, -35], [15, 79.5, -5],
                      [-15, 79.5, -5]), emit),
        (*meshes.box([-18, 30, -35], [30, 60, 30], rotation_y=0.3), white),
        (*meshes.box([20, 14, -5], [28, 28, 28], rotation_y=-0.25), white),
    ]
    v, f, uv, m = meshes.merge(*walls)
    mesh = build_bvh(v, f, uv, m)

    mats = [
        diffuse([0.75, 0.75, 0.75]),
        diffuse([0.75, 0.25, 0.25]),
        diffuse([0.25, 0.25, 0.75]),
        diffuse([0.0, 0.0, 0.0]),  # emitter surface: pure emitter, no BSDF
    ]
    lights = [tri_light(emit, [34.0, 34.0, 34.0])]
    cam = dict(eye=[0, 45, 79.0], look_at=[0, 35, 0], up=[0, 1, 0], fov=60.0)
    return make_scene([], mats, lights, mesh=mesh), cam


def terrain_textured(n: int = 224) -> tuple[Scene, dict]:
    """BASELINE config 4: textured triangle-mesh scene (~100k tris at the
    default n=224) under a sphere sky-light, checker-textured ground."""
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.terrain(n=n, extent=120.0, height=14.0, seed=3)
    mesh = build_bvh(v, f, uv, 0)
    tex = meshes.checker_texture(256, tiles=24,
                                 c0=(0.85, 0.8, 0.7), c1=(0.35, 0.45, 0.25))

    spheres = [sphere([0, 320, 0], 160.0, 1, 0)]  # sky dome emitter
    mats = [diffuse([1.0, 1.0, 1.0]), diffuse([1.0, 1.0, 1.0])]
    lights = [area_light(0, [6.0, 6.0, 6.0])]
    cam = dict(eye=[0, 26, 52], look_at=[0, 6, 0], up=[0, 1, 0], fov=60.0)
    return (
        make_scene(spheres, mats, lights, mesh=mesh, textures=tex,
                   mat_texture=[0, -1]),
        cam,
    )


def sphere_field(n: int = 128, seed: int = 7) -> tuple["Scene", dict]:
    """n-sphere stress scene: a floor, an emitter, and a deterministic
    pseudo-random field of diffuse/mirror/glass balls. Exercises kernel
    scaling past toy prim counts (the reference never leaves 9 spheres,
    main.cpp:152-164; this answers "does the fused path survive 100+").
    """
    import numpy as np

    rng_ = np.random.default_rng(seed)
    e5 = 1e5
    spheres = [
        sphere([0, -e5, 0], e5, 3),  # floor
        sphere([0, 90.0, 0], 30.0, 1, 0),  # emitter overhead
    ]
    n_field = n - len(spheres)
    pos = rng_.uniform([-45, 2, -45], [45, 14, 45], (n_field, 3))
    rad = rng_.uniform(1.0, 3.5, n_field)
    mat = rng_.choice([0, 2, 3, 4, 5], size=n_field,
                      p=[0.3, 0.25, 0.25, 0.1, 0.1])
    for p, r, m in zip(pos, rad, mat):
        spheres.append(sphere(p.tolist(), float(r), int(m)))
    lights = [area_light(1, [14.0, 14.0, 14.0])]
    cam = dict(eye=[0, 26, 95], look_at=[0, 8, 0], up=[0, 1, 0], fov=55.0)
    return make_scene(spheres, reference_materials(), lights), cam


BUILTIN_SCENES = {
    "cornell": cornell_spheres,
    "cornell-glass": cornell_glass,
    "small": small_spheres,
    "single-sphere": single_sphere,
    "cornell-boxes": cornell_boxes,
    "cornell-quad": cornell_quad,
    "terrain": terrain_textured,
    "sphere-field": sphere_field,
}
