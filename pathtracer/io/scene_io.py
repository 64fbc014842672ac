"""Declarative scene files (JSON) — the reference's unfulfilled TODO.

The reference hard-codes its scene in C++ ("TODO: configuration file
parsing", reference main.cpp:126-166). This module defines that file
format: a JSON document with materials, spheres, triangle meshes,
lights, and a camera block.

Example:
{
  "camera": {"eye": [0,45,79.5], "look_at": [0,35,0], "up": [0,1,0],
             "fov": 60.0, "lens_radius": 0.0, "focal_distance": 0.0},
  "materials": [
    {"type": "diffuse", "color": [0.75, 0.25, 0.25]},
    {"type": "specular", "color": [0.999, 0.999, 0.999], "coef": 1.0},
    {"type": "transmissive", "color": [0.999, 0.999, 0.999], "ior": 1.5}
  ],
  "spheres": [
    {"center": [0, 0, 0], "radius": 1.0, "material": 0},
    {"center": [0, 3, 0], "radius": 0.5, "material": 0, "light": 0}
  ],
  "meshes": [
    {"type": "obj", "path": "bunny.obj", "material": 0,
     "translate": [0, 0, 0], "scale": 1.0},
    {"type": "box", "center": [0, 5, 0], "size": [10, 10, 10],
     "rotation_y": 0.3, "material": 1},
    {"type": "quad", "corners": [[-5,0,5],[5,0,5],[5,0,-5],[-5,0,-5]],
     "material": 0},
    {"type": "uv_sphere", "center": [0, 3, 0], "radius": 2.0,
     "material": 2, "n_lat": 16, "n_lon": 24},
    {"type": "terrain", "n": 128, "extent": 200, "height": 14,
     "seed": 0, "material": 3}
  ],
  "lights": [
    {"type": "area", "prim": 1, "intensity": [12, 12, 12]},
    {"type": "point", "pos": [0, 5, 0], "intensity": [100, 100, 100]},
    {"type": "tri", "material": 3, "intensity": [30, 30, 30]}
  ]
}

Mesh entries merge into ONE BVH; "obj" paths resolve relative to the
scene file. "tri" lights turn every triangle of a material into an
emitter (TRI_LIGHT — the capability the reference's light model lacks).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from pathtracer.models import scene as sc

_MAT_TYPES = {"diffuse": sc.DIFFUSE, "specular": sc.SPECULAR,
              "transmissive": sc.TRANSMISSIVE}
_MAT_NAMES = {v: k for k, v in _MAT_TYPES.items()}


def _mesh_part(i: int, m: dict, base_dir: str):
    """One "meshes" entry -> (verts, faces, uvs, material_id)."""
    from pathtracer.models import meshes

    t = m.get("type", "obj")
    mat = int(m.get("material", 0))
    if t == "obj":
        path = m["path"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        v, f, uv = meshes.load_obj(path)
        v = np.asarray(v, np.float32) * float(m.get("scale", 1.0))
        v = v + np.asarray(m.get("translate", [0.0, 0.0, 0.0]), np.float32)
    elif t == "box":
        v, f, uv = meshes.box(m["center"], m["size"],
                              rotation_y=float(m.get("rotation_y", 0.0)))
    elif t == "quad":
        v, f, uv = meshes.quad(*m["corners"])
    elif t == "uv_sphere":
        v, f, uv = meshes.uv_sphere(
            m["center"], float(m["radius"]),
            n_lat=int(m.get("n_lat", 32)), n_lon=int(m.get("n_lon", 64)),
        )
    elif t == "terrain":
        v, f, uv = meshes.terrain(
            n=int(m.get("n", 128)), extent=float(m.get("extent", 100.0)),
            height=float(m.get("height", 12.0)), seed=int(m.get("seed", 0)),
        )
    else:
        raise ValueError(f"mesh {i}: unknown type {t!r}")
    return v, f, uv, mat


def scene_from_dict(doc: dict, base_dir: str = ".") -> tuple[sc.Scene, dict]:
    """Build (Scene, camera_spec) from a parsed scene document.

    base_dir: directory for resolving relative OBJ paths (load_scene
    passes the scene file's directory).
    """
    materials = []
    for i, m in enumerate(doc.get("materials", [])):
        t = m.get("type", "diffuse")
        if t not in _MAT_TYPES:
            raise ValueError(f"material {i}: unknown type {t!r}")
        coef = m.get("coef", m.get("ior", 1.5 if t == "transmissive" else 0.0))
        materials.append(
            {"type": _MAT_TYPES[t], "color": m["color"], "coef": float(coef)}
        )

    spheres = []
    for i, s in enumerate(doc.get("spheres", [])):
        spheres.append(
            sc.sphere(s["center"], float(s["radius"]), int(s["material"]),
                      int(s.get("light", -1)))
        )

    mesh = None
    mesh_docs = doc.get("meshes", [])
    if mesh_docs:
        from pathtracer.models import meshes
        from pathtracer.models.mesh import build_bvh

        parts = [_mesh_part(i, m, base_dir) for i, m in enumerate(mesh_docs)]
        v, f, uv, mids = meshes.merge(*parts)
        mesh = build_bvh(v, f, uv, mids)

    lights = []
    for i, l in enumerate(doc.get("lights", [])):
        t = l.get("type", "area")
        if t == "area":
            lights.append(sc.area_light(int(l["prim"]), l["intensity"]))
        elif t == "point":
            lights.append(sc.point_light(l["pos"], l["intensity"]))
        elif t == "tri":
            lights.append(sc.tri_light(int(l["material"]), l["intensity"]))
        else:
            raise ValueError(f"light {i}: unknown type {t!r}")

    cam = doc.get("camera", {})
    cam_spec = dict(
        eye=cam.get("eye", [0, 0, 5]),
        look_at=cam.get("look_at", [0, 0, 0]),
        up=cam.get("up", [0, 1, 0]),
        fov=float(cam.get("fov", 60.0)),
        lens_radius=float(cam.get("lens_radius", 0.0)),
        focal_distance=float(cam.get("focal_distance", 0.0)),
    )
    return sc.make_scene(spheres, materials, lights, mesh=mesh), cam_spec


def load_scene(path: str) -> tuple[sc.Scene, dict]:
    with open(path) as f:
        return scene_from_dict(json.load(f),
                               base_dir=os.path.dirname(os.path.abspath(path)))


def scene_to_dict(scene: sc.Scene, cam_spec: dict | None = None) -> dict:
    """Serialize a Scene back to the JSON document format.

    Mesh geometry does not round-trip (the Scene holds a built BVH, not
    the source declarations) — refuse rather than silently dropping it.
    """
    if scene.mesh is not None:
        raise ValueError(
            "mesh scenes do not serialize back to JSON; keep their source "
            "scene documents"
        )

    mats = []
    for i in range(int(np.asarray(scene.mat_type).shape[0])):
        if i >= _n_real_mats(scene):
            break
        mats.append(
            {
                "type": _MAT_NAMES[int(scene.mat_type[i])],
                "color": np.asarray(scene.mat_color[i]).tolist(),
                "coef": float(scene.mat_coef[i]),
            }
        )
    spheres = []
    for i in range(scene.num_prims):
        spheres.append(
            {
                "center": np.asarray(scene.centers[i]).tolist(),
                "radius": float(scene.radii[i]),
                "material": int(scene.material_id[i]),
                **(
                    {"light": int(scene.light_id[i])}
                    if int(scene.light_id[i]) >= 0
                    else {}
                ),
            }
        )
    lights = []
    for i in range(scene.num_lights):
        if int(scene.light_type[i]) == sc.AREA_LIGHT:
            lights.append(
                {
                    "type": "area",
                    "prim": int(scene.light_prim[i]),
                    "intensity": np.asarray(scene.light_intensity[i]).tolist(),
                }
            )
        else:
            lights.append(
                {
                    "type": "point",
                    "pos": np.asarray(scene.light_pos[i]).tolist(),
                    "intensity": np.asarray(scene.light_intensity[i]).tolist(),
                }
            )
    doc: dict[str, Any] = {
        "materials": mats, "spheres": spheres, "lights": lights,
    }
    if cam_spec:
        doc["camera"] = cam_spec
    return doc


def _n_real_mats(scene: sc.Scene) -> int:
    """Count non-padding materials (padding rows are zeroed diffuse)."""
    import numpy as np

    used = set(np.asarray(scene.material_id[: scene.num_prims]).tolist())
    return max(used) + 1 if used else 0


def save_scene(path: str, scene: sc.Scene, cam_spec: dict | None = None) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene, cam_spec), f, indent=2)
