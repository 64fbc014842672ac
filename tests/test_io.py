"""Tests for image IO, scene JSON IO, and the CLI."""
import json
import os

import numpy as np
import pytest

from pathtracer.io.image import read_png, save_png, tonemap, write_png
from pathtracer.io.scene_io import load_scene, save_scene, scene_from_dict
from pathtracer.models import scene as sc


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((33, 47, 3), np.float32)
    p = str(tmp_path / "t.png")
    save_png(p, img, gamma=1.0)
    back = read_png(p)
    np.testing.assert_array_equal(back, tonemap(img, gamma=1.0))


def test_tonemap_gamma_and_clamp():
    img = np.asarray([[[0.0, 0.5, 2.0]]], np.float32)
    out = tonemap(img, gamma=1.0)
    np.testing.assert_array_equal(out[0, 0], [0, 128, 255])
    out22 = tonemap(img, gamma=2.2)
    assert out22[0, 0, 1] > 128  # gamma brightens midtones


def test_scene_json_roundtrip(tmp_path):
    scene, cs = sc.cornell_spheres()
    p = str(tmp_path / "scene.json")
    save_scene(p, scene, cs)
    scene2, cs2 = load_scene(p)
    np.testing.assert_allclose(np.array(scene.centers), np.array(scene2.centers))
    np.testing.assert_allclose(np.array(scene.radii), np.array(scene2.radii))
    np.testing.assert_allclose(np.array(scene.mat_color), np.array(scene2.mat_color))
    np.testing.assert_array_equal(np.array(scene.mat_type), np.array(scene2.mat_type))
    np.testing.assert_allclose(
        np.array(scene.light_intensity), np.array(scene2.light_intensity))
    assert cs2["eye"] == cs["eye"] and cs2["fov"] == cs["fov"]


def test_scene_from_dict_validation():
    with pytest.raises(ValueError, match="unknown type"):
        scene_from_dict({"materials": [{"type": "velvet", "color": [1, 1, 1]}]})
    with pytest.raises(ValueError, match="material id"):
        scene_from_dict({
            "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
            "spheres": [{"center": [0, 0, 0], "radius": 1, "material": 5}],
        })
    # mesh triangles referencing an undeclared material must fail fast
    # too (they would otherwise gather a zero padding row and render
    # black with no diagnostic)
    with pytest.raises(ValueError, match="material id"):
        scene_from_dict({
            "materials": [{"type": "diffuse", "color": [1, 1, 1]}],
            "meshes": [{"type": "box", "center": [0, 0, 0],
                        "size": [1, 1, 1], "material": 5}],
        })


def test_cli_render_and_output(tmp_path):
    from pathtracer.cli import main

    out = str(tmp_path / "o.png")
    rc = main(["render", "--scene", "single-sphere", "--size", "24x24",
               "--spp", "2", "--iterations", "1",
               "-o", out, "-q"])
    assert rc == 0 and os.path.exists(out)
    img = read_png(out)
    assert img.shape == (24, 24, 3)
    assert img.max() > 0  # something rendered


def test_cli_render_json_scene(tmp_path):
    from pathtracer.cli import main

    doc = {
        "camera": {"eye": [0, 0, 4], "look_at": [0, 0, 0], "up": [0, 1, 0],
                   "fov": 50.0},
        "materials": [{"type": "diffuse", "color": [0.8, 0.2, 0.2]}],
        "spheres": [
            {"center": [0, 0, 0], "radius": 1.0, "material": 0},
            {"center": [0, 2.5, 0], "radius": 0.5, "material": 0, "light": 0},
        ],
        "lights": [{"type": "area", "prim": 1, "intensity": [15, 15, 15]}],
    }
    p = str(tmp_path / "s.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    out = str(tmp_path / "o.png")
    rc = main(["render", "--scene", p, "--size", "16x16", "--iterations", "1",
               "-o", out, "-q"])
    assert rc == 0 and os.path.exists(out)


def test_cost_report_and_trace(tmp_path):
    import jax
    import jax.numpy as jnp

    from pathtracer.utils.profiling import cost_report, trace

    def f(x):
        return (x @ x).sum()

    rep = cost_report(f, jnp.ones((64, 64)))
    assert rep.get("flops", 0) > 0
    with trace(str(tmp_path / "tr")) as d:
        jax.block_until_ready(jax.jit(f)(jnp.ones((32, 32))))
    import os
    assert any(os.scandir(d))  # trace files were written


def test_scene_json_with_meshes_and_tri_light(tmp_path):
    """The JSON format's mesh section: generator parts + an OBJ file merge
    into one BVH, 'tri' lights make a material emissive, relative OBJ
    paths resolve against the scene file's directory."""
    import jax

    from pathtracer.models import camera as cm
    from pathtracer.models.integrator import RenderConfig, render_image

    (tmp_path / "tri.obj").write_text(
        "v -2 6 -2\nv 2 6 -2\nv 0 6 2\nf 1 2 3\n"
    )
    doc = {
        "camera": {"eye": [0, 4, 12], "look_at": [0, 2, 0], "fov": 60.0},
        "materials": [
            {"type": "diffuse", "color": [0.7, 0.7, 0.7]},
            {"type": "diffuse", "color": [0.8, 0.2, 0.2]},
            {"type": "diffuse", "color": [1.0, 1.0, 1.0]},
        ],
        "meshes": [
            {"type": "quad", "corners": [[-8, 0, 8], [8, 0, 8],
                                         [8, 0, -8], [-8, 0, -8]],
             "material": 0},
            {"type": "box", "center": [0, 1.5, 0], "size": [2, 3, 2],
             "rotation_y": 0.4, "material": 1},
            {"type": "obj", "path": "tri.obj", "material": 2},
        ],
        "lights": [{"type": "tri", "material": 2,
                    "intensity": [25, 25, 25]}],
    }
    p = tmp_path / "scene.json"
    p.write_text(__import__("json").dumps(doc))

    scene, cs = load_scene(str(p))
    assert scene.mesh is not None and scene.has_tri_lights
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 24, 18,
                         cs["fov"])
    img = np.array(render_image(
        scene, cam, jax.random.key(2),
        RenderConfig(spp=2, max_bounces=2, use_nee=True)))
    assert np.isfinite(img).all() and img.max() > 0

    # mesh scenes refuse to serialize (no silent geometry loss)
    with pytest.raises(ValueError):
        save_scene(str(tmp_path / "back.json"), scene, cs)
