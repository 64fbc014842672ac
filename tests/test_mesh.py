"""Tests for triangle meshes, the threaded BVH, and textured shading."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.models import camera as cm, meshes, scene as sc
from pathtracer.models.mesh import build_bvh
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.models.scene import prim_attrs
from pathtracer.ops.intersect import intersect, intersect_p
from pathtracer.ops.texture import sample_bilinear
from pathtracer.ops.triangle import (
    BIG, intersect_mesh, mesh_brute_force_t, moller_trumbore,
)


def random_rays(n, seed, lo=-60, hi=60):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_moller_trumbore_basics():
    v0 = jnp.asarray([[0.0, 0.0, 0.0]])
    e1 = jnp.asarray([[1.0, 0.0, 0.0]])
    e2 = jnp.asarray([[0.0, 1.0, 0.0]])
    o = jnp.asarray([[0.25, 0.25, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    valid, t, u, v = moller_trumbore(o, d, v0, e1, e2, 1e-3, jnp.asarray([BIG]))
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose([float(u[0]), float(v[0])], [0.25, 0.25], rtol=1e-5)
    # outside the triangle
    o2 = jnp.asarray([[0.9, 0.9, 1.0]])
    valid2, *_ = moller_trumbore(o2, d, v0, e1, e2, 1e-3, jnp.asarray([BIG]))
    assert not bool(valid2[0])
    # two-sided: from below
    o3 = jnp.asarray([[0.25, 0.25, -1.0]])
    d3 = jnp.asarray([[0.0, 0.0, 1.0]])
    valid3, *_ = moller_trumbore(o3, d3, v0, e1, e2, 1e-3, jnp.asarray([BIG]))
    assert bool(valid3[0])


@pytest.mark.parametrize("mesh_fn", [
    lambda: meshes.box([0, 0, 0], [20, 10, 14], rotation_y=0.4),
    lambda: meshes.uv_sphere([5, -3, 2], 12.0, n_lat=12, n_lon=18),
    lambda: meshes.terrain(n=24, extent=80, height=10),
])
def test_bvh_matches_brute_force(mesh_fn):
    v, f, uv = mesh_fn()
    mesh = build_bvh(v, f, uv)
    o, d = random_rays(800, 1)
    got = intersect_mesh(mesh, o, d, tmin=1e-3)
    want = mesh_brute_force_t(mesh, o, d, tmin=1e-3)
    hit_g = np.array(got.t) < BIG / 2
    hit_w = np.array(want.t) < BIG / 2
    np.testing.assert_array_equal(hit_g, hit_w)
    np.testing.assert_allclose(
        np.array(got.t)[hit_g], np.array(want.t)[hit_w], rtol=1e-5
    )
    np.testing.assert_array_equal(np.array(got.tri)[hit_g], np.array(want.tri)[hit_w])


def test_bvh_respects_tmax():
    v, f, uv = meshes.quad([-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5])
    mesh = build_bvh(v, f, uv)
    o = jnp.asarray([[0, 10, 0.0]])
    d = jnp.asarray([[0, -1, 0.0]])
    full = intersect_mesh(mesh, o, d, tmin=1e-3)
    np.testing.assert_allclose(float(full.t[0]), 10.0, rtol=1e-5)
    short = intersect_mesh(mesh, o, d, tmin=1e-3, tmax=jnp.asarray([5.0]))
    assert float(short.t[0]) > BIG / 2  # beyond the segment -> miss


def test_scene_intersect_merges_spheres_and_mesh():
    v, f, uv = meshes.quad([-10, 0, 10], [10, 0, 10], [10, 0, -10], [-10, 0, -10])
    mesh = build_bvh(v, f, uv, material_id=1)  # +y-facing floor
    scene = sc.make_scene(
        [sc.sphere([0, 3, 0], 1.0, 0)],
        [sc.diffuse([0.9, 0.1, 0.1]), sc.diffuse([0.1, 0.9, 0.1])],
        [],
        mesh=mesh,
    )
    attrs = prim_attrs(scene)
    o = jnp.asarray([[0, 10, 0.0], [5, 10, 5.0]], jnp.float32)
    d = jnp.asarray([[0, -1, 0.0], [0, -1, 0.0]], jnp.float32)
    h = intersect(scene, attrs, o, d)
    # ray 0 hits the sphere first (t=6), ray 1 hits the floor (t=10)
    np.testing.assert_allclose(float(h.t[0]), 6.0, rtol=1e-5)
    np.testing.assert_allclose(float(h.t[1]), 10.0, rtol=1e-5)
    np.testing.assert_allclose(np.array(h.albedo[0]), [0.9, 0.1, 0.1], rtol=1e-5)
    np.testing.assert_allclose(np.array(h.albedo[1]), [0.1, 0.9, 0.1], rtol=1e-5)
    np.testing.assert_allclose(np.array(h.n[1]), [0, 1, 0], atol=1e-5)
    # shadow query sees the mesh too
    occ = intersect_p(scene, o, d, tmax=jnp.asarray([20.0, 20.0]))
    assert bool(occ[0]) and bool(occ[1])


def test_texture_sampling():
    tex = np.zeros((1, 4, 4, 3), np.float32)
    tex[0, :, :2] = [1, 0, 0]  # left half red
    tex[0, :, 2:] = [0, 0, 1]  # right half blue
    uv = jnp.asarray([[0.25, 0.5], [0.75, 0.5]])
    out = sample_bilinear(jnp.asarray(tex), jnp.asarray([0, 0]), uv)
    np.testing.assert_allclose(np.array(out[0]), [1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.array(out[1]), [0, 0, 1], atol=1e-5)
    # tex_id -1 -> zeros
    out2 = sample_bilinear(jnp.asarray(tex), jnp.asarray([-1]), uv[:1])
    np.testing.assert_array_equal(np.array(out2), np.zeros((1, 3)))


def test_textured_mesh_render_shows_texture():
    v, f, uv = meshes.quad([-10, 0, 10], [10, 0, 10], [10, 0, -10], [-10, 0, -10])
    mesh = build_bvh(v, f, uv, material_id=0)  # +y-facing floor
    tex = meshes.checker_texture(64, tiles=4, c0=(1, 0, 0), c1=(0, 0, 1))
    scene = sc.make_scene(
        [sc.sphere([0, 15, 0], 3.0, 1, 0)],
        [sc.diffuse([1, 1, 1]), sc.diffuse([1, 1, 1])],
        [sc.area_light(0, [40, 40, 40])],
        mesh=mesh, textures=tex, mat_texture=[0, -1],
    )
    cam = cm.make_camera([0, 12, 12], [0, 0, 0], [0, 1, 0], 32, 32, 60.0)
    acc = 0
    for it in range(4):
        acc = acc + np.array(render_image(
            scene, cam, jax.random.key(0),
            RenderConfig(spp=4, max_bounces=2, use_nee=True), iteration=it))
    img = acc / 4
    # both checker colors visible: red-dominant and blue-dominant pixels
    red = (img[..., 0] > 2 * img[..., 2] + 0.01) & (img[..., 0] > 0.02)
    blue = (img[..., 2] > 2 * img[..., 0] + 0.01) & (img[..., 2] > 0.02)
    assert red.sum() > 20 and blue.sum() > 20


def test_builtin_mesh_scenes_render_finite():
    for name, size in [("cornell-boxes", (32, 24))]:
        scene, cs = sc.BUILTIN_SCENES[name]()
        cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], *size, cs["fov"])
        img = np.array(render_image(
            scene, cam, jax.random.key(1),
            RenderConfig(spp=2, max_bounces=3, use_nee=True)))
        assert np.all(np.isfinite(img)) and img.max() > 0


def test_obj_loader(tmp_path):
    p = tmp_path / "tri.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
        "f 1/1 2/2 4/4 3/3\n"  # quad -> 2 tris
    )
    v, f, uv = meshes.load_obj(str(p))
    assert v.shape == (4, 3) and f.shape == (2, 3)
    np.testing.assert_allclose(uv[3], [1, 1])
