"""Triangle-emitter area lights (TRI_LIGHT) + mesh NEE.

The reference's light model stops at point + sphere-area emitters
(light.h:40-44); TRI_LIGHT is the superset capability that lets a real
Cornell box use an emissive ceiling quad. These tests pin:
  - emitter-hit transport sees quad emission (one-sided);
  - the area sampler's geometry and solid-angle pdf;
  - NEE+MIS == brute force within MC tolerance on the emissive-quad
    Cornell box;
  - MIS factor consistency between sampler and counterweight;
  - builder validation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.ops import lights


def avg_render(scene, cam, cfg, iters, key=None):
    key = key if key is not None else jax.random.key(0)
    acc = 0
    for it in range(iters):
        acc = acc + np.array(render_image(scene, cam, key, cfg, iteration=it))
    return acc / iters


@pytest.fixture(scope="module")
def quad_box():
    scene, cs = sc.cornell_quad()
    return scene, cs


def test_scene_tables(quad_box):
    scene, _ = quad_box
    assert scene.has_tri_lights
    # 30x30 quad = 900 area, 2 triangles
    np.testing.assert_allclose(float(scene.tl_area[0]), 900.0, rtol=1e-5)
    np.testing.assert_allclose(np.array(scene.tl_cdf[0]), [0.5, 1.0],
                               rtol=1e-5)
    # normals face the floor (-y)
    np.testing.assert_allclose(np.array(scene.tl_n[0, :, 1]), [-1.0, -1.0],
                               atol=1e-6)


def test_emitter_hit_direct_view(quad_box):
    """A camera looking straight up at the quad reads its intensity via
    brute-force emitter-hit transport (no NEE involved)."""
    scene, _ = quad_box
    cam = cm.make_camera([0, 40, -20], [0, 79.5, -20], [0, 0, -1],
                         8, 8, 30.0)
    img = avg_render(scene, cam, RenderConfig(spp=4, max_bounces=0), 2)
    np.testing.assert_allclose(img[4, 4], [34.0, 34.0, 34.0], rtol=1e-4)


def test_one_sided_emission(quad_box):
    """From between the quad and the ceiling, the quad's BACK faces the
    camera: no emission (light.h:43-45 one-sidedness, quad normal -y)."""
    scene, _ = quad_box
    cam = cm.make_camera([0, 79.75, -20], [0, 79.5, -20], [0, 0, -1],
                         4, 4, 30.0)
    img = avg_render(scene, cam, RenderConfig(spp=4, max_bounces=0), 1)
    assert img.max() == 0.0


def test_tri_light_sample_geometry(quad_box):
    """Samples land on the quad; pdf == d^2 / (cos_l * A_total)."""
    scene, _ = quad_box
    rng = np.random.default_rng(0)
    n = 4000
    p = jnp.asarray(np.stack(
        [rng.uniform(-40, 40, n), rng.uniform(1, 50, n),
         rng.uniform(-70, 60, n)], -1), jnp.float32)
    u = jnp.asarray(rng.random((n, 3), np.float32))
    ls = lights.sample_lights(scene, p, u)
    ps = np.array(p) + np.array(ls.wi) * np.array(ls.dist)[:, None]
    assert bool(np.all(np.array(ls.valid)))
    # on the quad plane, inside its extent
    np.testing.assert_allclose(ps[:, 1], 79.5, atol=2e-3)
    assert (ps[:, 0] > -15.01).all() and (ps[:, 0] < 15.01).all()
    assert (ps[:, 2] > -35.01).all() and (ps[:, 2] < -4.99).all()
    # solid-angle pdf
    d2 = np.sum((ps - np.array(p)) ** 2, -1)
    cos_l = np.abs(np.array(ls.wi)[:, 1])  # normal is -y
    expect = d2 / (cos_l * 900.0)
    np.testing.assert_allclose(np.array(ls.pdf), expect, rtol=2e-3)
    # triangle choice is area-uniform over the quad: x-coordinate mean
    # sits at the quad center
    assert abs(ps[:, 0].mean()) < 1.0


def test_mis_factor_matches_sampler(quad_box):
    """tri_sel_over_area_by_mat == sel_pdf / A_total for the emitter
    material, 0 for the others (sampler/counterweight consistency)."""
    scene, _ = quad_box
    fac = np.array(lights.tri_sel_over_area_by_mat(scene, jnp.float32))
    np.testing.assert_allclose(fac[3], 1.0 / 900.0, rtol=1e-5)
    assert (fac[:3] == 0.0).all() and (fac[4:] == 0.0).all()


def test_tri_nee_matches_brute_force(quad_box):
    """The emissive-quad Cornell box renders the
    same image under NEE+MIS and brute force (MC tolerance)."""
    scene, cs = quad_box
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 32, 24,
                         cs["fov"])
    bf = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4), 12,
                    key=jax.random.key(2))
    ne = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4,
                                             use_nee=True), 12)
    ratio = ne.mean() / bf.mean()
    assert abs(ratio - 1.0) < 0.05, ratio
    # NEE reduces variance vs an equal-budget brute render
    one_b = np.array(render_image(
        scene, cam, jax.random.key(0),
        RenderConfig(spp=8, max_bounces=4), iteration=99))
    one_n = np.array(render_image(
        scene, cam, jax.random.key(0),
        RenderConfig(spp=8, max_bounces=4, use_nee=True), iteration=99))
    err_b = np.abs(one_b - bf).mean()
    err_n = np.abs(one_n - ne).mean()
    assert err_n < 0.8 * err_b, (err_b, err_n)


def test_mixed_sphere_and_tri_lights():
    """A scene with BOTH a sphere emitter and a tri light: the shared
    power-proportional selector keeps NEE unbiased across types."""
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([-8, 12, -8], [8, 12, -8], [8, 12, 8],
                           [-8, 12, 8])  # normal -y
    mesh = build_bvh(v, f, uv, 2)
    spheres = [
        sc.sphere([0, -1e4, 0], 1e4, 0),    # floor
        sc.sphere([-6, 5, 0], 1.0, 1, 0),   # sphere emitter
    ]
    mats = [sc.diffuse([0.7, 0.7, 0.7]), sc.diffuse([0, 0, 0]),
            sc.diffuse([0, 0, 0])]
    lgts = [sc.area_light(1, [30, 30, 30]), sc.tri_light(2, [8, 8, 8])]
    scene = sc.make_scene(spheres, mats, lgts, mesh=mesh)
    cam = cm.make_camera([0, 6, 18], [0, 2, 0], [0, 1, 0], 24, 18, 60.0)
    bf = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4), 16)
    ne = avg_render(scene, cam, RenderConfig(spp=8, max_bounces=4,
                                             use_nee=True), 16)
    ratio = ne.mean() / bf.mean()
    assert abs(ratio - 1.0) < 0.06, ratio


def test_builder_validation():
    with pytest.raises(ValueError, match="requires a mesh"):
        sc.make_scene([], [sc.diffuse([1, 1, 1])],
                      [sc.tri_light(0, [1, 1, 1])])
    from pathtracer.models import meshes
    from pathtracer.models.mesh import build_bvh

    v, f, uv = meshes.quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0])
    mesh = build_bvh(v, f, uv, 0)
    with pytest.raises(ValueError, match="out of range"):
        sc.make_scene([], [sc.diffuse([1, 1, 1])],
                      [sc.tri_light(5, [1, 1, 1])], mesh=mesh)
    with pytest.raises(ValueError, match="no mesh triangle"):
        sc.make_scene([], [sc.diffuse([1, 1, 1]), sc.diffuse([1, 1, 1])],
                      [sc.tri_light(1, [1, 1, 1])], mesh=mesh)
