"""Camera geometry tests (reference camera.h parity)."""
import jax.numpy as jnp
import numpy as np

from pathtracer.models import camera as cm
from pathtracer.ops import vecmath as vm

W, H = 640, 480


def make():
    return cm.make_camera([0, 45, 79.5], [0, 35, 0], [0, 1, 0], W, H, 60.0)


def test_view_matrix_orthonormal():
    cam = make()
    v = np.array(cam.view)
    np.testing.assert_allclose(v @ v.T, np.eye(3), atol=1e-5)


def test_center_ray_points_at_look_at():
    cam = make()
    # The image-plane center sits at pixel (W/2, H/2) with zero jitter
    # (reference camera.h:154-155: offset puts pixel (0,0) at the upper left).
    o, d = cm.generate_rays(
        cam, jnp.asarray([W / 2]), jnp.asarray([H / 2]),
        jnp.zeros(1), jnp.zeros(1),
    )
    to_target = vm.normalize(jnp.asarray([[0.0, 35.0, 0.0]]) - o)
    np.testing.assert_allclose(np.array(d), np.array(to_target), atol=1e-5)


def test_ray_direction_matches_reference_formula():
    cam = make()
    rng = np.random.default_rng(0)
    px = jnp.asarray(rng.integers(0, W, 50))
    py = jnp.asarray(rng.integers(0, H, 50))
    ju = jnp.asarray(rng.uniform(-0.5, 0.5, 50).astype(np.float32))
    jv = jnp.asarray(rng.uniform(-0.5, 0.5, 50).astype(np.float32))
    o, d = cm.generate_rays(cam, px, py, ju, jv)
    # Oracle: dir = firstRayDir - pxY*sy + pxX*sx (camera.h:66-72).
    frd = np.array(cam.first_ray_dir, np.float64)
    pxx = np.array(cam.px_x, np.float64)
    pxy = np.array(cam.px_y, np.float64)
    sx = (np.array(px) + np.array(ju))[:, None]
    sy = (np.array(py) + np.array(jv))[:, None]
    dir_ref = frd[None] - pxy[None] * sy + pxx[None] * sx
    dir_ref /= np.linalg.norm(dir_ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.array(d), dir_ref, atol=1e-5)
    np.testing.assert_allclose(np.array(o), np.tile(np.array(cam.pos), (50, 1)), atol=1e-6)


def test_fov_spans_image_plane():
    cam = make()
    # Horizontal angle between leftmost and rightmost center-row rays ~ hfov.
    o, d = cm.generate_rays(
        cam, jnp.asarray([0.0, float(W)]), jnp.asarray([H / 2, H / 2]),
        jnp.zeros(2), jnp.zeros(2),
    )
    cosang = float(vm.dot(d[0:1], d[1:2])[0])
    ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    np.testing.assert_allclose(ang, 60.0, atol=1.0)


def test_translate_moves_along_view_axes():
    cam = make()
    cam2 = cm.translate(cam, [0.0, 0.0, 2.0])  # forward
    moved = np.array(cam2.pos) - np.array(cam.pos)
    w = np.array(cam.view[2])
    np.testing.assert_allclose(moved, 2.0 * w, atol=1e-5)
    # Image-plane basis unchanged (camera.h:87-88).
    np.testing.assert_allclose(np.array(cam2.first_ray_dir), np.array(cam.first_ray_dir))


def test_rotate_preserves_orthonormality_and_updates_plane():
    cam = make()
    cam2 = cm.rotate(cam, [0.05, -0.03])
    v = np.array(cam2.view)
    np.testing.assert_allclose(v @ v.T, np.eye(3), atol=1e-5)
    assert not np.allclose(np.array(cam2.first_ray_dir), np.array(cam.first_ray_dir))


def test_dof_pinhole_unchanged():
    cam = make()
    px = jnp.asarray([100.0]); py = jnp.asarray([200.0])
    z = jnp.zeros(1)
    o1, d1 = cm.generate_rays(cam, px, py, z, z)
    o2, d2 = cm.generate_rays(cam, px, py, z, z, jnp.asarray([0.7]), jnp.asarray([0.3]))
    # lens_radius == 0 -> thin lens inactive.
    np.testing.assert_allclose(np.array(o1), np.array(o2), atol=1e-6)
    np.testing.assert_allclose(np.array(d1), np.array(d2), atol=1e-6)


def test_dof_focal_plane_invariant():
    cam = cm.make_camera([0, 0, 10], [0, 0, 0], [0, 1, 0], 64, 64, 60.0,
                         lens_radius=0.5, focal_distance=10.0)
    px = jnp.full((8,), 32.0); py = jnp.full((8,), 32.0)
    z = jnp.zeros(8)
    lu = jnp.linspace(0.05, 0.95, 8); lv = jnp.linspace(0.9, 0.1, 8)
    o, d = cm.generate_rays(cam, px, py, z, z, lu, lv)
    # All lens rays for one pixel converge on the focal plane point.
    cos_w = np.array(vm.dot(d, jnp.tile(cam.view[2][None], (8, 1))))
    t = 10.0 / cos_w
    pts = np.array(o) + np.array(d) * t[:, None]
    assert np.ptp(pts, axis=0).max() < 1e-4
    # But origins differ (aperture sampling active).
    assert np.ptp(np.array(o), axis=0).max() > 0.1
