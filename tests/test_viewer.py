"""Viewer: headless smoke + the mouse-drag camera map (main.cpp:312-364)."""
import io

import numpy as np

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig
from pathtracer.viewer import drag_camera, run_viewer


def _cam(w=16, h=12):
    scene, cs = sc.small_spheres()
    return scene, cm.make_camera(
        cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"]
    )


def test_headless_smoke():
    scene, camera = _cam()
    n = run_viewer(
        scene, camera, RenderConfig(spp=2, max_bounces=2), seed=1,
        max_frames=2, interactive=False, out=io.StringIO(),
    )
    assert n == 2


def test_headless_smoke_pallas_backend():
    """The viewer drives the persistent kernel when handed a kernel
    renderer (the interpreter, explicitly, on the CPU) — the interactive
    path for sphere scenes on the GPU."""
    from pathtracer.models.progressive import PersistentRenderer

    scene, camera = _cam()
    config = RenderConfig(spp=2, max_bounces=2)
    r = PersistentRenderer(scene, camera, config, seed=1, budget=4,
                           interpret=True)
    n = run_viewer(
        scene, camera, config, seed=1, max_frames=2, interactive=False,
        out=io.StringIO(), renderer=r,
    )
    assert n == 2
    assert r.min_samples >= 1


def test_drag_camera_left_rotates():
    scene, camera = _cam()
    cam2 = drag_camera(camera, 0, 3, -2, 1.0)
    assert cam2 is not None
    # eye stays put under rotation, direction basis changes
    np.testing.assert_allclose(np.asarray(cam2.pos), np.asarray(camera.pos),
                               atol=1e-6)
    assert not np.allclose(np.asarray(cam2.first_ray_dir),
                           np.asarray(camera.first_ray_dir))


def test_drag_camera_right_translates_xy():
    scene, camera = _cam()
    cam2 = drag_camera(camera, 2, 2, 1, 0.5)
    assert cam2 is not None
    assert not np.allclose(np.asarray(cam2.pos), np.asarray(camera.pos))


def test_drag_camera_middle_translates_xz():
    scene, camera = _cam()
    cam2 = drag_camera(camera, 1, 1, 2, 0.5)
    assert cam2 is not None
    assert not np.allclose(np.asarray(cam2.pos), np.asarray(camera.pos))


def test_drag_camera_no_delta_is_none():
    scene, camera = _cam()
    assert drag_camera(camera, 0, 0, 0, 1.0) is None
    assert drag_camera(camera, 7, 1, 1, 1.0) is None  # unknown button
