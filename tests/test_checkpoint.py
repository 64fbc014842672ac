"""Checkpoint/resume tests: progressive renders continue bit-for-bit."""
import jax
import numpy as np

from pathtracer.models import camera as cm, progressive as prog, scene as sc
from pathtracer.models.integrator import RenderConfig
from pathtracer.utils import checkpoint as ckpt


def test_progressive_resume_bit_exact(tmp_path):
    scene, cs = sc.single_sphere()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 16, cs["fov"])
    cfg = RenderConfig(spp=2, max_bounces=2)
    key = jax.random.key(9)

    # Uninterrupted: 4 iterations.
    s_full = prog.init_state(16, 16)
    for _ in range(4):
        s_full = prog.step(s_full, scene, cam, key, cfg)

    # Interrupted: 2 iterations, snapshot, restore, 2 more.
    s = prog.init_state(16, 16)
    for _ in range(2):
        s = prog.step(s, scene, cam, key, cfg)
    d = str(tmp_path / "ckpt")
    ckpt.save_state(d, int(s.iteration), s)

    assert ckpt.latest_step(d) == 2
    s2 = ckpt.restore_state(d, prog.init_state(16, 16))
    assert int(s2.iteration) == 2
    for _ in range(2):
        s2 = prog.step(s2, scene, cam, key, cfg)

    np.testing.assert_array_equal(
        np.array(prog.image(s_full)), np.array(prog.image(s2))
    )


def test_train_state_roundtrip(tmp_path):
    from pathtracer.diff import inverse

    scene, _ = sc.single_sphere()
    opt = inverse.make_optimizer()
    state = inverse.init_state(scene, opt)
    d = str(tmp_path / "train")
    ckpt.save_state(d, 0, state)
    back = ckpt.restore_state(d, inverse.init_state(scene, opt))
    np.testing.assert_array_equal(
        np.array(state.params["mat_color"]), np.array(back.params["mat_color"])
    )
    assert int(back.step) == 0


def test_latest_step_missing_dir(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
