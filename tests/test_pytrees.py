"""Frozen-dataclass pytrees (utils/pytree) under jit, and the .npz
checkpoint format (utils/checkpoint)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.diff import inverse
from pathtracer.models import camera as cm, progressive as prog, scene as sc
from pathtracer.models.integrator import RenderConfig
from pathtracer.ops.pallas.persistent import init_state
from pathtracer.utils import checkpoint as ckpt


def _scene():
    return sc.cornell_spheres()[0]


def _camera():
    _, cs = sc.cornell_spheres()
    return cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 8, 6,
                          cs["fov"], lens_radius=1.0, focal_distance=30.0)


def _mesh():
    return sc.cornell_boxes()[0].mesh


def _train_state():
    return inverse.init_state(_scene(), inverse.make_optimizer())


CASES = {
    "scene": _scene,
    "camera": _camera,
    "mesh": _mesh,
    "accumulator": lambda: prog.init_state(6, 8),
    "path_state": lambda: init_state(8, 6, block=16),
    "train_state": _train_state,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pytree_roundtrips_through_jit(name):
    """Array fields are leaves, static fields ride the treedef: a jitted
    identity returns an equal tree with the same static metadata."""
    obj = CASES[name]()
    out = jax.jit(lambda t: jax.tree.map(lambda x: x + 0, t))(obj)
    assert jax.tree.structure(out) == jax.tree.structure(obj)
    for a, b in zip(jax.tree.leaves(obj), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_static_fields_are_not_leaves():
    cam = _camera()
    leaves = jax.tree.leaves(cam)
    assert all(hasattr(x, "shape") for x in leaves)
    assert cam.use_dof and cam.width == 8
    # a static field change is a different treedef (a recompile), not data
    cam2 = dataclasses.replace(cam, width=16)
    assert jax.tree.structure(cam2) != jax.tree.structure(cam)


def test_render_config_is_hashable_and_frozen():
    cfg = RenderConfig(spp=2, use_nee=True)
    assert hash(cfg) == hash(RenderConfig(spp=2, use_nee=True))
    assert jax.tree.leaves(cfg) == []
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.spp = 3


def test_checkpoint_path_state_roundtrip(tmp_path):
    st = init_state(8, 6, block=16)
    st = dataclasses.replace(st, lr=st.lr + 1.5, n_samp=st.n_samp + 3,
                             frame=st.frame + 7)
    ckpt.save_state(str(tmp_path), 7, st)
    back = ckpt.restore_state(str(tmp_path), init_state(8, 6, block=16))
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_checkpoint_keeps_newest(tmp_path):
    st = prog.init_state(2, 2)
    for step in range(5):
        ckpt.save_state(str(tmp_path), step, st, max_to_keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000003.npz", "step_0000000004.npz"]


def test_checkpoint_rejects_mismatched_template(tmp_path):
    ckpt.save_state(str(tmp_path), 0, prog.init_state(4, 4))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_state(str(tmp_path), prog.init_state(8, 8))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(str(tmp_path / "none"), prog.init_state(4, 4))


def test_checkpoint_restores_specific_step(tmp_path):
    s = prog.init_state(2, 2)
    ckpt.save_state(str(tmp_path), 1, dataclasses.replace(
        s, iteration=jnp.int32(1)))
    ckpt.save_state(str(tmp_path), 2, dataclasses.replace(
        s, iteration=jnp.int32(2)))
    assert int(ckpt.restore_state(str(tmp_path), s, step=1).iteration) == 1
    assert int(ckpt.restore_state(str(tmp_path), s).iteration) == 2
