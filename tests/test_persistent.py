"""Tests for the persistent path-regeneration kernel (ops/pallas/persistent).

On the CPU the Triton-route kernel runs through the Pallas interpreter
(`interpret=True`, always passed explicitly). Its random numbers come from
the same counter-based hash in interpret mode and compiled, so these tests
exercise the kernel's real streams, not a stand-in.

The kernel and the wavefront integrator (models/integrator.py, the plain
reference) agree in distribution, not sample for sample: their random
streams differ and the kernel warps the diffuse and lens disks with the
polar map. Comparisons are therefore z-scores of image means over
independent replicates on each side.
"""
from __future__ import annotations

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.models.progressive import PersistentRenderer
from pathtracer.ops import lights
from pathtracer.ops.pallas.persistent import (
    BLOCK, init_state, pack_lights, pack_prims, padded_lanes,
    persistent_step, state_min_samples, strat_k_for,
)
from pathtracer.parallel import persistent_sharded
from pathtracer.parallel.mesh import make_mesh
from pathtracer.parallel.persistent_sharded import (
    init_state_sharded, persistent_step_sharded,
)
from pathtracer.utils import checkpoint as ckpt

W, H = 16, 12
MB = 3


def _camera(cs, w=W, h=H, dof=False):
    return cm.make_camera(
        cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
        lens_radius=1.5 if dof else 0.0, focal_distance=40.0 if dof else 0.0,
    )


def _kernel_means(scene, camera, use_nee, reps, spp=32, max_bounces=MB):
    """Image means of `reps` independent kernel renders (fresh salts), each
    exactly `spp` samples per pixel, stratified like the XLA path's 16."""
    cfg = RenderConfig(spp=16, max_bounces=max_bounces, use_nee=use_nee)
    r = PersistentRenderer(scene, camera, cfg, seed=17, budget=32,
                           interpret=True)
    out = []
    for _ in range(reps):
        r.reset()
        r.render_to(spp)
        out.append(float(r.image().mean()))
    return np.asarray(out)


def _xla_means(scene, camera, use_nee, reps, spp=16, max_bounces=MB):
    cfg = RenderConfig(spp=spp, max_bounces=max_bounces, use_nee=use_nee)
    return np.asarray([
        float(render_image(scene, camera, jax.random.key(100 + i), cfg,
                           iteration=i).mean())
        for i in range(reps)
    ])


def _z(a, b):
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    return (a.mean() - b.mean()) / max(se, 1e-12)


@pytest.mark.parametrize("dof", [False, True], ids=["pinhole", "dof"])
@pytest.mark.parametrize("use_nee", [False, True], ids=["brute", "nee"])
@pytest.mark.parametrize("name", ["cornell", "small", "single-sphere"])
def test_kernel_matches_xla(name, use_nee, dof):
    """Image mean of the kernel == the wavefront integrator's, |z| <= 5
    over 8 independent replicates on each side (32 and 16 spp)."""
    scene, cs = sc.BUILTIN_SCENES[name]()
    camera = _camera(cs, dof=dof)
    k = _kernel_means(scene, camera, use_nee, reps=8)
    x = _xla_means(scene, camera, use_nee, reps=8)
    assert np.isfinite(k).all() and np.isfinite(x).all()
    z = _z(k, x)
    assert abs(z) <= 5.0, (k.mean(), x.mean(), z)


def test_nee_point_light_matches_xla():
    """The delta-light NEE branch (rsqrt direction and falloff)."""
    scene = sc.make_scene(
        [sc.sphere([0, -1e4 - 1, 0], 1e4, 0)],
        [sc.diffuse([0.7, 0.7, 0.7])],
        [sc.point_light([0, 3, 0], [40.0, 40.0, 40.0])],
    )
    camera = cm.make_camera([0, 2, 8], [0, 0, 0], [0, 1, 0], W, H, 60.0)
    k = _kernel_means(scene, camera, True, reps=6)
    x = _xla_means(scene, camera, True, reps=6)
    assert k.mean() > 0.05
    assert abs(_z(k, x)) <= 5.0, (k.mean(), x.mean())


def test_many_prims_sphere_field():
    """The unrolled sphere loops scale past the 9-sphere reference scenes."""
    scene, cs = sc.sphere_field(32)
    camera = _camera(cs, 8, 6)
    k = _kernel_means(scene, camera, False, reps=4)
    x = _xla_means(scene, camera, False, reps=4)
    assert np.isfinite(k).all() and k.mean() > 0
    assert abs(_z(k, x)) <= 5.0, (k.mean(), x.mean())


@pytest.fixture(scope="module")
def cornell():
    scene, cs = sc.cornell_spheres()
    return scene, _camera(cs)


def test_sample_count_guarantee(cornell):
    """budget >= spp * (max_bounces + 1) completes >= spp samples per
    pixel, and every lane traces a live segment every iteration."""
    scene, camera = cornell
    st = init_state(W, H)
    st, nrays = persistent_step(
        scene, camera, jnp.array([1, 2], jnp.int32), st,
        budget=2 * (MB + 1), max_bounces=MB, interpret=True)
    assert int(state_min_samples(st, W, H)) >= 2
    assert int(nrays) == W * H * 2 * (MB + 1)


def test_emitter_only_completes_one_sample_per_iteration(cornell):
    """max_bounces=0: every path ends after its primary segment, so each
    pixel completes exactly `budget` samples per launch."""
    scene, camera = cornell
    st = init_state(W, H)
    st, _ = persistent_step(scene, camera, jnp.array([4, 0], jnp.int32),
                            st, budget=5, max_bounces=0, interpret=True)
    np.testing.assert_array_equal(np.asarray(st.n_samp[:W * H]), 5)


def test_padding_lanes_inert(cornell):
    scene, camera = cornell
    st = init_state(W, H)
    assert st.lr.shape[0] == padded_lanes(W, H) > W * H
    st, _ = persistent_step(scene, camera, jnp.array([1, 2], jnp.int32), st,
                            budget=4, max_bounces=MB, interpret=True)
    assert (np.asarray(st.n_samp)[W * H:] == 0).all()
    assert (np.asarray(st.lr)[W * H:] == 0).all()
    assert (np.asarray(st.alive)[W * H:] == 0).all()


def test_state_carries_across_launches(cornell):
    """The second launch continues the first: the frame index advances
    (new random streams), sample counts only grow."""
    scene, camera = cornell
    st = init_state(W, H)
    st1, _ = persistent_step(scene, camera, jnp.array([2, 0], jnp.int32),
                             st, budget=6, max_bounces=MB, interpret=True)
    n1 = np.asarray(st1.n_samp).copy()
    st2, _ = persistent_step(scene, camera, jnp.array([2, 0], jnp.int32),
                             st1, budget=6, max_bounces=MB, interpret=True)
    assert int(st2.frame) == 2
    assert (np.asarray(st2.n_samp) >= n1).all()
    assert np.asarray(st2.n_samp).sum() > n1.sum()


def test_mesh_scene_rejected():
    scene, cs = sc.cornell_boxes()
    camera = _camera(cs, 8, 8)
    with pytest.raises(ValueError, match="sphere scenes only"):
        persistent_step(scene, camera, jnp.array([0, 0], jnp.int32),
                        init_state(8, 8), budget=1, interpret=True)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_sharded_bit_identical(cornell, shape):
    """Kernel under shard_map == one device, bit for bit: lanes and random
    streams are addressed by GLOBAL lane id."""
    scene, camera = cornell
    seed = jnp.array([5, 11], jnp.int32)
    kw = dict(budget=4, max_bounces=MB, block=8, interpret=True)
    st_ref = init_state(W, H, block=8, blocks_multiple=8)
    st_ref, nr_ref = persistent_step(scene, camera, seed, st_ref, **kw)

    mesh = make_mesh(jax.devices(), n_tile=shape[0], n_sample=shape[1])
    st_sh = init_state_sharded(W, H, mesh, block=8)
    st_sh, nr_sh = persistent_step_sharded(scene, camera, seed, st_sh, mesh,
                                           **kw)
    assert int(nr_ref) == int(nr_sh)
    for f in ("lr", "lg", "lb", "n_samp", "tr", "bounce", "alive"):
        np.testing.assert_array_equal(np.asarray(getattr(st_ref, f)),
                                      np.asarray(getattr(st_sh, f)),
                                      err_msg=f"{shape} {f}")


def test_sharded_init_compiles_once():
    """A restart (fresh sharded state) reuses the compiled initializer:
    the state is all-dead, lane-sharded, and built by one program."""
    mesh = make_mesh(jax.devices(), n_tile=4, n_sample=2)
    a = init_state_sharded(W, H, mesh, block=8)
    b = init_state_sharded(W, H, mesh, block=8)
    assert persistent_sharded._init_program.cache_info().currsize >= 1
    assert persistent_sharded._init_program(W, H, mesh, 8)._cache_size() == 1
    assert a.lr.sharding.spec == b.lr.sharding.spec
    assert len(a.lr.sharding.device_set) == 8
    assert not np.asarray(b.alive).any() and int(b.frame) == 0


def test_sharded_step_has_no_nonscalar_collectives(cornell):
    """The only collective of the sharded step is the scalar live-ray
    psum: per-shard work is independent (global-lane addressing)."""
    scene, camera = cornell
    mesh = make_mesh(jax.devices(), n_tile=4, n_sample=2)
    st = init_state_sharded(W, H, mesh, block=8)
    step = partial(persistent_step_sharded, mesh=mesh, budget=2,
                   max_bounces=MB, block=8, interpret=True)
    hlo = jax.jit(step).lower(scene, camera, jnp.array([5, 11], jnp.int32),
                              st).compile().as_text()
    for line in hlo.splitlines():
        if re.search(r"\b(all-gather|collective-permute|all-to-all"
                     r"|reduce-scatter|collective-broadcast)\b", line):
            raise AssertionError(f"unexpected collective: {line.strip()}")
        if "all-reduce" in line and "=" in line:
            shape = line.split("=", 1)[1].strip().split(" ")[0]
            assert re.match(r"^[a-z0-9]+\[\]", shape), line.strip()


def test_persistent_renderer_checkpoint_resume(tmp_path, cornell):
    """PersistentRenderer + .npz snapshot: resuming reproduces the
    uninterrupted render bit for bit."""
    scene, camera = cornell
    cfg = RenderConfig(spp=1, max_bounces=MB)
    r = PersistentRenderer(scene, camera, cfg, seed=3, budget=6,
                           interpret=True)
    r.step()
    ckpt.save_state(str(tmp_path / "ck"), int(r.state.frame), r.state)
    r.step()
    img_full = np.asarray(r.image())
    assert r.min_samples >= 1

    r2 = PersistentRenderer(scene, camera, cfg, seed=3, budget=6,
                            interpret=True)
    r2.state = ckpt.restore_state(str(tmp_path / "ck"), r2.state)
    r2.step()
    np.testing.assert_array_equal(img_full, np.asarray(r2.image()))


def test_persistent_renderer_reset_draws_fresh_streams(cornell):
    """A camera update restarts accumulation with a new salt: the same
    camera then renders different (fresh) paths."""
    scene, camera = cornell
    r = PersistentRenderer(scene, camera, RenderConfig(spp=1, max_bounces=MB),
                           budget=4, interpret=True)
    r.step()
    before = np.asarray(r.image())
    r.update_camera(camera)
    assert r.min_samples == 0 and r.iteration == 0
    r.step()
    after = np.asarray(r.image())
    assert not np.array_equal(before, after)


def test_render_to_reaches_target(cornell):
    scene, camera = cornell
    r = PersistentRenderer(scene, camera, RenderConfig(spp=2, max_bounces=MB),
                           budget=8, interpret=True)
    rays = r.render_to(3)
    assert r.min_samples >= 3 and r.iteration >= 1 and rays > 0


@pytest.mark.parametrize("name", ["cornell", "small", "single-sphere"])
def test_pack_lights_matches_light_selection(name):
    """The kernel's light table carries ops/lights' power-proportional
    selection probabilities."""
    scene, _ = sc.BUILTIN_SCENES[name]()
    tab = np.asarray(pack_lights(scene))
    _, sel = lights.light_selection_dist(scene)
    n = scene.num_lights
    np.testing.assert_allclose(tab[:, 7], np.asarray(sel)[:n], rtol=1e-6)
    np.testing.assert_allclose(tab[:, 6], np.concatenate(
        [[0.0], np.cumsum(tab[:, 7])[:-1]]), atol=1e-6)


def test_pack_prims_matches_prim_attrs():
    scene, _ = sc.cornell_spheres()
    tab = np.asarray(pack_prims(scene))
    assert tab.shape == (scene.num_prims, 13)
    np.testing.assert_allclose(tab[:, :3], np.asarray(scene.centers)[:9])
    np.testing.assert_allclose(tab[8, 9:12], [12.0, 12.0, 12.0])
    assert (tab[:8, 9:12] == 0).all()
    np.testing.assert_allclose(tab[:, 12], (tab[:, :3] ** 2).sum(-1),
                               rtol=1e-6)


@pytest.mark.parametrize("spp,k", [(1, 1), (2, 1), (4, 2), (9, 3)])
def test_strat_k_for(spp, k):
    """The kernel stratifies like the XLA path: a k x k grid for square
    spp, plain jitter otherwise."""
    assert strat_k_for(spp) == k


def test_block_must_divide_state():
    scene, cs = sc.cornell_spheres()
    camera = _camera(cs, 8, 8)
    with pytest.raises(ValueError, match="whole blocks"):
        persistent_step(scene, camera, jnp.array([0, 0], jnp.int32),
                        init_state(8, 8, block=BLOCK), budget=1, block=256,
                        interpret=True)


def test_limit_gives_exactly_that_many_samples(cornell):
    """With a limit, every pixel completes exactly `limit` samples and the
    lanes then idle: the image is the plain mean of that many samples."""
    scene, camera = cornell
    r = PersistentRenderer(scene, camera, RenderConfig(spp=4, max_bounces=MB),
                           budget=16, interpret=True)
    r.render_to(4)
    n = np.asarray(r.state.n_samp[:W * H])
    np.testing.assert_array_equal(n, 4)
    assert not np.asarray(r.state.alive).any()
    # a further limited step is a no-op: nothing left to start
    before = np.asarray(r.image())
    assert int(r.step(limit=4)) == 0
    np.testing.assert_array_equal(before, np.asarray(r.image()))


@pytest.mark.parametrize("use_nee,dof", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_kernel_lowers_for_cuda(use_nee, dof):
    """The Triton lowering runs in Python: every primitive the kernel uses
    must have a Triton rule. Lowering for CUDA here catches that without
    a card (compiling the Triton IR needs one)."""
    scene, cs = sc.cornell_spheres()
    camera = _camera(cs, 64, 48, dof=dof)
    st = init_state(64, 48)
    step = partial(persistent_step, budget=4, use_nee=use_nee)
    text = jax.jit(step).trace(
        scene, camera, jnp.array([1, 2], jnp.int32), st,
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "persistent_path_regeneration" in text
