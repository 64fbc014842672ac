"""Multi-process distributed test (SURVEY.md §4): two REAL processes over
jax.distributed on CPU, sharded render compared against the single-process
render. Exercises multi-host process coordination without a cluster.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

coord, pid = sys.argv[1], int(sys.argv[2])
from pathtracer.parallel import multihost
multihost.initialize(coord, 2, pid)
assert jax.process_count() == 2
assert len(jax.devices()) == 8  # 2 procs x 4 local cpu devices

import numpy as np
from jax.experimental import multihost_utils
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render_image
from pathtracer.parallel.mesh import make_mesh
from pathtracer.parallel.sharding import render_sharded_jit

scene, cs = sc.single_sphere()
camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 16, 16, cs["fov"])
cfg = RenderConfig(spp=4, max_bounces=3)
key = jax.random.key(11)

mesh = make_mesh(jax.devices(), n_tile=4, n_sample=2)
img = render_sharded_jit(scene, camera, key, cfg, mesh)
full = multihost_utils.process_allgather(img, tiled=True)

# single-process oracle computed locally on each process
want = np.array(render_image(scene, camera, key, cfg))
got = np.asarray(full).reshape(want.shape)
assert np.array_equal(got, want), (np.abs(got - want).max(),)
if pid == 0:
    print("MULTIHOST_OK", flush=True)
"""


KERNEL_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

coord, pid = sys.argv[1], int(sys.argv[2])
from pathtracer.parallel import multihost
multihost.initialize(coord, 2, pid)
assert jax.process_count() == 2
assert len(jax.devices()) == 8

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils
from pathtracer.diff import inverse
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig
from pathtracer.ops.pallas.persistent import init_state, persistent_step
from pathtracer.parallel.mesh import make_mesh
from pathtracer.parallel.persistent_sharded import (
    init_state_sharded, persistent_step_sharded,
)

W, H, BLOCK = 16, 12, 8
MB, SPP, BUDGET = 3, 2, 4
scene, cs = sc.cornell_spheres()
camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], W, H, cs["fov"])
seed = jnp.array([5, 11], jnp.int32)
# ONE device from each process: the smallest mesh that still crosses a
# real process boundary
devs = sorted(jax.devices(), key=lambda d: d.process_index)
sub = [next(d for d in devs if d.process_index == p) for p in (0, 1)]
mesh = make_mesh(sub, n_tile=2, n_sample=1)

# --- the persistent-kernel step across 2 real processes (interpreted)
kw = dict(budget=BUDGET, max_bounces=MB, block=BLOCK, interpret=True)
st = init_state_sharded(W, H, mesh, block=BLOCK)
st, nr = persistent_step_sharded(scene, camera, seed, st, mesh, **kw)
# single-process oracle computed locally on each process
st_ref = init_state(W, H, block=BLOCK, blocks_multiple=2)
st_ref, nr_ref = persistent_step(scene, camera, seed, st_ref, **kw)
assert int(nr) == int(nr_ref), (int(nr), int(nr_ref))
for f in ("lr", "lg", "lb", "n_samp", "alive"):
    got = np.asarray(
        multihost_utils.process_allgather(getattr(st, f), tiled=True)
    )
    want = np.asarray(getattr(st_ref, f))
    assert np.array_equal(got, want), (f, np.abs(got - want).max())

# --- the sharded loss + gradients across 2 real processes
cfg = RenderConfig(spp=SPP, max_bounces=MB)
key = jax.random.key(3)
rng = np.random.default_rng(9)
target = jnp.asarray(rng.random((H * W, 3), np.float32))
params = inverse.params_of(scene)
vg = jax.value_and_grad(inverse.sharded_loss)
loss_s, grads_s = vg(params, scene, camera, target, key, cfg, mesh, 0)
loss_1, grads_1 = vg(params, scene, camera, target, key, cfg,
                     make_mesh([jax.local_devices()[0]]), 0)
# psum'd outputs are replicated => fully addressable on every process
np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-6)
assert np.abs(np.asarray(grads_1["mat_color"])).max() > 0
for k in grads_1:
    np.testing.assert_allclose(
        np.asarray(grads_s[k]), np.asarray(grads_1[k]),
        rtol=1e-5, atol=1e-8, err_msg=k,
    )
if pid == 0:
    print("MULTIHOST_KERNEL_OK", flush=True)
"""


def _run_two_workers(tmp_path, worker_src, ok_token, timeout=420):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))

    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost workers timed out")
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-2000:]
    assert ok_token in outs[0][1]


def test_two_process_sharded_render_matches(tmp_path):
    _run_two_workers(tmp_path, WORKER, "MULTIHOST_OK", timeout=240)


def test_two_process_production_kernels_match(tmp_path):
    """The sharded persistent path-regeneration step and the sharded loss +
    gradients across 2 real processes (4 cpu devices each): bit-identical
    state / equal loss and gradients vs the single-process run."""
    _run_two_workers(tmp_path, KERNEL_WORKER, "MULTIHOST_KERNEL_OK")
