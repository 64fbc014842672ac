"""Inverse rendering: recover scene parameters by pixel-gradient descent.

BASELINE.json config 5: optimize Cornell-box albedo + light intensity to
match a target image, sharded over a device mesh. The reference has no
differentiability at all — this subsystem is the capability this renderer
adds on top of forward parity (north star: "differentiable end-to-end,
detached-sampling / path-replay backprop").

Design:
  - Optimizable parameters are the scene's normalized tables
    (mat_color, light_intensity) — gradients flow through the in-jit
    denormalization (scene.prim_attrs) and the integrator's throughput
    products into the tables.
  - The loss is computed under shard_map over the (tile, sample) mesh:
    each shard renders its pixel/sample block, pmean over the sample axis
    forms the per-pixel estimate, a psum over the mesh forms the scalar
    loss — so jax.grad of the whole thing yields gradients whose
    all-reduce rides the same collectives (XLA inserts the transposed
    psum for the replicated params).
  - Sampling decisions are detached (RenderConfig.detach_sampling), the
    detached-sampling estimator validated against finite differences in
    tests/test_gradients.py.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax import Array
from jax.sharding import PartitionSpec as P
from jax import shard_map

from pathtracer.utils.pytree import pytree_dataclass
from pathtracer.models.camera import Camera
from pathtracer.models.integrator import RenderConfig, render, trace_pixels
from pathtracer.models.scene import Scene
from pathtracer.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from pathtracer.parallel.sharding import _lane_matrix
from pathtracer.utils import rng


@pytree_dataclass
class TrainState:
    params: dict  # {"mat_color": (M,3), "light_intensity": (L,3)}
    opt_state: Any
    step: Array


def params_of(scene: Scene, *, ior: bool = False) -> dict:
    """ior=True adds mat_coef (index of refraction) to the optimizable
    set (its gradient estimator is diff/score.py)."""
    p = {
        "mat_color": scene.mat_color,
        "light_intensity": scene.light_intensity,
    }
    if scene.textures is not None:
        p["textures"] = scene.textures
    if ior:
        p["mat_coef"] = scene.mat_coef
    return p


def apply_params(scene: Scene, params: dict) -> Scene:
    """Clamp-free param injection; callers clamp post-update if desired."""
    scene = dataclasses.replace(
        scene, mat_color=params["mat_color"],
        light_intensity=params["light_intensity"],
    )
    if "textures" in params:
        scene = dataclasses.replace(scene, textures=params["textures"])
    if "mat_coef" in params:
        scene = dataclasses.replace(scene, mat_coef=params["mat_coef"])
    return scene


def _clamp_params(params: dict) -> dict:
    """Physical clamps: albedo/texels in [0,1], intensity >= 0, ior >= 1."""
    out = {
        "mat_color": jnp.clip(params["mat_color"], 0.0, 1.0),
        "light_intensity": jnp.maximum(params["light_intensity"], 0.0),
    }
    if "textures" in params:
        out["textures"] = jnp.clip(params["textures"], 0.0, 1.0)
    if "mat_coef" in params:
        out["mat_coef"] = jnp.maximum(params["mat_coef"], 1.0)
    return out


def make_optimizer(lr: float = 2e-2) -> optax.GradientTransformation:
    return optax.adam(lr)


def init_state(scene: Scene, optimizer: optax.GradientTransformation,
               init_params: dict | None = None) -> TrainState:
    params = init_params if init_params is not None else params_of(scene)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=jnp.zeros((), jnp.int32),
    )


def sharded_loss(
    params: dict,
    scene: Scene,
    camera: Camera,
    target: Array,  # (H*W, 3) flattened target image
    key: Array,
    config: RenderConfig,
    mesh: jax.sharding.Mesh,
    iteration: Array | int,
) -> Array:
    """Mean-squared pixel loss, computed fully on-mesh. Returns scalar."""
    spp = config.spp
    it_key = rng.iteration_key(key, iteration)
    lanes = _lane_matrix(camera, spp)
    n_pix = camera.height * camera.width

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(TILE_AXIS, SAMPLE_AXIS), P(TILE_AXIS)),
        out_specs=P(),
    )
    def block_loss(params_rep, scene_rep, camera_rep, lane_block, target_block):
        scene_p = apply_params(scene_rep, params_rep)
        rad = trace_pixels(
            scene_p, camera_rep, lane_block.reshape(-1), it_key, config
        ).reshape(lane_block.shape + (3,))
        est = jax.lax.pmean(rad.mean(axis=1), SAMPLE_AXIS)  # (pix_local, 3)
        partial_sse = jnp.sum((est - target_block) ** 2)
        # Sample-axis shards all hold the same partial after pmean; psum over
        # tile only, then normalize to the global mean.
        return jax.lax.psum(partial_sse, TILE_AXIS) / (n_pix * 3)

    return block_loss(params, scene, camera, lanes, target)


def make_train_step(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    mesh: jax.sharding.Mesh,
    optimizer: optax.GradientTransformation,
    fixed_iteration: int | None = None,
):
    """Build the jitted sharded training step (loss + grad + adam update).

    Gradient all-reduce across the mesh is XLA-inserted as the transpose of
    the replicated-parameter broadcast into shard_map — one all-reduce of
    the (small) parameter tables per step (SURVEY.md §5 plan).

    fixed_iteration: if set, every step reuses the SAME RNG streams (pass
    the iteration the target was rendered with). With a target rendered at
    identical seeds this makes the loss exactly zero at the true parameters
    ("same-seed" inverse rendering), removing the Cov(estimate, gradient)
    bias that plain stochastic MSE has under heavy MC noise. If None, each
    step draws fresh paths (iteration = optimizer step).
    """

    @jax.jit
    def train_step(state: TrainState, target: Array, key: Array) -> tuple[TrainState, Array]:
        it = state.step if fixed_iteration is None else fixed_iteration

        def loss_fn(params):
            return sharded_loss(
                params, scene, camera, target, key, config, mesh, it
            )

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = _clamp_params(optax.apply_updates(state.params, updates))
        return (
            TrainState(params=params, opt_state=opt_state, step=state.step + 1),
            loss,
        )

    return train_step


def render_target(
    scene: Scene, camera: Camera, key: Array, config: RenderConfig,
    n_iterations: int = 4, base_iteration: int = 1000,
) -> Array:
    """Render a (H*W, 3) reference target by averaging a few iterations.

    For same-seed inverse rendering pass n_iterations=1 and
    base_iteration == the fixed_iteration given to make_train_step.
    """
    acc = jnp.zeros((camera.height * camera.width, 3))
    for it in range(n_iterations):
        img = render(scene, camera, key, config, iteration=base_iteration + it)
        acc = acc + img.reshape(-1, 3)
    return acc / n_iterations
