"""Progressive (interactive-style) rendering: accumulate, reset on change.

The equivalent of the reference's frame loop state: the running-mean
framebuffer update `buf = (buf*(n-1) + c)/n` (reference pathtracer.cu:104-109),
the iteration counter (pathtracer.h:58), and reset-on-camera-change
(main.cpp:209 -> pathtracer.cu:245-247).

The accumulator state is a pytree (sum image + iteration count), so it can
be checkpointed to disk for preemption-safe long renders (SURVEY.md §5
"Checkpoint / resume") — the reference kept this state only in GPU memory.
We store the SUM rather than the running mean: mathematically equivalent
read-side (mean = sum/n), but the sum form is exact in accumulation and
maps onto psum-reductions when sample-sharded across devices.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from pathtracer.utils.pytree import pytree_dataclass
from pathtracer.models.camera import Camera
from pathtracer.models.integrator import RenderConfig, render
from pathtracer.models.scene import Scene
from pathtracer.ops.pallas import persistent as kernel


@pytree_dataclass
class AccumulatorState:
    """Persistent progressive-render state (pathtracer.h:52-58 analogue)."""

    radiance_sum: Array  # (H, W, 3) sum of per-iteration mean radiance
    iteration: Array  # () int32 — number of accumulated iterations


def init_state(height: int, width: int) -> AccumulatorState:
    return AccumulatorState(
        radiance_sum=jnp.zeros((height, width, 3), jnp.float32),
        iteration=jnp.zeros((), jnp.int32),
    )


def reset(state: AccumulatorState) -> AccumulatorState:
    """Restart accumulation (reference Pathtracer::Reset, pathtracer.cu:245)."""
    return AccumulatorState(
        radiance_sum=jnp.zeros_like(state.radiance_sum),
        iteration=jnp.zeros_like(state.iteration),
    )


@partial(jax.jit, static_argnames=("config",))
def step(
    state: AccumulatorState,
    scene: Scene,
    camera: Camera,
    key: Array,
    config: RenderConfig,
) -> AccumulatorState:
    """One progressive iteration (reference Pathtracer::Run, pathtracer.cu:222).

    The per-iteration RNG stream is keyed on the iteration counter, matching
    the reference's regenerate-every-frame cuRAND discipline
    (pathtracer.cu:224) but reproducibly.
    """
    it = state.iteration
    frame = render(scene, camera, key, config, iteration=it)
    return AccumulatorState(
        radiance_sum=state.radiance_sum + frame,
        iteration=it + 1,
    )


def image(state: AccumulatorState) -> Array:
    """Current progressive estimate = running mean of accumulated frames."""
    n = jnp.maximum(state.iteration, 1).astype(jnp.float32)
    return state.radiance_sum / n


def choose_backend(scene: Scene, platform: str | None = None) -> str:
    """The one place that picks the device path for a render.

    "xla" (the wavefront integrator) on the CPU and for mesh scenes;
    "pallas" (the persistent path-regeneration kernel) for sphere scenes
    on the GPU. Any other platform is an error: nothing here falls back
    to another device or to interpret mode.
    """
    platform = platform or jax.devices()[0].platform
    if platform == "cpu":
        return "xla"
    if platform == "gpu":
        return "xla" if scene.mesh is not None else "pallas"
    raise ValueError(f"no render path for platform {platform!r}")


def make_renderer(scene: Scene, camera: Camera, config: RenderConfig,
                  seed: int = 0, platform: str | None = None):
    """A progressive renderer on the path `choose_backend` picks for
    `platform` (default: the running one)."""
    if choose_backend(scene, platform) == "pallas":
        return PersistentRenderer(scene, camera, config, seed=seed)
    return ProgressiveRenderer(scene, camera, config, seed=seed)


class PersistentRenderer:
    """Progressive renderer over the persistent path-regeneration kernel
    (ops/pallas/persistent.py), with the same host-side surface as
    ProgressiveRenderer (step / image / iteration / update_camera-resets,
    reference main.cpp Display/Idle semantics).

    The kernel's PathState IS the progressive accumulator (per-pixel
    radiance sums + completed-sample counts carried in device memory
    across steps), so accumulation never leaves the device and
    checkpoints are the plain pytree snapshot (utils/checkpoint).

    ``iteration`` reports min-completed-samples // spp: the count of
    reference-equivalent frames (pathtracer.h:58) every pixel has finished.
    """

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 seed: int = 0, *, budget: int = 512,
                 interpret: bool = False):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.seed = seed
        self.budget = budget
        self.interpret = interpret
        self._salt = 0
        self.state = kernel.init_state(camera.width, camera.height)

    def step(self, limit: int | None = None):
        """Advance all lanes by up to ``budget`` wavefront iterations,
        starting no more than ``limit`` samples per pixel in total; returns
        the number of live ray segments traced (a device scalar, so a step
        does not wait for the device)."""
        self.state, nrays = kernel.persistent_step(
            self.scene, self.camera,
            jnp.asarray([self.seed, self._salt], jnp.int32), self.state,
            budget=self.budget, max_bounces=self.config.max_bounces,
            rr_start=self.config.rr_start, use_nee=self.config.use_nee,
            strat_k=kernel.strat_k_for(self.config.spp),
            limit=kernel.NO_LIMIT if limit is None else limit,
            interpret=self.interpret,
        )
        return nrays

    def render_to(self, target_spp: int, max_steps: int = 10_000) -> int:
        """Step until every pixel has completed exactly target_spp samples
        (the plain per-pixel mean of that many samples). Returns the total
        live ray segments traced."""
        total = 0
        for _ in range(max_steps):
            total = total + self.step(limit=target_spp)  # stays on device
            if self.min_samples >= target_spp:
                break
        return int(total)

    def image(self):
        return kernel.state_image(self.state, self.camera.width,
                                  self.camera.height)

    @property
    def min_samples(self) -> int:
        return int(kernel.state_min_samples(self.state, self.camera.width,
                                            self.camera.height))

    @property
    def iteration(self) -> int:
        """Completed reference-equivalent frames (min samples // spp)."""
        return self.min_samples // max(self.config.spp, 1)

    def reset(self) -> None:
        """Restart accumulation (pathtracer.cu:245 semantics). Bumps the
        RNG salt so the restart draws fresh streams rather than replaying
        the pre-reset paths."""
        self._salt += 1
        self.state = kernel.init_state(self.camera.width, self.camera.height)

    def update_camera(self, camera: Camera) -> None:
        """Camera motion restarts accumulation (main.cpp:209 semantics)."""
        self.camera = camera
        self.reset()


class ProgressiveRenderer:
    """Convenience host-side driver mirroring the reference's app loop
    (main.cpp Display/Idle): step(), image(), and camera updates that reset
    accumulation. Functional core, thin stateful shell.
    """

    def __init__(self, scene: Scene, camera: Camera, config: RenderConfig,
                 seed: int = 0):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.key = jax.random.key(seed)
        self.state = init_state(camera.height, camera.width)

    def step(self) -> None:
        self.state = step(self.state, self.scene, self.camera, self.key,
                          self.config)

    def image(self):
        return image(self.state)

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    def reset(self) -> None:
        """Restart accumulation (pathtracer.cu:245 semantics)."""
        self.state = reset(self.state)

    def update_camera(self, camera: Camera) -> None:
        """Camera motion restarts accumulation (main.cpp:209 semantics)."""
        self.camera = camera
        self.state = reset(self.state)
