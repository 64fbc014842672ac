"""pathtracer: a differentiable Monte Carlo path tracer in JAX.

Built from scratch with the capabilities of the CUDA reference renderer
mightycid/CUDA-pathtracer (see SURVEY.md): an SoA wavefront integrator in
plain XLA (the reference every kernel is checked against), a persistent
path-regeneration kernel for NVIDIA GPUs (Pallas, Triton route),
counter-based RNG instead of a cuRAND batch, and `shard_map` over device
meshes instead of single-GPU kernel launches.
"""

from pathtracer.models.camera import Camera, make_camera
from pathtracer.models.scene import BUILTIN_SCENES, Scene, make_scene
from pathtracer.models.integrator import RenderConfig, render, render_image
from pathtracer.models.progressive import ProgressiveRenderer

__version__ = "0.1.0"

__all__ = [
    "BUILTIN_SCENES",
    "Camera",
    "Scene",
    "make_camera",
    "make_scene",
    "RenderConfig",
    "render",
    "render_image",
    "ProgressiveRenderer",
]
