"""The one place that picks the device path (models/progressive), and the
compile-cache placement (utils/cache)."""
import os

import jax
import pytest

from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig
from pathtracer.models.progressive import (
    PersistentRenderer, ProgressiveRenderer, choose_backend, make_renderer,
)
from pathtracer.utils import cache


@pytest.mark.parametrize("platform,scene_name,want", [
    ("cpu", "cornell", "xla"),
    ("cpu", "cornell-boxes", "xla"),
    ("gpu", "cornell", "pallas"),
    ("gpu", "small", "pallas"),
    ("gpu", "cornell-boxes", "xla"),
    ("gpu", "terrain", "xla"),
])
def test_choose_backend(platform, scene_name, want):
    if scene_name == "terrain":
        scene, _ = sc.terrain_textured(n=8)
    else:
        scene, _ = sc.BUILTIN_SCENES[scene_name]()
    assert choose_backend(scene, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_choose_backend_rejects_other_platforms(platform):
    scene, _ = sc.cornell_spheres()
    with pytest.raises(ValueError, match="no render path"):
        choose_backend(scene, platform)


def test_choose_backend_defaults_to_the_running_platform():
    scene, _ = sc.cornell_spheres()
    assert jax.devices()[0].platform == "cpu"
    assert choose_backend(scene) == "xla"


def test_make_renderer_follows_the_choice():
    scene, cs = sc.cornell_spheres()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], 8, 8, cs["fov"])
    cfg = RenderConfig(spp=1, max_bounces=1)
    assert isinstance(make_renderer(scene, cam, cfg), ProgressiveRenderer)
    assert isinstance(make_renderer(scene, cam, cfg, platform="gpu"),
                      PersistentRenderer)


def test_compile_cache_dir_unset_uses_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compile_cache_dir()
    assert path == os.path.join(cache.CHECKOUT_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(cache.CHECKOUT_ROOT, "pyproject.toml"))


def test_compile_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() is None


def test_enable_compile_cache_leaves_cpu_alone(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
