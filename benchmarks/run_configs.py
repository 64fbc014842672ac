"""Run every BASELINE.json render config at its specified scale on the GPU:
one full render each, time-to-image and live segments/s, the image
written to --out.

  1. single diffuse sphere + area light   128x128 x 16 spp,  2 bounces
  2. cornell_boxes (walls + 2 boxes)      256x256 x 64 spp,  4 bounces
  3. cornell_glass (mirror + dielectric)  512x512 x 256 spp, 8 bounces
  4. terrain_textured (~100k tris, BVH)   1024x1024 x 512 spp, 3 bounces

Every config renders through the path models/progressive.choose_backend
picks for it (all four hold meshes or are tiny, so the wavefront
integrator). Config 5 (sharded inverse rendering) is chip_smoke.py's
trainer phase. Compilation is warmed up outside the clock.

Usage: python -m benchmarks.run_configs [--only N] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from bench import card_line, require_gpu
from pathtracer.io.image import save_png
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render
from pathtracer.utils.cache import enable_compile_cache

CONFIGS = {
    1: ("config1", sc.single_sphere, 128, 128, 16, 16, 2),
    2: ("config2", sc.cornell_boxes, 256, 256, 64, 16, 4),
    3: ("config3", sc.cornell_glass, 512, 512, 256, 16, 8),
    4: ("config4", sc.terrain_textured, 1024, 1024, 512, 2, 3),
}


def run(name, fixture, w, h, spp_total, spp_frame, bounces, out):
    scene, cs = fixture()
    cam = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    cfg = RenderConfig(spp=spp_frame, max_bounces=bounces, use_nee=True,
                       count_rays=True)
    fn = jax.jit(lambda key, it: render(scene, cam, key, cfg, iteration=it))
    jax.block_until_ready(fn(jax.random.key(0), 10_000))  # compile
    frames = spp_total // spp_frame
    t0 = time.perf_counter()
    acc = jnp.zeros((h, w, 3))
    rays = jnp.int32(0)
    for i in range(frames):
        img, n = fn(jax.random.key(1), i)
        acc = acc + img
        rays = rays + n
    acc = jax.block_until_ready(acc / frames)
    el = time.perf_counter() - t0
    save_png(os.path.join(out, f"{name}_spec.png"), np.asarray(acc))
    print(f"{name} {w}x{h}x{spp_total}spp b{bounces} nee: {el:.2f} s, "
          f"{el / frames * 1e3:.2f} ms/frame of {spp_frame} spp, "
          f"{int(rays) / el / 1e9:.3f} Gseg/s, mean {float(acc.mean()):.4f}",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, default=0)
    ap.add_argument("--out", default="out/configs")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    print(f"card: {card_line()}; devices: {jax.devices()}", flush=True)
    for n, spec in CONFIGS.items():
        if args.only in (0, n):
            run(*spec, args.out)


if __name__ == "__main__":
    main()
