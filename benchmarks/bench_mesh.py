"""Config-4 frame benchmark on the GPU: the 100k-tri textured terrain.

Workload (BASELINE config 4): terrain_textured scene, 256x192, 2 spp,
3 bounces, NEE on, through the wavefront integrator and the XLA BVH
traversal (ops/triangle.py). Each frame is timed on the host clock
around work that ends in block_until_ready; the median over --iters
frames is reported, with the integrator's live-segment count.

Usage: python -m benchmarks.bench_mesh [--size 256x192] [--spp 2]
       [--bounces 3] [--iters 8] [--no-nee]
"""
from __future__ import annotations

import argparse
import statistics
import time

import jax

from bench import card_line, require_gpu
from pathtracer.models import camera as cm, scene as sc
from pathtracer.models.integrator import RenderConfig, render
from pathtracer.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x192")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--no-nee", action="store_true")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    w, h = (int(x) for x in args.size.lower().split("x"))
    print(f"card: {card_line()}; devices: {jax.devices()}", flush=True)

    scene, cs = sc.terrain_textured()
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h,
                            cs["fov"])
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=not args.no_nee, count_rays=True)
    key = jax.random.key(0)
    frame = jax.jit(lambda it: render(scene, camera, key, config,
                                      iteration=it))
    jax.block_until_ready(frame(0))  # compile
    times, segs = [], 0
    for i in range(1, args.iters + 1):
        t0 = time.perf_counter()
        _, n = jax.block_until_ready(frame(i))
        times.append(time.perf_counter() - t0)
        segs = int(n)
    ms = statistics.median(times) * 1e3
    print(f"mesh frame {w}x{h}x{args.spp}spp b{args.bounces} "
          f"nee={not args.no_nee}: {ms:.2f} ms/frame ({segs} segs, "
          f"{segs / ms / 1e6:.3f} Gseg/s)", flush=True)


if __name__ == "__main__":
    main()
