"""Benchmark: the reference workload on one NVIDIA GPU, both render paths.

Workload: the reference renderer's per-frame budget — the Cornell-spheres
scene (9 spheres, 6 materials, 1 area light, reference main.cpp:152-164)
at 640x480, 4 spp, max 10 bounces, Russian roulette after bounce 3 —
brute-force emitter hits and NEE + MIS.

Both render paths a user reaches through `cli render` are timed on equal
completed samples (64 per pixel = 16 reference frames of 4 spp):

  - "kernel": the persistent path-regeneration kernel
    (models/progressive.PersistentRenderer, Pallas on the Triton route),
    stepped until every pixel has completed 64 samples;
  - "xla": the wavefront integrator (models/progressive.ProgressiveRenderer),
    16 iterations of 4 spp.

Each is warmed up first (compilation is set-up time), then timed
`REPEATS` times on the host clock around work that ends in
`block_until_ready`; the median is reported. Metrics: ms per 4-spp frame,
and live ray segments per second (path segments plus needed NEE shadow
segments, as each path counts them).

Prints exactly one JSON line naming the device. Needs a GPU: on any other
platform it exits non-zero without a result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import jax

WIDTH, HEIGHT, SPP, MAX_BOUNCES, FRAMES = 640, 480, 4, 10, 16
REPEATS = 5


def card_line() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> None:
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {jax.devices()[0].platform!r}")


def _reference_setup(use_nee: bool):
    from pathtracer.models import camera as cm, scene as sc
    from pathtracer.models.integrator import RenderConfig

    scene, cs = sc.cornell_spheres()
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], WIDTH,
                            HEIGHT, cs["fov"])
    return scene, camera, RenderConfig(spp=SPP, max_bounces=MAX_BOUNCES,
                                       use_nee=use_nee)


def _median_seconds(run) -> float:
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def time_kernel(use_nee: bool) -> dict:
    from pathtracer.models.progressive import PersistentRenderer

    scene, camera, config = _reference_setup(use_nee)
    r = PersistentRenderer(scene, camera, config, seed=1)
    r.render_to(1)  # compile the step and the sample-count readout
    segs = []

    def run():
        r.reset()
        segs.append(r.render_to(SPP * FRAMES))
        jax.block_until_ready(r.state)

    sec = _median_seconds(run)
    return {"ms_per_frame": sec * 1e3 / FRAMES,
            "segments_per_s": statistics.median(segs) / sec,
            "image_mean": float(r.image().mean())}


def time_xla(use_nee: bool) -> dict:
    import dataclasses

    from pathtracer.models.integrator import render_image
    from pathtracer.models.progressive import ProgressiveRenderer

    scene, camera, config = _reference_setup(use_nee)
    r = ProgressiveRenderer(scene, camera, config, seed=1)
    r.step()
    jax.block_until_ready(r.state)

    def run():
        r.reset()
        for _ in range(FRAMES):
            r.step()
        jax.block_until_ready(r.state)

    sec = _median_seconds(run)
    # the integrator's own live-segment counter, one frame
    counted = dataclasses.replace(config, count_rays=True)
    _, n = render_image(scene, camera, jax.random.key(1), counted)
    return {"ms_per_frame": sec * 1e3 / FRAMES,
            "segments_per_s": int(n) * FRAMES / sec,
            "image_mean": float(r.image().mean())}


def measure() -> dict:
    out = {}
    for mode, nee in (("brute", False), ("nee", True)):
        out[f"kernel_{mode}"] = time_kernel(nee)
        out[f"xla_{mode}"] = time_xla(nee)
    return out


def main() -> None:
    require_gpu()
    from pathtracer.utils.cache import enable_compile_cache

    enable_compile_cache()
    cells = measure()
    print(json.dumps({
        "workload": f"cornell {WIDTH}x{HEIGHT} {SPP}spp {MAX_BOUNCES} "
                    f"bounces, {FRAMES} frames",
        "card": card_line(),
        "device": device_info(),
        "cells": cells,
    }))


if __name__ == "__main__":
    main()
