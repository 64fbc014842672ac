"""Command-line interface: render scenes to image files.

Replaces the reference's GLUT window + hard-coded main() (reference
main.cpp:386-408) with a batch CLI. The progressive accumulation loop is
the same Run/accumulate cycle (pathtracer.cu:222-247); output goes to
PNG/HDR files instead of a GL pixel buffer.

Examples:
  pathtracer render --scene cornell --size 640x480 --spp 4 --iterations 16 -o out.png
  pathtracer render --scene scene.json --nee -o out.png
  pathtracer bench
  pathtracer invert --steps 40 -o recovered.png

The device path is chosen in one place (models/progressive.choose_backend):
the wavefront integrator on the CPU and for mesh scenes, the persistent
path-regeneration kernel for sphere scenes on the GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str) -> tuple[int, int]:
    w, h = s.lower().split("x")
    return int(w), int(h)


def _load_scene(name: str):
    from pathtracer.io.scene_io import load_scene
    from pathtracer.models import scene as sc

    if name in sc.BUILTIN_SCENES:
        return sc.BUILTIN_SCENES[name]()
    return load_scene(name)


def cmd_render(args: argparse.Namespace) -> int:
    import numpy as np

    from pathtracer.utils.cache import enable_compile_cache

    enable_compile_cache()

    from pathtracer.io.image import save_hdr, save_png
    from pathtracer.models import camera as cm
    from pathtracer.models.integrator import RenderConfig
    from pathtracer.models.progressive import (
        PersistentRenderer, make_renderer,
    )
    from pathtracer.utils import checkpoint as ckpt
    from pathtracer.utils.metrics import RenderMeter

    w, h = _parse_size(args.size)
    scene, cs = _load_scene(args.scene)
    camera = cm.make_camera(
        cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"],
        lens_radius=cs.get("lens_radius", 0.0),
        focal_distance=cs.get("focal_distance", 0.0),
    )
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=args.nee)
    r = make_renderer(scene, camera, config, seed=args.seed)
    # The persistent kernel counts completed samples per pixel; the
    # wavefront renderer counts iterations of `spp` samples. Both stop at
    # --iterations x --spp samples per pixel.
    kernel = isinstance(r, PersistentRenderer)

    def progress() -> int:
        return r.min_samples if kernel else r.iteration

    def snapshot() -> int:
        return int(r.state.frame) if kernel else r.iteration

    target = args.spp * args.iterations if kernel else args.iterations
    if args.checkpoint_dir and ckpt.latest_step(args.checkpoint_dir) is not None:
        r.state = ckpt.restore_state(args.checkpoint_dir, r.state)
        print(f"resumed at {progress()} of {target}", file=sys.stderr)
    meter = RenderMeter(w * h * args.spp)
    steps = 0
    while progress() < target:
        t0 = time.perf_counter()
        if kernel:
            # each pixel starts exactly `target` samples: the plain mean
            nrays = int(r.step(limit=target))
        else:
            nrays = r.step()
            r.state.radiance_sum.block_until_ready()
        meter.update(time.perf_counter() - t0, nrays)
        steps += 1
        if not args.quiet:
            print(f"\r{meter.status(progress())}", end="", file=sys.stderr)
        if args.checkpoint_dir and steps % args.checkpoint_every == 0:
            ckpt.save_state(args.checkpoint_dir, snapshot(), r.state)
    if args.checkpoint_dir:
        ckpt.save_state(args.checkpoint_dir, snapshot(), r.state)
    hdr = np.array(r.image())
    if not args.quiet:
        print(file=sys.stderr)

    if args.output:
        save_png(args.output, hdr, gamma=args.gamma)
        print(f"wrote {args.output}")
    if args.hdr_output:
        save_hdr(args.hdr_output, hdr)
        print(f"wrote {args.hdr_output}")
    if not args.output and not args.hdr_output:
        print(json.dumps({"mean": float(hdr.mean()), "max": float(hdr.max())}))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    import bench

    bench.main()
    return 0


def cmd_view(args: argparse.Namespace) -> int:
    from pathtracer.models import camera as cm
    from pathtracer.models.integrator import RenderConfig
    from pathtracer.utils.cache import enable_compile_cache
    from pathtracer.viewer import run_viewer

    enable_compile_cache()
    w, h = _parse_size(args.size)
    scene, cs = _load_scene(args.scene)
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    config = RenderConfig(spp=args.spp, max_bounces=args.bounces,
                          use_nee=args.nee)
    frames = run_viewer(
        scene, camera, config, seed=args.seed,
        max_frames=args.frames,
        interactive=sys.stdout.isatty() or args.frames is None,
        snapshot_path=args.snapshot,
    )
    print(f"\nrendered {frames} frames")
    return 0


def cmd_invert(args: argparse.Namespace) -> int:
    """Inverse-rendering demo (BASELINE config 5): perturb the Cornell
    grey-wall albedo + light intensity, recover them by gradient descent."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer.diff import inverse
    from pathtracer.io.image import save_png
    from pathtracer.models import camera as cm, scene as sc
    from pathtracer.models.integrator import RenderConfig
    from pathtracer.parallel.mesh import make_mesh
    from pathtracer.utils.cache import enable_compile_cache

    enable_compile_cache()
    w, h = _parse_size(args.size)
    scene, cs = sc.cornell_spheres()
    camera = cm.make_camera(cs["eye"], cs["look_at"], cs["up"], w, h, cs["fov"])
    config = RenderConfig(spp=args.spp, max_bounces=3)
    key = jax.random.key(args.seed)

    params0 = dict(inverse.params_of(scene))
    params0["mat_color"] = scene.mat_color.at[3].set(
        jnp.asarray([0.3, 0.3, 0.3]))
    params0["light_intensity"] = scene.light_intensity * 0.5

    optimizer = inverse.make_optimizer(lr=args.lr)
    state = inverse.init_state(scene, optimizer, params0)
    mesh = make_mesh()
    target = inverse.render_target(scene, camera, key, config,
                                   n_iterations=1, base_iteration=0)
    step_fn = inverse.make_train_step(scene, camera, config, mesh,
                                      optimizer, fixed_iteration=0)
    for i in range(args.steps):
        state, loss = step_fn(state, target, key)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
    got = np.array(state.params["mat_color"][3])
    want = np.array(scene.mat_color[3])
    print(f"recovered albedo {np.round(got, 3)}  (true {np.round(want, 3)})")
    gi = np.array(state.params["light_intensity"][0])
    wi = np.array(scene.light_intensity[0])
    print(f"recovered intensity {np.round(gi, 2)}  (true {np.round(wi, 2)})")
    if args.output:
        final = inverse.apply_params(scene, state.params)
        from pathtracer.models.integrator import render_image

        img = np.array(render_image(final, camera, key, config))
        save_png(args.output, img)
        print(f"wrote {args.output}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pathtracer", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to an image")
    pr.add_argument("--scene", default="cornell",
                    help="builtin name (cornell, small, single-sphere, "
                         "cornell-glass) or a .json scene file")
    pr.add_argument("--size", default="640x480")
    pr.add_argument("--spp", type=int, default=4)
    pr.add_argument("--bounces", type=int, default=10)
    pr.add_argument("--iterations", type=int, default=8)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--nee", action="store_true",
                    help="next-event estimation + MIS (lower variance)")
    pr.add_argument("--gamma", type=float, default=2.2)
    pr.add_argument("--checkpoint-dir",
                    help="snapshot dir: resume an interrupted progressive "
                         "render bit-exactly (either render path)")
    pr.add_argument("--checkpoint-every", type=int, default=8,
                    help="snapshot every N steps")
    pr.add_argument("-o", "--output", help="PNG output path")
    pr.add_argument("--hdr-output", help="linear .npy output path")
    pr.add_argument("-q", "--quiet", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="run the standard benchmark")
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("view", help="interactive terminal viewer")
    pv.add_argument("--scene", default="cornell")
    pv.add_argument("--size", default="192x144")
    pv.add_argument("--spp", type=int, default=2)
    pv.add_argument("--bounces", type=int, default=6)
    pv.add_argument("--nee", action="store_true")
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--frames", type=int, default=None,
                    help="stop after N frames (headless smoke mode)")
    pv.add_argument("--snapshot", default="snapshot.png")
    pv.set_defaults(fn=cmd_view)

    pi = sub.add_parser("invert", help="inverse-rendering demo (config 5)")
    pi.add_argument("--size", default="32x32")
    pi.add_argument("--spp", type=int, default=4)
    pi.add_argument("--steps", type=int, default=30)
    pi.add_argument("--lr", type=float, default=5e-2)
    pi.add_argument("--seed", type=int, default=0)
    pi.add_argument("-o", "--output", help="render recovered scene to PNG")
    pi.set_defaults(fn=cmd_invert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
