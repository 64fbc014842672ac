"""CLI smoke tests (pathtracer.cli) — the batch render surface.

The reference's only "batch" surface is its GLUT window loop
(main.cpp:205-232); the CLI is this framework's headless equivalent.
These run on the CPU suite: the CLI leaves the CPU backend without a
persistent compile cache (utils/cache), so it is safe to invoke
in-process here. On the CPU every render takes the wavefront integrator
(models/progressive.choose_backend).
"""
from __future__ import annotations

import json

import numpy as np

from pathtracer import cli


def _read_png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w = int.from_bytes(data[16:20], "big")
    h = int.from_bytes(data[20:24], "big")
    return w, h


def test_render_builtin_scene(tmp_path):
    out = tmp_path / "cornell.png"
    hdr = tmp_path / "cornell.npy"
    rc = cli.main([
        "render", "--scene", "cornell", "--size", "32x24", "--spp", "4",
        "--bounces", "4", "--iterations", "2",
        "-o", str(out), "--hdr-output", str(hdr), "-q",
    ])
    assert rc == 0
    assert _read_png_size(out) == (32, 24)
    lin = np.load(hdr)
    assert lin.shape == (24, 32, 3)
    assert np.isfinite(lin).all() and lin.max() > 0


def test_render_json_scene_with_nee(tmp_path):
    scene = {
        "camera": {"eye": [0, 2, 8], "look_at": [0, 0, 0], "up": [0, 1, 0],
                   "fov": 60.0},
        "materials": [{"type": "diffuse", "color": [0.7, 0.7, 0.7]}],
        "spheres": [{"center": [0, -1e4 - 1, 0], "radius": 1e4,
                     "material": 0}],
        "lights": [{"type": "point", "pos": [0, 3, 0],
                    "intensity": [30, 30, 30]}],
    }
    sf = tmp_path / "scene.json"
    sf.write_text(json.dumps(scene))
    out = tmp_path / "out.png"
    rc = cli.main([
        "render", "--scene", str(sf), "--size", "16x12", "--spp", "4",
        "--bounces", "3", "--iterations", "1", "--nee",
        "-o", str(out), "-q",
    ])
    assert rc == 0
    assert _read_png_size(out) == (16, 12)


def test_backend_flag_is_gone():
    """The device path is chosen in one place; no flag overrides it."""
    import pytest

    with pytest.raises(SystemExit):
        cli.main(["render", "--backend", "pallas", "--size", "8x8", "-q"])


def test_invert_smoke(capsys):
    """CLI inverse-rendering demo through the sharded XLA train step:
    runs, prints a finite loss per logged step and the recovered values."""
    rc = cli.main([
        "invert", "--size", "12x8", "--spp", "2", "--steps", "2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert losses and np.isfinite(losses).all()
    assert "recovered albedo" in out


def test_render_checkpoint_resume(tmp_path):
    """--checkpoint-dir snapshots the accumulator; a second run with a
    higher --iterations resumes and finishes the render."""
    d = str(tmp_path / "ck")
    args = ["render", "--scene", "single-sphere", "--size", "8x8", "--spp",
            "1", "--bounces", "2", "-q", "--checkpoint-dir", d,
            "--checkpoint-every", "1"]
    assert cli.main(args + ["--iterations", "2"]) == 0
    from pathtracer.utils import checkpoint as ckpt

    assert ckpt.latest_step(d) == 2
    assert cli.main(args + ["--iterations", "3"]) == 0
    assert ckpt.latest_step(d) == 3
