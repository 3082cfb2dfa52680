"""The port's CLI flags from rrt_tpu's that came with sharding, and
io.read_image, on the CPU.

A two-process render (--coordinator, --num-processes, --process-id,
--mesh; gloo ranks started with a free port and a time limit by
parallel.launch) writes the single-process image; -m draws one seed on
rank 0 for every rank; --texture with --texture-max and --texture-filter
builds the atlas rrt_tpu's CLI builds; RRT_FAULT_AFTER_CHUNKS ends a
render with exit code 17 and a restart from its --checkpoint ends bit
for bit as an uninterrupted one, as does one process resuming a
sharded render's checkpoint; --profile writes a chrome trace.
io.read_image equals rrt_tpu.io.read_image on PPM and PNG files the
tests write (each of PNG's five row filters among them)."""

import json
import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rrt_tpu import io as jio
from rrt_tpu import scenes as jscenes
from rrt_tpu.scene import resample_image as jresample
from rrt_tpu_torch import cli, io as tio
from rrt_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--scene", "chap11", "-r", "24x16", "--max-depth", "6", "--device",
        "cpu"]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def test_two_process_render_writes_the_single_process_image(tmp_path):
    cli.main(ARGS + ["-s", "4", "--quiet", "-o", str(tmp_path / "one.png")])
    logs = launch(["rrt_tpu_torch.cli", *ARGS, "-s", "4", "--mesh", "2x1",
                   "-o", str(tmp_path / "two.png")], 2, timeout=240,
                  env=_env(), cwd=REPO)
    assert any(ln.startswith("backend gloo") for ln in logs[0].splitlines())
    assert ((tmp_path / "one.png").read_bytes()
            == (tmp_path / "two.png").read_bytes())


def test_distributed_flags_are_required_together(capsys, tmp_path):
    out = str(tmp_path / "o.png")
    assert cli.main(ARGS + ["--coordinator", "localhost:1", "-o", out]) == 2
    assert cli.main(ARGS + ["--num-processes", "2", "--process-id", "0",
                            "-o", out]) == 2
    assert "needs all of --coordinator" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_random_seed_is_rank_0s_on_every_rank(tmp_path):
    """-m: rank 0 draws the seed and broadcasts it (rrt_tpu draws one a
    process, so its ranks would render with different seeds)."""
    logs = launch(["rrt_tpu_torch.cli", *ARGS, "-s", "2", "-m", "--mesh",
                   "1x2", "-o", str(tmp_path / "r.png")], 2, timeout=240,
                  env=_env(), cwd=REPO)
    seeds = {int(m) for log in logs for m in re.findall(r"seed=(\d+)", log)}
    assert len(seeds) == 1


def _texture_file(tmp_path, kind):
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (150, 300, 3), dtype=np.uint8)
    path = str(tmp_path / f"tex.{kind}")
    if kind == "ppm":
        jio.write_ppm(path, rgb)
    else:
        Image.fromarray(rgb).save(path)
    return path


@pytest.mark.parametrize("kind,filt", [("ppm", "nearest"),
                                       ("png", "bilinear")])
def test_texture_builds_rrt_tpu_clis_atlas(tmp_path, kind, filt):
    """--texture past --texture-max is resampled with --texture-filter
    into the scene's atlas, as rrt_tpu's CLI does (cli.py:237-262)."""
    path = _texture_file(tmp_path, kind)
    args = cli.build_parser().parse_args(
        ["--scene", "earth", "-r", "32x16", "--texture", path,
         "--texture-max", "128x64", "--texture-filter", filt])
    scene, _ = cli.build_scene(args, lambda *a: None)
    img = jresample(jio.read_image(path), 64, 128, filt)
    want, _ = jscenes.SCENES["earth"](32, 16, image=img, image_resample=filt)
    assert np.array_equal(scene.images.numpy(), np.asarray(want.images))


def test_texture_on_a_scene_without_an_image_exits_2(tmp_path, capsys):
    path = _texture_file(tmp_path, "ppm")
    assert cli.main(ARGS + ["--texture", path, "-o",
                            str(tmp_path / "o.png")]) == 2
    assert "has no image texture" in capsys.readouterr().err


def test_fault_hook_then_resume_is_bit_exact(tmp_path):
    """RRT_FAULT_AFTER_CHUNKS=1 ends the render with code 17 after its
    first pass of 2 samples, its checkpoint written; the restart renders
    samples 2-3 on top and equals the uninterrupted render in passes of
    2, bit for bit (rrt_tpu's test_cli_crash_recovery_bit_exact)."""
    ck = str(tmp_path / "ck.npz")
    argv = ARGS + ["-s", "4", "--spp-chunk", "2", "--checkpoint", ck]
    crashed = subprocess.run(
        [sys.executable, "-m", "rrt_tpu_torch.cli", *argv, "--quiet", "-o",
         str(tmp_path / "c.png")], env=_env(RRT_FAULT_AFTER_CHUNKS="1"),
        cwd=REPO, capture_output=True, timeout=240)
    assert crashed.returncode == 17, crashed.stderr
    assert tio.load_checkpoint(ck)[1] == 2
    resumed = cli.render(cli.build_parser().parse_args(
        argv + ["--quiet", "-o", str(tmp_path / "r.png")]))
    whole = cli.render(cli.build_parser().parse_args(
        ARGS + ["-s", "4", "--spp-chunk", "2", "--quiet", "-o",
                str(tmp_path / "w.png")]))
    assert resumed.passes == 1 and torch.equal(resumed.image, whole.image)


def test_sharded_checkpoint_resumes_bit_for_bit(tmp_path):
    """A 2x1 render at 6 spp checkpoints the assembled radiance sums (not
    the image times spp, which rounds at an spp that is not a power of
    two): one process resuming it ends bit for bit as an unsharded
    render."""
    ck = str(tmp_path / "ck.npz")
    launch(["rrt_tpu_torch.cli", *ARGS, "-s", "6", "--mesh", "2x1",
            "--checkpoint", ck, "-o", str(tmp_path / "two.png")], 2,
           timeout=240, env=_env(), cwd=REPO)
    argv = ARGS + ["-s", "6", "--spp-chunk", "6", "--quiet"]
    resumed = cli.render(cli.build_parser().parse_args(
        argv + ["--checkpoint", ck, "-o", str(tmp_path / "r.png")]))
    whole = cli.render(cli.build_parser().parse_args(
        argv + ["-o", str(tmp_path / "w.png")]))
    assert resumed.passes == 0 and torch.equal(resumed.image, whole.image)


def test_profile_writes_a_chrome_trace(tmp_path):
    cli.render(cli.build_parser().parse_args(
        ARGS + ["-s", "2", "--quiet", "--profile", str(tmp_path / "prof"),
                "-o", str(tmp_path / "o.png")]))
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def _png(rgb, rows_filter):
    """An 8-bit PNG of rgb (h, w, c), c = 3 or 4, row y written with PNG
    filter rows_filter(y) (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    h, w, c = rgb.shape
    px = rgb.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        cur = px[y]
        up = px[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        kind = rows_filter(y)
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["ppm", "png-rgb", "png-rgba", "png-pil"])
def test_read_image_matches_rrt_tpu(tmp_path, kind):
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (23, 31, 4), dtype=np.uint8)
    rgba[5:15, 4:20] = rgba[5, 4]  # flat runs, as photographs have
    path = tmp_path / f"t.{kind.split('-')[0]}"
    if kind == "ppm":
        # Comments in the header, and a raster whose first byte is a
        # whitespace value (exactly one whitespace byte ends the header).
        rgba[0, 0, 0] = 10
        path.write_bytes(b"P6\n# a comment\n31 23\n# another\n255\n"
                         + rgba[:, :, :3].tobytes())
    elif kind == "png-pil":
        Image.fromarray(rgba, "RGBA").save(path, optimize=True)
    else:
        c = 3 if kind == "png-rgb" else 4
        path.write_bytes(_png(rgba[:, :, :c], lambda y: y % 5))
    got = tio.read_image(str(path))
    assert got.dtype == np.float32 and got.shape == (23, 31, 3)
    assert np.array_equal(got, jio.read_image(str(path)))


def test_read_image_rejects_what_it_does_not_read(tmp_path):
    rgb = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "t.jpg")
    with pytest.raises(ValueError, match="PPM .*PNG"):
        tio.read_image(str(tmp_path / "t.jpg"))
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "g.png")
    with pytest.raises(ValueError, match="8-bit"):
        tio.read_image(str(tmp_path / "g.png"))
