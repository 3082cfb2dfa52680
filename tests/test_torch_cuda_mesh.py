"""The row window and sharded runs on the card (marked `cuda`; skip
without a CUDA device). Imports neither JAX nor rrt_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py -q

tile_render, train_fwd and train_bwd on bands of rows: the forward
kernels' outputs are the full launch's rows bit for bit (keys are the
image's pixel ids), train_bwd's cotangents summed over the bands are
the full launch's within the spread its atomics allow; a window outside
the image raises before any launch. Then ranks sharing the card under
gloo: a two-rank CLI render writes the single-process image, and a
two-rank train step gives the single-process gradients on every rank.
Last, ranks that load the kernels at once in a fresh build directory
run nvcc once between them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rrt_tpu_torch import render, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.parallel.launch import launch

from test_torch_cuda import device  # noqa: F401 (a fixture)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (scene, width, height, band edges): bands that do not start on a block
# of 16 rows, and rttnw_final's walk over its 400 ground boxes.
CASES = [("chap12", 128, 72, (0, 23, 50, 72)),
         ("cornell", 64, 64, (0, 17, 64)),
         ("rttnw_final", 80, 54, (0, 30, 54))]
# train_bwd's pack cotangents within this share of their largest (its
# atomics and per-block partials: chip_smoke.py's PACK_SPREAD).
SPREAD = 1e-5


def _case(device, name, w, h, spp=2, depth=8):
    scene, cam = tscenes.SCENES[name](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    packs = [p.detach() for p in packs]
    kw = dict(seed_words=(0, 3), sample_lo=1, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=scene.has_moving,
              solids=tmk.pack_solids(scene, device),
              tex=tmk.pack_textures(scene, device))
    return packs, bvh, kw


def _bands(edges):
    return list(zip(edges[:-1], edges[1:]))


@pytest.mark.parametrize("name,w,h,edges", CASES)
def test_tile_render_bands_are_the_full_rows(device, name, w, h, edges):
    packs, bvh, kw = _case(device, name, w, h)
    full = tmk.render_tiles(*packs, bvh=bvh, **kw)
    parts = [tmk.render_tiles(*packs, bvh=bvh, row_lo=lo, row_hi=hi, **kw)
             for lo, hi in _bands(edges)]
    torch.cuda.synchronize(device)
    for i in range(2):
        assert torch.equal(torch.cat([p[i] for p in parts]), full[i])


@pytest.mark.parametrize("name,w,h,edges", CASES)
def test_train_fwd_bands_are_the_full_rows(device, name, w, h, edges):
    packs, _, kw = _case(device, name, w, h)
    full = tmkt.render_tiles_train(*packs, **kw)
    parts = [tmkt.render_tiles_train(*packs, row_lo=lo, row_hi=hi, **kw)
             for lo, hi in _bands(edges)]
    assert torch.equal(torch.cat([p[0] for p in parts]), full[0])
    assert torch.equal(torch.cat([p[1] for p in parts]), full[1])
    assert torch.equal(torch.cat([p[2] for p in parts], dim=1), full[2])
    # The kernel leaves the winner entries past a pixel's segments as they
    # were: compare the written ones.
    winners = torch.cat([p[3] for p in parts], dim=1)
    written = (torch.arange(full[3].shape[0], device=device)[:, None]
               < full[1][None, :])
    assert torch.equal(winners[written], full[3][written])


def _spread(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("name,w,h,edges", CASES)
def test_train_bwd_bands_sum_to_the_full_launch(device, name, w, h, edges):
    packs, _, kw = _case(device, name, w, h)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    g = torch.Generator(device=device).manual_seed(0)
    d_rad = torch.randn(rad.shape, generator=g, device=device)
    full = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    parts = []
    for lo, hi in _bands(edges):
        fwd = tmkt.render_tiles_train(*packs, row_lo=lo, row_hi=hi, **kw)
        parts.append(tmkt.tiles_adjoint(
            *packs, d_rad[lo * w:hi * w].contiguous(), fwd[2], fwd[3],
            row_lo=lo, row_hi=hi, **kw))
    assert int(full[3]) == 0 and all(int(p[3]) == 0 for p in parts)
    for i in range(3):
        assert _spread(sum(p[i] for p in parts), full[i]) <= SPREAD, i
    if full[4] is not None:
        for field in ("quad24", "box24"):
            got = sum(getattr(p[4], field) for p in parts)
            assert _spread(got, getattr(full[4], field)) <= SPREAD, field
    if full[5] is not None:
        assert _spread(sum(p[5] for p in parts), full[5]) <= SPREAD


def test_window_outside_the_image_raises_before_a_launch(device):
    packs, bvh, kw = _case(device, "chap12", 32, 16)
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    counts = (tmk.render_tiles.launches, tmkt.render_tiles_train.launches,
              tmkt.tiles_adjoint.launches)
    for lo, hi in ((-1, 4), (0, 17), (5, 5), (9, 3)):
        win = dict(row_lo=lo, row_hi=hi)
        with pytest.raises(ValueError, match="row window"):
            tmk.render_tiles(*packs, bvh=bvh, **win, **kw)
        with pytest.raises(ValueError, match="row window"):
            tmkt.render_tiles_train(*packs, **win, **kw)
        with pytest.raises(ValueError, match="row window"):
            tmkt.tiles_adjoint(*packs, torch.zeros_like(rad), lengths,
                               winners, **win, **kw)
    assert counts == (tmk.render_tiles.launches,
                      tmkt.render_tiles_train.launches,
                      tmkt.tiles_adjoint.launches)


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def test_two_ranks_sharing_the_card_write_the_single_process_image(
        device, tmp_path):
    args = ["--scene", "chap12", "-r", "96x64", "-s", "8", "--max-depth",
            "16", "--device", "cuda", "--quiet"]
    from rrt_tpu_torch import cli
    cli.main(args + ["-o", str(tmp_path / "one.png")])
    launch(["rrt_tpu_torch.cli", *args, "--mesh", "2x1", "-o",
            str(tmp_path / "two.png")], 2, timeout=600, env=_env(), cwd=REPO)
    assert ((tmp_path / "one.png").read_bytes()
            == (tmp_path / "two.png").read_bytes())


def test_two_ranks_sharing_the_card_train_as_one(device, tmp_path):
    """1x2 (the samples split): every rank's gradients are the single
    process's within 1e-5 of each field's largest (not twice them), and
    both ranks' parameters are the same bit for bit."""
    args = ["rrt_tpu_torch.parallel.train_step", "--scene", "chap12", "-r",
            "64x32", "-s", "4", "--device", "cuda"]
    launch([*args, "--out", str(tmp_path / "one")], 1, timeout=600,
           env=_env(), cwd=REPO)
    outs = launch([*args, "--mesh", "1x2", "--out", str(tmp_path / "two")],
                  2, timeout=600, env=_env(), cwd=REPO)
    assert "backend gloo" in outs[0]
    one = dict(np.load(tmp_path / "one" / "rank0.npz"))
    ranks = [dict(np.load(tmp_path / "two" / f"rank{i}.npz"))
             for i in range(2)]
    for key, want in one.items():
        if key.startswith("grad/"):
            tol = 1e-5 * max(np.abs(want).max(), 1e-6)
            for r in ranks:
                np.testing.assert_allclose(r[key], want, rtol=0, atol=tol,
                                           err_msg=key)
        if key.startswith("param/"):
            assert np.array_equal(ranks[0][key], ranks[1][key]), key


_BUILD_RANK = """
import ctypes, sys
from pathlib import Path
from rrt_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._SOURCES = ("probes.cu",)  # the quickest source to build
built = _build.build()
ctypes.CDLL(str(built.path))
print(built.path, built.seconds)
"""


def test_ranks_first_use_runs_nvcc_once(device, tmp_path):
    """Three processes build the kernels at once in a fresh directory
    (a sharded run's first use): one runs nvcc, the others wait on its
    lock, and every one loads the library it renamed into place."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RANK,
                               str(tmp_path)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    built = [out.split()[-2:] for out in outs]
    assert len({path for path, _ in built}) == 1, outs
    assert sorted(float(s) > 0 for _, s in built) == [False, False, True]
