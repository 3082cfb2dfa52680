"""The port's sharding (rrt_tpu_torch/parallel/mesh.py) on the CPU.

The row window: the plain versions of the three tile kernels on two
bands of rows against the full launch, keyed by the image's pixel ids.
make_mesh's factorization against rrt_tpu's. Then ranks: gloo processes
on the CPU, each started with a free port and a time limit
(parallel.launch), so nothing can hang the suite: the sharded forward
through the CLI's tile, queue and batch drivers (with --checkpoint, its
float radiance) against one process (bit for bit under sp = 1, within
1e-5 x max(1, |v|) otherwise) and against rrt_tpu's sharded renders on
conftest's virtual CPU mesh; the sharded train step
(parallel.train_step) against one process's gradients, on every rank,
with every rank's parameters the same bit for bit; make_train_step's
routing to the chunked trainer, rrt_tpu's rule per rank; and
resolve_spp_chunk's per-rank residual."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_helpers as helpers
import rrt_tpu.diff as jdiff
from rrt_tpu import render as jrender
from rrt_tpu import scenes as jscenes
from rrt_tpu.parallel import mesh as jmesh
from rrt_tpu_torch import diff, io as tio, render, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.parallel import mesh as pmesh
from rrt_tpu_torch.parallel.launch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # a run's ranks together; each takes a few seconds alone
W, H, SPP, DEPTH = 16, 8, 4, 4
MESHES = ["2x1", "1x2", "2x2"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _ranks(mesh):
    dp, sp = map(int, mesh.split("x"))
    return dp * sp


# ---------------------------------------------------------------------------
# The row window
# ---------------------------------------------------------------------------


def _packs(name):
    scene, cam = tscenes.SCENES[name](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=2, max_depth=DEPTH)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, "cpu")]
    kw = dict(seed_words=(0, 3), sample_lo=1, width=W, height=H, spp=2,
              max_depth=DEPTH, t_min=1e-3, moving=scene.has_moving,
              solids=tmk.pack_solids(scene, "cpu"),
              tex=tmk.pack_textures(scene, "cpu"))
    return packs, kw


@pytest.mark.parametrize("name", ["chap12", "rttnw_final"])
@pytest.mark.parametrize("kernel", ["render_tiles", "render_tiles_train",
                                    "tiles_adjoint"])
def test_bands_give_the_full_launch(name, kernel):
    """render_tiles' and render_tiles_train's outputs on bands [0, 5) and
    [5, 8) are the full launch's rows (lengths and winners: columns) bit
    for bit; tiles_adjoint's cotangents are sums over every pixel, so the
    bands' sum is the full launch's up to f32 summation order."""
    packs, kw = _packs(name)
    bands = ((0, 5), (5, H))
    if kernel == "render_tiles":
        full = tmk.render_tiles(*packs, **kw)
        parts = [tmk.render_tiles(*packs, row_lo=lo, row_hi=hi, **kw)
                 for lo, hi in bands]
        for i in range(2):
            assert torch.equal(torch.cat([p[i] for p in parts]), full[i])
        return
    full = tmkt.render_tiles_train(*packs, **kw)
    parts = [tmkt.render_tiles_train(*packs, row_lo=lo, row_hi=hi, **kw)
             for lo, hi in bands]
    if kernel == "render_tiles_train":
        for i in range(4):
            assert torch.equal(torch.cat([p[i] for p in parts],
                                         dim=0 if i < 2 else 1), full[i])
        return
    g = torch.Generator().manual_seed(0)
    d_rad = torch.randn((W * H, 3), generator=g)
    want = tmkt.tiles_adjoint(*packs, d_rad, full[2], full[3], **kw)
    got = [tmkt.tiles_adjoint(*packs, d_rad[lo * W:hi * W].contiguous(),
                              p[2], p[3], row_lo=lo, row_hi=hi, **kw)
           for (lo, hi), p in zip(bands, parts)]
    assert int(want[3]) == 0 and all(int(x[3]) == 0 for x in got)
    for i in range(3):
        torch.testing.assert_close(got[0][i] + got[1][i], want[i], rtol=0,
                                   atol=1e-6 * float(want[i].abs().max()))


def test_window_outside_the_image_raises():
    packs, kw = _packs("chap12")
    for lo, hi in ((-1, 4), (0, H + 1), (3, 3)):
        with pytest.raises(ValueError, match="row window"):
            tmk.render_tiles(*packs, row_lo=lo, row_hi=hi, **kw)
        with pytest.raises(ValueError, match="row window"):
            render.trace_tiles_diff(*tscenes.SCENES["chap12"](W, H),
                                    render.RenderConfig(width=W, height=H,
                                                        spp=1, max_depth=2),
                                    0, device="cpu", row_lo=lo, row_hi=hi)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_factorization_matches_rrt_tpu(n):
    """rrt_tpu's default rule, raise and all: at 5 and 7 devices its sp
    of 2 leaves a device out, and both packages raise."""
    try:
        want = jmesh.make_mesh(jax.devices()[:n]).shape
    except ValueError:
        with pytest.raises(ValueError):
            pmesh.factorize(n)
    else:
        assert pmesh.factorize(n) == (want["dp"], want["sp"])
    for sp in (1, 2):
        if n % sp == 0:
            assert pmesh.factorize(n, sp=sp) == (n // sp, sp)
            assert pmesh.factorize(n, dp=n // sp) == (n // sp, sp)


def test_bad_factorization_raises_as_rrt_tpu():
    for dp, sp in ((3, 1), (2, 3), (1, 3)):
        with pytest.raises(ValueError):
            jmesh.make_mesh(jax.devices()[:4], dp=dp, sp=sp)
        with pytest.raises(ValueError, match="world size 4"):
            pmesh.factorize(4, dp, sp)


def test_mesh_of_one_process():
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.dp, mesh.sp, mesh.dp_rank, mesh.sp_rank) == (1, 1, 0, 0)
    assert mesh.share == 1 and pmesh.band(mesh, H) == (0, H)
    assert pmesh.sample_range(mesh, 8) == (0, 8)
    with pytest.raises(ValueError, match="dp\\*sp=2"):
        pmesh.make_mesh(2, 1, device="cpu")
    # On a world of one the tile route is render_image_tiles.
    scene, cam = tscenes.SCENES["chap12"](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    img, n = pmesh.render_image_tiles_sharded(scene, cam, cfg, 0, mesh)
    want, n_want = render.render_image_tiles(scene, cam, cfg, 0,
                                             device="cpu")
    assert torch.equal(img, want) and int(n) == int(n_want)
    # A mesh of another world raises in every sharded route.
    other = pmesh.Mesh(2, 1, 0, 0, torch.device("cpu"))
    for route in (pmesh.trace_tiles_sharded, pmesh.render_image_sharded,
                  pmesh.render_image_queue_sharded,
                  pmesh.render_image_tiles_sharded,
                  pmesh.render_image_diff_sharded):
        with pytest.raises(ValueError, match="world of 1"):
            route(scene, cam, cfg, 0, other)


@pytest.mark.parametrize("hosts,rank,cards,device,want", [
    # Two hosts of four ranks, four cards each: a card a rank, by its
    # index on its host, under nccl.
    (["a"] * 4 + ["b"] * 4, 5, 4, "cuda", ("nccl", "cuda:1", 1)),
    (["a", "b"] * 4, 6, 4, "cuda", ("nccl", "cuda:3", 1)),
    # Four ranks on a host of one card share it under gloo.
    (["a"] * 4, 2, 1, "cuda", ("gloo", "cuda:0", 4)),
    (["a"] * 2 + ["b"] * 3, 4, 2, "cuda:1", ("gloo", "cuda:1", 3)),
    # The CPU: the host's ranks share its memory.
    (["a"] * 3 + ["b"], 1, 4, "cpu", ("gloo", "cpu", 3)),
])
def test_placement_follows_the_host(monkeypatch, hosts, rank, cards, device,
                                    want):
    """place() counts the ranks of this rank's host, not the world's:
    a rank of a multi-host run takes its host's card of its local
    index."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    got = pmesh.place(hosts, rank, device)
    assert (got.backend, str(got.device), got.share) == want


def test_initialize_distributed_trades_host_names(monkeypatch):
    """A world of one through the TCP store: its host's one rank, on the
    CPU under gloo; from_flags leaves the group on exit."""
    from rrt_tpu_torch.parallel.launch import free_port
    with pmesh.from_flags(f"localhost:{free_port()}", 1, 0, "1x1",
                          "cpu") as (mesh, backend):
        assert backend == "gloo" and torch.distributed.is_initialized()
        assert (mesh.size, mesh.share, mesh.device) == (1, 1,
                                                        torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs all of --coordinator"):
        with pmesh.from_flags("localhost:1", None, 0, None, "cpu"):
            pass


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------


SMALL = (W, H, SPP, DEPTH)
# tests/test_torch_slice.py's configuration, where its rule against
# rrt_tpu was set (at 16x8 one parted path is 0.8% of the pixels).
SLICE = (32, 16, 2, 8)


def _sharded_cli(tmp_path, mesh, driver, size=SMALL):
    """The mean image a sharded CLI render writes (its checkpoint, rank
    0, holds the radiance sums) and each rank's log."""
    w, h, spp, depth = size
    ck = tmp_path / f"{mesh}_{driver}.npz"
    logs = launch(["rrt_tpu_torch.cli", "--scene", "chap12", "-r", f"{w}x{h}",
                   "-s", str(spp), "--max-depth", str(depth), "--device",
                   "cpu", "--driver", driver, "--mesh", mesh, "--checkpoint",
                   str(ck), "-o", str(tmp_path / f"{mesh}_{driver}.png")],
                  _ranks(mesh), timeout=TIMEOUT, env=_env(), cwd=REPO)
    rad, spp_done, _, _ = tio.load_checkpoint(str(ck))
    assert spp_done == spp
    return rad.reshape(h, w, 3) / spp, logs


@pytest.fixture(scope="module")
def single_images():
    """One process's tile image and traced count at SMALL and SLICE."""
    out = {}
    for w, h, spp, depth in (SMALL, SLICE):
        cfg = render.RenderConfig(width=w, height=h, spp=spp,
                                  max_depth=depth)
        img, n = render.render_image_tiles(*tscenes.SCENES["chap12"](w, h),
                                           cfg, 0, device="cpu")
        out[(w, h, spp, depth)] = (img.numpy(), int(n))
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_tiles_give_the_single_process_image(tmp_path, single_images,
                                                     mesh):
    img, logs = _sharded_cli(tmp_path, mesh, "tile")
    ours = [ln for ln in logs[0].splitlines() if ln.startswith("backend")]
    assert ours and ours[0].startswith("backend gloo")
    want = single_images[SMALL][0]
    if mesh.endswith("x1"):
        assert np.array_equal(img, want)
    else:
        assert (np.abs(img - want)
                <= 1e-5 * np.maximum(1.0, np.abs(want))).all()


@pytest.mark.parametrize("driver", ["queue", "batch"])
def test_sharded_drivers_match_one_process_and_rrt_tpu(tmp_path,
                                                       single_images,
                                                       driver):
    """The queue and batch drivers on a 2x2 mesh at SLICE against the tile
    image of one process (1e-5: the drivers' rule) and against rrt_tpu's
    render_image_queue_sharded / render_image_sharded on four of
    conftest's virtual CPU devices by tests/test_torch_slice.py's rule
    (>= 98.5% of pixels within 1e-3, traced totals within 1%; the
    port's drivers trace the tile driver's segments)."""
    w, h, spp, depth = SLICE
    img, _ = _sharded_cli(tmp_path, "2x2", driver, SLICE)
    want, n_port = single_images[SLICE]
    np.testing.assert_allclose(img, want, rtol=1e-5, atol=1e-5)
    # Tiles of half the image: rrt_tpu pads its tiles to a multiple of dp
    # with repeats of the last pixel, whose segments its n_traced counts.
    cfg = jrender.RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                               queue_size=w * h * spp,
                               tile_pixels=w * h // 2, samples_per_pass=1)
    route = (jmesh.render_image_queue_sharded if driver == "queue"
             else jmesh.render_image_sharded)
    ref, n_ref = route(*jscenes.chap12_scene(w, h), cfg, 0,
                       jmesh.make_mesh(jax.devices()[:4], dp=2, sp=2))
    close = np.abs(img - np.asarray(ref)).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(n_port - float(n_ref)) / float(n_ref) < 1e-2


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _train(tmp_path, mesh, *extra):
    out = tmp_path / (mesh or "one")
    args = ["rrt_tpu_torch.parallel.train_step", "--scene", "chap12", "-r",
            f"{W}x{H}", "-s", str(SPP), "--max-depth", str(DEPTH),
            "--device", "cpu", "--out", str(out), *extra]
    n = 1 if mesh is None else _ranks(mesh)
    launch(args + ([] if mesh is None else ["--mesh", mesh]), n,
           timeout=TIMEOUT, env=_env(), cwd=REPO)
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(n)]


@pytest.fixture(scope="module")
def single_step():
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    from rrt_tpu_torch.parallel import train_step
    return train_step.run(cfg, "chap12", "cpu")


def _grads(out):
    return {k[len("grad/"):]: v for k, v in out.items()
            if k.startswith("grad/")}


def _check_ranks(ranks, single):
    want = _grads(single)
    for r in ranks:
        got = _grads(r)
        helpers.assert_fields_close(got, want, 1e-5, 1e-5)
        # Not world-size times them: the assembly's transpose is the
        # identity, and the leaves' all_reduce sums shares.
        total = sum(np.abs(v).sum() for v in got.values())
        assert abs(total / sum(np.abs(v).sum() for v in want.values())
                   - 1.0) < 1e-4
        assert float(r["loss"]) == float(single["loss"])
    for k in (k for k in ranks[0] if k.startswith("param/")):
        assert all(np.array_equal(r[k], ranks[0][k]) for r in ranks), k


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_train_step_gives_every_rank_the_gradients(tmp_path,
                                                           single_step,
                                                           mesh):
    _check_ranks(_train(tmp_path, mesh), single_step)


def test_sharded_chunked_trainer_gives_every_rank_the_gradients(
        tmp_path, single_step):
    """make_train_step_chunked on a 2x2 mesh in chunks of 2 samples (one
    sample a rank a chunk): chunk 0 through the train kernels, the other
    through the forward kernel, the cotangent's band rows, the leaves'
    gradients summed over the world."""
    _check_ranks(_train(tmp_path, "2x2", "--spp-chunk", "2"), single_step)


@pytest.mark.parametrize("spp,dp,sp", [(256, 1, 1), (260, 1, 1),
                                       (260, 2, 2), (520, 4, 2),
                                       (1028, 2, 4)])
def test_make_train_step_routes_as_rrt_tpu(monkeypatch, spp, dp, sp):
    """rrt_tpu's rule (tests/test_sharding.py:308): spp / sp past
    4 * DIFF_SAMPLE_BUDGET a rank takes the chunked trainer."""
    routed = {}
    monkeypatch.setattr(jdiff, "make_train_step_chunked",
                        lambda *a, **k: routed.setdefault("jax", True))
    monkeypatch.setattr(diff, "make_train_step_chunked",
                        lambda *a, **k: routed.setdefault("torch", True))
    jcfg = jrender.RenderConfig(width=W, height=H, spp=spp, max_depth=DEPTH)
    jdiff.make_train_step(jcfg, mesh=jmesh.make_mesh(
        jax.devices()[:dp * sp], dp=dp, sp=sp))
    cfg = render.RenderConfig(width=W, height=H, spp=spp, max_depth=DEPTH)
    diff.make_train_step(cfg, mesh=pmesh.Mesh(dp, sp, 0, 0,
                                              torch.device("cpu")),
                         device="cpu")
    assert routed.get("torch", False) == routed.get("jax", False)
    assert routed.get("torch", False) == (spp > 256 * sp)


def test_resolve_spp_chunk_per_rank(monkeypatch):
    """A rank's residual: the tallest band's pixels and chunk / sp
    samples, 33 bytes a path; the chunk a multiple of sp; ranks that
    share a device divide its budget."""
    cfg = render.RenderConfig(width=1200, height=800, spp=500, max_depth=50)
    path = tmkt.boundary_residual_bytes(1, 1)
    monkeypatch.setenv("RRT_RESIDUAL_BUDGET_GB",
                       str((1200 * 400 * 50 * path + 1000) / 1e9))
    mesh = pmesh.Mesh(2, 2, 0, 0, torch.device("cpu"))
    # 100 samples a chunk are 50 a rank on 400 rows: exactly the budget.
    assert diff.resolve_spp_chunk(cfg, device="cpu", mesh=mesh) == 100
    assert diff.resolve_spp_chunk(cfg, 250, device="cpu", mesh=mesh) == 100
    with pytest.raises(ValueError, match="multiple of sp=3"):
        diff.resolve_spp_chunk(dataclasses.replace(cfg, spp=7), device="cpu",
                               mesh=pmesh.Mesh(1, 3, 0, 0,
                                               torch.device("cpu")))
    monkeypatch.delenv("RRT_RESIDUAL_BUDGET_GB")
    monkeypatch.setattr(diff.os, "sysconf", lambda name: 4096)
    assert diff._residual_budget_bytes("cpu") == 4096 * 4096 // 2
    assert diff._residual_budget_bytes("cpu", 4) == 4096 * 4096 // 8


# ---------------------------------------------------------------------------
# The ranks' first use of the kernels
# ---------------------------------------------------------------------------


_BUILD_RANK = """
import os, sys, time
from pathlib import Path
from rrt_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])

def compile_once(srcs, out, log_path):  # nvcc's place: slow, then a rename
    with open(_build.BUILD_DIR / "compiles", "a") as f:
        f.write("1\\n")
    time.sleep(1.0)
    part = out.with_suffix(".part")
    part.write_bytes(b"library")
    os.replace(part, out)
    return _build.Build(out, 1.0, "")

_build._compile = compile_once
print(_build.build().path)
"""


def test_ranks_first_use_builds_once(tmp_path):
    """Four processes that load the kernels at once (a sharded run's
    first use) compile once: the others wait on the build's lock and load
    the library it renamed into place."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_RANK, str(tmp_path)], env=_env(),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert (tmp_path / "compiles").read_text() == "1\n"
