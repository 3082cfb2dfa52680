"""The port's CLI: drivers, progressive passes and checkpoints, on the
CPU (the kernels' plain versions).

Every driver renders the same samples with the same keys, so their
images agree within 1e-5 (the sums' order differs); a render split into
passes agrees with the one-pass render within 1e-5; a render resumed
from its checkpoint equals, bit for bit, the uninterrupted render with
the same passes (tests/test_io_cli.py's rule for rrt_tpu). Checkpoints
are rrt_tpu's .npz format, so either package loads the other's."""

import numpy as np
import pytest
import torch

from rrt_tpu import io as jio
from rrt_tpu_torch import cli, io as tio

ARGS = ["--scene", "chap11", "-r", "24x16", "--max-depth", "6",
        "--device", "cpu", "--quiet"]


def _render(tmp_path, *extra, spp=4):
    argv = ARGS + ["-s", str(spp), "-o", str(tmp_path / "o.png"),
                   *map(str, extra)]
    return cli.render(cli.build_parser().parse_args(argv))


@pytest.fixture(scope="module")
def tile_image(tmp_path_factory):
    return _render(tmp_path_factory.mktemp("tile"), "--driver",
                   "tile").image


@pytest.mark.parametrize("driver", ["tile", "queue", "batch"])
def test_each_driver_renders(tmp_path, tile_image, driver):
    res = _render(tmp_path, "--driver", driver, "--queue-size", 512)
    assert res.driver == driver and res.passes == 1
    assert res.image.shape == (16, 24, 3)
    torch.testing.assert_close(res.image, tile_image, atol=1e-5, rtol=1e-5)
    assert (tmp_path / "o.png").stat().st_size > 0


def test_auto_resolves_to_tile(tmp_path, tile_image):
    res = _render(tmp_path)
    assert res.driver == "tile"
    assert torch.equal(res.image, tile_image)


@pytest.mark.parametrize("driver", ["tile", "queue", "batch"])
def test_spp_chunks_give_the_one_pass_image(tmp_path, tile_image, driver):
    res = _render(tmp_path, "--driver", driver, "--spp-chunk", 2)
    assert res.passes == 2
    torch.testing.assert_close(res.image, tile_image, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("driver", ["tile", "queue", "batch"])
def test_resumed_render_is_bit_exact(tmp_path, capsys, driver):
    """-s 4 with --checkpoint, then -s 8 with the same file: the second
    run renders samples 4-7 on top of the first run's sum, and equals an
    uninterrupted -s 8 render in passes of 4, bit for bit."""
    whole = _render(tmp_path, "--driver", driver, "--spp-chunk", 4, spp=8)
    ck = tmp_path / "ck.npz"
    _render(tmp_path, "--driver", driver, "--checkpoint", ck)
    _, spp_done, _, _ = tio.load_checkpoint(str(ck))
    assert spp_done == 4
    argv = [a for a in ARGS if a != "--quiet"]
    capsys.readouterr()
    res = cli.render(cli.build_parser().parse_args(
        argv + ["-s", "8", "--driver", driver, "--checkpoint", str(ck),
                "-o", str(tmp_path / "r.png")]))
    assert "resumed checkpoint at 4/8" in capsys.readouterr().err
    assert res.passes == 1
    assert torch.equal(res.image, whole.image)
    assert tio.load_checkpoint(str(ck))[1] == 8


def test_incompatible_checkpoint_starts_fresh(tmp_path, capsys, tile_image):
    ck = str(tmp_path / "ck.npz")
    tio.save_checkpoint(ck, np.ones((24 * 16, 3), np.float32), 2, seed=5,
                        meta={"scene": "chap11"})
    argv = [a for a in ARGS if a != "--quiet"]
    res = cli.render(cli.build_parser().parse_args(
        argv + ["-s", "4", "--checkpoint", ck,
                "-o", str(tmp_path / "o.png")]))
    assert "incompatible" in capsys.readouterr().err
    assert torch.equal(res.image, tile_image)


def test_checkpoints_cross_packages(tmp_path):
    """rrt_tpu's checkpoint loads in the port and the port's in rrt_tpu,
    with the same sum, cursor, seed and meta."""
    rg = np.random.default_rng(0)
    acc = rg.random((12, 3), dtype=np.float32)
    meta = {"scene": "chap12", "width": 4, "height": 3, "max_depth": 50}
    for save, load in ((jio.save_checkpoint, tio.load_checkpoint),
                       (tio.save_checkpoint, jio.load_checkpoint)):
        path = str(tmp_path / f"{save.__module__}.npz")
        save(path, acc, 6, 11, meta)
        got, spp_done, seed, got_meta = load(path)
        np.testing.assert_array_equal(got, acc)
        assert (spp_done, seed, got_meta) == (6, 11, meta)


def test_resumes_an_rrt_tpu_checkpoint(tmp_path, capsys, tile_image):
    """A checkpoint with rrt_tpu's CLI meta for the same render resumes:
    the port renders samples 2-3 on top of its samples 0-1."""
    first = _render(tmp_path, "--spp-chunk", 2, spp=2)
    ck = str(tmp_path / "ck.npz")
    meta = {"scene": "chap11", "width": 24, "height": 16, "max_depth": 6,
            "rr_depth": 0, "texture": "", "texture_filter": "nearest",
            "texture_max": "512x256"}
    jio.save_checkpoint(ck, (first.image * 2).reshape(-1, 3).numpy(), 2, 0,
                        meta)
    argv = [a for a in ARGS if a != "--quiet"]
    res = cli.render(cli.build_parser().parse_args(
        argv + ["-s", "4", "--checkpoint", ck,
                "-o", str(tmp_path / "o.png")]))
    assert "resumed checkpoint at 2/4" in capsys.readouterr().err
    torch.testing.assert_close(res.image, tile_image, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def rr_tile(tmp_path_factory):
    """The tile driver's render with --rr-depth 2, and the traced count
    of the same render without the roulette."""
    tmp = tmp_path_factory.mktemp("rr")
    off = _render(tmp, "--driver", "tile")
    return _render(tmp, "--driver", "tile", "--rr-depth", 2), off.n_traced


@pytest.mark.parametrize("driver", ["tile", "queue", "batch"])
def test_rr_depth(tmp_path, rr_tile, driver):
    """--rr-depth goes into RenderConfig on every driver (the tile
    driver's image, fewer segments than without it) and into the
    checkpoint's meta, as rrt_tpu's CLI writes it, so a render without
    the roulette does not resume it (test_incompatible_checkpoint_starts_
    fresh)."""
    tile, n_off = rr_tile
    ck = tmp_path / "ck.npz"
    res = _render(tmp_path, "--driver", driver, "--rr-depth", 2,
                  "--queue-size", 512, "--checkpoint", ck)
    torch.testing.assert_close(res.image, tile.image, atol=1e-5, rtol=1e-5)
    assert res.n_traced == tile.n_traced < n_off
    assert tio.load_checkpoint(str(ck))[3]["rr_depth"] == 2
