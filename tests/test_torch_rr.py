"""Russian roulette (RenderConfig.rr_depth) in the port's forward routes
against rrt_tpu, on the CPU (the kernels' plain versions).

  * the coin and the weight: rng.rr_draw and render._apply_rr against
    rrt_tpu.rng.rr_draw and rrt_tpu.render._apply_rr, bit for bit, over
    bounces 0-50, with one bounce for every lane (the batch driver) and
    a bounce a lane (the queue);
  * the tile driver (render_tiles_reference) against rrt_tpu's tile
    kernel in interpret mode (tests/test_rr.py's case: chap11 16x9, 4
    spp, depth 8, rr_depth 2) by tests/test_torch_slice.py's rule:
    per-pixel max |delta| < 1e-3 on >= 98.5% of pixels, traced totals
    within 1%;
  * the port's tile, queue and batch plain routes within 1e-4 of each
    other (tests/test_rr.py's driver parity);
  * on cornell 12x12, 2 spp, depth 20, rr_depth 3 traces fewer than 0.8
    times the segments of rr_depth 0 (tests/test_rr.py's);
  * the estimator's mean (tests/test_rr.py's unbiased-mean check, over
    as many paths).

Every case asserts that the roulette fired: fewer traced segments than
at rr_depth 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.vec import V3
from rrt_tpu_torch import render, rng

import _torch_helpers as helpers

N = 4096


def _keys(seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (2, N), dtype=np.uint64).astype(np.uint32)


def test_rr_draw_matches_reference():
    keys = _keys(0)
    jk = jnp.asarray(keys)
    tk = torch.from_numpy(keys.astype(np.int64))
    for bounce in range(51):
        a = np.asarray(jrng.rr_draw(jk, bounce))
        b = rng.rr_draw(tk, bounce).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f"bounce {bounce}")
    per_lane = np.random.default_rng(1).integers(0, 51, N)
    a = np.asarray(jrng.rr_draw(jk, jnp.asarray(per_lane, jnp.int32)))
    b = rng.rr_draw(tk, torch.from_numpy(per_lane)).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("rr_depth", [0, 3])
def test_apply_rr_matches_reference(rr_depth):
    """render._apply_rr's throughput and survival bit for bit, the
    attenuation of a dielectric (1) among them, throughputs from below
    the 0.05 clip to above 1."""
    rs = np.random.default_rng(2)
    keys = _keys(3)
    thr = rs.uniform(0.0, 1.5, (3, N)).astype(np.float32)
    att = rs.uniform(0.0, 1.0, (3, N)).astype(np.float32)
    att[:, rs.random(N) < 0.2] = 1.0
    thr[:, rs.random(N) < 0.1] *= 0.01
    survives = rs.random(N) < 0.8
    lane_bounce = rs.integers(0, 51, N)
    fired = 0
    for bounce in [*range(51), lane_bounce]:
        jb = bounce if isinstance(bounce, int) else jnp.asarray(
            bounce, jnp.int32)
        tb = bounce if isinstance(bounce, int) else torch.from_numpy(bounce)
        jt, js = jrender._apply_rr(jnp.asarray(keys), jb, V3(*thr),
                                   V3(*att), jnp.asarray(survives), rr_depth)
        tt, ts = render._apply_rr(torch.from_numpy(keys.astype(np.int64)),
                                  tb, torch.from_numpy(thr),
                                  torch.from_numpy(att),
                                  torch.from_numpy(survives), rr_depth)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tt.numpy(), np.stack([np.asarray(v) for v in (jt.x, jt.y, jt.z)]))
        fired += int((survives & ~ts.numpy()).sum())
    assert (fired > 0) == (rr_depth > 0)


@pytest.fixture(scope="module")
def chap11():
    """rrt_tpu's tile render of tests/test_rr.py's driver-parity case in
    interpret mode, and the port's three plain routes: {name: (image,
    traced)}, the port's at rr_depth 0 too."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RRT_INTERPRET", "1")
    try:
        j_scene, j_cam = jscenes.chap11_scene(16, 9)
        kw = dict(width=16, height=9, spp=4, max_depth=8, queue_size=1024,
                  tile_pixels=16 * 9, samples_per_pass=4, rr_depth=2)
        j_img, j_n = jrender.render_image_tiles(
            j_scene, j_cam, jrender.RenderConfig(**kw), 0)
    finally:
        mp.undo()
    scene, cam = helpers.port(j_scene, j_cam)
    cfg = render.RenderConfig(**kw)
    out = {"rrt_tpu": (np.asarray(j_img), float(j_n))}
    for name, fn in (("tile", render.render_image_tiles),
                     ("queue", render.render_image_queue),
                     ("batch", render.render_image)):
        img, n = fn(scene, cam, cfg, 0, device="cpu")
        out[name] = (img.numpy(), int(n))
    img, n = render.render_image_tiles(
        scene, cam, dataclasses.replace(cfg, rr_depth=0), 0, device="cpu")
    out["off"] = (img.numpy(), int(n))
    return out


def test_tile_matches_reference(chap11):
    a, j_n = chap11["rrt_tpu"]
    b, n = chap11["tile"]
    assert np.isfinite(b).all()
    close = np.abs(a - b).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(n - j_n) / j_n < 1e-2, (n, j_n)
    assert n < chap11["off"][1], (n, chap11["off"][1])


def test_drivers_agree(chap11):
    tile, n = chap11["tile"]
    for name in ("queue", "batch"):
        img, n_d = chap11[name]
        assert np.abs(img - tile).max() < 1e-4, name
        assert n_d == n, name


def test_reduces_traced_rays_on_cornell():
    """Enclosed-box paths run to max_depth without the roulette."""
    scene, cam = helpers.port_scene("cornell", 12, 12)
    cfg = render.RenderConfig(width=12, height=12, spp=2, max_depth=20)
    _, n0 = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    img, n1 = render.render_image_tiles(
        scene, cam, dataclasses.replace(cfg, rr_depth=3), 0, device="cpu")
    assert torch.isfinite(img).all()
    assert int(n1) < 0.8 * int(n0), (int(n0), int(n1))


def test_unbiased_mean():
    """Over 86,016 paths the image with the roulette converges to the
    exact one: tests/test_rr.py's bound, 2% of the mean, far below the
    tens of percent a wrong 1/p weight would shift bounce-2+ energy by.
    test_rr.py traces them as 24x14 at 256 spp; here 384x224 at 1 spp,
    one chunk of the plain tile loop, which takes at most one sample a
    pixel a chunk (its small ops are slow under the suite's workers)."""
    scene, cam = helpers.port_scene("diffuse", 384, 224)
    cfg = render.RenderConfig(width=384, height=224, spp=1, max_depth=12)
    img0, n0 = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    img1, n1 = render.render_image_tiles(
        scene, cam, dataclasses.replace(cfg, rr_depth=2), 0, device="cpu")
    m0, m1 = float(img0.mean()), float(img1.mean())
    assert abs(m1 - m0) / m0 < 0.02, (m0, m1)
    assert int(n1) < int(n0)
