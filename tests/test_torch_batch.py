"""The batch driver (render_image -> render_tile -> trace_batch, with
the intersection through ops.megakernel.intersect_only) against rrt_tpu.

rrt_tpu's render_image runs jit-compiled (its XLA intersection: the
Pallas intersect kernel needs a TPU), the port's op by op. The rules are
those of tests/test_torch_queue.py: diffuse within 1e-5 with traced
totals equal (as tests/test_queue.py holds rrt_tpu's drivers to each
other); chap12 on 98.5% of pixels within 1e-3 and traced totals within
1%, rrt_tpu's own eager-vs-jit spread. The port's batch and tile drivers
trace the same paths through the same plain physics: within 1e-5. The
passes' and the scope's tests are tests/test_torch_batch_passes.py."""

import dataclasses

import numpy as np
import pytest
import torch

from rrt_tpu import render as jrender
from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import render, rng, scenes as tscenes

import _torch_helpers as helpers

W, H, SPP, DEPTH = 48, 27, 4, 8
SIZE = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)
SCENE_SPP = {"diffuse": SPP, "chap12": 2}  # see tests/test_torch_queue.py


@pytest.fixture(scope="module")
def reference_batch():
    out = {}
    for name, spp in SCENE_SPP.items():
        j_scene, j_cam = jscenes.SCENES[name](W, H)
        img, n = jrender.render_image(
            j_scene, j_cam, helpers.batch_cfgs(SIZE, spp=spp)[0], 0)
        out[name] = (np.asarray(img), float(n))
    return out


def _port_batch(name, **kw):
    scene, cam = tscenes.SCENES[name](W, H)
    img, n = render.render_image(scene, cam,
                                 helpers.batch_cfgs(SIZE, **kw)[1], 0,
                                 device="cpu")
    return img.numpy(), int(n)


def test_batch_diffuse_matches_reference(reference_batch):
    ref, n_ref = reference_batch["diffuse"]
    img, n = _port_batch("diffuse")
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=1e-5)
    assert n == n_ref


def test_batch_chap12_matches_reference(reference_batch):
    ref, n_ref = reference_batch["chap12"]
    img, n = _port_batch("chap12", spp=SCENE_SPP["chap12"])
    close = np.abs(img - ref).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(n - n_ref) / n_ref < 1e-2


@pytest.mark.parametrize("name", ["diffuse", "chap12"])
def test_batch_matches_tile_driver(name):
    scene, cam = tscenes.SCENES[name](W, H)
    cfg = helpers.batch_cfgs(SIZE)[1]
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0,
                                             device="cpu")
    img, n = _port_batch(name)
    np.testing.assert_allclose(img, tile.numpy(), atol=1e-5, rtol=1e-5)
    assert n == int(n_tile)


def test_trace_batch_kernel_route_matches_broadcast_route():
    """_shade with packs intersects through intersect_only (its plain
    version here), without through geometry.intersect_spheres, as the
    kernels' plain versions do: the same function, so the same radiance,
    rays and survivors bounce after bounce."""
    scene, cam = tscenes.SCENES["chap12"](W, H)
    n = W * H
    ids = torch.arange(n)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % W, ids // W, W, H, keys)
    alive = torch.ones((n,), dtype=torch.bool)
    packed = render.pack_scene(scene, "cpu")
    for bounce in range(DEPTH):
        a = render._shade(scene, o, d, tm, keys, bounce, alive, 1e-3, DEPTH)
        b = render._shade(scene, o, d, tm, keys, bounce, alive, 1e-3, DEPTH,
                          packed=packed)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        _, o, d, _, alive = a
    assert bounce > 0 and not alive.all()


def test_trace_batch_always_intersects_through_intersect_only(monkeypatch):
    """Called without packs, trace_batch makes them and intersects every
    bounce through intersect_only (on the CPU, its plain version)."""
    from rrt_tpu_torch.ops import megakernel as tmk
    calls = []
    plain = tmk.intersect_only_reference

    def counted(*args, **kwargs):
        calls.append(args[0].shape[1])
        return plain(*args, **kwargs)

    monkeypatch.setattr(tmk, "intersect_only_reference", counted)
    scene, cam = tscenes.SCENES["chap11"](16, 8)
    ids = torch.arange(16 * 8)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % 16, ids // 16, 16, 8, keys)
    rad, n_traced = render.trace_batch(scene, o, d, tm, keys, DEPTH, 1e-3)
    assert calls and all(c == 16 * 8 for c in calls)
    assert torch.isfinite(rad).all() and int(n_traced) >= 16 * 8


def test_spp_not_a_multiple_of_the_pass_raises():
    scene, cam = tscenes.SCENES["diffuse"](8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=3, samples_per_pass=2)
    with pytest.raises(ValueError, match="samples_per_pass"):
        render.render_image(scene, cam, cfg, 0, device="cpu")


def test_differentiable_batch_runs():
    """render_image(differentiable=True) renders the forward's image, and
    its gradient reaches the scene (tests/test_torch_chain.py holds it
    against rrt_tpu)."""
    scene, cam = tscenes.SCENES["diffuse"](8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=2, samples_per_pass=2)
    color = scene.tex_color1.clone().requires_grad_()
    img, n = render.render_image(dataclasses.replace(scene, tex_color1=color),
                                 cam, cfg, 0, differentiable=True,
                                 device="cpu")
    fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(img.detach(), fwd, atol=1e-5, rtol=1e-5)
    assert int(n) == int(n_fwd)
    (g,) = torch.autograd.grad(img.sum(), color)
    assert torch.isfinite(g).all() and g.abs().max() > 0


