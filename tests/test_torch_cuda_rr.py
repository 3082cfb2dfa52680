"""Russian roulette on the card: the five shading kernels with rr_depth
against their plain versions (marked `cuda`; skip without a CUDA
device). Imports neither JAX nor rrt_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rr.py -q

Each kernel is held to the rule tests/test_torch_cuda.py holds it to at
rr_depth 0, here with rr_depth 2 on chap12 (spheres), cornell (quads,
boxes, a light) and cornell_smoke (constant media, whose albedo the
coin's p sees), and each case checks that the roulette fired: fewer
segments than at rr_depth 0. An rr_depth past every path's length gives
rr_depth 0's outputs bit for bit."""

import dataclasses

import pytest
import torch

from rrt_tpu_torch import diff, gradcheck, render
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

from test_torch_cuda import (_MIX, _assert_close, _scene, _solid_case,
                             _solid_lanes, device)  # noqa: F401 (a fixture)

pytestmark = pytest.mark.cuda

RR = 2
SCENES = ["chap12", "cornell", "cornell_smoke"]


def _case(device, name, depth=8):
    """(scene, camera, cfg, packs, sphere BVH, render_tiles keywords with
    rr_depth RR) of a scene at 64x32, 4 spp."""
    scene, cam = _scene(name, 64, 32)
    packs, bvh, _, kw = _solid_case(device, name, depth=depth)
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=depth)
    return scene, cam, cfg, packs, bvh, dict(kw, moving=scene.has_moving,
                                             rr_depth=RR)


@pytest.mark.parametrize("name", SCENES)
def test_tile_render_matches_plain_version(device, name):
    _, _, _, packs, bvh, kw = _case(device, name, depth=50)
    before = tmk.render_tiles.launches
    out = tmk.render_tiles(*packs, bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)
    off = tmk.render_tiles(*packs, bvh=bvh, **dict(kw, rr_depth=0))
    assert int(out[1].sum()) < int(off[1].sum())
    late = tmk.render_tiles(*packs, bvh=bvh, **dict(kw, rr_depth=51))
    assert torch.equal(late[0], off[0]) and torch.equal(late[1], off[1])


@pytest.mark.parametrize("name", SCENES)
def test_train_fwd_equals_tile_render(device, name):
    """train_fwd's scan and tile_render's walk trace the same paths with
    the roulette too, bit for bit; its lengths count a killed path's last
    bounce, and an rr_depth past every path gives rr_depth 0's residual."""
    _, _, _, packs, bvh, kw = _case(device, name, depth=50)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = tmk.render_tiles(*packs, bvh=bvh, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)
    late = tmkt.render_tiles_train(*packs, **dict(kw, rr_depth=51))
    off = tmkt.render_tiles_train(*packs, **dict(kw, rr_depth=0))
    for a, b in zip(late[:3], off[:3]):
        assert torch.equal(a, b)
    # The kernel leaves the winner entries past a pixel's segments as they
    # were: compare the written ones.
    written = (torch.arange(off[3].shape[0], device=device)[:, None]
               < off[1][None, :])
    assert torch.equal(late[3][written], off[3][written])


@pytest.mark.parametrize("name", SCENES)
def test_train_bwd_matches_plain_version(device, name):
    """tests/test_torch_cuda.py's rule (gradcheck: the agreeing pixels,
    field_grad_faults), no replay mismatch from the winners or without
    them: the replay redraws the coin."""
    scene, cam, cfg, packs, _, kw = _case(device, name)
    _, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    weight = torch.sin(torch.arange(64 * 32, device=device) * 0.1) \
        * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    before = tmkt.tiles_adjoint.launches
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    scan = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, None,
                                     **kw)
    assert tmkt.tiles_adjoint.launches == before + 2
    assert int(k[3]) == 0 and int(scan[3]) == 0 and int(p[3]) == 0
    assert torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    assert pp["tex_color1"].abs().max() > 0


def _lanes(device, name, pre_steps):
    """_solid_lanes' state after pre_steps kernel bounce steps at rr_depth
    RR, so that the next steps start past it."""
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, name)
    kw = dict(max_depth=50, t_min=1e-3, moving=False, solids=solids,
              rr_depth=RR)
    tmk.bounce_steps(st, keys, sph, bg, bvh=bvh, k_steps=pre_steps, **kw)
    return st, keys, sph, bg, bvh, kw


@pytest.mark.parametrize("name", SCENES)
def test_bounce_steps_matches_plain_version(device, name):
    """tests/test_torch_cuda.py's rule: alive agrees on >= 99.9% of
    lanes; on those traced and bounce are equal, throughput and pending
    radiance within 1e-3 on >= 99.5%."""
    st, keys, sph, bg, bvh, kw = _lanes(device, name, 2)
    before = tmk.bounce_steps.launches
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, k_steps=4,
                           **kw)
    torch.cuda.synchronize(device)
    assert tmk.bounce_steps.launches == before + 1
    ref = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, k_steps=4,
                                     **kw)
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.float().mean() >= 0.999
    assert torch.equal(out[15][agree], ref[15][agree])
    assert torch.equal(out[13][agree], ref[13][agree])
    close = ((out[7:13] - ref[7:13]).abs() < 1e-3).all(dim=0)[agree]
    assert close.float().mean() >= 0.995
    off = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, k_steps=4,
                           **dict(kw, rr_depth=0))
    assert int(out[15].sum()) < int(off[15].sum())


@pytest.mark.parametrize("name", ["chap12", "cornell"])
def test_chain_bwd_matches_plain_version(device, name):
    """tests/test_torch_cuda.py's chain rule on 12 steps from the state 3
    steps in: the input cotangent within 1e-3 of each row's largest on
    >= 99.5% of the agreeing lanes, the packs' within 1e-3 of their
    largest; the replay redraws the coin, so no mismatch."""
    st, keys, sph, bg, bvh, kw = _lanes(device, name, 3)
    kw = dict(kw, k_steps=12)
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_out = torch.randn((16, st.shape[1]), generator=gen).to(device) * agree
    before = tmkv.chain_adjoint.launches
    k = tmkv.chain_adjoint(st, keys, sph, bg, d_out,
                           out[tmk.ROW_BOUNCE].clone(), bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmkv.chain_adjoint.launches == before + 1
    p = tmkv.chain_adjoint_reference(st, keys, sph, bg, d_out,
                                     ref_out[tmk.ROW_BOUNCE].clone(), **kw)
    assert int(k[3]) == 0 and int(p[3]) == 0
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    assert lane_ok.float().mean() >= 0.995
    got, exp = list(k[1:3]), list(p[1:3])
    if k[4] is not None:
        got += [k[4].quad24, k[4].box24]
        exp += [p[4].quad24, p[4].box24]
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=0,
                                   atol=1e-3 * e.abs().max().item())
    off = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh,
                           **dict(kw, rr_depth=0))
    assert int(out[15].sum()) < int(off[15].sum())


def test_routes_launch_the_kernels(device):
    """Every route with rr_depth launches its kernels on the card: the
    tile, queue and batch drivers, the train step and the differentiable
    batch (bounce_steps and chain_bwd)."""
    scene, cam = _scene("chap12", 64, 32)
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=50,
                              samples_per_pass=2, rr_depth=RR)
    counts = (tmk.render_tiles, tmk.bounce_steps, tmk.intersect_only,
              tmkt.render_tiles_train, tmkt.tiles_adjoint,
              tmkv.chain_adjoint)
    before = [f.launches for f in counts]
    tile, _ = render.render_image_tiles(scene, cam, cfg, 0, device=device)
    queue, _ = render.render_image_queue(scene, cam, cfg, 0, device=device)
    batch, _ = render.render_image(scene, cam, cfg, 0, device=device)
    for img in (queue, batch):
        assert (img - tile).abs().max(dim=2).values.lt(1e-3).float().mean() \
            >= 0.985
    tmkt.tiles_adjoint.replay_mismatches = 0
    _, _, loss = diff.make_train_step(cfg, device=device)(scene, cam, tile, 1)
    assert torch.isfinite(loss)
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    tmkv.chain_adjoint.replay_mismatches = 0
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    img, _ = render.render_image(diff.combine(scene, params), cam,
                                 dataclasses.replace(cfg, spp=2), 0,
                                 differentiable=True, device=device)
    (g,) = torch.autograd.grad(img.sum(), params["tex_color1"])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    assert all(f.launches > b for f, b in zip(counts, before))
