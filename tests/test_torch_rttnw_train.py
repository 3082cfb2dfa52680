"""rttnw_final's train kernels' plain versions on the CPU (split from
tests/test_torch_rttnw_grad.py, which holds the codes and the gradient
against rrt_tpu, to keep each file's time on one worker down): the
plain train forward's pooled winners against gradcheck.replay_winners,
the train route that render_image_diff and the train steps take, and
the plain backward's rebuilt radiance against its forward."""

import torch

from rrt_tpu_torch import diff, geometry, gradcheck, render
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

W, H, SPP, DEPTH = 16, 8, 1, 8
T_MIN = 1e-3


def _train_kw(scene, **over):
    kw = dict(seed_words=(0, 0), sample_lo=0, width=W, height=H, spp=SPP,
              max_depth=DEPTH, t_min=T_MIN, moving=scene.has_moving,
              solids=tmk.pack_solids(scene), tex=tmk.pack_textures(scene))
    kw.update(over)
    return kw


def test_plain_train_forward_pools_the_replay_winners():
    """The plain train forward on rttnw_final: tile_render's plain
    version's radiance and traced counts, and pooled winner codes equal
    to gradcheck.replay_winners' (the backward's replay), boxes past
    slot 63 among them; its backward replays them with no mismatch."""
    scene, cam = tscenes.SCENES["rttnw_final"](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, "cpu")]
    kw = _train_kw(scene)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = tmk.render_tiles_reference(*packs, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    expected = gradcheck.replay_winners(
        *packs, win_cap=tmkt.winner_capacity(SPP),
        **{k: v for k, v in kw.items() if k != "tex"})
    assert torch.equal(winners, expected)
    fam, idx = tmk.decode_winner(winners[winners >= 0])
    past = (fam == geometry.FAM_BOX) & (idx >= tmk.SOLID_CAP)
    assert int(past.sum()) > 0
    assert set(fam.tolist()) == {geometry.FAM_SPHERE, geometry.FAM_QUAD,
                                 geometry.FAM_BOX, geometry.FAM_MEDIUM}
    out = tmkt.tiles_adjoint(*packs, torch.ones_like(rad), lengths, winners,
                             **kw)
    assert int(out[3]) == 0
    assert out[4].box24[:, tmk.SOLID_CAP:].abs().max() > 0


def test_train_route_takes_rttnw_final(caplog, monkeypatch):
    """The train kernels' scope takes rttnw_final and chain_bwd's does
    not, for its media alone (#9.4; its boxes past SOLID_CAP are in
    chain_bwd's scope): on the CPU render_image_diff and the train
    steps run the train kernels' plain versions (no fallback line), and
    the chunked step's loss is the one-shot step's within 1e-5."""
    scene, cam = tscenes.SCENES["rttnw_final"](8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=2, max_depth=4,
                              samples_per_pass=2)
    assert tmkt.train_scope_gap(scene) is None
    assert render.diff_fallback_reason(scene, cfg) is None
    gap = tmkv.backward_scope_gap(scene)
    assert gap[1] == "#9.4" and "constant media" in gap[0]
    target = torch.zeros((4, 8, 3))
    apply = tmkt.TileTrainChain.apply
    calls = []
    monkeypatch.setattr(tmkt.TileTrainChain, "apply",
                        lambda *a: calls.append(a) or apply(*a))
    img, _ = render.render_image_diff(scene, cam, cfg, 0, device="cpu")
    _, _, loss = diff.make_train_step(cfg, device="cpu")(scene, cam, target,
                                                          1)
    _, _, c_loss = diff.make_train_step_chunked(
        cfg, spp_chunk=1, device="cpu")(scene, cam, target, 1)
    assert len(calls) == 4  # the diff render, the step, the chunked 2
    assert "batch driver's differentiable path" not in caplog.text
    assert torch.isfinite(img).all() and bool(torch.isfinite(loss))
    assert abs(c_loss.item() - loss.item()) <= 1e-5 * loss.item()


def test_plain_rebuild_keeps_the_forwards_marble():
    """The plain backward rebuilds each bounce under autograd
    (megakernel_vjp.diff_step) from the replay's records; its radiance is
    the forward's on every path of rttnw_final at 200x134, depth 8. A
    box's rebuilt t once took another rounding than the forward's slab
    test, and the marble (sphere 131, 80 units wide, hundreds of units
    out: 10 turb(p), whose last octave varies over 1/64 of a unit)
    turned that into another albedo a few bounces later (2 of these
    26,800 paths, by up to 1.7e-3; on the card one path 13 times dark):
    diff_step now takes the kernels' slab arithmetic."""
    from rrt_tpu_torch import rng
    from rrt_tpu_torch.camera import thin_lens_rays
    w, h, depth = 200, 134, 8
    scene, cam = tscenes.SCENES["rttnw_final"](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    sph24, cam24, bg8 = [p.detach() for p in render._packs(scene, cam, cfg,
                                                           "cpu")]
    solids, tex = tmk.pack_solids(scene), tmk.pack_textures(scene)
    fwd, _ = tmk.render_tiles_reference(
        sph24, cam24, bg8, **_train_kw(scene, width=w, height=h,
                                       max_depth=depth))
    pix = torch.arange(w * h)
    keys = rng.sample_keys((0, 0), pix, 0)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                              pix % w, pix // w, w, h, keys)
    records, _, _ = tmkv.replay_steps(
        tmk._scene_from_packs(sph24, bg8, True, solids, tex), o, d, tm, keys,
        torch.zeros_like(pix), depth + 1, max_depth=depth, t_min=T_MIN)
    quads, boxes, media = tmkv.solid_leaves(solids)
    frames = tmk.quad_frame_pack(quads)
    state = tmkv.camera_ray_rows(cam24, (pix % w).float(),
                                 (pix // w).float(), rng.camera_draws(keys))
    state = state + (torch.ones_like(state[0]),) * 3
    rebuilt = torch.zeros((3, w * h))
    for r in records:
        state = tuple(row[r["sel"]] for row in state)
        zero = torch.zeros_like(state[0])
        sel, flags = tmkv.winner_rows(r, sph24, frames, boxes, media, tex)
        out = tmkv.diff_step(
            tmkv.step_constants(r, sph24, bg8, solids), *state, zero, zero,
            zero, *sel, *bg8[:6], tmkv.atlas_leaf(tex), moving=True,
            t_min=T_MIN, **flags)
        rebuilt[:, r["cur"]] += torch.stack(out[10:13]).detach()
        state = out[:10]
    torch.testing.assert_close(rebuilt.T, fwd, rtol=0, atol=1e-5)
    assert fwd.abs().max() > 0
