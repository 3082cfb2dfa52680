"""The train step's residual and the trainers that bound it, on the CPU:
the plain forward's pooled winners against the backward's replay and
rrt_tpu's intersect, the adjoint given them, gradcheck's readings of
them (tie_gaps, pool_faults), the residual's bytes, and the chunked
trainer and the sample-budget split against the unsplit step (tests
moved from tests/test_torch_train.py, whose docstring states the
tolerances, to keep each file's time on one worker down).

The chunked trainer against the one-shot step, and a sample-budget
split against none: within 1e-5 of each field's largest gradient (the
camera's: of the largest camera gradient)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays
from rrt_tpu_torch import diff, render
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt

import _torch_helpers as helpers


def test_chunked_step_matches_oneshot():
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=4, max_depth=4)
    target = torch.full((8, 16, 3), 0.25)
    tmkt.tiles_adjoint.replay_mismatches = 0
    loss1, gp1, gc1 = diff.loss_and_grads(cfg, scene, cam, target, 0,
                                          device="cpu")
    loss2, gp2, gc2 = diff.loss_and_grads_chunked(cfg, scene, cam, target,
                                                  0, spp_chunk=2,
                                                  device="cpu")
    # Three backwards (one-shot, two chunks), none off its forward's path.
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-6)
    for k in gp1:
        torch.testing.assert_close(gp2[k], gp1[k], rtol=0, atol=1e-5 * max(
            gp1[k].abs().max(), 1e-6), msg=k)
    cam_max = max(float(g.abs().max()) for g in gc1)
    for a, b in zip(gc2, gc1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * cam_max)
    # The steps apply those gradients.
    lr = 0.5
    new_scene, new_cam, loss = diff.make_train_step_chunked(
        cfg, lr=lr, spp_chunk=2, device="cpu")(scene, cam, target, 0)
    assert float(loss) == float(loss2)
    torch.testing.assert_close(new_scene.tex_color1,
                               scene.tex_color1 - lr * gp2["tex_color1"])
    torch.testing.assert_close(new_cam.look_from,
                               cam.look_from - lr * gc2[0])


def test_sample_budget_split_matches_unsplit():
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=4, max_depth=4)
    weight = torch.cos(torch.arange(16 * 8 * 3) * 0.3).reshape(-1, 3)

    def grads(budget):
        params, camera = helpers.grad_leaves(scene, cam)
        rad, n = render.trace_tiles_diff(diff.combine(scene, params),
                                         camera, cfg, 0,
                                         sample_budget=budget, device="cpu")
        return (helpers.field_grads((weight * rad).sum(), params, camera),
                int(n))

    (split, n_split), (whole, n_whole) = grads(1), grads(None)
    assert n_split == n_whole
    helpers.assert_fields_close(split, whole, 1e-5, 1e-5)


def _train_kw(w, h, spp, depth, moving=False):
    return dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
                max_depth=depth, t_min=1e-3, moving=moving)


@pytest.mark.parametrize("win_cap", [None, 5])
def test_plain_winners_match_replay(win_cap):
    """The plain forward's winners (render_tiles_train_reference, or
    trace_paths_reference with a pool of 5 entries a pixel, which cuts
    most pixels' later segments) equal those of the backward's plain
    replay (megakernel_vjp.replay_steps) entry for entry: -1 at misses,
    in each pixel's trace order, -2 past its segments; and the camera
    rays' winners equal rrt_tpu's intersect_spheres on rrt_tpu's rays
    with the same keys."""
    from rrt_tpu import geometry as jgeometry
    from rrt_tpu_torch import gradcheck
    j_scene, j_cam = jscenes.chap12_scene(16, 8)
    scene, cam = helpers.port(j_scene, j_cam)
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=8)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = _train_kw(16, 8, 2, 8)
    if win_cap is None:
        win_cap = tmkt.winner_capacity(2)
        rad, traced, lengths, winners = tmkt.render_tiles_train_reference(
            *packs, **kw)
    else:
        rad, traced, lengths, winners = tmk.trace_paths_reference(
            *packs, win_cap=win_cap, **kw)
    assert winners.shape == (win_cap, 16 * 8)
    assert winners.dtype == torch.int16
    torch.testing.assert_close(rad, tmk.render_tiles_reference(*packs,
                                                               **kw)[0],
                               rtol=0, atol=0)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)
    expected = gradcheck.replay_winners(*packs, win_cap=win_cap, **kw)
    assert torch.equal(winners, expected)
    assert (winners == -1).any() and (winners >= 0).any()
    j = torch.arange(win_cap)[:, None]
    assert torch.equal(winners == -2, j >= traced.long()[None, :])
    # Bounce 0 of sample 0 against rrt_tpu's intersect of its own rays.
    ids = jnp.arange(16 * 8, dtype=jnp.int32)
    keys = jrng.sample_keys(jax.random.key(0), ids.astype(jnp.uint32), 0)
    o, d, tm = generate_rays(j_cam, ids % 16, ids // 16, 16, 8, keys)
    n = ids.shape[0]
    j_t, j_idx = jgeometry.intersect_spheres(
        j_scene, o, d, tm, jnp.full((n,), 1e-3), jnp.full((n,), 3e38))
    j_win = np.where(np.asarray(j_t) < 1e38, np.asarray(j_idx), -1)
    np.testing.assert_array_equal(winners[0].numpy(), j_win)


def test_adjoint_reference_with_winners():
    """tiles_adjoint_reference given the forward's winners computes as
    without them (its own replay), bit for bit, with 0 mismatches; a
    stored winner that differs from the replay's counts as one, through
    the CPU wrapper too."""
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=4)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = _train_kw(16, 8, 2, 4)
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_rad = torch.sin(torch.arange(rad.numel()) * 0.3).reshape(rad.shape)
    with_w = tmkt.tiles_adjoint_reference(*packs, d_rad, lengths, winners,
                                          **kw)
    without = tmkt.tiles_adjoint_reference(*packs, d_rad, lengths, None, **kw)
    assert int(with_w[3]) == 0 and int(without[3]) == 0
    for a, b in zip(with_w[:3], without[:3]):
        assert torch.equal(a, b)
    bad = winners.clone()
    pix = (bad[0] >= 0).nonzero()[0, 0].item()
    bad[0, pix] = (bad[0, pix] + 1) % packs[0].shape[1]
    tmkt.tiles_adjoint.replay_mismatches = 0
    got = tmkt.tiles_adjoint(*packs, d_rad, lengths, bad, **kw)
    assert int(got[3]) == 1 and int(tmkt.tiles_adjoint.replay_mismatches) == 1
    for a, b in zip(got[:3], without[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="winners"):
        tmkt.tiles_adjoint(*packs, d_rad, lengths, bad.int(), **kw)


def test_tie_gaps_measures_both_winners_on_the_plain_ray():
    """gradcheck.tie_gaps, the witness chip_smoke.py holds differing
    winners to: a row whose two winners are the plain one has gap 0, a
    row with a miss has gap inf, and a row that names the ground against
    the camera ray's winner has the gap of the two slots' float32 t from
    geometry.intersect_spheres (each slot alone) within the sum of their
    rounding bounds, and each of those t within its own bound of the
    float64 root; its replay retraces the plain winners at every
    bounce."""
    from rrt_tpu_torch import gradcheck
    from rrt_tpu_torch.geometry import intersect_spheres
    from rrt_tpu_torch.ops.megakernel import _scene_from_packs
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=8)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = _train_kw(16, 8, 2, 8)
    plain = gradcheck.sample_agreement(packs, kw).winners  # (spp, d+1, P)
    s, b, p = (plain >= 0).nonzero(as_tuple=True)
    same = torch.stack([s, b, p, plain[s, b, p], plain[s, b, p]], 1).long()
    ties = gradcheck.tie_gaps(packs, kw, same)
    assert same.shape[0] > 100 and b.max() >= 3
    firsts = {}  # (sample, pixel): its least bounce (rows run by bounce)
    for row in same.tolist():
        firsts.setdefault((row[0], row[2]), row[1])
    got = gradcheck.first_differences(same)[:, :3].tolist()
    assert sorted(map(tuple, got)) == sorted(
        (s_, b_, p_) for (s_, p_), b_ in firsts.items())
    assert torch.equal(ties.replayed, same[:, 4])
    assert bool((ties.gap == 0).all()) and bool((ties.ulps == 0).all())
    missed = same[:5].clone()
    missed[:, 3] = -1
    assert bool(torch.isinf(gradcheck.tie_gaps(packs, kw, missed).gap).all())
    # Bounce 0 of sample 0: the ground (slot 0) against the winner.
    first = same[(same[:, 0] == 0) & (same[:, 1] == 0)
                 & (same[:, 4] > 0)].clone()
    first[:, 3] = 0
    ties = gradcheck.tie_gaps(packs, kw, first)
    sph24, cam24, _ = packs
    o, d, tm = thin_lens_rays_of(cam24, first[:, 2], 16, 8, kw)
    t32, t64, bound = [], [], []
    for col in (3, 4):
        alone = []
        for i, slot in enumerate(first[:, col].tolist()):
            one = sph24.clone()
            one[7] = 0.0
            one[7, slot] = 1.0
            alone.append(intersect_spheres(
                _scene_from_packs(one, None, False), o[:, i:i + 1],
                d[:, i:i + 1], tm[i:i + 1], 1e-3, float("inf"))[0])
        t32.append(torch.cat(alone).double())
        t, e = gradcheck._slot_t64(sph24, o, d, tm, first[:, col], kw)
        t64.append(t)
        bound.append(e)
    hit = t32[0] < 1e38  # geometry's INF is 3e38
    assert int(hit.sum()) >= 5
    for a, b, e in zip(t32, t64, bound):
        assert bool(((a - b).abs() <= e)[hit].all())
    gap32 = (t32[0] - t32[1]).abs()
    gap64 = ties.gap * torch.minimum(*t64)
    assert bool(((gap32 - gap64).abs() <= bound[0] + bound[1])[hit].all())
    assert bool((ties.ulps[hit] > 1.0).all())
    assert bool(torch.isinf(ties.gap[~hit]).all())


def test_pool_faults_count_a_misplaced_winner():
    """gradcheck.pool_faults holds a forward's pooled winners to its
    winners of each sample traced alone: equal for the plain forward on
    the CPU, and one entry moved is one fault."""
    from rrt_tpu_torch import gradcheck
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=3, max_depth=8)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = _train_kw(16, 8, 3, 8)
    _, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.alone.shape == (3, tmkt.WINNERS_PER_SAMPLE, 16 * 8)
    faults, compared = gradcheck.pool_faults(winners, lengths, agreement)
    assert faults == 0 and compared == int(traced.sum())
    pix = int((lengths[0] >= 2).nonzero()[0, 0])
    bad = winners.clone()
    bad[0, pix], bad[1, pix] = winners[1, pix], winners[0, pix]
    n_bad = int(winners[0, pix] != winners[1, pix])
    assert gradcheck.pool_faults(bad, lengths, agreement)[0] == 2 * n_bad
    moved = winners.clone()
    moved[int(lengths[0, pix]), pix] = -7  # sample 1's first entry
    assert gradcheck.pool_faults(moved, lengths, agreement)[0] == 1


def thin_lens_rays_of(cam24, pix, w, h, kw):
    from rrt_tpu_torch import rng
    from rrt_tpu_torch.camera import thin_lens_rays
    keys = rng.sample_keys(kw["seed_words"], pix, kw["sample_lo"])
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    return thin_lens_rays(basis, cam24[18], cam24[19], cam24[20], pix % w,
                          pix // w, w, h, keys)


def test_boundary_residual_bytes_counts_the_winners():
    assert tmkt.boundary_residual_bytes(10, 3) == 10 * 3 * (
        1 + 2 * tmkt.WINNERS_PER_SAMPLE)
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=3, max_depth=4)
    _, _, lengths, winners = tmkt.render_tiles_train(
        *render._packs(scene, cam, cfg, "cpu"), **_train_kw(16, 8, 3, 4))
    assert (lengths.numel() * lengths.element_size()
            + winners.numel() * winners.element_size()
            == tmkt.boundary_residual_bytes(16 * 8, 3))
