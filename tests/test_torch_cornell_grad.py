"""The Cornell box's gradients through rrt_tpu_torch, against rrt_tpu on
the CPU.

The quad, box and light backwards (ROADMAP Queue A #9.7): diff_step's
quad, box and emission branches, the train chain's and the bounce
chain's plain versions on cornell (six quads, two boxes rotated about
Y, a light) and on scenes.book2.mixed_scene (spheres, quads, boxes and a
light together, built with the same calls in both packages), at 16x16
or less, 1-2 spp, depth 4 or less. The CUDA kernels are held to these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py
[K3]). Rules:

  * diff_step against rrt_tpu's _make_diff_step on the same rows and
    constants (both plain float32 code with the same operations):
    outputs within 1e-6 of each row's largest, the VJPs within 1e-5 of
    each input's largest gradient (tests/test_torch_diff_step.py);
  * the train chain against rrt_tpu's scan: in
    tests/test_torch_cornell_train_grad.py;
  * the bounce chain's plain version (chain_adjoint_reference) against
    the port's checkpointed scan on the same rays: the same physics, so
    within 1e-4 of each field's largest gradient;
  * the winner codes round trip, and the plain backward's replay finds
    every stored winner (replay_mismatches 0)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu.ops.megakernel_vjp as jmkv
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu_torch import convert, diff, geometry, gradcheck, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import SceneBuilder
from rrt_tpu_torch.scenes import book2

N = 512
MIX = np.array([1.0, 0.7, 0.3], np.float32)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _both(name, w, h):
    """(rrt_tpu's scene and camera, the port's carried across)."""
    if name == "mixed":
        j_scene, j_cam = book2.mixed_scene(w, h, JBuilder, JCamera)
    else:
        j_scene, j_cam = jscenes.SCENES[name](w, h)
    return (j_scene, j_cam), (convert.scene_from_numpy(_leaves(j_scene)),
                              convert.camera_from_numpy(_leaves(j_cam)))


# ---------------------------------------------------------------------------
# diff_step's quad, box and emission branches
# ---------------------------------------------------------------------------


def _solid_lanes(seed):
    """Rows and constants of N lanes, each won by a sphere, a quad or a
    box (a third each), some of them lights seen from either side."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    fam = rs.integers(0, 3, N)  # 0 sphere, 1 quad, 2 box
    o = rs.uniform(-6, 6, (3, N))
    # A sphere, a quad and a box a lane, around the point it aims at.
    aim = rs.uniform(-2, 2, (3, N))
    d = (aim + rs.uniform(-0.3, 0.3, (3, N)) - o) * rs.uniform(0.5, 2.0, N)
    r = rs.uniform(0.5, 1.5, N)
    sel_s = np.zeros((24, N))
    sel_s[0:3], sel_s[3], sel_s[18] = aim, r * r, r
    a = (d * d).sum(0)
    hb = (o * d).sum(0) - (d * aim).sum(0)
    cc = (o * o).sum(0) - 2 * (o * aim).sum(0) + (aim * aim).sum(0) - r * r
    t_s = (-hb - np.sqrt(np.maximum(hb * hb - a * cc, 0.0))) / a
    # Quads through the aim point, in rrt_tpu's pack layout.
    u = rs.normal(size=(3, N))
    v = rs.normal(size=(3, N))
    q = aim - 0.5 * u - 0.5 * v
    quad = torch.from_numpy(np.concatenate(
        [q, u, v, np.ones((1, N)), np.zeros((14, N))]).astype(f32))
    sel_q = tmk.quad_frame_pack(quad).numpy().astype(np.float64)
    n = sel_q[0:3]
    t_q = (sel_q[9] - (o * n).sum(0)) / (d * n).sum(0)
    # Boxes rotated about Y around the aim point: the slab's entry t.
    half = rs.uniform(0.5, 1.5, (3, N))
    ang = rs.uniform(0, 2 * np.pi, N)
    cth, sth = np.cos(ang), np.sin(ang)
    sel_b = np.zeros((24, N))
    sel_b[0:3], sel_b[3:6], sel_b[6], sel_b[7] = aim, half, cth, sth
    w = o - aim
    ob = np.stack([cth * w[0] - sth * w[2], w[1], sth * w[0] + cth * w[2]])
    db = np.stack([cth * d[0] - sth * d[2], d[1], sth * d[0] + cth * d[2]])
    t1, t2 = (-half - ob) / db, (half - ob) / db
    t_b = np.minimum(t1, t2).max(axis=0)
    t_hit = np.where(fam == 0, t_s, np.where(fam == 1, t_q, t_b))

    mtype = rs.integers(0, 3, N)
    aux = np.where(mtype == 2, rs.uniform(1.3, 1.8, N),
                   np.where(rs.random(N) < 0.3, 0.0, rs.uniform(0, 1, N)))
    for sel, row in ((sel_s, 9), (sel_b, 10)):
        sel[row - 1], sel[row] = mtype, aux
        sel[row + 1:row + 7] = rs.uniform(0, 1, (6, N))
    sel_q[14], sel_q[15] = mtype, aux
    sel_q[16:22] = rs.uniform(0, 1, (6, N))
    g = rs.normal(size=(6, N))
    unit = g[0:3] / np.linalg.norm(g[0:3], axis=0)
    sph = g[3:6] / np.linalg.norm(g[3:6], axis=0) * rs.random(N) ** (1 / 3)
    hit = rs.random(N) < 0.9
    light = hit & (rs.random(N) < 0.2)
    consts = dict(
        t_hit=t_hit.astype(f32), hit=hit, miss=~hit,
        survives=hit & ~light & (rs.random(N) < 0.9),
        front=rs.random(N) < 0.6, degen=rs.random(N) < 0.05,
        do_reflect=rs.random(N) < 0.4, use_c2=rs.random(N) < 0.5,
        is_lam=mtype == 0, is_met=mtype == 1, is_die=mtype == 2,
        use_q=fam == 1, use_b=fam == 2, is_light=light)
    draws = [x.astype(f32) for x in (*unit, *sph, rs.random(N))]
    state = np.concatenate([o, d, rs.random((1, N)), rs.uniform(0, 1, (3, N)),
                            rs.uniform(0, 0.5, (3, N))]).astype(f32)
    sels = [x.astype(f32) for x in (sel_s, sel_q, sel_b)]
    return state, sels, rs.uniform(0, 1, (6, N)).astype(f32), consts, draws


@pytest.mark.parametrize("is_sky", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_diff_step_solids_match_reference(seed, is_sky):
    """The quad, box and emission branches against rrt_tpu's
    _make_diff_step under jax.vjp (boxes rotated about Y), lights hit
    from either side among the lanes."""
    state, sels, bg6, consts, draws = _solid_lanes(seed)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    jc.update(draws=tuple(jnp.asarray(x) for x in draws),
              is_sky=jnp.asarray(is_sky))
    g = jmkv._make_diff_step(jc, moving=False, has_quads=True,
                             has_boxes=True, has_rot_boxes=True,
                             has_perlin=False, has_images=False, img_ah=1,
                             img_aw=1)
    ins = [*state, *sels, *bg6]
    j_out, vjp = jax.vjp(g, *[jnp.asarray(x) for x in ins])
    cot = np.random.default_rng(seed + 7).normal(size=(13, N)).astype(
        np.float32)
    j_grads = vjp(tuple(jnp.asarray(x).reshape(jo.shape)
                        for x, jo in zip(cot, j_out)))
    tc = {k: torch.from_numpy(v) for k, v in consts.items()}
    tc.update(draws=tuple(torch.from_numpy(x) for x in draws),
              is_sky=torch.tensor(is_sky))
    t_ins = [torch.from_numpy(x.copy()).requires_grad_() for x in ins]
    t_out = tmkv.diff_step(tc, *t_ins, moving=False, has_quads=True,
                           has_boxes=True)
    t_grads = torch.autograd.grad(
        t_out, t_ins, [torch.from_numpy(x) for x in cot], allow_unused=True)
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        jo = np.broadcast_to(np.asarray(jo).reshape(-1), (N,))
        to = np.broadcast_to(to.detach().numpy(), (N,))
        scale = max(np.abs(jo).max(), 1e-6)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"output row {i}")
    for i, (jg, tg, x) in enumerate(zip(j_grads, t_grads, t_ins)):
        jg = np.asarray(jg).reshape(x.shape)
        tg = np.zeros(x.shape, np.float32) if tg is None else tg.numpy()
        assert np.isfinite(tg).all(), f"input {i}"
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"input {i}")
    # Every family's rows are reached: the quad's frame normal and
    # d_plane, the box's center, half extents and rotation, the colors
    # (the lights' through their emission).
    d_q, d_b = t_grads[14].abs().sum(dim=1), t_grads[15].abs().sum(dim=1)
    for row in (0, 1, 2, 9, 15, 16, 17, 18, 19, 20, 21):
        assert d_q[row] > 0, ("quad", row)
    for row in range(8):
        assert d_b[row] > 0, ("box", row)
    light = consts["is_light"] & consts["use_q"]
    assert t_grads[14][16:19, torch.from_numpy(light)].abs().sum() > 0


def test_quad_frame_vjp_matches_autograd():
    """geometry.quad_frame_vjp, the transpose the CUDA backwards' host
    side applies to their frame cotangents, against autograd through
    geometry.quad_frames."""
    rs = np.random.default_rng(5)
    q, u, v = (torch.from_numpy(rs.normal(size=(3, 64)).astype(np.float64))
               .requires_grad_() for _ in range(3))
    g_n = torch.from_numpy(rs.normal(size=(3, 64)))
    g_p = torch.from_numpy(rs.normal(size=64))
    fr = geometry.quad_frames(q, u, v)
    auto = torch.autograd.grad((fr.n * g_n).sum() + (fr.d_plane * g_p).sum(),
                               (q, u, v))
    for a, b in zip(geometry.quad_frame_vjp(q.detach(), u.detach(),
                                            v.detach(), g_n, g_p), auto):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The winner codes and the replay
# ---------------------------------------------------------------------------


def test_winner_codes_round_trip():
    """A sphere's slot, QUAD_CODE + a quad's, BOX_CODE + a box's, -1 a
    miss (CODE_SPAN codes a family after the spheres'): every code fits
    an int16 and decodes to its family and slot."""
    fam = torch.tensor([geometry.FAM_SPHERE, geometry.FAM_SPHERE,
                        geometry.FAM_QUAD, geometry.FAM_QUAD, geometry.FAM_BOX,
                        geometry.FAM_BOX, geometry.FAM_NONE])
    idx = torch.tensor([0, tmk.MAX_SLOTS - 1, 0, tmk.CODE_SPAN - 1, 0,
                        tmk.CODE_SPAN - 1, 0])
    code = tmk.encode_winner(fam, idx)
    assert code.tolist() == [0, 3071, 3072, 11263, 11264, 19455, -1]
    assert int(code.max()) <= torch.iinfo(torch.int16).max
    f2, i2 = tmk.decode_winner(code.to(torch.int16))
    assert torch.equal(f2, fam)
    assert torch.equal(i2[:-1], idx[:-1]) and int(i2[-1]) == -1


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_winners_and_replay(name):
    """The plain forward's pooled winner codes equal the backward's
    replay's (gradcheck.replay_winners), every family among them; the
    plain backward finds every stored winner (replay_mismatches 0, with
    the winners and without), and a stored winner of another family
    counts one mismatch."""
    w, h, spp, depth = 12, 12, 2, 4
    _, (scene, cam) = _both(name, w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, "cpu")]
    solids = tmk.pack_solids(scene)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=False, solids=solids)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref = tmk.render_tiles(*packs, **kw)
    assert torch.equal(rad, ref[0]) and torch.equal(traced, ref[1])
    replayed = gradcheck.replay_winners(
        *packs, win_cap=winners.shape[0], **kw)
    assert torch.equal(winners, replayed)
    fam, _ = tmk.decode_winner(winners[winners > -2])
    for f in (geometry.FAM_QUAD, geometry.FAM_BOX, geometry.FAM_NONE) + (
            (geometry.FAM_SPHERE,) if name == "mixed" else ()):
        assert bool((fam == f).any()), f
    d_rad = torch.ones_like(rad)
    tmkt.tiles_adjoint.replay_mismatches = 0
    a = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    b = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    assert int(a[3]) == 0 and int(b[3]) == 0
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    bad = winners.clone()
    at = (bad >= tmk.QUAD_CODE) & (bad < tmk.BOX_CODE)
    j, p = [int(i) for i in at.nonzero()[0]]
    bad[j, p] = tmk.BOX_CODE
    got = tmkt.tiles_adjoint(*packs, d_rad, lengths, bad, **kw)
    assert int(got[3]) == 1


def test_tie_gaps_reads_solid_winners():
    """gradcheck.tie_gaps on a differing entry whose winners are a box and
    the wall behind it: the plain replay finds the box, and the two t
    are far apart (no near-tie), in float64."""
    w, h = 12, 12
    _, (scene, cam) = _both("cornell", w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=2)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, "cpu")]
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=1,
              max_depth=2, t_min=1e-3, moving=False,
              solids=tmk.pack_solids(scene))
    winners = tmkt.render_tiles_train(*packs, **kw)[3]
    pixel = int((winners[0] >= tmk.BOX_CODE).nonzero()[0])
    box = int(winners[0, pixel])
    back = tmk.QUAD_CODE + 5  # the back wall, behind both boxes
    differ = torch.tensor([[0, 0, pixel, back, box]])
    ties = gradcheck.tie_gaps(packs, kw, differ)
    assert int(ties.replayed[0]) == box
    assert torch.isfinite(ties.gap).all() and float(ties.gap[0]) > 0.1
    assert float(ties.ulps[0]) > 1.0


# ---------------------------------------------------------------------------
# The train chain and the bounce chain against the references
# ---------------------------------------------------------------------------


def _field_grads(out, params, cot):
    gs = torch.autograd.grad(out, list(params.values()), cot,
                             allow_unused=True)
    return {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
            for (k, v), g in zip(params.items(), gs)}


def _assert_fields(got, exp, fields, tol):
    for k in fields:
        a, b = got[k], np.asarray(exp[k])
        assert np.isfinite(a).all(), k
        atol = tol * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_chain_reference_matches_scan(name):
    """render.trace_batch_fused (the bounce chain: chain_adjoint_reference
    on the CPU) against the port's checkpointed scan on the same camera
    rays, depth 4: the gradients of every partition() field."""
    w, h, depth = 16, 16, 4
    _, (scene, cam) = _both(name, w, h)
    ids = torch.arange(w * h)
    px, py = ids % w, ids // w
    keys = rng.sample_keys(rng.key_words(0), py * w + px, 0)
    cot = torch.from_numpy(
        (MIX[:, None] * np.sin(np.arange(w * h) * 0.1)).astype(np.float32))
    grads, rads = [], []
    for fused in (True, False):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in diff.partition(scene).items()}
        o, d, tm = render.generate_rays(cam, px, py, w, h, keys)
        tmkv.chain_adjoint.replay_mismatches = 0
        rad, _ = render.trace_batch(diff.combine(scene, params), o, d, tm,
                                    keys, depth, 1e-3, differentiable=True,
                                    fused_vjp=fused)
        rads.append(rad.detach())
        grads.append(_field_grads(rad, params, cot))
        if fused:
            assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    torch.testing.assert_close(rads[0], rads[1], rtol=0, atol=1e-5)
    _assert_fields(grads[0], grads[1], grads[1], 1e-4)
    assert np.abs(grads[1]["tex_color1"]).max() > 0
    if name == "mixed":
        assert np.abs(grads[1]["quad_q"]).max() > 0
        assert np.abs(grads[1]["box_center"]).max() > 0


def test_light_emits_from_behind():
    """A diffuse_light quad seen from behind emits, as rrt_tpu's
    _one_bounce does (no face test): the camera sees its back, and the
    train chain's gradient of its color is the plain forward's
    autograd one."""
    w = h = 8
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    b.quad((-1.0, -1.0, 0.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0),
           b.diffuse_light((4.0, 3.0, 2.0)))  # faces +z
    scene = b.build()
    cam = Camera.create(look_from=(0.0, 0.0, -3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=1.0)
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=2)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    np.testing.assert_array_equal(rad.detach().numpy()[w * h // 2 + w // 2],
                                  [4.0, 3.0, 2.0])
    got = _field_grads(rad.sum(), params, None)
    params2 = {k: v.detach().clone().requires_grad_()
               for k, v in diff.partition(scene).items()}
    s2 = diff.combine(scene, params2)
    packs = render._packs(s2, cam, cfg, "cpu")
    plain, _ = tmk.render_tiles_reference(
        *packs, seed_words=rng.key_words(0), sample_lo=0, width=w, height=h,
        spp=1, max_depth=2, t_min=1e-3, moving=False,
        solids=tmk.pack_solids(s2))
    exp = _field_grads(plain.sum(), params2, None)
    assert np.abs(exp["tex_color1"]).max() == w * h
    _assert_fields(got, exp, ("tex_color1", "quad_q", "quad_u"), 1e-6)


def test_out_of_scope_still_raises():
    """Media on chain_bwd and more than MAX_TRAIN_MEDIA media on the
    train kernels stay outside the backwards, raising with their ROADMAP
    items; more quads than SOLID_CAP are in both backwards' scopes (the
    train kernels' since #9.5's rest, chain_bwd's since its chain part),
    as the perlin and image textures are, and Russian roulette since
    #9.6; cornell's train route renders with it."""
    (_, _), (smoke, smoke_cam) = _both("cornell_smoke", 8, 8)
    cornell, cornell_cam = tscenes.cornell_box_scene(8, 8)
    cfg = render.RenderConfig(width=8, height=8, spp=1, max_depth=2)
    assert tmkv.backward_scope_gap(smoke)[1] == "#9.4"
    assert tmkt.train_scope_gap(smoke) is None
    assert tmkv.backward_scope_gap(cornell) is None
    assert tmkt.train_scope_gap(cornell) is None
    perlin = dataclasses.replace(cornell, n_quads_active=tmk.SOLID_CAP + 1)
    assert tmkv.backward_scope_gap(perlin) is None
    assert tmkt.train_scope_gap(perlin) is None
    render._check_chain_card_scope("render_image(differentiable=True)",
                                   perlin, "cuda")
    fog = SceneBuilder()
    for i in range(tmkt.MAX_TRAIN_MEDIA + 1):
        fog.medium_sphere((float(i), 0.0, 0.0), 0.4, 0.5, (0.5, 0.5, 0.5))
    fog = fog.build()
    assert tmkt.train_scope_gap(fog)[1] == "#9.4"
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.trace_tiles_diff(fog, smoke_cam, cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image_diff(fog, smoke_cam, cfg, 0, device="cuda")
    rad, n = render.trace_tiles_diff(
        cornell, cornell_cam, dataclasses.replace(cfg, rr_depth=1), 0,
        device="cpu")
    assert torch.isfinite(rad).all() and int(n) >= 8 * 8
