"""The constant media's gradients through rrt_tpu_torch (ROADMAP Queue A
#9.4), against rrt_tpu on the CPU.

diff_step's medium branch against rrt_tpu's _make_diff_step(n_media=2)
under jax.vjp; the train chain's plain versions (trace_tiles_diff) on
scenes.book2.media_scene against rrt_tpu's scan with explicit keys
(tests/test_torch_cornell_train_grad.py's pattern), after asserting that
rrt_tpu's med_center and med_neg_inv_density gradients there are not 0;
the replay of medium winners; the white smoke's albedo of cornell_smoke
against central differences; the chain's scope, which leaves media out.
Sizes: 16x16 or less, 1-2 spp, depth 8 or less. Rules:

  * diff_step: outputs within 1e-6 of each row's largest, the VJPs within
    1e-5 of each input's largest gradient, lane by lane (rrt_tpu takes a
    medium's 11 rows as inputs of its own, the port the winner's row of
    the medium pack: the same entries);
  * the train chain against rrt_tpu's scan: pixels whose radiance parts
    by 1e-3 get weight 0, at least 98.5% agree, each field within 2e-3 of
    its largest gradient."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu.ops.megakernel_vjp as jmkv
from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.render import trace_batch as jtrace_batch
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu_torch import convert, diff, gradcheck, render
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scenes import book2

N = 512
MIX = np.array([1.0, 0.7, 0.3], np.float32)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _media_rows():
    """Two medium-pack rows: a sphere boundary, and a box rotated 30
    degrees about Y."""
    rows = np.zeros((2, 24), np.float32)
    rows[0, 1:4], rows[0, 4] = (0.5, 1.0, -0.5), 1.2
    rows[0, 5:8], rows[0, 8:17] = 1.0, np.eye(3).reshape(9)
    rows[0, 17], rows[0, 18], rows[0, 19:22] = -1.0 / 0.7, 1.0, (0.2, 0.4, .9)
    c, s = math.cos(math.radians(30.0)), math.sin(math.radians(30.0))
    rows[1, 0], rows[1, 1:4], rows[1, 4] = 1.0, (-1.5, 0.8, 1.0), 1.0
    rows[1, 5:8] = (0.8, 1.2, 0.6)
    rows[1, 8:17] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]).reshape(9)
    rows[1, 17], rows[1, 18], rows[1, 19:22] = -1.0 / 0.5, 1.0, (.8, .5, .3)
    return rows


def _medium_lanes(seed):
    """Rows and constants of N lanes: a sphere winner or a scatter in one
    of _media_rows' two media (most from outside, some from inside the
    boundary, where t_min clamps the entry)."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    med = _media_rows()
    kind = rs.integers(0, 3, N)  # 0 sphere, 1 medium 0, 2 medium 1
    use_med = kind > 0
    win = np.where(use_med, kind - 1, 0)
    aim = np.where(use_med, med[win, 1:4].T,
                   rs.uniform(-2, 2, (3, N))).astype(np.float64)
    inside = use_med & (rs.random(N) < 0.15)
    away = rs.normal(size=(3, N))
    away *= rs.uniform(3.0, 6.0, N) / np.linalg.norm(away, axis=0)
    o = np.where(inside, aim + 0.1 * rs.normal(size=(3, N)), aim + away)
    d = (aim + rs.uniform(-0.3, 0.3, (3, N)) - o) * rs.uniform(0.5, 2.0, N)
    r = rs.uniform(0.5, 1.5, N)
    sel_s = np.zeros((24, N))
    sel_s[0:3], sel_s[3], sel_s[18] = aim, r * r, r
    a = (d * d).sum(0)
    hb = (o * d).sum(0) - (d * aim).sum(0)
    cc = (o * o).sum(0) - 2 * (o * aim).sum(0) + (aim * aim).sum(0) - r * r
    t_s = (-hb - np.sqrt(np.maximum(hb * hb - a * cc, 0.0))) / a
    mtype = rs.integers(0, 3, N)
    aux = np.where(mtype == 2, rs.uniform(1.3, 1.8, N), rs.uniform(0, 1, N))
    sel_s[8], sel_s[9], sel_s[10:16] = mtype, aux, rs.uniform(0, 1, (6, N))
    g = rs.normal(size=(6, N))
    unit = g[0:3] / np.linalg.norm(g[0:3], axis=0)
    sph = g[3:6] / np.linalg.norm(g[3:6], axis=0) * rs.random(N) ** (1 / 3)
    logu = np.log(np.maximum(rs.random((2, N)), 1e-12)).astype(f32)
    consts = dict(
        t_hit=t_s.astype(f32), hit=np.ones(N, bool), miss=np.zeros(N, bool),
        survives=rs.random(N) < 0.9,
        front=use_med | (rs.random(N) < 0.6), degen=rs.random(N) < 0.05,
        do_reflect=rs.random(N) < 0.4, use_c2=~use_med & (rs.random(N) < .5),
        is_lam=~use_med & (mtype == 0), is_met=~use_med & (mtype == 1),
        is_die=~use_med & (mtype == 2), use_med=use_med,
        is_light=np.zeros(N, bool))
    draws = [x.astype(f32) for x in (*unit, *sph, rs.random(N))]
    state = np.concatenate([o, d, rs.random((1, N)), rs.uniform(0, 1, (3, N)),
                            rs.uniform(0, 0.5, (3, N))]).astype(f32)
    return (state, sel_s.astype(f32), med, win, logu,
            rs.uniform(0, 1, (6, N)).astype(f32), consts, draws)


@pytest.mark.parametrize("seed", [0, 1])
def test_diff_step_media_match_reference(seed):
    """diff_step's medium branch (a sphere boundary and a rotated box
    one, entered from outside and from inside) against rrt_tpu's
    _make_diff_step(n_media=2) under jax.vjp."""
    state, sel_s, med, win, logu, bg6, consts, draws = _medium_lanes(seed)
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    jc.update(draws=tuple(jnp.asarray(x) for x in draws),
              is_sky=jnp.asarray(True),
              win_med=jnp.asarray(win.astype(np.float32)),
              med_is_sph=[bool(med[m, 0] < 0.5) for m in range(2)],
              med_rot=[tuple(float(x) for x in med[m, 8:17])
                       for m in range(2)],
              med_logu=[jnp.asarray(logu[m]) for m in range(2)])
    g = jmkv._make_diff_step(jc, moving=False, has_quads=False,
                             has_boxes=False, has_rot_boxes=False,
                             has_perlin=False, has_images=False, img_ah=1,
                             img_aw=1, n_media=2, t_min=1e-3)
    med_ins = [np.full(N, med[m, col], np.float32) for m in range(2)
               for col in tmkv.MED_COLS]
    ins = [*state, sel_s, *bg6, *med_ins]
    j_out, vjp = jax.vjp(g, *[jnp.asarray(x) for x in ins])
    cot = np.random.default_rng(seed + 7).normal(size=(13, N)).astype(
        np.float32)
    j_grads = vjp(tuple(jnp.asarray(x).reshape(jo.shape)
                        for x, jo in zip(cot, j_out)))

    tc = {k: torch.from_numpy(v) for k, v in consts.items()}
    tc.update(draws=tuple(torch.from_numpy(x) for x in draws),
              is_sky=torch.tensor(True),
              med_logu=torch.from_numpy(np.take_along_axis(
                  logu, win[None], 0)[0]))
    sel_m = torch.from_numpy(med[win].T.copy())
    t_ins = [torch.from_numpy(x.copy()).requires_grad_()
             for x in (*state, sel_s)]
    t_ins += [sel_m.requires_grad_()]
    t_ins += [torch.from_numpy(x.copy()).requires_grad_() for x in bg6]
    t_out = tmkv.diff_step(tc, *t_ins, moving=False, has_media=True,
                           t_min=1e-3)
    t_grads = torch.autograd.grad(
        t_out, t_ins, [torch.from_numpy(x) for x in cot], allow_unused=True)
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        jo = np.broadcast_to(np.asarray(jo).reshape(-1), (N,))
        to = np.broadcast_to(to.detach().numpy(), (N,))
        scale = max(np.abs(jo).max(), 1e-6)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"output row {i}")
    # State rows, sel_s and the background: input for input.
    for i in [*range(14), *range(15, 21)]:
        jg = np.asarray(j_grads[i if i < 14 else i - 1]).reshape(
            t_ins[i].shape)
        tg = t_grads[i]
        tg = np.zeros(jg.shape, np.float32) if tg is None else tg.numpy()
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"input {i}")
    # The media: rrt_tpu's per-medium rows, the port's winner's row.
    j_med = np.stack([np.asarray(x).reshape(N) for x in j_grads[20:]])
    j_med = j_med.reshape(2, 11, N)
    t_med = t_grads[14].numpy()[list(tmkv.MED_COLS)]
    lanes = np.arange(N)
    want = j_med[win, :, lanes].T
    other = j_med[1 - win, :, lanes].T
    assert np.abs(other).max() == 0.0
    scale = np.abs(want).max(axis=1, keepdims=True).clip(min=1e-6)
    np.testing.assert_allclose(t_med, want, rtol=0, atol=1e-5 * scale.max())
    use = consts["use_med"]
    assert np.abs(t_med[:, ~use]).max() == 0.0
    # Every column is reached: the center, radius, half extents, density
    # and albedo of each medium.
    for m, cols in ((0, (0, 1, 2, 3, 7, 8, 9, 10)),
                    (1, (0, 1, 2, 4, 5, 6, 7, 8, 9, 10))):
        reached = np.abs(want[:, (win == m) & use]).sum(axis=1)
        for j in cols:
            assert reached[j] > 0, (m, j)


def _params(scene):
    return {k: v.detach().clone().requires_grad_()
            for k, v in diff.partition(scene).items()}


def _field_grads(out, params, cot):
    gs = torch.autograd.grad(out, list(params.values()), cot,
                             allow_unused=True)
    return {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
            for (k, v), g in zip(params.items(), gs)}


def test_train_gradients_match_reference():
    """trace_tiles_diff (the train chain's plain versions) on media_scene
    against rrt_tpu's scan with explicit keys: rrt_tpu's media get
    non-zero gradients there, and the port's match them."""
    w, h, spp, depth = 12, 12, 1, 4
    j_scene, j_cam = book2.media_scene(w, h, JBuilder, JCamera)
    scene = convert.scene_from_numpy(_leaves(j_scene))
    cam = convert.camera_from_numpy(_leaves(j_cam))
    ids = jnp.arange(w * h, dtype=jnp.int32)
    px, py = ids % w, ids // w

    def j_rad(params):
        s = jdiff.combine(j_scene, params)
        tot = jnp.zeros((w * h, 3), jnp.float32)
        for samp in range(spp):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * w + px).astype(jnp.uint32), samp)
            o, d, tm = jgenerate_rays(j_cam, px, py, w, h, keys)
            r, _ = jtrace_batch(s, o, d, tm, keys, depth, 1e-3,
                                differentiable=True)
            tot = tot + jnp.stack([r.x, r.y, r.z], axis=-1)
        return tot

    j_params = jdiff.partition(j_scene)
    ref, vjp = jax.vjp(jax.jit(j_rad), j_params)
    ref = np.asarray(ref)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    params = _params(scene)
    rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    agree = (np.abs(rad.detach().numpy() - ref) < 1e-3).all(axis=1)
    assert agree.mean() >= 0.985, agree.mean()
    wm = (np.sin(np.arange(w * h) * 0.1)[:, None] * MIX * agree[:, None]) \
        .astype(np.float32)
    (gj,) = vjp(jnp.asarray(wm))
    for k in ("med_center", "med_neg_inv_density"):
        assert np.abs(np.asarray(gj[k])).max() > 0, k
    got = _field_grads(rad, params, torch.from_numpy(wm))
    for k in ("med_center", "med_radius", "med_half", "med_neg_inv_density",
              "tex_color1", "sphere_c0", "bg_top"):
        a, b = got[k], np.asarray(gj[k])
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
    assert np.abs(got["med_center"]).max() > 0


def test_replay_finds_medium_winners():
    """On cornell_smoke the plain backward's replay finds every stored
    medium winner (replay_mismatches 0), gradcheck.replay_winners gives
    the forward's winner codes, and tie_gaps reads a medium's t."""
    scene, cam = tscenes.cornell_smoke_scene(8, 8)
    cfg = render.RenderConfig(width=8, height=8, spp=2, max_depth=4)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = dict(seed_words=(0, 0), sample_lo=0, width=8, height=8, spp=2,
              max_depth=4, t_min=1e-3, moving=False,
              solids=tmk.pack_solids(scene))
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    assert (winners >= tmk.MEDIUM_CODE).any()
    d_rad = torch.ones_like(rad)
    out = tmkt.tiles_adjoint_reference(*packs, d_rad, lengths, winners, **kw)
    assert int(out[3]) == 0
    assert out[4].med24[:2, 19:22].abs().max() > 0  # the smoke's albedos
    replayed = gradcheck.replay_winners(
        *packs, win_cap=tmkt.winner_capacity(2), **kw)
    stored = winners != -2
    assert torch.equal(replayed[stored], winners[stored])
    at = (winners >= tmk.MEDIUM_CODE).nonzero()[0]
    row = int(at[0])
    pix = int(at[1])
    first = int(lengths[0, pix])
    s, k = (0, row) if row < first else (1, row - first)
    code = int(winners[row, pix])
    differ = torch.tensor([[s, k, pix, code, code]])
    ties = gradcheck.tie_gaps(packs, kw, differ)
    assert int(ties.replayed[0]) == code
    assert float(ties.gap[0]) == 0.0


def test_smoke_albedo_gradient_matches_central_differences():
    """d loss / d (the white smoke's albedo, red) from the train chain's
    plain backward against central differences of its forward, loss =
    sum(MIX . radiance) in float64 (eps 1e-2 moves no path: the albedo
    scales the throughput only), at 16x16, 2 spp, depth 8, where paths
    scatter in the smoke and reach the light."""
    scene, cam = tscenes.cornell_smoke_scene(16, 16)
    cfg = render.RenderConfig(width=16, height=16, spp=2, max_depth=8)
    tex = int(scene.mat_tex[scene.med_mat[1]])
    assert scene.tex_color1[tex].tolist() == [1.0, 1.0, 1.0]
    mix = torch.from_numpy(MIX)

    def loss(delta):
        color = scene.tex_color1.clone()
        color[tex, 0] += delta
        r, _ = render.trace_tiles(diff.combine(scene, {"tex_color1": color}),
                                  cam, cfg, 0, device="cpu")
        return (r.double() * mix.double()).sum().item()

    params = _params(scene)
    rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    (g,) = torch.autograd.grad((rad * mix).sum(), params["tex_color1"])
    eps = 1e-2
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    auto = g[tex, 0].item()
    assert auto != 0.0
    assert abs(auto - fd) <= 1e-2 * abs(fd), (auto, fd)


def test_the_chain_keeps_media_out():
    """chain_bwd's scope leaves the media out, as rrt_tpu's: its wrapper
    raises naming #9.4 for a medium pack, supports_backward is False, and
    render_image(differentiable=True) on the CPU takes the checkpointed
    scan, whose media gradients are finite."""
    scene, cam = tscenes.cornell_smoke_scene(4, 4)
    assert not tmkv.supports_backward(scene)
    assert tmkt.supports_train(scene)
    solids = tmk.pack_solids(scene)
    st = torch.zeros((16, 4))
    with pytest.raises(NotImplementedError, match="#9.4"):
        tmkv.chain_adjoint(st, torch.zeros((2, 4), dtype=torch.int32),
                           tmk.pack_spheres_full(scene), tmk.pack_bg(scene),
                           st.clone(), torch.zeros(4), k_steps=1,
                           max_depth=4, t_min=1e-3, moving=False,
                           solids=solids)
    cfg = render.RenderConfig(width=4, height=4, spp=2, max_depth=3,
                              samples_per_pass=2)
    params = _params(scene)
    calls = []
    orig = tmkv.BounceChain.apply
    tmkv.BounceChain.apply = lambda *a: calls.append(a) or orig(*a)
    try:
        img, _ = render.render_image(diff.combine(scene, params), cam, cfg,
                                     0, differentiable=True, device="cpu")
    finally:
        tmkv.BounceChain.apply = orig
    assert not calls
    g = torch.autograd.grad(img.sum(), params["tex_color1"])[0]
    assert torch.isfinite(g).all() and g.abs().max() > 0
