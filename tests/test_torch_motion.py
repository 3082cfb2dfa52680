"""Motion blur (book2chap2: chap12's field with moving diffuse spheres,
shutter [0, 1]) in the port against rrt_tpu, on the CPU.

rrt_tpu's Pallas kernels run in interpret mode, as its own tests run
them; the port's kernels run their plain versions. Inputs come from a
seed. Rules, each the one the static scenes' tests use:

  * the scene layout and the packs: bit for bit (tests/test_scenes.py);
  * eager intersect_spheres / make_hit with times: the same op order as
    rrt_tpu.geometry, so the winner on every ray and t within 1e-5
    relative;
  * the tile render: tests/test_torch_slice.py's rule (98.5% of pixels
    within 1e-3, traced totals within 1%);
  * bounce_steps: tests/test_torch_queue.py's; intersect_only: fam and
    idx on every ray, t within 1e-5 relative on at least 80% (ROADMAP
    Queue C: rrt_tpu's jit-compiled quadratic rounds otherwise);
  * gradients, sphere_dc included: tests/test_torch_train.py's and
    tests/test_torch_chain.py's rules, pixels or lanes whose forwards
    part by 1e-3 or more weighted 0;
  * a finite-difference check of one moving sphere's sphere_dc."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rrt_tpu.ops.megakernel as jmk
import rrt_tpu.ops.megakernel_vjp as jmkv
from rrt_tpu import diff as jdiff
from rrt_tpu import geometry as jgeometry
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu.vec import V3
from rrt_tpu_torch import convert, diff, geometry, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import SceneBuilder

W, H = 32, 18
MIX = np.array([1.0, 0.7, 0.3], np.float32)


@pytest.fixture(scope="module")
def interpret_pallas():
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    mp.setattr(jmk.pl, "pallas_call", interp)
    mp.setattr(jmkv.pl, "pallas_call", interp)
    yield
    mp.undo()


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_same(t_obj, j_obj):
    for f in dataclasses.fields(t_obj):
        a, b = getattr(t_obj, f.name), getattr(j_obj, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype != torch.float64, f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("checker", [False, True])
def test_layout_and_packs_match_reference(checker):
    j_scene, j_cam = jscenes.book2chap2_scene(W, H, checker=checker)
    t_scene, t_cam = tscenes.book2chap2_scene(W, H, checker=checker)
    _assert_same(t_scene, j_scene)
    _assert_same(t_cam, j_cam)
    assert t_scene.has_moving and t_scene.n_spheres_active == 484
    assert tmk.scope_gap(t_scene) is None
    n = t_scene.n_spheres
    for t_pack, j_pack in (
            (tmk.pack_spheres_full(t_scene),
             jmk.pack_spheres_full(j_scene)[:, :n]),
            (tmk.pack_camera(t_cam, W, H), jmk.pack_camera(j_cam, W, H)),
            (tmk.pack_bg(t_scene), jmk.pack_bg(j_scene))):
        np.testing.assert_array_equal(t_pack.numpy(), np.asarray(j_pack))


def test_moving_sphere_builder_matches_reference():
    arrays = []
    for b in (SceneBuilder(), JBuilder()):
        mat = b.lambertian((0.3, 0.6, 0.2))
        b.moving_sphere((0.0, 0.2, -1.0), (0.3, 0.7, -1.1), 0.25, 0.75, 0.5,
                        mat)
        b.sphere((0.0, -100.5, -1.0), 100.0, b.metal((0.5, 0.5, 0.5), 0.1))
        arrays.append(b.build())
    _assert_same(*arrays)
    assert arrays[0].has_moving


def _camera_rays(n=1024, seed=0):
    """rrt_tpu's book2chap2 camera rays (times over the shutter [0, 1])
    of pixels 0..n-1 (wrapping) at sample 0, and the port's scene."""
    j_scene, j_cam = jscenes.book2chap2_scene(W, H)
    ids = jnp.arange(n, dtype=jnp.int32)
    px, py = ids % W, (ids // W) % H
    keys = jrng.sample_keys(jax.random.key(seed),
                            (py * W + px).astype(jnp.uint32), 0)
    o, d, tm = generate_rays(j_cam, px, py, W, H, keys)
    return j_scene, o, d, tm, keys


def _rows(v):
    return torch.from_numpy(np.stack([np.asarray(v.x), np.asarray(v.y),
                                      np.asarray(v.z)]))


def test_intersect_and_make_hit_match_reference():
    j_scene, o, d, tm, _ = _camera_rays()
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    n = tm.shape[0]
    assert float(tm.min()) < 0.1 and float(tm.max()) > 0.9
    j_t, j_idx = jgeometry.intersect_spheres(
        j_scene, o, d, tm, jnp.full((n,), 1e-3), jnp.full((n,), 3e38))
    to, td, ttm = _rows(o), _rows(d), torch.from_numpy(np.array(tm))
    t, idx = geometry.intersect_spheres(t_scene, to, td, ttm, 1e-3,
                                        geometry.INF)
    j_t, j_idx = np.asarray(j_t), np.asarray(j_idx)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    hit = j_t < 1e38
    assert hit.sum() > n // 2 and (~hit).any()
    np.testing.assert_allclose(t.numpy()[hit], j_t[hit], rtol=1e-5)
    np.testing.assert_array_equal(t.numpy()[~hit], j_t[~hit])
    fam = np.where(hit, 0, -1).astype(np.int32)
    j_hit = jgeometry.make_hit(j_scene, o, d, tm, jnp.asarray(j_t),
                               jnp.asarray(fam), jnp.asarray(j_idx))
    t_hit = geometry.make_hit(t_scene, to, td, ttm, t,
                              torch.from_numpy(fam), idx)
    np.testing.assert_allclose(t_hit.p.numpy(), _rows(j_hit.p).numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_hit.normal.numpy()[:, hit],
                               _rows(j_hit.normal).numpy()[:, hit],
                               atol=1e-4)
    np.testing.assert_array_equal(t_hit.front_face.numpy()[hit],
                                  np.asarray(j_hit.front_face)[hit])


def test_tile_render_matches_reference(interpret_pallas):
    spp, depth = 2, 8
    j_scene, j_cam = jscenes.book2chap2_scene(W, H)
    j_cfg = jrender.RenderConfig(width=W, height=H, spp=spp,
                                 max_depth=depth)
    j_img, j_n = jrender.render_image_tiles(j_scene, j_cam, j_cfg, 0)
    t_scene, t_cam = tscenes.book2chap2_scene(W, H)
    t_cfg = render.RenderConfig(width=W, height=H, spp=spp, max_depth=depth)
    t_img, t_n = render.render_image_tiles(t_scene, t_cam, t_cfg, 0,
                                           device="cpu")
    a, b = np.asarray(j_img), t_img.numpy()
    assert b.shape == (H, W, 3) and np.isfinite(b).all()
    close = np.abs(a - b).max(axis=2) < 1e-3
    assert close.mean() >= 0.985, close.mean()
    assert abs(int(t_n) - float(j_n)) / float(j_n) < 1e-2
    # Motion blur shows: the static field renders otherwise.
    s_scene, _ = tscenes.chap12_scene(W, H)
    static, _ = render.render_image_tiles(s_scene, t_cam, t_cfg, 0,
                                          device="cpu")
    assert (static - t_img).abs().max() > 1e-2


def _state(j_scene, o, d, tm, keys):
    n = tm.shape[0]
    st = jmk.pack_state(o, d, tm, V3.ones((n,)), V3.zeros((n,)),
                        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool),
                        jnp.zeros((n,)))
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    return (st, torch.from_numpy(np.array(st)),
            torch.from_numpy(np.asarray(keys).view(np.int32).copy()),
            tmk.pack_spheres_full(t_scene), tmk.pack_bg(t_scene))


def _jax_steps(j_scene, st, keys, k_steps):
    return jmk.bounce_steps(
        st, keys, jmk.pack_spheres_full(j_scene),
        jnp.zeros((24, jmk.TS), jnp.float32), jmk.pack_media(j_scene),
        jmk.pack_bg(j_scene), k_steps=k_steps, moving=True, has_quads=False,
        n_media=0, max_depth=50, t_min=1e-3)


def test_bounce_steps_matches_reference(interpret_pallas):
    j_scene, o, d, tm, keys = _camera_rays()
    st, state, kbits, sph, bg = _state(j_scene, o, d, tm, keys)
    ref = np.asarray(_jax_steps(j_scene, st, keys, 4))
    out = tmk.bounce_steps_reference(state, kbits, sph, bg, k_steps=4,
                                     max_depth=50, t_min=1e-3,
                                     moving=True).numpy()
    np.testing.assert_array_equal(out[6], ref[6])  # the time stays
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.mean() >= 0.98, agree.mean()
    np.testing.assert_array_equal(out[15][agree], ref[15][agree])
    np.testing.assert_array_equal(out[13][agree], ref[13][agree])
    close = np.all(np.abs(out[7:13] - ref[7:13]) < 1e-3, axis=0)[agree]
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("bounce", [0, 1])
def test_intersect_only_matches_reference(interpret_pallas, bounce):
    j_scene, o, d, tm, keys = _camera_rays()
    st, _, _, sph, _ = _state(j_scene, o, d, tm, keys)
    if bounce:
        st = _jax_steps(j_scene, st, keys, 1)
    rays8 = jnp.concatenate([st[0:7], st[13:14]], axis=0)
    t, fam, idx = (np.asarray(a) for a in jmk.intersect_only(
        rays8, keys, jmk.pack_spheres_full(j_scene),
        jnp.zeros((24, jmk.TS), jnp.float32), jmk.pack_media(j_scene),
        moving=True, has_quads=False, n_media=0, t_min=1e-3))
    rays = torch.from_numpy(np.array(rays8))
    tt, tf, ti = tmk.intersect_only(rays[0:3], rays[3:6], sph, t_min=1e-3,
                                    time=rays[6].contiguous())
    np.testing.assert_array_equal(tf.numpy(), fam)
    np.testing.assert_array_equal(ti.numpy(), idx)
    hit = fam == 0
    assert hit.sum() >= 256 and (~hit).any()
    rel = np.abs(tt.numpy()[hit] - t[hit]) / t[hit]
    assert (rel < 1e-5).mean() >= 0.8, np.sort(rel)[-5:]
    assert (rel < 1e-3).all()
    np.testing.assert_array_equal(tt.numpy()[~hit], t[~hit])


def _grad_leaves(scene, cam):
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    camera = dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).detach().clone().requires_grad_()
        for f in dataclasses.fields(cam)})
    return params, camera


def _port_grads(out, params, camera, cot):
    leaves = list(params.values()) + [getattr(camera, f.name)
                                      for f in dataclasses.fields(camera)]
    gs = torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                             allow_unused=True)
    gs = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
          for x, g in zip(leaves, gs)]
    names = list(params) + ["camera." + f.name
                            for f in dataclasses.fields(camera)]
    return dict(zip(names, gs))


def _jax_grads(vjp, cot):
    gp, gc = vjp(jnp.asarray(cot))
    out = {k: np.asarray(v) for k, v in gp.items()}
    out.update({"camera." + f.name: np.asarray(getattr(gc, f.name))
                for f in dataclasses.fields(gc)})
    return out


def _assert_grads_close(got, exp, cam_tol, cam_slack):
    """tests/test_torch_train.py's rule: tables of <= 64 elements within
    2e-3 of their largest gradient, larger ones on >= 99.5% of elements;
    camera fields within cam_tol of their own largest (no smaller than
    1e-3 of the largest camera gradient) plus cam_slack of the largest
    camera gradient."""
    cam_max = max(np.abs(v).max() for k, v in exp.items()
                  if k.startswith("camera."))
    for k, b in exp.items():
        a = got[k]
        assert np.isfinite(a).all(), k
        if k.startswith("camera."):
            scale = max(np.abs(b).max(), 1e-3 * cam_max)
            atol = cam_tol * scale + cam_slack * cam_max
            assert (np.abs(a - b) <= atol).all(), (k, a, b)
            continue
        close = np.abs(a - b) <= 2e-3 * max(np.abs(b).max(), 1e-4)
        if a.size > 64:
            assert close.mean() >= 0.995, (k, close.mean())
        else:
            assert close.all(), (k, a, b)


def test_train_gradients_match_reference():
    """The train chain (trace_tiles_diff: on the CPU the plain versions
    of train_fwd and train_bwd) against rrt_tpu's scan path with explicit
    keys (tests/test_torch_train.py), at 16x8, 2 spp, depth 8, sphere_dc
    and the shutter (camera time0, time1) included, by
    gradcheck.sample_agreement's weights: a pixel with a sample whose
    radiance parts by more than 1e-3 relative gets weight 0. rrt_tpu runs
    op by op (jax.disable_jit), as the port does: its jit-compiled scan
    rounds the moving centers' multiply-adds otherwise, and at depth 8
    the chaotic long paths (ROADMAP Queue C) carry that into up to 7% of
    a field's largest gradient on the few elements a mirror reaches;
    op by op every element is within 1.2e-3 of its field's largest. Rule:
    tests/test_mk_grad.py's, each field within 2e-3 of its largest
    gradient, each camera field within 1e-2 of its own."""
    w, h, spp, depth = 16, 8, 2, 8
    j_scene, j_cam = jscenes.book2chap2_scene(w, h)
    n_pix = w * h

    def rad_ref(params, camera):
        s = jdiff.combine(j_scene, params)
        ids = jnp.arange(n_pix, dtype=jnp.int32)
        px, py = ids % w, ids // w
        per_sample = []
        for samp in range(spp):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * w + px).astype(jnp.uint32), samp)
            o, d, tm = generate_rays(camera, px, py, w, h, keys)
            rad, _ = jrender.trace_batch(s, o, d, tm, keys, depth, 1e-3,
                                         differentiable=True)
            per_sample.append(jnp.stack([rad.x, rad.y, rad.z], axis=-1))
        return jnp.stack(per_sample)

    with jax.disable_jit():
        rr, vjp = jax.vjp(rad_ref, jdiff.partition(j_scene), j_cam)
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    t_cam = convert.camera_from_numpy(_leaves(j_cam))
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=depth)
    params, camera = _grad_leaves(t_scene, t_cam)
    rad_t = torch.stack([render.trace_tiles_diff(
        diff.combine(t_scene, params), camera, cfg, 0, sample_lo=s,
        device="cpu")[0] for s in range(spp)])
    a, b = rad_t.detach().numpy(), np.asarray(rr)
    agree = (np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-6).all(axis=(0, 2))
    assert agree.mean() >= 0.985, agree.mean()
    cot = (np.sin(np.arange(n_pix) * 0.1)[:, None] * agree[:, None]
           * MIX).astype(np.float32)
    cot = np.broadcast_to(cot, (spp, n_pix, 3)).copy()
    got = _port_grads(rad_t, params, camera, cot)
    with jax.disable_jit():
        exp = _jax_grads(vjp, cot)
    assert np.abs(exp["sphere_dc"]).max() > 0
    assert np.abs(exp["camera.time1"]).max() > 0
    for k_, b_ in exp.items():
        assert np.isfinite(got[k_]).all(), k_
        tol = 1e-2 if k_.startswith("camera.") else 2e-3
        np.testing.assert_allclose(got[k_], b_, rtol=0,
                                   atol=tol * max(np.abs(b_).max(), 1e-4),
                                   err_msg=k_)


def test_train_winners_match_replay():
    """The moving variant's plain forward keeps the winners of the
    backward's plain replay (gradcheck.replay_winners) entry for entry,
    and tiles_adjoint_reference given them computes as without them,
    with 0 mismatches: book2chap2 at 16x8, 2 spp, depth 8."""
    from rrt_tpu_torch import gradcheck
    from rrt_tpu_torch.ops import megakernel_train as tmkt
    scene, cam = tscenes.book2chap2_scene(16, 8)
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=8)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = dict(seed_words=(0, 0), sample_lo=0, width=16, height=8, spp=2,
              max_depth=8, t_min=1e-3, moving=True)
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    expected = gradcheck.replay_winners(
        *packs, win_cap=tmkt.winner_capacity(2), **kw)
    assert torch.equal(winners, expected)
    assert (winners == -1).any() and (winners >= 0).any()
    d_rad = torch.sin(torch.arange(rad.numel()) * 0.3).reshape(rad.shape)
    with_w = tmkt.tiles_adjoint_reference(*packs, d_rad, lengths, winners,
                                          **kw)
    without = tmkt.tiles_adjoint_reference(*packs, d_rad, lengths, None, **kw)
    assert int(with_w[3]) == 0 and int(without[3]) == 0
    for a, b in zip(with_w[:3], without[:3]):
        assert torch.equal(a, b)
    assert with_w[0][4:7].abs().max() > 0  # the velocity rows


def test_chain_matches_reference(interpret_pallas):
    """The port's bounce chain (trace_batch_fused; on the CPU
    chain_adjoint_reference) against rrt_tpu's (its bounce_chain backward
    in interpret mode) at 16x8 pixels on rrt_tpu's TN lanes, depth 3,
    chains (2, 2), as tests/test_mk_grad.py holds rrt_tpu's own: the
    loss within 1e-4 and the gradients by tests/test_torch_chain.py's
    rule, lanes whose radiance parts by 1e-3 weighted 0. Lane i traces
    sample i // 128 of pixel i % 128."""
    w, h, n, depth, schedule = 16, 8, jmk.TN, 3, (2, 2)
    j_scene, j_cam = jscenes.book2chap2_scene(w, h)
    ids = np.arange(n)
    px, py, sample = ids % w, (ids // w) % h, ids // (w * h)
    jpx, jpy = jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32)
    j_keys = jrng.sample_keys(jax.random.key(0),
                              (jpy * w + jpx).astype(jnp.uint32),
                              jnp.asarray(sample, jnp.uint32))

    def j_rad(params, camera):
        o, d, tm = generate_rays(camera, jpx, jpy, w, h, j_keys)
        r, _ = jrender.trace_batch_fused(jdiff.combine(j_scene, params), o,
                                         d, tm, j_keys, depth, 1e-3,
                                         schedule=schedule)
        return jnp.stack([r.x, r.y, r.z])

    ref, vjp = jax.vjp(jax.jit(j_rad), jdiff.partition(j_scene), j_cam)
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    t_cam = convert.camera_from_numpy(_leaves(j_cam))
    params, camera = _grad_leaves(t_scene, t_cam)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    keys = rng.sample_keys(rng.key_words(0), tpy * w + tpx,
                           torch.from_numpy(sample))
    np.testing.assert_array_equal(rng.u32_bits(keys).numpy().view(np.uint32),
                                  np.asarray(j_keys))
    o, d, tm = render.generate_rays(camera, tpx, tpy, w, h, keys)
    tmkv.chain_adjoint.replay_mismatches = 0
    rad, _ = render.trace_batch_fused(diff.combine(t_scene, params), o, d,
                                      tm, keys, depth, 1e-3,
                                      schedule=schedule)
    agree = (np.abs(rad.detach().numpy() - np.asarray(ref)) < 1e-3).all(
        axis=0)
    assert agree.mean() >= 0.985, agree.mean()
    cot = (MIX[:, None] * np.sin(np.arange(n) * 0.1) * agree).astype(
        np.float32)
    loss = float((cot * rad.detach().numpy()).sum())
    assert loss == pytest.approx(float((cot * np.asarray(ref)).sum()),
                                 rel=1e-4)
    got = _port_grads(rad, params, camera, cot)
    exp = _jax_grads(vjp, cot)
    assert np.abs(exp["sphere_dc"]).max() > 0
    _assert_grads_close(got, exp, 3e-2, 2e-2)
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_sphere_dc_finite_differences():
    """d loss / d sphere_dc of one moving mirror sphere filling the frame
    under the sky (tests/test_grad.py's full-frame scene, now moving, as
    chip_smoke.py [M3] runs it at full size): every path is camera ->
    sphere -> sky, smooth in the motion (a lambertian sphere's grazing
    scatters re-hit it now and then, which moves path lengths under a
    finite difference), so the train chain's gradient must match central
    differences of its forward within 1e-3 of the largest component
    (measured 7.2e-7 at 120x80, 8 spp)."""
    w, h = 12, 8
    b = SceneBuilder()
    b.moving_sphere((0.0, 0.0, -1.0), (0.05, 0.03, -1.0), 0.0, 1.0, 0.5,
                    b.metal((0.6, 0.3, 0.2), fuzz=0.0))
    scene = b.build()
    cam = Camera.create(look_from=(0.0, 0.0, 1.0), look_at=(0.0, 0.0, -1.0),
                        fov_deg=10.0, aspect=w / h, time0=0.0, time1=1.0)
    cfg = render.RenderConfig(width=w, height=h, spp=2, max_depth=4)
    weight = torch.from_numpy(
        np.sin(np.arange(w * h * 3) * 0.37).astype(np.float32)).reshape(-1, 3)

    def loss(dc):
        s = dataclasses.replace(scene, sphere_dc=dc)
        rad, _ = render.trace_tiles_diff(s, cam, cfg, 0, device="cpu")
        return (weight.double() * rad.double()).sum()

    dc = scene.sphere_dc.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(dc), dc)
    eps = 1e-3
    fd = torch.zeros(3, dtype=torch.float64)
    for j in range(3):
        step = torch.zeros_like(dc)
        step[0, j] = eps
        with torch.no_grad():
            fd[j] = (loss(scene.sphere_dc + step)
                     - loss(scene.sphere_dc - step)) / (2 * eps)
    assert g[1:].abs().max() == 0  # the padding slots
    assert fd.abs().max() > 0.1
    torch.testing.assert_close(g[0].double(), fd, rtol=0,
                               atol=1e-3 * float(fd.abs().max()))
