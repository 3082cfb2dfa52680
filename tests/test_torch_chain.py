"""The differentiable batch driver: the bounce chain (trace_batch_fused,
ops/megakernel_vjp.BounceChain with chain_adjoint's plain version on the
CPU), _compact_lanes and the checkpointed scan, against rrt_tpu.

rrt_tpu's Pallas kernels run in interpret mode (tests/test_mk_grad.py's
fixture, here for the module's cached references). The loss is
test_mk_grad's: sum(sin(0.1 i) (r + 0.7 g + 0.3 b)) over the lanes of
chap12 32x18, 1024 lanes at depth 3, chains (2, 2). Rules:

  * the port's chain against the port's scan (the same plain physics):
    test_mk_grad's rule, loss within 1e-5 relative, each partition()
    field within 2e-3 of its largest gradient, each Camera field within
    3e-2 of its own;
  * the port against rrt_tpu (its chain or its scan, jit-compiled): a
    lane whose radiance differs by 1e-3 or more gets weight 0, and at
    most 1.5% may (the spread of tests/test_torch_train.py: here 10 of
    chap12's 1024 lanes part on a last-bit decision flip, 0 of
    diffuse's); then the loss within 1e-4 and the gradients by
    test_mk_grad's rule, except tables of more than 64 elements, of
    which 99.5% must be within it, and the camera's slack stated in
    test_matches_reference (tests/test_torch_train.py's rule);
  * forwards: trace_batch_fused's radiance within 2e-4 of the
    non-differentiable trace_batch's and traced counts equal
    (test_mk_grad.py's chain-forward rule)."""

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
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu_torch import convert, diff, render, rng
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

W, H, N, DEPTH, SCHEDULE = 32, 18, 1024, 3, (2, 2)
MIX = (1.0, 0.7, 0.3)


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


def _lanes():
    ids = np.arange(N)
    return ids % W, (ids // W) % H


def _weight():
    return np.sin(np.arange(N) * 0.1).astype(np.float32)


def _jax_rad(j_scene, fused):
    """rrt_tpu's radiance (3, N) of the lanes as a function of
    (partition(scene), camera), its chain or its scan."""
    px, py = (jnp.asarray(a, jnp.int32) for a in _lanes())
    keys = jrng.sample_keys(jax.random.key(0),
                            (py * W + px).astype(jnp.uint32), 0)

    def rad(params, camera):
        s = jdiff.combine(j_scene, params)
        o, d, tm = jgenerate_rays(camera, px, py, W, H, keys)
        if fused:
            r, _ = jrender.trace_batch_fused(s, o, d, tm, keys, DEPTH, 1e-3,
                                             schedule=SCHEDULE)
        else:
            r, _ = jrender.trace_batch(s, o, d, tm, keys, DEPTH, 1e-3,
                                       differentiable=True)
        return jnp.stack([r.x, r.y, r.z])
    return rad


@pytest.fixture(scope="module")
def reference(interpret_pallas):
    """rrt_tpu's radiance and gradients, computed on first use and shared:
    {(scene, 'chain' | 'scan'): (rad (3, N), vjp)}."""
    cache = {}

    def get(name, path):
        if (name, path) not in cache:
            j_scene, j_cam = jscenes.SCENES[name](W, H)
            rad, vjp = jax.vjp(jax.jit(_jax_rad(j_scene, path == "chain")),
                               jdiff.partition(j_scene), j_cam)
            cache[name, path] = (np.asarray(rad), vjp)
        return cache[name, path]
    return get


def _port_scene(name):
    j_scene, j_cam = jscenes.SCENES[name](W, H)
    return (convert.scene_from_numpy(_leaves(j_scene)),
            convert.camera_from_numpy(_leaves(j_cam)))


def _port_rad(name, path):
    """The port's radiance (3, N) of the lanes through its chain or its
    scan, and the gradient leaves (params, camera) it depends on."""
    scene, cam = _port_scene(name)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    camera = dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).detach().clone().requires_grad_()
        for f in dataclasses.fields(cam)})
    px, py = (torch.from_numpy(a) for a in _lanes())
    keys = rng.sample_keys(rng.key_words(0), py * W + px, 0)
    o, d, tm = render.generate_rays(camera, px, py, W, H, keys)
    s = diff.combine(scene, params)
    if path == "chain":
        rad, _ = render.trace_batch_fused(s, o, d, tm, keys, DEPTH, 1e-3,
                                          schedule=SCHEDULE)
    else:
        rad, _ = render.trace_batch(s, o, d, tm, keys, DEPTH, 1e-3,
                                    differentiable=True)
    return rad, params, camera


def _port_grads(rad, params, camera, cot):
    leaves = list(params.values()) + [getattr(camera, f.name)
                                      for f in dataclasses.fields(camera)]
    gs = torch.autograd.grad(rad, leaves, torch.from_numpy(cot),
                             allow_unused=True)
    gs = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
          for x, g in zip(leaves, gs)]
    names = list(params) + ["camera." + f.name
                            for f in dataclasses.fields(camera)]
    return dict(zip(names, gs))


def _cotangent(mask=None):
    w = _weight() if mask is None else _weight() * mask
    return (np.asarray(MIX, np.float32)[:, None] * w).astype(np.float32)


def _assert_grads_close(got, exp, *, share=1.0, cam_slack=0.0):
    """test_mk_grad's rule: partition() fields within 2e-3 of their
    largest gradient (for tables above 64 elements on at least `share`
    of the elements), Camera fields within 3e-2 of their own plus
    `cam_slack` of the largest Camera gradient."""
    cam_max = max(np.abs(v).max() for k, v in exp.items()
                  if k.startswith("camera."))
    for k, b in exp.items():
        a = got[k]
        assert np.isfinite(a).all(), k
        if k.startswith("camera."):
            atol = 3e-2 * max(np.abs(b).max(), 1e-4) + cam_slack * cam_max
            assert (np.abs(a - b) <= atol).all(), (k, a, b)
            continue
        close = np.abs(a - b) <= 2e-3 * max(np.abs(b).max(), 1e-4)
        if a.size > 64:
            assert close.mean() >= share, (k, close.mean())
        else:
            assert close.all(), (k, a, b)


def _jax_grads(vjp, cot):
    gp, gc = vjp(jnp.asarray(cot))
    out = {k: np.asarray(v) for k, v in gp.items()}
    out.update({"camera." + f.name: np.asarray(getattr(gc, f.name))
                for f in dataclasses.fields(gc)})
    return out


@pytest.mark.parametrize("depth", [0, 1, 3, 8, 9, 12, 50])
def test_fused_schedule_matches_reference(depth):
    assert render._fused_schedule(depth) == jrender._fused_schedule(depth)
    assert sum(render._fused_schedule(depth)) == depth + 1


def test_compact_lanes_matches_reference():
    """The permutation is rrt_tpu's bit for bit (alive first, both parts
    in lane order), and the state's gradient is the inverse scatter."""
    rg = np.random.default_rng(0)
    q = 300
    st = rg.standard_normal((16, q)).astype(np.float32)
    st[14] = rg.random(q) > 0.4
    keys = rg.integers(0, 2**31, (2, q)).astype(np.int32)
    lane = np.arange(q, dtype=np.int32)
    j_st, j_keys, j_lane = jrender._compact_lanes(
        jnp.asarray(st), jnp.asarray(keys), jnp.asarray(lane))
    t_st = torch.from_numpy(st).requires_grad_()
    c_st, c_keys, c_lane = render._compact_lanes(
        t_st, torch.from_numpy(keys), torch.from_numpy(lane).long())
    np.testing.assert_array_equal(c_lane.numpy(), np.asarray(j_lane))
    np.testing.assert_array_equal(c_st.detach().numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(c_keys.numpy(), np.asarray(j_keys))
    n_alive = int(st[14].sum())
    assert (c_st[14, :n_alive] == 1).all() and (c_st[14, n_alive:] == 0).all()
    cot = torch.from_numpy(rg.standard_normal((16, q)).astype(np.float32))
    (g,) = torch.autograd.grad(c_st, t_st, cot)
    expect = torch.zeros_like(cot)
    expect[:, c_lane] = cot
    assert torch.equal(g, expect)


@pytest.mark.parametrize("name", ["chap12", "diffuse"])
def test_fused_forward_matches_nondiff(name):
    scene, cam = _port_scene(name)
    px, py = (torch.from_numpy(a) for a in _lanes())
    keys = rng.sample_keys(rng.key_words(3), py * W + px, 0)
    o, d, tm = render.generate_rays(cam, px, py, W, H, keys)
    rad, n = render.trace_batch_fused(scene, o, d, tm, keys, 4, 1e-3,
                                      schedule=(2, 3))
    rad2, n2 = render.trace_batch(scene, o, d, tm, keys, 4, 1e-3)
    torch.testing.assert_close(rad, rad2, atol=2e-4, rtol=0)
    assert n.dtype == torch.int64 and int(n) == int(n2) >= N


def test_chain_matches_scan():
    """The port's chain against its own scan, by test_mk_grad's rule; the
    chain's backwards replay their forwards exactly."""
    tmkv.chain_adjoint.replay_mismatches = 0
    rad_c, pc, cc = _port_rad("chap12", "chain")
    rad_s, ps, cs = _port_rad("chap12", "scan")
    cot = _cotangent()
    lc = float((torch.from_numpy(cot) * rad_c.detach()).sum())
    ls = float((torch.from_numpy(cot) * rad_s.detach()).sum())
    assert lc == pytest.approx(ls, rel=1e-5)
    got, exp = _port_grads(rad_c, pc, cc, cot), _port_grads(rad_s, ps, cs, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    _assert_grads_close(got, exp)
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


@pytest.mark.parametrize("name,port_path,ref_path", [
    ("chap12", "chain", "chain"),
    ("chap12", "scan", "scan"),
    ("diffuse", "chain", "scan"),
])
def test_matches_reference(reference, name, port_path, ref_path):
    """The port's chain or scan against rrt_tpu's chain or scan, by the
    module's rule for the two packages (diffuse: every lane agrees).
    The loss agrees within 1e-4 relative (chap12 measured 2.4e-5: lanes
    within 1e-3 still differ by up to 2e-4). cam_slack on chap12:
    rrt_tpu's jit-compiled bounce and the port's op-by-op one put the
    aspect gradient, a small residual of cancelling per-ray terms (1.2
    beside look_from's 14.7), 1.38e-2 of the largest camera gradient
    apart (measured); 2e-2 of it is allowed on top, as
    tests/test_torch_train.py allows 1.5e-2 on the tile path."""
    ref_rad, vjp = reference(name, ref_path)
    rad, params, camera = _port_rad(name, port_path)
    agree = (np.abs(rad.detach().numpy() - ref_rad) < 1e-3).all(axis=0)
    assert agree.mean() >= (1.0 if name == "diffuse" else 0.985), \
        agree.mean()
    cot = _cotangent(agree)
    loss = float((cot * rad.detach().numpy()).sum())
    assert loss == pytest.approx(float((cot * ref_rad).sum()), rel=1e-4)
    got = _port_grads(rad, params, camera, cot)
    exp = _jax_grads(vjp, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    _assert_grads_close(got, exp, share=0.995,
                        cam_slack=2e-2 if name == "chap12" else 0.0)


def _image_cfgs(**kw):
    base = dict(width=16, height=8, spp=2, max_depth=DEPTH,
                tile_pixels=64, samples_per_pass=2)
    base.update(kw)
    return jrender.RenderConfig(**base), render.RenderConfig(**base)


def test_render_image_differentiable_matches_reference():
    """render_image(differentiable=True) (the chain, on the CPU its plain
    versions) against rrt_tpu's (its scan on the CPU): the image within
    1e-5 on diffuse, and the gradient of sum(sin(0.1 i) * image) by
    test_mk_grad's rule."""
    j_cfg, cfg = _image_cfgs()
    j_scene, j_cam = jscenes.SCENES["diffuse"](16, 8)
    n_px = 16 * 8 * 3
    w = np.sin(np.arange(n_px) * 0.1).astype(np.float32).reshape(8, 16, 3)

    def j_image(params, camera):
        return jrender.render_image(jdiff.combine(j_scene, params), camera,
                                    j_cfg, 0, differentiable=True)[0]

    ref, vjp = jax.vjp(j_image, jdiff.partition(j_scene), j_cam)
    scene, cam = (convert.scene_from_numpy(_leaves(j_scene)),
                  convert.camera_from_numpy(_leaves(j_cam)))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    camera = dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).detach().clone().requires_grad_()
        for f in dataclasses.fields(cam)})
    before = tmkv.chain_adjoint.launches
    img, n = render.render_image(diff.combine(scene, params), camera, cfg, 0,
                                 differentiable=True, device="cpu")
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    assert int(n) > 16 * 8 * 2
    got = _port_grads(img, params, camera, w)
    exp = _jax_grads(vjp, w)
    assert np.abs(exp["tex_color1"]).max() > 0
    _assert_grads_close(got, exp)
    assert tmkv.chain_adjoint.launches == before  # plain versions on the CPU


def test_differentiable_image_equals_forward():
    """The differentiable image is the forward image: the batch driver's
    chain and its intersect-kernel route trace the same paths."""
    _, cfg = _image_cfgs(tile_pixels=40)
    scene, cam = _port_scene("chap12")
    img, n = render.render_image(scene, cam, cfg, 0, differentiable=True,
                                 device="cpu")
    fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(img, fwd, atol=2e-4, rtol=0)
    assert int(n) == int(n_fwd)


def _chain_inputs(alive=True):
    scene, cam = _port_scene("chap12")
    px, py = (torch.from_numpy(a) for a in _lanes())
    keys = rng.sample_keys(rng.key_words(0), py * W + px, 0)
    o, d, tm = render.generate_rays(cam, px, py, W, H, keys)
    one, zero = torch.ones((N,)), torch.zeros((N,))
    st = tmk.pack_state(o, d, tm, one.expand(3, N), zero.expand(3, N), zero,
                        one * alive, zero)
    return (st, rng.u32_bits(keys), tmk.pack_spheres_full(scene),
            tmk.pack_bg(scene))


def test_adjoint_of_dead_lanes_is_d_out():
    st, keys, sph, bg = _chain_inputs(alive=False)
    d_out = torch.from_numpy(
        np.random.default_rng(1).standard_normal((16, N)).astype(np.float32))
    d_st, d_sph, d_bg, mism = tmkv.chain_adjoint_reference(
        st, keys, sph, bg, d_out, st[tmk.ROW_BOUNCE].clone(), k_steps=4,
        max_depth=50, t_min=1e-3, moving=False)
    assert torch.equal(d_st[:13], d_out[:13]) and not d_st[13:].any()
    assert not d_sph.any() and not d_bg.any() and int(mism) == 0


def test_chain_adjoint_checks_its_inputs():
    st, keys, sph, bg = _chain_inputs()
    kw = dict(max_depth=80, t_min=1e-3, moving=False)
    with pytest.raises(ValueError, match="records"):
        tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st),
                           st[tmk.ROW_BOUNCE].clone(),
                           k_steps=tmkv.MAX_RECORDS + 1, **kw)
    with pytest.raises(ValueError, match="out_bounce"):
        tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st),
                           st[tmk.ROW_BOUNCE][:10].clone(), k_steps=4, **kw)


def test_bounce_chain_keeps_its_input():
    """BounceChain runs bounce_steps on a copy: the saved input state is
    untouched, and its backward (the plain version here) replays it."""
    st, keys, sph, bg = _chain_inputs()
    st = st.requires_grad_()
    before = st.detach().clone()
    tmkv.chain_adjoint.replay_mismatches = 0
    out = tmkv.bounce_chain(3, 50, 1e-3, False)(st, keys, sph, bg)
    assert torch.equal(st.detach(), before)
    assert not torch.equal(out.detach(), before)
    (g,) = torch.autograd.grad(out[10:13].sum(), st)
    assert torch.isfinite(g).all() and g[0:10].abs().max() > 0
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_render_image_diff_out_of_scope_still_raises(caplog):
    """An out-of-scope scene now routes to render_image(differentiable=
    True), which logs the reason and raises naming the ROADMAP item."""
    scene, cam = _port_scene("chap12")
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=2,
                              samples_per_pass=2)
    with pytest.raises(NotImplementedError, match="#9.5"):
        render.render_image_diff(dataclasses.replace(scene, has_perlin=True),
                                 cam, cfg, 0, device="cpu")
    assert "batch driver's differentiable path" in caplog.text


# ---------------------------------------------------------------------------
# Any depth: chains of at most MAX_RECORDS steps, and the route past the
# train kernels' records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [63, 71, 72, 99, 200])
def test_fused_schedule_splits_long_tails(depth):
    """A chain's backward keeps at most MAX_RECORDS bounce records a lane,
    so the tail splits into chains of at most that many steps; below 72
    the schedule is rrt_tpu's."""
    schedule = render._fused_schedule(depth)
    assert sum(schedule) == depth + 1
    assert max(schedule) <= tmkv.MAX_RECORDS and min(schedule) >= 1
    assert schedule[:2] == (4, 4)
    if depth < 72:
        assert schedule == jrender._fused_schedule(depth)
    if depth == 99:
        assert schedule == (4, 4, 64, 28)


def _deep_cfg(**kw):
    base = dict(width=16, height=8, spp=1, max_depth=80, samples_per_pass=1,
                tile_pixels=128)
    base.update(kw)
    return render.RenderConfig(**base)


def test_chain_matches_scan_at_depth_80():
    """trace_batch(differentiable=True, fused_vjp=True) at depth 80, chains
    (4, 4, 64, 9), against the checkpointed scan (fused_vjp=False) at
    16x8, 1 spp: the same plain physics, so the loss within 1e-5
    relative; the gradients by test_chain_matches_scan's rule, lanes
    whose radiance parts by 1e-3 relative (gradcheck.sample_agreement's
    rule) weighted 0."""
    cfg = _deep_cfg()
    scene, cam = _port_scene("chap12")
    n = cfg.width * cfg.height
    ids = torch.arange(n)
    px, py = ids % cfg.width, ids // cfg.width
    keys = rng.sample_keys(rng.key_words(0), py * cfg.width + px, 0)
    assert render._fused_schedule(cfg.max_depth) == (4, 4, 64, 9)
    tmkv.chain_adjoint.replay_mismatches = 0
    out = {}
    for fused in (True, False):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in diff.partition(scene).items()}
        camera = dataclasses.replace(cam, **{
            f.name: getattr(cam, f.name).detach().clone().requires_grad_()
            for f in dataclasses.fields(cam)})
        o, d, tm = render.generate_rays(camera, px, py, cfg.width,
                                        cfg.height, keys)
        rad, _ = render.trace_batch(diff.combine(scene, params), o, d, tm,
                                    keys, cfg.max_depth, 1e-3,
                                    differentiable=True, fused_vjp=fused)
        out[fused] = (rad, params, camera)
    a, b = out[True][0].detach(), out[False][0].detach()
    agree = ((a - b).abs() <= 1e-3 * b.abs() + 1e-6).all(dim=0).numpy()
    assert agree.mean() >= 0.985, agree.mean()
    w = np.sin(np.arange(n) * 0.1).astype(np.float32) * agree
    cot = (np.asarray(MIX, np.float32)[:, None] * w).astype(np.float32)
    lc = float((torch.from_numpy(cot) * a).sum())
    ls = float((torch.from_numpy(cot) * b).sum())
    assert lc == pytest.approx(ls, rel=1e-5)
    got, exp = (_port_grads(*out[f], cot) for f in (True, False))
    assert np.abs(exp["sphere_radius"]).max() > 0
    _assert_grads_close(got, exp)
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_matches_reference_at_depth_80(interpret_pallas):
    """trace_batch(differentiable=True, fused_vjp=True) at depth 80, where
    the port splits its tail into chains (4, 4, 64, 9), against rrt_tpu's
    trace_batch(differentiable=True) under jax.vjp, chap12 16x8, 1 spp:
    lanes whose radiance parts by gradcheck.sample_agreement's rule (1e-3
    relative) weighted 0; at most 3 of the 128 lanes may be (2 are,
    measured: 80 bounces give a last-bit decision flip more chances than
    the module's 4); then the module's rule for the two packages."""
    w, h, depth = 16, 8, 80
    j_scene, j_cam = jscenes.SCENES["chap12"](w, h)
    scene = convert.scene_from_numpy(_leaves(j_scene))
    cam = convert.camera_from_numpy(_leaves(j_cam))
    ids = np.arange(w * h)
    px, py = ids % w, ids // w

    def j_rad(params, camera):
        jpx, jpy = jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32)
        keys = jrng.sample_keys(jax.random.key(0),
                                (jpy * w + jpx).astype(jnp.uint32), 0)
        o, d, tm = jgenerate_rays(camera, jpx, jpy, w, h, keys)
        r, _ = jrender.trace_batch(jdiff.combine(j_scene, params), o, d, tm,
                                   keys, depth, 1e-3, differentiable=True)
        return jnp.stack([r.x, r.y, r.z])

    ref_rad, vjp = jax.vjp(jax.jit(j_rad), jdiff.partition(j_scene), j_cam)
    ref_rad = np.asarray(ref_rad)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    camera = dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).detach().clone().requires_grad_()
        for f in dataclasses.fields(cam)})
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    keys = rng.sample_keys(rng.key_words(0), tpy * w + tpx, 0)
    o, d, tm = render.generate_rays(camera, tpx, tpy, w, h, keys)
    assert render._fused_schedule(depth) == (4, 4, 64, 9)
    tmkv.chain_adjoint.replay_mismatches = 0
    rad, _ = render.trace_batch(diff.combine(scene, params), o, d, tm, keys,
                                depth, 1e-3, differentiable=True,
                                fused_vjp=True)
    a = rad.detach().numpy()
    agree = (np.abs(a - ref_rad) <= 1e-3 * np.abs(ref_rad) + 1e-6).all(axis=0)
    assert (~agree).sum() <= 3, agree.mean()
    weight = np.sin(ids * 0.1).astype(np.float32) * agree
    cot = (np.asarray(MIX, np.float32)[:, None] * weight).astype(np.float32)
    loss = float((cot * a).sum())
    assert loss == pytest.approx(float((cot * ref_rad).sum()), rel=1e-4)
    got = _port_grads(rad, params, camera, cot)
    exp = _jax_grads(vjp, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    _assert_grads_close(got, exp, share=0.995, cam_slack=2e-2)
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_render_image_diff_and_train_step_at_depth_80(caplog):
    """Past the train kernels' records (max_depth + 1 > MAX_RECORDS)
    render_image_diff routes to render_image(differentiable=True), whose
    chains split the depth, after one log line, as rrt_tpu's scope
    fallback does; make_train_step takes the same route, at 100 too."""
    scene, cam = _port_scene("chap12")
    cfg = _deep_cfg()
    reason = render.diff_fallback_reason(scene, cfg)
    assert reason is not None and "records" in reason
    assert render.diff_fallback_reason(
        scene, dataclasses.replace(cfg, max_depth=63)) is None
    before = tmkv.chain_adjoint.launches
    img, n = render.render_image_diff(scene, cam, cfg, 0, device="cpu")
    fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(img, fwd, atol=2e-4, rtol=0)
    assert int(n) == int(n_fwd)
    assert "batch driver's differentiable path" in caplog.text
    assert tmkv.chain_adjoint.launches == before  # plain versions here
    for depth in (80, 100):
        step = diff.make_train_step(dataclasses.replace(cfg,
                                                        max_depth=depth),
                                    lr=0.5, device="cpu")
        new, new_cam, loss = step(scene, cam, torch.full((8, 16, 3), 0.2), 0)
        assert torch.isfinite(loss)
        assert not torch.equal(new.tex_color1, scene.tex_color1)
