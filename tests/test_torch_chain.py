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

from rrt_tpu import diff as jdiff
from rrt_tpu import render as jrender
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu_torch import convert, diff, render, rng
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

import _torch_helpers as helpers
from _torch_helpers import interpret_pallas  # noqa: F401 (a fixture)

W, H, N, DEPTH, SCHEDULE = 32, 18, 1024, 3, (2, 2)
MIX = (1.0, 0.7, 0.3)


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


def _port_rad(name, path):
    """The port's radiance (3, N) of the lanes through its chain or its
    scan, and the gradient leaves (params, camera) it depends on."""
    scene, cam = helpers.port_scene(name, W, H)
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


def _cotangent(mask=None):
    w = _weight() if mask is None else _weight() * mask
    return (np.asarray(MIX, np.float32)[:, None] * w).astype(np.float32)


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
    scene, cam = helpers.port_scene(name, W, H)
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
    got, exp = (helpers.field_grads(rad_c, pc, cc, cot),
                helpers.field_grads(rad_s, ps, cs, cot))
    assert np.abs(exp["sphere_radius"]).max() > 0
    helpers.assert_grads_close(got, exp)
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
    got = helpers.field_grads(rad, params, camera, cot)
    exp = helpers.jax_grads(vjp, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    helpers.assert_grads_close(got, exp, share=0.995,
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
    scene, cam = (convert.scene_from_numpy(helpers.leaves(j_scene)),
                  convert.camera_from_numpy(helpers.leaves(j_cam)))
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
    got = helpers.field_grads(img, params, camera, w)
    exp = helpers.jax_grads(vjp, w)
    assert np.abs(exp["tex_color1"]).max() > 0
    helpers.assert_grads_close(got, exp)
    assert tmkv.chain_adjoint.launches == before  # plain versions on the CPU


def test_differentiable_image_equals_forward():
    """The differentiable image is the forward image: the batch driver's
    chain and its intersect-kernel route trace the same paths."""
    _, cfg = _image_cfgs(tile_pixels=40)
    scene, cam = helpers.port_scene("chap12", W, H)
    img, n = render.render_image(scene, cam, cfg, 0, differentiable=True,
                                 device="cpu")
    fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(img, fwd, atol=2e-4, rtol=0)
    assert int(n) == int(n_fwd)


def _chain_inputs(alive=True):
    scene, cam = helpers.port_scene("chap12", W, H)
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
    d_st, d_sph, d_bg, mism, _, _ = tmkv.chain_adjoint_reference(
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


def test_render_image_diff_out_of_scope_still_raises(caplog, monkeypatch):
    """A scene outside the train kernels' scope routes to
    render_image(differentiable=True), which logs the reason (the log's
    once-a-process memory starts empty, whatever ran before) and runs the
    scan on the CPU; on a CUDA device it raises naming the ROADMAP
    item."""
    monkeypatch.setattr(render, "_warned_fallbacks", set())
    scene, cam = helpers.port_scene("chap12", W, H)
    cfg = render.RenderConfig(width=16, height=8, spp=2, max_depth=2,
                              samples_per_pass=2)
    # More constant media than the train kernels take (#9.4; the chain
    # leaves media out): on the CPU the scan renders it, on a CUDA device
    # it raises before anything runs. (More quads or boxes than
    # SOLID_CAP, which this test once used, now take the train kernels:
    # tests/test_torch_rttnw_grad.py.)
    from rrt_tpu_torch.scene import SceneBuilder
    fog = SceneBuilder()
    for i in range(tmkt.MAX_TRAIN_MEDIA + 1):
        fog.medium_sphere((float(i), 0.0, 0.0), 0.4, 0.5, (0.5, 0.5, 0.5))
    many = fog.build()
    assert render.diff_fallback_reason(many, cfg) is not None
    img, _ = render.render_image_diff(many, cam, cfg, 0, device="cpu")
    assert torch.isfinite(img).all()
    assert "batch driver's differentiable path" in caplog.text
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image_diff(many, cam, cfg, 0, device="cuda")


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


