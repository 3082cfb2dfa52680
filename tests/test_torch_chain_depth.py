"""The bounce chain at depth 80, on the CPU (tests moved from
tests/test_torch_chain.py, whose docstring states the rules, to keep
each file's time on one worker down): chap12 at 16x8, 1 spp, its tail
split into chains (4, 4, 64, 9) of at most MAX_RECORDS steps, against
the port's checkpointed scan and rrt_tpu's scan (its Pallas kernels in
interpret mode), and render_image_diff and make_train_step past the
train kernels' records."""

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
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

import _torch_helpers as helpers
from _torch_helpers import interpret_pallas  # noqa: F401 (a fixture)

W, H = 32, 18
MIX = (1.0, 0.7, 0.3)


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
    scene, cam = helpers.port_scene("chap12", W, H)
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
    got, exp = (helpers.field_grads(*out[f], cot) for f in (True, False))
    assert np.abs(exp["sphere_radius"]).max() > 0
    helpers.assert_grads_close(got, exp)
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
    scene = convert.scene_from_numpy(helpers.leaves(j_scene))
    cam = convert.camera_from_numpy(helpers.leaves(j_cam))
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
    got = helpers.field_grads(rad, params, camera, cot)
    exp = helpers.jax_grads(vjp, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    helpers.assert_grads_close(got, exp, share=0.995, cam_slack=2e-2)
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_render_image_diff_and_train_step_at_depth_80(caplog):
    """Past the train kernels' records (max_depth + 1 > MAX_RECORDS)
    render_image_diff routes to render_image(differentiable=True), whose
    chains split the depth, after one log line, as rrt_tpu's scope
    fallback does; make_train_step takes the same route, at 100 too."""
    scene, cam = helpers.port_scene("chap12", W, H)
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
