"""Russian roulette's gradient in the port against rrt_tpu, on the CPU.

The kill is a replayed decision and the weight 1 / p is detached
(megakernel_vjp.diff_step, render._apply_rr), in both packages:

  * diff_step with rr_on against rrt_tpu's _make_diff_step under
    jax.vjp, on tests/test_torch_diff_step.py's lanes and rule (outputs
    within 1e-6 of each row's largest, the VJP within 1e-5 of each
    input's largest gradient);
  * the train kernels' plain versions (trace_tiles_diff) with rr_depth 2
    against jax.vjp of rrt_tpu's scan with explicit keys
    (trace_batch(differentiable=True), tests/test_torch_cornell_train_grad
    .py's pattern) on cornell 24x24, 1 spp, depth 6
    (tests/test_tile_grad.py's case) and cornell_smoke 16x16, 1 spp,
    depth 6, whose media fold their albedo into the throughput before the
    coin (tests/test_tile_grad.py:192-197). Weights are
    gradcheck.sample_agreement's: a pixel with a sample whose radiance
    parts by more than 1e-3 relative (+1e-6) gets weight 0, also under a
    grey background, which shows a path that leaves the black box in one
    package only; at least 98.5% must agree. Each listed field within
    2e-3 of its largest gradient;
  * the bounce chain (trace_batch_fused with chains (3, 3): on the CPU
    bounce_steps_reference and chain_adjoint_reference) against rrt_tpu's
    scan on chap12 32x18, depth 5 (tests/test_mk_grad.py's case), one
    lane a pixel, by tests/test_torch_chain.py's rule for the two
    packages (helpers.assert_grads_close, 99.5% of a large table's
    elements, the camera's slack stated there).

Each case asserts that the roulette fired: fewer traced segments than at
rr_depth 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.render import trace_batch as jtrace_batch
from rrt_tpu_torch import diff, render, rng

import _torch_helpers as helpers
from test_torch_diff_step import _assert_steps_agree, _run_both

RR = 2
MIX = np.array([1.0, 0.7, 0.3], np.float32)


@pytest.mark.parametrize("seed,is_sky", [(0, True), (1, False)])
def test_diff_step_matches_reference(seed, is_sky):
    out = _run_both(seed, is_sky, 100, rr_depth=RR)
    _assert_steps_agree(*out)
    # The roulette's weight reaches the throughput's cotangent.
    t_plain = _run_both(seed, is_sky, 100)[3]
    assert any(not torch.equal(a, b) for a, b in zip(out[3][7:10],
                                                     t_plain[7:10]))


def _jax_rad(j_scene, j_cam, w, h, depth, params):
    """rrt_tpu's radiance sums (P, 3) of sample 0 through its scan."""
    s = jdiff.combine(j_scene, params)
    ids = jnp.arange(w * h, dtype=jnp.int32)
    px, py = ids % w, ids // w
    keys = jrng.sample_keys(jax.random.key(0),
                            (py * w + px).astype(jnp.uint32), 0)
    o, d, tm = jgenerate_rays(j_cam, px, py, w, h, keys)
    r, _ = jtrace_batch(s, o, d, tm, keys, depth, 1e-3, differentiable=True,
                        rr_depth=RR)
    return jnp.stack([r.x, r.y, r.z], axis=-1)


def _agreeing(a, b):
    """sample_agreement's rule on (P, 3) radiance of one sample."""
    return (np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-6).all(axis=1)


@pytest.mark.parametrize("name,size,fields,nonzero", [
    ("cornell", 24, ("quad_q", "quad_u", "quad_v", "box_center",
                     "box_half", "tex_color1", "bg_bottom"),
     ("tex_color1",)),
    ("cornell_smoke", 16, ("quad_q", "med_center", "med_radius",
                           "med_half", "med_neg_inv_density",
                           "tex_color1", "bg_bottom"),
     ("tex_color1", "the media's albedo")),
])
def test_train_gradients_match_reference(name, size, fields, nonzero):
    """nonzero: the fields whose gradient is not 0 in either package,
    "the media's albedo" the rows of tex_color1 the media's isotropic
    materials read."""
    w = h = size
    depth = 6
    j_scene, j_cam = jscenes.SCENES[name](w, h)
    scene, cam = helpers.port(j_scene, j_cam)
    j_params = jdiff.partition(j_scene)
    j_rad = jax.jit(lambda p: _jax_rad(j_scene, j_cam, w, h, depth, p))
    ref, vjp = jax.vjp(j_rad, j_params)
    ref = np.asarray(ref)
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=depth,
                              rr_depth=RR)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in diff.partition(scene).items()}
    rad, n = render.trace_tiles_diff(diff.combine(scene, params), cam, cfg,
                                     0, device="cpu")
    _, n0 = render.trace_tiles(scene, cam, dataclasses.replace(
        cfg, rr_depth=0), 0, device="cpu")
    assert int(n) < int(n0), (int(n), int(n0))
    grey = np.full(3, 0.5, np.float32)
    lit = np.asarray(j_rad(dict(j_params, bg_bottom=jnp.asarray(grey))))
    lit_t, _ = render.trace_tiles(diff.combine(scene, {
        "bg_bottom": torch.from_numpy(grey)}), cam, cfg, 0, device="cpu")
    agree = (_agreeing(rad.detach().numpy(), ref)
             & _agreeing(lit_t.numpy(), lit))
    assert agree.mean() >= 0.985, agree.mean()
    wm = (np.sin(np.arange(w * h) * 0.1)[:, None] * MIX * agree[:, None]) \
        .astype(np.float32)
    (gj,) = vjp(jnp.asarray(wm))
    gs = torch.autograd.grad(rad, list(params.values()),
                             torch.from_numpy(wm), allow_unused=True)
    got = {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
           for (k, v), g in zip(params.items(), gs)}
    for k in nonzero:
        rows = slice(None)
        if k == "the media's albedo":
            rows = scene.mat_tex[scene.med_mat[:scene.n_media_active].long()
                                 ].long().numpy()
            k = "tex_color1"
        assert np.abs(np.asarray(gj[k])[rows]).max() > 0, k
        assert np.abs(got[k][rows]).max() > 0, k
    for k in fields:
        a, b = got[k], np.asarray(gj[k])
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def test_chain_gradients_match_reference():
    w, h, depth = 32, 18, 5
    j_scene, j_cam = jscenes.chap12_scene(w, h)
    ids = np.arange(w * h)

    def j_rad(params, camera):
        return _jax_rad(j_scene, camera, w, h, depth, params).T

    ref, vjp = jax.vjp(jax.jit(j_rad), jdiff.partition(j_scene), j_cam)
    ref = np.asarray(ref)
    scene, cam = helpers.port(j_scene, j_cam)
    params, camera = helpers.grad_leaves(scene, cam)
    px, py = (torch.from_numpy(a) for a in (ids % w, ids // w))
    keys = rng.sample_keys(rng.key_words(0), py * w + px, 0)
    o, d, tm = render.generate_rays(camera, px, py, w, h, keys)
    rad, n = render.trace_batch_fused(diff.combine(scene, params), o, d, tm,
                                      keys, depth, 1e-3, schedule=(3, 3),
                                      rr_depth=RR)
    with torch.no_grad():
        _, n0 = render.trace_batch_fused(scene, o, d, tm, keys, depth, 1e-3,
                                         schedule=(3, 3))
    assert int(n) < int(n0), (int(n), int(n0))
    agree = (np.abs(rad.detach().numpy() - ref) < 1e-3).all(axis=0)
    assert agree.mean() >= 0.985, agree.mean()
    cot = (MIX[:, None] * np.sin(ids * 0.1) * agree).astype(np.float32)
    got = helpers.field_grads(rad, params, camera, cot)
    exp = helpers.jax_grads(vjp, cot)
    assert np.abs(exp["sphere_radius"]).max() > 0
    helpers.assert_grads_close(got, exp, share=0.995, cam_slack=2e-2)
