"""The bounce chain past SOLID_CAP quads or boxes, on the CPU: chain_bwd's
scope takes every media-free scene the forward kernels take (its replay
walks the solid trees on a card, as bounce_steps does; its plain
version, which CPU tensors run, scans every slot and so gives the
walk's winners).

The port's render_image(differentiable=True) (bounce_steps' and
chain_adjoint's plain versions) against rrt_tpu's (its scan on the CPU),
both scenes built with the same calls in both packages, at 16x8:

  * many_solids_scene (81 boxes rotated about Y and 82 quads under the
    sky), static at 2 spp, depth 8, and with its moving sphere and its
    marble at 2 spp, depth 8;
  * rttnw_final_scene(ablate={"media"}) (400 ground boxes, 1,006
    spheres, one moving, the marble and the earth image) at 1 spp, depth
    4, its background made grey in both packages: under its black one,
    two paths that part and miss bank the same zero, which the image
    cannot see (at 16x8 every pixel agreed and bg_bottom's gradient
    parted by 6.0e-3 of its largest).

The rule is tests/test_torch_chain.py's for the two packages: a pixel
whose image differs by 1e-3 or more gets weight 0 (many_solids: none
does; rttnw_final: 2 of 128, on paths among its spheres, where the
plain version's sphere shading rounds otherwise, ROADMAP Queue C; at
most 5% may); the loss within 1e-4 relative; each partition() field
within 2e-3 of its largest gradient (tables above 64 elements on 99.5%
of their elements), each Camera field within 3e-2 of its own plus
CAM_SLACK of the largest Camera gradient, but for the spheres' geometry
beside the marble (MARBLE_FIELDS); the same quads and boxes past slot 63
get position gradients in both packages, and no replay mismatch.
rrt_tpu's side is jitted (about 15, 45 and 45 s alone); rttnw_final's
case is tests/test_torch_chain_solids_rttnw.py."""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from rrt_tpu import diff as jdiff
from rrt_tpu import render as jrender
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu.scenes import book2 as jbook2
from rrt_tpu_torch import diff, render, rng
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scenes import book2

import _torch_helpers as helpers

W, H = 16, 8
MIX = np.array([1.0, 0.7, 0.3], np.float32)
NO_MEDIA = frozenset({"media"})
# Each case: the scene's builder (given a builder and a camera class, so
# both packages build it with the same calls), spp, depth, a grey
# background, the fields whose slots past 63 get position gradients.
CASES = {
    "many_solids": (lambda b, c: book2.many_solids_scene(
        W, H, builder=b, camera=c), 2, 8, False,
        ("quad_u", "quad_v", "box_center")),
    "many_solids_moving_marble": (lambda b, c: book2.many_solids_scene(
        W, H, moving=True, marble=True, builder=b, camera=c), 2, 8, False,
        ("quad_u", "quad_v", "box_center")),
    "rttnw_final_no_media": (None, 1, 4, True, ("box_center", "box_half")),
}
# The Camera slack of each case (a share of the largest Camera gradient),
# as tests/test_torch_chain.py allows chap12 2e-2: many_solids'
# focus_dist gradient is a residual of cancelling per-ray terms (2e-5 to
# 3e-4 beside look_at's), which rrt_tpu's jit-compiled bounce and the
# port's op-by-op one leave apart by up to 4e-5 (measured on the moving
# case); rttnw_final's camera fields part by up to 6% of their own (its
# glass and metal spheres), under 1e-3 of the largest (aperture's).
CAM_SLACK = {"many_solids": 0.0, "many_solids_moving_marble": 2e-2,
             "rttnw_final_no_media": 2e-2}
# The spheres' geometry where the marble is in the scene, within
# MARBLE_TOL of each field's largest gradient: the marble's turbulence
# turns last-bit differences of a hit point into per-mille differences of
# the gradients of what moves it (tests/test_torch_rttnw_grad.py's _sky
# leaves the marble out for it). On many_solids with its marble, 3 of
# 384 sphere_c0 elements (the marble's and the ground's height), the
# marble's radius and its sphere_dc parted by up to 4.5e-3; the quads'
# and boxes' geometry held 2e-3. MARBLE_TOL is twice the reading.
MARBLE_FIELDS = ("sphere_c0", "sphere_radius", "sphere_dc")
MARBLE_TOL = 1e-2
# The chain against the port's scan: many_solids' camera has no aperture,
# so its focus_dist gradient is a residual of cancelling terms (2.6e-6
# and 1.3e-4), which the two routes' orders of summation leave apart by
# up to 2.0e-4, 7.6e-6 of the largest Camera gradient (up's, 25.8, with
# the marble); the other fields agree within 1e-5 of their own.
SCAN_CAM_SLACK = 2e-5


def _scenes(name):
    """rrt_tpu's and the port's (scene, camera) of a case."""
    build = CASES[name][0]
    if build is None:
        return (jbook2.rttnw_final_scene(W, H, ablate=NO_MEDIA),
                book2.rttnw_final_scene(W, H, ablate=NO_MEDIA))
    return build(JBuilder, JCamera), build(book2.SceneBuilder, book2.Camera)


@pytest.fixture(scope="module")
def images():
    """Both packages' differentiable images of a case and their
    gradients of sum(sin(0.1 i) MIX . image) over the agreeing pixels,
    computed on first use: {name: {"agree", "port", "ref", "img",
    "mismatches"}}."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        _, spp, depth, grey, _ = CASES[name]
        (j_scene, j_cam), (scene, cam) = _scenes(name)
        base = dict(width=W, height=H, spp=spp, max_depth=depth,
                    tile_pixels=64, samples_per_pass=spp)
        j_cfg, cfg = jrender.RenderConfig(**base), render.RenderConfig(**base)
        j_params = jdiff.partition(j_scene)
        if grey:
            g = np.full(3, 0.5, np.float32)
            j_params = dict(j_params, bg_bottom=g, bg_top=g)
            scene = dataclasses.replace(scene, bg_bottom=torch.from_numpy(g),
                                        bg_top=torch.from_numpy(g))

        def j_image(params, camera):
            return jrender.render_image(jdiff.combine(j_scene, params),
                                        camera, j_cfg, 0,
                                        differentiable=True)[0]

        ref, vjp = jax.vjp(jax.jit(j_image), j_params, j_cam)
        ref = np.asarray(ref)
        params, camera = helpers.grad_leaves(scene, cam)
        tmkv.chain_adjoint.replay_mismatches = 0
        img, _ = render.render_image(diff.combine(scene, params), camera,
                                     cfg, 0, differentiable=True,
                                     device="cpu")
        mism = int(tmkv.chain_adjoint.replay_mismatches)
        agree = (np.abs(img.detach().numpy() - ref) < 1e-3).all(axis=-1)
        cot = (np.sin(np.arange(W * H) * 0.1).reshape(H, W, 1) * MIX
               * agree[..., None]).astype(np.float32)
        cache[name] = dict(
            agree=agree, img=img.detach().numpy(), ref=ref, cot=cot,
            port=helpers.field_grads(img, params, camera, cot),
            exp=helpers.jax_grads(vjp, cot), mismatches=mism)
        return cache[name]
    return get


def check_case(r, name):
    """The module's rule on a case's images(name): the agreeing pixels,
    the loss and the gradients, and the chain's replays without a
    mismatch."""
    assert r["agree"].mean() >= 0.95, r["agree"].mean()
    if name.startswith("many_solids"):
        np.testing.assert_allclose(r["img"], r["ref"], rtol=0, atol=1e-5)
    loss = float((r["cot"] * r["img"]).sum())
    assert loss == pytest.approx(float((r["cot"] * r["ref"]).sum()),
                                 rel=1e-4)
    marble = name == "many_solids_moving_marble"
    held = MARBLE_FIELDS if marble else ()
    helpers.assert_grads_close(
        r["port"], {k: v for k, v in r["exp"].items() if k not in held},
        share=0.995, cam_slack=CAM_SLACK[name])
    for k in held:
        b = r["exp"][k]
        np.testing.assert_allclose(r["port"][k], b, rtol=0, err_msg=k,
                                   atol=MARBLE_TOL * np.abs(b).max())
    assert r["mismatches"] == 0


def check_past_cap(r, name):
    """Quads and boxes past slot 63, which chain_bwd once looped over at
    most SOLID_CAP of, get position gradients in a case's images(name):
    some slot in rrt_tpu, and the port's on the same slots."""
    for k in CASES[name][4]:
        rows = {side: np.abs(r[side][k][tmk.SOLID_CAP:]).max(axis=1) > 0
                for side in ("port", "exp")}
        assert rows["exp"].any(), k
        assert np.array_equal(rows["port"], rows["exp"]), k


# rttnw_final's case runs in tests/test_torch_chain_solids_rttnw.py, so
# that the two jits of rrt_tpu's render share no worker's file.
@pytest.mark.parametrize("name", ["many_solids",
                                  "many_solids_moving_marble"])
def test_render_image_differentiable_matches_rrt_tpu(images, name):
    check_case(images(name), name)


@pytest.mark.parametrize("name", ["many_solids",
                                  "many_solids_moving_marble"])
def test_solids_past_the_cap_get_position_gradients(images, name):
    check_past_cap(images(name), name)


def _lane_rad(scene, cam, n, fused, depth=8):
    """The port's radiance (3, n) of n lanes of scene (pixel ids i mod W
    x H, sample i div W x H) through its chain (trace_batch_fused) or
    its checkpointed scan, and the leaves (params, camera)."""
    params, camera = helpers.grad_leaves(scene, cam)
    ids = torch.arange(n)
    px, py = ids % W, (ids // W) % H
    keys = rng.sample_keys(rng.key_words(0), py * W + px, ids // (W * H))
    o, d, tm = render.generate_rays(camera, px, py, W, H, keys)
    rad, _ = render.trace_batch(diff.combine(scene, params), o, d, tm, keys,
                                depth, 1e-3, differentiable=True,
                                fused_vjp=fused)
    return rad, params, camera


@pytest.mark.parametrize("moving", [False, True])
def test_chain_matches_scan_past_the_cap(moving):
    """chain_adjoint_reference past SOLID_CAP (many_solids_scene, 256
    lanes, depth 8, chains (4, 5)) against the port's checkpointed scan,
    by test_chain_matches_scan's rule: the same plain physics, so the
    loss within 1e-5 relative and the gradients by test_mk_grad's rule,
    with SCAN_CAM_SLACK; the quads and boxes past slot 63 get gradients;
    no replay mismatch."""
    scene, cam = book2.many_solids_scene(W, H, moving=moving, marble=moving)
    assert min(scene.n_quads_active, scene.n_boxes_active) > tmk.SOLID_CAP
    tmkv.chain_adjoint.replay_mismatches = 0
    out = {f: _lane_rad(scene, cam, 2 * W * H, f) for f in (True, False)}
    a, b = out[True][0].detach(), out[False][0].detach()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    cot = (MIX[:, None] * np.sin(np.arange(2 * W * H) * 0.1)).astype(
        np.float32)
    assert float((torch.from_numpy(cot) * a).sum()) == pytest.approx(
        float((torch.from_numpy(cot) * b).sum()), rel=1e-5)
    got, exp = (helpers.field_grads(*out[f], cot) for f in (True, False))
    helpers.assert_grads_close(got, exp, cam_slack=SCAN_CAM_SLACK)
    for k in ("quad_u", "box_center"):
        assert np.abs(exp[k][tmk.SOLID_CAP:]).max() > 0, k
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_backward_scope_takes_media_free_scenes_past_the_cap():
    """backward_scope_gap is None for a media-free scene past SOLID_CAP
    quads or boxes (many_solids_scene, rttnw_final without its media),
    and the chain's route passes its card scope check; rttnw_final with
    its media names #9.4, and a media scene's raise on a CUDA device
    names it too."""
    for scene, _ in (book2.many_solids_scene(W, H),
                     book2.many_solids_scene(W, H, moving=True, marble=True),
                     book2.rttnw_final_scene(W, H, ablate=NO_MEDIA)):
        assert max(scene.n_quads_active, scene.n_boxes_active) > \
            tmk.SOLID_CAP
        assert tmkv.backward_scope_gap(scene) is None
        assert tmkv.supports_backward(scene)
        render._check_chain_card_scope("render_image(differentiable=True)",
                                       scene, "cuda")
    final, cam = tscenes.SCENES["rttnw_final"](W, H)
    assert tmkv.backward_scope_gap(final)[1] == "#9.4"
    cfg = render.RenderConfig(width=W, height=H, spp=1, max_depth=2,
                              samples_per_pass=1)
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image(final, cam, cfg, 0, differentiable=True,
                            device="cuda")


def test_render_image_diff_at_depth_80_takes_the_chain(caplog, monkeypatch):
    """Past the train kernels' records render_image_diff routes a scene
    past SOLID_CAP to render_image(differentiable=True) after one log
    line, and its gradient runs on the chain (BounceChain), not the
    train kernels, with no replay mismatch; the image is the forward
    batch driver's."""
    monkeypatch.setattr(render, "_warned_fallbacks", set())
    scene, cam = book2.many_solids_scene(8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=1, max_depth=80,
                              samples_per_pass=1, tile_pixels=32)
    assert "records" in render.diff_fallback_reason(scene, cfg)
    chains, trains = [], []
    chain_apply = tmkv.BounceChain.apply
    train_apply = tmkt.TileTrainChain.apply
    monkeypatch.setattr(tmkv.BounceChain, "apply",
                        lambda *a: chains.append(a) or chain_apply(*a))
    monkeypatch.setattr(tmkt.TileTrainChain, "apply",
                        lambda *a: trains.append(a) or train_apply(*a))
    tmkv.chain_adjoint.replay_mismatches = 0
    params, camera = helpers.grad_leaves(scene, cam)
    with caplog.at_level(logging.WARNING, logger="rrt_tpu_torch.render"):
        img, n = render.render_image_diff(diff.combine(scene, params),
                                          camera, cfg, 0, device="cpu")
        img.sum().backward()
    lines = [r for r in caplog.records
             if "batch driver's differentiable path" in r.getMessage()]
    assert len(lines) == 1
    assert len(chains) == len(render._fused_schedule(80)) and not trains
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    assert torch.isfinite(params["box_center"].grad).all()
    fwd, n_fwd = render.render_image(scene, cam, cfg, 0, device="cpu")
    torch.testing.assert_close(img.detach(), fwd, atol=2e-4, rtol=0)
    assert int(n) == int(n_fwd)
