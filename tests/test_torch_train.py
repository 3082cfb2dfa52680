"""The differentiable slice and the train step against rrt_tpu, on the CPU.

On the CPU the port's train chain runs its plain versions
(ops/megakernel_train: render_tiles_train_reference forward,
tiles_adjoint_reference backward), so these tests hold the adjoint's
math; tests/test_torch_cuda.py holds the CUDA kernels against it on the
card. Tolerances:

  * tiles_adjoint_reference against plain autograd through
    render_tiles_reference (same decisions, other summation order):
    within 1e-4 of each partition() field's largest gradient, and 1e-4
    of the largest Camera gradient for every Camera field (a camera
    field's gradient can be a small residual of large cancelling
    per-ray terms: focus_dist's is 0.006 beside up's 11.7 on chap12,
    and its two sums part at 2e-3 of its own size);
  * the slice against rrt_tpu's scan path (trace_batch with explicit
    keys, as tests/test_tile_grad.py's _compare builds it), with that
    test's gradient rule: tables of <= 64 elements within 2e-3 max|g|,
    larger ones >= 99.5% of elements within it; camera fields within
    1e-2 max|g|, max|g| taken no smaller than 1e-3 of the largest
    camera gradient (a field whose true gradient is 0, as focus_dist's
    at aperture 0, is rounding noise of ~1e-6 in both). Pixels whose
    forward differs by 1e-3 or more get loss weight 0, and must be no
    more than 1.5%: the spread between two float implementations of
    the same paths that tests/test_torch_slice.py allows (here 7 of
    chap12's 576 pixels, 98.8%, part ways on a last-bit decision
    flip);
  * one SGD step against rrt_tpu's make_train_step (its scan path on
    the CPU): new parameters within 2e-3 max|g| lr.

The residual's tests (the winners, gradcheck's readings of them) and the
chunked trainer's are in tests/test_torch_train_residual.py."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu
from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import Camera as JCamera
from rrt_tpu.camera import generate_rays
from rrt_tpu.render import trace_batch
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu_torch import convert, diff, render
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.parallel import mesh as pmesh
from rrt_tpu_torch.scene import SceneBuilder

import _torch_helpers as helpers


def _fullframe(material, w=24, h=16):
    """One sphere covering every pixel (tests/test_grad.py)."""
    b = JBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, material(b))
    cam = JCamera.create(look_from=(0.0, 0.0, 1.0),
                         look_at=(0.0, 0.0, -1.0), fov_deg=10.0,
                         aspect=w / h)
    return b.build(), cam


def _checker_scene(w, h):
    b = SceneBuilder()
    tex = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(tex))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), fuzz=0.3))
    b.sphere((-2.5, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.solid_background((0.3, 0.4, 0.5))
    from rrt_tpu_torch.camera import Camera
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=w / h, aperture=0.1,
                        focus_dist=10.0)
    return b.build(), cam


@pytest.mark.parametrize("name", ["chap12", "checker"])
def test_adjoint_reference_matches_autograd(name):
    """TileTrainChain on the CPU (the plain adjoint) against autograd
    through the plain forward, at the level of partition() and Camera
    fields: the two split the radius gradient between pack rows 3 and
    18 differently."""
    w, h, spp, depth = 16, 8, 2, 4
    build = _checker_scene if name == "checker" else (
        lambda w, h: helpers.port(*jscenes.chap12_scene(w, h)))
    scene, cam = build(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    weight = torch.sin(torch.arange(w * h) * 0.1)[:, None] * torch.tensor(
        [1.0, 0.7, 0.3])
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=False)

    def grads(fn):
        params, camera = helpers.grad_leaves(scene, cam)
        packs = render._packs(diff.combine(scene, params), camera, cfg,
                              "cpu")
        rad = fn(*packs)
        return helpers.field_grads((weight * rad).sum(), params, camera)

    chain = grads(lambda *p: tmkt.TileTrainChain.apply(
        *p, (0, 0), 0, w, h, spp, depth, 1e-3, False)[0])
    plain = grads(lambda *p: tmk.render_tiles_reference(*p, **kw)[0])
    # (Under a solid background a path's radiance is a product of
    # albedos, so only chap12's sky gives geometry a gradient.)
    power = ("sphere_radius", "camera.look_from") if name == "chap12" \
        else ("tex_color1", "tex_color2", "bg_bottom")
    for k in power:
        assert np.abs(plain[k]).max() > 0, k
    helpers.assert_fields_close(chain, plain, 1e-4, 1e-4)


def _jax_reference_rad(scene, cam, w, h, spp, depth):
    """rrt_tpu's scan path with explicit keys (test_tile_grad._compare)."""
    n_pix = w * h

    def rad_ref(params, camera):
        s = jdiff.combine(scene, params)
        ids = jnp.arange(n_pix, dtype=jnp.int32)
        px, py = ids % w, ids // w
        tot = jnp.zeros((n_pix, 3), jnp.float32)
        for samp in range(spp):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * w + px).astype(jnp.uint32), samp)
            o, d, tm = generate_rays(camera, px, py, w, h, keys)
            rad, _ = trace_batch(s, o, d, tm, keys, depth, 1e-3,
                                 differentiable=True)
            tot = tot + jnp.stack([rad.x, rad.y, rad.z], axis=-1)
        return tot
    return rad_ref


@pytest.mark.parametrize("name", ["chap12", "lambertian", "metal"])
def test_slice_gradients_match_reference(name):
    """cam_slack on chap12: its camera gradient runs through short hops
    onto the radius-1000 ground, where the expanded quadratic cancels in
    f32. rrt_tpu's own bounce step, jit-compiled against run op by op,
    moves a pixel's look_from tangent by up to 0.16 of 19 there (the
    port matches the op-by-op run within 4e-4), and the image's
    look_from gradient by 1.1% of the largest camera gradient: 1.5% of
    it is allowed on top of the 1e-2 camera tolerance, as
    tests/test_tile_grad.py's flip_slack allows extra on this scene."""
    cam_slack = 0.0
    if name == "chap12":
        cam_slack = 1.5e-2
        w, h = 32, 18
        j_scene, j_cam = jscenes.chap12_scene(w, h)
    else:
        w, h = 24, 16
        mat = {"lambertian": lambda b: b.lambertian((0.6, 0.3, 0.2)),
               "metal": lambda b: b.metal((0.8, 0.7, 0.6), fuzz=0.3)}[name]
        j_scene, j_cam = _fullframe(mat, w, h)
    spp, depth = 2, 3
    rad_ref = _jax_reference_rad(j_scene, j_cam, w, h, spp, depth)
    j_params = jdiff.partition(j_scene)

    t_scene, t_cam = helpers.port(j_scene, j_cam)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    params, camera = helpers.grad_leaves(t_scene, t_cam)
    rad_t = render.trace_tiles_diff(diff.combine(t_scene, params), camera,
                                    cfg, 0, device="cpu")[0]

    rr, vjp = jax.vjp(jax.jit(rad_ref), j_params, j_cam)
    rr = np.asarray(rr)
    rt = rad_t.detach().numpy()
    agree = (np.abs(rt - rr) < 1e-3).all(axis=1)
    assert agree.mean() >= 0.985, agree.mean()
    weight = np.sin(np.arange(w * h) * 0.1) * agree
    mix = np.array([1.0, 0.7, 0.3], np.float32)
    wm = (weight[:, None] * mix).astype(np.float32)

    gp, gc = vjp(jnp.asarray(wm))
    got = helpers.field_grads((torch.from_numpy(wm) * rad_t).sum(), params,
                              camera)
    assert np.abs(np.asarray(gp["sphere_radius"])).max() > 0
    for k in sorted(gp):
        a, b = got[k], np.asarray(gp[k])
        assert np.isfinite(a).all(), k
        scale = max(np.abs(b).max(), 1e-4)
        close = np.abs(a - b) <= 2e-3 * scale
        if a.size > 64:
            assert close.mean() >= 0.995, (k, close.mean())
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * scale,
                                       err_msg=k)
    cam_max = max(np.abs(np.asarray(getattr(gc, f.name))).max()
                  for f in dataclasses.fields(gc))
    for f in dataclasses.fields(gc):
        b = np.asarray(getattr(gc, f.name))
        scale = max(np.abs(b).max(), 1e-3 * cam_max)
        np.testing.assert_allclose(got["camera." + f.name], b, rtol=0,
                                   atol=1e-2 * scale + cam_slack * cam_max,
                                   err_msg=f.name)


def test_sgd_step_matches_reference():
    """The port's make_train_step against rrt_tpu's (its scan path on
    the CPU, which draws the tile path's keys), full-frame lambertian."""
    w, h, lr = 24, 16, 0.5
    j_scene, j_cam = _fullframe(lambda b: b.lambertian((0.6, 0.3, 0.2)),
                                w, h)
    j_cfg = rrt_tpu.RenderConfig(width=w, height=h, spp=4, max_depth=4,
                                 tile_pixels=w * h, samples_per_pass=4)
    target = np.random.default_rng(0).uniform(0, 0.5, (h, w, 3)).astype(
        np.float32)
    j_new, j_cam_new, j_loss = jdiff.make_train_step(j_cfg, lr=lr)(
        j_scene, j_cam, jnp.asarray(target), 0)
    # The step's own gradient, (p - p') / lr, sets the scale.
    j_grads = {k: (np.asarray(getattr(j_scene, k))
                   - np.asarray(getattr(j_new, k))) / lr
               for k in jdiff.DIFFERENTIABLE_FIELDS}

    t_scene, t_cam = helpers.port(j_scene, j_cam)
    cfg = render.RenderConfig(width=w, height=h, spp=4, max_depth=4)
    t_new, t_cam_new, t_loss = diff.make_train_step(cfg, lr=lr,
                                                    device="cpu")(
        t_scene, t_cam, torch.from_numpy(target), 0)

    assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-4)
    assert np.abs(j_grads["tex_color1"]).max() > 0
    for k, g in j_grads.items():
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(
            getattr(t_new, k).numpy(), np.asarray(getattr(j_new, k)),
            rtol=0, atol=2e-3 * scale * lr + 1e-7, err_msg=k)
    moved = t_new.tex_color1 - t_scene.tex_color1
    assert moved.abs().max() > 0
    # The camera by the camera rule: within 1e-2 of the largest camera
    # gradient, times lr.
    j_cam_grads = {f.name: (np.asarray(getattr(j_cam, f.name))
                            - np.asarray(getattr(j_cam_new, f.name))) / lr
                   for f in dataclasses.fields(j_cam)}
    cam_max = max(np.abs(g).max() for g in j_cam_grads.values())
    assert cam_max > 0
    for f in dataclasses.fields(t_cam_new):
        got = getattr(t_cam_new, f.name).numpy()
        assert np.isfinite(got).all(), f.name
        np.testing.assert_allclose(
            got, np.asarray(getattr(j_cam_new, f.name)), rtol=0,
            atol=1e-2 * cam_max * lr + 1e-7, err_msg=f.name)


def test_trace_tiles_sample_ranges_add_up():
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=4, max_depth=4)
    full, n_full = render.trace_tiles(scene, cam, cfg, 0, device="cpu")
    lo, n_lo = render.trace_tiles(scene, cam, cfg, 0, 0, 3, device="cpu")
    hi, n_hi = render.trace_tiles(scene, cam, cfg, 0, 3, 1, device="cpu")
    torch.testing.assert_close(lo + hi, full, rtol=1e-6, atol=1e-6)
    assert int(n_lo) + int(n_hi) == int(n_full)


def test_no_nan_gradients_on_masked_branches():
    """A fuzz-0 metal, glass seen at total internal reflection (a
    hollow-free ball close to the camera, rays leaving it at grazing
    angles) and rays that miss: every gradient stays finite."""
    b = SceneBuilder()
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    b.sphere((0.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.8, 0.8), fuzz=0.0))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.dielectric(2.4))
    b.sphere((-1.0, 0.0, -1.0), 0.5, b.dielectric(1.5))
    from rrt_tpu_torch.camera import Camera
    cam = Camera.create(look_from=(0.0, 0.5, 1.5), look_at=(0.0, 0.0, -1.0),
                        fov_deg=60.0, aspect=2.0, aperture=0.05,
                        focus_dist=2.5)
    scene = b.build()
    cfg = render.RenderConfig(width=24, height=12, spp=2, max_depth=8)
    params, camera = helpers.grad_leaves(scene, cam)
    img, _ = render.render_image_diff(diff.combine(scene, params), camera,
                                      cfg, 0, device="cpu")
    got = helpers.field_grads(img.sum(), params, camera)
    for k, g in got.items():
        assert np.isfinite(g).all(), k
    assert np.abs(got["mat_ior"]).max() > 0
    assert np.abs(got["bg_top"]).max() > 0


def test_out_of_scope_scenes_raise():
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=1, max_depth=2)
    # More boxes or quads than SOLID_CAP (rttnw_final's ground): the train
    # kernels take them (train_fwd walks their tree, train_bwd loops), and
    # so does the chain (its replay walks their tree, #9.5's chain part),
    # so both routes pass their scope checks on a CUDA device; on the CPU
    # the train step runs.
    many = dataclasses.replace(scene, n_boxes_active=tmk.SOLID_CAP + 1)
    render._check_card_scope("render_image_diff", many, "cuda")
    render._check_chain_card_scope("render_image(differentiable=True)",
                                   many, "cuda")
    assert tmkv.backward_scope_gap(many) is None
    # Russian roulette (#9.6) takes the train kernels' route: no fallback,
    # and the roulette kills paths.
    rr = dataclasses.replace(cfg, rr_depth=1)
    assert render.diff_fallback_reason(scene, rr) is None
    img, n = render.render_image_diff(scene, cam, rr, 0, device="cpu")
    _, n0 = render.render_image_diff(scene, cam, cfg, 0, device="cpu")
    assert torch.isfinite(img).all() and int(n) < int(n0)
    step = diff.make_train_step(dataclasses.replace(cfg, samples_per_pass=1),
                                device="cpu")
    _, _, loss = step(dataclasses.replace(
        scene, n_quads_active=tmk.SOLID_CAP + 1), cam,
        torch.zeros((8, 16, 3)), 0)
    assert torch.isfinite(loss)
    # With a mesh, what raises is a mesh whose world is not the process
    # group's (here no group: a world of one).
    with pytest.raises(ValueError, match="world of 1"):
        diff.render_loss(diff.partition(scene), cam, scene,
                         torch.zeros((8, 16, 3)), cfg, 0,
                         mesh=pmesh.Mesh(2, 1, 0, 0, torch.device("cpu")),
                         device="cpu")
    assert render.diff_fallback_reason(scene, cfg) is None


def test_record_cap_raises():
    scene, cam = helpers.chap12_small()
    cfg = render.RenderConfig(width=16, height=8, spp=1,
                              max_depth=tmkt.MAX_RECORDS)
    with pytest.raises(ValueError, match="records"):
        render.trace_tiles_diff(scene, cam, cfg, 0, device="cpu")


def test_resolve_spp_chunk(monkeypatch, caplog):
    # 33 bytes a path (tmkt.boundary_residual_bytes): 31.68 MB a sample
    # at 1200x800.
    cfg = render.RenderConfig(width=1200, height=800, spp=500, max_depth=50)
    monkeypatch.setenv("RRT_RESIDUAL_BUDGET_GB", "16")
    # 15.84 GB: one chunk
    assert diff.resolve_spp_chunk(cfg, device="cpu") == 500
    monkeypatch.setenv("RRT_RESIDUAL_BUDGET_GB", "4")
    # largest divisor <= 126
    assert diff.resolve_spp_chunk(cfg, device="cpu") == 125
    monkeypatch.setenv("RRT_RESIDUAL_BUDGET_GB", "16")
    with caplog.at_level(logging.WARNING, logger="rrt_tpu_torch.diff"):
        assert diff.resolve_spp_chunk(cfg, spp_chunk=300,
                                      device="cpu") == 250
    assert "adjusted to 250" in caplog.text
    assert diff.resolve_spp_chunk(cfg, spp_chunk=100, device="cpu") == 100
    monkeypatch.setenv("RRT_RESIDUAL_BUDGET_GB", "0.0001")
    with pytest.raises(ValueError, match="budget"):
        diff.resolve_spp_chunk(cfg, device="cpu")
    monkeypatch.delenv("RRT_RESIDUAL_BUDGET_GB")
    assert diff._residual_budget_bytes("cpu") > 0
    assert tmkt.boundary_residual_bytes(1200 * 800, 500) == 15_840_000_000
    with pytest.raises(TypeError):
        diff.resolve_spp_chunk(cfg)  # the device is required


def test_make_train_step_routes_by_budget():
    small = render.RenderConfig(width=8, height=8, spp=256)
    big = dataclasses.replace(small, spp=4 * render.DIFF_SAMPLE_BUDGET + 4)
    assert diff.make_train_step(small, device="cpu").__qualname__.startswith(
        "_make_train_step_oneshot")
    assert diff.make_train_step(big, device="cpu").__qualname__.startswith(
        "make_train_step_chunked")


def test_params_and_camera_round_trip():
    scene, cam = helpers.chap12_small()
    leaves = convert.params_to_numpy(diff.partition(scene))
    back = convert.params_from_numpy(leaves)
    for k, v in diff.partition(scene).items():
        assert torch.equal(back[k], v), k
    cam2 = convert.camera_from_numpy(convert.camera_to_numpy(cam))
    for f in dataclasses.fields(cam):
        assert torch.equal(getattr(cam2, f.name), getattr(cam, f.name))
