"""The CUDA kernels on the card: tile_render, the train kernels, the
queue and batch drivers' kernels and the bounce chain's backward
(marked `cuda`; skip without a CUDA device).

This file imports neither JAX nor rrt_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
packs. tile_render: the tolerance of tests/test_torch_slice.py,
per-pixel mean |delta| < 1e-3 on >= 98.5% of pixels, traced totals
within 1%; its BVH walk gives train_fwd's scan's paths bit for bit.
train_fwd: tile_render's outputs bit for bit, and its
winners the plain version's on every path that agrees. train_bwd,
bounce_steps, intersect_only and chain_bwd: the tolerances stated in
each test."""

import dataclasses

import pytest
import torch

from rrt_tpu_torch import accel, cli
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import SceneBuilder

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _checker_scene(w, h):
    """The kernel's checker-texture and solid-background branches, which
    no canned scene reaches (tests/test_torch_tile_render.py holds the
    same scene's plain physics against rrt_tpu)."""
    b = SceneBuilder()
    tex = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(tex))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), fuzz=0.3))
    b.sphere((-2.5, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.solid_background((0.3, 0.4, 0.5))
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=w / h, aperture=0.1,
                        focus_dist=10.0)
    return b.build(), cam


def _packs(device, name="chap12", w=64, h=32):
    build = _checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    return (tmk.pack_spheres_full(scene).to(device),
            tmk.pack_camera(cam, w, h).to(device),
            tmk.pack_bg(scene).to(device))


def _tree(sph, cam=None):
    """The sphere pack's BVH, which tile_render and intersect_only walk,
    over the camera pack's shutter (rows 19-20)."""
    shutter = None if cam is None else (cam[19], cam[19] + cam[20])
    return accel.pack_bvh(sph, shutter)


def _tiles(packs, **kw):
    """render_tiles on the packs (sph, cam, bg) with their BVH."""
    return tmk.render_tiles(*packs, bvh=_tree(packs[0], packs[1]), **kw)


def _kw(**over):
    kw = dict(seed_words=(0, 0), sample_lo=0, width=64, height=32, spp=4,
              max_depth=8, t_min=1e-3, moving=False)
    kw.update(over)
    return kw


def _assert_close(a, b, spp):
    (rad, traced), (ref, ref_traced) = a, b
    close = (rad - ref).abs().max(dim=1).values / spp < 1e-3
    assert close.float().mean().item() >= 0.985
    nt, nr = int(traced.sum()), int(ref_traced.sum())
    assert abs(nt - nr) / nr < 1e-2


@pytest.mark.parametrize("name", ["chap12", "chap11", "diffuse", "checker"])
@pytest.mark.parametrize("seed_words", [(0, 0), (0, 7)])
def test_kernel_matches_plain_version(device, name, seed_words):
    packs = _packs(device, name)
    kw = _kw(seed_words=seed_words)
    before = tmk.render_tiles.launches
    out = _tiles(packs, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    assert out[0].device == packs[0].device and out[1].dtype == torch.int32
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)


def test_kernel_is_deterministic(device):
    packs = _packs(device)
    a = _tiles(packs, **_kw())
    b = _tiles(packs, **_kw())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sample_ranges_add_up(device):
    """Samples [0,2) + [2,4) are the paths of samples [0,4)."""
    packs = _packs(device)
    lo = _tiles(packs, **_kw(spp=2))
    hi = _tiles(packs, **_kw(spp=2, sample_lo=2))
    full = _tiles(packs, **_kw())
    torch.testing.assert_close(lo[0] + hi[0], full[0], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(lo[1] + hi[1], full[1])


def test_too_many_slots_raise(device):
    sph, cam, bg = _packs(device)
    wide = sph.repeat(1, tmk.MAX_SLOTS // sph.shape[1] + 1).contiguous()
    with pytest.raises(ValueError, match="slots"):
        tmk.render_tiles(wide, cam, bg, **_kw())


def test_cli_launches_the_kernel(device, tmp_path):
    out = tmp_path / "chap12.png"
    before = tmk.render_tiles.launches
    assert cli.main(["--scene", "chap12", "-r", "64x32", "-s", "4",
                     "--max-depth", "8", "--device", str(device),
                     "-o", str(out), "--quiet"]) == 0
    assert tmk.render_tiles.launches == before + 1
    assert out.stat().st_size > 0


# ---------------------------------------------------------------------------
# The train kernels (csrc/train.cu)
# ---------------------------------------------------------------------------

_MIX = (1.0, 0.7, 0.3)


def _train_case(device, name, w=64, h=32, spp=4, depth=8):
    from rrt_tpu_torch import render
    build = _checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    return scene, cam, cfg, packs, _kw(width=w, height=h, spp=spp,
                                        max_depth=depth,
                                        moving=scene.has_moving)


@pytest.mark.parametrize("name", ["chap12", "chap11", "diffuse", "checker"])
def test_train_fwd_equals_tile_render(device, name):
    _, _, _, packs, kw = _train_case(device, name)
    before = tmkt.render_tiles_train.launches
    rad, traced, lengths, _ = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = _tiles(packs, **kw)
    torch.cuda.synchronize(device)
    assert tmkt.render_tiles_train.launches == before + 1
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_tile_render_walk_equals_train_fwd_scan(device, name):
    """tile_render walks the BVH, train_fwd scans every slot: the same
    winners and t bit for bit, so the same paths, radiance and traced
    counts at 240x160, 4 spp, depth 50, static and moving."""
    _, _, _, packs, kw = _train_case(device, name, 240, 160, 4, 50)
    rad, traced, _, _ = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = _tiles(packs, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert int(traced.sum()) > 240 * 160 * 4 * 2


def test_walking_kernels_raise_without_the_bvh(device):
    """On the card every kernel but the train kernels walks the BVH or
    raises: tile_render, intersect_only, bounce_steps and chain_bwd; a
    pack built for other spheres raises too."""
    sph, cam, bg = _packs(device)
    with pytest.raises(ValueError, match="BVH"):
        tmk.render_tiles(sph, cam, bg, **_kw())
    o = torch.zeros((3, 8), device=device)
    with pytest.raises(ValueError, match="BVH"):
        tmk.intersect_only(o, o + 1.0, sph, t_min=1e-3)
    other = _tree(sph[:, :128].contiguous())
    with pytest.raises(ValueError, match="slots"):
        tmk.intersect_only(o, o + 1.0, sph, t_min=1e-3, bvh=other)
    st, keys, sph, bg = _lane_state(device)
    kw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=False)
    with pytest.raises(ValueError, match="BVH"):
        tmk.bounce_steps(st.clone(), keys, sph, bg, **kw)
    with pytest.raises(ValueError, match="slots"):
        tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=other, **kw)
    ob = st[tmk.ROW_BOUNCE].clone()
    with pytest.raises(ValueError, match="BVH"):
        tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st), ob, **kw)
    with pytest.raises(ValueError, match="slots"):
        tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st), ob,
                           bvh=other, **kw)


@pytest.mark.parametrize("name", ["chap12", "chap11", "diffuse", "checker"])
def test_train_bwd_matches_plain_version(device, name):
    """Kernel gradients against tiles_adjoint_reference on the card, by
    the rule of rrt_tpu_torch.gradcheck (which says why): pixels with a
    sample whose forward differs from the plain version's (radiance
    beyond 1e-3 relative, or its bounce count) get loss weight 0, and
    are at most 1%; the partition() and
    Camera gradients then follow tests/test_tile_grad.py's rule."""
    from rrt_tpu_torch import diff, gradcheck
    scene, cam, cfg, packs, kw = _train_case(device, name)
    _, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    n = kw["width"] * kw["height"]
    weight = torch.sin(torch.arange(n, device=device) * 0.1) * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    before = tmkt.tiles_adjoint.launches
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths,
                                     None, **kw)
    assert tmkt.tiles_adjoint.launches == before + 1
    assert int(k[3]) == 0 and int(p[3]) == 0  # replay_mismatches
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults


def test_albedo_finite_difference(device):
    """d loss / d (ground albedo) against central differences of the
    train_fwd forward: albedo changes no path decision, so the loss is a
    polynomial in it and eps=1e-2 differences agree within 1e-2."""
    from rrt_tpu_torch import diff, render
    scene, cam, cfg, packs, kw = _train_case(device, "chap12", spp=4,
                                             depth=50)
    mix = torch.tensor(_MIX, device=device)
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_rad = mix.expand_as(rad).contiguous()
    d_sph, d_cam, d_bg, _ = tmkt.tiles_adjoint(*packs, d_rad, lengths,
                                               winners, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, d_sph, d_cam, d_bg,
                             device=device)
    tex = int(scene.mat_tex[scene.sphere_mat[0]])

    def loss(delta):
        t1 = scene.tex_color1.clone()
        t1[tex, 0] += delta
        sph = tmk.pack_spheres_full(diff.combine(
            scene, {"tex_color1": t1})).to(device)
        r = tmkt.render_tiles_train(sph, packs[1], packs[2], **kw)[0]
        return (r.double() * mix.double()).sum().item()

    fd = (loss(1e-2) - loss(-1e-2)) / 2e-2
    auto = gp["tex_color1"][tex, 0].item()
    assert auto != 0.0 and abs(auto - fd) <= 1e-2 * abs(fd), (auto, fd)


def test_train_bwd_determinism(device):
    """As csrc/train.cu states: the camera and background cotangents are
    bit-identical from run to run; the pack's are summed with atomic
    reductions and agree within 1e-6 of their largest."""
    _, _, _, packs, kw = _train_case(device, "chap12")
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_rad = torch.ones_like(rad)
    a = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    b = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(a[0], b[0], rtol=0,
                               atol=1e-6 * a[0].abs().max().item())


def test_kernels_run_at_max_slots(device):
    """At tmk.MAX_SLOTS slots the staged packs need shared memory above
    the 48 KB a block gets without the opt-in. Padding with empty slots
    (r^2 = -1) changes no result: the forwards bit for bit, the camera
    and background cotangents bit for bit (fixed-order sums), the pack's
    within the determinism bound, and the empty slots get none."""
    _, _, _, packs, kw = _train_case(device, "chap12")
    sph, rest = packs[0], packs[1:]
    n = sph.shape[1]
    empty = sph[:, -1:]  # chap12's 484 spheres are padded to 512 slots
    assert empty[3].item() == -1.0
    wide = torch.cat([sph, empty.expand(-1, tmk.MAX_SLOTS - n)],
                     dim=1).contiguous()
    ref = _tiles((sph, *rest), **kw)
    out = _tiles((wide, *rest), **kw)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    rad, traced, lengths, winners = tmkt.render_tiles_train(wide, *rest,
                                                            **kw)
    assert torch.equal(rad, ref[0]) and torch.equal(traced, ref[1])
    d_rad = torch.ones_like(rad)
    g = tmkt.tiles_adjoint(sph, *rest, d_rad, lengths, winners, **kw)
    gw = tmkt.tiles_adjoint(wide, *rest, d_rad, lengths, winners, **kw)
    assert int(gw[3]) == 0
    assert torch.equal(gw[1], g[1]) and torch.equal(gw[2], g[2])
    torch.testing.assert_close(gw[0][:, :n], g[0], rtol=0,
                               atol=1e-6 * g[0].abs().max().item())
    assert not gw[0][:, n:].any()


# train_bwd's camera and background cotangents on _train_case(chap12)
# with d_rad = 1, as the kernel gave them before its adjoints moved into
# csrc/adjoint.cuh (H100 80GB HBM3, CUDA 12.8, nvcc -fmad=false): they
# are sums in a fixed order, so bit-identical from run to run.
TRAIN_BWD_BG = ("0x1.296f8ep+10", "0x1.29d968p+10", "0x1.1bcdecp+10",
                "0x1.48a512p+11", "0x1.4887f6p+11", "0x1.31e684p+11")
TRAIN_BWD_CAM_BG_SHA = "8303079e42f74fa7"


def test_train_bwd_unchanged_by_the_shared_header(device):
    """The move of miss_adjoint and scatter_adjoint into adjoint.cuh
    (miss_adjoint now adds to the cotangents it is given, zeroed here)
    left train_bwd's outputs as they were, and so did its replay from the
    forward's winners: the camera and background cotangents bit for bit,
    the pack's (atomics) as a sum within 1e-6."""
    import hashlib
    _, _, _, packs, kw = _train_case(device, "chap12")
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_sph, d_cam, d_bg, mism = tmkt.tiles_adjoint(
        *packs, torch.ones_like(rad), lengths, winners, **kw)
    assert int(mism) == 0
    assert [float(x).hex() for x in d_bg[:6].cpu()] == [
        float.fromhex(h).hex() for h in TRAIN_BWD_BG]
    blob = d_cam.cpu().numpy().tobytes() + d_bg.cpu().numpy().tobytes()
    assert hashlib.sha256(blob).hexdigest()[:16] == TRAIN_BWD_CAM_BG_SHA
    assert abs(d_sph.double().sum().item() - 11716.329432595001) \
        <= 1e-6 * 11716.33


def test_train_record_cap_raises(device):
    _, _, _, packs, kw = _train_case(device, "chap12")
    kw["max_depth"] = tmkt.MAX_RECORDS
    with pytest.raises(ValueError, match="records"):
        tmkt.render_tiles_train(*packs, **kw)
    rad = torch.zeros((64 * 32, 3), device=device)
    lengths = torch.ones((4, 64 * 32), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="records"):
        tmkt.tiles_adjoint(*packs, rad, lengths, None, **kw)


@pytest.mark.parametrize("name", ["chap12", "checker", "book2chap2"])
def test_train_fwd_winners_match_plain_version(device, name):
    """The forward's winners against the plain version's on every path
    gradcheck.sample_agreement counts as agreeing, depth 50 on chap12:
    every stored segment of those paths, which hold 95% of the segments
    or more (the paths that part ways are long ones)."""
    from rrt_tpu_torch import gradcheck
    depth = 50 if name == "chap12" else 8
    _, _, _, packs, kw = _train_case(device, name, depth=depth)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    assert winners.shape == (tmkt.WINNERS_PER_SAMPLE * kw["spp"],
                             kw["width"] * kw["height"])
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.path_share >= 0.99
    faults, compared, _ = gradcheck.winner_faults(winners, lengths,
                                                  agreement)
    assert faults == 0 and compared >= 0.95 * int(traced.sum())
    stored = winners[:, traced > 0]
    assert (stored == -1).any() and (stored >= 0).any()


@pytest.mark.parametrize("name", ["chap12", "checker", "book2chap2"])
def test_train_fwd_pooled_winners_match_each_sample_alone(device, name):
    """The forward's pooled winners equal its own winners of each sample
    traced alone (gradcheck.pool_faults), entry for entry: the same code
    traces the same paths, so only a fault in the pool's layout parts
    them."""
    from rrt_tpu_torch import gradcheck
    depth = 50 if name == "chap12" else 8
    _, _, _, packs, kw = _train_case(device, name, depth=depth)
    _, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    faults, compared = gradcheck.pool_faults(winners, lengths, agreement)
    assert faults == 0 and compared >= 0.95 * int(traced.sum())


@pytest.mark.parametrize("name", ["chap12", "checker", "book2chap2"])
def test_train_bwd_with_and_without_winners(device, name):
    """tiles_adjoint from the forward's winners, from a pool cut to one
    entry a sample (most segments past it scan), and from the scan alone
    (winners=None): the same replayed arithmetic, so the camera and
    background cotangents bit for bit; the pack's (atomics) within 1e-5
    of their largest; no mismatches."""
    depth = 50 if name == "chap12" else 8
    _, _, _, packs, kw = _train_case(device, name, depth=depth)
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_rad = torch.sin(torch.arange(rad.numel(), device=device) * 0.3
                      ).reshape(rad.shape).contiguous()
    scan = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    assert int(scan[3]) == 0
    for pool in (winners, winners[:kw["spp"]]):
        got = tmkt.tiles_adjoint(*packs, d_rad, lengths, pool, **kw)
        assert int(got[3]) == 0
        assert torch.equal(got[1], scan[1]) and torch.equal(got[2], scan[2])
        torch.testing.assert_close(got[0], scan[0], rtol=0,
                                   atol=1e-5 * scan[0].abs().max().item())


def test_train_bwd_counts_bad_winners(device):
    """A stored winner the replay cannot find (here an empty slot, r^2 =
    -1, in place of a hit) counts as a replay mismatch, and so does a
    length that differs from the replay's."""
    _, _, _, packs, kw = _train_case(device, "chap12")
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    d_rad = torch.ones_like(rad)
    empty = packs[0].shape[1] - 1
    assert packs[0][3, empty].item() == -1.0
    bad = winners.clone()
    pix = (bad[0] >= 0).nonzero()[0, 0].item()
    bad[0, pix] = empty
    assert int(tmkt.tiles_adjoint(*packs, d_rad, lengths, bad, **kw)[3]) == 1
    longer = lengths.clone()
    longer[0, pix] += 1
    assert int(tmkt.tiles_adjoint(*packs, d_rad, longer, winners,
                                  **kw)[3]) >= 1


def test_train_step_launches_the_kernels(device):
    from rrt_tpu_torch import diff, render
    scene, cam = tscenes.chap12_scene(64, 32)
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=8)
    fwd, bwd = tmkt.render_tiles_train.launches, tmkt.tiles_adjoint.launches
    tmkt.tiles_adjoint.replay_mismatches = 0
    new_scene, new_cam, loss = diff.make_train_step(cfg, device=device)(
        scene, cam, torch.zeros((32, 64, 3)), 0)
    assert tmkt.render_tiles_train.launches == fwd + 1
    assert tmkt.tiles_adjoint.launches == bwd + 1
    mismatches = tmkt.tiles_adjoint.replay_mismatches
    assert mismatches.device == torch.device(device) and int(mismatches) == 0
    assert torch.isfinite(loss)
    assert not torch.equal(new_scene.tex_color1.cpu(), scene.tex_color1)


# ---------------------------------------------------------------------------
# The queue and batch drivers' kernels (csrc/queue.cu)
# ---------------------------------------------------------------------------


def _lane_state(device, name="chap12", w=64, h=32):
    """A queue state of camera rays (16, w*h) at sample 0, its key bits
    (2, w*h) and the packs, on the device."""
    from rrt_tpu_torch import render, rng
    build = _checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    n = w * h
    ids = torch.arange(n, device=device)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam.to(device), ids % w, ids // w, w, h,
                                    keys)
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    return (st, rng.u32_bits(keys), tmk.pack_spheres_full(scene).to(device),
            tmk.pack_bg(scene).to(device))


def _lane_tree(sph, name="chap12"):
    """The BVH the queue kernels walk on _lane_state's lanes: over the
    camera's shutter, as render.trace_queue builds it."""
    return _tree(sph, _packs(sph.device, name)[1])


@pytest.mark.parametrize("k_steps", [1, 4])
@pytest.mark.parametrize("name", ["chap12", "checker"])
def test_bounce_steps_matches_plain_version(device, name, k_steps):
    """The rule of tests/test_torch_queue.py, with the card's own spread
    (kernel and plain agreed on 99.995% of lanes at full size, both
    rounding every product): alive agrees on >= 99.9% of lanes; on
    those, traced and bounce are equal and throughput and pending
    radiance agree within 1e-3 on >= 99.5%."""
    st, keys, sph, bg = _lane_state(device, name)
    kw = dict(k_steps=k_steps, max_depth=50, t_min=1e-3, moving=False)
    before = tmk.bounce_steps.launches
    out = tmk.bounce_steps(st.clone(), keys, sph, bg,
                           bvh=_lane_tree(sph, name), **kw)
    torch.cuda.synchronize(device)
    assert tmk.bounce_steps.launches == before + 1
    ref = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.float().mean() >= 0.999
    assert torch.equal(out[15][agree], ref[15][agree])
    assert torch.equal(out[13][agree], ref[13][agree])
    close = ((out[7:13] - ref[7:13]).abs() < 1e-3).all(dim=0)[agree]
    assert close.float().mean() >= 0.995
    assert int(out[15].sum()) >= st.shape[1]


def test_bounce_steps_dead_lanes_pass_through(device):
    st, keys, sph, bg = _lane_state(device)
    st[14] = 0.0
    st[15] = 7.0
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, k_steps=4,
                           max_depth=50, t_min=1e-3, moving=False,
                           bvh=_lane_tree(sph))
    assert torch.equal(out, st)


@pytest.mark.parametrize("bounces", [0, 2, 4])
@pytest.mark.parametrize("name", ["chap12", "checker"])
def test_intersect_only_matches_plain_version(device, name, bounces):
    """Camera rays, and the rays after `bounces` bounce steps (secondary
    rays leave sphere surfaces, where t_min decides self-hits; dead lanes
    keep their last ray, as in trace_batch): fam and idx equal on >=
    99.9% of rays (the card measured 100% at full size); t within 1e-5
    relative where they agree (both versions round every product)."""
    from rrt_tpu_torch import render
    st, keys, sph, bg = _lane_state(device, name)
    if bounces:
        tmk.bounce_steps(st, keys, sph, bg, k_steps=bounces, max_depth=50,
                         t_min=1e-3, moving=False, bvh=_lane_tree(sph, name))
    o, d = st[0:3], st[3:6]
    before = tmk.intersect_only.launches
    t, fam, idx = tmk.intersect_only(o, d, sph, t_min=1e-3, bvh=_tree(sph))
    torch.cuda.synchronize(device)
    assert tmk.intersect_only.launches == before + 1
    rt, rfam, ridx = tmk.intersect_only_reference(o, d, sph, t_min=1e-3)
    same = (fam == rfam) & (idx == ridx)
    assert same.float().mean() >= 0.999
    hit = same & (fam == 0)
    assert hit.any()
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-5, atol=0)
    assert torch.equal(t[same & (fam == -1)], rt[same & (fam == -1)])
    miss = fam == -1
    assert miss.any() and bool((t[miss] == render.INF).all())


def test_queue_image_matches_tile_image(device):
    """The queue's bounces are tile_render's (bounce.cuh), but its camera
    rays come from eager PyTorch, whose last bits differ from the
    kernel's camera_ray; over depth-50 chap12 paths that parts as many
    paths as it does between tile_render and its plain version, 0.13% of
    traced segments at 240x160 (the queue: 0.23% at 4 spp, H100). So the
    rule is chip_smoke.py [3]'s at 240x160: image means and traced totals
    within 1%, >= 90% of pixels within 1e-3."""
    from rrt_tpu_torch import render
    scene, cam = tscenes.chap12_scene(240, 160)
    cfg = render.RenderConfig(width=240, height=160, spp=4, max_depth=50,
                              queue_size=16384)
    before = tmk.bounce_steps.launches
    iq, nq = render.render_image_queue(scene, cam, cfg, 0, device=device)
    assert tmk.bounce_steps.launches > before
    it, nt = render.render_image_tiles(scene, cam, cfg, 0, device=device)
    mq, mt = iq.mean(dim=(0, 1)), it.mean(dim=(0, 1))
    assert ((mq - mt).abs() / mt).max() < 1e-2
    assert abs(int(nq) - int(nt)) / int(nt) < 1e-2
    close = (iq - it).abs().amax(dim=2) < 1e-3
    assert close.float().mean() >= 0.9


def test_queue_kernels_run_at_max_slots(device):
    """At MAX_SLOTS padding with empty slots (r^2 = -1), which the BVH
    leaves out, changes no bit."""
    st, keys, sph, bg = _lane_state(device)
    n = sph.shape[1]
    wide = torch.cat([sph, sph[:, -1:].expand(-1, tmk.MAX_SLOTS - n)],
                     dim=1).contiguous()
    a = tmk.bounce_steps(st.clone(), keys, sph, bg, k_steps=4, max_depth=50,
                         t_min=1e-3, moving=False, bvh=_tree(sph))
    b = tmk.bounce_steps(st.clone(), keys, wide, bg, k_steps=4,
                         max_depth=50, t_min=1e-3, moving=False,
                         bvh=_tree(wide))
    assert torch.equal(a, b)
    for x, y in zip(tmk.intersect_only(st[0:3], st[3:6], sph, t_min=1e-3,
                                       bvh=_tree(sph)),
                    tmk.intersect_only(st[0:3], st[3:6], wide, t_min=1e-3,
                                       bvh=_tree(wide))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("driver,kernel", [("queue", "bounce_steps"),
                                           ("batch", "intersect_only")])
def test_cli_drivers_launch_their_kernels(device, tmp_path, driver, kernel):
    wrapper = getattr(tmk, kernel)
    before = wrapper.launches
    assert cli.main(["--scene", "chap12", "-r", "64x32", "-s", "4",
                     "--max-depth", "8", "--driver", driver,
                     "--spp-chunk", "2", "--device", str(device),
                     "-o", str(tmp_path / "o.png"), "--quiet"]) == 0
    assert wrapper.launches > before
    assert (tmp_path / "o.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# The bounce chain's backward (csrc/chain.cu)
# ---------------------------------------------------------------------------


def _chain_case(device, name="chap12", k_steps=4, pre_steps=0):
    """A lane state after `pre_steps` kernel bounce steps, the kernel's
    output after k_steps more, a seeded output cotangent, the plain
    versions' keywords and the BVH both kernels walk."""
    st, keys, sph, bg = _lane_state(device, name)
    moving = name == "book2chap2"
    bvh = _lane_tree(sph, name)
    kw = dict(k_steps=k_steps, max_depth=50, t_min=1e-3, moving=moving)
    if pre_steps:
        tmk.bounce_steps(st, keys, sph, bg, bvh=bvh,
                         **dict(kw, k_steps=pre_steps))
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_out = torch.randn((16, st.shape[1]), generator=gen).to(device)
    return st, keys, sph, bg, out, d_out, kw, bvh


@pytest.mark.parametrize("k_steps,pre_steps", [(4, 0), (1, 0), (12, 3)])
@pytest.mark.parametrize("name", ["chap12", "checker"])
def test_chain_bwd_matches_plain_version(device, name, k_steps, pre_steps):
    """chain_bwd against chain_adjoint_reference on the same state, by
    chip_smoke.py [C1]'s rule: on the lanes whose kernel and plain
    forwards agree (bounce and alive rows equal, rows 0-12 within 1e-3
    absolute and relative; the others get a zero cotangent) the input
    cotangent within 1e-3 of each row's largest on >= 99.5% of lanes,
    the pack's and the background's within 1e-3 of their largest; each
    replay retraces its own forward."""
    st, keys, sph, bg, out, d_out, kw, bvh = _chain_case(
        device, name, k_steps, pre_steps)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    d_out = d_out * agree
    before = tmkv.chain_adjoint.launches
    k = tmkv.chain_adjoint(st, keys, sph, bg, d_out,
                           out[tmk.ROW_BOUNCE].clone(), bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmkv.chain_adjoint.launches == before + 1
    p = tmkv.chain_adjoint_reference(st, keys, sph, bg, d_out,
                                     ref_out[tmk.ROW_BOUNCE].clone(), **kw)
    assert int(k[3]) == 0 and int(p[3]) == 0
    assert not k[0][13:].any()
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    assert lane_ok.float().mean() >= 0.995
    for got, exp in zip(k[1:3], p[1:3]):
        torch.testing.assert_close(got, exp, rtol=0,
                                   atol=1e-3 * exp.abs().max().item())


@pytest.mark.parametrize("name", ["chap12", "book2chap2"])
def test_chain_bwd_determinism(device, name):
    """As csrc/chain.cu states: the input and background cotangents are
    bit-identical from run to run; the pack's are summed with four-float
    atomic reductions in device memory and agree within 1e-5 of their
    largest (chip_smoke.py PACK_SPREAD)."""
    st, keys, sph, bg, out, d_out, kw, bvh = _chain_case(device, name)
    ob = out[tmk.ROW_BOUNCE].clone()
    a = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    b = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(a[1], b[1], rtol=0,
                               atol=1e-5 * a[1].abs().max().item())


def test_chain_bwd_dead_lanes_pass_through(device):
    st, keys, sph, bg, _, d_out, kw, bvh = _chain_case(device)
    st[tmk.ROW_ALIVE] = 0.0
    d_st, d_sph, d_bg, mism = tmkv.chain_adjoint(
        st, keys, sph, bg, d_out, st[tmk.ROW_BOUNCE].clone(), bvh=bvh, **kw)
    assert torch.equal(d_st[:13], d_out[:13]) and not d_st[13:].any()
    assert not d_sph.any() and not d_bg.any() and int(mism) == 0


@pytest.mark.parametrize("name,cap", [("chap12", tmk.MAX_SLOTS),
                                      ("book2chap2", tmkv.MAX_SLOTS_MOVING)])
def test_chain_bwd_runs_at_max_slots(device, name, cap):
    """Empty slots (r^2 = -1) up to the backwards' cap (3,072 static,
    2,048 moving slots), which the BVH leaves out, change no input
    cotangent and no background one (fixed-order sums) and get no pack
    cotangent; the pack's agree within the atomics' order."""
    st, keys, sph, bg, out, d_out, kw, bvh = _chain_case(device, name)
    n = sph.shape[1]
    wide = torch.cat([sph, sph[:, -1:].expand(-1, cap - n)],
                     dim=1).contiguous()
    ob = out[tmk.ROW_BOUNCE].clone()
    a = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    b = tmkv.chain_adjoint(st, keys, wide, bg, d_out, ob,
                           bvh=_lane_tree(wide, name), **kw)
    assert int(b[3]) == 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    torch.testing.assert_close(b[1][:, :n], a[1], rtol=0,
                               atol=1e-5 * a[1].abs().max().item())
    assert not b[1][:, n:].any()


def test_bounce_chain_launches_both_kernels(device):
    """BounceChain's forward runs bounce_steps on a copy (the saved input
    is untouched), its backward chain_bwd, with no replay mismatch."""
    st, keys, sph, bg, out, _, kw, bvh = _chain_case(device)
    st = st.requires_grad_()
    saved = st.detach().clone()
    fwd, bwd = tmk.bounce_steps.launches, tmkv.chain_adjoint.launches
    tmkv.chain_adjoint.replay_mismatches = 0
    y = tmkv.bounce_chain(kw["k_steps"], 50, 1e-3, False)(st, keys, sph, bg,
                                                           bvh)
    assert torch.equal(st.detach(), saved) and torch.equal(y, out)
    (g,) = torch.autograd.grad(y[10:13].sum(), st)
    assert tmk.bounce_steps.launches == fwd + 1
    assert tmkv.chain_adjoint.launches == bwd + 1
    assert torch.isfinite(g).all() and g[0:10].abs().max() > 0
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0


def test_differentiable_batch_launches_the_chain(device):
    """render_image(differentiable=True) on the card goes through the
    chain's kernels, renders the forward's image within the batch
    driver's rule, and its gradient is finite."""
    from rrt_tpu_torch import render
    scene, cam = tscenes.chap12_scene(64, 32)
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=50)
    color = scene.tex_color1.clone().requires_grad_()
    s = dataclasses.replace(scene, tex_color1=color)
    fwd, bwd = tmk.bounce_steps.launches, tmkv.chain_adjoint.launches
    tmkv.chain_adjoint.replay_mismatches = 0
    img, n = render.render_image(s, cam, cfg, 0, differentiable=True,
                                 device=device)
    (g,) = torch.autograd.grad(img.sum(), color)
    assert tmk.bounce_steps.launches - fwd >= 3
    assert tmkv.chain_adjoint.launches - bwd >= 3
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    assert torch.isfinite(g).all() and g.abs().max() > 0
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0,
                                             device=device)
    assert abs(int(n) - int(n_tile)) / int(n_tile) < 1e-2
    close = (img.detach() - tile).abs().amax(dim=2) < 1e-3
    assert close.float().mean() >= 0.9


# ---------------------------------------------------------------------------
# Moving spheres: each kernel's kMoving variant on a small book2chap2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed_words", [(0, 0), (0, 7)])
def test_moving_tile_render_matches_plain_version(device, seed_words):
    packs = _packs(device, "book2chap2")
    kw = _kw(seed_words=seed_words, moving=True)
    out = _tiles(packs, **kw)
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)
    # The static variant on the same packs renders another image.
    static = _tiles(packs, **_kw(seed_words=seed_words))
    assert (static[0] - out[0]).abs().max() > 1e-2


def test_moving_train_kernels_match_plain_versions(device):
    """train_fwd's moving variant equals tile_render's bit for bit;
    train_bwd's against its plain version by
    test_train_bwd_matches_plain_version's rule, with the velocity rows
    and the shutter's camera rows among the gradients."""
    from rrt_tpu_torch import diff, gradcheck
    scene, cam, cfg, packs, kw = _train_case(device, "book2chap2")
    assert kw["moving"]
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = _tiles(packs, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    n = kw["width"] * kw["height"]
    weight = torch.sin(torch.arange(n, device=device) * 0.1) * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths,
                                     None, **kw)
    assert int(k[3]) == 0 and int(p[3]) == 0  # replay_mismatches
    assert k[0][4:7].abs().max() > 0 and k[1][19:21].abs().max() > 0
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    assert kp["sphere_dc"].abs().max() > 0


@pytest.mark.parametrize("k_steps", [1, 4])
def test_moving_bounce_steps_matches_plain_version(device, k_steps):
    st, keys, sph, bg = _lane_state(device, "book2chap2")
    kw = dict(k_steps=k_steps, max_depth=50, t_min=1e-3, moving=True)
    out = tmk.bounce_steps(st.clone(), keys, sph, bg,
                           bvh=_lane_tree(sph, "book2chap2"), **kw)
    ref = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    assert torch.equal(out[6], st[6])  # the time stays
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.float().mean() >= 0.999
    assert torch.equal(out[15][agree], ref[15][agree])
    assert torch.equal(out[13][agree], ref[13][agree])
    close = ((out[7:13] - ref[7:13]).abs() < 1e-3).all(dim=0)[agree]
    assert close.float().mean() >= 0.995


@pytest.mark.parametrize("bounces", [0, 2, 4])
def test_moving_intersect_only_matches_plain_version(device, bounces):
    st, keys, sph, bg = _lane_state(device, "book2chap2")
    bvh = _lane_tree(sph, "book2chap2")
    if bounces:
        tmk.bounce_steps(st, keys, sph, bg, k_steps=bounces, max_depth=50,
                         t_min=1e-3, moving=True, bvh=bvh)
    o, d, tm = st[0:3], st[3:6], st[6].contiguous()
    t, fam, idx = tmk.intersect_only(o, d, sph, t_min=1e-3, time=tm,
                                     bvh=bvh)
    rt, rfam, ridx = tmk.intersect_only_reference(o, d, sph, t_min=1e-3,
                                                  time=tm)
    same = (fam == rfam) & (idx == ridx)
    assert same.float().mean() >= 0.999
    hit = same & (fam == 0)
    assert hit.any()
    torch.testing.assert_close(t[hit], rt[hit], rtol=1e-5, atol=0)


@pytest.mark.parametrize("k_steps,pre_steps", [(4, 0), (12, 3)])
def test_moving_chain_bwd_matches_plain_version(device, k_steps, pre_steps):
    """test_chain_bwd_matches_plain_version's rule on book2chap2, the
    time row's cotangent included."""
    st, keys, sph, bg, out, _, kw, bvh = _chain_case(
        device, "book2chap2", k_steps, pre_steps)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_out = torch.randn((16, st.shape[1]), generator=gen).to(device) * agree
    k = tmkv.chain_adjoint(st, keys, sph, bg, d_out,
                           out[tmk.ROW_BOUNCE].clone(), bvh=bvh, **kw)
    p = tmkv.chain_adjoint_reference(st, keys, sph, bg, d_out,
                                     ref_out[tmk.ROW_BOUNCE].clone(), **kw)
    assert int(k[3]) == 0 and int(p[3]) == 0
    live = st[tmk.ROW_ALIVE] > 0.5
    assert (k[0][tmk.ROW_TIME, live] != d_out[tmk.ROW_TIME, live]).any()
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    assert lane_ok.float().mean() >= 0.995
    assert k[1][4:7].abs().max() > 0
    for got, exp in zip(k[1:3], p[1:3]):
        torch.testing.assert_close(got, exp, rtol=0,
                                   atol=1e-3 * exp.abs().max().item())


def test_moving_backwards_cap_their_slots(device):
    sph, cam, bg = _packs(device, "book2chap2")
    wide = sph.repeat(1, tmkv.MAX_SLOTS_MOVING // sph.shape[1] + 1)
    kw = _kw(moving=True)
    with pytest.raises(ValueError, match="moving"):
        tmkt.render_tiles_train(wide.contiguous(), cam, bg, **kw)


# ---------------------------------------------------------------------------
# The probes (csrc/probes.cu)
# ---------------------------------------------------------------------------


def test_probe_kernels_match_plain_versions(device):
    """At 8 iterations: the f32 chains bit for bit equal to their plain
    versions (which round once a step, as fmaf does), on values near 1
    and on values between 1e-8 and 1e-6 where the addend moves them by
    at least 12%, the relayout's values equal to the flat chain's, the
    u32 mixers bit for bit."""
    from rrt_tpu_torch.probes import probe_reshape, probe_rng, probe_row_layout
    gen = torch.Generator().manual_seed(0)
    for shape in probe_row_layout.SHAPES:
        near_one = 0.5 + 0.5 * torch.rand(shape, generator=gen)
        small = 10.0 ** (-8.0 + 2.0 * torch.rand(shape, generator=gen))
        for x in (near_one.to(device), small.to(device)):
            y = probe_row_layout.fma_chain(x, iters=8)
            assert not torch.equal(y, x)
            assert torch.equal(
                y, probe_row_layout.fma_chain_reference(x, iters=8))
            if x.numel() % 1024 == 0:
                assert torch.equal(
                    probe_reshape.fma_chain_relayout(x, iters=8), y)
    x = torch.randint(-2**31, 2**31, (1, 1024), generator=gen,
                      dtype=torch.int64).to(torch.int32).to(device)
    for mode in probe_rng.MODES:
        assert torch.equal(probe_rng.mix(x, mode=mode, iters=8),
                           probe_rng.mix_reference(x, mode=mode, iters=8))
