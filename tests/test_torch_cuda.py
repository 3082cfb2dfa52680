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
each test. Each kernel's solid-family variant (quads, boxes, lights) is
held on cornell and scenes.book2.mixed_scene by the same rules, and its
media (constant media, the isotropic material) on cornell_smoke and
scenes.book2.media_scene: bounce_steps and intersect_only bit for bit on
cornell_smoke; the walks over the solid families' trees (the kWalk
variants, with and without kMoving and kTex) on
scenes.book2.many_solids_scene, past SOLID_CAP quads and boxes, each
against its plain version (tile_render and bounce_steps by the rules
above, intersect_only bit for bit), and all three the solid scan's
outputs (accel.solid_scan: the same families as loops) bit for bit;
train_fwd's kWalk variant tile_render's outputs bit for bit, and
train_bwd's loop past SOLID_CAP against its plain version, on
rttnw_final and many_solids_scene."""

import dataclasses

import numpy as np
import pytest
import torch

from rrt_tpu_torch import accel, cli
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.ops import megakernel_vjp as tmkv
from rrt_tpu_torch.scene import SceneBuilder
from rrt_tpu_torch.scenes import book2

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
    d_sph, d_cam, d_bg, _, _, _ = tmkt.tiles_adjoint(*packs, d_rad, lengths,
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
    d_sph, d_cam, d_bg, mism, _, _ = tmkt.tiles_adjoint(
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
    d_st, d_sph, d_bg, mism, _, _ = tmkv.chain_adjoint(
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


# ---------------------------------------------------------------------------
# The solid families: quads, boxes and lights (the Cornell box)
# ---------------------------------------------------------------------------


def _scene(name, w, h):
    """A scene of SCENES, or scenes.book2's mixed_scene or media_scene."""
    if name in ("mixed", "media"):
        return getattr(book2, f"{name}_scene")(w, h)
    return tscenes.SCENES[name](w, h)


def _solid_case(device, name, w=64, h=32, spp=4, depth=8):
    """(packs (sph, cam, bg), the sphere BVH, SolidPacks, render_tiles
    keywords) of cornell, cornell_smoke, the mixed or the media scene on
    the device."""
    from rrt_tpu_torch import render
    scene, cam = _scene(name, w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = tmk.pack_solids(scene, device)
    return packs, bvh, solids, _kw(width=w, height=h, spp=spp,
                                   max_depth=depth, solids=solids)


def _solid_lanes(device, name, w=64, h=32):
    """_lane_state's lanes of _solid_case's scenes, with the BVH and
    SolidPacks."""
    from rrt_tpu_torch import render, rng
    scene, cam = _scene(name, w, h)
    n = w * h
    ids = torch.arange(n, device=device)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam.to(device), ids % w, ids // w, w, h,
                                    keys)
    one, zero = torch.ones((n,), device=device), torch.zeros((n,),
                                                             device=device)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    packed = render.pack_scene(scene, device, render._shutter(cam))
    return (st, rng.u32_bits(keys), packed["sph24"],
            tmk.pack_bg(scene).to(device), packed["bvh"], packed["solids"])


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_tile_render_matches_plain_version(device, name):
    """tile_render's solid-family variant against its plain version, the
    tolerance of tests/test_torch_slice.py."""
    packs, bvh, solids, kw = _solid_case(device, name)
    before = tmk.render_tiles.launches
    out = tmk.render_tiles(*packs, bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)
    assert out[0].max() > 0


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_bounce_steps_matches_plain_version(device, name):
    """bounce_steps' solid-family variant against its plain version, the
    rule of test_bounce_steps_matches_plain_version."""
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, name)
    kw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=False,
              solids=solids)
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.float().mean() >= 0.999
    assert torch.equal(out[15][agree], ref[15][agree])
    assert torch.equal(out[13][agree], ref[13][agree])
    close = ((out[7:13] - ref[7:13]).abs() < 1e-3).all(dim=0)[agree]
    assert close.float().mean() >= 0.995


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_intersect_only_matches_plain_version(device, name):
    """intersect_only's solid-family variant: fam and idx equal on >=
    99.9% of camera rays and rays after 2 bounces, t within 1e-5
    relative where they agree; every family a miss, a quad or a box (and
    on the mixed scene a sphere) appears."""
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, name)
    fams = set()
    for bounces in (0, 2):
        if bounces:
            tmk.bounce_steps(st, keys, sph, bg, k_steps=bounces, max_depth=50,
                             t_min=1e-3, moving=False, bvh=bvh, solids=solids)
        o, d = st[0:3], st[3:6]
        t, fam, idx = tmk.intersect_only(o, d, sph, t_min=1e-3, bvh=bvh,
                                         solids=solids)
        rt, rfam, ridx = tmk.intersect_only_reference(o, d, sph, t_min=1e-3,
                                                      solids=solids)
        same = (fam == rfam) & (idx == ridx)
        assert same.float().mean() >= 0.999
        hit = same & (fam >= 0)
        torch.testing.assert_close(t[hit], rt[hit], rtol=1e-5, atol=0)
        fams |= set(fam.tolist())
    assert fams >= ({1, 3, 0} if name == "mixed" else {1, 3})


def test_seeded_walk_equals_seeded_scan(device):
    """On the mixed scene the BVH walk seeded by the quads' and boxes' t
    gives the seeded scan's (accel.pack_scan: every slot tested in slot
    order) outputs bit for bit, in all three kernels, at depth 50."""
    packs, bvh, solids, kw = _solid_case(device, "mixed", 96, 64, 4, 50)
    scan = accel.pack_scan(packs[0])
    for a, b in zip(tmk.render_tiles(*packs, bvh=bvh, **kw),
                    tmk.render_tiles(*packs, bvh=scan, **kw)):
        assert torch.equal(a, b)
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, "mixed", 96, 64)
    kw = dict(k_steps=1, max_depth=50, t_min=1e-3, moving=False,
              solids=solids)
    for _ in range(4):
        for a, b in zip(
                tmk.intersect_only(st[0:3], st[3:6], sph, t_min=1e-3,
                                   bvh=bvh, solids=solids),
                tmk.intersect_only(st[0:3], st[3:6], sph, t_min=1e-3,
                                   bvh=accel.pack_scan(sph), solids=solids)):
            assert torch.equal(a, b)
        walked = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
        assert torch.equal(walked, tmk.bounce_steps(
            st.clone(), keys, sph, bg, bvh=accel.pack_scan(sph), **kw))
        st = walked


def test_solid_variants_without_solids_equal_the_sphere_variants(device):
    """The solid-family variants with no active quad or box (the seed
    kInf) give the sphere variants' outputs on chap12 bit for bit."""
    packs = _packs(device)
    kw = _kw(max_depth=50)
    cornell, _ = tscenes.cornell_box_scene(8, 8)
    full = tmk.pack_solids(cornell, device)
    empty = tmk.SolidPacks(full.quad24, full.box24, 0, 0)
    a = _tiles(packs, **kw)
    b = _tiles(packs, solids=empty, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    st, keys, sph, bg = _lane_state(device)
    kwq = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=False,
               bvh=_lane_tree(sph))
    assert torch.equal(tmk.bounce_steps(st.clone(), keys, sph, bg, **kwq),
                       tmk.bounce_steps(st.clone(), keys, sph, bg,
                                        solids=empty, **kwq))


def test_cli_renders_cornell_through_the_kernels(device, tmp_path):
    """--scene cornell: auto picks the tile driver; the queue and batch
    drivers launch their kernels."""
    for driver, kernel in (("auto", "render_tiles"),
                           ("queue", "bounce_steps"),
                           ("batch", "intersect_only")):
        wrapper = getattr(tmk, kernel)
        before = wrapper.launches
        assert cli.main(["--scene", "cornell", "-r", "32x32", "-s", "4",
                         "--max-depth", "8", "--driver", driver,
                         "--device", str(device),
                         "-o", str(tmp_path / f"{driver}.png"),
                         "--quiet"]) == 0
        assert wrapper.launches > before


def test_solid_cap_raises_on_the_card(device):
    packs, bvh, solids, kw = _solid_case(device, "cornell", 8, 8, 1, 2)
    over = dataclasses.replace(solids, n_quads=tmk.SOLID_CAP + 1)
    with pytest.raises((NotImplementedError, ValueError)):
        tmk.render_tiles(*packs, bvh=bvh, **dict(kw, solids=over))


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_train_fwd_equals_tile_render(device, name):
    """train_fwd's solid-family variant (the scan seeded by the quads and
    boxes) gives tile_render's (the walk seeded by them) radiance and
    traced counts bit for bit; its pooled winner codes are the plain
    version's on every agreeing path, and each sample's traced alone."""
    from rrt_tpu_torch import gradcheck
    packs, _, solids, kw = _solid_case(device, name, depth=50)
    before = tmkt.render_tiles_train.launches
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = _tiles(packs, **kw)
    assert tmkt.render_tiles_train.launches == before + 1
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    faults, compared, _ = gradcheck.winner_faults(winners, lengths,
                                                  agreement)
    assert compared > 0 and faults == 0
    faults, compared = gradcheck.pool_faults(winners, lengths, agreement)
    assert compared > 0 and faults == 0
    assert bool((winners >= tmk.BOX_CODE).any())
    assert bool(((winners >= tmk.QUAD_CODE) & (winners < tmk.BOX_CODE)).any())


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_train_bwd_matches_plain_version(device, name):
    """train_bwd's solid-family variant against its plain version by
    test_train_bwd_matches_plain_version's rule (gradcheck), the quads'
    and boxes' fields among the partition() gradients; no replay
    mismatch, from the winners or without them."""
    from rrt_tpu_torch import diff, gradcheck, render
    scene, cam = (book2.mixed_scene(64, 32) if name == "mixed"
                  else tscenes.SCENES[name](64, 32))
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=50)
    packs, _, solids, kw = _solid_case(device, name, depth=50)
    _, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    weight = torch.sin(torch.arange(64 * 32, device=device) * 0.1) \
        * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    before = tmkt.tiles_adjoint.launches
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    scan = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, None,
                                     **kw)
    assert tmkt.tiles_adjoint.launches == before + 2
    assert int(k[3]) == 0 and int(scan[3]) == 0 and int(p[3]) == 0
    assert torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    # Cornell's radiance is a product of albedos and the emission, so its
    # geometry gets no gradient; the mixed scene's sky gives it one.
    assert pp["tex_color1"].abs().max() > 0
    if name == "mixed":
        for key in ("quad_q", "quad_u", "box_center"):
            assert pp[key].abs().max() > 0, key


@pytest.mark.parametrize("k_steps,pre_steps", [(4, 0), (12, 3)])
@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_solid_chain_bwd_matches_plain_version(device, name, k_steps,
                                               pre_steps):
    """chain_bwd's solid-family variant against its plain version by
    test_chain_bwd_matches_plain_version's rule, the quad and box packs'
    cotangents within 1e-3 of their largest too."""
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, name)
    kw = dict(k_steps=k_steps, max_depth=50, t_min=1e-3, moving=False,
              solids=solids)
    if pre_steps:
        tmk.bounce_steps(st, keys, sph, bg, bvh=bvh,
                         **dict(kw, k_steps=pre_steps))
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_out = torch.randn((16, st.shape[1]), generator=gen).to(device) * agree
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
    for got, exp in zip((*k[1:3], k[4].quad24, k[4].box24),
                        (*p[1:3], p[4].quad24, p[4].box24)):
        torch.testing.assert_close(got, exp, rtol=0,
                                   atol=1e-3 * exp.abs().max().item())
    assert p[4].quad24.abs().max() > 0 and p[4].box24.abs().max() > 0


def test_cornell_gradient_raises_on_the_card(device):
    """Cornell's gradient runs on the card's kernels (ROADMAP Queue A
    #9.7): make_train_step, its chunked step and render_image_diff launch
    train_fwd and train_bwd, render_image(differentiable=True) bounce_steps
    and chain_bwd, with no replay mismatch and finite losses and
    gradients; a scene with constant media still raises naming #9.4 on
    the bounce chain's route (render_image(differentiable=True)), and
    one with more than MAX_TRAIN_MEDIA media on render_image_diff, before
    any launch."""
    from rrt_tpu_torch import diff, render
    scene, cam = tscenes.cornell_box_scene(16, 16)
    cfg = render.RenderConfig(width=16, height=16, spp=2, max_depth=8,
                              samples_per_pass=2)
    target = torch.zeros((16, 16, 3), device=device)
    tmkt.tiles_adjoint.replay_mismatches = 0
    tmkv.chain_adjoint.replay_mismatches = 0
    for step in (diff.make_train_step(cfg, device=device),
                 diff.make_train_step_chunked(cfg, spp_chunk=1,
                                              device=device)):
        fwd, bwd = (tmkt.render_tiles_train.launches,
                    tmkt.tiles_adjoint.launches)
        new, _, loss = step(scene, cam, target, 0)
        assert tmkt.render_tiles_train.launches > fwd
        assert tmkt.tiles_adjoint.launches > bwd
        assert bool(torch.isfinite(loss))
        assert not torch.equal(new.tex_color1.cpu(), scene.tex_color1)
    color = scene.tex_color1.clone().requires_grad_()
    s = dataclasses.replace(scene, tex_color1=color)
    fwd, bwd = tmk.bounce_steps.launches, tmkv.chain_adjoint.launches
    img, _ = render.render_image(s, cam, cfg, 0, differentiable=True,
                                 device=device)
    (g,) = torch.autograd.grad(img.sum(), color)
    assert tmk.bounce_steps.launches > fwd
    assert tmkv.chain_adjoint.launches > bwd
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    smoke = dataclasses.replace(scene, has_media=True)
    fog = dataclasses.replace(smoke,
                              n_media_active=tmkt.MAX_TRAIN_MEDIA + 1)
    launches = (tmk.bounce_steps.launches, tmkv.chain_adjoint.launches,
                tmkt.render_tiles_train.launches)
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image(smoke, cam, cfg, 0, differentiable=True,
                            device=device)
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image_diff(fog, cam, cfg, 0, device=device)
    assert launches == (tmk.bounce_steps.launches,
                        tmkv.chain_adjoint.launches,
                        tmkt.render_tiles_train.launches)


# ---------------------------------------------------------------------------
# Constant media and the isotropic material (cornell_smoke)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_media_tile_render_matches_plain_version(device, name):
    """tile_render's solid-family variant with media against its plain
    version, the tolerance of tests/test_torch_slice.py, at depth 50."""
    packs, bvh, solids, kw = _solid_case(device, name, depth=50)
    assert solids.n_media == 2
    before = tmk.render_tiles.launches
    out = tmk.render_tiles(*packs, bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)
    assert out[0].max() > 0


@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_media_bounce_steps_and_intersect_match_plain_versions(device, name):
    """bounce_steps and intersect_only with media against their plain
    versions on camera rays and after 1-4 bounces: bit for bit on
    cornell_smoke (quads and media: the same arithmetic, CUDA's libm in
    both), test_solid_bounce_steps_matches_plain_version's rule on the
    media scene (its spheres' dielectric and metal branches round
    differently); some rays scatter in a medium."""
    st, keys, sph, bg, bvh, solids = _solid_lanes(device, name)
    kw = dict(k_steps=1, max_depth=50, t_min=1e-3, moving=False,
              solids=solids)
    scattered = 0
    for _ in range(5):
        bounce = st[tmk.ROW_BOUNCE].to(torch.int32)
        hit = tmk.intersect_only(st[0:3], st[3:6], sph, t_min=1e-3, bvh=bvh,
                                 solids=solids, keys=keys, bounce=bounce)
        ref = tmk.intersect_only_reference(st[0:3], st[3:6], sph, t_min=1e-3,
                                           solids=solids, keys=keys,
                                           bounce=bounce)
        live = st[tmk.ROW_ALIVE] > 0.5
        scattered += int((hit[1][live] == 2).sum())
        out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
        plain = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
        if name == "cornell_smoke":
            assert all(torch.equal(a, b) for a, b in zip(hit, ref))
            assert torch.equal(out, plain)
        else:
            same = (hit[1] == ref[1]) & (hit[2] == ref[2])
            assert same[live].float().mean() >= 0.999
            agree = (out[14] > 0.5) == (plain[14] > 0.5)
            assert agree.float().mean() >= 0.999
        st = out
    assert scattered > 0


@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_media_train_fwd_equals_tile_render(device, name):
    """train_fwd with media gives tile_render's radiance and traced
    counts bit for bit, and its pooled winner codes, medium codes among
    them, are the plain version's on every agreeing path."""
    from rrt_tpu_torch import gradcheck
    packs, _, solids, kw = _solid_case(device, name, depth=50)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = _tiles(packs, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.95
    faults, compared, _ = gradcheck.winner_faults(winners, lengths,
                                                  agreement)
    assert compared > 0 and faults <= 1e-4 * compared
    faults, compared = gradcheck.pool_faults(winners, lengths, agreement)
    assert compared > 0 and faults == 0
    assert bool((winners >= tmk.MEDIUM_CODE).any())


@pytest.mark.parametrize("name", ["cornell_smoke", "media"])
def test_media_train_bwd_matches_plain_version(device, name):
    """train_bwd with media against its plain version by gradcheck's rule
    on the agreeing pixels (the media's fields among the partition()
    gradients), no replay mismatch from the winners or without them; the
    media scene's med_center and med_neg_inv_density get gradients."""
    from rrt_tpu_torch import diff, gradcheck, render
    scene, cam = _scene(name, 64, 32)
    cfg = render.RenderConfig(width=64, height=32, spp=4, max_depth=8)
    packs, _, solids, kw = _solid_case(device, name)
    _, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    weight = torch.sin(torch.arange(64 * 32, device=device) * 0.1) \
        * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    scan = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, None,
                                     **kw)
    assert int(k[3]) == 0 and int(scan[3]) == 0 and int(p[3]) == 0
    assert torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    assert pp["tex_color1"].abs().max() > 0
    if name == "media":
        for key in ("med_center", "med_neg_inv_density"):
            assert pp[key].abs().max() > 0, key


def test_media_train_step_launches_the_train_kernels(device):
    """make_train_step on cornell_smoke runs train_fwd and train_bwd (no
    chain_bwd, which leaves media out), with no replay mismatch and a
    finite loss; the CLI renders it through the tile, queue and batch
    drivers' kernels."""
    from rrt_tpu_torch import diff, render
    scene, cam = tscenes.cornell_smoke_scene(16, 16)
    cfg = render.RenderConfig(width=16, height=16, spp=2, max_depth=8)
    tmkt.tiles_adjoint.replay_mismatches = 0
    before = (tmkt.render_tiles_train.launches, tmkt.tiles_adjoint.launches,
              tmkv.chain_adjoint.launches)
    _, _, loss = diff.make_train_step(cfg, device=device)(
        scene, cam, torch.zeros((16, 16, 3), device=device), 0)
    assert tmkt.render_tiles_train.launches > before[0]
    assert tmkt.tiles_adjoint.launches > before[1]
    assert tmkv.chain_adjoint.launches == before[2]
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    assert bool(torch.isfinite(loss))


def test_cli_renders_cornell_smoke_through_the_kernels(device, tmp_path):
    """--scene cornell_smoke: auto picks the tile driver; the queue and
    batch drivers launch their kernels."""
    for driver, kernel in (("auto", "render_tiles"),
                           ("queue", "bounce_steps"),
                           ("batch", "intersect_only")):
        wrapper = getattr(tmk, kernel)
        before = wrapper.launches
        assert cli.main(["--scene", "cornell_smoke", "-r", "32x32", "-s",
                         "4", "--max-depth", "8", "--driver", driver,
                         "--device", str(device),
                         "-o", str(tmp_path / f"{driver}.png"),
                         "--quiet"]) == 0
        assert wrapper.launches > before


# ---------------------------------------------------------------------------
# Perlin-marble and image textures (simple_light, earth)
# ---------------------------------------------------------------------------


def _texture_case(device, name, w=64, h=36, spp=4, depth=8):
    """_solid_case's tuple for simple_light or earth, the keywords with
    the scene's TexPack, and the scene and camera."""
    from rrt_tpu_torch import render
    scene, cam = tscenes.SCENES[name](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = tmk.pack_solids(scene, device)
    tex = tmk.pack_textures(scene, device)
    return scene, cam, cfg, packs, bvh, _kw(
        width=w, height=h, spp=spp, max_depth=depth, solids=solids, tex=tex)


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_tile_render_matches_plain_version(device, name):
    """tile_render's texture variant against its plain version, the
    tolerance of tests/test_torch_slice.py, at depth 50; the marble and
    the image give every hit pixel a colour."""
    *_, packs, bvh, kw = _texture_case(device, name, depth=50)
    before = tmk.render_tiles.launches
    out = tmk.render_tiles(*packs, bvh=bvh, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)
    assert out[0].max() > 0


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_bounce_steps_matches_plain_version(device, name):
    """bounce_steps' texture variant against its plain version on camera
    rays and after 1-4 bounces: alive rows and counts agree on >= 99.9%
    of the lanes, throughput and radiance within 1e-4 there."""
    from rrt_tpu_torch import render, rng
    scene, cam, _, packs, _, kw = _texture_case(device, name)
    w, h = 64, 36
    n = w * h
    ids = torch.arange(n, device=device)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam.to(device), ids % w, ids // w, w, h,
                                    keys)
    one, zero = torch.ones((n,), device=device), torch.zeros((n,),
                                                             device=device)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    keys = rng.u32_bits(keys)
    packed = render.pack_scene(scene, device, render._shutter(cam))
    skw = dict(k_steps=1, max_depth=50, t_min=1e-3, moving=False,
               solids=kw["solids"], tex=kw["tex"])
    for _ in range(5):
        out = tmk.bounce_steps(st.clone(), keys, packed["sph24"], packs[2],
                               bvh=packed["bvh"], **skw)
        plain = tmk.bounce_steps_reference(st.clone(), keys, packed["sph24"],
                                           packs[2], **skw)
        agree = ((out[14] > 0.5) == (plain[14] > 0.5)) \
            & (out[13] == plain[13]) & (out[15] == plain[15])
        assert agree.float().mean() >= 0.999
        err = (out[7:13] - plain[7:13]).abs().amax(dim=0)[agree]
        assert (err <= 1e-4).float().mean() >= 0.999
        st = out


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_train_kernels_match_plain_versions(device, name):
    """train_fwd's texture variant gives tile_render's outputs bit for
    bit; train_bwd's against its plain version by gradcheck's rule on the
    agreeing pixels, no replay mismatch, the marble's texture scale with
    a gradient; earth's atlas cotangent within 1e-4 of the plain
    version's largest (float atomics)."""
    from rrt_tpu_torch import diff, gradcheck
    scene, cam, cfg, packs, bvh, kw = _texture_case(device, name)
    kw = dict(kw, spp=2)
    cfg = dataclasses.replace(cfg, spp=2)
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = tmk.render_tiles(*packs, bvh=bvh, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.95
    weight = torch.sin(torch.arange(cfg.width * cfg.height, device=device)
                       * 0.1) * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, None,
                                     **kw)
    assert int(k[3]) == 0 and int(p[3]) == 0
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    if name == "simple_light":
        assert pp["tex_scale"].abs().max() > 0 and k[5] is None
    else:
        assert p[5].abs().max() > 0
        torch.testing.assert_close(k[5], p[5], rtol=0,
                                   atol=1e-4 * p[5].abs().max().item())


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_chain_bwd_matches_plain_version(device, name):
    """chain_bwd's texture variant against its plain version by
    test_solid_chain_bwd_matches_plain_version's rule; earth's atlas
    cotangent within 1e-3 of its largest."""
    from rrt_tpu_torch import render, rng
    scene, cam, _, packs, _, kw = _texture_case(device, name)
    w, h = 64, 36
    n = w * h
    ids = torch.arange(n, device=device)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam.to(device), ids % w, ids // w, w, h,
                                    keys)
    one, zero = torch.ones((n,), device=device), torch.zeros((n,),
                                                             device=device)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    keys = rng.u32_bits(keys)
    sph, bg = packs[0], packs[2]
    bvh = render.chain_bvh(sph, st[6], False)
    ckw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=False,
               solids=kw["solids"], tex=kw["tex"])
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **ckw)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg, **ckw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    gen = torch.Generator(device="cpu").manual_seed(0)
    d_out = torch.randn((16, n), generator=gen).to(device) * agree
    before = tmkv.chain_adjoint.launches
    k = tmkv.chain_adjoint(st, keys, sph, bg, d_out,
                           out[tmk.ROW_BOUNCE].clone(), bvh=bvh, **ckw)
    torch.cuda.synchronize(device)
    assert tmkv.chain_adjoint.launches == before + 1
    p = tmkv.chain_adjoint_reference(st, keys, sph, bg, d_out,
                                     ref_out[tmk.ROW_BOUNCE].clone(), **ckw)
    assert int(k[3]) == 0 and int(p[3]) == 0
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    assert lane_ok.float().mean() >= 0.995
    pairs = list(zip(k[1:3], p[1:3]))
    if k[5] is not None:
        pairs.append((k[5], p[5]))
        assert p[5].abs().max() > 0
    for got, exp in pairs:
        torch.testing.assert_close(got, exp, rtol=0,
                                   atol=1e-3 * exp.abs().max().item())
    if name == "simple_light":
        assert p[1][17].abs().max() > 0  # the marble's texture scale


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_train_step_and_cli_launch_the_kernels(device, name, tmp_path):
    """make_train_step runs train_fwd and train_bwd, render_image(
    differentiable=True) bounce_steps and chain_bwd, with no replay
    mismatch; the CLI renders the scene through the tile, queue and
    batch drivers' kernels."""
    from rrt_tpu_torch import diff, render
    scene, cam = tscenes.SCENES[name](16, 16)
    cfg = render.RenderConfig(width=16, height=16, spp=2, max_depth=8,
                              samples_per_pass=2)
    tmkt.tiles_adjoint.replay_mismatches = 0
    tmkv.chain_adjoint.replay_mismatches = 0
    before = (tmkt.render_tiles_train.launches, tmkt.tiles_adjoint.launches,
              tmkv.chain_adjoint.launches)
    _, _, loss = diff.make_train_step(cfg, device=device)(
        scene, cam, torch.zeros((16, 16, 3), device=device), 0)
    color = scene.tex_color1.clone().requires_grad_()
    img, _ = render.render_image(dataclasses.replace(scene, tex_color1=color),
                                 cam, cfg, 0, differentiable=True,
                                 device=device)
    (g,) = torch.autograd.grad(img.sum(), color)
    assert tmkt.render_tiles_train.launches > before[0]
    assert tmkt.tiles_adjoint.launches > before[1]
    assert tmkv.chain_adjoint.launches > before[2]
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    assert int(tmkv.chain_adjoint.replay_mismatches) == 0
    assert bool(torch.isfinite(loss)) and torch.isfinite(g).all()
    for driver, kernel in (("auto", "render_tiles"),
                           ("queue", "bounce_steps"),
                           ("batch", "intersect_only")):
        wrapper = getattr(tmk, kernel)
        launched = wrapper.launches
        assert cli.main(["--scene", name, "-r", "32x18", "-s", "4",
                         "--max-depth", "8", "--driver", driver,
                         "--device", str(device),
                         "-o", str(tmp_path / f"{driver}.png"),
                         "--quiet"]) == 0
        assert wrapper.launches > launched


def test_image_on_a_medium_raises_on_the_card(device):
    """A constant medium whose albedo is an image texture raises on a
    CUDA device before any launch, naming its ROADMAP entry (rrt_tpu
    sends it to its eager route, the port's CPU route)."""
    import numpy as np
    from rrt_tpu_torch import render
    b = SceneBuilder()
    b.medium_sphere((0.0, 0.0, 0.0), 1.0, 0.5, b.image(np.ones((4, 8, 3))))
    scene = b.build()
    cam = Camera.create(look_from=(0.0, 0.0, 5.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=30.0, aspect=1.0)
    cfg = render.RenderConfig(width=8, height=8, spp=2, max_depth=4,
                              samples_per_pass=2)
    launches = (tmk.render_tiles.launches, tmk.intersect_only.launches,
                tmkt.render_tiles_train.launches)
    for fn in (render.render_image_tiles, render.render_image,
               render.render_image_diff):
        with pytest.raises(NotImplementedError, match="Not ported by "
                                                      "decision"):
            fn(scene, cam, cfg, 0, device=device)
    assert launches == (tmk.render_tiles.launches,
                        tmk.intersect_only.launches,
                        tmkt.render_tiles_train.launches)


# ---------------------------------------------------------------------------
# Quads and boxes past SOLID_CAP: the forward kernels' walks over the
# solid families' trees (many_solids_scene, rttnw_final)
# ---------------------------------------------------------------------------

# (moving, marble): the kWalk instantiations with and without kMoving
# and kTex.
WALK_VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


def _walk_case(device, moving, marble, w=64, h=48, spp=2, depth=8):
    """many_solids_scene (82 quads and 81 boxes, rotated about Y, under
    the sky) on the device: (packs, the sphere BVH, SolidPacks with their
    trees, render_tiles keywords, the solid scan's SolidPacks: the same
    packs, every family a loop)."""
    from rrt_tpu_torch import render
    scene, cam = book2.many_solids_scene(w, h, moving=moving, marble=marble)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = tmk.pack_solids(scene, device)
    assert solids.tree.quad.n_nodes and solids.tree.box.n_nodes
    scan = dataclasses.replace(solids, tree=accel.solid_scan(solids.tree))
    return packs, bvh, solids, _kw(
        width=w, height=h, spp=spp, max_depth=depth, moving=moving,
        solids=solids, tex=tmk.pack_textures(scene, device)), scan


def _walk_lanes(device, moving, marble, w=64, h=48):
    """_solid_lanes' tuple of many_solids_scene, its SolidPacks with
    their trees, its TexPack and the solid scan's SolidPacks."""
    from rrt_tpu_torch import render, rng
    scene, cam = book2.many_solids_scene(w, h, moving=moving, marble=marble)
    n = w * h
    ids = torch.arange(n, device=device)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam.to(device), ids % w, ids // w, w, h,
                                    keys)
    one, zero = torch.ones((n,), device=device), torch.zeros((n,),
                                                             device=device)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    packed = render.pack_scene(scene, device, render._shutter(cam))
    solids = packed["solids"]
    scan = dataclasses.replace(solids, tree=accel.solid_scan(solids.tree))
    return (st, rng.u32_bits(keys), packed["sph24"],
            tmk.pack_bg(scene).to(device), packed["bvh"], solids,
            packed["tex"], scan)


@pytest.mark.parametrize("moving,marble", WALK_VARIANTS)
def test_walk_tile_render_matches_plain_version(device, moving, marble):
    """tile_render's kWalk variant on more than 64 quads and 64 boxes:
    the tolerance of tests/test_torch_slice.py against its plain version
    at depth 50, and the solid scan's outputs bit for bit."""
    packs, bvh, solids, kw, scan = _walk_case(device, moving, marble,
                                              depth=50)
    before = tmk.render_tiles.launches
    out = tmk.render_tiles(*packs, bvh=bvh, **kw)
    assert tmk.render_tiles.launches == before + 1
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 2)
    for a, b in zip(out, tmk.render_tiles(*packs, bvh=bvh,
                                          **dict(kw, solids=scan))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moving,marble", WALK_VARIANTS)
def test_walk_bounce_steps_matches_plain_version(device, moving, marble):
    """bounce_steps' kWalk variant, 4 steps from the camera rays at depth
    50: the solid scan's state bit for bit, and its plain version's by
    test_solid_bounce_steps_matches_plain_version's rule (a sphere hit's
    shading rounds otherwise in the plain version)."""
    st, keys, sph, bg, bvh, solids, tex, scan = _walk_lanes(device, moving,
                                                            marble)
    kw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=moving, tex=tex)
    before = tmk.bounce_steps.launches
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, solids=solids,
                           **kw)
    assert tmk.bounce_steps.launches == before + 1
    assert torch.equal(out, tmk.bounce_steps(st.clone(), keys, sph, bg,
                                             bvh=bvh, solids=scan, **kw))
    ref = tmk.bounce_steps_reference(st.clone(), keys, sph, bg,
                                     solids=solids, **kw)
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    assert agree.float().mean() >= 0.999
    assert torch.equal(out[15][agree], ref[15][agree])
    assert torch.equal(out[13][agree], ref[13][agree])
    close = ((out[7:13] - ref[7:13]).abs() < 1e-3).all(dim=0)[agree]
    assert close.float().mean() >= 0.995


@pytest.mark.parametrize("moving,marble", WALK_VARIANTS)
def test_walk_intersect_only_matches_plain_version(device, moving, marble):
    """intersect_only's kWalk variant on camera rays and after 2 bounces:
    its plain version's (t, family, slot) bit for bit (the same
    arithmetic; rttnw_final's 131,072 rays agree at every depth of
    chip_smoke.py [F1]), and the solid scan's; quads, boxes and spheres
    all win somewhere."""
    st, keys, sph, bg, bvh, solids, tex, scan = _walk_lanes(device, moving,
                                                            marble)
    fams = set()
    for bounces in (0, 2):
        if bounces:
            tmk.bounce_steps(st, keys, sph, bg, k_steps=bounces, max_depth=50,
                             t_min=1e-3, moving=moving, bvh=bvh,
                             solids=solids, tex=tex)
        o, d = st[0:3].contiguous(), st[3:6].contiguous()
        ikw = dict(t_min=1e-3, time=st[6].contiguous() if moving else None)
        got = tmk.intersect_only(o, d, sph, bvh=bvh, solids=solids, **ikw)
        ref = tmk.intersect_only_reference(o, d, sph, solids=solids, **ikw)
        walked_scan = tmk.intersect_only(o, d, sph, bvh=bvh, solids=scan,
                                         **ikw)
        for a, b, c in zip(got, ref, walked_scan):
            assert torch.equal(a, b) and torch.equal(a, c)
        fams |= set(got[1].tolist())
    assert fams >= {0, 1, 3}


def test_forward_smem_past_the_opt_in_raises_before_launch(device):
    """forward_blocks reports the blocks an SM of many_solids_scene's
    walk at forward_smem_bytes; 7,000 boxes, whose rows and tree exceed
    what a block may opt into, raise NotImplementedError naming the
    ROADMAP entry before any launch of the three forward kernels."""
    packs, bvh, solids, kw, _ = _walk_case(device, True, True)
    blocks = tmk.forward_blocks("tile_render", packs[0], bvh, moving=True,
                                solids=solids, tex=kw["tex"])
    assert blocks["blocks"] >= 1
    assert blocks["smem_bytes"] == tmk.forward_smem_bytes(bvh, solids, True)
    rs = np.random.RandomState(0)
    box24 = torch.zeros((24, 7000))
    box24[0:3] = torch.from_numpy(rs.uniform(-1000.0, 1000.0, (3, 7000)))
    box24[3:6] = torch.from_numpy(rs.uniform(1.0, 10.0, (3, 7000)))
    box24[6] = 1.0
    box24 = box24.to(device)
    big = dataclasses.replace(
        solids, box24=box24, n_boxes=7000,
        tree=accel.pack_solid_bvh(solids.quad24, box24, solids.n_quads,
                                  7000))
    wrappers = (tmk.render_tiles, tmk.bounce_steps, tmk.intersect_only)
    launches = [w.launches for w in wrappers]
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmk.render_tiles(*packs, bvh=bvh, **dict(kw, solids=big))
    st, keys, sph, bg, q_bvh, _, tex, _ = _walk_lanes(device, True, True)
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmk.bounce_steps(st, keys, sph, bg, k_steps=1, max_depth=8,
                         t_min=1e-3, moving=True, bvh=q_bvh, solids=big,
                         tex=tex)
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmk.intersect_only(st[0:3].contiguous(), st[3:6].contiguous(), sph,
                           t_min=1e-3, time=st[6].contiguous(), bvh=q_bvh,
                           solids=big)
    assert launches == [w.launches for w in wrappers]


def test_rttnw_final_renders_and_its_gradient_raises_on_the_card(device):
    """rttnw_final (400 ground boxes) renders on the tile driver with the
    kWalk variant; its gradient runs on train_fwd and train_bwd
    (make_train_step, render_image_diff) with no replay mismatch and no
    launch of bounce_steps or chain_bwd; the chain's route
    (render_image(differentiable=True)) still raises NotImplementedError
    before any launch, now naming its media (#9.4): chain_adjoint takes
    its packs without the media, walking the boxes' tree (#9.5's chain
    part), with no replay mismatch."""
    from rrt_tpu_torch import diff, render
    scene, cam = tscenes.SCENES["rttnw_final"](40, 27)
    cfg = render.RenderConfig(width=40, height=27, spp=2, max_depth=8,
                              samples_per_pass=2)
    before = tmk.render_tiles.launches
    img, n = render.render_image_tiles(scene, cam, cfg, 0, device=device)
    assert tmk.render_tiles.launches == before + 1
    assert torch.isfinite(img).all() and int(n) >= 40 * 27 * 2
    target = torch.zeros((27, 40, 3), device=device)
    wrappers = (tmk.render_tiles, tmk.bounce_steps, tmk.intersect_only,
                tmkt.render_tiles_train, tmkt.tiles_adjoint,
                tmkv.chain_adjoint)
    launches = [w.launches for w in wrappers]
    tmkt.tiles_adjoint.replay_mismatches = 0
    _, _, loss = diff.make_train_step(cfg, device=device)(scene, cam, target,
                                                          1)
    d_img, _ = render.render_image_diff(scene, cam, cfg, 0, device=device)
    after = [w.launches for w in wrappers]
    assert bool(torch.isfinite(loss)) and torch.isfinite(d_img).all()
    assert after[3] == launches[3] + 2 and after[4] == launches[4] + 1
    assert after[1] == launches[1] and after[5] == launches[5]
    assert int(tmkt.tiles_adjoint.replay_mismatches) == 0
    with pytest.raises(NotImplementedError, match="#9.4"):
        render.render_image(scene, cam, cfg, 0, differentiable=True,
                            device=device)
    assert after == [w.launches for w in wrappers]
    st, keys, sph, bg = _lane_state(device)
    solids = dataclasses.replace(tmk.pack_solids(scene, device), n_media=0,
                                 med24=None)
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, k_steps=1,
                           max_depth=8, t_min=1e-3, moving=False,
                           bvh=_tree(sph), solids=solids)
    k = tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st),
                           out[tmk.ROW_BOUNCE].clone(), k_steps=1,
                           max_depth=8, t_min=1e-3, moving=False,
                           bvh=_tree(sph), solids=solids)
    torch.cuda.synchronize(device)
    assert int(k[3]) == 0
    assert tmkv.chain_adjoint.launches == after[5] + 1


# ---------------------------------------------------------------------------
# The train kernels past SOLID_CAP: train_fwd's kWalk instantiations walk
# the solid families' trees, train_bwd loops over every active quad and
# box (rttnw_final, many_solids_scene)
# ---------------------------------------------------------------------------


def _walk_train_case(device, name, spp=2, depth=50):
    """(scene, camera, RenderConfig, packs, render_tiles_train keywords
    with the SolidPacks and their trees, the sphere BVH) of rttnw_final
    at 40x27 or of many_solids_scene ("many", moving and marbled) at
    64x48."""
    from rrt_tpu_torch import render
    if name == "rttnw_final":
        w, h = 40, 27
        scene, cam = tscenes.SCENES[name](w, h)
    else:
        w, h = 64, 48
        scene, cam = book2.many_solids_scene(w, h, moving=True, marble=True)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    packs = [p.detach() for p in packs]
    solids = tmk.pack_solids(scene, device)
    assert solids.tree.box.n_nodes > 0
    return scene, cam, cfg, packs, _kw(
        width=w, height=h, spp=spp, max_depth=depth,
        moving=scene.has_moving, solids=solids,
        tex=tmk.pack_textures(scene, device)), bvh


@pytest.mark.parametrize("name", ["rttnw_final", "many"])
def test_walk_train_fwd_equals_tile_render(device, name):
    """train_fwd's kWalk variant gives tile_render's radiance and traced
    counts bit for bit (both walk the solid trees, the loop's winners
    bit for bit); its pooled winner codes are each sample's traced alone
    (pool_faults 0) and the plain version's on every agreeing path, boxes
    past slot 63 among them; the train kernels' blocks an SM at their
    shared memory."""
    from rrt_tpu_torch import gradcheck
    _, _, _, packs, kw, bvh = _walk_train_case(device, name)
    before = tmkt.render_tiles_train.launches
    rad, traced, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    assert tmkt.render_tiles_train.launches == before + 1
    ref, ref_traced = tmk.render_tiles(*packs, bvh=bvh, **kw)
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.98
    faults, compared = gradcheck.pool_faults(winners, lengths, agreement)
    assert compared > 0 and faults == 0
    faults, compared, _ = gradcheck.winner_faults(winners, lengths,
                                                  agreement)
    assert compared > 0 and faults <= 1e-3 * compared
    fam, idx = tmk.decode_winner(winners[winners >= 0])
    assert bool(((fam == 3) & (idx >= tmk.SOLID_CAP)).any())
    # rttnw_final's 1,024 moving sphere slots at 32 bytes, 1 quad and 400
    # boxes' rows (16 * (3 + 2 * 400) + 4 bytes), and train_fwd's trees.
    smem = {"train_fwd": 32 * 1024 + 16 * 803 + 4 + 12
            + kw["solids"].tree.smem_bytes(),
            "train_bwd": 32 * 1024 + 16 * 803 + 4}
    for kernel in tmkt.TRAIN_KERNELS:
        b = tmkt.train_blocks(kernel, packs[0], moving=kw["moving"],
                              solids=kw["solids"], tex=kw["tex"])
        assert b["blocks"] >= 1
        assert 0 < b["smem_bytes"] <= b["room"]
        if name == "rttnw_final":
            assert b["smem_bytes"] == smem[kernel]


@pytest.mark.parametrize("name", ["rttnw_final", "many"])
def test_walk_train_bwd_matches_plain_version(device, name):
    """train_bwd past SOLID_CAP (a stored box winner tested alone, the
    segments past the pool looping over every box) against its plain
    version by test_train_bwd_matches_plain_version's rule (gradcheck),
    box_center and box_half among the fields; no replay mismatch, from
    the winners or without them; the gradients not all 0."""
    from rrt_tpu_torch import diff, gradcheck
    scene, cam, cfg, packs, kw, _ = _walk_train_case(device, name)
    _, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.98
    n = kw["width"] * kw["height"]
    weight = torch.sin(torch.arange(n, device=device) * 0.1) * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    before = tmkt.tiles_adjoint.launches
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    scan = tmkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, None,
                                     **kw)
    assert tmkt.tiles_adjoint.launches == before + 2
    assert int(k[3]) == 0 and int(scan[3]) == 0 and int(p[3]) == 0
    assert torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4], device=device)
    faults, _ = gradcheck.field_grad_faults(kp, kc, pp, pc)
    assert not faults, faults
    # rttnw_final's ground is solid under a black background, so its
    # boxes' positions get no gradient (as cornell's walls): its albedos
    # do; many_solids_scene's sky gives the boxes past slot 63 one.
    field = "tex_color1" if name == "rttnw_final" else "box_center"
    rows = pp[field] if name == "rttnw_final" else pp[field][tmk.SOLID_CAP:]
    assert rows.abs().max() > 0


def test_train_smem_past_the_opt_in_raises_before_launch(device):
    """7,000 boxes, whose rows (and train_fwd's tree) exceed what a block
    may opt into, raise NotImplementedError naming the ROADMAP entry
    before any launch of the train kernels."""
    _, _, _, packs, kw, _ = _walk_train_case(device, "many", spp=1,
                                             depth=8)
    solids = kw["solids"]
    rs = np.random.RandomState(0)
    box24 = torch.zeros((24, 7000))
    box24[0:3] = torch.from_numpy(rs.uniform(-1000.0, 1000.0, (3, 7000)))
    box24[3:6] = torch.from_numpy(rs.uniform(1.0, 10.0, (3, 7000)))
    box24[6] = 1.0
    box24 = box24.to(device)
    big = dataclasses.replace(
        solids, box24=box24, n_boxes=7000,
        tree=accel.pack_solid_bvh(solids.quad24, box24, solids.n_quads,
                                  7000))
    wrappers = (tmkt.render_tiles_train, tmkt.tiles_adjoint)
    launches = [w.launches for w in wrappers]
    rad, _, lengths, winners = tmkt.render_tiles_train(*packs, **kw)
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmkt.render_tiles_train(*packs, **dict(kw, solids=big))
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmkt.tiles_adjoint(*packs, torch.ones_like(rad), lengths, winners,
                           **dict(kw, solids=big))
    assert [w.launches for w in wrappers] == [launches[0] + 1, launches[1]]


def test_walk_train_fwd_needs_the_trees(device):
    """On the card train_fwd walks a family past SOLID_CAP or raises: no
    loop stands in for a missing tree."""
    _, _, _, packs, kw, _ = _walk_train_case(device, "rttnw_final", spp=1,
                                             depth=8)
    before = tmkt.render_tiles_train.launches
    with pytest.raises(ValueError, match="trees"):
        tmkt.render_tiles_train(*packs, **dict(
            kw, solids=dataclasses.replace(kw["solids"], tree=None)))
    assert tmkt.render_tiles_train.launches == before