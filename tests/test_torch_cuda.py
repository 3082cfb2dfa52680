"""The CUDA kernels on the card: tile_render and the train kernels
(marked `cuda`; skip without a CUDA device).

This file imports neither JAX nor rrt_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same
packs. tile_render: the tolerance of tests/test_torch_slice.py,
per-pixel mean |delta| < 1e-3 on >= 98.5% of pixels, traced totals
within 1%. train_fwd: tile_render's outputs bit for bit. train_bwd:
the tolerances stated in each test."""

import pytest
import torch

from rrt_tpu_torch import cli
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
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


def _kw(**over):
    kw = dict(seed_words=(0, 0), sample_lo=0, width=64, height=32, spp=4,
              max_depth=8, t_min=1e-3)
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
    out = tmk.render_tiles(*packs, **kw)
    torch.cuda.synchronize(device)
    assert tmk.render_tiles.launches == before + 1
    assert out[0].device == packs[0].device and out[1].dtype == torch.int32
    _assert_close(out, tmk.render_tiles_reference(*packs, **kw), 4)


def test_kernel_is_deterministic(device):
    packs = _packs(device)
    a = tmk.render_tiles(*packs, **_kw())
    b = tmk.render_tiles(*packs, **_kw())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sample_ranges_add_up(device):
    """Samples [0,2) + [2,4) are the paths of samples [0,4)."""
    packs = _packs(device)
    lo = tmk.render_tiles(*packs, **_kw(spp=2))
    hi = tmk.render_tiles(*packs, **_kw(spp=2, sample_lo=2))
    full = tmk.render_tiles(*packs, **_kw())
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
                                        max_depth=depth)


@pytest.mark.parametrize("name", ["chap12", "chap11", "diffuse", "checker"])
def test_train_fwd_equals_tile_render(device, name):
    _, _, _, packs, kw = _train_case(device, name)
    before = tmkt.render_tiles_train.launches
    rad, traced, lengths = tmkt.render_tiles_train(*packs, **kw)
    ref, ref_traced = tmk.render_tiles(*packs, **kw)
    torch.cuda.synchronize(device)
    assert tmkt.render_tiles_train.launches == before + 1
    assert torch.equal(rad, ref) and torch.equal(traced, ref_traced)
    assert torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced)


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
    _, _, lengths = tmkt.render_tiles_train(*packs, **kw)
    agreement = gradcheck.sample_agreement(packs, kw)
    assert agreement.agree.float().mean() >= 0.99
    n = kw["width"] * kw["height"]
    weight = torch.sin(torch.arange(n, device=device) * 0.1) * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(_MIX, device=device)).contiguous()
    before = tmkt.tiles_adjoint.launches
    k = tmkt.tiles_adjoint(*packs, d_rad, lengths, **kw)
    p = tmkt.tiles_adjoint_reference(*packs, d_rad, agreement.lengths, **kw)
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
    rad, _, lengths = tmkt.render_tiles_train(*packs, **kw)
    d_rad = mix.expand_as(rad).contiguous()
    d_sph, d_cam, d_bg, _ = tmkt.tiles_adjoint(*packs, d_rad, lengths, **kw)
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
    bit-identical from run to run; the pack's are summed with
    shared-memory atomics and agree within 1e-6 of their largest."""
    _, _, _, packs, kw = _train_case(device, "chap12")
    rad, _, lengths = tmkt.render_tiles_train(*packs, **kw)
    d_rad = torch.ones_like(rad)
    a = tmkt.tiles_adjoint(*packs, d_rad, lengths, **kw)
    b = tmkt.tiles_adjoint(*packs, d_rad, lengths, **kw)
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
    ref = tmk.render_tiles(sph, *rest, **kw)
    out = tmk.render_tiles(wide, *rest, **kw)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    rad, traced, lengths = tmkt.render_tiles_train(wide, *rest, **kw)
    assert torch.equal(rad, ref[0]) and torch.equal(traced, ref[1])
    d_rad = torch.ones_like(rad)
    g = tmkt.tiles_adjoint(sph, *rest, d_rad, lengths, **kw)
    gw = tmkt.tiles_adjoint(wide, *rest, d_rad, lengths, **kw)
    assert int(gw[3]) == 0
    assert torch.equal(gw[1], g[1]) and torch.equal(gw[2], g[2])
    torch.testing.assert_close(gw[0][:, :n], g[0], rtol=0,
                               atol=1e-6 * g[0].abs().max().item())
    assert not gw[0][:, n:].any()


def test_train_record_cap_raises(device):
    _, _, _, packs, kw = _train_case(device, "chap12")
    kw["max_depth"] = tmkt.MAX_RECORDS
    with pytest.raises(ValueError, match="records"):
        tmkt.render_tiles_train(*packs, **kw)
    rad = torch.zeros((64 * 32, 3), device=device)
    lengths = torch.ones((4, 64 * 32), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError, match="records"):
        tmkt.tiles_adjoint(*packs, rad, lengths, **kw)


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
