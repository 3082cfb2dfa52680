"""The CUDA tile-render kernel on the card (marked `cuda`; skips without
a CUDA device).

This file imports neither JAX nor rrt_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The kernel is held against its plain PyTorch version on the same packs,
with the tolerance of tests/test_torch_slice.py: per-pixel mean
|delta| < 1e-3 on >= 98.5% of pixels, traced totals within 1%."""

import pytest
import torch

from rrt_tpu_torch import cli
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.camera import Camera
from rrt_tpu_torch.ops import megakernel as tmk
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
