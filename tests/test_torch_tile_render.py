"""The tile-render module: plain physics, wrapper and kernel.

One bounce of the port's plain physics (render._shade, which the
kernel's plain version runs) must agree with rrt_tpu.render._shade on
the same rays and keys, with the tolerances of tests/test_megakernel.py:
survival agrees on more than 99% of rays (near-tie winner flips), banked
radiance within 1e-4 on the rays that agree, throughput within 2e-3 on
more than 97% of them. The kernel itself runs only on a CUDA card:
its tests are in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays
from rrt_tpu.render import _shade as j_shade
from rrt_tpu_torch import convert, render, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _rows(v3):
    return torch.from_numpy(np.stack([np.asarray(c) for c in v3]))


def _checker_scene(w, h):
    """Kernel-scope builders no canned scene uses: a checker-textured
    ground, fuzzy metal and glass spheres, a solid background."""
    from rrt_tpu.camera import Camera
    from rrt_tpu.scene import SceneBuilder
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


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name", ["diffuse", "chap11", "chap12", "checker"])
def test_one_bounce_matches_reference(name, depth):
    w, h, n = 32, 18, 1024
    build = _checker_scene if name == "checker" else jscenes.SCENES[name]
    j_scene, j_cam = build(w, h)
    t_scene = convert.scene_from_numpy(_leaves(j_scene))
    ids = jnp.arange(n, dtype=jnp.int32)
    px, py = ids % w, (ids // w) % h
    keys = jrng.sample_keys(jax.random.key(0),
                            (py * w + px).astype(jnp.uint32), 0)
    o, d, tm = generate_rays(j_cam, px, py, w, h, keys)
    alive = jnp.ones((n,), bool)
    if depth:  # the reference's own bounce-0 survivors as inputs
        _, o, d, _, alive = j_shade(j_scene, o, d, tm, keys, 0, alive,
                                    1e-3, 50)
    contrib, _, _, att, sv = j_shade(j_scene, o, d, tm, keys, depth,
                                     alive, 1e-3, 50)

    c_t, _, _, att_t, sv_t = render._shade(
        t_scene, _rows(o), _rows(d), torch.from_numpy(np.array(tm)),
        torch.from_numpy(np.asarray(keys).astype(np.int64)), depth,
        torch.from_numpy(np.array(alive)), 1e-3, 50)

    sv, sv_t = np.asarray(sv), sv_t.numpy()
    agree = sv == sv_t
    assert agree.mean() > 0.99
    diff = np.abs(c_t.numpy() - np.stack([np.asarray(c) for c in contrib]))
    assert diff[:, agree].max() < 1e-4
    exp_thr = np.where(sv, np.stack([np.asarray(c) for c in att]), 1.0)
    got_thr = np.where(sv_t, att_t.numpy(), 1.0)
    close = np.all(np.abs(got_thr - exp_thr) < 2e-3, axis=0)[agree]
    assert close.mean() > 0.97, close.mean()


def _packs(name="chap12", w=16, h=8, device="cpu"):
    scene, cam = tscenes.SCENES[name](w, h)
    return (tmk.pack_spheres_full(scene).to(device),
            tmk.pack_camera(cam, w, h).to(device),
            tmk.pack_bg(scene).to(device))


KW = dict(seed_words=(0, 0), sample_lo=0, width=16, height=8, spp=2,
          max_depth=8, t_min=1e-3, moving=False)


def test_cpu_wrapper_runs_plain_version_without_launch():
    before = tmk.render_tiles.launches
    rad, traced = tmk.render_tiles(*_packs(), **KW)
    assert tmk.render_tiles.launches == before
    ref_rad, ref_traced = tmk.render_tiles_reference(*_packs(), **KW)
    assert torch.equal(rad, ref_rad) and torch.equal(traced, ref_traced)
    assert rad.shape == (16 * 8, 3) and traced.dtype == torch.int32
    n = 16 * 8 * 2
    assert n <= int(traced.sum()) <= n * 9


def test_plain_version_is_independent_of_chunking():
    """Per-pixel sums keep the sample-major, bounce-by-bounce order
    whatever the chunk size, so chunking changes no bit."""
    a = tmk.render_tiles_reference(*_packs(), **KW)
    b = tmk.render_tiles_reference(*_packs(), **KW, chunk=7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene, cam = tscenes.chap11_scene(8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(RuntimeError, match="cuda"):
        render.render_image_tiles(scene, cam, cfg, 0, device="cuda")


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    sph, cam, bg = _packs()
    if bad == "dtype":
        sph = sph.double()
    elif bad == "shape":
        cam = cam[:20].contiguous()
    elif bad == "contiguous":
        sph = torch.cat([sph, sph], dim=1)[:, ::2]
    else:
        bg = bg.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tmk.render_tiles(sph, cam, bg, **KW)


def _image_on_medium():
    """A medium whose albedo is an image, with rrt_tpu's builder."""
    from rrt_tpu.camera import Camera as JCamera
    from rrt_tpu.scene import SceneBuilder as JBuilder
    b = JBuilder()
    b.medium_sphere((0.0, 0.0, 0.0), 1.0, 0.5, b.image(np.ones((4, 8, 3))))
    return b.build(), JCamera.create(look_from=(0.0, 0.0, 5.0),
                                     look_at=(0.0, 0.0, 0.0), fov_deg=30.0,
                                     aspect=2.0)


# simple_light and earth render since ROADMAP Queue A #9.5's first part
# (tests/test_torch_textures.py), rttnw_final's 400 ground boxes since
# its rest's forward part (tests/test_torch_rttnw.py); what stays outside
# the tile kernel: an image on a medium (a decision).
@pytest.mark.parametrize("name,item", [
    ("rttnw_final", None),
    ("image_on_medium", 'ROADMAP "Not ported by decision"')])
def test_scenes_outside_the_kernel_scope_raise(name, item):
    """An image on a medium raises naming its ROADMAP entry; rttnw_final
    (converted from rrt_tpu's build) renders, the CLI's auto choosing the
    tile driver for it."""
    j_scene, j_cam = (_image_on_medium() if name == "image_on_medium"
                      else jscenes.SCENES[name](16, 8))
    scene = convert.scene_from_numpy(_leaves(j_scene))
    cam = convert.camera_from_numpy(_leaves(j_cam))
    cfg = render.RenderConfig(width=16, height=8, spp=1, max_depth=2)
    if item is None:
        from rrt_tpu_torch import cli
        assert cli.resolve_driver("auto", scene) == "tile"
        img, n = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
        assert torch.isfinite(img).all() and int(n) >= 16 * 8
        return
    with pytest.raises(NotImplementedError, match=item):
        render.render_image_tiles(scene, cam, cfg, 0, device="cpu")


def test_russian_roulette_raises():
    """No longer raises (#9.6): the tile driver renders with the
    roulette, and with rr_depth past every path's length as without it,
    bit for bit."""
    scene, cam = tscenes.chap11_scene(8, 4)
    cfg = render.RenderConfig(width=8, height=4, spp=2, rr_depth=1)
    img, n = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    off, n_off = render.render_image_tiles(
        scene, cam, dataclasses.replace(cfg, rr_depth=0), 0, device="cpu")
    assert torch.isfinite(img).all() and int(n) < int(n_off)
    late, n_late = render.render_image_tiles(
        scene, cam, dataclasses.replace(cfg, rr_depth=cfg.max_depth + 1), 0,
        device="cpu")
    assert torch.equal(late, off) and int(n_late) == int(n_off)
