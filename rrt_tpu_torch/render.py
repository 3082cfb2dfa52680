"""Forward render: the one-launch tile path and the plain bounce step.

`render_image_tiles` renders every pixel's samples with one launch of
the tile-render kernel (ops/megakernel.render_tiles) on a CUDA device,
or with the kernel's plain PyTorch version for tensors on the CPU.
`_shade` is one bounce of the plain physics (intersect, shade,
scatter), shared by the plain version and the tests.

Every random draw is keyed by (seed, pixel, sample, bounce, stream)
(rng.py), so a pixel's samples are the same paths whichever version
traces them; images differ by f32 rounding and the rare near-tie
winner flip it causes.
"""

import dataclasses

import torch

from . import rng
from .geometry import FAM_NONE, FAM_SPHERE, INF, intersect_spheres, make_hit
from .materials import scatter
from .ops import megakernel as ops_mega
from .scene import BG_SKY, SceneArrays


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 400
    height: int = 225
    spp: int = 32
    max_depth: int = 50
    t_min: float = 1.0e-3
    # Russian roulette from this bounce; 0 = off (the books' method).
    # Only 0 is ported (ROADMAP Queue A #9.6).
    rr_depth: int = 0


def background_color(scene: SceneArrays, d):
    """Miss shader: the RTIOW vertical sky lerp (reference
    src/lib.rs:66-70) or a solid color. d: (3,N) -> (3,N)."""
    unit_y = d[1] * torch.rsqrt(torch.clamp(
        d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=1e-20))
    t = 0.5 * (unit_y + 1.0)
    bot = scene.bg_bottom[:, None]
    top = scene.bg_top[:, None]
    sky = (1.0 - t) * bot + t * top
    return torch.where(scene.bg_mode == BG_SKY, sky, bot.expand_as(sky))


def _shade(scene: SceneArrays, o, d, keys, bounce, alive, t_min,
           max_depth):
    """One physics step for a ray set: intersect, shade, scatter.

    o, d: (3,N); keys: (2,N); bounce: int or (N,); alive: (N,) bool.
    Returns (contribution (3,N) — radiance to bank this step, scaled by
    throughput by the caller — new_o, new_d, attenuation (3,N),
    survives (N,))."""
    ops_mega.check_scope(scene)
    t, idx = intersect_spheres(scene, o, d, t_min, INF)
    fam = torch.where(t < INF, FAM_SPHERE, FAM_NONE)
    hit_mask = (t < INF) & alive
    miss_mask = alive & ~hit_mask

    hit = make_hit(scene, o, d, t, fam, idx)
    sc = scatter(scene, d, hit, keys, bounce)
    contribution = background_color(scene, d) * miss_mask

    # The reference kills rays that hit at depth >= max_depth *before*
    # scattering (src/lib.rs:58-60); misses at that depth still see the
    # sky.
    survives = hit_mask & sc.scattered & (bounce < max_depth)
    new_o = torch.where(survives, hit.p, o)
    new_d = torch.where(survives, sc.direction, d)
    return contribution, new_o, new_d, sc.attenuation, survives


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but "
                           "torch.cuda.is_available() is False")
    return device


def trace_tiles(scene: SceneArrays, camera, cfg: RenderConfig, seed, *,
                device):
    """Render the cfg.spp samples of every pixel on `device`. Returns
    (radiance sums (P,3) in scan-line order, n_traced) with
    P = width * height. (rrt_tpu's progressive sample ranges come with
    the CLI's chunks, ROADMAP Queue A #12.)"""
    ops_mega.check_scope(scene, cfg.rr_depth)
    device = _check_device(device)
    sph24 = ops_mega.pack_spheres_full(scene).to(device)
    cam24 = ops_mega.pack_camera(camera, cfg.width, cfg.height).to(device)
    bg8 = ops_mega.pack_bg(scene).to(device)
    rad, traced = ops_mega.render_tiles(
        sph24, cam24, bg8, seed_words=rng.key_words(seed),
        sample_lo=0, width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_depth=cfg.max_depth, t_min=cfg.t_min)
    return rad, traced.sum()


def render_image_tiles(scene: SceneArrays, camera, cfg: RenderConfig,
                       seed, *, device):
    """Render the full image. Returns (image (H,W,3) mean radiance,
    n_traced)."""
    rad, n_traced = trace_tiles(scene, camera, cfg, seed, device=device)
    image = rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp)
    return image, n_traced


def tonemap(image):
    """Gamma-2.0 to RGB8, saturating like the reference's `as u8`
    (src/lib.rs:104-108)."""
    c = torch.sqrt(torch.clamp(image, min=0.0)) * 255.99
    return torch.clamp(c, 0.0, 255.0).to(torch.uint8)
