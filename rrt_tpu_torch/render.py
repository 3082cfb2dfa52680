"""Render: the one-launch tile paths, forward and differentiable.

`render_image_tiles` renders every pixel's samples with one launch of
the tile-render kernel (ops/megakernel.render_tiles) on a CUDA device,
or with the kernel's plain PyTorch version for tensors on the CPU.
`render_image_diff` / `trace_tiles_diff` are the differentiable render
through the train kernels (ops/megakernel_train). `_bounce` is one
bounce of the plain physics (intersect, shade, scatter), shared by the
plain versions and the tests.

Every random draw is keyed by (seed, pixel, sample, bounce, stream)
(rng.py), so a pixel's samples are the same paths whichever version
traces them; images differ by f32 rounding and the rare near-tie
winner flip it causes.
"""

import dataclasses

import torch

from . import rng
from .geometry import (FAM_NONE, FAM_SPHERE, INF, Hit, intersect_spheres,
                       make_hit)
from .materials import Scatter, scatter
from .ops import megakernel as ops_mega
from .ops import megakernel_train as ops_train
from .scene import BG_SKY, SceneArrays
from .textures import use_color2


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


@dataclasses.dataclass(frozen=True)
class Bounce:
    """One bounce of a ray batch, with the decisions a replay needs."""

    t: torch.Tensor  # (N,) winner t; INF on a miss
    win: torch.Tensor  # (N,) int64 winning sphere slot (0 on a miss)
    hit: Hit
    scatter: Scatter
    hit_mask: torch.Tensor  # (N,) bool
    miss_mask: torch.Tensor  # (N,) bool
    use_c2: torch.Tensor  # (N,) bool: the checker's odd cell
    contribution: torch.Tensor  # (3,N) radiance banked this step
    survives: torch.Tensor  # (N,) bool
    new_o: torch.Tensor  # (3,N)
    new_d: torch.Tensor  # (3,N)


def _bounce(scene: SceneArrays, o, d, keys, bounce, alive, t_min,
            max_depth) -> Bounce:
    """One physics step for a ray set: intersect, shade, scatter.

    o, d: (3,N); keys: (2,N); bounce: int or (N,); alive: (N,) bool."""
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
    return Bounce(
        t=t, win=idx, hit=hit, scatter=sc, hit_mask=hit_mask,
        miss_mask=miss_mask,
        use_c2=use_color2(scene, scene.mat_tex[hit.mat_id.long()], hit.p),
        contribution=contribution, survives=survives,
        new_o=torch.where(survives, hit.p, o),
        new_d=torch.where(survives, sc.direction, d))


def _shade(scene: SceneArrays, o, d, keys, bounce, alive, t_min,
           max_depth):
    """One physics step (`_bounce`). Returns (contribution (3,N) —
    radiance to bank this step, scaled by throughput by the caller —
    new_o, new_d, attenuation (3,N), survives (N,))."""
    b = _bounce(scene, o, d, keys, bounce, alive, t_min, max_depth)
    return (b.contribution, b.new_o, b.new_d, b.scatter.attenuation,
            b.survives)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but "
                           "torch.cuda.is_available() is False")
    return device


def _packs(scene: SceneArrays, camera, cfg: RenderConfig, device):
    """The kernels' sphere, camera and background packs on `device`,
    differentiable functions of the scene and camera."""
    return (ops_mega.pack_spheres_full(scene).to(device),
            ops_mega.pack_camera(camera, cfg.width, cfg.height).to(device),
            ops_mega.pack_bg(scene).to(device))


def trace_tiles(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                sample_lo: int = 0, n_samples: int | None = None, *,
                device):
    """Render samples [sample_lo, sample_lo + n_samples) of every pixel
    on `device` (n_samples defaults to cfg.spp). Returns (radiance sums
    (P,3) in scan-line order, n_traced) with P = width * height."""
    ops_mega.check_scope(scene, cfg.rr_depth)
    device = _check_device(device)
    rad, traced = ops_mega.render_tiles(
        *_packs(scene, camera, cfg, device), seed_words=rng.key_words(seed),
        sample_lo=sample_lo, width=cfg.width, height=cfg.height,
        spp=cfg.spp if n_samples is None else n_samples,
        max_depth=cfg.max_depth, t_min=cfg.t_min)
    return rad, traced.sum()


def render_image_tiles(scene: SceneArrays, camera, cfg: RenderConfig,
                       seed, *, device):
    """Render the full image. Returns (image (H,W,3) mean radiance,
    n_traced)."""
    rad, n_traced = trace_tiles(scene, camera, cfg, seed, device=device)
    image = rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp)
    return image, n_traced


# Samples per differentiable launch in trace_tiles_diff; make_train_step
# sends budgets above 4x this to the chunked trainer (as rrt_tpu does).
DIFF_SAMPLE_BUDGET = 64


def diff_fallback_reason(scene: SceneArrays, cfg: RenderConfig):
    """None when the train kernels cover the scene; otherwise why not.
    rrt_tpu then takes its scan path, which the port does not have yet
    (ROADMAP Queue A #10), so the differentiable entry points raise."""
    if ops_train.supports_train(scene) and cfg.rr_depth == 0:
        return None
    what, item = ops_mega.scope_gap(scene, cfg.rr_depth)
    return (f"{what} is outside the train kernels' scope (ROADMAP "
            f"Queue A {item})")


def _check_diff_scope(where: str, scene: SceneArrays, cfg: RenderConfig):
    reason = diff_fallback_reason(scene, cfg)
    if reason is not None:
        raise NotImplementedError(
            f"{where}: {reason}; the scan fallback that would render it "
            "differentiably is not ported (ROADMAP Queue A #10)")


def trace_tiles_diff(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                     sample_lo: int = 0, n_samples: int | None = None,
                     sample_budget: int | None = None, *, device):
    """Differentiable render of samples [sample_lo, sample_lo +
    n_samples): (radiance sums (P,3), n_traced), as trace_tiles, with
    gradients to the scene's and camera's tensors through the packs.

    Each launch is an ops.megakernel_train.TileTrainChain: forward one
    train_fwd kernel, backward one train_bwd kernel. Budgets above
    `sample_budget` (default DIFF_SAMPLE_BUDGET) run as several chains
    over consecutive sample ranges; autograd sums their gradients. The
    residual a chain keeps is one byte per path, so no chain is
    recomputed."""
    _check_diff_scope("trace_tiles_diff", scene, cfg)
    device = _check_device(device)
    budget = sample_budget or DIFF_SAMPLE_BUDGET
    n_samples = cfg.spp if n_samples is None else n_samples
    packs = _packs(scene, camera, cfg, device)
    rad, n_traced = None, 0
    for lo in range(0, n_samples, budget):
        r, traced = ops_train.TileTrainChain.apply(
            *packs, rng.key_words(seed), sample_lo + lo, cfg.width,
            cfg.height, min(budget, n_samples - lo), cfg.max_depth,
            cfg.t_min)
        rad = r if rad is None else rad + r
        n_traced = n_traced + traced.sum()
    return rad, n_traced


def render_image_diff(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                      *, device):
    """Differentiable full-image render through the train kernels.
    Returns (image (H,W,3) mean radiance, n_traced). A scene outside
    their scope raises NotImplementedError naming the reason."""
    _check_diff_scope("render_image_diff", scene, cfg)
    rad, n = trace_tiles_diff(scene, camera, cfg, seed, device=device)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n


def tonemap(image):
    """Gamma-2.0 to RGB8, saturating like the reference's `as u8`
    (src/lib.rs:104-108)."""
    c = torch.sqrt(torch.clamp(image, min=0.0)) * 255.99
    return torch.clamp(c, 0.0, 255.0).to(torch.uint8)
