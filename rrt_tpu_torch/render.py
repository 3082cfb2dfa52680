"""Render: the tile, queue and batch drivers, forward and differentiable.

Three forward drivers render the same paths, each through its own CUDA
kernel on a CUDA device, or through the kernel's plain PyTorch version
for tensors on the CPU:

  tile   `render_image_tiles` / `trace_tiles`: every pixel's samples in
         one launch of ops/megakernel.render_tiles;
  queue  `render_image_queue` / `trace_queue`: a persistent queue of Q
         lanes; dead lanes are refilled with fresh (pixel, sample)
         camera rays between launches of ops/megakernel.bounce_steps;
  batch  `render_image` / `render_tile` / `trace_batch`: fixed ray
         batches traced bounce by bounce in eager PyTorch, intersecting
         through ops/megakernel.intersect_only.

`render_image_diff` / `trace_tiles_diff` are the differentiable render
through the train kernels (ops/megakernel_train). `_bounce` is one
bounce of the plain physics (intersect, shade, scatter), shared by the
plain versions, the batch driver and the tests.

Every random draw is keyed by (seed, pixel, sample, bounce, stream)
(rng.py), so a pixel's samples are the same paths whichever driver or
version traces them; images differ by f32 rounding, the order of the
sums, and the rare near-tie winner flip rounding causes.
"""

import dataclasses

import torch

from . import rng
from .camera import generate_rays
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
    # Queue driver: in-flight rays (lanes) and bounce steps between
    # refills.
    queue_size: int = 131072
    bounces_per_refill: int = 4
    # Batch driver: rays per traced batch = tile_pixels * samples_per_pass.
    tile_pixels: int = 16384
    samples_per_pass: int = 4
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
            max_depth, packed=None) -> Bounce:
    """One physics step for a ray set: intersect, shade, scatter.

    o, d: (3,N); keys: (2,N); bounce: int or (N,); alive: (N,) bool.
    packed: pack_scene's dict on the rays' device, to intersect through
    ops.megakernel.intersect_only (the kernel on a CUDA device, its plain
    version on the CPU), as the batch driver does; None intersects
    through geometry.intersect_spheres, as the kernels' plain versions
    do, which must launch no kernel."""
    ops_mega.check_scope(scene)
    if packed is None:
        t, idx = intersect_spheres(scene, o, d, t_min, INF)
        fam = torch.where(t < INF, FAM_SPHERE, FAM_NONE)
    else:
        t, fam, idx = ops_mega.intersect_only(
            o.contiguous(), d.contiguous(), packed["sph24"], t_min=t_min)
        idx = idx.long()
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
           max_depth, packed=None):
    """One physics step (`_bounce`). Returns (contribution (3,N) —
    radiance to bank this step, scaled by throughput by the caller —
    new_o, new_d, attenuation (3,N), survives (N,))."""
    b = _bounce(scene, o, d, keys, bounce, alive, t_min, max_depth,
                packed=packed)
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


# ---------------------------------------------------------------------------
# The batch driver
# ---------------------------------------------------------------------------


def pack_scene(scene: SceneArrays, device):
    """The intersect kernel's packs on `device`. Only the sphere family
    is ported (quads and media: ROADMAP Queue A #9.2 and #9.4)."""
    return {"sph24": ops_mega.pack_spheres_full(scene).to(device)}


def trace_batch(scene: SceneArrays, o, d, keys, max_depth: int,
                t_min: float, differentiable: bool = False, packed=None,
                rr_depth: int = 0):
    """Trace a fixed ray batch to completion (forward only).

    o, d: (3,N) rays; keys: (2,N) sample key words (rng.sample_keys);
    packed: pack_scene(scene, o.device), made here when not given. Every
    bounce intersects through ops.megakernel.intersect_only: its kernel
    for rays on a CUDA device, its plain version for rays on the CPU.
    rrt_tpu's lax.while_loop is a Python loop here
    that ends at max_depth or when no lane is alive, which costs one
    device-to-host read a bounce. Returns (radiance (3,N), n_traced ()
    int64: exact, where rrt_tpu sums it in f32)."""
    if differentiable:
        raise NotImplementedError(
            "trace_batch(differentiable=True): the rematerialised scan "
            "(ROADMAP Queue A #10) and its chain-vjp kernel "
            "megakernel_vjp._bwd_kernel (Queue B #6) are not ported yet; "
            "render_image_diff is the differentiable render")
    ops_mega.check_scope(scene, rr_depth)
    if packed is None:
        packed = pack_scene(scene, o.device)
    thr = torch.ones_like(o)
    rad = torch.zeros_like(o)
    alive = torch.ones((o.shape[1],), dtype=torch.bool, device=o.device)
    n_traced = torch.zeros((), dtype=torch.int64, device=o.device)
    bounce = 0
    while bounce <= max_depth and bool(alive.any()):
        contrib, o, d, att, survives = _shade(
            scene, o, d, keys, bounce, alive, t_min, max_depth,
            packed=packed)
        rad = rad + thr * contrib
        thr = torch.where(survives, thr * att, thr)
        n_traced = n_traced + alive.sum()
        alive = survives
        bounce += 1
    return rad, n_traced


def render_tile(scene: SceneArrays, camera, px, py, cfg: RenderConfig, seed,
                pass_start: int, n_passes: int, differentiable: bool = False):
    """Render one tile of pixels (px, py: (P,) on the scene's device)
    with n_passes sample passes through the batch driver. Pass i covers
    samples [(pass_start+i)*spc, ...+spc), spc = cfg.samples_per_pass.
    Returns (radiance sums (P,3), n_traced)."""
    p_count = px.shape[0]
    spc = cfg.samples_per_pass
    pxr, pyr = px.repeat(spc), py.repeat(spc)
    gid = pyr * cfg.width + pxr
    replica = torch.arange(spc, device=px.device).repeat_interleave(p_count)
    seed_words = rng.key_words(seed)
    packed = pack_scene(scene, px.device)
    acc = torch.zeros((p_count, 3), dtype=torch.float32, device=px.device)
    n_traced = torch.zeros((), dtype=torch.int64, device=px.device)
    for i in range(n_passes):
        keys = rng.sample_keys(seed_words, gid,
                               (pass_start + i) * spc + replica)
        o, d, _ = generate_rays(camera, pxr, pyr, cfg.width, cfg.height,
                                keys)
        rad, nt = trace_batch(scene, o, d, keys, cfg.max_depth, cfg.t_min,
                              differentiable, packed=packed,
                              rr_depth=cfg.rr_depth)
        acc = acc + rad.T.reshape(spc, p_count, 3).sum(dim=0)
        n_traced = n_traced + nt
    return acc, n_traced


def _tile_coords(cfg: RenderConfig, device):
    """Flat pixel ids in tiles of cfg.tile_pixels: [(px, py), ...], the
    last tile ragged. rrt_tpu pads it with repeats of the last pixel to a
    fixed shape, and its n_traced counts their segments too; eager
    PyTorch needs no fixed shape, so here n_traced counts the image's
    pixels only."""
    ids = torch.arange(cfg.width * cfg.height, device=device)
    return [(t % cfg.width, t // cfg.width)
            for t in torch.split(ids, cfg.tile_pixels)]


def render_image(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                 differentiable: bool = False, pass_start: int = 0,
                 n_passes: int | None = None, *, device):
    """Render the full image through the batch driver, tile by tile.

    pass_start / n_passes select samples [pass_start*spc, (pass_start +
    n_passes)*spc) for progressive and resumed renders; the default is
    all cfg.spp. Returns (image (H,W,3) mean radiance over the rendered
    samples, n_traced). The queue and tile drivers render the same image
    faster."""
    if cfg.spp % cfg.samples_per_pass != 0:
        raise ValueError("spp must be a multiple of samples_per_pass")
    ops_mega.check_scope(scene, cfg.rr_depth)
    device = _check_device(device)
    scene, camera = scene.to(device), camera.to(device)
    if n_passes is None:
        n_passes = cfg.spp // cfg.samples_per_pass
    rads, n_traced = [], 0
    for px, py in _tile_coords(cfg, device):
        r, n = render_tile(scene, camera, px, py, cfg, seed, pass_start,
                           n_passes, differentiable)
        rads.append(r)
        n_traced = n_traced + n
    rad = torch.cat(rads)
    image = rad.reshape(cfg.height, cfg.width, 3) / float(
        n_passes * cfg.samples_per_pass)
    return image, n_traced


# ---------------------------------------------------------------------------
# The queue driver
# ---------------------------------------------------------------------------


def trace_queue(scene: SceneArrays, camera, px, py, cfg: RenderConfig, seed,
                sample_lo: int, sample_hi: int,
                queue_size: int | None = None, *, device):
    """Render samples [sample_lo, sample_hi) of the pixels (px, py) (P,)
    with a persistent queue of Q = min(queue_size or cfg.queue_size,
    P * n_samples) lanes, in rrt_tpu's (16, Q) state layout.

    An outer step flushes and refills, then runs cfg.bounces_per_refill
    bounce steps in one launch of ops.megakernel.bounce_steps. The
    refill is rrt_tpu's, in eager PyTorch: a cumsum ranks the dead lanes;
    the first of them take the next (pixel, sample) ids, sample-major
    (every pixel at sample s, then s+1), so fresh camera rays are
    coherent; their finished samples' pending radiance goes into the
    (3, P) accumulator in one index_add_; their keys and camera rays are
    made for all Q lanes and one select writes them into the state. The
    loop runs while ids are left or a lane is alive, which costs one
    device-to-host read an outer step (the live-lane count; the id
    cursor is kept on the host). A final flush banks the lanes that
    finished after the last refill. `trace_queue.outer_steps` counts the
    outer steps.

    Returns (radiance sums (P,3), n_traced () int64: exact, where rrt_tpu
    sums the traced row in f32)."""
    ops_mega.check_scope(scene, cfg.rr_depth)
    device = _check_device(device)
    camera, px, py = camera.to(device), px.to(device), py.to(device)
    p_count = px.shape[0]
    total = p_count * (sample_hi - sample_lo)
    q = min(queue_size or cfg.queue_size, total)
    k_steps = max(1, cfg.bounces_per_refill)
    sph24 = ops_mega.pack_spheres_full(scene).to(device)
    bg8 = ops_mega.pack_bg(scene).to(device)
    seed_words = rng.key_words(seed)
    pixel_gid = py * cfg.width + px
    acc = torch.zeros((3, p_count), dtype=torch.float32, device=device)
    st = torch.zeros((ops_mega.STATE_ROWS, q), dtype=torch.float32,
                     device=device)
    st[3:6] = 1.0  # a non-degenerate direction in the never-issued lanes
    keys = torch.zeros((2, q), dtype=torch.int32, device=device)
    pix = torch.zeros((q,), dtype=torch.int64, device=device)
    ones = torch.ones((q,), dtype=torch.float32, device=device)
    zeros = torch.zeros((q,), dtype=torch.float32, device=device)
    next_s, n_alive = 0, 0
    while next_s < total or n_alive > 0:
        n_issue = min(q - n_alive, total - next_s)
        if n_issue > 0:
            dead = st[ops_mega.ROW_ALIVE] <= 0.5
            sidx = next_s + torch.cumsum(dead, 0) - 1
            issue = dead & (sidx < total)
            sidx = torch.clamp(sidx, max=total - 1)
            p_new = sidx % p_count
            acc.index_add_(1, pix, st[10:13] * issue)  # flush
            new_keys = rng.sample_keys(seed_words, pixel_gid[p_new],
                                       sidx // p_count + sample_lo)
            o, d, tm = generate_rays(camera, px[p_new], py[p_new],
                                     cfg.width, cfg.height, new_keys)
            fresh = ops_mega.pack_state(
                o, d, tm, ones.expand(3, q), zeros.expand(3, q), zeros, ones,
                st[ops_mega.ROW_TRACED])  # the traced count carries over
            st = torch.where(issue, fresh, st)
            keys = torch.where(issue, rng.u32_bits(new_keys), keys)
            pix = torch.where(issue, p_new, pix)
            next_s += n_issue
        ops_mega.bounce_steps(st, keys, sph24, bg8, k_steps=k_steps,
                              max_depth=cfg.max_depth, t_min=cfg.t_min)
        trace_queue.outer_steps += 1
        n_alive = int((st[ops_mega.ROW_ALIVE] > 0.5).sum())
    acc.index_add_(1, pix, st[10:13])  # the final flush
    n_traced = st[ops_mega.ROW_TRACED].to(torch.int64).sum()
    return acc.T.contiguous(), n_traced


trace_queue.outer_steps = 0


def render_image_queue(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                       *, device):
    """Render the full image with the queue driver (forward only).
    Returns (image (H,W,3) mean radiance, n_traced)."""
    ids = torch.arange(cfg.width * cfg.height)
    rad, n_traced = trace_queue(scene, camera, ids % cfg.width,
                                ids // cfg.width, cfg, seed, 0, cfg.spp,
                                device=device)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n_traced


def tonemap(image):
    """Gamma-2.0 to RGB8, saturating like the reference's `as u8`
    (src/lib.rs:104-108)."""
    c = torch.sqrt(torch.clamp(image, min=0.0)) * 255.99
    return torch.clamp(c, 0.0, 255.0).to(torch.uint8)
