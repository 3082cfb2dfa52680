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

Two differentiable renders: `render_image_diff` / `trace_tiles_diff`
through the train kernels (ops/megakernel_train), and the batch driver
with differentiable=True, whose passes run `trace_batch_fused`: a few
bounce chains (ops/megakernel_vjp.BounceChain: forward
ops/megakernel.bounce_steps, backward the chain_bwd kernel) with
differentiable lane compaction between them. `trace_batch`'s
checkpointed scan is the route for what the chain does not cover.
`_bounce` is one bounce of the plain physics (intersect, shade,
scatter), shared by the plain versions, the batch driver and the tests.

Every random draw is keyed by (seed, pixel, sample, bounce, stream)
(rng.py), so a pixel's samples are the same paths whichever driver or
version traces them; images differ by f32 rounding, the order of the
sums, and the rare near-tie winner flip rounding causes.
"""

import dataclasses
import functools
import logging

import torch
from torch.utils.checkpoint import checkpoint

from . import accel, rng
from .camera import generate_rays
from .geometry import (FAM_NONE, FAM_SPHERE, INF, Hit, intersect_spheres,
                       make_hit)
from .materials import Scatter, scatter
from .ops import megakernel as ops_mega
from .ops import megakernel_train as ops_train
from .ops import megakernel_vjp as ops_vjp
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


def _bounce(scene: SceneArrays, o, d, time, keys, bounce, alive, t_min,
            max_depth, packed=None) -> Bounce:
    """One physics step for a ray set: intersect, shade, scatter.

    o, d: (3,N); time: (N,) the rays' times (moving spheres' centers);
    keys: (2,N); bounce: int or (N,); alive: (N,) bool.
    packed: pack_scene's dict on the rays' device, to intersect through
    ops.megakernel.intersect_only (the kernel on a CUDA device, its plain
    version on the CPU), as the batch driver does; None intersects
    through geometry.intersect_spheres, as the kernels' plain versions
    do, which must launch no kernel."""
    ops_mega.check_scope(scene)
    if packed is None:
        t, idx = intersect_spheres(scene, o, d, time, t_min, INF)
        fam = torch.where(t < INF, FAM_SPHERE, FAM_NONE)
    else:
        t, fam, idx = ops_mega.intersect_only(
            o.contiguous(), d.contiguous(), packed["sph24"], t_min=t_min,
            time=time.contiguous() if scene.has_moving else None,
            bvh=packed["bvh"])
        idx = idx.long()
    hit_mask = (t < INF) & alive
    miss_mask = alive & ~hit_mask

    hit = make_hit(scene, o, d, time, t, fam, idx)
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


def _shade(scene: SceneArrays, o, d, time, keys, bounce, alive, t_min,
           max_depth, packed=None):
    """One physics step (`_bounce`). Returns (contribution (3,N) —
    radiance to bank this step, scaled by throughput by the caller —
    new_o, new_d, attenuation (3,N), survives (N,))."""
    b = _bounce(scene, o, d, time, keys, bounce, alive, t_min, max_depth,
                packed=packed)
    return (b.contribution, b.new_o, b.new_d, b.scatter.attenuation,
            b.survives)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but "
                           "torch.cuda.is_available() is False")
    return device


def _packs(scene: SceneArrays, camera, cfg: RenderConfig, device, *,
           bvh: bool = False):
    """The kernels' sphere, camera and background packs on `device`,
    differentiable functions of the scene and camera; with bvh, also
    the sphere pack's accel.BvhPack over the camera's shutter, which
    tile_render walks (built on the host: one device-to-host copy of the
    spheres; the train kernels scan and need none)."""
    packs = (ops_mega.pack_spheres_full(scene).to(device),
             ops_mega.pack_camera(camera, cfg.width, cfg.height).to(device),
             ops_mega.pack_bg(scene).to(device))
    if not bvh:
        return packs
    cam24 = packs[1].detach().cpu()
    shutter = (cam24[19], cam24[19] + cam24[20])  # the kernel's ray times
    return (*packs, accel.pack_bvh(packs[0], shutter))


def trace_tiles(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                sample_lo: int = 0, n_samples: int | None = None, *,
                device):
    """Render samples [sample_lo, sample_lo + n_samples) of every pixel
    on `device` (n_samples defaults to cfg.spp). Returns (radiance sums
    (P,3) in scan-line order, n_traced) with P = width * height."""
    ops_mega.check_scope(scene, cfg.rr_depth)
    device = _check_device(device)
    sph24, cam24, bg8, bvh = _packs(scene, camera, cfg, device, bvh=True)
    rad, traced = ops_mega.render_tiles(
        sph24, cam24, bg8, seed_words=rng.key_words(seed),
        sample_lo=sample_lo, width=cfg.width, height=cfg.height,
        spp=cfg.spp if n_samples is None else n_samples,
        max_depth=cfg.max_depth, t_min=cfg.t_min, moving=scene.has_moving,
        bvh=bvh)
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
    """None when the train kernels cover the scene and depth; otherwise
    why not, and render_image_diff takes the batch driver's
    differentiable path, whose chains split any depth (_fused_schedule).
    The train backward keeps one record a bounce, at most MAX_RECORDS a
    path."""
    gap = ops_mega.scope_gap(scene, cfg.rr_depth)
    if gap is not None:
        return (f"{gap[0]} is outside the train kernels' scope (ROADMAP "
                f"Queue A {gap[1]})")
    if cfg.max_depth + 1 > ops_vjp.MAX_RECORDS:
        return (f"max_depth {cfg.max_depth} is past the train kernels' "
                f"{ops_vjp.MAX_RECORDS} bounce records a path")
    return None


def _check_diff_scope(where: str, scene: SceneArrays, cfg: RenderConfig):
    """Raise for a scene outside the train kernels' scope (a depth past
    their records raises ValueError in the kernels' wrappers)."""
    gap = ops_mega.scope_gap(scene, cfg.rr_depth)
    if gap is not None:
        raise NotImplementedError(
            f"{where}: {gap[0]} is outside the train kernels' scope "
            f"(ROADMAP Queue A {gap[1]})")


_logger = logging.getLogger("rrt_tpu_torch.render")
_warned_fallbacks: set = set()


def _warn_diff_fallback(where: str, reason: str):
    """One log line per (site, reason) a process: a scene that drops off
    the train kernels renders far slower through the batch driver."""
    key = (where, reason)
    if key not in _warned_fallbacks:
        _warned_fallbacks.add(key)
        _logger.warning("%s: using the batch driver's differentiable path "
                        "because %s", where, reason)


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
    residual a chain keeps is 33 bytes a path (its length and its share
    of the winners: ops.megakernel_train.boundary_residual_bytes), so no
    chain is recomputed."""
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
            cfg.t_min, scene.has_moving)
        rad = r if rad is None else rad + r
        n_traced = n_traced + traced.sum()
    return rad, n_traced


def render_image_diff(scene: SceneArrays, camera, cfg: RenderConfig, seed,
                      *, device):
    """Differentiable full-image render, through the train kernels when
    they cover the scene (trace_tiles_diff), otherwise through
    render_image(differentiable=True) after one log line naming the
    reason, as rrt_tpu routes. Returns (image (H,W,3) mean radiance,
    n_traced)."""
    reason = diff_fallback_reason(scene, cfg)
    if reason is not None:
        _warn_diff_fallback("render_image_diff", reason)
        return render_image(scene, camera, cfg, seed, differentiable=True,
                            device=device)
    rad, n = trace_tiles_diff(scene, camera, cfg, seed, device=device)
    return rad.reshape(cfg.height, cfg.width, 3) / float(cfg.spp), n


# ---------------------------------------------------------------------------
# The batch driver
# ---------------------------------------------------------------------------


def pack_scene(scene: SceneArrays, device, shutter=None):
    """The intersect kernel's packs on `device`: the sphere pack and its
    accel.BvhPack, whose boxes cover the moving spheres over `shutter`
    (time0, time1), the interval of the rays' times (required when the
    scene moves). Built once a render and passed to every bounce's
    intersect_only; a pack of changed spheres needs a new one. Only the
    sphere family is ported (quads and media: ROADMAP Queue A #9.2 and
    #9.4)."""
    sph24 = ops_mega.pack_spheres_full(scene).to(device)
    return {"sph24": sph24, "bvh": accel.pack_bvh(sph24, shutter)}


def chain_bvh(sph24, time, moving: bool):
    """The accel.BvhPack that trace_batch_fused's chains walk, over the
    sphere pack sph24 (24, S) and, when the scene moves, the rays' own
    range of times `time` (N,): one device-to-host read of the spheres
    and that range together, the host build (accel.pack_bvh), and the
    pack's copy to sph24's device. Trained spheres move every step, so
    a pack is built a call and never reused."""
    sph = sph24.detach()
    shutter = None
    if moving:
        tm = time.detach()
        flat = torch.cat([sph.reshape(-1), tm.min()[None], tm.max()[None]])
        flat = flat.cpu()
        sph, shutter = flat[:-2].reshape(sph.shape), (flat[-2], flat[-1])
    return accel.pack_bvh(sph.cpu(), shutter).to(sph24.device)


def _shutter(camera):
    """The camera's shutter (time0, time1), which its rays' times lie in
    (camera.thin_lens_rays)."""
    return (float(camera.time0), float(camera.time1))


def _bounce_body(scene: SceneArrays, t_min, keys, o, d, time, thr, rad,
                 alive, bounce, max_depth, packed=None):
    """One bounce of trace_batch's carry (o, d, time, throughput,
    radiance, alive) -> the next (rrt_tpu's _bounce_body)."""
    contrib, o, d, att, survives = _shade(
        scene, o, d, time, keys, bounce, alive, t_min, max_depth,
        packed=packed)
    return (o, d, time, torch.where(survives, thr * att, thr),
            rad + thr * contrib, survives)


def _fused_schedule(max_depth: int):
    """Chain lengths between compactions, as rrt_tpu's: after 4 steps
    about 18% of chap12's lanes are alive and after 8 about 3%, so the
    first two chains of 4 are compacted and one long chain takes the
    tail. A chain's backward keeps one record a step, at most
    MAX_RECORDS (csrc/adjoint.cuh), so a longer tail runs as chains of
    MAX_RECORDS steps and the rest; compaction between them is exact,
    so the gradient is the one of a single chain."""
    steps = max_depth + 1
    schedule = []
    for k in (4, 4):
        if steps > k + 4:
            schedule.append(k)
            steps -= k
    cap = ops_vjp.MAX_RECORDS
    schedule += [cap] * ((steps - 1) // cap)
    schedule.append(steps - cap * ((steps - 1) // cap))
    return tuple(schedule)


def _compact_lanes(st, keys, lane):
    """Stable alive-first permutation of a lane state (16, Q), its keys
    (2, Q) and lane ids (Q,). The permutation comes from the detached
    alive row, so under autograd the state's index_select is a constant
    linear map whose gradient is the inverse scatter: index_select's
    backward is an index_add_ of distinct columns, where advanced
    indexing's sorts the indices first (on an H100 that sort cost as
    much as the three chain_bwd launches of a 262,144-lane step)."""
    alive = st[ops_mega.ROW_ALIVE].detach() > 0.5
    ca = torch.cumsum(alive.to(torch.int64), 0)
    i = torch.arange(lane.shape[0], device=lane.device)
    pos = torch.where(alive, ca - 1, ca[-1] + i - ca)
    perm = torch.empty_like(i).scatter_(0, pos, i)
    return (st.index_select(1, perm), keys.index_select(1, perm),
            lane.index_select(0, perm))


def trace_batch_fused(scene: SceneArrays, o, d, time, keys, max_depth: int,
                      t_min: float, schedule: tuple | None = None,
                      rr_depth: int = 0, bvh=None):
    """Reverse-differentiable trace of a ray batch through the bounce
    chain (rrt_tpu's trace_batch_fused).

    The max_depth + 1 bounces run as the chains of `schedule` (default
    _fused_schedule), each one ops/megakernel_vjp.BounceChain: forward a
    bounce_steps launch, backward a chain_bwd launch that replays the
    chain from its input state, the only residual besides the keys; both
    walk one BVH pack of the scene's spheres: `bvh` when given (a pack of
    these spheres whose shutter covers the rays' times: render_image
    builds one an image), otherwise chain_bvh's, built here over the
    rays' own range of times (one device-to-host read and a host build a
    call).
    _compact_lanes packs the live lanes first between chains. o, d: (3,N)
    rays; time: (N,) their times (state row 6, differentiable); keys:
    (2,N) sample key words (rng.sample_keys). The kernels
    take any N (no tile alignment). Returns (radiance (3,N) in the rays'
    order, n_traced () int64: exact, from the traced row)."""
    ops_mega.check_scope(scene, rr_depth)
    if schedule is None:
        schedule = _fused_schedule(max_depth)
    n, dev = o.shape[1], o.device
    sph24 = ops_mega.pack_spheres_full(scene).to(dev)
    if bvh is None:
        bvh = chain_bvh(sph24, time, scene.has_moving)
    bg8 = ops_mega.pack_bg(scene).to(dev)
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    st = ops_mega.pack_state(o, d, time, ones.expand(3, n),
                             zeros.expand(3, n), zeros, ones, zeros)
    keys = rng.u32_bits(keys)
    lane = torch.arange(n, device=dev)
    for j, k in enumerate(schedule):
        st = ops_vjp.bounce_chain(k, max_depth, t_min, scene.has_moving)(
            st, keys, sph24, bg8, bvh)
        if j < len(schedule) - 1:
            st, keys, lane = _compact_lanes(st, keys, lane)
    # Undo the compactions: callers index by the rays' order.
    rad = torch.zeros_like(st[10:13]).index_copy(1, lane, st[10:13])
    return rad, st[ops_mega.ROW_TRACED].to(torch.int64).sum()


def trace_batch(scene: SceneArrays, o, d, time, keys, max_depth: int,
                t_min: float, differentiable: bool = False, packed=None,
                fused_vjp: bool = False, rr_depth: int = 0):
    """Trace a fixed ray batch to completion.

    o, d: (3,N) rays; time: (N,) their times; keys: (2,N) sample key
    words (rng.sample_keys).
    differentiable and fused_vjp: trace_batch_fused. Otherwise a Python
    loop of _bounce_body that ends at max_depth or when no lane is
    alive (one device-to-host read a bounce; dead lanes are the identity,
    so stopping early changes no gradient):

      forward         every bounce intersects through
                      ops.megakernel.intersect_only (its kernel for rays
                      on a CUDA device, its plain version on the CPU), on
                      packed = pack_scene(scene, o.device), made here
                      when not given, over the rays' own range of times
                      (one device-to-host read);
      differentiable  the scan: each bounce under
                      torch.utils.checkpoint, so only the carry between
                      bounces is kept and the bounce is recomputed in
                      the backward (rrt_tpu's lax.scan of
                      jax.checkpoint); it intersects through
                      geometry.intersect_spheres, as rrt_tpu's scan does
                      (`packed` is not used): the kernel's t carries no
                      gradient. With fused_vjp, packed's BVH, when
                      given, goes to trace_batch_fused.

    Returns (radiance (3,N), n_traced () int64: exact, where rrt_tpu
    sums it in f32)."""
    if differentiable and fused_vjp:
        return trace_batch_fused(scene, o, d, time, keys, max_depth, t_min,
                                 rr_depth=rr_depth,
                                 bvh=None if packed is None else packed["bvh"])
    ops_mega.check_scope(scene, rr_depth)
    if differentiable:
        packed = None
    elif packed is None:
        packed = pack_scene(scene, o.device, (time.min(), time.max())
                            if scene.has_moving else None)
    body = functools.partial(_bounce_body, scene, t_min, keys,
                             max_depth=max_depth, packed=packed)
    alive = torch.ones((o.shape[1],), dtype=torch.bool, device=o.device)
    carry = (o, d, time, torch.ones_like(o), torch.zeros_like(o), alive)
    n_traced = torch.zeros((), dtype=torch.int64, device=o.device)
    bounce = 0
    while bounce <= max_depth and bool(carry[5].any()):
        n_traced = n_traced + carry[5].sum()
        if differentiable:
            carry = checkpoint(body, *carry, bounce, use_reentrant=False)
        else:
            carry = body(*carry, bounce)
        bounce += 1
    return carry[4], n_traced


def render_tile(scene: SceneArrays, camera, px, py, cfg: RenderConfig, seed,
                pass_start: int, n_passes: int, differentiable: bool = False,
                packed=None):
    """Render one tile of pixels (px, py: (P,) on the scene's device)
    with n_passes sample passes through the batch driver. Pass i covers
    samples [(pass_start+i)*spc, ...+spc), spc = cfg.samples_per_pass.
    packed: pack_scene's dict over the camera's shutter (render_image
    makes it once an image), made here when not given (forward only:
    without it each bounce chain builds its own BVH).
    differentiable: each pass through trace_batch's bounce chain
    (trace_batch_fused, which walks packed's BVH) when
    ops_vjp.supports_backward(scene), else its checkpointed scan;
    rrt_tpu also requires a TPU and tile-aligned batches there, the port
    neither. Returns (radiance sums (P,3), n_traced)."""
    p_count = px.shape[0]
    spc = cfg.samples_per_pass
    pxr, pyr = px.repeat(spc), py.repeat(spc)
    gid = pyr * cfg.width + pxr
    replica = torch.arange(spc, device=px.device).repeat_interleave(p_count)
    seed_words = rng.key_words(seed)
    if packed is None and not differentiable:
        packed = pack_scene(scene, px.device, _shutter(camera))
    fused_vjp = differentiable and ops_vjp.supports_backward(scene)
    acc = torch.zeros((p_count, 3), dtype=torch.float32, device=px.device)
    n_traced = torch.zeros((), dtype=torch.int64, device=px.device)
    for i in range(n_passes):
        keys = rng.sample_keys(seed_words, gid,
                               (pass_start + i) * spc + replica)
        o, d, tm = generate_rays(camera, pxr, pyr, cfg.width, cfg.height,
                                 keys)
        rad, nt = trace_batch(scene, o, d, tm, keys, cfg.max_depth,
                              cfg.t_min, differentiable, packed=packed,
                              fused_vjp=fused_vjp, rr_depth=cfg.rr_depth)
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
    all cfg.spp. differentiable: the image is a differentiable function
    of the scene's and camera's tensors (render_tile). Returns (image
    (H,W,3) mean radiance over the rendered samples, n_traced). The queue
    and tile drivers render the same image faster."""
    ops_mega.check_scope(scene, cfg.rr_depth)
    if cfg.spp % cfg.samples_per_pass != 0:
        raise ValueError("spp must be a multiple of samples_per_pass")
    device = _check_device(device)
    scene, camera = scene.to(device), camera.to(device)
    if n_passes is None:
        n_passes = cfg.spp // cfg.samples_per_pass
    with torch.no_grad():  # the packs carry no gradient
        packed = pack_scene(scene, device, _shutter(camera))
    rads, n_traced = [], 0
    for px, py in _tile_coords(cfg, device):
        r, n = render_tile(scene, camera, px, py, cfg, seed, pass_start,
                           n_passes, differentiable, packed=packed)
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
    bounce steps in one launch of ops.megakernel.bounce_steps, which walks
    the BVH pack_scene builds once a call over the camera's shutter. The
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
    packed = pack_scene(scene, device, _shutter(camera))
    sph24, bvh = packed["sph24"], packed["bvh"]
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
                              max_depth=cfg.max_depth, t_min=cfg.t_min,
                              moving=scene.has_moving, bvh=bvh)
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
