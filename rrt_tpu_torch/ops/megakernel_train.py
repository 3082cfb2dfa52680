"""The differentiable tile render: train kernels, wrappers, plain versions.

The counterpart of rrt_tpu's `ops/megakernel_train.py` for the sphere
subset of the tile kernel (stationary and moving spheres, solid /
checker textures, lambertian / metal / dielectric, sky or solid
background, a thin-lens camera with a shutter, no Russian roulette).
`TileTrainChain` is the render as a torch.autograd.Function over the
packs (sph24, cam24, bg8):

  forward   `render_tiles_train`: the CUDA kernel train_fwd
            (csrc/train.cu), which renders exactly as tile_render, each
            pixel's samples back to back, and keeps the residual the
            backward needs: each path's executed bounce count (uint8 a
            path) and the winning slot of each pixel's first
            WINNERS_PER_SAMPLE * spp segments (int16 a segment);
  backward  `tiles_adjoint`: the CUDA kernel train_bwd, which replays
            each path from its counter-addressed key, recomputing only
            the stored winner's quadratic where there is one and
            scanning every slot where there is none, checks its length
            against the forward's (`replay_mismatches`), and sweeps the
            bounces in reverse through the hand-written transpose of
            megakernel_vjp.diff_step, into the cotangents of the packs.

On the TPU the residual was the 24-row loop carry at segment
boundaries, because one lane ran many pixels' samples in one loop. A
GPU thread traces one pixel, and a path restarts from its key
threefry(s0, s1, pixel, sample), so no carry is parked; the winners
spare the backward the scan, and take 2 * WINNERS_PER_SAMPLE + 1 bytes
a path with the lengths (`boundary_residual_bytes`).

CUDA tensors launch the kernels; CPU tensors run the plain versions
`render_tiles_train_reference` and `tiles_adjoint_reference`.
"""

import torch

from .. import rng
from . import _build
from . import megakernel as mk
from .megakernel_vjp import (MAX_RECORDS, SLOT_COLS, camera_ray_rows,
                             check_backward_slots, count_mismatches,
                             diff_step, grad_rows, replay_steps,
                             step_constants)
from ..camera import thin_lens_rays


# Winner entries a sample, pooled over a pixel's samples (csrc/train.cu):
# a pixel keeps the winners of its first WINNERS_PER_SAMPLE * spp
# segments. At chap12 1200x800, 8 spp, depth 50 the segments past the
# pool are well under 1% (chip_smoke.py [5] prints the share), and each
# costs the backward a scan.
WINNERS_PER_SAMPLE = 16


def winner_capacity(spp: int) -> int:
    """Winner entries a pixel keeps for spp samples."""
    return WINNERS_PER_SAMPLE * spp


def boundary_residual_bytes(n_pix: int, chunk: int) -> int:
    """Bytes one train launch keeps for its backward: every (pixel,
    sample) path's uint8 bounce count and its share of the int16
    winners."""
    return n_pix * chunk * (1 + 2 * WINNERS_PER_SAMPLE)


def _check_train_inputs(sph24, cam24, bg8, *, width, height, spp, max_depth,
                        moving):
    mk._check_inputs(sph24, cam24, bg8, width, height, spp, max_depth)
    if sph24.shape[1] > mk.MAX_SLOTS:
        raise ValueError(f"{sph24.shape[1]} sphere slots exceed the "
                         f"kernels' {mk.MAX_SLOTS}")
    check_backward_slots(sph24, moving)
    if max_depth + 1 > MAX_RECORDS:
        raise ValueError(f"max_depth {max_depth}: the backward keeps at "
                         f"most {MAX_RECORDS} bounce records a path "
                         f"(max_depth <= {MAX_RECORDS - 1})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.rrt_error_string(err).decode())


def render_tiles_train(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                       width: int, height: int, spp: int, max_depth: int,
                       t_min: float, moving: bool):
    """Render samples [sample_lo, sample_lo + spp) as render_tiles does,
    and keep the residual. Returns (radiance sums (P,3) f32, traced
    counts (P,) i32, lengths (spp, P) uint8: the bounces each path
    traced, winners (winner_capacity(spp), P) int16: winners[j, p] the
    slot pixel p's j-th segment hit, in trace order, -1 on a miss);
    moving: the moving-sphere variant. The kernel leaves the entries
    past a pixel's segments unwritten; the plain version sets them to
    -2.

    CUDA tensors launch train_fwd (counted in
    `render_tiles_train.launches`); CPU tensors run
    render_tiles_train_reference."""
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving)
    _check_train_inputs(sph24, cam24, bg8, width=width, height=height,
                        spp=spp, max_depth=max_depth, moving=moving)
    device = sph24.device
    if device.type == "cpu":
        return render_tiles_train_reference(sph24, cam24, bg8, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_tiles_train runs on cuda or cpu, not "
                         f"{device}")
    lib = _build.load()
    n_pix = width * height
    cap = winner_capacity(spp)
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traced = torch.empty((n_pix,), dtype=torch.int32, device=device)
    lengths = torch.empty((spp, n_pix), dtype=torch.uint8, device=device)
    winners = torch.empty((cap, n_pix), dtype=torch.int16, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        err = lib.rrt_train_fwd(
            sph24.data_ptr(), sph24.shape[1], cam24.data_ptr(),
            bg8.data_ptr(), s0, s1, sample_lo & rng.MASK32, width, height,
            spp, max_depth, t_min, int(moving), cap, rad.data_ptr(),
            traced.data_ptr(), lengths.data_ptr(), winners.data_ptr(),
            _stream(device))
    _raise_on(lib, err, "train_fwd")
    render_tiles_train.launches += 1
    return rad, traced, lengths, winners


render_tiles_train.launches = 0


def render_tiles_train_reference(sph24, cam24, bg8, *, seed_words,
                                 sample_lo: int, width: int, height: int,
                                 spp: int, max_depth: int, t_min: float,
                                 moving: bool):
    """Plain version of render_tiles_train: render_tiles_reference plus
    the lengths and the winners (mk.trace_paths_reference)."""
    return mk.trace_paths_reference(
        sph24, cam24, bg8, seed_words=seed_words, sample_lo=sample_lo,
        width=width, height=height, spp=spp, max_depth=max_depth,
        t_min=t_min, moving=moving, win_cap=winner_capacity(spp))


def tiles_adjoint(sph24, cam24, bg8, d_rad, lengths, winners, *,
                  seed_words, sample_lo: int, width: int, height: int,
                  spp: int, max_depth: int, t_min: float, moving: bool):
    """Cotangents of the packs for the radiance cotangent d_rad (P,3):
    (d_sph24 (24,S), d_cam24 (24,), d_bg8 (8,), replay mismatches (1,)
    int32: the paths whose replayed length differs from `lengths`, and
    the stored winners the replay does not find). With moving spheres
    the velocity rows 4-6 get cotangents, and the shutter rows 19-20 of
    the camera through each ray's time. `winners` is
    render_tiles_train's (any number of entries a pixel, int16), or None:
    then every bounce scans every slot, with the same d_cam and d_bg bit
    for bit and several times the time; callers pass it explicitly.

    CUDA tensors launch train_bwd (counted in `tiles_adjoint.launches`);
    CPU tensors run tiles_adjoint_reference. Either way the mismatches
    are added to `tiles_adjoint.replay_mismatches`
    (megakernel_vjp.count_mismatches): a replay off the forward's path
    would give wrong gradients."""
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving)
    _check_train_inputs(sph24, cam24, bg8, width=width, height=height,
                        spp=spp, max_depth=max_depth, moving=moving)
    n_pix = width * height
    if d_rad.dtype != torch.float32 or tuple(d_rad.shape) != (n_pix, 3):
        raise ValueError(f"d_rad must be ({n_pix}, 3) float32, got "
                         f"{tuple(d_rad.shape)} {d_rad.dtype}")
    if lengths.dtype != torch.uint8 or tuple(lengths.shape) != (spp,
                                                                 n_pix):
        raise ValueError(f"lengths must be ({spp}, {n_pix}) uint8")
    if winners is not None and (
            winners.dtype != torch.int16 or winners.dim() != 2
            or winners.shape[1] != n_pix or not winners.is_contiguous()):
        raise ValueError(f"winners must be a contiguous (cap, {n_pix}) "
                         "int16 tensor")
    device = sph24.device
    if any(t is not None and t.device != device
           for t in (d_rad, lengths, winners)):
        raise ValueError("d_rad, lengths and winners must be on the packs' "
                         "device")
    d_rad = d_rad.contiguous()
    if device.type == "cpu":
        out = tiles_adjoint_reference(sph24, cam24, bg8, d_rad, lengths,
                                      winners, **kw)
        count_mismatches(tiles_adjoint, out[3])
        return out
    if device.type != "cuda":
        raise ValueError(f"tiles_adjoint runs on cuda or cpu, not {device}")
    lib = _build.load()
    n_slots = sph24.shape[1]
    # Per-block partials and, below them, the first reduction's groups of
    # 64 blocks (csrc/train.cu rrt_train_bwd).
    rows = grad_rows(moving)
    n_blocks = -(-width // 16) * -(-height // 16)
    n_cols = SLOT_COLS * n_slots + 32
    partials = torch.empty((n_blocks + -(-n_blocks // 64), n_cols),
                           dtype=torch.float32, device=device)
    sums = torch.empty((n_cols,), dtype=torch.float32, device=device)
    mismatches = torch.zeros((1,), dtype=torch.int32, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        err = lib.rrt_train_bwd(
            sph24.data_ptr(), n_slots, cam24.data_ptr(), bg8.data_ptr(),
            d_rad.data_ptr(), lengths.data_ptr(),
            None if winners is None else winners.data_ptr(),
            0 if winners is None else winners.shape[0], s0, s1,
            sample_lo & rng.MASK32, width, height, spp, max_depth, t_min,
            int(moving), partials.data_ptr(), sums.data_ptr(),
            mismatches.data_ptr(), _stream(device))
    _raise_on(lib, err, "train_bwd")
    tiles_adjoint.launches += 1
    count_mismatches(tiles_adjoint, mismatches)
    d_sph24 = torch.zeros_like(sph24)
    d_sph24[list(rows)] = sums[:-32].reshape(n_slots, SLOT_COLS)[
        :, :len(rows)].T
    return d_sph24, sums[-32:-8].clone(), sums[-8:].clone(), mismatches


tiles_adjoint.launches = 0
tiles_adjoint.replay_mismatches = 0


def tiles_adjoint_reference(sph24, cam24, bg8, d_rad, lengths,
                            winners, *, seed_words, sample_lo: int,
                            width: int, height: int, spp: int,
                            max_depth: int, t_min: float, moving: bool,
                            chunk: int = 1 << 16):
    """Plain version of tiles_adjoint, same inputs and outputs.

    For each chunk of (pixel, sample) paths: 1. replay the decisions and
    winners under no_grad with the port's plain physics, counting a
    mismatch for a path whose length differs from `lengths` and for a
    stored winner (sample s's entries start at the sum of the pixel's
    earlier lengths; none when winners is None) that differs from the
    replay's; 2. rebuild every
    bounce with diff_step under autograd, from the winners' pack columns
    only (no (N,S) broadcast); 3. take torch.autograd.grad of
    sum(d_rad[pixel] . contribution)."""
    dev = sph24.device
    scene = mk._scene_from_packs(sph24.detach(), bg8.detach(), moving)
    basis = tuple(cam24.detach()[3 * i:3 * i + 3] for i in range(6))
    sph = sph24.detach().requires_grad_()
    cam = cam24.detach().requires_grad_()
    bg = bg8.detach().requires_grad_()
    grads = [torch.zeros_like(sph), torch.zeros_like(cam),
             torch.zeros_like(bg)]
    mismatches = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_pix = width * height
    n_rays = n_pix * spp
    chunk = min(chunk, n_pix)
    flat_lengths = lengths.reshape(-1).long()
    if winners is not None:  # each path's first entry, (spp * P,)
        first = (lengths.long().cumsum(dim=0) - lengths.long()).reshape(-1)
    for lo in range(0, n_rays, chunk):
        ray = torch.arange(lo, min(lo + chunk, n_rays), device=dev)
        pix = ray % n_pix
        keys = rng.sample_keys(tuple(seed_words), pix,
                               sample_lo + ray // n_pix)
        with torch.no_grad():
            o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19],
                                      cam24[20], pix % width, pix // width,
                                      width, height, keys)
            records, n_seg, _ = replay_steps(
                scene, o, d, tm, keys, torch.zeros_like(pix), max_depth + 1,
                max_depth=max_depth, t_min=t_min)
            mismatches += (n_seg != flat_lengths[ray]).sum().to(
                torch.int32)
            if winners is not None:
                mismatches += _stored_winner_faults(
                    records, ray, winners, first, flat_lengths, n_pix)
        with torch.enable_grad():
            state = camera_ray_rows(
                cam, (pix % width).to(torch.float32),
                (pix // width).to(torch.float32), rng.camera_draws(keys))
            state = state + (torch.ones_like(state[0]),) * 3
            total = 0.0
            for r in records:
                state = tuple(row[r["sel"]] for row in state)
                zero = torch.zeros_like(state[0])
                out = diff_step(step_constants(r, sph24, bg8), *state, zero,
                                zero, zero, sph[:, r["win"]], *bg[:6],
                                moving=moving)
                dr = d_rad[pix[r["cur"]]]
                total = total + (dr[:, 0] * out[10] + dr[:, 1] * out[11]
                                 + dr[:, 2] * out[12]).sum()
                state = out[:10]
            parts = torch.autograd.grad(total, (sph, cam, bg),
                                        allow_unused=True)
        for acc, g in zip(grads, parts):
            if g is not None:
                acc += g
    return (*grads, mismatches)


def _stored_winner_faults(records, ray, winners, first, flat_lengths,
                          n_pix):
    """The stored winners (winners[first[ray] + k, pixel] for bounces k
    inside the path's forward length and the pool) that differ from the
    replay's records (-1 on a miss). (1,) int32."""
    faults = torch.zeros((1,), dtype=torch.int32, device=ray.device)
    for k, r in enumerate(records):
        rays = ray[r["cur"]]
        j = first[rays] + k
        ok = (j < winners.shape[0]) & (k < flat_lengths[rays])
        replayed = torch.where(r["miss"], -1, r["win"])[ok]
        stored = winners[j[ok], rays[ok] % n_pix].long()
        faults += (stored != replayed).sum().to(torch.int32)
    return faults


class TileTrainChain(torch.autograd.Function):
    """The tile render as a differentiable function of the packs:
    apply(sph24, cam24, bg8, seed_words, sample_lo, width, height, spp,
    max_depth, t_min, moving) -> (radiance sums (P,3), traced counts (P,)
    i32).
    Forward: one render_tiles_train, whose lengths and winners it saves;
    backward: one tiles_adjoint on them, seeded by the radiance
    cotangent (P,3). The traced counts carry no gradient."""

    @staticmethod
    def forward(ctx, sph24, cam24, bg8, seed_words, sample_lo, width,
                height, spp, max_depth, t_min, moving):
        kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
                  height=height, spp=spp, max_depth=max_depth, t_min=t_min,
                  moving=moving)
        rad, traced, lengths, winners = render_tiles_train(sph24, cam24,
                                                           bg8, **kw)
        ctx.save_for_backward(sph24, cam24, bg8, lengths, winners)
        ctx.kw = kw
        ctx.mark_non_differentiable(traced)
        return rad, traced

    @staticmethod
    def backward(ctx, d_rad, _d_traced):
        sph24, cam24, bg8, lengths, winners = ctx.saved_tensors
        d_sph, d_cam, d_bg, _ = tiles_adjoint(
            sph24, cam24, bg8, d_rad.to(torch.float32), lengths, winners,
            **ctx.kw)
        return (d_sph, d_cam, d_bg) + (None,) * 8
