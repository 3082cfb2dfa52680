"""The differentiable tile render: train kernels, wrappers, plain versions.

The counterpart of rrt_tpu's `ops/megakernel_train.py` for the tile
kernel's scenes (stationary and moving spheres, quads, boxes rotated
about Y, up to MAX_TRAIN_MEDIA constant media, solid / checker /
perlin-marble / image textures, lambertian / metal / dielectric /
diffuse_light / isotropic, sky or solid background, a thin-lens camera
with a shutter, Russian roulette: `train_scope_gap`).
`TileTrainChain` is the render as a
torch.autograd.Function over the packs (sph24, cam24, bg8, and for a
scene with quads, boxes, media or a light its quad, box and medium
packs, and for a scene with textures the atlas):

  forward   `render_tiles_train`: the CUDA kernel train_fwd
            (csrc/train.cu), which renders exactly as tile_render, each
            pixel's samples back to back (a solid family past
            mk.SOLID_CAP active slots, rttnw_final's 400 ground boxes,
            over its tree: the SolidPacks' accel.SolidBvh, as the
            forward kernels walk it), and keeps the residual the
            backward needs: each path's executed bounce count (uint8 a
            path) and the winner of each pixel's first
            WINNERS_PER_SAMPLE * spp segments (int16 a segment: a
            sphere's slot, or mk.QUAD_CODE + a quad's, mk.BOX_CODE + a
            box's, mk.MEDIUM_CODE + a medium's, mk.CODE_SPAN slots a
            family; -1 a miss: mk.encode_winner);
  backward  `tiles_adjoint`: the CUDA kernel train_bwd, which replays
            each path from its counter-addressed key, recomputing only
            the stored winner's test where there is one and scanning
            every slot where there is none (every active quad and box
            in a loop: it reads no tree), checks its length
            against the forward's (`replay_mismatches`), and sweeps the
            bounces in reverse through the hand-written transpose of
            megakernel_vjp.diff_step (a surviving throughput's Russian
            roulette weight 1 / p detached, p recomputed from the
            record), into the cotangents of the packs
            (a quad's through its plane frame's n and d_plane, which the
            wrapper takes to q, u, v: geometry.quad_frame_vjp; a
            medium's into its MED_COLS; a marble's texture scale into
            its pack row) and of the atlas (an image's texels).

On the TPU the residual was the 24-row loop carry at segment
boundaries, because one lane ran many pixels' samples in one loop. A
GPU thread traces one pixel, and a path restarts from its key
threefry(s0, s1, pixel, sample), so no carry is parked; the winners
spare the backward the scan, and take 2 * WINNERS_PER_SAMPLE + 1 bytes
a path with the lengths (`boundary_residual_bytes`).

CUDA tensors launch the kernels; CPU tensors run the plain versions
`render_tiles_train_reference` and `tiles_adjoint_reference`.
"""

import ctypes
import dataclasses

import torch

from .. import rng
from . import _build
from . import megakernel as mk
from .megakernel_vjp import (MAX_RECORDS, SLOT_COLS, SPHERE_TEX_SCALE_ROW,
                             TEX_SCALE_COL, atlas_leaf, camera_ray_rows,
                             check_backward_slots, count_mismatches,
                             diff_step, grad_rows, kernel_solid_grads,
                             replay_steps, solid_grads, solid_leaves,
                             step_constants, unpack_inputs, winner_rows)
from ..camera import thin_lens_rays


# The constant media the train kernels take, rrt_tpu's gradient scope
# (ops/megakernel_train.py MAX_TRAIN_MEDIA: SceneArrays pads media to 8
# slots). A scene with more renders on the forward kernels, and its
# gradient takes rrt_tpu's scan on the CPU; on a card it raises.
MAX_TRAIN_MEDIA = 8


def train_scope_gap(scene):
    """The train kernels' scope (rrt_tpu's supports_train): None when
    they cover the scene, otherwise (what is outside, its ROADMAP item:
    mk.roadmap_ref), with rrt_tpu's reasons: the forward kernels'
    (mk.scope_gap: an image texture on a medium), then more than
    MAX_TRAIN_MEDIA media. Any number of quads and boxes: train_fwd
    walks a family's tree past mk.SOLID_CAP, train_bwd loops (a scene
    past what a block may opt into raises before the launch:
    _check_train_smem). Russian roulette is in every scope."""
    gap = mk.scope_gap(scene)
    if gap is None and scene.n_media_active > MAX_TRAIN_MEDIA:
        return (f"{scene.n_media_active} constant media, past the train "
                f"kernels' {MAX_TRAIN_MEDIA}-slot gradient scope", "#9.4")
    return gap


def supports_train(scene) -> bool:
    """Whether the train kernels cover the scene (train_scope_gap)."""
    return train_scope_gap(scene) is None


def check_train_scope(where: str, scene):
    """Raise NotImplementedError naming the ROADMAP item for a scene
    outside train_scope_gap's scope."""
    gap = train_scope_gap(scene)
    if gap is not None:
        raise NotImplementedError(
            f"{where}: {gap[0]} is outside the train kernels' scope "
            f"({mk.roadmap_ref(gap[1])})")


def _check_train_media(solids):
    if solids is not None and solids.n_media > MAX_TRAIN_MEDIA:
        raise NotImplementedError(
            f"{solids.n_media} constant media: the train kernels take at "
            f"most {MAX_TRAIN_MEDIA} (ROADMAP Queue A #9.4)")


# The kernels train_blocks takes, as csrc/train.cu's rrt_train_blocks
# numbers them.
TRAIN_KERNELS = ("train_fwd", "train_bwd")


def _check_train_smem(kernel: str, n_slots: int, moving: bool, solids,
                      solid_arg, tex):
    """Raise NotImplementedError, before a launch, when what a train
    kernel stages (the spheres, the solid rows and, for train_fwd's
    walk, the solid trees: csrc/train.cu fwd_kernel and bwd_kernel)
    passes what a block of it may opt into on the current CUDA device;
    else rrt_train_blocks' (blocks an SM, the bytes, the room)."""
    lib = _build.load()
    blocks, smem, room = (ctypes.c_int(0), ctypes.c_longlong(0),
                          ctypes.c_longlong(0))
    err = lib.rrt_train_blocks(
        TRAIN_KERNELS.index(kernel), n_slots, int(moving), solid_arg,
        int(tex is not None), ctypes.byref(blocks), ctypes.byref(smem),
        ctypes.byref(room))
    _raise_on(lib, err, f"{kernel}'s shared-memory query")
    blocks, need, room = blocks.value, smem.value, room.value
    if need > room:
        raise NotImplementedError(
            f"{kernel} stages {need} bytes of spheres, solid rows and "
            f"solid trees, past the {room} a block may opt into "
            f"({n_slots} sphere slots"
            + ("" if solids is None else
               f", {solids.n_quads} quads, {solids.n_boxes} boxes")
            + f": ROADMAP {mk.FORWARD_SMEM_ITEM})")
    return blocks, need, room


def train_blocks(kernel: str, sph24, *, moving: bool, solids=None,
                 tex=None):
    """The blocks an SM of the instantiation train_fwd ("train_fwd") or
    train_bwd ("train_bwd") launches for these packs on their CUDA
    device, at the dynamic shared memory the launch takes, and what a
    block may opt into: {"blocks", "smem_bytes", "room"}. Raises as the
    launch would when the bytes pass the room."""
    device = sph24.device
    scope = "walk" if kernel == "train_fwd" else "loop"
    solid_arg = mk._check_solids(solids, device, scope)
    with torch.cuda.device(device):
        blocks, smem, room = _check_train_smem(
            kernel, sph24.shape[1], moving, solids, solid_arg, tex)
    return {"blocks": blocks, "smem_bytes": smem, "room": room}


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
                        moving, rr_depth=0):
    mk._check_inputs(sph24, cam24, bg8, width, height, spp, max_depth,
                     rr_depth)
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
                       t_min: float, moving: bool, solids=None, tex=None,
                       rr_depth: int = 0, row_lo: int = 0,
                       row_hi: int | None = None):
    """Render samples [sample_lo, sample_lo + spp) of the rows [row_lo,
    row_hi) (default all: mk.check_window; P their pixels, each keyed by
    its id in the whole image) as render_tiles does, and keep the
    residual. Returns (radiance sums (P,3) f32, traced
    counts (P,) i32, lengths (spp, P) uint8: the bounces each path
    traced, winners (winner_capacity(spp), P) int16: winners[j, p] the
    code of the winner of pixel p's j-th segment, in trace order
    (mk.encode_winner: a sphere's slot, or a quad's, box's or medium's
    offset by mk.QUAD_CODE, mk.BOX_CODE or mk.MEDIUM_CODE; -1 on a
    miss)); moving: the moving-sphere variant; solids: the scene's
    SolidPacks (the solid-family variant; at most MAX_TRAIN_MEDIA
    media; on a CUDA device with the families' trees, mk.pack_solids',
    which the kWalk instantiation walks past mk.SOLID_CAP active slots of
    a family) or None; tex: its TexPack (the texture variant) or None;
    rr_depth: Russian roulette's first bounce (0: off), a lost coin
    ending a path as an absorption does (its length counts the bounce).
    The kernel leaves the entries past a pixel's segments unwritten; the
    plain version sets them to -2.

    CUDA tensors launch train_fwd (counted in
    `render_tiles_train.launches`); CPU tensors run
    render_tiles_train_reference."""
    _check_train_inputs(sph24, cam24, bg8, width=width, height=height,
                        spp=spp, max_depth=max_depth, moving=moving,
                        rr_depth=rr_depth)
    row_lo, row_hi = mk.check_window(height, row_lo, row_hi)
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving, solids=solids, tex=tex, rr_depth=rr_depth,
              row_lo=row_lo, row_hi=row_hi)
    _check_train_media(solids)
    mk.check_codes(solids)
    device = sph24.device
    solid_arg = mk._check_solids(solids, device, "walk")
    tex_arg = mk._check_tex(tex, device)
    if device.type == "cpu":
        return render_tiles_train_reference(sph24, cam24, bg8, **kw)
    if device.type != "cuda":
        raise ValueError(f"render_tiles_train runs on cuda or cpu, not "
                         f"{device}")
    with torch.cuda.device(device):
        _check_train_smem("train_fwd", sph24.shape[1], moving, solids,
                          solid_arg, tex)
    lib = _build.load()
    n_pix = width * (row_hi - row_lo)
    cap = winner_capacity(spp)
    rad = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    traced = torch.empty((n_pix,), dtype=torch.int32, device=device)
    lengths = torch.empty((spp, n_pix), dtype=torch.uint8, device=device)
    winners = torch.empty((cap, n_pix), dtype=torch.int16, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        err = lib.rrt_train_fwd(
            sph24.data_ptr(), sph24.shape[1], cam24.data_ptr(),
            bg8.data_ptr(), solid_arg, tex_arg, s0, s1,
            sample_lo & rng.MASK32, width, row_lo, row_hi, spp, max_depth,
            rr_depth, t_min, int(moving), cap, rad.data_ptr(),
            traced.data_ptr(), lengths.data_ptr(), winners.data_ptr(),
            _stream(device))
    _raise_on(lib, err, "train_fwd")
    render_tiles_train.launches += 1
    return rad, traced, lengths, winners


render_tiles_train.launches = 0


def render_tiles_train_reference(sph24, cam24, bg8, *, seed_words,
                                 sample_lo: int, width: int, height: int,
                                 spp: int, max_depth: int, t_min: float,
                                 moving: bool, solids=None, tex=None,
                                 rr_depth: int = 0, row_lo: int = 0,
                                 row_hi: int | None = None):
    """Plain version of render_tiles_train: render_tiles_reference plus
    the lengths and the winners (mk.trace_paths_reference)."""
    return mk.trace_paths_reference(
        sph24, cam24, bg8, seed_words=seed_words, sample_lo=sample_lo,
        width=width, height=height, spp=spp, max_depth=max_depth,
        t_min=t_min, moving=moving, solids=solids, tex=tex,
        win_cap=winner_capacity(spp), rr_depth=rr_depth, row_lo=row_lo,
        row_hi=row_hi)


def tiles_adjoint(sph24, cam24, bg8, d_rad, lengths, winners, *,
                  seed_words, sample_lo: int, width: int, height: int,
                  spp: int, max_depth: int, t_min: float, moving: bool,
                  solids=None, tex=None, rr_depth: int = 0, row_lo: int = 0,
                  row_hi: int | None = None):
    """Cotangents of the packs for the radiance cotangent d_rad (P,3) of
    the rows [row_lo, row_hi) (default all: mk.check_window; P their
    pixels, with render_tiles_train's lengths and winners of the same
    rows): (d_sph24 (24,S), d_cam24 (24,), d_bg8 (8,), replay mismatches
    (1,) int32: the paths whose replayed length differs from `lengths`, and
    the stored winners the replay does not find; d_solids: with solids
    (the scene's SolidPacks: the solid-family variant) the SolidPacks of
    the quad, box and medium packs' cotangents, else None; d_atlas: with
    tex (the scene's TexPack: the texture variant) holding images, the
    atlas's cotangent (T, 4), float atomics on the card, so it repeats
    within a spread; else None). A marble's texture scale gets its
    gradient in its pack row (17 of a sphere's, 19 of a quad's, 18 of a
    box's). With moving spheres
    the velocity rows 4-6 get cotangents, and the shutter rows 19-20 of
    the camera through each ray's time. `winners` is
    render_tiles_train's (any number of entries a pixel, int16), or None:
    then every bounce scans every slot, with the same d_cam and d_bg bit
    for bit and several times the time; callers pass it explicitly.
    rr_depth: the forward's; the replay redraws Russian roulette's coin,
    and a surviving throughput's 1 / p is a constant of the gradient.

    CUDA tensors launch train_bwd (counted in `tiles_adjoint.launches`);
    CPU tensors run tiles_adjoint_reference. Either way the mismatches
    are added to `tiles_adjoint.replay_mismatches`
    (megakernel_vjp.count_mismatches): a replay off the forward's path
    would give wrong gradients."""
    _check_train_inputs(sph24, cam24, bg8, width=width, height=height,
                        spp=spp, max_depth=max_depth, moving=moving,
                        rr_depth=rr_depth)
    row_lo, row_hi = mk.check_window(height, row_lo, row_hi)
    kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
              height=height, spp=spp, max_depth=max_depth, t_min=t_min,
              moving=moving, solids=solids, tex=tex, rr_depth=rr_depth,
              row_lo=row_lo, row_hi=row_hi)
    n_pix = width * (row_hi - row_lo)
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
    _check_train_media(solids)
    mk.check_codes(solids)
    solid_arg = mk._check_solids(solids, device, "loop")
    d_atlas = (torch.zeros_like(tex.atlas)
               if tex is not None and tex.has_images
               and device.type == "cuda" else None)
    tex_arg = mk._check_tex(tex, device, d_atlas)
    d_rad = d_rad.contiguous()
    if device.type == "cpu":
        out = tiles_adjoint_reference(sph24, cam24, bg8, d_rad, lengths,
                                      winners, **kw)
        count_mismatches(tiles_adjoint, out[3])
        return out
    if device.type != "cuda":
        raise ValueError(f"tiles_adjoint runs on cuda or cpu, not {device}")
    with torch.cuda.device(device):
        _check_train_smem("train_bwd", sph24.shape[1], moving, solids,
                          solid_arg, tex)
    lib = _build.load()
    n_slots = sph24.shape[1]
    n_solid = 0 if solids is None else (solids.n_quads + solids.n_boxes
                                        + solids.n_media)
    # Per-block partials (SLOT_COLS floats a slot: the spheres', then the
    # active quads', boxes' and media's; then 32 of the camera and
    # background)
    # and, below them, the first reduction's groups of 64 blocks
    # (csrc/train.cu rrt_train_bwd).
    rows = grad_rows(moving)
    n_blocks = -(-width // 16) * -(-(row_hi - row_lo) // 16)
    n_cols = SLOT_COLS * (n_slots + n_solid) + 32
    partials = torch.empty((n_blocks + -(-n_blocks // 64), n_cols),
                           dtype=torch.float32, device=device)
    sums = torch.empty((n_cols,), dtype=torch.float32, device=device)
    mismatches = torch.zeros((1,), dtype=torch.int32, device=device)
    s0, s1 = rng._seed_words(tuple(seed_words))
    with torch.cuda.device(device):
        err = lib.rrt_train_bwd(
            sph24.data_ptr(), n_slots, cam24.data_ptr(), bg8.data_ptr(),
            solid_arg, tex_arg, d_rad.data_ptr(), lengths.data_ptr(),
            None if winners is None else winners.data_ptr(),
            0 if winners is None else winners.shape[0], s0, s1,
            sample_lo & rng.MASK32, width, row_lo, row_hi, spp, max_depth,
            rr_depth, t_min, int(moving), partials.data_ptr(),
            sums.data_ptr(), mismatches.data_ptr(), _stream(device))
    _raise_on(lib, err, "train_bwd")
    tiles_adjoint.launches += 1
    count_mismatches(tiles_adjoint, mismatches)
    g = sums[:-32].reshape(n_slots + n_solid, SLOT_COLS)
    d_sph24 = torch.zeros_like(sph24)
    d_sph24[list(rows)] = g[:n_slots, :len(rows)].T
    d_sph24[SPHERE_TEX_SCALE_ROW] = g[:n_slots, TEX_SCALE_COL]
    d_solids = (None if solids is None
                else kernel_solid_grads(g[n_slots:], solids))
    return (d_sph24, sums[-32:-8].clone(), sums[-8:].clone(), mismatches,
            d_solids, d_atlas)


tiles_adjoint.launches = 0
tiles_adjoint.replay_mismatches = 0


def tiles_adjoint_reference(sph24, cam24, bg8, d_rad, lengths,
                            winners, *, seed_words, sample_lo: int,
                            width: int, height: int, spp: int,
                            max_depth: int, t_min: float, moving: bool,
                            solids=None, tex=None, rr_depth: int = 0,
                            row_lo: int = 0, row_hi: int | None = None,
                            chunk: int = 1 << 16):
    """Plain version of tiles_adjoint, same inputs and outputs.

    For each chunk of (pixel, sample) paths: 1. replay the decisions and
    winners under no_grad with the port's plain physics, counting a
    mismatch for a path whose length differs from `lengths` and for a
    stored winner (sample s's entries start at the sum of the pixel's
    earlier lengths; none when winners is None) that differs from the
    replay's; 2. rebuild every
    bounce with diff_step under autograd, from the winners' pack columns
    only (no (N,S) broadcast; the quads' through mk.quad_frame_pack, the
    media's rows of their pack; Russian roulette's kills replayed and its
    1 / p detached);
    3. take torch.autograd.grad of sum(d_rad[pixel] . contribution)."""
    dev = sph24.device
    scene = mk._scene_from_packs(sph24.detach(), bg8.detach(), moving,
                                 solids, tex)
    basis = tuple(cam24.detach()[3 * i:3 * i + 3] for i in range(6))
    sph = sph24.detach().requires_grad_()
    cam = cam24.detach().requires_grad_()
    bg = bg8.detach().requires_grad_()
    quads, boxes, media = solid_leaves(solids)
    atlas = atlas_leaf(tex)
    leaves = {k: x for k, x in (("sph", sph), ("cam", cam), ("bg", bg),
                                ("quad", quads), ("box", boxes),
                                ("med", media), ("atlas", atlas))
              if x is not None}
    grads = {k: torch.zeros_like(x) for k, x in leaves.items()}
    mismatches = torch.zeros((1,), dtype=torch.int32, device=dev)
    row_lo, row_hi = mk.check_window(height, row_lo, row_hi)
    n_pix = width * (row_hi - row_lo)
    n_rays = n_pix * spp
    chunk = min(chunk, n_pix)
    flat_lengths = lengths.reshape(-1).long()
    if winners is not None:  # each path's first entry, (spp * P,)
        first = (lengths.long().cumsum(dim=0) - lengths.long()).reshape(-1)
    for lo in range(0, n_rays, chunk):
        ray = torch.arange(lo, min(lo + chunk, n_rays), device=dev)
        pix = ray % n_pix  # the band's; keyed by the image's id
        gid = pix + row_lo * width
        keys = rng.sample_keys(tuple(seed_words), gid,
                               sample_lo + ray // n_pix)
        with torch.no_grad():
            o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19],
                                      cam24[20], gid % width, gid // width,
                                      width, height, keys)
            records, n_seg, _ = replay_steps(
                scene, o, d, tm, keys, torch.zeros_like(pix), max_depth + 1,
                max_depth=max_depth, t_min=t_min, rr_depth=rr_depth)
            mismatches += (n_seg != flat_lengths[ray]).sum().to(
                torch.int32)
            if winners is not None:
                mismatches += _stored_winner_faults(
                    records, ray, winners, first, flat_lengths, n_pix)
        with torch.enable_grad():
            frames = None if quads is None else mk.quad_frame_pack(quads)
            state = camera_ray_rows(
                cam, (gid % width).to(torch.float32),
                (gid // width).to(torch.float32), rng.camera_draws(keys))
            state = state + (torch.ones_like(state[0]),) * 3
            total = 0.0
            for r in records:
                state = tuple(row[r["sel"]] for row in state)
                zero = torch.zeros_like(state[0])
                sel, flags = winner_rows(r, sph, frames, boxes, media, tex)
                out = diff_step(step_constants(r, sph24, bg8, solids),
                                *state, zero, zero, zero, *sel, *bg[:6],
                                *(() if atlas is None else (atlas,)),
                                moving=moving, t_min=t_min,
                                rr_depth=rr_depth, **flags)
                dr = d_rad[pix[r["cur"]]]
                total = total + (dr[:, 0] * out[10] + dr[:, 1] * out[11]
                                 + dr[:, 2] * out[12]).sum()
                state = out[:10]
            parts = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        for k, g in zip(leaves, parts):
            if g is not None:
                grads[k] += g
    d_solids = None if solids is None else solid_grads(
        solids, grads.get("quad"), grads.get("box"), grads.get("med"))
    return (grads["sph"], grads["cam"], grads["bg"], mismatches, d_solids,
            grads.get("atlas"))


def _stored_winner_faults(records, ray, winners, first, flat_lengths,
                          n_pix):
    """The stored winners (winners[first[ray] + k, pixel] for bounces k
    inside the path's forward length and the pool) that differ from the
    replay's records' codes (mk.encode_winner, -1 on a miss). (1,)
    int32."""
    faults = torch.zeros((1,), dtype=torch.int32, device=ray.device)
    for k, r in enumerate(records):
        rays = ray[r["cur"]]
        j = first[rays] + k
        ok = (j < winners.shape[0]) & (k < flat_lengths[rays])
        replayed = torch.where(r["miss"], -1,
                               mk.encode_winner(r["fam"], r["win"]))[ok]
        stored = winners[j[ok], rays[ok] % n_pix].long()
        faults += (stored != replayed).sum().to(torch.int32)
    return faults


class TileTrainChain(torch.autograd.Function):
    """The tile render as a differentiable function of the packs:
    apply(sph24, cam24, bg8, seed_words, sample_lo, width, height, spp,
    max_depth, t_min, moving, *solid_inputs(solids, tex, rr_depth)) ->
    (radiance sums (P,3), traced counts (P,) i32), the last arguments the
    quad and box packs, their layout (active slot counts and the trees,
    which train_fwd walks) and the medium pack (or None) of a scene with
    quads, boxes, media or a light, the atlas of a scene with textures,
    and Russian roulette's first bounce (megakernel_vjp.solid_inputs),
    then an optional `window`, the band of rows (row_lo, row_hi) to
    render (None: every row; P the band's pixels).
    Forward: one render_tiles_train, whose lengths and winners it saves;
    backward: one tiles_adjoint on them, seeded by the radiance
    cotangent (P,3). The traced counts carry no gradient."""

    @staticmethod
    def forward(ctx, sph24, cam24, bg8, seed_words, sample_lo, width,
                height, spp, max_depth, t_min, moving, quad24=None,
                box24=None, layout=None, med24=None, atlas=None, tex=None,
                rr_depth=0, window=None):
        row_lo, row_hi = (0, None) if window is None else window
        kw = dict(seed_words=seed_words, sample_lo=sample_lo, width=width,
                  height=height, spp=spp, max_depth=max_depth, t_min=t_min,
                  moving=moving, rr_depth=rr_depth, row_lo=row_lo,
                  row_hi=row_hi)
        solids, tex = unpack_inputs(quad24, box24, layout, med24, atlas, tex)
        rad, traced, lengths, winners = render_tiles_train(
            sph24, cam24, bg8, solids=solids, tex=tex, **kw)
        ctx.save_for_backward(sph24, cam24, bg8, lengths, winners, quad24,
                              box24, med24, atlas)
        ctx.kw = kw
        ctx.layout = layout
        ctx.tex = None if tex is None else dataclasses.replace(tex,
                                                                atlas=None)
        ctx.mark_non_differentiable(traced)
        return rad, traced

    @staticmethod
    def backward(ctx, d_rad, _d_traced):
        (sph24, cam24, bg8, lengths, winners, quad24, box24, med24,
         atlas) = ctx.saved_tensors
        solids, tex = unpack_inputs(quad24, box24, ctx.layout, med24, atlas,
                                    ctx.tex)
        d_sph, d_cam, d_bg, _, d_solids, d_atlas = tiles_adjoint(
            sph24, cam24, bg8, d_rad.to(torch.float32), lengths, winners,
            solids=solids, tex=tex, **ctx.kw)
        d_quad, d_box, d_med = ((None, None, None) if d_solids is None
                                else (d_solids.quad24, d_solids.box24,
                                      d_solids.med24))
        return ((d_sph, d_cam, d_bg) + (None,) * 8
                + (d_quad, d_box, None, d_med, d_atlas, None, None, None))
