"""The differentiable bounce and the bounce chain's backward.

`diff_step` is the sphere-subset counterpart of rrt_tpu's
`ops/megakernel_vjp.py::_make_diff_step`: one bounce as a function of
the 13 state rows (origin, direction, time, throughput, pending
radiance), the winner's 24 sphere-pack rows and the 6 background rows
(with moving spheres, the winner's center at the ray's time, so the
velocity rows and the time get gradients too),
with every discrete decision (root, front face, checker parity,
degenerate lambertian, reflect-vs-refract, hit / miss / survival) and
every random draw supplied as a replayed constant. It is the math the
CUDA backwards transpose by hand (csrc/adjoint.cuh, shared by train.cu
and chain.cu), and the body of their plain versions
(megakernel_train.tiles_adjoint_reference, chain_adjoint_reference),
which differentiate it with autograd.

`camera_ray_rows` is the thin-lens camera ray as a function of the 24
camera-pack rows (rrt_tpu's `megakernel_train._camera_ray_rows`); the
backward applies it at bounce 0 of every sample.

Square roots and reciprocals on masked branches are guarded with a
double `where`, as rrt_tpu does, so a branch that is not taken never
leaks NaN into a gradient.

`BounceChain` (`bounce_chain`) is K bounce steps of the (16, Q) lane
state as a torch.autograd.Function over the state and the packs, the
counterpart of rrt_tpu's `bounce_chain` custom_vjp:

  forward   ops.megakernel.bounce_steps (csrc/queue.cu) on a copy of the
            input state, which is the only residual besides the keys,
            the packs, the BVH pack and the output's bounce row;
  backward  `chain_adjoint`: the CUDA kernel chain_bwd (csrc/chain.cu),
            the counterpart of rrt_tpu's `_bwd_kernel`, which replays
            the K steps from the input state, walking the forward's BVH,
            and sweeps them in reverse through the hand-written
            transpose of diff_step. Its plain version is
            `chain_adjoint_reference`, which CPU tensors run.
"""

import torch

from .. import rng
from . import _build
from . import megakernel as mk
from ..scene import MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL

# The backward kernels keep one record per replayed bounce in
# per-thread storage of this many entries (csrc/adjoint.cuh kMaxRecords).
MAX_RECORDS = 64

# The sphere-pack rows that receive gradients, in the order the CUDA
# backwards accumulate them: center (motion base) xyz, r^2, aux, color1
# rgb, color2 rgb, signed radius, then, with moving spheres only, the
# velocity xyz (csrc/adjoint.cuh kGradRows; grad_rows).
GRAD_ROWS = (0, 1, 2, 3, 9, 10, 11, 12, 13, 14, 15, 18, 4, 5, 6)
# The backwards take MAX_SLOTS slots, or this many with moving spheres
# (the limit their shared-memory accumulators once set, which the tests
# hold; the pack cotangents now go to device memory).
MAX_SLOTS_MOVING = 2048
# Pack cotangent floats a slot in the CUDA backwards' per-block partials
# and sums (csrc/adjoint.cuh kSlotCols): grad_rows(moving), then zeros.
SLOT_COLS = 16


def grad_rows(moving: bool):
    """The GRAD_ROWS a backward accumulates: the velocity rows only with
    moving spheres, so a static scene's backward is unchanged."""
    return GRAD_ROWS if moving else GRAD_ROWS[:12]


def check_backward_slots(sph24, moving: bool):
    """Raise for more slots than a CUDA backward's shared memory takes."""
    cap = MAX_SLOTS_MOVING if moving else mk.MAX_SLOTS
    if sph24.device.type == "cuda" and sph24.shape[1] > cap:
        raise ValueError(f"{sph24.shape[1]} sphere slots exceed the "
                         f"backward kernels' {cap}"
                         + (" with moving spheres" if moving else ""))


# The families outside the sphere subset, by flag: the ROADMAP Queue A
# item that ports each.
_NOT_PORTED = (("has_quads", "quads", "#9.2"),
               ("has_boxes", "boxes", "#9.3"),
               ("n_media", "constant media", "#9.4"),
               ("has_perlin", "perlin textures", "#9.5"),
               ("has_images", "image textures", "#9.5"),
               ("rr_depth", "Russian roulette", "#9.6"))


def diff_step(c, *ins, moving, has_quads=False, has_boxes=False,
              has_perlin=False, has_images=False, n_media=0, rr_depth=0):
    """One bounce, differentiable in `ins`: 13 state rows (ox, oy, oz,
    dx, dy, dz, time, thx, thy, thz, pex, pey, pez), sel_s (24, N) (the
    winner's pack column per ray) and 6 background rows (bottom rgb,
    top rgb). Returns the 13 state rows after the bounce.

    c: the replayed constants, (N,) bool tensors t_hit (float), hit,
    miss, survives, front, degen, do_reflect, use_c2, is_lam, is_met,
    is_die; is_sky (0-d bool); draws, the 7 rows (unit xyz, sphere xyz,
    choice) of the bounce's scatter draws. moving: the winner's center
    is sel_s rows 0-2 + time * rows 4-6, in the quadratic and the
    normal. The other families' flags raise NotImplementedError."""
    flags = dict(has_quads=has_quads, has_boxes=has_boxes,
                 n_media=n_media, has_perlin=has_perlin,
                 has_images=has_images, rr_depth=rr_depth)
    for flag, what, item in _NOT_PORTED:
        if flags[flag]:
            raise NotImplementedError(
                f"diff_step: {what} are not ported to rrt_tpu_torch yet "
                f"(ROADMAP Queue A {item})")
    (ox, oy, oz, dx, dy, dz, time, thx, thy, thz,
     pex, pey, pez) = ins[:13]
    sel_s = ins[13]
    bg6 = ins[14:20]
    where = torch.where

    a = dx * dx + dy * dy + dz * dz
    o_dot_d = ox * dx + oy * dy + oz * dz
    o_dot_o = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a
    d_len = torch.sqrt(a)

    # --- the winner's t: the tile loop's quadratic on its rows; the root
    # is the one the forward accepted (the one nearest the stored t).
    if moving:
        cx = sel_s[0] + time * sel_s[4]
        cy = sel_s[1] + time * sel_s[5]
        cz = sel_s[2] + time * sel_s[6]
    else:
        cx, cy, cz = sel_s[0], sel_s[1], sel_s[2]
    d_c = dx * cx + dy * cy + dz * cz
    o_c = ox * cx + oy * cy + oz * cz
    c_sq = cx * cx + cy * cy + cz * cz
    half_b = o_dot_d - d_c
    c_coef = o_dot_o - 2.0 * o_c + c_sq - sel_s[3]
    disc = half_b * half_b - a * c_coef
    disc_ok = disc > 0.0
    sq = torch.sqrt(where(disc_ok, disc, 1.0))
    root0 = (-half_b - sq) * inv_a
    root1 = (-half_b + sq) * inv_a
    pick0 = (root0 - c["t_hit"]).abs() <= (root1 - c["t_hit"]).abs()
    t_hit = where(pick0, root0, root1)

    t_eff = where(c["hit"], t_hit, 0.0)
    px_ = ox + t_eff * dx
    py_ = oy + t_eff * dy
    pz_ = oz + t_eff * dz

    # --- the winner's normal (a negative radius flips it inward).
    srad = sel_s[18]
    inv_r = 1.0 / where(srad.abs() > 1e-20, srad, 1.0)
    sgn = where(c["front"], 1.0, -1.0)
    nx_ = (px_ - cx) * inv_r * sgn
    ny_ = (py_ - cy) * inv_r * sgn
    nz_ = (pz_ - cz) * inv_r * sgn
    aux_v = sel_s[9]

    # --- albedo (checker parity replayed).
    albr = where(c["use_c2"], sel_s[13], sel_s[10])
    albg = where(c["use_c2"], sel_s[14], sel_s[11])
    albb = where(c["use_c2"], sel_s[15], sel_s[12])

    # --- scatter (draws and decisions replayed).
    ux, uy_, uz, sx, sy, sz, _u_choice = c["draws"]
    ldx = where(c["degen"], nx_, nx_ + ux)
    ldy = where(c["degen"], ny_, ny_ + uy_)
    ldz = where(c["degen"], nz_, nz_ + uz)

    inv_dl = 1.0 / torch.clamp(d_len, min=1e-20)
    udx = dx * inv_dl
    udy = dy * inv_dl
    udz = dz * inv_dl
    ud_n = udx * nx_ + udy * ny_ + udz * nz_
    rfx = udx - 2.0 * ud_n * nx_
    rfy = udy - 2.0 * ud_n * ny_
    rfz = udz - 2.0 * ud_n * nz_
    mdx = rfx + aux_v * sx
    mdy = rfy + aux_v * sy
    mdz = rfz + aux_v * sz

    # Double where: on a metal aux is the fuzz, which may be 0.
    aux_ok = aux_v > 1e-10
    ratio = where(c["front"], 1.0 / where(aux_ok, aux_v, 1.0), aux_v)
    cos_t = torch.clamp(-ud_n, max=1.0)
    rpx = ratio * (udx + cos_t * nx_)
    rpy = ratio * (udy + cos_t * ny_)
    rpz = ratio * (udz + cos_t * nz_)
    rpar_sq = 1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)
    refr_ok = rpar_sq > 1e-12
    rlen = torch.sqrt(where(refr_ok, rpar_sq, 1.0)) * refr_ok
    ddx = where(c["do_reflect"], rfx, rpx - rlen * nx_)
    ddy = where(c["do_reflect"], rfy, rpy - rlen * ny_)
    ddz = where(c["do_reflect"], rfz, rpz - rlen * nz_)

    is_lam, is_met, is_die = c["is_lam"], c["is_met"], c["is_die"]
    ndx = where(is_lam, ldx, where(is_met, mdx, where(is_die, ddx, sx)))
    ndy = where(is_lam, ldy, where(is_met, mdy, where(is_die, ddy, sy)))
    ndz = where(is_lam, ldz, where(is_met, mdz, where(is_die, ddz, sz)))
    atr = where(is_die, 1.0, albr)
    atg = where(is_die, 1.0, albg)
    atb = where(is_die, 1.0, albb)

    # --- the miss's background (no emitters in this subset).
    inv_dl2 = torch.rsqrt(torch.clamp(a, min=1e-20))
    tsky = 0.5 * (dy * inv_dl2 + 1.0)
    is_sky = c["is_sky"]
    bgr = where(is_sky, (1.0 - tsky) * bg6[0] + tsky * bg6[3], bg6[0])
    bgg = where(is_sky, (1.0 - tsky) * bg6[1] + tsky * bg6[4], bg6[1])
    bgb = where(is_sky, (1.0 - tsky) * bg6[2] + tsky * bg6[5], bg6[2])
    missf = c["miss"].to(torch.float32)
    pex = pex + thx * (bgr * missf)
    pey = pey + thy * (bgg * missf)
    pez = pez + thz * (bgb * missf)

    sv = c["survives"]
    return (where(sv, px_, ox), where(sv, py_, oy), where(sv, pz_, oz),
            where(sv, ndx, dx), where(sv, ndy, dy), where(sv, ndz, dz),
            time, where(sv, thx * atr, thx), where(sv, thy * atg, thy),
            where(sv, thz * atb, thz), pex, pey, pez)


def camera_ray_rows(cam, pxr, pyr, draws):
    """Thin-lens ray from the 24 camera-pack rows `cam` (a (24,) tensor
    or 24 rows), pixel coordinates pxr, pyr (float, row 0 at the top)
    and the camera draws (jx, jy, disc_x, disc_y, time_u). Returns
    (ox, oy, oz, dx, dy, dz, time)."""
    jx, jy, dcx, dcy, time_u = draws
    s = (pxr + jx) / cam[21]
    t = ((cam[23] - pyr) + jy) / cam[22]
    rdx = cam[18] * dcx
    rdy = cam[18] * dcy
    ox = cam[0] + cam[12] * rdx + cam[15] * rdy
    oy = cam[1] + cam[13] * rdx + cam[16] * rdy
    oz = cam[2] + cam[14] * rdx + cam[17] * rdy
    dx = cam[3] + cam[6] * s + cam[9] * t - ox
    dy = cam[4] + cam[7] * s + cam[10] * t - oy
    dz = cam[5] + cam[8] * s + cam[11] * t - oz
    tm = cam[19] + cam[20] * time_u
    return ox, oy, oz, dx, dy, dz, tm


# ---------------------------------------------------------------------------
# The bounce chain
# ---------------------------------------------------------------------------


def supports_backward(scene) -> bool:
    """The chain backward's scope: the tile kernel's (mk.scope_gap), which
    already leaves out the constant media rrt_tpu's excludes."""
    return mk.scope_gap(scene) is None


def count_mismatches(wrapper, mismatches):
    """Add a backward's replay-mismatch count (1,) int32 to
    `wrapper.replay_mismatches`, on the device and without a
    synchronize; a caller sets it to 0 before a run and reads it after:
    an autograd Function's backward has no other way to report it."""
    acc = wrapper.replay_mismatches
    wrapper.replay_mismatches = (
        acc + mismatches.to(acc.device) if torch.is_tensor(acc)
        else mismatches + acc)


def replay_steps(scene, o, d, time, keys, bounce0, n_steps: int, *,
                 max_depth, t_min):
    """Replay up to n_steps bounces of rays (o, d (3,N), time (N,), keys
    (2,N) u32 words in int64, bounce0 (N,) their bounce counters) under
    no_grad with the plain physics (render._bounce). Per bounce, a
    record of the rays still traced (`sel`: positions among the previous
    bounce's, `cur`: among the N) with their winners and decisions.
    Returns
    (records, bounces traced per ray, bounces scattered per ray)."""
    from ..render import _bounce  # render imports this package

    cur = torch.arange(o.shape[1], device=o.device)
    sel = cur
    n_seg = torch.zeros_like(cur)
    n_scattered = torch.zeros_like(cur)
    records = []
    for k in range(n_steps):
        b = _bounce(scene, o, d, time[cur], keys[:, cur], bounce0[cur] + k,
                    torch.ones_like(cur, dtype=torch.bool), t_min, max_depth)
        n_seg[cur] += 1
        n_scattered[cur] += b.survives.long()
        sc = b.scatter
        records.append(dict(
            sel=sel, cur=cur, win=b.win, t_hit=b.t, hit=b.hit_mask,
            miss=b.miss_mask, survives=b.survives, front=b.hit.front_face,
            degen=sc.degenerate, do_reflect=sc.reflected, use_c2=b.use_c2,
            draws=(*sc.unit_rand, *sc.sphere_rand, torch.zeros_like(b.t))))
        keep = b.survives.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        sel, cur = keep, cur[keep]
        o, d = b.new_o[:, keep], b.new_d[:, keep]
    return records, n_seg, n_scattered


def step_constants(record, sph24, bg8):
    """diff_step's replayed constants for one record of replay_steps."""
    mtype = sph24.detach()[8, record["win"]]
    return dict(record, is_sky=bg8.detach()[6] < 0.5,
                is_lam=mtype == MAT_LAMBERTIAN, is_met=mtype == MAT_METAL,
                is_die=mtype == MAT_DIELECTRIC)


def _check_chain_inputs(state, keys, sph24, bg8, d_out, out_bounce,
                        k_steps, moving):
    device = mk._check_spheres(sph24, bg8)
    check_backward_slots(sph24, moving)
    mk._check_lanes("state", state, mk.STATE_ROWS, torch.float32, device)
    mk._check_lanes("keys", keys, 2, torch.int32, device)
    mk._check_lanes("d_out", d_out, mk.STATE_ROWS, torch.float32, device)
    q = state.shape[1]
    if keys.shape[1] != q or d_out.shape[1] != q:
        raise ValueError(f"keys has {keys.shape[1]} lanes and d_out "
                         f"{d_out.shape[1]}, state {q}")
    if (out_bounce.dtype != torch.float32 or tuple(out_bounce.shape) != (q,)
            or out_bounce.device != device):
        raise ValueError(f"out_bounce must be a ({q},) float32 tensor on "
                         f"{device}")
    if not 1 <= k_steps <= MAX_RECORDS:
        raise ValueError(f"k_steps {k_steps}: the backward keeps at most "
                         f"{MAX_RECORDS} bounce records a lane")
    return device


def chain_adjoint(state, keys, sph24, bg8, d_out, out_bounce, *,
                  k_steps: int, max_depth: int, t_min: float,
                  moving: bool, bvh=None):
    """The backward of k_steps bounce steps (ops.megakernel.bounce_steps)
    of a lane state; moving: the moving-sphere variant.

    state: the chain's input state (16, Q) f32; keys (2, Q) int32 (the
    lanes' u32 words); sph24 (24, S), bg8 (8,): the packs; d_out (16, Q)
    f32: the output state's cotangent; out_bounce (Q,) f32: the forward
    output's bounce row; bvh: the sphere pack's accel.BvhPack that the
    forward walked, which the replay walks: required on a CUDA device,
    not read on the CPU. Returns (d_state (16, Q), rows 13-15 zero;
    d_sph24 (24, S), the grad_rows(moving) filled; d_bg8 (8,); replay
    mismatches (1,) int32: the lanes whose replayed bounce row differs
    from out_bounce).

    CUDA tensors launch chain_bwd (counted in `chain_adjoint.launches`);
    CPU tensors run chain_adjoint_reference. Either way the mismatches
    are added to `chain_adjoint.replay_mismatches` (count_mismatches)."""
    device = _check_chain_inputs(state, keys, sph24, bg8, d_out,
                                 out_bounce, k_steps, moving)
    kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
              moving=moving)
    if device.type == "cpu":
        out = chain_adjoint_reference(state, keys, sph24, bg8, d_out,
                                      out_bounce, **kw)
        count_mismatches(chain_adjoint, out[3])
        return out
    tree = mk._check_bvh(bvh, sph24, "chain_adjoint")
    lib = _build.load()
    q, n_slots = state.shape[1], sph24.shape[1]
    # Per-block partials of 256 lanes, SLOT_COLS floats a slot and 8 of
    # the background, and, below them, the first reduction's groups of
    # 64 blocks (csrc/chain.cu rrt_chain_bwd).
    n_blocks = -(-q // 256)
    n_cols = SLOT_COLS * n_slots + 8
    partials = torch.empty((n_blocks + -(-n_blocks // 64), n_cols),
                           dtype=torch.float32, device=device)
    sums = torch.empty((n_cols,), dtype=torch.float32, device=device)
    d_state = torch.empty_like(state)
    mismatches = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rrt_chain_bwd(
            state.data_ptr(), keys.data_ptr(), q, sph24.data_ptr(), n_slots,
            *tree, bg8.data_ptr(), d_out.data_ptr(), out_bounce.data_ptr(),
            k_steps, max_depth, t_min, int(moving), d_state.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), mismatches.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    mk._launch_error(lib, err, "chain_bwd")
    chain_adjoint.launches += 1
    count_mismatches(chain_adjoint, mismatches)
    # Row by row: an index list would be copied from the host, which a
    # CUDA graph capturing this wrapper does not allow.
    d_sph24 = torch.zeros_like(sph24)
    g = sums[:-8].view(n_slots, SLOT_COLS)
    for i, row in enumerate(grad_rows(moving)):
        d_sph24[row] = g[:, i]
    return d_state, d_sph24, sums[-8:].clone(), mismatches


chain_adjoint.launches = 0
chain_adjoint.replay_mismatches = 0


def chain_adjoint_reference(state, keys, sph24, bg8, d_out, out_bounce, *,
                            k_steps: int, max_depth: int, t_min: float,
                            moving: bool):
    """Plain version of chain_adjoint, same inputs and outputs.

    1. replay the live lanes' steps under no_grad with the port's plain
    physics (replay_steps); 2. rebuild every step with diff_step under
    autograd, from the winners' pack columns only; 3. take
    torch.autograd.grad of the sum of d_out . (each lane's state where
    its chain ends). Dead lanes pass d_out through."""
    dev = state.device
    st = state.detach()
    d_state = torch.zeros_like(st)
    d_state[:13] = d_out[:13]
    sph = sph24.detach().requires_grad_()
    bg = bg8.detach().requires_grad_()
    mismatches = torch.zeros((1,), dtype=torch.int32, device=dev)
    lanes = (st[mk.ROW_ALIVE] > 0.5).nonzero()[:, 0]
    if lanes.numel() == 0:
        return (d_state, torch.zeros_like(sph24), torch.zeros_like(bg8),
                mismatches)
    scene = mk._scene_from_packs(sph24.detach(), bg8.detach(), moving)
    bounce0 = st[mk.ROW_BOUNCE, lanes].long()
    with torch.no_grad():
        records, _, n_scattered = replay_steps(
            scene, st[0:3, lanes], st[3:6, lanes], st[mk.ROW_TIME, lanes],
            rng.from_u32_bits(keys[:, lanes]), bounce0, k_steps,
            max_depth=max_depth, t_min=t_min)
        mismatches += ((bounce0 + n_scattered).float()
                       != out_bounce[lanes]).sum().to(torch.int32)
    seed = d_out[:13, lanes]
    with torch.enable_grad():
        rows_in = tuple(st[r, lanes].clone().requires_grad_()
                        for r in range(13))
        rows, total = rows_in, 0.0
        for i, r in enumerate(records):
            rows = tuple(x[r["sel"]] for x in rows)
            rows = diff_step(step_constants(r, sph24, bg8), *rows,
                             sph[:, r["win"]], *bg[:6], moving=moving)
            # A lane's chain ends at its last step, or where it stops.
            ends = (torch.ones_like(r["survives"]) if i + 1 == len(records)
                    else ~r["survives"])
            total = total + (seed[:, r["cur"]] * ends
                             * torch.stack(rows)).sum()
        grads = torch.autograd.grad(total, (*rows_in, sph, bg),
                                    allow_unused=True)
    zero = torch.zeros_like(lanes, dtype=torch.float32)
    d_state[:13, lanes] = torch.stack(
        [zero if g is None else g for g in grads[:13]])
    d_sph, d_bg = (torch.zeros_like(x) if g is None else g
                   for x, g in zip((sph24, bg8), grads[13:]))
    return d_state, d_sph, d_bg, mismatches


class BounceChain(torch.autograd.Function):
    """K bounce steps of a lane state as a differentiable function of
    the state and the packs: apply(state (16,Q), keys (2,Q) int32,
    sph24, bg8, k_steps, max_depth, t_min, moving, bvh) -> state' (16,Q),
    bvh the sphere pack's accel.BvhPack (required on a CUDA device).
    Forward: one bounce_steps launch on a copy of the state
    (bounce_steps updates in place, and the input is the backward's
    residual); backward: one chain_adjoint on the same BVH, seeded with
    zeros where the output has no cotangent (autograd materialises
    them). The keys carry no gradient."""

    @staticmethod
    def forward(ctx, state, keys, sph24, bg8, k_steps, max_depth, t_min,
                moving, bvh):
        kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
                  moving=moving, bvh=bvh)
        out = mk.bounce_steps(state.clone(), keys, sph24, bg8, **kw)
        ctx.save_for_backward(state, keys, sph24, bg8,
                              out[mk.ROW_BOUNCE].clone())
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, d_out):
        state, keys, sph24, bg8, out_bounce = ctx.saved_tensors
        d_state, d_sph, d_bg, _ = chain_adjoint(
            state, keys, sph24, bg8, d_out.contiguous(), out_bounce,
            **ctx.kw)
        return d_state, None, d_sph, d_bg, None, None, None, None, None


def bounce_chain(k_steps: int, max_depth: int, t_min: float,
                 moving: bool):
    """chain(state, keys, sph24, bg8, bvh=None) -> state': BounceChain
    with its step count and options bound, as rrt_tpu's bounce_chain
    returns; bvh: the sphere pack's accel.BvhPack, which both kernels
    walk (required on a CUDA device)."""
    def chain(state, keys, sph24, bg8, bvh=None):
        return BounceChain.apply(state, keys, sph24, bg8, k_steps,
                                 max_depth, t_min, moving, bvh)
    return chain
