"""The differentiable bounce and the bounce chain's backward.

`diff_step` is the counterpart of rrt_tpu's
`ops/megakernel_vjp.py::_make_diff_step` for spheres, quads, boxes,
lights, constant media and the perlin and image textures: one bounce
as a function of the 13 state rows (origin, direction, time,
throughput, pending radiance), the
winner's 24 sphere-pack rows (with moving spheres, the winner's center
at the ray's time, so the velocity rows and the time get gradients
too), its quad, box and medium rows (rrt_tpu's layouts), the 6
background rows and the texture atlas, with every discrete decision
(root, box face, front face, checker parity, which texture and which
texel, degenerate lambertian, reflect-vs-refract, which medium and
whether it scatters, hit / miss / light / survival, Russian roulette's
kill) and every random draw supplied as a replayed constant, Russian
roulette's weight 1 / p detached. It is
the math the CUDA backwards transpose by hand (csrc/adjoint.cuh, shared
by train.cu and chain.cu), and the body of their plain versions
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
            the K steps from the input state, walking the forward's BVH
            (and, past SOLID_CAP quads or boxes, its solid trees), and
            sweeps them in reverse through the hand-written transpose of
            diff_step. Its plain version is
            `chain_adjoint_reference`, which CPU tensors run.
"""

import dataclasses

import torch

from .. import rng, textures
from . import _build
from . import megakernel as mk
from ..geometry import (FAM_BOX, FAM_MEDIUM, FAM_QUAD, FAM_SPHERE, INF,
                        quad_frame_vjp)
from ..scene import (MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC,
                     MAT_LAMBERTIAN, MAT_METAL, TEX_IMAGE, TEX_PERLIN)

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
# and sums (csrc/adjoint.cuh kSlotCols): grad_rows(moving), then zeros,
# but for the last: TEX_SCALE_COL holds a sphere's, quad's or box's
# texture scale (a marble's; a checker's keeps gradient 0), pack rows
# 17, 19 and 18 (csrc/adjoint.cuh kAccTexScale).
SLOT_COLS = 16
TEX_SCALE_COL = 15
SPHERE_TEX_SCALE_ROW, QUAD_TEX_SCALE_ROW, BOX_TEX_SCALE_ROW = 17, 19, 18


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


# The quad and box cotangents the CUDA backwards accumulate, kSlotCols
# floats a slot as the spheres' (csrc/adjoint.cuh): a quad's frame n xyz
# and d_plane (geometry.quad_frame_vjp takes them to q, u, v), then, as
# for a sphere, aux at 4, color1 at 5-7, color2 at 8-10; a box's pack
# rows in the order of its columns: center 0-2, cos, aux, color1,
# color2, sin, half 3-5.
QUAD_MAT_ROWS = (11, 12, 13, 14, 15, 16, 17)  # quad pack rows, cols 4-10
BOX_GRAD_ROWS = (0, 1, 2, 6, 10, 11, 12, 13, 14, 15, 16, 7, 3, 4, 5)
# The medium-pack columns a medium's cotangent fills, rrt_tpu's MED_COLS
# (ops/megakernel_train.py): center 1-3, radius 4, half 5-7, -1/density
# 17, albedo 19-21; the CUDA backwards keep them in this order in a
# medium's kSlotCols floats (csrc/adjoint.cuh medium_adjoint).
MED_COLS = (1, 2, 3, 4, 5, 6, 7, 17, 19, 20, 21)


def diff_step(c, *ins, moving, has_quads=False, has_boxes=False,
              has_media=False, has_perlin=False, has_images=False,
              rr_depth=0, t_min=1e-3):
    """One bounce, differentiable in `ins`: 13 state rows (ox, oy, oz,
    dx, dy, dz, time, thx, thy, thz, pex, pey, pez), sel_s (24, N) (the
    winner's sphere-pack column per ray), with has_quads sel_q (24, N)
    (its quad column in rrt_tpu's layout: ops.megakernel.quad_frame_pack),
    with has_boxes sel_b (24, N) (its box-pack column), with has_media
    sel_m (24, N) (its medium-pack row, transposed), then 6 background
    rows (bottom rgb, top rgb), then with has_images the atlas (T, 4)
    (ops.megakernel.pack_atlas). Returns the 13 state rows after the
    bounce.

    c: the replayed constants, (N,) bool tensors t_hit (float), hit,
    miss, survives, front, degen, do_reflect, use_c2, is_lam, is_met,
    is_die, and with quads or boxes use_q, use_b (the winner's family)
    and is_light (a diffuse_light: the bounce adds throughput x its color
    to the pending radiance and ends the path); is_sky (0-d bool); draws,
    the 7 rows (unit xyz, sphere xyz, choice) of the bounce's scatter
    draws. moving: the winner's center is sel_s rows 0-2 + time * rows
    4-6, in the quadratic and the normal. A box's face and a quad's side
    are replayed: the face is the candidate nearest t_hit, its axis and
    sign detached. With media, use_med (a medium won) and med_logu (the
    log of its clamped STREAM_MEDIUM uniform): a medium's t is te +
    (-1/density) log(u) / |d|, te its boundary's entry t clamped to
    t_min and 0 (rrt_tpu's rule: the boundary type, the rotation, which
    slab and whether it scatters are replayed), its normal the constant
    (1, 0, 0), its albedo its pack's columns 19-21, its new direction the
    in-sphere draw. With has_perlin, is_per (the winner's texture is a
    marble: its albedo is textures.marble(scale, p) x color1, p the hit
    point, so the texture scale, color1 and through p the hit's t get
    gradients); with has_images, is_img and texel (the texel the winner's
    uv reads, a replayed constant: its albedo is the atlas row, which
    gets the gradient, and nothing flows to uv). With rr_depth, rr_on
    (Russian roulette acts at this bounce: its bounce >= rr_depth; its
    kill is in survives): a surviving throughput is tn / p, tn = thr *
    att and p = clip(max(tn), 0.05, 1) detached, in rrt_tpu's op order
    (render._apply_rr)."""
    (ox, oy, oz, dx, dy, dz, time, thx, thy, thz,
     pex, pey, pez) = ins[:13]
    sel_s = ins[13]
    i = 14
    if has_quads:
        sel_q = ins[i]
        i += 1
    if has_boxes:
        sel_b = ins[i]
        i += 1
    if has_media:
        sel_m = ins[i]
        i += 1
    bg6 = ins[i:i + 6]
    atlas = ins[i + 6] if has_images else None
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

    # --- a box winner's t: the face nearest the stored t (its axis and
    # side replayed) of the slab test in the box's frame, in the kernels'
    # arithmetic (bounce.cuh slab: -ob/db -+ h/|db|), so that the rebuilt
    # hit point is theirs and not a rounding away: a path's later hits
    # amplify it (rttnw_final's marble, 1/64 of a unit a last octave).
    if has_boxes:
        cthb, sthb = sel_b[6], sel_b[7]
        bwx, bwy, bwz = ox - sel_b[0], oy - sel_b[1], oz - sel_b[2]
        faces = ((cthb * bwx - sthb * bwz, cthb * dx - sthb * dz, sel_b[3]),
                 (bwy, dy, sel_b[4]),
                 (sthb * bwx + cthb * bwz, sthb * dx + cthb * dz, sel_b[5]))
        t_box = torch.zeros_like(t_hit)
        best = torch.full_like(t_hit, INF)
        for ob, db, hk in faces:
            ok_db = db.abs() > 1e-12
            inv_db = 1.0 / where(ok_db, db, 1.0)
            a_t = ob * inv_db
            b_t = hk * inv_db.abs()
            for t_f in (-a_t - b_t, b_t - a_t):
                err = where(ok_db, (t_f - c["t_hit"]).abs(), INF).detach()
                take = err < best
                best = where(take, err, best)
                t_box = where(take, t_f, t_box)
        t_hit = where(c["use_b"], t_box, t_hit)
    # --- a quad winner's t: its plane's, (d_plane - n.o) / (n.d).
    if has_quads:
        nqx, nqy, nqz = sel_q[0], sel_q[1], sel_q[2]
        denom = dx * nqx + dy * nqy + dz * nqz
        o_n = ox * nqx + oy * nqy + oz * nqz
        not_par = (denom.abs() > sel_q[12] * d_len).detach()
        t_quad = (sel_q[9] - o_n) / where(not_par, denom, 1.0)
        t_hit = where(c["use_q"], t_quad, t_hit)
    # --- a medium winner's t: its boundary's entry t, clamped, plus the
    # sampled distance.
    if has_media:
        t_hit = where(c["use_med"], _medium_t(
            sel_m, ox, oy, oz, dx, dy, dz, a, inv_a, d_len, t_min,
            c["med_logu"]), t_hit)

    t_eff = where(c["hit"], t_hit, 0.0)
    px_ = ox + t_eff * dx
    py_ = oy + t_eff * dy
    pz_ = oz + t_eff * dz

    # --- the winner's outward normal (a negative radius flips a sphere's
    # inward) and material rows.
    srad = sel_s[18]
    inv_r = 1.0 / where(srad.abs() > 1e-20, srad, 1.0)
    outx, outy, outz = (px_ - cx) * inv_r, (py_ - cy) * inv_r, \
        (pz_ - cz) * inv_r
    aux_v = sel_s[9]
    c1 = (sel_s[10], sel_s[11], sel_s[12])
    c2 = (sel_s[13], sel_s[14], sel_s[15])
    texscale = sel_s[17]
    if has_boxes:
        # The axis whose |q_k| - h_k is largest at the hit point, and its
        # sign, are discrete; the rotation rows carry the gradient.
        bpx, bpy, bpz = px_ - sel_b[0], py_ - sel_b[1], pz_ - sel_b[2]
        bqx = cthb * bpx - sthb * bpz
        bqz = sthb * bpx + cthb * bpz
        fxb = bqx.abs() - sel_b[3]
        fyb = bpy.abs() - sel_b[4]
        fzb = bqz.abs() - sel_b[5]
        use_x = ((fxb >= fyb) & (fxb >= fzb)).detach()
        use_y = (~use_x & (fyb >= fzb)).detach()
        nbx = where(use_x, where(bqx >= 0.0, 1.0, -1.0), 0.0).detach()
        nby = where(use_y, where(bpy >= 0.0, 1.0, -1.0), 0.0).detach()
        nbz = where(use_x | use_y, 0.0,
                    where(bqz >= 0.0, 1.0, -1.0)).detach()
        ub = c["use_b"]
        outx = where(ub, cthb * nbx + sthb * nbz, outx)
        outy = where(ub, nby, outy)
        outz = where(ub, -sthb * nbx + cthb * nbz, outz)
        aux_v = where(ub, sel_b[10], aux_v)
        c1 = tuple(where(ub, sel_b[11 + j], c1[j]) for j in range(3))
        c2 = tuple(where(ub, sel_b[14 + j], c2[j]) for j in range(3))
        texscale = where(ub, sel_b[18], texscale)
    if has_quads:
        nn = nqx * nqx + nqy * nqy + nqz * nqz
        qinv = torch.rsqrt(where(nn > 1e-20, nn, 1.0))
        uq = c["use_q"]
        outx = where(uq, nqx * qinv, outx)
        outy = where(uq, nqy * qinv, outy)
        outz = where(uq, nqz * qinv, outz)
        aux_v = where(uq, sel_q[15], aux_v)
        c1 = tuple(where(uq, sel_q[16 + j], c1[j]) for j in range(3))
        c2 = tuple(where(uq, sel_q[19 + j], c2[j]) for j in range(3))
        texscale = where(uq, sel_q[23], texscale)
    sgn = where(c["front"], 1.0, -1.0)
    nx_, ny_, nz_ = outx * sgn, outy * sgn, outz * sgn
    if has_media:  # a medium's normal: a constant (isotropic ignores it)
        um = c["use_med"]
        nx_, ny_, nz_ = where(um, 1.0, nx_), where(um, 0.0, ny_), \
            where(um, 0.0, nz_)

    # --- albedo (checker parity, texture type and texel replayed).
    alb = tuple(where(c["use_c2"], c2[j], c1[j]) for j in range(3))
    if has_perlin:
        m = textures.marble(texscale, torch.stack([px_, py_, pz_]))
        alb = tuple(where(c["is_per"], m * c1[j], alb[j]) for j in range(3))
    if has_images:
        img = atlas[c["texel"]]
        alb = tuple(where(c["is_img"], img[:, j], alb[j]) for j in range(3))
    albr, albg, albb = alb
    if has_media:
        albr, albg, albb = (where(um, sel_m[19 + j], alb)
                            for j, alb in enumerate((albr, albg, albb)))

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

    # --- the miss's background, and a light's emission (on either side).
    inv_dl2 = torch.rsqrt(torch.clamp(a, min=1e-20))
    tsky = 0.5 * (dy * inv_dl2 + 1.0)
    is_sky = c["is_sky"]
    bgr = where(is_sky, (1.0 - tsky) * bg6[0] + tsky * bg6[3], bg6[0])
    bgg = where(is_sky, (1.0 - tsky) * bg6[1] + tsky * bg6[4], bg6[1])
    bgb = where(is_sky, (1.0 - tsky) * bg6[2] + tsky * bg6[5], bg6[2])
    missf = c["miss"].to(torch.float32)
    if "is_light" in c:
        lightf = (c["hit"] & c["is_light"]).to(torch.float32)
        pex = pex + thx * (bgr * missf + albr * lightf)
        pey = pey + thy * (bgg * missf + albg * lightf)
        pez = pez + thz * (bgb * missf + albb * lightf)
    else:
        pex = pex + thx * (bgr * missf)
        pey = pey + thy * (bgg * missf)
        pez = pez + thz * (bgb * missf)

    sv = c["survives"]
    tnx, tny, tnz = thx * atr, thy * atg, thz * atb
    if rr_depth:
        p_rr = torch.clamp(torch.maximum(tnx, torch.maximum(tny, tnz)),
                           0.05, 1.0).detach()
        inv_p = where(c["rr_on"], 1.0 / p_rr, 1.0)
        tnx, tny, tnz = tnx * inv_p, tny * inv_p, tnz * inv_p
    return (where(sv, px_, ox), where(sv, py_, oy), where(sv, pz_, oz),
            where(sv, ndx, dx), where(sv, ndy, dy), where(sv, ndz, dz),
            time, where(sv, tnx, thx), where(sv, tny, thy),
            where(sv, tnz, thz), pex, pey, pez)


def _medium_t(sel_m, ox, oy, oz, dx, dy, dz, a, inv_a, d_len, t_min,
              logu):
    """diff_step's medium t (rrt_tpu's medium branch of _make_diff_step)
    from the winner's medium-pack rows sel_m (24, N): the boundary's
    entry t (a sphere's near root; an oriented box's slab entry, the
    rotation detached), clamped to t_min and 0, plus (-1/density) logu /
    |d|. Square roots and reciprocals are double-guarded."""
    where = torch.where
    ocx, ocy, ocz = ox - sel_m[1], oy - sel_m[2], oz - sel_m[3]
    hb = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - sel_m[4] * sel_m[4]
    disc = hb * hb - a * cc
    dok = (disc > 0.0).detach()
    sq = torch.sqrt(where(dok, disc, 1.0))
    sph_enter = (-hb - sq) * inv_a
    rot = sel_m[8:17].detach()
    lo = torch.full_like(a, -INF)
    for k in range(3):
        ob = rot[k] * ocx + rot[3 + k] * ocy + rot[6 + k] * ocz
        db = rot[k] * dx + rot[3 + k] * dy + rot[6 + k] * dz
        hk = sel_m[5 + k]
        par = (db.abs() <= 1e-12).detach()
        inv_db = 1.0 / where(par, 1.0, db)
        klo = torch.minimum((-hk - ob) * inv_db, (hk - ob) * inv_db)
        inside = (ob.abs() <= hk).detach()
        lo = torch.maximum(lo, where(par, where(inside, -INF, INF), klo))
    t_enter = where((sel_m[0] < 0.5).detach(), sph_enter, lo)
    te = torch.maximum(torch.maximum(t_enter, torch.full_like(a, t_min)),
                       torch.zeros_like(a))
    return te + sel_m[17] * logu * (1.0 / torch.clamp(d_len, min=1e-20))


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


# Why chain_bwd leaves out the constant media, as rrt_tpu's does: a
# medium's sampled interval couples the closest solid's t into the
# decision, and rrt_tpu's scan, its route there, is the CPU's here.
CHAIN_MEDIA = ("constant media (rrt_tpu's chain leaves them out too; "
               "render_image_diff and make_train_step run their gradient "
               "on the train kernels)")


def backward_scope_gap(scene):
    """chain_bwd's scope (rrt_tpu's supports_backward): None when it
    covers the scene, otherwise (what is outside, the ROADMAP Queue A
    item). The forward kernels' (mk.scope_gap), any number of quads and
    boxes among them (past mk.SOLID_CAP its replay walks their trees, as
    bounce_steps does), but the constant media, which it leaves out by
    decision (#9.4; the train kernels take them:
    megakernel_train.train_scope_gap). Russian roulette is in scope."""
    gap = mk.scope_gap(scene)
    if gap is None and scene.has_media:
        return CHAIN_MEDIA, "#9.4"
    return gap


def check_backward_scope(where: str, scene):
    """Raise NotImplementedError naming the ROADMAP item for a scene
    outside backward_scope_gap's scope."""
    gap = backward_scope_gap(scene)
    if gap is not None:
        raise NotImplementedError(
            f"{where}: {gap[0]} is outside chain_bwd's scope "
            f"({mk.roadmap_ref(gap[1])})")


def supports_backward(scene) -> bool:
    """Whether the chain backward covers the scene (backward_scope_gap),
    which leaves out the constant media rrt_tpu's excludes."""
    return backward_scope_gap(scene) is None


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
                 max_depth, t_min, thr=None, rr_depth: int = 0):
    """Replay up to n_steps bounces of rays (o, d (3,N), time (N,), keys
    (2,N) u32 words in int64, bounce0 (N,) their bounce counters, thr
    (3,N) their throughputs, ones when None, which Russian roulette from
    bounce rr_depth on weighs (0: off, thr unread)) under no_grad with
    the plain physics (render._bounce, render._apply_rr). Per bounce, a
    record of
    the rays still traced (`sel`: positions among the previous bounce's,
    `cur`: among the N) with their winners and decisions (with rr_depth,
    rr_on: the roulette acts there; survives holds its kill). Returns
    (records, bounces traced per ray, bounces scattered per ray)."""
    from ..render import _apply_rr, _bounce  # render imports this package

    cur = torch.arange(o.shape[1], device=o.device)
    sel = cur
    n_seg = torch.zeros_like(cur)
    n_scattered = torch.zeros_like(cur)
    if rr_depth and thr is None:
        thr = torch.ones_like(o)
    records = []
    for k in range(n_steps):
        bounce, k_cur = bounce0[cur] + k, keys[:, cur]
        b = _bounce(scene, o, d, time[cur], k_cur, bounce,
                    torch.ones_like(cur, dtype=torch.bool), t_min, max_depth)
        survives = b.survives
        if rr_depth:  # the throughput matters only to the roulette
            thr, survives = _apply_rr(k_cur, bounce, thr,
                                      b.scatter.attenuation, survives,
                                      rr_depth)
        n_seg[cur] += 1
        n_scattered[cur] += survives.long()
        sc = b.scatter
        records.append(dict(
            sel=sel, cur=cur, win=b.win, fam=b.fam, t_hit=b.t,
            hit=b.hit_mask, miss=b.miss_mask, survives=survives,
            front=b.hit.front_face, degen=sc.degenerate,
            do_reflect=sc.reflected, use_c2=b.use_c2,
            draws=(*sc.unit_rand, *sc.sphere_rand, torch.zeros_like(b.t)),
            med_logu=_winner_logu(b),
            texel=(torch.zeros_like(b.win) if b.texel is None
                   else b.texel)))
        if rr_depth:
            records[-1]["rr_on"] = bounce >= rr_depth
        keep = survives.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        sel, cur = keep, cur[keep]
        o, d = b.new_o[:, keep], b.new_d[:, keep]
        if rr_depth:
            thr = thr[:, keep]
    return records, n_seg, n_scattered


def _winner_logu(b):
    """log(max(u, 1e-12)) of the STREAM_MEDIUM uniform of each ray's
    winning medium in a render.Bounce (0 where no medium won, or the
    scene has none): diff_step's med_logu."""
    if b.u_med is None:
        return torch.zeros_like(b.t)
    use = b.fam == FAM_MEDIUM
    u = b.u_med.gather(0, torch.where(use, b.win, 0)[None])[0]
    return torch.where(use, torch.log(torch.clamp(u, min=1e-12)), 0.0)


def step_constants(record, sph24, bg8, solids=None):
    """diff_step's replayed constants for one record of replay_steps;
    solids: the replayed scene's SolidPacks (the quads' and boxes'
    material and texture types, a medium's isotropic one and solid
    albedo, and the use_q, use_b, use_med and is_light constants). The
    winner's texture type gives is_per and is_img."""
    fam, win = record["fam"], record["win"]
    col = sph24.detach()[:, torch.where(fam == FAM_SPHERE, win, 0)]
    mtype, ttype = col[8], col[16]
    c = dict(record, is_sky=bg8.detach()[6] < 0.5)
    if solids is not None:
        for f, pack, n, row in ((FAM_QUAD, solids.quad24, solids.n_quads,
                                 10),
                                (FAM_BOX, solids.box24, solids.n_boxes, 9)):
            if n:
                use = fam == f
                sel = pack.detach()[:, torch.where(use, win, 0)]
                mtype = torch.where(use, sel[row], mtype)
                ttype = torch.where(use, sel[row + 8], ttype)
        use_med = fam == FAM_MEDIUM
        mtype = torch.where(use_med, float(MAT_ISOTROPIC), mtype)
        ttype = torch.where(use_med, 0.0, ttype)
        c.update(use_q=fam == FAM_QUAD, use_b=fam == FAM_BOX, use_med=use_med,
                 is_light=mtype == MAT_DIFFUSE_LIGHT)
    c.update(is_lam=mtype == MAT_LAMBERTIAN, is_met=mtype == MAT_METAL,
             is_die=mtype == MAT_DIELECTRIC, is_per=ttype == TEX_PERLIN,
             is_img=ttype == TEX_IMAGE)
    return c


def winner_rows(record, sph, quads=None, boxes=None, media=None, tex=None):
    """diff_step's winner inputs for a record of replay_steps: (sel_s,
    [sel_q], [sel_b], [sel_m]) from the sphere pack sph (24, S), the
    active quads' frame pack quads (mk.quad_frame_pack, (24, nq); None
    without quads), the active boxes' pack boxes ((24, nb); None without)
    and the active media's pack media ((nm, 24); None without), each a
    column a ray; and diff_step's has_quads, has_boxes, has_media, and
    has_perlin and has_images from the scene's TexPack tex (or None)."""
    fam, win = record["fam"], record["win"]
    sel = [sph[:, torch.where(fam == FAM_SPHERE, win, 0)]]
    for f, pack in ((FAM_QUAD, quads), (FAM_BOX, boxes)):
        if pack is not None:
            sel.append(pack[:, torch.where(fam == f, win, 0)])
    if media is not None:
        sel.append(media[torch.where(fam == FAM_MEDIUM, win, 0)].T)
    return sel, dict(has_quads=quads is not None, has_boxes=boxes is not None,
                     has_media=media is not None,
                     has_perlin=tex is not None and tex.has_perlin,
                     has_images=tex is not None and tex.has_images)


def atlas_leaf(tex):
    """A gradient leaf of the atlas of a TexPack with images (a detached
    copy), None otherwise; diff_step's has_images input."""
    if tex is None or not tex.has_images:
        return None
    return tex.atlas.detach().clone().requires_grad_()


def solid_leaves(solids):
    """Gradient leaves of the active quads', boxes' and media's packs
    (detached copies of solids' first n_quads, n_boxes and n_media
    slots), None for a family without active slots. Returns (quad leaf,
    box leaf, medium leaf)."""
    if solids is None:
        return None, None, None
    q = (solids.quad24.detach()[:, :solids.n_quads].clone()
         .requires_grad_() if solids.n_quads else None)
    b = (solids.box24.detach()[:, :solids.n_boxes].clone()
         .requires_grad_() if solids.n_boxes else None)
    m = (solids.med24.detach()[:solids.n_media].clone().requires_grad_()
         if solids.n_media else None)
    return q, b, m


def solid_grads(solids, g_quad, g_box, g_med=None):
    """The SolidPacks of the pack cotangents: solids' shapes, g_quad,
    g_box and g_med (the active slots' cotangents, or None) in the first
    slots."""
    d_quad = torch.zeros_like(solids.quad24)
    d_box = torch.zeros_like(solids.box24)
    d_med = None if solids.med24 is None else torch.zeros_like(solids.med24)
    if g_quad is not None:
        d_quad[:, :solids.n_quads] = g_quad
    if g_box is not None:
        d_box[:, :solids.n_boxes] = g_box
    if g_med is not None:
        d_med[:solids.n_media] = g_med
    return mk.SolidPacks(d_quad, d_box, solids.n_quads, solids.n_boxes,
                         solids.n_media, d_med)


def kernel_solid_grads(g, solids):
    """The SolidPacks of the pack cotangents from a CUDA backward's sums
    of the solid slots, g ((n_quads + n_boxes + n_media, SLOT_COLS): the
    quads', the boxes', then the media's columns, csrc/adjoint.cuh): the
    quads' frame cotangents taken to q, u, v (geometry.quad_frame_vjp),
    the material and box rows put back in their pack rows, and the
    media's MED_COLS in theirs, row by row (an index list would be
    copied from the host, which a CUDA graph capturing the wrapper does
    not allow)."""
    nq, nb, nm = solids.n_quads, solids.n_boxes, solids.n_media
    d_quad = torch.zeros_like(solids.quad24)
    d_box = torch.zeros_like(solids.box24)
    d_med = None if solids.med24 is None else torch.zeros_like(solids.med24)
    gq, gb, gm = g[:nq], g[nq:nq + nb], g[nq + nb:nq + nb + nm]
    quad = solids.quad24[:, :nq]
    parts = quad_frame_vjp(quad[0:3], quad[3:6], quad[6:9], gq[:, 0:3].T,
                           gq[:, 3])
    for j, part in enumerate(parts):
        d_quad[3 * j:3 * j + 3, :nq] = part
    for i, row in enumerate(QUAD_MAT_ROWS):
        d_quad[row, :nq] = gq[:, 4 + i]
    for i, row in enumerate(BOX_GRAD_ROWS):
        d_box[row, :nb] = gb[:, i]
    for i, col in enumerate(MED_COLS if nm else ()):
        d_med[:nm, col] = gm[:, i]
    d_quad[QUAD_TEX_SCALE_ROW, :nq] = gq[:, TEX_SCALE_COL]
    d_box[BOX_TEX_SCALE_ROW, :nb] = gb[:, TEX_SCALE_COL]
    return mk.SolidPacks(d_quad, d_box, nq, nb, nm, d_med)


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
                  moving: bool, bvh=None, solids=None, tex=None,
                  rr_depth: int = 0):
    """The backward of k_steps bounce steps (ops.megakernel.bounce_steps)
    of a lane state; moving: the moving-sphere variant; solids: the
    scene's SolidPacks (quads, boxes, lights: the solid-family variant)
    or None; tex: the scene's TexPack (the texture variant) or None;
    rr_depth: the forward's Russian roulette (0: off), its coin redrawn
    at each lane's bounce row plus the step, its 1 / p detached.

    state: the chain's input state (16, Q) f32; keys (2, Q) int32 (the
    lanes' u32 words); sph24 (24, S), bg8 (8,): the packs; d_out (16, Q)
    f32: the output state's cotangent; out_bounce (Q,) f32: the forward
    output's bounce row; bvh: the sphere pack's accel.BvhPack that the
    forward walked, which the replay walks: required on a CUDA device,
    not read on the CPU. A solid family past mk.SOLID_CAP active slots
    is walked over solids.tree, as bounce_steps walks it (the kernel's
    kWalk instantiation; required on a CUDA device, where what the block
    stages must fit its shared memory: mk._check_forward_smem); on the
    CPU the plain version scans every slot, which gives the walk's
    winners. Returns (d_state (16, Q), rows 13-15 zero;
    d_sph24 (24, S), the grad_rows(moving) filled; d_bg8 (8,); replay
    mismatches (1,) int32: the lanes whose replayed bounce row differs
    from out_bounce; d_solids: the SolidPacks of the quad and box packs'
    cotangents, None without solids; d_atlas (T, 4): the atlas's
    cotangent, the sum of the albedo cotangents of the bounces that read
    each texel (float atomics on the card, so it repeats within a
    spread), None without images). A marble's texture scale gets its
    gradient in its pack row (17 of a sphere's, 19 of a quad's, 18 of a
    box's).

    CUDA tensors launch chain_bwd (counted in `chain_adjoint.launches`);
    CPU tensors run chain_adjoint_reference. Either way the mismatches
    are added to `chain_adjoint.replay_mismatches` (count_mismatches)."""
    device = _check_chain_inputs(state, keys, sph24, bg8, d_out,
                                 out_bounce, k_steps, moving)
    if solids is not None and solids.n_media:
        raise NotImplementedError(f"chain_adjoint: {CHAIN_MEDIA} are outside "
                                  f"chain_bwd's scope (ROADMAP Queue A #9.4)")
    if rr_depth < 0:
        raise ValueError(f"rr_depth {rr_depth} < 0")
    solid_arg = mk._check_solids(solids, device, "walk")
    kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
              moving=moving, solids=solids, tex=tex, rr_depth=rr_depth)
    if device.type == "cpu":
        mk._check_tex(tex, device)
        out = chain_adjoint_reference(state, keys, sph24, bg8, d_out,
                                      out_bounce, **kw)
        count_mismatches(chain_adjoint, out[3])
        return out
    d_atlas = (torch.zeros_like(tex.atlas)
               if tex is not None and tex.has_images else None)
    tex_arg = mk._check_tex(tex, device, d_atlas)
    tree = mk._check_bvh(bvh, sph24, "chain_adjoint")
    mk._check_forward_smem(bvh, solids, moving, "chain_adjoint")
    lib = _build.load()
    q, n_slots = state.shape[1], sph24.shape[1]
    n_solid = 0 if solids is None else solids.n_quads + solids.n_boxes
    # Per-block partials of 256 lanes, SLOT_COLS floats a slot (the
    # spheres', then the active quads' and boxes') and 8 of the
    # background, and, below them, the first reduction's groups of 64
    # blocks (csrc/chain.cu rrt_chain_bwd).
    n_blocks = -(-q // 256)
    n_cols = SLOT_COLS * (n_slots + n_solid) + 8
    partials = torch.empty((n_blocks + -(-n_blocks // 64), n_cols),
                           dtype=torch.float32, device=device)
    sums = torch.empty((n_cols,), dtype=torch.float32, device=device)
    d_state = torch.empty_like(state)
    mismatches = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.rrt_chain_bwd(
            state.data_ptr(), keys.data_ptr(), q, sph24.data_ptr(), n_slots,
            *tree, solid_arg, tex_arg, bg8.data_ptr(), d_out.data_ptr(),
            out_bounce.data_ptr(), k_steps, max_depth, rr_depth, t_min,
            int(moving), d_state.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), mismatches.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    mk._launch_error(lib, err, "chain_bwd")
    chain_adjoint.launches += 1
    count_mismatches(chain_adjoint, mismatches)
    # Row by row: an index list would be copied from the host, which a
    # CUDA graph capturing this wrapper does not allow.
    d_sph24 = torch.zeros_like(sph24)
    g = sums[:-8].view(n_slots + n_solid, SLOT_COLS)
    for i, row in enumerate(grad_rows(moving)):
        d_sph24[row] = g[:n_slots, i]
    d_sph24[SPHERE_TEX_SCALE_ROW] = g[:n_slots, TEX_SCALE_COL]
    d_solids = (None if solids is None
                else kernel_solid_grads(g[n_slots:], solids))
    return (d_state, d_sph24, sums[-8:].clone(), mismatches, d_solids,
            d_atlas)


chain_adjoint.launches = 0
chain_adjoint.replay_mismatches = 0


def chain_adjoint_reference(state, keys, sph24, bg8, d_out, out_bounce, *,
                            k_steps: int, max_depth: int, t_min: float,
                            moving: bool, solids=None, tex=None,
                            rr_depth: int = 0):
    """Plain version of chain_adjoint, same inputs and outputs.

    1. replay the live lanes' steps under no_grad with the port's plain
    physics (replay_steps); 2. rebuild every step with diff_step under
    autograd, from the winners' pack columns only (the quads' through
    mk.quad_frame_pack, so their cotangents reach q, u and v); 3. take
    torch.autograd.grad of the sum of d_out . (each lane's state where
    its chain ends). Dead lanes pass d_out through."""
    dev = state.device
    st = state.detach()
    d_state = torch.zeros_like(st)
    d_state[:13] = d_out[:13]
    sph = sph24.detach().requires_grad_()
    bg = bg8.detach().requires_grad_()
    quads, boxes, _ = solid_leaves(solids)
    atlas = atlas_leaf(tex)
    mismatches = torch.zeros((1,), dtype=torch.int32, device=dev)
    lanes = (st[mk.ROW_ALIVE] > 0.5).nonzero()[:, 0]
    no_solids = None if solids is None else solid_grads(solids, None, None)
    if lanes.numel() == 0:
        return (d_state, torch.zeros_like(sph24), torch.zeros_like(bg8),
                mismatches, no_solids,
                None if atlas is None else torch.zeros_like(atlas))
    scene = mk._scene_from_packs(sph24.detach(), bg8.detach(), moving,
                                 solids, tex)
    bounce0 = st[mk.ROW_BOUNCE, lanes].long()
    with torch.no_grad():
        records, _, n_scattered = replay_steps(
            scene, st[0:3, lanes], st[3:6, lanes], st[mk.ROW_TIME, lanes],
            rng.from_u32_bits(keys[:, lanes]), bounce0, k_steps,
            max_depth=max_depth, t_min=t_min, thr=st[7:10, lanes],
            rr_depth=rr_depth)
        mismatches += ((bounce0 + n_scattered).float()
                       != out_bounce[lanes]).sum().to(torch.int32)
    seed = d_out[:13, lanes]
    leaves = {k: x for k, x in (("sph", sph), ("bg", bg), ("quad", quads),
                                ("box", boxes), ("atlas", atlas))
              if x is not None}
    with torch.enable_grad():
        frames = None if quads is None else mk.quad_frame_pack(quads)
        rows_in = tuple(st[r, lanes].clone().requires_grad_()
                        for r in range(13))
        rows, total = rows_in, 0.0
        for i, r in enumerate(records):
            rows = tuple(x[r["sel"]] for x in rows)
            sel, flags = winner_rows(r, sph, frames, boxes, tex=tex)
            rows = diff_step(step_constants(r, sph24, bg8, solids), *rows,
                             *sel, *bg[:6], *(() if atlas is None
                                              else (atlas,)),
                             moving=moving, t_min=t_min, rr_depth=rr_depth,
                             **flags)
            # A lane's chain ends at its last step, or where it stops.
            ends = (torch.ones_like(r["survives"]) if i + 1 == len(records)
                    else ~r["survives"])
            total = total + (seed[:, r["cur"]] * ends
                             * torch.stack(rows)).sum()
        grads = torch.autograd.grad(total, (*rows_in, *leaves.values()),
                                    allow_unused=True)
    zero = torch.zeros_like(lanes, dtype=torch.float32)
    d_state[:13, lanes] = torch.stack(
        [zero if g is None else g for g in grads[:13]])
    got = {k: torch.zeros_like(x) if g is None else g
           for (k, x), g in zip(leaves.items(), grads[13:])}
    d_solids = None if solids is None else solid_grads(
        solids, got.get("quad"), got.get("box"))
    return (d_state, got["sph"], got["bg"], mismatches, d_solids,
            got.get("atlas"))


def solid_inputs(solids, tex=None, rr_depth: int = 0) -> tuple:
    """The trailing arguments of BounceChain.apply and
    TileTrainChain.apply for a scene's SolidPacks and TexPack and
    Russian roulette's first bounce: (quad24, box24, layout, med24 or
    None, atlas, tex without its atlas, rr_depth), the first four None
    without solids, the next two without tex. layout, which carries no
    gradient: (n_quads, n_boxes, n_media, tree), the active counts and
    the families' accel.SolidBvh (or None), which train_fwd,
    bounce_steps and chain_bwd walk past mk.SOLID_CAP active slots."""
    packs = ((None,) * 4 if solids is None else (
        solids.quad24, solids.box24,
        (solids.n_quads, solids.n_boxes, solids.n_media, solids.tree),
        solids.med24))
    atlas = ((None, None) if tex is None
             else (tex.atlas, dataclasses.replace(tex, atlas=None)))
    return packs + atlas + (rr_depth,)


def unpack_inputs(quad24, box24, layout, med24, atlas, tex):
    """The SolidPacks and TexPack of solid_inputs' arguments, the solid
    trees among them."""
    solids = None if layout is None else mk.SolidPacks(
        quad24, box24, *layout[:3], med24, layout[3])
    return solids, (None if tex is None
                    else dataclasses.replace(tex, atlas=atlas))


class BounceChain(torch.autograd.Function):
    """K bounce steps of a lane state as a differentiable function of
    the state and the packs: apply(state (16,Q), keys (2,Q) int32,
    sph24, bg8, k_steps, max_depth, t_min, moving, bvh,
    *solid_inputs(solids, tex, rr_depth)) -> state' (16,Q), bvh the
    sphere pack's accel.BvhPack (required on a CUDA device), the last
    arguments the quad and box packs, their layout (active slot counts,
    trees) and the medium pack (None: the chain takes no media) of a
    scene with quads, boxes or a light, the atlas of a scene with
    textures, and Russian roulette's first bounce.
    Forward: one bounce_steps launch on a copy of the state
    (bounce_steps updates in place, and the input is the backward's
    residual); backward: one chain_adjoint on the same BVH, seeded with
    zeros where the output has no cotangent (autograd materialises
    them). The keys carry no gradient."""

    @staticmethod
    def forward(ctx, state, keys, sph24, bg8, k_steps, max_depth, t_min,
                moving, bvh, quad24=None, box24=None, layout=None,
                med24=None, atlas=None, tex=None, rr_depth=0):
        solids, tex = unpack_inputs(quad24, box24, layout, med24, atlas, tex)
        kw = dict(k_steps=k_steps, max_depth=max_depth, t_min=t_min,
                  moving=moving, bvh=bvh, rr_depth=rr_depth)
        out = mk.bounce_steps(state.clone(), keys, sph24, bg8, solids=solids,
                              tex=tex, **kw)
        ctx.save_for_backward(state, keys, sph24, bg8,
                              out[mk.ROW_BOUNCE].clone(), quad24, box24,
                              atlas)
        ctx.kw = kw
        ctx.layout = layout
        ctx.tex = None if tex is None else dataclasses.replace(tex,
                                                                atlas=None)
        return out

    @staticmethod
    def backward(ctx, d_out):
        state, keys, sph24, bg8, out_bounce, quad24, box24, atlas = \
            ctx.saved_tensors
        solids, tex = unpack_inputs(quad24, box24, ctx.layout, None, atlas,
                                    ctx.tex)
        d_state, d_sph, d_bg, _, d_solids, d_atlas = chain_adjoint(
            state, keys, sph24, bg8, d_out.contiguous(), out_bounce,
            solids=solids, tex=tex, **ctx.kw)
        d_quad, d_box = ((None, None) if d_solids is None
                         else (d_solids.quad24, d_solids.box24))
        return ((d_state, None, d_sph, d_bg) + (None,) * 5
                + (d_quad, d_box, None, None, d_atlas, None, None))


def bounce_chain(k_steps: int, max_depth: int, t_min: float,
                 moving: bool, rr_depth: int = 0):
    """chain(state, keys, sph24, bg8, bvh=None, solids=None, tex=None)
    -> state': BounceChain with its step count and options bound (its
    Russian roulette from bounce rr_depth, 0 off), as rrt_tpu's
    bounce_chain returns; bvh: the sphere pack's accel.BvhPack, which
    both kernels walk (required on a CUDA device); solids, tex: the
    scene's SolidPacks and TexPack, or None."""
    def chain(state, keys, sph24, bg8, bvh=None, solids=None, tex=None):
        return BounceChain.apply(state, keys, sph24, bg8, k_steps, max_depth,
                                 t_min, moving, bvh,
                                 *solid_inputs(solids, tex, rr_depth))
    return chain
