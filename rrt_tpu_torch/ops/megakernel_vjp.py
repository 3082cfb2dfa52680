"""The differentiable bounce: one step re-derived from the winner's rows.

`diff_step` is the sphere-subset counterpart of rrt_tpu's
`ops/megakernel_vjp.py::_make_diff_step`: one bounce as a function of
the 13 state rows (origin, direction, time, throughput, pending
radiance), the winner's 24 sphere-pack rows and the 6 background rows,
with every discrete decision (root, front face, checker parity,
degenerate lambertian, reflect-vs-refract, hit / miss / survival) and
every random draw supplied as a replayed constant. It is the math the
CUDA backward (csrc/train.cu) transposes by hand, and the body of that
kernel's plain version (megakernel_train.tiles_adjoint_reference),
which differentiates it with autograd.

`camera_ray_rows` is the thin-lens camera ray as a function of the 24
camera-pack rows (rrt_tpu's `megakernel_train._camera_ray_rows`); the
backward applies it at bounce 0 of every sample.

Square roots and reciprocals on masked branches are guarded with a
double `where`, as rrt_tpu does, so a branch that is not taken never
leaks NaN into a gradient.
"""

import torch

# The families outside the sphere subset, by flag: the ROADMAP Queue A
# item that ports each.
_NOT_PORTED = (("moving", "moving spheres", "#9.1"),
               ("has_quads", "quads", "#9.2"),
               ("has_boxes", "boxes", "#9.3"),
               ("n_media", "constant media", "#9.4"),
               ("has_perlin", "perlin textures", "#9.5"),
               ("has_images", "image textures", "#9.5"),
               ("rr_depth", "Russian roulette", "#9.6"))


def diff_step(c, *ins, moving=False, has_quads=False, has_boxes=False,
              has_perlin=False, has_images=False, n_media=0, rr_depth=0):
    """One bounce, differentiable in `ins`: 13 state rows (ox, oy, oz,
    dx, dy, dz, time, thx, thy, thz, pex, pey, pez), sel_s (24, N) (the
    winner's pack column per ray) and 6 background rows (bottom rgb,
    top rgb). Returns the 13 state rows after the bounce.

    c: the replayed constants, (N,) bool tensors t_hit (float), hit,
    miss, survives, front, degen, do_reflect, use_c2, is_lam, is_met,
    is_die; is_sky (0-d bool); draws, the 7 rows (unit xyz, sphere xyz,
    choice) of the bounce's scatter draws. The other families' flags
    raise NotImplementedError."""
    flags = dict(moving=moving, has_quads=has_quads, has_boxes=has_boxes,
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
