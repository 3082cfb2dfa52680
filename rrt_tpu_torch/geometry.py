"""Batched ray-primitive intersection and hit records, component rows.

A ray batch is tested against a whole primitive family at once as
(N,1) x (1,S) broadcasts, the families' closest hits are merged
(`intersect_all`), and only the winner's hit record is rebuilt
afterwards (`make_hit`), as in rrt_tpu.geometry. Vectors are (3,N)
tensors, one row per component. The families: spheres, quads
(parallelograms), boxes (axis-aligned in their own frame, rotated
about the world Y axis) and constant media (RTTNW ch. 9: a sphere or an
oriented box boundary whose interval, clipped by the closest solid's t,
holds a sampled scattering distance).

Spheres move linearly over their shutter interval: the center at a
ray's time is base + time * vel, folded from (center0, center1 - center0,
time0, 1 / (time1 - time0)) as in rrt_tpu.geometry.

The quad and box tests (`quad_roots`, `box_roots`) are written in the
arithmetic of rrt_tpu's kernel (ops/megakernel.py `_one_bounce`'s
scalar family loops), which the CUDA kernels share (ops/csrc/bounce.cuh):
the quad test on each quad's plane frame (`quad_frames`, which the
kernels compute from the same rows), the box test by its closed-form
slab interval; the media (`medium_interval`, `intersect_media`) in the
arithmetic of its `_one_bounce` medium loop.
"""

import dataclasses
import math

import torch

INF = 3.0e38

FAM_NONE = -1
FAM_SPHERE = 0
FAM_QUAD = 1
FAM_MEDIUM = 2
FAM_BOX = 3


@dataclasses.dataclass(frozen=True)
class Hit:
    """Hit record for a ray batch (the reference's `Hit` struct,
    src/hittable.rs:10-16, plus texture uv and a material id)."""

    t: torch.Tensor  # (N,)
    p: torch.Tensor  # (3,N)
    normal: torch.Tensor  # (3,N) faces against the incoming ray
    front_face: torch.Tensor  # (N,) bool
    mat_id: torch.Tensor  # (N,) i32
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    hit_mask: torch.Tensor  # (N,) bool


def dot(a, b):
    """Row-wise dot product of (3,...) tensors, summed x, y, z in order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _safe_sqrt(x):
    return torch.sqrt(torch.where(x > 0.0, x, 1.0)) * (x > 0.0)


def intersect_spheres(scene, o, d, time, t_min, t_max):
    """Closest valid sphere per ray. o, d: (3,N); time: (N,) the rays'
    times (read when scene.has_moving); t_min, t_max: floats or (N,).
    Returns (t (N,), idx (N,) int64); misses have t == INF."""
    t_hit = sphere_roots(scene, o, d, time, t_min, t_max)
    idx = torch.argmin(t_hit, dim=-1)  # the first minimum, like jnp
    return t_hit.gather(1, idx[:, None])[:, 0], idx


def sphere_roots(scene, o, d, time, t_min, t_max):
    """Every ray's root on every sphere slot, (N,S): INF where the slot
    is invalid or gives no root in (t_min, t_max).

    Root selection matches the reference (src/sphere.rs:79-87): near
    root if inside (t_min, t_max), else far root, else miss. The
    quadratic is the expanded form of rrt_tpu.geometry and of the tile
    kernel, and a moving sphere's center is base + time * vel as there,
    so the three agree up to rounding."""
    inv_dt = scene.sphere_inv_dt[:, None]
    base = scene.sphere_c0 - scene.sphere_dc * (scene.sphere_t0[:, None]
                                                 * inv_dt)
    if scene.has_moving:
        f = time[:, None]  # (N,1)
        vel = scene.sphere_dc * inv_dt
        cx, cy, cz = (b[None, :] + f * v[None, :]  # (N,S)
                      for b, v in zip(base.T, vel.T))
    else:
        cx, cy, cz = (b[None, :] for b in base.T)  # (1,S)
    a = dot(d, d)[:, None]  # (N,1)
    o_dot_d = dot(o, d)[:, None]
    o_dot_o = dot(o, o)[:, None]
    inv_a = 1.0 / a

    d_c = d[0][:, None] * cx + d[1][:, None] * cy + d[2][:, None] * cz
    o_c = o[0][:, None] * cx + o[1][:, None] * cy + o[2][:, None] * cz
    c_sq = cx * cx + cy * cy + cz * cz
    r = scene.sphere_radius[None, :]

    half_b = o_dot_d - d_c
    c_coef = o_dot_o - 2.0 * o_c + c_sq - r * r
    disc = half_b * half_b - a * c_coef
    sq = _safe_sqrt(disc)
    root0 = (-half_b - sq) * inv_a
    root1 = (-half_b + sq) * inv_a

    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=o.device)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    if t_min.dim():
        t_min = t_min[:, None]
    if t_max.dim():
        t_max = t_max[:, None]
    ok = (disc > 0.0) & scene.sphere_valid[None, :]
    in0 = ok & (root0 > t_min) & (root0 < t_max)
    in1 = ok & (root1 > t_min) & (root1 < t_max)
    return torch.where(in0, root0, torch.where(in1, root1, INF))


def cross(a, b):
    """Row-wise cross product of (3,...) tensors."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


@dataclasses.dataclass(frozen=True)
class QuadFrames:
    """Each quad's plane frame (rrt_tpu's pack_quads_full rows 0-12):
    n = u x v, g = (v x n) / |n|^2 and h = (n x u) / |n|^2, so a point p
    of the plane is q + alpha u + beta v with alpha = p.g - q.g and beta
    = p.h - q.h; d_plane = n.q; eps_n = 1e-8 |n| (the parallel test)."""

    n: torch.Tensor  # (3,Q)
    g: torch.Tensor  # (3,Q)
    h: torch.Tensor  # (3,Q)
    d_plane: torch.Tensor  # (Q,)
    q_g: torch.Tensor  # (Q,)
    q_h: torch.Tensor  # (Q,)
    eps_n: torch.Tensor  # (Q,)


def quad_frames(q, u, v) -> QuadFrames:
    """The frames of quads with corners q and edges u, v, each (3,Q)."""
    n = cross(u, v)
    nn = dot(n, n)
    inv_nn = 1.0 / torch.clamp(nn, min=1e-20)
    g = cross(v, n) * inv_nn
    h = cross(n, u) * inv_nn
    return QuadFrames(n=n, g=g, h=h, d_plane=dot(n, q), q_g=dot(g, q),
                      q_h=dot(h, q),
                      eps_n=1e-8 * torch.sqrt(torch.clamp(nn, min=1e-20)))


def quad_frame_vjp(q, u, v, g_n, g_plane):
    """The cotangents of q, u, v (each (3,Q)) for the cotangents g_n
    (3,Q) of n = u x v and g_plane (Q,) of d_plane = n.q: the only frame
    rows a bounce's gradient reaches (the quad's t and normal; g, h and
    eps_n feed decisions only). Returns (g_q, g_u, g_v)."""
    g = g_n + g_plane * q  # n's cotangent, d_plane's share included
    return g_plane * cross(u, v), cross(v, g), cross(g, u)


def _limits(t_min, t_max, device):
    """t_min, t_max (floats or (N,)) as tensors that broadcast over
    (N, family)."""
    lims = []
    for x in (t_min, t_max):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        lims.append(x[:, None] if x.dim() else x)
    return lims


def quad_roots(fr: QuadFrames, valid, o, d, t_min, t_max):
    """Every ray's t on every quad, (N,Q): INF where the quad is invalid,
    the ray parallel to its plane, the plane's t outside (t_min, t_max),
    or the plane's point outside the parallelogram."""
    def pair(r, p):  # (3,N) ray rows x (3,Q) quad rows -> (N,Q)
        return (r[0][:, None] * p[0][None, :] + r[1][:, None] * p[1][None, :]
                + r[2][:, None] * p[2][None, :])

    denom = pair(d, fr.n)
    o_n = pair(o, fr.n)
    d_len = torch.sqrt(dot(d, d))[:, None]
    not_par = torch.abs(denom) > fr.eps_n[None, :] * d_len
    t = (fr.d_plane[None, :] - o_n) / torch.where(not_par, denom, 1.0)
    alpha = pair(o, fr.g) + t * pair(d, fr.g) - fr.q_g[None, :]
    beta = pair(o, fr.h) + t * pair(d, fr.h) - fr.q_h[None, :]
    t_min, t_max = _limits(t_min, t_max, o.device)
    ok = (valid[None, :] & not_par & (t > t_min) & (t < t_max)
          & (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0))
    return torch.where(ok, t, INF)


def box_roots(center, half, cos_t, sin_t, valid, o, d, t_min, t_max):
    """Every ray's t on every box, (N,B): the slab test in each box's
    frame (center (B,3), half extents (B,3), the world-from-box Y
    rotation's cos and sin (B,)), by the closed-form interval of
    rrt_tpu's kernel: per axis, with inv = 1 / db (1e18 where |db| <=
    1e-12), the slab is -ob inv -/+ h |inv|. A ray starting inside a box
    hits its far face. INF where the box is invalid or missed."""
    cth, sth = cos_t[None, :], sin_t[None, :]
    wx = o[0][:, None] - center[:, 0][None, :]
    wy = o[1][:, None] - center[:, 1][None, :]
    wz = o[2][:, None] - center[:, 2][None, :]
    dx, dy, dz = d[0][:, None], d[1][:, None], d[2][:, None]
    obs = (cth * wx - sth * wz, wy, sth * wx + cth * wz)
    dbs = (cth * dx - sth * dz, dy.expand_as(wy), sth * dx + cth * dz)
    lo = hi = None
    for k in range(3):
        db = dbs[k]
        par = torch.abs(db) <= 1e-12
        inv = torch.where(par, 1e18, 1.0 / torch.where(par, 1.0, db))
        a_t = obs[k] * inv
        b_t = half[:, k][None, :] * torch.abs(inv)
        k_lo, k_hi = -a_t - b_t, b_t - a_t
        lo = k_lo if lo is None else torch.maximum(lo, k_lo)
        hi = k_hi if hi is None else torch.minimum(hi, k_hi)
    t_min, t_max = _limits(t_min, t_max, o.device)
    t = torch.where(lo > t_min, lo, hi)
    ok = valid[None, :] & (lo < hi) & (t > t_min) & (t < t_max)
    return torch.where(ok, t, INF)


def _closest(t_hit):
    """(t (N,), idx (N,) int64) of the first minimum of each row."""
    idx = torch.argmin(t_hit, dim=-1)
    return t_hit.gather(1, idx[:, None])[:, 0], idx


def intersect_quads(scene, o, d, t_min, t_max):
    """Closest valid quad per ray: (t (N,), idx (N,) int64)."""
    fr = quad_frames(scene.quad_q.T, scene.quad_u.T, scene.quad_v.T)
    return _closest(quad_roots(fr, scene.quad_valid, o, d, t_min, t_max))


def intersect_boxes(scene, o, d, t_min, t_max):
    """Closest valid box per ray: (t (N,), idx (N,) int64)."""
    return _closest(box_roots(scene.box_center, scene.box_half,
                              scene.box_cos, scene.box_sin, scene.box_valid,
                              o, d, t_min, t_max))


def merge_solid(ts, is_, tq, iq, tb, ib):
    """The families' closest hits (t, idx each (N,)) -> (t, fam, idx).

    Exact ties between families go by the kernels' order (rrt_tpu's
    kernel's and the CUDA kernels'): quad, box, sphere, each seeded by
    the one before and won only by a strictly smaller t. rrt_tpu's eager
    merge_solid_medium gives them to the sphere, then the box; the two
    differ on exact ties only."""
    t = torch.minimum(torch.minimum(ts, tq), tb)
    use_s = ts < torch.minimum(tq, tb)
    use_b = ~use_s & (tb < tq)
    fam = torch.where(use_s, FAM_SPHERE, torch.where(use_b, FAM_BOX,
                                                     FAM_QUAD))
    idx = torch.where(use_s, is_, torch.where(use_b, ib, iq))
    return t, torch.where(t < INF, fam, FAM_NONE), idx


def medium_interval(scene, i: int, o, d, a, inv_a):
    """Medium slot i's boundary interval over the unbounded line of each
    ray, (t_enter, t_exit, ok) each (N,), in the arithmetic of rrt_tpu's
    kernel (ops/megakernel.py `_one_bounce`): a sphere boundary by the
    quadratic of o - c (entered where the discriminant is positive), an
    oriented box by the slab test in its frame (med_rot is world from
    box), an axis whose |d_k| <= 1e-12 bounding nothing or everything as
    the origin lies inside its slab or not. a, inv_a: |d|^2 and 1 / a
    (N,)."""
    c = scene.med_center[i]
    ocx, ocy, ocz = o[0] - c[0], o[1] - c[1], o[2] - c[2]
    half_b = ocx * d[0] + ocy * d[1] + ocz * d[2]
    r = scene.med_radius[i]
    c_coef = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = half_b * half_b - a * c_coef
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    rot = scene.med_rot[i]
    lo = torch.full_like(a, -INF)
    hi = torch.full_like(a, INF)
    for k in range(3):
        ob = rot[0, k] * ocx + rot[1, k] * ocy + rot[2, k] * ocz
        db = rot[0, k] * d[0] + rot[1, k] * d[1] + rot[2, k] * d[2]
        hk = scene.med_half[i, k]
        par = torch.abs(db) <= 1e-12
        inv_db = 1.0 / torch.where(par, 1.0, db)
        t1 = (-hk - ob) * inv_db
        t2 = (hk - ob) * inv_db
        big = torch.where(torch.abs(ob) <= hk, INF, -INF)
        lo = torch.maximum(lo, torch.where(par, -big, torch.minimum(t1, t2)))
        hi = torch.minimum(hi, torch.where(par, big, torch.maximum(t1, t2)))
    is_sph = scene.med_btype[i] == 0  # scene.BOUND_SPHERE
    t_enter = torch.where(is_sph, (-half_b - sq) * inv_a, lo)
    t_exit = torch.where(is_sph, (-half_b + sq) * inv_a, hi)
    ok = torch.where(is_sph, disc > 0.0, lo < hi) & scene.med_valid[i]
    return t_enter, t_exit, ok


def intersect_media(scene, o, d, t_min, t_max, u_med):
    """Stochastic constant-medium intersection (RTTNW ch. 9): each
    medium's interval clipped to [t_min, t_max] and to t >= 0 holds a
    sampled distance -log(U) / density along the ray, which the ray
    scatters at if it lies inside. o, d: (3,N); t_min: a float; t_max:
    a float or (N,) (the closest solid's t); u_med: (n_media_active, N)
    uniforms (rng.medium_draws). Returns (t (N,), idx (N,) int64): the
    first medium with the strictly smallest t, as the kernels loop them;
    t == INF where none scatters."""
    a = dot(d, d)
    inv_a = 1.0 / a
    d_len = torch.sqrt(a)
    inv_dlen = 1.0 / torch.clamp(d_len, min=1e-20)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    t_med = torch.full_like(a, INF)
    idx = torch.zeros(a.shape, dtype=torch.int64, device=o.device)
    for i in range(scene.n_media_active):
        t_enter, t_exit, ok = medium_interval(scene, i, o, d, a, inv_a)
        te = torch.clamp(t_enter, min=t_min)
        tx = torch.minimum(t_exit, t_max)
        ok = ok & (te < tx)
        te = torch.clamp(te, min=0.0)
        ok = ok & (te < tx)
        # neg_inv_density * log(U) == -log(U) / density.
        hit_dist = scene.med_neg_inv_density[i] * torch.log(
            torch.clamp(u_med[i], min=1e-12))
        ok = ok & (hit_dist <= (tx - te) * d_len)
        t = torch.where(ok, te + hit_dist * inv_dlen, INF)
        better = t < t_med
        t_med = torch.where(better, t, t_med)
        idx = torch.where(better, i, idx)
    return t_med, idx


def merge_solid_medium(scene, o, d, t_min, t_max, u_med, ts, is_, tq, iq, tb,
                       ib):
    """The solid families' closest hits merged (merge_solid: quad, box,
    sphere on exact ties), then the media intersected against a t_max
    shrunk to the closest solid's t, as the books do: a medium wins with
    a strictly smaller t. Returns (t, fam, idx), each (N,)."""
    t, fam, idx = merge_solid(ts, is_, tq, iq, tb, ib)
    if scene.has_media:
        tm, im = intersect_media(scene, o, d, t_min, torch.minimum(
            torch.as_tensor(t_max, dtype=torch.float32, device=o.device), t),
            u_med)
        use = tm < t
        t = torch.where(use, tm, t)
        fam = torch.where(use, FAM_MEDIUM, fam)
        idx = torch.where(use, im, idx)
    return t, fam, idx


def intersect_all(scene, o, d, time, t_min, t_max, u_med=None):
    """The closest hit over the scene's families (rrt_tpu's
    intersect_all, solid ties by merge_solid's order): (t (N,), fam (N,)
    int64, idx (N,) int64); misses have t == INF, fam FAM_NONE. u_med:
    the media's uniforms (rng.medium_draws), read when scene.has_media."""
    ts, is_ = intersect_spheres(scene, o, d, time, t_min, t_max)
    none = (torch.full_like(ts, INF), torch.zeros_like(is_))
    tq, iq = (intersect_quads(scene, o, d, t_min, t_max) if scene.has_quads
              else none)
    tb, ib = (intersect_boxes(scene, o, d, t_min, t_max) if scene.has_boxes
              else none)
    return merge_solid_medium(scene, o, d, t_min, t_max, u_med, ts, is_, tq,
                              iq, tb, ib)


def atan_poly(z):
    """atan on [-1, 1] by rrt_tpu's kernel polynomial (minimax, odd; max
    error about 1e-5: rrt_tpu/ops/megakernel.py _atan_poly)."""
    z2 = z * z
    return z * (0.9998660 + z2 * (-0.3302995 + z2 * (0.1801410 + z2 * (
        -0.0851330 + z2 * 0.0208351))))


def atan2_poly(y, x):
    """atan2 from atan_poly on the bounded argument (rrt_tpu's
    _atan2_rows)."""
    ax, ay = torch.abs(x), torch.abs(y)
    swap = ay > ax
    num = torch.where(swap, ax, ay)
    den = torch.clamp(torch.where(swap, ay, ax), min=1e-30)
    r = atan_poly(num / den)
    r = torch.where(swap, (math.pi / 2) - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def sphere_uv(p, center, radius):
    """A sphere's texture uv at p (3,N) (RTTNW ch. 4.2): u = (atan2(-z,
    x) + pi) / (2 pi), v = acos(-y) / pi of the unit outward vector
    (p - c) / max(|r|, 1e-20), by rrt_tpu's kernel polynomials, the one
    rule of every kernel and plain version here; rrt_tpu's eager code
    takes exact arccos / arctan2, and the two part only at a texel's
    edge."""
    inv_ar = 1.0 / torch.clamp(torch.abs(radius), min=1e-20)
    ux, uy, uz = ((p - center) * inv_ar).unbind(0)
    y = torch.clamp(-uy, -1.0, 1.0)
    theta = atan2_poly(torch.sqrt(torch.clamp(1.0 - y * y, min=0.0)), y)
    phi = atan2_poly(-uz, ux) + math.pi
    return phi * (0.5 / math.pi), theta * (1.0 / math.pi)


def quad_uv(p, q, u, v):
    """A quad's texture uv at p (3,N): (alpha, beta) on the winner's
    plane frame, p.g - q.g and p.h - q.h (quad_frames of q, u, v (3,N),
    the rows the kernels stage)."""
    fr = quad_frames(q, u, v)
    return dot(p, fr.g) - fr.q_g, dot(p, fr.h) - fr.q_h


def make_hit(scene, o, d, time, t, fam, idx) -> Hit:
    """Rebuild the hit record of each ray's winner (rrt_tpu's make_hit):
    a sphere's center at the ray's time (N,); a quad's normal u x v /
    |u x v|; a box's the axis of its frame whose |q_k| - h_k is largest
    at the hit point, rotated back; a medium's a constant (1, 0, 0),
    front face (a volumetric scatter has no surface), its material the
    medium's. Texture uv is a sphere's (sphere_uv) or a quad's
    (quad_uv), 0 on a box or a medium (a box with an image is built as
    quads; a medium's albedo is its texture at uv 0, rrt_tpu's eager
    rule)."""
    hit_mask = fam != FAM_NONE
    # Misses carry t == INF; clamp so the (masked-out) miss rays' normal
    # math stays finite.
    t_eff = torch.where(hit_mask, t, 0.0)
    p = o + d * t_eff
    is_sphere = fam == FAM_SPHERE
    si = torch.where(is_sphere, idx, 0)
    f = (time - scene.sphere_t0[si]) * scene.sphere_inv_dt[si]
    center = scene.sphere_c0[si].T + scene.sphere_dc[si].T * f
    radius = scene.sphere_radius[si]
    outward = (p - center) * (1.0 / radius)  # sign(r) flips inward
    u, v = sphere_uv(p, center, radius)
    mat_id = scene.sphere_mat[si]
    if scene.has_quads:
        is_quad = fam == FAM_QUAD
        qi = torch.where(is_quad, idx, 0)
        qu, qv = scene.quad_u[qi].T, scene.quad_v[qi].T
        qn = cross(qu, qv)
        outward_q = qn * torch.rsqrt(torch.clamp(dot(qn, qn), min=1e-20))
        outward = torch.where(is_quad, outward_q, outward)
        mat_id = torch.where(is_quad, scene.quad_mat[qi], mat_id)
        if scene.has_images:
            u_q, v_q = quad_uv(p, scene.quad_q[qi].T, qu, qv)
            u, v = torch.where(is_quad, u_q, u), torch.where(is_quad, v_q, v)
    if scene.has_boxes:
        is_box = fam == FAM_BOX
        bi = torch.where(is_box, idx, 0)
        w = p - scene.box_center[bi].T
        bh = scene.box_half[bi].T
        cth, sth = scene.box_cos[bi], scene.box_sin[bi]
        qx, qy, qz = cth * w[0] - sth * w[2], w[1], sth * w[0] + cth * w[2]
        fx = torch.abs(qx) - bh[0]
        fy = torch.abs(qy) - bh[1]
        fz = torch.abs(qz) - bh[2]
        use_x = (fx >= fy) & (fx >= fz)
        use_y = ~use_x & (fy >= fz)
        nbx = torch.where(use_x, torch.sign(qx), 0.0)
        nby = torch.where(use_y, torch.sign(qy), 0.0)
        nbz = torch.where(use_x | use_y, 0.0, torch.sign(qz))
        outward_b = torch.stack([cth * nbx + sth * nbz, nby,
                                 -sth * nbx + cth * nbz])
        outward = torch.where(is_box, outward_b, outward)
        mat_id = torch.where(is_box, scene.box_mat[bi], mat_id)
    front_face = dot(d, outward) < 0.0
    if scene.has_media:
        is_medium = fam == FAM_MEDIUM
        mi = torch.where(is_medium, idx, 0)
        axis = torch.tensor([1.0, 0.0, 0.0], device=o.device)[:, None]
        outward = torch.where(is_medium, axis, outward)
        front_face = front_face | is_medium
        mat_id = torch.where(is_medium, scene.med_mat[mi], mat_id)
    if scene.has_quads or scene.has_boxes or scene.has_media:
        keep = is_sphere | is_quad if scene.has_quads else is_sphere
        u, v = torch.where(keep, u, 0.0), torch.where(keep, v, 0.0)
    normal = torch.where(front_face, outward, -outward)
    return Hit(t=t, p=p, normal=normal, front_face=front_face,
               mat_id=mat_id, u=u, v=v, hit_mask=hit_mask)
