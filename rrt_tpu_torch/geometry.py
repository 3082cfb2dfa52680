"""Batched ray-sphere intersection and hit records, component rows.

A ray batch is tested against the whole sphere family at once as
(N,1) x (1,S) broadcasts, and only the winning sphere's hit record is
rebuilt afterwards (`make_hit`), as in rrt_tpu.geometry. Vectors are
(3,N) tensors, one row per component.

Spheres move linearly over their shutter interval: the center at a
ray's time is base + time * vel, folded from (center0, center1 - center0,
time0, 1 / (time1 - time0)) as in rrt_tpu.geometry. Quads, boxes and
media wait for ROADMAP Queue A #9.2-#9.4.
"""

import dataclasses
import math

import torch

INF = 3.0e38

FAM_NONE = -1
FAM_SPHERE = 0


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
    Returns (t (N,), idx (N,) int64); misses have t == INF.

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
    t_hit = torch.where(in0, root0, torch.where(in1, root1, INF))
    idx = torch.argmin(t_hit, dim=-1)  # the first minimum, like jnp
    return t_hit.gather(1, idx[:, None])[:, 0], idx


def make_hit(scene, o, d, time, t, fam, idx) -> Hit:
    """Rebuild the hit record of each ray's winning sphere, its center
    at the ray's time (N,)."""
    hit_mask = fam == FAM_SPHERE
    # Misses carry t == INF; clamp so the (masked-out) miss rays' normal
    # math stays finite.
    t_eff = torch.where(hit_mask, t, 0.0)
    p = o + d * t_eff
    si = torch.where(hit_mask, idx, 0)
    f = (time - scene.sphere_t0[si]) * scene.sphere_inv_dt[si]
    center = scene.sphere_c0[si].T + scene.sphere_dc[si].T * f
    radius = scene.sphere_radius[si]
    outward = (p - center) * (1.0 / radius)  # sign(r) flips inward
    unit_out = (p - center) * (1.0 / torch.abs(radius))
    theta = torch.arccos(torch.clamp(-unit_out[1], -1.0, 1.0))
    phi = torch.atan2(-unit_out[2], unit_out[0]) + math.pi
    front_face = dot(d, outward) < 0.0
    normal = torch.where(front_face, outward, -outward)
    return Hit(t=t, p=p, normal=normal, front_face=front_face,
               mat_id=scene.sphere_mat[si], u=phi * (0.5 / math.pi),
               v=theta * (1.0 / math.pi), hit_mask=hit_mask)
