"""Branchless batched material scatter: lambertian, metal, dielectric.

Every material model is evaluated for the whole batch and the result is
selected by material id, as in rrt_tpu.materials. Semantics follow the
books and the reference:

  lambertian  dir = n + unit_vector, degenerate -> n     (materials.rs:19-35)
  metal       dir = reflect(unit(d), n) + fuzz*in_sphere,
              absorbed if dir.n <= 0                     (materials.rs:44-61)
  dielectric  Schlick reflectance, TIR, stochastic
              reflect-vs-refract, attenuation = 1        (materials.rs:75-104)

diffuse_light and isotropic wait for ROADMAP Queue A #9.2 and #9.4.
"""

import dataclasses

import torch

from . import rng
from .geometry import dot
from .scene import MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL, SceneArrays
from .textures import texture_value


@dataclasses.dataclass(frozen=True)
class Scatter:
    direction: torch.Tensor  # (3,N) new ray direction
    attenuation: torch.Tensor  # (3,N)
    scattered: torch.Tensor  # (N,) bool; False = absorbed
    # The discrete decisions and the draws, which the backward replays.
    degenerate: torch.Tensor  # (N,) bool: lambertian n + u ~ 0
    reflected: torch.Tensor  # (N,) bool: dielectric reflects
    unit_rand: torch.Tensor  # (3,N) unit vector (lambertian)
    sphere_rand: torch.Tensor  # (3,N) point in the unit sphere (metal)


def _reflect(v, n):
    return v - n * (2.0 * dot(v, n))


def _refract(unit_d, n, ratio):
    """Snell refraction of a unit direction about unit normal n."""
    cos_theta = torch.clamp(-dot(unit_d, n), max=1.0)
    r_perp = (unit_d + n * cos_theta) * ratio
    r_par_sq = 1.0 - dot(r_perp, r_perp)
    ok = r_par_sq > 1e-12
    r_par_len = torch.sqrt(torch.where(ok, r_par_sq, 1.0)) * ok
    return r_perp - n * r_par_len


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5)


def scatter(scene: SceneArrays, d_in, hit, keys, bounce) -> Scatter:
    """Evaluate the material models for the batch and select by mat_id.

    d_in: (3,N) incoming directions (unnormalized, like the reference).
    hit: geometry.Hit. keys: (2,N) sample keys; bounce: int or (N,)
    bounce counter of the draw stream."""
    mat = hit.mat_id.long()
    mtype = scene.mat_type[mat]
    albedo = texture_value(scene, scene.mat_tex[mat], hit.u, hit.v, hit.p)
    unit_rand, sphere_rand, u_choice = rng.scatter_draws(keys, bounce)
    normal = hit.normal

    # Lambertian.
    lam_dir = normal + unit_rand
    degenerate = torch.all(torch.abs(lam_dir) < 1e-8, dim=0)
    lam_dir = torch.where(degenerate, normal, lam_dir)

    # Metal.
    unit_d = d_in * torch.rsqrt(torch.clamp(dot(d_in, d_in), min=1e-20))
    met_dir = _reflect(unit_d, normal) + sphere_rand * scene.mat_fuzz[mat]
    met_ok = dot(met_dir, normal) > 0.0

    # Dielectric.
    ior = scene.mat_ior[mat]
    ratio = torch.where(hit.front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(-dot(unit_d, normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    cannot_refract = ratio * sin_theta > 1.0
    reflect_choice = cannot_refract | (_schlick(cos_theta, ratio)
                                       > u_choice)
    die_dir = torch.where(reflect_choice, _reflect(unit_d, normal),
                          _refract(unit_d, normal, ratio))

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    direction = torch.where(is_lam, lam_dir,
                            torch.where(is_met, met_dir, die_dir))
    attenuation = torch.where(is_die, 1.0, albedo)
    scattered = torch.where(is_met, met_ok, is_lam | is_die)
    return Scatter(direction=direction, attenuation=attenuation,
                   scattered=scattered, degenerate=degenerate,
                   reflected=reflect_choice, unit_rand=unit_rand,
                   sphere_rand=sphere_rand)
