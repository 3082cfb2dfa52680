"""Thin-lens look-at camera.

Covers the reference camera (reference: src/camera.rs:31-66): vertical
fov, aspect, aperture (defocus disc), focus distance and a shutter
interval. The camera holds its creation parameters; the frame is derived
from them in `basis()`, with the same f32 expressions as rrt_tpu.camera.
"""

import dataclasses
import math

import torch

from . import rng


@dataclasses.dataclass(frozen=True)
class Camera:
    """Creation parameters, all f32 tensors."""

    look_from: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov_deg: torch.Tensor  # () vertical field of view in degrees
    aspect: torch.Tensor  # () width / height
    aperture: torch.Tensor  # ()
    focus_dist: torch.Tensor  # ()
    time0: torch.Tensor  # () shutter open
    time1: torch.Tensor  # () shutter close

    @staticmethod
    def create(look_from, look_at, up=(0.0, 1.0, 0.0), fov_deg=20.0,
               aspect=1.5, aperture=0.0, focus_dist=1.0, time0=0.0,
               time1=0.0) -> "Camera":
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32)

        return Camera(
            look_from=f32(look_from), look_at=f32(look_at), up=f32(up),
            fov_deg=f32(fov_deg), aspect=f32(aspect), aperture=f32(aperture),
            focus_dist=f32(focus_dist), time0=f32(time0), time1=f32(time1))

    def to(self, device) -> "Camera":
        """The same camera with every field on `device` (differentiable,
        like Tensor.to)."""
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})

    def basis(self):
        """Derived frame: (origin, lower_left, horizontal, vertical, u, v),
        each (3,)."""
        theta = self.fov_deg * (math.pi / 180.0)
        half_h = torch.tan(theta * 0.5)
        half_w = self.aspect * half_h
        w = _normalize(self.look_from - self.look_at)
        u = _normalize(torch.linalg.cross(self.up, w))
        v = torch.linalg.cross(w, u)
        fd = self.focus_dist
        lower_left = (self.look_from - half_w * fd * u - half_h * fd * v
                      - fd * w)
        horizontal = (2.0 * half_w * fd) * u
        vertical = (2.0 * half_h * fd) * v
        return self.look_from, lower_left, horizontal, vertical, u, v


def _normalize(x):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x), min=1e-20))


def thin_lens_rays(basis, lens_radius, time0, dtime, px, py, width: int,
                   height: int, keys):
    """One jittered thin-lens ray per pixel of the batch.

    basis: Camera.basis()'s six (3,) vectors. px, py: (N,) integer pixel
    coordinates, row 0 at the top (flipped into camera `t` here, like
    the reference at src/lib.rs:93-94). keys: (2,N) sample keys.
    Returns (origins (3,N), directions (3,N), times (N,))."""
    origin, lower_left, horizontal, vertical, u, v = (
        b[:, None] for b in basis)
    jx, jy, dcx, dcy, time_u = rng.camera_draws(keys)
    s = (px.to(torch.float32) + jx) / float(width)
    t = ((float(height - 1) - py.to(torch.float32)) + jy) / float(height)
    rdx = lens_radius * dcx
    rdy = lens_radius * dcy
    origins = origin + u * rdx + v * rdy
    directions = lower_left + horizontal * s + vertical * t - origins
    times = time0 + dtime * time_u
    return origins, directions, times


def generate_rays(camera: Camera, px, py, width: int, height: int, keys):
    """Camera rays for pixels (px, py) with per-ray sample keys (2,N);
    each ray's jitter, lens offset and shutter time are a pure function
    of its (seed, pixel, sample) identity."""
    return thin_lens_rays(camera.basis(), camera.aperture * 0.5,
                          camera.time0, camera.time1 - camera.time0,
                          px, py, width, height, keys)
