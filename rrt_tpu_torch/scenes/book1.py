"""RTIOW (book 1) scenes, matching the reference builders bit-for-bit.

The random scenes consume the host xoshiro128+ stream in exactly the
reference's draw order (reference: src/chap12.rs:20-70) so sphere
layouts/materials are identical for a given seed, and equal to
rrt_tpu.scenes.book1's. Returns (SceneArrays, Camera).

book2chap2 (the same field with moving spheres) waits for the
motion-blur port (ROADMAP Queue A #9.1).
"""

import math

from ..camera import Camera
from ..scene import SceneBuilder
from ..xoshiro import Xoshiro128Plus


def diffuse_scene(nx: int, ny: int):
    """BASELINE config #1: single lambertian sphere + ground plane with the
    RTIOW ch. 8 fixed camera (origin, 90-degree vfov)."""
    b = SceneBuilder()
    gray = b.lambertian((0.5, 0.5, 0.5))
    b.sphere((0.0, 0.0, -1.0), 0.5, gray)
    b.sphere((0.0, -100.5, -1.0), 100.0, gray)
    cam = Camera.create(
        look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0), fov_deg=90.0,
        aspect=nx / ny, aperture=0.0, focus_dist=1.0)
    return b.build(), cam


def chap11_scene(nx: int, ny: int):
    """Five-sphere scene with the hollow-glass negative-radius trick and a
    wide aperture (reference: src/chap11.rs:8-63)."""
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian((0.1, 0.2, 0.5)))
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.8, 0.8, 0.0)))
    b.sphere((1.0, 0.0, -1.0), 0.5, b.metal((0.8, 0.6, 0.2), fuzz=0.3))
    glass = b.dielectric(1.5)
    b.sphere((-1.0, 0.0, -1.0), 0.5, glass)
    b.sphere((-1.0, 0.0, -1.0), -0.45, glass)

    look_from = (3.0, 3.0, 2.0)
    look_at = (0.0, 0.0, -1.0)
    focus = math.dist(look_from, look_at)
    cam = Camera.create(look_from=look_from, look_at=look_at, fov_deg=20.0,
                        aspect=nx / ny, aperture=2.0, focus_dist=focus)
    return b.build(), cam


def _random_sphere_field(b: SceneBuilder, rng: Xoshiro128Plus):
    """The 22x22 random grid of chap12, with the reference's exact draw
    order.

    All arithmetic rounds through f32, because the reference computes in
    f32 throughout (`a as f32 + 0.9 * rng.gen::<f32>()` etc.,
    src/chap12.rs:22-27) — the stored layouts are then bit-identical, not
    merely double-rounded-close (tests/test_scenes.py pins values)."""
    import numpy as np
    f32 = np.float32
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    for a in range(-11, 11):
        for z in range(-11, 11):
            cx = f32(f32(a) + f32(f32(0.9) * f32(rng.gen_f32())))
            cz = f32(f32(z) + f32(f32(0.9) * f32(rng.gen_f32())))
            center = (cx, f32(0.2), cz)
            # Rejection distance in f32 like ultraviolet's Vec4f::mag
            # (src/chap12.rs:28: (center - (4,0.2,0)).mag() <= 0.9 skips).
            dx = f32(cx - f32(4.0))
            if f32(np.sqrt(f32(f32(dx * dx) + f32(cz * cz)))) <= f32(0.9):
                continue
            # Branch compares in f32 (the reference compares f32 draws
            # against f32 literals; a draw exactly equal to f32(0.95)
            # would flip branch under an f64 compare).
            choose = f32(rng.gen_f32())
            if choose < f32(0.8):
                albedo = (f32(f32(rng.gen_f32()) * f32(rng.gen_f32())),
                          f32(f32(rng.gen_f32()) * f32(rng.gen_f32())),
                          f32(f32(rng.gen_f32()) * f32(rng.gen_f32())))
                b.sphere(center, 0.2, b.lambertian(albedo))
            elif choose < f32(0.95):
                albedo = (f32(f32(0.5) * f32(f32(1.0) + f32(rng.gen_f32()))),
                          f32(f32(0.5) * f32(f32(1.0) + f32(rng.gen_f32()))),
                          f32(f32(0.5) * f32(f32(1.0) + f32(rng.gen_f32()))))
                b.sphere(center, 0.2,
                         b.metal(albedo,
                                 fuzz=f32(f32(0.5) * f32(rng.gen_f32()))))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), fuzz=0.0))


def _final_camera(nx: int, ny: int) -> Camera:
    return Camera.create(look_from=(13.0, 2.0, 3.0),
                         look_at=(0.0, 0.0, 0.0), fov_deg=20.0,
                         aspect=nx / ny, aperture=0.1, focus_dist=10.0,
                         time0=0.0, time1=0.0)


def chap12_scene(nx: int, ny: int, seed: int = 0):
    """RTIOW final scene: ~480 random spheres (reference src/chap12.rs)."""
    b = SceneBuilder()
    _random_sphere_field(b, Xoshiro128Plus(seed))
    return b.build(), _final_camera(nx, ny)
