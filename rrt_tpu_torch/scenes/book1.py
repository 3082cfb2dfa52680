"""RTIOW (book 1) scenes, matching the reference builders bit-for-bit.

The random scenes consume the host xoshiro128+ stream in exactly the
reference's draw order (reference: src/chap12.rs:20-70) so sphere
layouts/materials are identical for a given seed, and equal to
rrt_tpu.scenes.book1's. Returns (SceneArrays, Camera).
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


def _random_sphere_field(b: SceneBuilder, rng: Xoshiro128Plus,
                         moving_diffuse: bool):
    """The 22x22 random grid shared by chap12 and book2chap2, with the
    reference's exact draw order. When `moving_diffuse`, diffuse spheres
    get a y-motion offset drawn from a *cloned* stream, so the layout
    matches the stationary scene (reference: src/book2chap2.rs:12-13,
    36-44).

    All arithmetic rounds through f32, because the reference computes in
    f32 throughout (`a as f32 + 0.9 * rng.gen::<f32>()` etc.,
    src/chap12.rs:22-27) — the stored layouts are then bit-identical, not
    merely double-rounded-close (tests/test_scenes.py pins values)."""
    import numpy as np
    f32 = np.float32
    rng2 = rng.clone() if moving_diffuse else None
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
                if moving_diffuse:
                    # rand's inclusive uniform, bit-exact: two candidate
                    # f32 draws can lie within an ulp (xoshiro.py).
                    dy = f32(rng2.uniform_inclusive(0.0, 0.5))
                albedo = (f32(f32(rng.gen_f32()) * f32(rng.gen_f32())),
                          f32(f32(rng.gen_f32()) * f32(rng.gen_f32())),
                          f32(f32(rng.gen_f32()) * f32(rng.gen_f32())))
                mat = b.lambertian(albedo)
                if moving_diffuse:
                    b.moving_sphere(center, (cx, f32(f32(0.2) + dy), cz),
                                    0.0, 1.0, 0.2, mat)
                else:
                    b.sphere(center, 0.2, mat)
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


def _final_camera(nx: int, ny: int, time1: float) -> Camera:
    return Camera.create(look_from=(13.0, 2.0, 3.0),
                         look_at=(0.0, 0.0, 0.0), fov_deg=20.0,
                         aspect=nx / ny, aperture=0.1, focus_dist=10.0,
                         time0=0.0, time1=time1)


def chap12_scene(nx: int, ny: int, seed: int = 0):
    """RTIOW final scene: ~480 random spheres (reference src/chap12.rs)."""
    b = SceneBuilder()
    _random_sphere_field(b, Xoshiro128Plus(seed), moving_diffuse=False)
    return b.build(), _final_camera(nx, ny, time1=0.0)


def book2chap2_scene(nx: int, ny: int, seed: int = 0, checker: bool = False):
    """Motion-blur variant (reference src/book2chap2.rs); shutter [0,1].
    With `checker`, the ground gets the RTTNW ch. 4.3 checker texture
    (BASELINE config #3)."""
    b = SceneBuilder()
    _random_sphere_field(b, Xoshiro128Plus(seed), moving_diffuse=True)
    if checker:
        # Rebind the ground sphere's material (index 0) to a checker.
        tex = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
        b._materials[0] = (b._materials[0][0], tex, 0.0, 1.0)
    return b.build(), _final_camera(nx, ny, time1=1.0)
