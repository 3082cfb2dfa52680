"""RTTNW (book 2) scenes, with rrt_tpu.scenes.book2's geometry and
constants: simple_light (perlin marble, a quad and a sphere light),
earth (an image texture), the Cornell box and its smoke version, and
the book's final scene (rttnw_final: 400 ground boxes, a quad light,
1,006 spheres, one moving, two media, the marble and the image, in
Morton order). mixed_scene, media_scene and many_solids_scene are test
data (the solid families beside spheres; both constant-medium
boundaries where the sky gives them a gradient; more quads and boxes
than the loops take), not book scenes. Returns (SceneArrays,
Camera)."""

import math

import numpy as np

from ..camera import Camera
from ..scene import SceneBuilder


def simple_light_scene(nx: int, ny: int):
    """Two perlin-marble spheres, a quad light and a sphere light on a
    black background (RTTNW ch. 7.1)."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    marble = b.lambertian(b.perlin(scale=4.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, marble)
    b.sphere((0.0, 2.0, 0.0), 2.0, marble)
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.quad((3.0, 1.0, -2.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), light)
    b.sphere((0.0, 7.0, 0.0), 2.0, light)
    cam = Camera.create(look_from=(26.0, 3.0, 6.0), look_at=(0.0, 2.0, 0.0),
                        fov_deg=20.0, aspect=nx / ny)
    return b.build(), cam


def _default_earth_image() -> np.ndarray:
    """The procedural stand-in for the book's earthmap.jpg (nothing is
    bundled or downloaded): latitude-banded land and sea, 128x256,
    rrt_tpu's."""
    h, w = 128, 256
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = u / (w - 1), v / (h - 1)
    land = (np.sin(u * 19.0) * np.sin(v * 13.0 + 2.0)) > 0.2
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(land, 0.2, 0.05)
    img[..., 1] = np.where(land, 0.55, 0.15)
    img[..., 2] = np.where(land, 0.2, 0.5)
    return img


def earth_scene(nx: int, ny: int, image: np.ndarray | None = None,
                image_resample: str = "nearest"):
    """One image-textured sphere under the default sky (RTTNW ch. 6).
    `image` replaces the stand-in with an (h,w,3) float array in [0,1];
    `image_resample` picks the atlas fit."""
    b = SceneBuilder()
    tex = b.image(_default_earth_image() if image is None else image,
                  resample=image_resample)
    b.sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(tex))
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=nx / ny)
    return b.build(), cam


def rttnw_final_scene(nx: int, ny: int, seed: int = 0,
                      image: np.ndarray | None = None,
                      ablate: frozenset = frozenset(),
                      image_resample: str = "nearest"):
    """RTTNW ch. 10 final scene (rrt_tpu's, the same draws): a ground of
    400 boxes of random height, a quad light, a moving sphere, glass,
    metal and subsurface spheres, the earth image and the marble, a
    global fog and a cloud of 1,000 spheres rotated and translated
    (baked into their centers), built with spatial_sort=True.

    `ablate` (any of {"earth", "perlin", "media", "boxes", "cloud"})
    drops a feature while keeping every draw of the seed's RandomState,
    for per-feature cost attribution: a texture's ablation substitutes a
    solid color. `image` and `image_resample`: as earth_scene's."""
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))

    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = float(rs.uniform(1.0, 101.0))
            if "boxes" not in ablate:
                b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.diffuse_light((7.0, 7.0, 7.0))
    b.quad((123.0, 554.0, 147.0), (300.0, 0.0, 0.0), (0.0, 0.0, 265.0),
           light)

    b.moving_sphere((400.0, 400.0, 200.0), (430.0, 400.0, 200.0), 0.0, 1.0,
                    50.0, b.lambertian((0.7, 0.3, 0.1)))
    glass = b.dielectric(1.5)
    b.sphere((260.0, 150.0, 45.0), 50.0, glass)
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal((0.8, 0.8, 0.9), fuzz=1.0))

    # The subsurface sphere: a glass boundary holding a constant medium.
    b.sphere((360.0, 150.0, 145.0), 70.0, glass)
    if "media" not in ablate:
        b.medium_sphere((360.0, 150.0, 145.0), 70.0, density=0.2,
                        albedo=(0.2, 0.4, 0.9))
        b.medium_sphere((0.0, 0.0, 0.0), 5000.0, density=1.0e-4,
                        albedo=(1.0, 1.0, 1.0))  # the global fog

    earth_tex = (b.lambertian((0.4, 0.3, 0.2)) if "earth" in ablate
                 else b.lambertian(b.image(
                     _default_earth_image() if image is None else image,
                     resample=image_resample)))
    b.sphere((400.0, 200.0, 400.0), 100.0, earth_tex)
    per_tex = (b.lambertian((0.5, 0.5, 0.5)) if "perlin" in ablate
               else b.lambertian(b.perlin(scale=0.1)))
    b.sphere((220.0, 280.0, 300.0), 80.0, per_tex)

    # The cloud, instanced rotate_y(15) + translate(-100, 270, 395): a
    # rotated sphere is a sphere, so the transform moves its center.
    white = b.lambertian((0.73, 0.73, 0.73))
    ang = math.radians(15.0)
    c, s = math.cos(ang), math.sin(ang)
    for _ in range(1000):
        x, y, z = rs.uniform(0.0, 165.0, size=3)
        if "cloud" in ablate:
            continue
        rx = c * x + s * z - 100.0
        rz = -s * x + c * z + 395.0
        b.sphere((float(rx), float(y + 270.0), float(rz)), 10.0, white)

    cam = Camera.create(look_from=(478.0, 278.0, -600.0),
                        look_at=(278.0, 278.0, 0.0), fov_deg=40.0,
                        aspect=nx / ny, time0=0.0, time1=1.0)
    return b.build(spatial_sort=True), cam


def _cornell_walls(b: SceneBuilder, light_emit, light_q, light_u, light_v):
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light(light_emit)
    b.quad((555.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), green)
    b.quad((0.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), red)
    b.quad(light_q, light_u, light_v, light)
    b.quad((0.0, 0.0, 0.0), (555.0, 0.0, 0.0), (0.0, 0.0, 555.0), white)
    b.quad((555.0, 555.0, 555.0), (-555.0, 0.0, 0.0), (0.0, 0.0, -555.0),
           white)
    b.quad((0.0, 0.0, 555.0), (555.0, 0.0, 0.0), (0.0, 555.0, 0.0), white)
    return white


def _cornell_camera(nx: int, ny: int) -> Camera:
    return Camera.create(look_from=(278.0, 278.0, -800.0),
                         look_at=(278.0, 278.0, 0.0), fov_deg=40.0,
                         aspect=nx / ny)


def cornell_box_scene(nx: int, ny: int):
    """The standard Cornell box with two rotate_y-instanced boxes (RTTNW
    ch. 8.2), in the box family with the rotation baked into cos/sin:
    six quads (five walls and the light), two boxes, no sphere."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    white = _cornell_walls(b, (15.0, 15.0, 15.0), (213.0, 554.0, 227.0),
                           (130.0, 0.0, 0.0), (0.0, 0.0, 105.0))
    b.box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white, rotate_y_deg=15.0,
          translate=(265.0, 0.0, 295.0))
    b.box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), white, rotate_y_deg=-18.0,
          translate=(130.0, 0.0, 65.0))
    return b.build(), _cornell_camera(nx, ny)


def cornell_smoke_scene(nx: int, ny: int):
    """Cornell box with the boxes swapped for smoke and fog constant
    media of density 0.01 (RTTNW ch. 9.2): a black one in the tall box,
    a white one in the short box, both rotated about Y, under the larger
    light."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    _cornell_walls(b, (7.0, 7.0, 7.0), (113.0, 554.0, 127.0),
                   (330.0, 0.0, 0.0), (0.0, 0.0, 305.0))
    b.medium_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), density=0.01,
                 albedo=(0.0, 0.0, 0.0), rotate_y_deg=15.0,
                 translate=(265.0, 0.0, 295.0))
    b.medium_box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), density=0.01,
                 albedo=(1.0, 1.0, 1.0), rotate_y_deg=-18.0,
                 translate=(130.0, 0.0, 65.0))
    return b.build(), _cornell_camera(nx, ny)


def media_scene(w, h, builder=SceneBuilder, camera=Camera):
    """Both constant-medium boundaries under the sky: test data for the
    media's gradients, which cornell_smoke's black background and
    constant albedos leave at 0. A glass sphere holding a medium sphere
    (rttnw_final's subsurface sphere), a metal sphere, a rotated medium
    box on a checker ground. Not a scene of the book and not in SCENES;
    the tests also pass rrt_tpu's builder and camera classes, so both
    packages build it with the same calls."""
    b = builder()
    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9),
                                    scale=2.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.sphere((-1.6, 1.0, 0.0), 1.0, b.metal((0.8, 0.8, 0.9), fuzz=0.3))
    b.sphere((1.2, 1.0, 0.5), 1.0, b.dielectric(1.5))
    b.medium_sphere((1.2, 1.0, 0.5), 1.0, density=0.8,
                    albedo=(0.2, 0.4, 0.9))
    b.medium_box((0.0, 0.0, 0.0), (1.2, 1.6, 1.2), density=0.6,
                 albedo=(0.8, 0.5, 0.3), rotate_y_deg=25.0,
                 translate=(-0.8, 0.0, -2.2))
    cam = camera.create(look_from=(0.0, 2.0, 7.0), look_at=(0.0, 0.8, 0.0),
                        fov_deg=40.0, aspect=w / h)
    return b.build(), cam


def mixed_scene(w, h, builder=SceneBuilder, camera=Camera):
    """Spheres, quads, rotated boxes and a quad light together under the
    sky: test data for the kernels' solid-family variants with a BVH to
    seed (a ground sphere the walk always tests, 24 small spheres in its
    tree, a checker texture, metal, glass). Not a scene of the book and
    not in SCENES. The tests also pass rrt_tpu's builder and camera
    classes, so both packages build it with the same calls."""
    b = builder()
    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9),
                                    scale=2.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    mats = (b.lambertian((0.7, 0.3, 0.3)), b.metal((0.8, 0.8, 0.6), fuzz=0.2),
            b.dielectric(1.5))
    for i in range(24):
        b.sphere((1.6 * (i % 6) - 4.0, 0.35, 1.6 * (i // 6) - 2.4), 0.35,
                 mats[i % 3])
    white = b.lambertian((0.73, 0.73, 0.73))
    b.quad((-6.0, 0.0, -4.5), (12.0, 0.0, 0.0), (0.0, 5.0, 0.0), white)
    b.quad((-5.5, 0.2, 3.0), (0.0, 1.5, 0.0), (1.2, 0.0, 0.5),
           b.metal((0.9, 0.9, 0.9), fuzz=0.0), rotate_y_deg=10.0)
    b.box((0.0, 0.0, 0.0), (1.0, 2.0, 1.0), white, rotate_y_deg=30.0,
          translate=(2.7, 0.05, -3.0))
    b.box((0.0, 0.0, 0.0), (0.8, 0.8, 0.8), mats[0], rotate_y_deg=-20.0,
          translate=(-3.3, 0.05, 1.1))
    b.quad((-1.0, 4.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
           b.diffuse_light((6.0, 6.0, 6.0)))
    cam = camera.create(look_from=(0.0, 3.0, 9.0), look_at=(0.0, 0.5, 0.0),
                        fov_deg=45.0, aspect=w / h)
    return b.build(), cam


def many_solids_scene(w, h, moving=False, marble=False, builder=SceneBuilder,
                      camera=Camera):
    """81 boxes rotated about Y and 81 quads, past the SOLID_CAP (64) of
    a family the train kernels loop over, among spheres under the sky
    with a quad light: test data for the forward kernels' walks over the
    solid families' trees. Each cell of a 9 x 9 grid holds a box on the
    ground and a tilted panel above it; moving adds a moving sphere,
    marble a perlin-marble sphere (the kernels' kMoving and kTex
    variants). Not a scene of the book and not in SCENES. The tests also
    pass rrt_tpu's builder and camera classes, so both packages build it
    with the same calls."""
    b = builder()
    ground = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9),
                                    scale=2.0))
    b.sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    mats = (b.lambertian((0.73, 0.73, 0.73)), b.metal((0.8, 0.8, 0.6),
                                                      fuzz=0.2),
            b.lambertian((0.7, 0.3, 0.3)))
    for i in range(9):
        for j in range(9):
            x, z = 1.3 * (i - 4), 1.3 * (j - 4)
            k = (7 * i + 3 * j) % 9
            b.box((0.0, 0.0, 0.0), (0.5, 0.3 + 0.1 * (k % 5), 0.5),
                  mats[(i + j) % 3], rotate_y_deg=10.0 * k - 40.0,
                  translate=(x, 0.0, z))
            b.quad((0.0, 0.0, 0.0), (0.7, 0.0, 0.0), (0.0, 0.25, 0.4),
                   mats[(i + 2 * j) % 3], rotate_y_deg=15.0 * k,
                   translate=(x + 0.35, 1.2 + 0.05 * k, z - 0.2))
    b.sphere((0.0, 2.6, 0.0), 0.6, b.dielectric(1.5))
    b.quad((-2.0, 6.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
           b.diffuse_light((5.0, 5.0, 5.0)))
    if moving:
        b.moving_sphere((3.0, 2.4, 1.0), (3.4, 2.4, 1.0), 0.0, 1.0, 0.5,
                        mats[2])
    if marble:
        b.sphere((-3.0, 2.4, 1.0), 0.6, b.lambertian(b.perlin(scale=4.0)))
    cam = camera.create(look_from=(0.0, 9.0, 11.0), look_at=(0.0, 0.5, 0.0),
                        fov_deg=50.0, aspect=w / h, time0=0.0,
                        time1=1.0 if moving else 0.0)
    return b.build(), cam
