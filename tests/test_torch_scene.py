"""rrt_tpu_torch scenes, conversion and packs against rrt_tpu.

Scene arrays reproduce the reference's f32 draw order, so they must
equal rrt_tpu's exactly, as must the sphere and background packs. The
camera pack derives the frame through tan/rsqrt/cross, whose last bits
may differ between XLA and PyTorch: it compares within 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import scenes as jscenes
from rrt_tpu_torch import convert, scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.scene import SceneBuilder, tensor_fields
from rrt_tpu_torch.xoshiro import Xoshiro128Plus

SCENE_NAMES = ["diffuse", "chap11", "chap12"]
W, H = 48, 32


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _assert_scene_equal(got, exp_leaves):
    for name in tensor_fields():
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), exp_leaves[name], err_msg=name)
        assert getattr(got, name).numpy().dtype == exp_leaves[name].dtype, \
            name
    for f in dataclasses.fields(got):
        if f.name not in tensor_fields():
            assert getattr(got, f.name) == exp_leaves[f.name], f.name


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scene_arrays_equal_reference(name):
    exp, _ = jscenes.SCENES[name](W, H)
    got, _ = tscenes.SCENES[name](W, H)
    _assert_scene_equal(got, _leaves(exp))


def test_chap12_layout_checksums():
    """The checksums tests/test_scenes.py pins for rrt_tpu."""
    scene, _ = tscenes.chap12_scene(120, 80)
    valid = scene.sphere_valid.numpy()
    assert int(valid.sum()) == 484
    assert scene.n_spheres == 512
    c0 = scene.sphere_c0.numpy()[valid].astype(np.float64)
    r = scene.sphere_radius.numpy()[valid].astype(np.float64)
    assert np.float32(c0.sum()) == np.float32(-971.883056640625)
    assert np.float32(r.sum()) == np.float32(1099.0)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_convert_matches_own_build(name):
    ref_scene, ref_cam = jscenes.SCENES[name](W, H)
    own_scene, own_cam = tscenes.SCENES[name](W, H)
    _assert_scene_equal(convert.scene_from_numpy(_leaves(ref_scene)),
                        {k: (v.numpy() if isinstance(v, torch.Tensor)
                             else v)
                         for k, v in dataclasses.asdict(own_scene).items()})
    cam = convert.camera_from_numpy(_leaves(ref_cam))
    for f in dataclasses.fields(cam):
        assert torch.equal(getattr(cam, f.name), getattr(own_cam, f.name))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_packs_match_reference(name):
    j_scene, j_cam = jscenes.SCENES[name](W, H)
    t_scene, t_cam = tscenes.SCENES[name](W, H)
    np.testing.assert_array_equal(tmk.pack_spheres_full(t_scene).numpy(),
                                  np.asarray(jmk.pack_spheres_full(j_scene)))
    np.testing.assert_array_equal(tmk.pack_bg(t_scene).numpy(),
                                  np.asarray(jmk.pack_bg(j_scene)))
    np.testing.assert_allclose(tmk.pack_camera(t_cam, W, H).numpy(),
                               np.asarray(jmk.pack_camera(j_cam, W, H)),
                               rtol=1e-6, atol=1e-6)


def test_xoshiro_seed_zero_stream():
    """The seed-0 stream that tests/test_scenes.py pins."""
    rng = Xoshiro128Plus(0)
    assert tuple(rng.next_u32() for _ in range(4)) == (
        0xE9966C19, 0xB8F8985E, 0xC3536FC5, 0x97D6A8F6)


def _texture_case(kind, b):
    """A scene of the texture builders (rrt_tpu's or the port's
    SceneBuilder `b`): perlin marbles, images onto one atlas grid (a
    smaller image resampled, nearest or bilinear), an image-textured box
    (the books' six quads), an image on a medium."""
    rng = np.random.default_rng(7)
    big = rng.uniform(0.0, 1.0, (6, 10, 3)).astype(np.float32)
    small = rng.uniform(0.0, 1.0, (3, 4, 3)).astype(np.float32)
    if kind in ("perlin", "perlin_scaled"):
        tex = b.perlin() if kind == "perlin" else b.perlin(scale=4.0)
        b.sphere((0.0, 1.0, 0.0), 1.0, b.lambertian(tex))
        b.sphere((0.0, -100.0, 0.0), 100.0, b.metal(tex, fuzz=0.2))
    elif kind in ("image_nearest", "image_bilinear"):
        resample = kind.split("_")[1]
        b.sphere((0.0, 1.0, 0.0), 1.0, b.lambertian(b.image(big)))
        b.sphere((2.0, 1.0, 0.0), 1.0,
                 b.lambertian(b.image(small, resample=resample)))
    elif kind == "image_textured_box":
        mat = b.lambertian(b.image(big))
        b.box((0.0, 0.0, 0.0), (1.0, 2.0, 3.0), mat, rotate_y_deg=15.0,
              translate=(1.0, 0.0, -2.0))
        b.box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), b.lambertian((0.5, 0.5, 0.5)))
    else:  # image_on_medium
        b.medium_sphere((0.0, 0.0, 0.0), 1.0, 0.5, b.image(small))
        b.sphere((0.0, 1.0, 0.0), 1.0, b.lambertian(b.image(big)))
    return b.build()


# The perlin and image builders, once NotImplementedError (ROADMAP Queue A
# #9.5, first part), build rrt_tpu's layout.
@pytest.mark.parametrize("kind", ["perlin", "perlin_scaled", "image_nearest",
                                  "image_bilinear", "image_textured_box",
                                  "image_on_medium"])
def test_texture_builders_build_rrt_tpus_layout(kind):
    """Every SceneArrays field, the atlas and the static flags (has_perlin,
    has_images, has_images_on_media) equal rrt_tpu's bit for bit."""
    from rrt_tpu.scene import SceneBuilder as JBuilder
    got = _texture_case(kind, SceneBuilder())
    exp = _texture_case(kind, JBuilder())
    _assert_scene_equal(got, _leaves(exp))
    assert got.has_perlin == kind.startswith("perlin")
    assert got.has_images == kind.startswith("image")
    assert got.has_images_on_media == (kind == "image_on_medium")
    if kind == "image_textured_box":
        assert (got.n_quads_active, got.n_boxes_active) == (6, 1)


def test_resample_image_matches_rrt_tpu():
    """resample_image onto larger and smaller grids, nearest and
    bilinear, and the identity, bit for bit against rrt_tpu's."""
    from rrt_tpu.scene import resample_image as j_resample
    from rrt_tpu_torch.scene import resample_image
    im = np.random.default_rng(1).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    for ah, aw in ((5, 7), (8, 16), (3, 4), (11, 5)):
        for method in ("nearest", "bilinear"):
            np.testing.assert_array_equal(resample_image(im, ah, aw, method),
                                          j_resample(im, ah, aw, method))
    with pytest.raises(ValueError):
        SceneBuilder().image(im, resample="cubic")


def test_checker_and_solid_background_build():
    """Builders outside the canned scenes but inside the kernel scope
    produce rrt_tpu's layout."""
    from rrt_tpu.scene import SceneBuilder as JBuilder
    arrays = []
    for builder in (SceneBuilder(), JBuilder()):
        tex = builder.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
        builder.sphere((0.0, -1000.0, 0.0), 1000.0, builder.lambertian(tex))
        builder.sphere((0.0, 1.0, 0.0), 1.0, builder.metal((0.7, 0.6, 0.5),
                                                           fuzz=0.1))
        builder.solid_background((0.1, 0.2, 0.3))
        arrays.append(builder.build())
    _assert_scene_equal(arrays[0], _leaves(arrays[1]))
