"""The perlin-marble and image textures (simple_light, earth) against
rrt_tpu, on the CPU: the scenes and the atlas, the noise and the
texture values, the uv of spheres and quads, the kernels' plain versions
and the three drivers, the image-on-a-medium route.

The port's kernels and plain versions take a sphere's texture angles
from rrt_tpu's kernel polynomials (geometry.sphere_uv: atan2 within
about 1e-5), rrt_tpu's eager code from exact arccos and arctan2, so a
ray at a texel's edge may read another texel in each; the images are
held by the slice rule (tests/test_torch_slice.py: 98.5% of pixels
within 1e-3, traced totals within 1%), and the uv where no texel edge
lies between the two."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu
import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import geometry as jgeo
from rrt_tpu import render as jrender
from rrt_tpu import scenes as jscenes
from rrt_tpu import textures as jtex
from rrt_tpu.scene import SceneBuilder as JBuilder
from rrt_tpu.vec import V3
from rrt_tpu_torch import geometry, render, textures
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.scene import SceneBuilder, tensor_fields

W, H = 24, 14


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_scenes_and_atlas_equal_rrt_tpu(name):
    """simple_light and earth build rrt_tpu's SceneArrays bit for bit,
    atlas and static flags included, and are in SCENES; the atlas pack
    holds rrt_tpu's channel-major atlas's texels."""
    exp, _ = jscenes.SCENES[name](W, H)
    got, _ = tscenes.SCENES[name](W, H)
    leaves = _leaves(exp)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if f.name in tensor_fields():
            np.testing.assert_array_equal(v.numpy(), leaves[f.name], f.name)
        else:
            assert v == leaves[f.name], f.name
    tex = tmk.pack_textures(got)
    assert (tex.has_perlin, tex.has_images) == (name == "simple_light",
                                                name == "earth")
    j_atlas = np.asarray(jmk.pack_atlas(exp))  # (I*AH, 3*AW)
    n_img, ah, aw = tex.shape
    np.testing.assert_array_equal(
        tex.atlas[:, :3].numpy(),
        j_atlas.reshape(n_img * ah, 3, aw).transpose(0, 2, 1).reshape(-1, 3))
    assert (tex.atlas[:, 3] == 0).all()


def _points(seed=0, n=4096):
    """Seeded points over negative and positive coordinates, a few on
    lattice planes."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-40.0, 40.0, (3, n)).astype(np.float32)
    p[:, :64] = np.round(p[:, :64])
    return p


def test_noise_and_turbulence_match_rrt_tpu():
    """perlin_noise and perlin_turb against rrt_tpu's on seeded points,
    negative coordinates and lattice points among them: the u32 hash
    wraps as numpy's uint32 does (the gradients are equal bit for bit),
    and the values agree within a few f32 ulps (rsqrt's rounding)."""
    p = _points()
    j_scene, _ = jscenes.SCENES["simple_light"](8, 8)
    jp = V3(*map(jnp.asarray, p))
    ix = np.floor(p).astype(np.int32)
    jg = jtex._lattice_grad(*map(jnp.asarray, ix))
    tg = textures.lattice_grad(*torch.from_numpy(ix))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-7)
    tp = torch.from_numpy(p)
    np.testing.assert_allclose(textures.perlin_noise(*tp).numpy(),
                               np.asarray(jtex.perlin_noise(j_scene, jp)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(textures.perlin_turb(*tp).numpy(),
                               np.asarray(jtex.perlin_turb(j_scene, jp)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_texture_value_matches_rrt_tpu(name):
    """texture_value on every texture of the scene at seeded points and
    uv (a marble at negative coordinates; the image's texel at uv away
    from a texel's edge) against rrt_tpu's."""
    j_scene, _ = jscenes.SCENES[name](8, 8)
    scene, _ = tscenes.SCENES[name](8, 8)
    p = _points(1, 2048)
    rng = np.random.default_rng(2)
    n_img, ah, aw = scene.images.shape[:3]
    # Texel centres, jittered well inside the texel.
    u = ((rng.integers(0, aw, 2048) + rng.uniform(0.2, 0.8, 2048)) / aw)
    v = ((rng.integers(0, ah, 2048) + rng.uniform(0.2, 0.8, 2048)) / ah)
    u, v = u.astype(np.float32), v.astype(np.float32)
    for t in range(scene.tex_type.shape[0]):
        tid = np.full(2048, t, np.int32)
        exp = jtex.texture_value(j_scene, jnp.asarray(tid), jnp.asarray(u),
                                 jnp.asarray(v), V3(*map(jnp.asarray, p)))
        got = textures.texture_value(scene, torch.from_numpy(tid),
                                     torch.from_numpy(u), torch.from_numpy(v),
                                     torch.from_numpy(p))
        np.testing.assert_allclose(
            got.numpy(), np.stack([np.asarray(exp.x), np.asarray(exp.y),
                                   np.asarray(exp.z)]),
            rtol=0, atol=2e-5, err_msg=f"texture {t}")


def test_sphere_uv_is_rrt_tpus_kernel_rule():
    """geometry.sphere_uv against rrt_tpu's kernel polynomials
    (_atan2_rows, _acos_rows) within an f32 ulp (XLA's CPU code may fuse
    a multiply-add; the port's kernels, built without contraction, and
    the plain versions agree bit for bit on the card), and against its
    eager exact angles within the polynomial's 1e-5."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    c = np.array([[0.5], [-1.0], [2.0]], np.float32)
    r = np.float32(2.0)
    p = (c + r * d).astype(np.float32)
    u, v = geometry.sphere_uv(torch.from_numpy(p), torch.from_numpy(c),
                              torch.tensor(r))
    inv = 1.0 / np.maximum(np.abs(r), np.float32(1e-20))
    uo = [jnp.asarray((p[k] - c[k]) * inv) for k in range(3)]
    theta = jmk._acos_rows(jnp.clip(-uo[1], -1.0, 1.0))
    phi = jmk._atan2_rows(-uo[2], uo[0]) + jnp.pi
    np.testing.assert_allclose(u.numpy(), np.asarray(phi * (0.5 / jnp.pi)),
                               rtol=0, atol=6e-8)
    np.testing.assert_allclose(v.numpy(), np.asarray(theta * (1.0 / jnp.pi)),
                               rtol=0, atol=6e-8)
    exact_u = (np.arctan2(-uo[2], uo[0]) + np.pi) / (2 * np.pi)
    np.testing.assert_allclose(u.numpy(), exact_u, rtol=0, atol=1e-5)


def _quad_scene(builder):
    b = builder()
    img = np.random.default_rng(5).uniform(0, 1, (4, 8, 3)).astype(
        np.float32)
    b.quad((-1.0, -1.0, 0.0), (2.0, 0.0, 0.3), (0.2, 2.0, 0.0),
           b.lambertian(b.image(img)), rotate_y_deg=20.0)
    b.sphere((0.0, 0.0, -5.0), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    return b.build()


def test_quad_uv_matches_rrt_tpu():
    """make_hit's quad uv (alpha and beta on the winner's frame, the
    kernels' rows) against rrt_tpu's eager make_hit on rays that hit the
    quad, within 1e-5; a sphere's hit keeps its sphere uv."""
    scene, j_scene = _quad_scene(SceneBuilder), _quad_scene(JBuilder)
    rng = np.random.default_rng(6)
    n = 512
    o = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                  np.full(n, 4.0)]).astype(np.float32)
    d = np.tile(np.array([[0.05], [0.02], [-1.0]], np.float32), (1, n))
    t, fam, idx = geometry.intersect_all(scene, torch.from_numpy(o),
                                         torch.from_numpy(d), None, 1e-3,
                                         geometry.INF)
    assert (fam == geometry.FAM_QUAD).float().mean() > 0.5
    hit = geometry.make_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                            torch.zeros(n), t, fam, idx)
    jo, jd = V3(*map(jnp.asarray, o)), V3(*map(jnp.asarray, d))
    j_hit = jgeo.make_hit(j_scene, jo, jd, jnp.zeros(n), jnp.asarray(
        t.numpy()), jnp.asarray(fam.numpy().astype(np.int32)),
        jnp.asarray(idx.numpy().astype(np.int32)))
    quad = (fam == geometry.FAM_QUAD).numpy()
    np.testing.assert_allclose(hit.u.numpy()[quad], np.asarray(j_hit.u)[quad],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(hit.v.numpy()[quad], np.asarray(j_hit.v)[quad],
                               rtol=0, atol=1e-5)


def _j_image(name, spp, depth):
    j_scene, j_cam = jscenes.SCENES[name](W, H)
    cfg = rrt_tpu.RenderConfig(width=W, height=H, spp=spp, max_depth=depth,
                               tile_pixels=4096, samples_per_pass=spp)
    img, n = jrender.render_image(j_scene, j_cam, cfg, 0)
    return np.asarray(img), int(n)


@pytest.fixture(scope="module")
def reference_images():
    return {name: _j_image(name, 2, 8) for name in ("simple_light", "earth")}


def _slice_rule(img, ref, n, n_ref):
    close = (np.abs(img - ref).max(axis=-1) < 1e-3).mean()
    assert close >= 0.985, close
    assert abs(n - n_ref) / n_ref < 1e-2, (n, n_ref)


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_drivers_match_rrt_tpu(name, reference_images):
    """The tile driver (render_tiles' plain version), the queue driver
    (bounce_steps') and the batch driver (intersect_only's, with the
    eager shading) render the same image within 1e-5 and the same
    traced count, and match rrt_tpu's render_image by the slice rule;
    the image is lit (earth's everywhere, simple_light's where its paths
    reach a light)."""
    scene, cam = tscenes.SCENES[name](W, H)
    cfg = render.RenderConfig(width=W, height=H, spp=2, max_depth=8,
                              samples_per_pass=2)
    tile, n_tile = render.render_image_tiles(scene, cam, cfg, 0, device="cpu")
    queue, n_queue = render.render_image_queue(scene, cam, cfg, 0,
                                               device="cpu")
    batch, n_batch = render.render_image(scene, cam, cfg, 0, device="cpu")
    for img, n in ((queue, n_queue), (batch, n_batch)):
        torch.testing.assert_close(img, tile, rtol=1e-5, atol=1e-5)
        assert int(n) == int(n_tile)
    ref, n_ref = reference_images[name]
    _slice_rule(tile.numpy(), ref, int(n_tile), n_ref)
    lit = (tile.amax(dim=2) > 0).float().mean()
    assert lit > (0.9 if name == "earth" else 0.05), lit


@pytest.mark.parametrize("name", ["simple_light", "earth"])
def test_plain_kernels_trace_the_eager_paths(name):
    """bounce_steps' plain version (from the packs, the TexPack's atlas
    and flags) against the eager _bounce on the scene itself: the same
    lanes alive, the same counts, throughput and radiance equal after 4
    steps from the camera."""
    from rrt_tpu_torch import rng
    scene, cam = tscenes.SCENES[name](W, H)
    n = W * H
    ids = torch.arange(n)
    keys = rng.sample_keys(rng.key_words(0), ids, 0)
    o, d, tm = render.generate_rays(cam, ids % W, ids // W, W, H, keys)
    one, zero = torch.ones(n), torch.zeros(n)
    st = tmk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                        one, zero)
    kw = dict(k_steps=4, max_depth=8, t_min=1e-3, moving=False,
              solids=tmk.pack_solids(scene), tex=tmk.pack_textures(scene))
    out = tmk.bounce_steps(st.clone(), rng.u32_bits(keys),
                           tmk.pack_spheres_full(scene), tmk.pack_bg(scene),
                           **kw)
    thr, rad, alive = torch.ones_like(o), torch.zeros_like(o), one > 0
    for bounce in range(4):
        b = render._bounce(scene, o, d, tm, keys, bounce, alive, 1e-3, 8)
        rad = rad + thr * b.contribution * alive
        thr = torch.where(b.survives, thr * b.scatter.attenuation, thr)
        alive = b.survives
        o, d = b.new_o, b.new_d
    assert torch.equal(out[14] > 0.5, alive)
    torch.testing.assert_close(out[10:13], rad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out[7:10][:, alive], thr[:, alive], rtol=1e-6,
                               atol=1e-6)


def _medium_image_scene(builder):
    b = builder()
    img = np.random.default_rng(8).uniform(0.1, 0.9, (4, 8, 3)).astype(
        np.float32)
    b.medium_sphere((0.0, 0.0, 0.0), 1.0, 2.0, b.image(img))
    b.sphere((0.0, -101.0, 0.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    return b.build()


def test_image_on_a_medium_takes_the_eager_route():
    """A medium whose albedo is an image: on the CPU the batch driver
    shades it as rrt_tpu's eager code does (the image at uv 0) and
    matches rrt_tpu's render_image; the tile and queue drivers, and any
    route on a CUDA device, raise before any launch naming the ROADMAP
    decision."""
    from rrt_tpu.camera import Camera as JCamera
    from rrt_tpu_torch import convert
    j_scene = _medium_image_scene(JBuilder)
    scene = _medium_image_scene(SceneBuilder)
    assert scene.has_images_on_media
    j_cam = JCamera.create(look_from=(0.0, 0.5, 5.0),
                           look_at=(0.0, 0.0, 0.0), fov_deg=30.0,
                           aspect=W / H)
    cam = convert.camera_from_numpy(_leaves(j_cam))
    cfg = render.RenderConfig(width=W, height=H, spp=2, max_depth=8,
                              samples_per_pass=2)
    img, n = render.render_image(scene, cam, cfg, 0, device="cpu")
    ref, n_ref = jrender.render_image(j_scene, j_cam, rrt_tpu.RenderConfig(
        width=W, height=H, spp=2, max_depth=8, tile_pixels=4096,
        samples_per_pass=2), 0)
    _slice_rule(img.numpy(), np.asarray(ref), int(n), int(n_ref))
    match = 'ROADMAP "Not ported by decision"'
    for fn in (render.render_image_tiles, render.render_image_queue):
        with pytest.raises(NotImplementedError, match=match):
            fn(scene, cam, cfg, 0, device="cpu")
    for fn in (render.render_image, render.render_image_diff):
        with pytest.raises(NotImplementedError, match=match):
            fn(scene, cam, cfg, 0, device="cuda")
