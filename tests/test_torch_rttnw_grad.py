"""The RTTNW final scene's gradient through the train kernels' plain
versions against rrt_tpu, on the CPU (tests/test_torch_rttnw.py holds
its forward, tests/test_torch_rttnw_train.py the plain train versions'
winners, route and rebuild).

rttnw_final's 400 ground boxes pass SOLID_CAP: train_fwd walks their
tree and train_bwd loops over them, and their winner codes take
CODE_SPAN slots a family (BOX_CODE + 399 on this scene). The codes
round-trip at each family's last slot and equal csrc/bounce.cuh's, and
a family past them raises before any launch; and trace_tiles_diff
matches rrt_tpu's trace_batch(differentiable=True) under jax.vjp with
explicit keys (tests/test_torch_cornell_train_grad.py's pattern) at
16x8, 1 spp, depth 8, each ground box past slot 63 with an albedo of
its own (the same render), weighting out the pixels that part also
under a grey background (the scene's is black; at most 5% may part):
box_center, box_half, tex_color1, sphere_c0 and bg_bottom within 2e-3
of each field's largest gradient, and boxes past slot 63 with nonzero
albedo gradients in both packages; and, under the RTIOW sky with the
marble made solid and the camera looking down among the spheres
(_sky), boxes past slot 63 with nonzero position gradients in
rrt_tpu, the port's the same within 2e-3. A sphere's texture uv
is rrt_tpu's kernel polynomial rule in the port (geometry.sphere_uv),
so the pixels whose texel parts from rrt_tpu's eager atan2 and acos are
among those weighted out. rrt_tpu's side is computed once, in a module
fixture that jits rrt_tpu's radiance once for both configurations."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrt_tpu import diff as jdiff
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays as jgenerate_rays
from rrt_tpu.render import trace_batch as jtrace_batch
from rrt_tpu_torch import convert, diff, geometry, render
from rrt_tpu_torch import scenes as tscenes
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_train as tmkt
from rrt_tpu_torch.scene import BG_SKY, TEX_PERLIN, TEX_SOLID

import _torch_helpers as helpers

W, H, SPP, DEPTH = 16, 8, 1, 8
T_MIN = 1e-3
FIELDS = ("box_center", "box_half", "tex_color1", "sphere_c0", "bg_bottom")
# _sky's camera (look_from, look_at): down at the ground among the glass,
# metal and subsurface spheres.
SKY_CAMERA = ((130.0, 500.0, -400.0), (130.0, 150.0, 100.0))
MIX = np.array([1.0, 0.7, 0.3], np.float32)


# ---------------------------------------------------------------------------
# The winner codes
# ---------------------------------------------------------------------------


def _header_codes() -> dict:
    """kCodeSpan, kQuadCode, kBoxCode and kMediumCode as csrc/bounce.cuh
    declares them, its expressions evaluated in order."""
    text = (Path(tmk.__file__).parent / "csrc" / "bounce.cuh").read_text()
    names = {}
    for decl in re.findall(r"constexpr int (k(?:CodeSpan|QuadCode)[^;]*);",
                           text):
        for part in decl.split(","):
            name, expr = (s.strip() for s in part.split("="))
            names[name] = eval(expr, {"__builtins__": {}}, dict(names))
    return names


def test_winner_codes_equal_the_headers():
    """The Python codes are the ones the kernels write and read."""
    codes = _header_codes()
    assert codes == {"kCodeSpan": tmk.CODE_SPAN, "kQuadCode": tmk.QUAD_CODE,
                     "kBoxCode": tmk.BOX_CODE,
                     "kMediumCode": tmk.MEDIUM_CODE}
    assert tmk.QUAD_CODE == tmk.MAX_SLOTS
    assert tmk.CODE_SPAN > 400  # rttnw_final's ground boxes


def test_winner_codes_round_trip_at_each_familys_last_slot():
    """Each family's last slot fits an int16 and decodes to its family
    and slot; -1 (a miss) and -2 (nothing stored) decode to no family."""
    last = tmk.CODE_SPAN - 1
    fam = torch.tensor([geometry.FAM_SPHERE, geometry.FAM_QUAD,
                        geometry.FAM_BOX, geometry.FAM_MEDIUM,
                        geometry.FAM_BOX, geometry.FAM_NONE])
    idx = torch.tensor([tmk.MAX_SLOTS - 1, last, last, last, 399, 0])
    code = tmk.encode_winner(fam, idx)
    assert code.tolist() == [tmk.QUAD_CODE - 1, tmk.BOX_CODE - 1,
                             tmk.MEDIUM_CODE - 1, tmk.MEDIUM_CODE + last,
                             tmk.BOX_CODE + 399, -1]
    assert int(code.max()) <= torch.iinfo(torch.int16).max
    f2, i2 = tmk.decode_winner(torch.cat([code, torch.tensor([-2])]).to(
        torch.int16))
    assert f2.tolist() == fam.tolist() + [geometry.FAM_NONE]
    assert i2.tolist() == idx.tolist()[:5] + [-1, -2]


def test_families_past_the_codes_or_the_shared_memory_raise():
    """A family past CODE_SPAN slots raises before any launch: check_codes
    alone, and the train wrappers, which call it before they choose
    between the kernels and the plain versions. What a train kernel
    stages past what a block may opt into raises too; csrc/train.cu
    sizes it (rrt_train_blocks), so that raise is held on the card
    (tests/test_torch_cuda.py
    ::test_train_smem_past_the_opt_in_raises_before_launch,
    rttnw_final's 55,392 and 45,620 bytes in
    ::test_walk_train_fwd_equals_tile_render)."""
    scene, cam = tscenes.SCENES["rttnw_final"](W, H)
    solids = tmk.pack_solids(scene)
    past = dataclasses.replace(solids, n_boxes=tmk.CODE_SPAN + 1)
    with pytest.raises(NotImplementedError, match="winner codes"):
        tmk.check_codes(past)
    tmk.check_codes(solids)
    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    packs = render._packs(scene, cam, cfg, "cpu")
    kw = dict(seed_words=(0, 0), sample_lo=0, width=W, height=H, spp=SPP,
              max_depth=DEPTH, t_min=T_MIN, moving=True, solids=past,
              tex=tmk.pack_textures(scene))
    with pytest.raises(NotImplementedError, match="winner codes"):
        tmkt.render_tiles_train(*packs, **kw)
    lengths = torch.zeros((SPP, W * H), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="winner codes"):
        tmkt.tiles_adjoint(*packs, torch.zeros((W * H, 3)), lengths, None,
                           **kw)


# ---------------------------------------------------------------------------
# The gradient against rrt_tpu's scan
# ---------------------------------------------------------------------------


def _box_albedos(leaves: dict, first: int):
    """rttnw_final's numpy leaves with each ground box from slot `first`
    on given a material and a texture of its own, copies of the ones it
    had (so the same render): (the leaves, the first new texture row),
    tex_color1's rows from there on those boxes' albedos in slot
    order."""
    out = dict(leaves)
    slots = np.arange(first, int(leaves["n_boxes_active"]))
    mats = leaves["box_mat"][slots]
    texs = leaves["mat_tex"][mats]
    n_mat, n_tex = len(leaves["mat_type"]), len(leaves["tex_type"])
    for f in ("mat_type", "mat_fuzz", "mat_ior"):
        out[f] = np.concatenate([leaves[f], leaves[f][mats]])
    for f in ("tex_type", "tex_color1", "tex_color2", "tex_scale",
              "tex_image"):
        out[f] = np.concatenate([leaves[f], leaves[f][texs]])
    dtype = leaves["mat_tex"].dtype
    out["mat_tex"] = np.concatenate(
        [leaves["mat_tex"], (n_tex + np.arange(len(slots))).astype(dtype)])
    out["box_mat"] = leaves["box_mat"].copy()
    out["box_mat"][slots] = n_mat + np.arange(len(slots))
    return out, n_tex


def _sky(leaves: dict, cam: dict):
    """The sky configuration of rttnw_final's numpy leaves and camera
    leaves: the RTIOW sky (white to (0.5, 0.7, 1)), the marble made a
    solid texture of its colour, and the camera at SKY_CAMERA. A
    lambertian box's bounce to a glass, metal or lambertian sphere and
    on to the sky gives the box's position a gradient, which the
    scene's black background does not. The marble is left out because
    its turbulence, at these coordinates, turns last-bit differences of
    a hit point into percent-level differences of its gradient: at 16x8
    on the CPU a 1e-3 shift of the camera (16 float32 ulps at 600) moved
    the port's own sphere_c0 gradient of the marble by 15% at one pixel
    and flipped its sign at another, and rrt_tpu's parted from the
    port's by 2-7% at two agreeing pixels (where the port's train plain
    versions and its autograd scan agree within 4e-6)."""
    leaves = dict(leaves, bg_mode=np.asarray(BG_SKY, leaves["bg_mode"].dtype),
                  bg_bottom=np.ones(3, np.float32),
                  bg_top=np.asarray([0.5, 0.7, 1.0], np.float32))
    leaves["tex_type"] = np.where(leaves["tex_type"] == TEX_PERLIN,
                                  TEX_SOLID, leaves["tex_type"]).astype(
        leaves["tex_type"].dtype)
    cam = dict(cam, **{k: np.asarray(v, np.float32)
                       for k, v in zip(("look_from", "look_at"),
                                       SKY_CAMERA)})
    return leaves, cam


@pytest.fixture(scope="module")
def gradients():
    """Both packages' radiance and field gradients on rttnw_final at W x
    H, SPP spp, depth DEPTH, each ground box past slot 63 with an albedo
    of its own (_box_albedos), the loss sum(sin(0.1 i) MIX . radiance)
    over the pixels that agree within 1e-3: with the scene's black
    background, its pixels agreeing also under a grey one, {"agree",
    "port", "ref", "own": the first of the boxes' own tex_color1 rows,
    "same": whether the port renders the scene with and without the
    boxes' own albedos alike}; and under _sky, {"sky": {"agree", "port",
    "ref"}}. rrt_tpu's radiance is jitted once for both."""
    j_base, j_cam = jscenes.SCENES["rttnw_final"](W, H)
    leaves, own = _box_albedos(helpers.leaves(j_base), tmk.SOLID_CAP)
    cam_leaves = helpers.leaves(j_cam)
    j_scene = dataclasses.replace(j_base, **{
        k: jnp.asarray(v) for k, v in leaves.items()
        if isinstance(getattr(j_base, k), jax.Array)})
    ids = jnp.arange(W * H, dtype=jnp.int32)
    px, py = ids % W, ids // W

    @jax.jit
    def j_rad(params, tex_type, bg_mode, camera):
        s = jdiff.combine(dataclasses.replace(
            j_scene, tex_type=tex_type, bg_mode=bg_mode), params)
        tot = jnp.zeros((W * H, 3), jnp.float32)
        for samp in range(SPP):
            keys = jrng.sample_keys(jax.random.key(0),
                                    (py * W + px).astype(jnp.uint32), samp)
            o, d, tm = jgenerate_rays(camera, px, py, W, H, keys)
            r, _ = jtrace_batch(s, o, d, tm, keys, DEPTH, T_MIN,
                                differentiable=True)
            tot = tot + jnp.stack([r.x, r.y, r.z], axis=-1)
        return tot

    cfg = render.RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)

    def both(leaves, cam_leaves, grey=None):
        """The two packages on one configuration: (agree, port, ref, the
        port's radiance)."""
        j_params = jdiff.partition(dataclasses.replace(j_scene, **{
            k: jnp.asarray(leaves[k]) for k in ("bg_bottom", "bg_top")}))
        rest = (jnp.asarray(leaves["tex_type"]),
                jnp.asarray(leaves["bg_mode"]),
                dataclasses.replace(j_cam, **{
                    k: jnp.asarray(v) for k, v in cam_leaves.items()}))
        ref, vjp = jax.vjp(lambda p: j_rad(p, *rest), j_params)
        ref = np.asarray(ref)
        scene = convert.scene_from_numpy(leaves)
        cam = convert.camera_from_numpy(cam_leaves)
        params, _ = helpers.grad_leaves(scene, cam)
        rad, _ = render.trace_tiles_diff(diff.combine(scene, params), cam,
                                         cfg, 0, device="cpu")
        agree = (np.abs(rad.detach().numpy() - ref) < 1e-3).all(axis=1)
        if grey is not None:
            g = {k: np.full(3, grey, np.float32)
                 for k in ("bg_bottom", "bg_top")}
            lit = np.asarray(j_rad(dict(j_params, **{
                k: jnp.asarray(v) for k, v in g.items()}), *rest))
            lit_t, _ = render.trace_tiles(diff.combine(scene, {
                k: torch.from_numpy(v) for k, v in g.items()}), cam, cfg, 0,
                device="cpu")
            agree &= (np.abs(lit_t.numpy() - lit) < 1e-3).all(axis=1)
        wm = (np.sin(np.arange(W * H) * 0.1)[:, None] * MIX
              * agree[:, None]).astype(np.float32)
        (gj,) = vjp(jnp.asarray(wm))
        gs = torch.autograd.grad(rad, list(params.values()),
                                 torch.from_numpy(wm), allow_unused=True)
        port = {k: np.zeros(v.shape, np.float32) if g is None else g.numpy()
                for (k, v), g in zip(params.items(), gs)}
        return agree, port, {k: np.asarray(v) for k, v in gj.items()}, rad

    agree, port, ref, rad = both(leaves, cam_leaves, grey=0.5)
    base, _ = render.trace_tiles(
        convert.scene_from_numpy(helpers.leaves(j_base)),
        convert.camera_from_numpy(cam_leaves), cfg, 0, device="cpu")
    sky = dict(zip(("agree", "port", "ref"),
                   both(*_sky(leaves, cam_leaves))[:3]))
    return {"agree": agree, "port": port, "own": own, "ref": ref,
            "same": torch.equal(rad.detach(), base), "sky": sky}


def test_trace_tiles_diff_matches_rrt_tpu(gradients):
    """trace_tiles_diff (train_fwd's and train_bwd's plain versions)
    against rrt_tpu's differentiable scan: at least 95% of pixels agree,
    and each compared field lies within 2e-3 of its largest gradient
    (taken no smaller than 1e-4). rttnw_final's glass, metal and media
    turn a last-bit difference into another path more often than
    cornell's walls do: 3 of the 128 pixels part (one path through the
    glass sphere's subsurface medium, one through the fog, one among the
    lambertian spheres); the gate allows twice that. The albedos and the
    background get gradients; the geometry does not in either package
    (the ground's albedo is solid and the background black, so a box's
    or a sphere's position reaches the radiance only through the
    marble's texture at a later hit, which no agreeing path at this size
    reaches), and is held to 0 in both; _sky's configuration gives it
    one (test_box_geometry_past_the_cap_matches_rrt_tpu_under_a_sky)."""
    agree = gradients["agree"]
    assert agree.mean() >= 0.95, agree.mean()
    assert gradients["same"]
    for k in FIELDS:
        a, b = gradients["port"][k], gradients["ref"][k]
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
    for k in ("tex_color1", "bg_bottom"):
        assert np.abs(gradients["ref"][k]).max() > 0, k


def test_boxes_past_the_cap_get_gradients(gradients):
    """Ground boxes past slot 63, which the train kernels looped over at
    most SOLID_CAP of before, get albedo gradients (each box its own
    albedo: _box_albedos), nonzero for some box in both packages and
    within 2e-3 of the largest; rrt_tpu's and the port's nonzero boxes
    are the same ones."""
    rows = {side: gradients[side]["tex_color1"][gradients["own"]:]
            for side in ("port", "ref")}
    hit = {side: np.abs(g).max(axis=1) > 0 for side, g in rows.items()}
    assert hit["ref"].any() and np.array_equal(hit["port"], hit["ref"])
    np.testing.assert_allclose(rows["port"], rows["ref"], rtol=0,
                               atol=2e-3 * np.abs(rows["ref"]).max())




def test_box_geometry_past_the_cap_matches_rrt_tpu_under_a_sky(gradients):
    """Under _sky, ground boxes past slot 63 get position gradients in
    rrt_tpu (box_center and box_half: the box's top face moves the next
    bounce's origin, and a sphere's normal there turns it toward another
    part of the sky), and the port gives the same boxes the same within
    2e-3 of each field's largest, as it gives the spheres, albedos and
    sky theirs. On the CPU 6 of the 128 pixels part (the glass
    and media of the first configuration); the gate allows twice that."""
    sky = gradients["sky"]
    assert sky["agree"].mean() >= 1.0 - 12 / 128, sky["agree"].mean()
    for k in FIELDS + ("sphere_radius", "bg_top"):
        a, b = sky["port"][k], sky["ref"][k]
        assert np.isfinite(a).all(), k
        atol = 2e-3 * max(np.abs(b).max(), 1e-4)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)
    for k in ("box_center", "box_half"):
        rows = {side: np.abs(sky[side][k][tmk.SOLID_CAP:]).max(axis=1) > 0
                for side in ("port", "ref")}
        assert rows["ref"].any(), k
        assert np.array_equal(rows["port"], rows["ref"]), k
