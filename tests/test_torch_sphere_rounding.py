"""One bounce of the port's plain bounce_steps against rrt_tpu's
_bounce_megakernel (its Pallas kernel in interpret mode, as
tests/test_torch_queue.py runs it) on 512 of rttnw_final's camera rays
that hit spheres: where the two part, and by how much.

ROADMAP Queue C: on rttnw_final the port's bounce_steps kernel parts
from its plain version on sphere-hit lanes. The question was whether
the plain version's sphere shading rounds otherwise than a kernel's.
Against rrt_tpu's kernel the answer is no use: that kernel parts from
the plain version on every sphere-hit lane, by its own arithmetic (its
hit distance's rounding: up to 5.5e-5 of t, the median 5.5e-7; its
scatter directions up to 5.4e-3), far past the rounding that parts the
port's kernel from its plain version; so rrt_tpu's kernel cannot name
that operation. What holds: every lane's decisions (alive, bounce,
traced) agree, the hit distances agree to rounding at the median, and
the throughput agrees within 1e-3 on every lane whose texture is not
the perlin marble, whose turbulence turns the hit point's last digits
into percent-level albedo differences (Queue C, the marble's entry)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rrt_tpu.ops.megakernel as jmk
from rrt_tpu import rng as jrng
from rrt_tpu import scenes as jscenes
from rrt_tpu.camera import generate_rays
from rrt_tpu.scene import TEX_PERLIN
from rrt_tpu.vec import V3
from rrt_tpu_torch import convert
from rrt_tpu_torch.geometry import FAM_SPHERE
from rrt_tpu_torch.ops import megakernel as tmk

from _torch_helpers import interpret_pallas  # noqa: F401 (a fixture)

W, H, LANES = 96, 64, 512


def test_one_bounce_on_sphere_hits_against_rrt_tpus_kernel(interpret_pallas):
    j_scene, j_cam = jscenes.SCENES["rttnw_final"](W, H)
    t_scene = convert.scene_from_numpy(
        {f.name: np.asarray(getattr(j_scene, f.name))
         for f in dataclasses.fields(j_scene)})
    n = W * H
    ids = jnp.arange(n, dtype=jnp.int32)
    px, py = ids % W, ids // W
    keys = jrng.sample_keys(jax.random.key(0), (py * W + px).astype(
        jnp.uint32), 0)
    o, d, tm = generate_rays(j_cam, px, py, W, H, keys)
    st = jmk.pack_state(o, d, tm, V3.ones((n,)), V3.zeros((n,)),
                        jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool),
                        jnp.zeros((n,)))
    state = torch.from_numpy(np.array(st))
    kbits = torch.from_numpy(np.asarray(keys).view(np.int32).copy())
    sph, bg = tmk.pack_spheres_full(t_scene), tmk.pack_bg(t_scene)
    solids, tex = tmk.pack_solids(t_scene), tmk.pack_textures(t_scene)
    t, fam, idx = tmk.intersect_only_reference(
        state[0:3].contiguous(), state[3:6].contiguous(), sph, t_min=1e-3,
        time=state[6].contiguous(), solids=solids, keys=kbits,
        bounce=torch.zeros(n, dtype=torch.int32))
    hits = torch.nonzero((fam == FAM_SPHERE) & (t < 1e30))[:, 0]
    assert hits.numel() >= LANES
    sel = hits[:LANES]
    lanes = sel.numpy()
    ref = np.asarray(jmk.bounce_steps(
        st[:, lanes], keys[:, lanes], jmk.pack_spheres_full(j_scene),
        jmk.pack_quads_full(j_scene), jmk.pack_media(j_scene),
        jmk.pack_bg(j_scene), atlas=jmk.pack_atlas(j_scene),
        boxes24=jmk.pack_boxes_full(j_scene), k_steps=1,
        moving=j_scene.has_moving, has_quads=True, has_boxes=True,
        has_rot_boxes=True, has_perlin=True, has_images=True,
        img_ah=j_scene.images.shape[1], img_aw=j_scene.images.shape[2],
        n_media=j_scene.n_media_active, max_depth=50, t_min=1e-3,
        fam_n=j_scene.fam_n))
    out = tmk.bounce_steps_reference(
        state[:, sel].contiguous(), kbits[:, sel].contiguous(), sph, bg,
        k_steps=1, max_depth=50, t_min=1e-3, moving=True, solids=solids,
        tex=tex).numpy()
    # The decisions: every lane scatters (or not), and counts, alike.
    for row in (13, 14, 15):
        np.testing.assert_array_equal(out[row], ref[row])
    # The hit distance each implies on its ray's largest axis: rounding at
    # the median, rrt_tpu's kernel's own arithmetic at the largest.
    o0, d0 = state[0:3, sel].numpy(), state[3:6, sel].numpy()
    axis = np.argmax(np.abs(d0), axis=0)
    col = np.arange(LANES)
    t_plain = t[sel].numpy()
    t_ref = (ref[axis, col] - o0[axis, col]) / d0[axis, col]
    t_out = (out[axis, col] - o0[axis, col]) / d0[axis, col]
    assert np.abs(t_out - t_plain).max() <= 1e-6 * t_plain.max()
    rel = np.abs(t_ref - t_plain) / t_plain
    assert np.median(rel) <= 2e-6 and rel.max() <= 1e-4, (np.median(rel),
                                                          rel.max())
    # The throughput: within 1e-3 on every lane off the marble.
    mat = t_scene.sphere_mat[idx[sel]].long()
    marble = (t_scene.tex_type[t_scene.mat_tex[mat].long()]
              == TEX_PERLIN).numpy()
    close = np.all(np.abs(out[7:10] - ref[7:10]) < 1e-3, axis=0)
    assert close[~marble].all() and 0 < marble.sum() < LANES
