"""chain_bwd's kWalk instantiations on the card: the bounce chain's
backward on more than SOLID_CAP quads and boxes, its replay walking the
solid families' trees as bounce_steps walks them (marked `cuda`; skip
without a CUDA device). Imports neither JAX nor rrt_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_chain_walk.py -q

many_solids_scene (82 quads and 81 boxes rotated about Y, under the
sky) at 64x48, in its four variants (static, moving, marble, both: the
kMoving and kTex instantiations), its camera rays after 1-4 bounces:

  * against chain_adjoint_reference by tests/test_torch_cuda.py's chain
    rule (the forwards agree on >= 99.9% of lanes; the input cotangent
    within 1e-3 of each row's largest on >= 99.5% of the agreeing lanes,
    the packs' within 1e-3 of their largest), with no replay mismatch;
  * against the same kernel walking the solid scan (accel.solid_scan:
    the same packs, every family a loop), which gives the walk's
    winners: the input and background cotangents bit for bit, the
    packs' within PACK_SPREAD (atomics);
  * a repeat: the same, within PACK_SPREAD;
  * 7,000 boxes, whose rows and tree pass what a block may opt into,
    raise NotImplementedError naming Queue C before any launch."""

import dataclasses

import numpy as np
import pytest
import torch

from rrt_tpu_torch import accel
from rrt_tpu_torch.ops import megakernel as tmk
from rrt_tpu_torch.ops import megakernel_vjp as tmkv

from test_torch_cuda import (WALK_VARIANTS, _walk_lanes,  # noqa: F401
                             device)

pytestmark = pytest.mark.cuda

# chip_smoke.py PACK_SPREAD: two runs' pack cotangents, which four-float
# atomic reductions sum in an order that changes, within this share of
# the largest.
PACK_SPREAD = 1e-5


def _pack_grads(out):
    """The pack cotangents of a chain_adjoint output: spheres, quads,
    boxes, and the atlas with images."""
    grads = [out[1], out[4].quad24, out[4].box24]
    return grads + ([] if out[5] is None else [out[5]])


def _spread(a, b):
    """The largest |delta| of the pack cotangents of two outputs over
    each one's largest of a."""
    return max(((y - x).abs().max() / x.abs().max().clamp(min=1e-30)).item()
               for x, y in zip(_pack_grads(a), _pack_grads(b)))


@pytest.mark.parametrize("moving,marble", WALK_VARIANTS)
@pytest.mark.parametrize("pre", [1, 2, 3, 4])
def test_walk_chain_bwd_matches_plain_version(device, moving, marble, pre):
    st, keys, sph, bg, bvh, solids, tex, scan = _walk_lanes(device, moving,
                                                            marble)
    assert min(solids.n_quads, solids.n_boxes) > tmk.SOLID_CAP
    kw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=moving, tex=tex)
    tmk.bounce_steps(st, keys, sph, bg, bvh=bvh, solids=solids,
                     **dict(kw, k_steps=pre))
    out = tmk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, solids=solids,
                           **kw)
    ref_out = tmk.bounce_steps_reference(st.clone(), keys, sph, bg,
                                         solids=solids, **kw)
    agree = ((out[13] == ref_out[13])
             & ((out[14] > 0.5) == (ref_out[14] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    assert agree.float().mean() >= 0.999
    gen = torch.Generator(device="cpu").manual_seed(pre)
    d_out = torch.randn((16, st.shape[1]), generator=gen).to(device) * agree
    ob = out[tmk.ROW_BOUNCE].clone()
    before = tmkv.chain_adjoint.launches
    k = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh,
                           solids=solids, **kw)
    walked_scan = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh,
                                     solids=scan, **kw)
    again = tmkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh,
                               solids=solids, **kw)
    torch.cuda.synchronize(device)
    assert tmkv.chain_adjoint.launches == before + 3
    p = tmkv.chain_adjoint_reference(st, keys, sph, bg, d_out,
                                     ref_out[tmk.ROW_BOUNCE].clone(),
                                     solids=solids, **kw)
    assert int(k[3]) == int(walked_scan[3]) == int(p[3]) == 0
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    assert lane_ok[agree].float().mean() >= 0.995
    for g, e in zip(_pack_grads(k), _pack_grads(p)):
        torch.testing.assert_close(g, e, rtol=0,
                                   atol=1e-3 * e.abs().max().item())
    assert k[4].box24[:, tmk.SOLID_CAP:solids.n_boxes].abs().max() > 0
    assert k[4].quad24[:, tmk.SOLID_CAP:solids.n_quads].abs().max() > 0
    for other in (walked_scan, again):
        assert torch.equal(k[0], other[0]) and torch.equal(k[2], other[2])
        assert _spread(k, other) <= PACK_SPREAD


def test_walk_chain_bwd_past_the_opt_in_raises_before_launch(device):
    """7,000 boxes, whose rows and tree pass the shared memory a block may
    opt into, raise NotImplementedError naming Queue C before a launch
    of chain_bwd, as the forward kernels do."""
    st, keys, sph, bg, bvh, solids, tex, _ = _walk_lanes(device, True, True)
    rs = np.random.RandomState(0)
    box24 = torch.zeros((24, 7000))
    box24[0:3] = torch.from_numpy(rs.uniform(-1000.0, 1000.0, (3, 7000)))
    box24[3:6] = torch.from_numpy(rs.uniform(1.0, 10.0, (3, 7000)))
    box24[6] = 1.0
    box24 = box24.to(device)
    big = dataclasses.replace(
        solids, box24=box24, n_boxes=7000,
        tree=accel.pack_solid_bvh(solids.quad24, box24, solids.n_quads,
                                  7000))
    assert tmk.forward_smem_bytes(bvh, big, True) > accel.BVH_SMEM
    before = tmkv.chain_adjoint.launches
    with pytest.raises(NotImplementedError, match="Queue C"):
        tmkv.chain_adjoint(st, keys, sph, bg, torch.zeros_like(st),
                           st[tmk.ROW_BOUNCE].clone(), k_steps=1,
                           max_depth=8, t_min=1e-3, moving=True, bvh=bvh,
                           solids=big, tex=tex)
    assert tmkv.chain_adjoint.launches == before
