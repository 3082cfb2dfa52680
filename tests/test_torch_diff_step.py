"""The differentiable bounce (ops/megakernel_vjp.py) against rrt_tpu.

`diff_step` is held against rrt_tpu's `_make_diff_step` and
`camera_ray_rows` against `_camera_ray_rows`, on the same rows and
replayed constants made from a seed with numpy. Both are plain array
code in float32 with the same operations in the same order, so:

  * outputs agree within 1e-6 of each row's largest magnitude;
  * the VJP under the same cotangent (jax.vjp against
    torch.autograd.grad) agrees within 1e-5 of each input's largest
    gradient.

The lanes mix hits and misses, front and back faces, all three
materials (metal fuzz 0 among them), reflect and refract, checker
parity and degenerate lambertian directions, with the sky or a solid
background."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrt_tpu.ops.megakernel_train as jmkt
import rrt_tpu.ops.megakernel_vjp as jmkv
from rrt_tpu_torch.ops.megakernel_vjp import camera_ray_rows, diff_step

N = 512
_BOOLS = ("hit", "miss", "survives", "front", "degen", "do_reflect",
          "use_c2", "is_lam", "is_met", "is_die")


def _lanes(seed):
    """Rows, sphere columns and replayed constants for N lanes: each
    lane's ray starts outside its sphere and aims at it (so root 0 is
    the forward's pick), or inside it (root 1)."""
    rs = np.random.default_rng(seed)
    f32 = np.float32
    c = rs.uniform(-3, 3, (3, N))
    r = rs.uniform(0.5, 2.0, N)
    u = rs.normal(size=(3, N))
    u /= np.linalg.norm(u, axis=0)
    inside = rs.random(N) < 0.2
    o = np.where(inside, c + 0.3 * r * u, c + (r + rs.uniform(1, 5, N)) * u)
    aim = c + 0.5 * r * rs.uniform(-1, 1, (3, N)) - o
    d = aim * rs.uniform(0.5, 2.0, N)
    a = (d * d).sum(0)
    hb = (o * d).sum(0) - (d * c).sum(0)
    cc = (o * o).sum(0) - 2 * (o * c).sum(0) + (c * c).sum(0) - r * r
    sq = np.sqrt(hb * hb - a * cc)
    t = np.where(inside, (-hb + sq) / a, (-hb - sq) / a)

    mtype = rs.integers(0, 3, N)
    aux = np.where(mtype == 2, rs.uniform(1.3, 1.8, N),
                   np.where(rs.random(N) < 0.3, 0.0, rs.uniform(0, 1, N)))
    sign = np.where((mtype == 2) & (rs.random(N) < 0.3), -1.0, 1.0)
    sel = np.zeros((24, N))
    sel[0:3], sel[3], sel[8], sel[9] = c, r * r, mtype, aux
    sel[10:16] = rs.uniform(0, 1, (6, N))
    sel[16], sel[17], sel[18] = 1.0, 10.0, sign * r

    g = rs.normal(size=(6, N))
    unit = g[0:3] / np.linalg.norm(g[0:3], axis=0)
    sph = g[3:6] / np.linalg.norm(g[3:6], axis=0) * rs.random(N) ** (1 / 3)
    hit = rs.random(N) < 0.85
    consts = dict(
        t_hit=t.astype(f32), hit=hit, miss=~hit,
        survives=hit & (rs.random(N) < 0.9), front=rs.random(N) < 0.7,
        degen=rs.random(N) < 0.05, do_reflect=rs.random(N) < 0.4,
        use_c2=rs.random(N) < 0.5, is_lam=mtype == 0, is_met=mtype == 1,
        is_die=mtype == 2)
    draws = [x.astype(f32) for x in (*unit, *sph, rs.random(N))]
    state = np.concatenate([o, d, rs.random((1, N)), rs.uniform(0, 1, (3, N)),
                            rs.uniform(0, 0.5, (3, N))]).astype(f32)
    bg6 = rs.uniform(0, 1, (6, N)).astype(f32)
    return state, sel.astype(f32), bg6, consts, draws


def _run_both(seed, is_sky, cot_seed, moving=False, rr_depth=0):
    """rrt_tpu's _make_diff_step and the port's diff_step on _lanes(seed)
    under jax.vjp and autograd; with rr_depth, a random rr_on (Russian
    roulette acts at the lane's bounce)."""
    state, sel, bg6, consts, draws = _lanes(seed)
    if rr_depth:
        consts["rr_on"] = np.random.default_rng(seed + 2).random(N) < 0.7
    if moving:  # the same centers at each lane's time, reached by motion
        rs = np.random.default_rng(seed + 1)
        vel = rs.uniform(-0.5, 0.5, (3, N)).astype(np.float32)
        sel[4:7] = vel
        sel[0:3] = sel[0:3] - state[6] * vel
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    jc.update(draws=tuple(jnp.asarray(x) for x in draws),
              is_sky=jnp.asarray(is_sky), is_light=jnp.zeros(N, bool))
    g = jmkv._make_diff_step(jc, moving=moving, has_quads=False,
                             has_boxes=False, has_rot_boxes=False,
                             has_perlin=False, has_images=False, img_ah=1,
                             img_aw=1, rr_depth=rr_depth)
    j_ins = [jnp.asarray(x) for x in state] + [jnp.asarray(sel)] + [
        jnp.asarray(x) for x in bg6]
    j_out, vjp = jax.vjp(g, *j_ins)
    cot = np.random.default_rng(cot_seed).normal(size=(13, N)).astype(
        np.float32)
    j_grads = vjp(tuple(jnp.asarray(x).reshape(jo.shape)
                        for x, jo in zip(cot, j_out)))

    tc = {k: torch.from_numpy(v) for k, v in consts.items()}
    tc.update(draws=tuple(torch.from_numpy(x) for x in draws),
              is_sky=torch.tensor(is_sky))
    t_ins = [torch.from_numpy(x.copy()).requires_grad_() for x in state] + [
        torch.from_numpy(sel).requires_grad_()] + [
        torch.from_numpy(x.copy()).requires_grad_() for x in bg6]
    t_out = diff_step(tc, *t_ins, moving=moving, rr_depth=rr_depth)
    t_grads = torch.autograd.grad(
        t_out, t_ins, [torch.from_numpy(x) for x in cot], allow_unused=True)
    return j_out, t_out, j_grads, t_grads, t_ins


@pytest.mark.parametrize("is_sky", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_diff_step_matches_reference(seed, is_sky):
    _assert_steps_agree(*_run_both(seed, is_sky, 100))


@pytest.mark.parametrize("seed", [0, 1])
def test_moving_diff_step_matches_reference(seed):
    """Moving spheres: the center at the lane's time (state row 6) from
    pack rows 0-2 and 4-6, so the velocity rows and the time get
    gradients, as under rrt_tpu's jax.vjp."""
    out = _run_both(seed, True, 100, moving=True)
    _assert_steps_agree(*out)
    t_grads = out[3]
    assert t_grads[6].abs().max() > 0  # the time
    assert t_grads[13][4:7].abs().max() > 0  # the velocity rows


def _assert_steps_agree(j_out, t_out, j_grads, t_grads, t_ins):
    for i, (jo, to) in enumerate(zip(j_out, t_out)):
        jo = np.broadcast_to(np.asarray(jo).reshape(-1), (N,))
        to = np.broadcast_to(to.detach().numpy(), (N,))
        scale = max(np.abs(jo).max(), 1e-6)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6 * scale,
                                   err_msg=f"output row {i}")
    for i, (jg, tg, x) in enumerate(zip(j_grads, t_grads, t_ins)):
        jg = np.asarray(jg).reshape(x.shape)
        tg = np.zeros(x.shape, np.float32) if tg is None else tg.numpy()
        assert np.isfinite(tg).all(), f"input {i}"
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"input {i}")


def test_diff_step_has_gradient_power():
    """The lanes above do reach every input: the VJP is not trivially
    zero for the sphere, albedo, aux, radius and background rows."""
    _, _, _, t_grads, _ = _run_both(0, True, 100)
    d_sel = t_grads[13].abs().sum(dim=1)
    for row in (0, 1, 2, 3, 9, 10, 11, 12, 13, 14, 15, 18):
        assert d_sel[row] > 0, row
    assert all(g.abs().sum() > 0 for g in t_grads[14:20])


def test_diff_step_other_families_raise():
    """Nothing raises any more: quads, boxes and lights are diff_step's
    since #9.7 (tests/test_torch_cornell_grad.py), media since #9.4
    (tests/test_torch_media_grad.py), the perlin and image textures since
    #9.5's first part (tests/test_torch_textures_grad.py), and Russian
    roulette since #9.6 (tests/test_torch_rr_grad.py holds it against
    rrt_tpu). Where rr_on is false the step is rr_depth 0's bit for bit;
    where it is true a surviving lane's throughput is divided by the
    detached p, so its cotangent is scaled by 1 / p and no more."""
    state, sel, _, consts, draws = _lanes(0)
    tc = {k: torch.from_numpy(v) for k, v in consts.items()}
    tc.update(draws=tuple(torch.from_numpy(x) for x in draws),
              is_sky=torch.tensor(True))
    ins = [torch.from_numpy(x.copy()).requires_grad_() for x in state] + [
        torch.from_numpy(sel)] + [torch.full((N,), 0.5)] * 6
    off = diff_step(tc, *ins, moving=False)
    no = diff_step(dict(tc, rr_on=torch.zeros(N, dtype=torch.bool)), *ins,
                   moving=False, rr_depth=2)
    for a, b in zip(off, no):
        assert torch.equal(a, b)
    on = diff_step(dict(tc, rr_on=torch.ones(N, dtype=torch.bool)), *ins,
                   moving=False, rr_depth=2)
    sv = tc["survives"]
    tn = torch.stack(off[7:10]).detach()
    p = torch.clamp(tn.max(dim=0).values, 0.05, 1.0)
    expect = torch.where(sv, tn * (1.0 / p), tn)
    torch.testing.assert_close(torch.stack(on[7:10]).detach(), expect,
                               rtol=1e-6, atol=0)
    g_on = torch.autograd.grad(on[7].sum(), ins[7])[0]
    g_off = torch.autograd.grad(off[7].sum(), ins[7])[0]
    torch.testing.assert_close(g_on, torch.where(sv, g_off / p, g_off),
                               rtol=1e-6, atol=0)
    assert (sv & (p < 1.0)).any()


def test_camera_ray_rows_matches_reference():
    rs = np.random.default_rng(3)
    cam = rs.normal(size=24).astype(np.float32)
    cam[21:24] = (64.0, 32.0, 31.0)
    cam[18] = 0.05
    px = rs.integers(0, 64, N).astype(np.float32)
    py = rs.integers(0, 32, N).astype(np.float32)
    draws = [x.astype(np.float32) for x in rs.random((5, N))]
    cot = rs.normal(size=(7, N)).astype(np.float32)

    j_out, vjp = jax.vjp(
        lambda *c: jmkt._camera_ray_rows(c, px, py, draws),
        *[jnp.asarray(v) for v in cam])
    j_g = np.array([np.asarray(g) for g in vjp(tuple(map(jnp.asarray,
                                                         cot)))])

    t_cam = torch.from_numpy(cam).requires_grad_()
    t_out = camera_ray_rows(t_cam, torch.from_numpy(px),
                            torch.from_numpy(py),
                            [torch.from_numpy(x) for x in draws])
    (t_g,) = torch.autograd.grad(t_out, t_cam,
                                 [torch.from_numpy(x) for x in cot])
    for jo, to in zip(j_out, t_out):
        jo = np.broadcast_to(np.asarray(jo), (N,))
        to = np.broadcast_to(to.detach().numpy(), (N,))
        np.testing.assert_allclose(to, jo, rtol=0,
                                   atol=1e-6 * np.abs(jo).max())
    np.testing.assert_allclose(t_g.numpy(), j_g, rtol=0,
                               atol=1e-5 * np.abs(j_g).max())
