"""The rule that holds the train kernels' gradients against their plain
versions, in one place for chip_smoke.py and tests/test_torch_cuda.py.

`sample_agreement` finds the pixels each of whose samples the kernel and
the plain version render alike; the others get loss weight 0. A long
path among curved surfaces is chaotic, so two f32 roundings of it part
ways in value and, more, in derivative: at chap12 240x160, 2 spp,
depth 50, one 12-bounce sample rendered 8e-6 in one and 4e-6 in the
other, with d rad / d cam[4] of 503 and 1002, while its pixel's sum
agreed within 1e-4 of 1. So each sample is compared alone: it agrees
when both versions traced the same number of bounces and its radiance
agrees within 1e-3 relative (+1e-6) in every channel. The bounce count
matters at full size: at chap12 1200x800, 8 spp, depth 50, 0.15% of
paths trace a different number of bounces in the two versions, and
those of them whose radiance still agrees within 1e-3 are other paths
with other derivatives; weighted in, they put the aspect gradient 3.3%
apart (12476.6 against 12073.8), weighted out 1.5e-4 apart, for 97.93%
of pixels kept instead of 98.05% (H100).

`winner_faults` holds a forward's stored winners to the plain
version's on the paths that agree, and `pool_faults` to the same
kernel's winners of each sample traced alone, which must be equal.
`tie_gaps` reads, at each differing path's first differing bounce,
both winners' roots on the plain version's ray in float64: at chap12
1200x800, 8 spp, depth 50 on an H100 they were no near-ties (one root
missing on most, the others 4e-3 relative apart or more, past their
float32 rounding bounds): such a path had parted ways earlier, by
drift or by an earlier decision, and still agrees by the rule above,
mostly at 51 bounces, where both paths end absorbed with radiance 0.
`replay_winners` builds the winners' layout from the backward's plain
replay, for the CPU tests. A scene with quads, boxes, media or a light
passes its SolidPacks as kw's `solids`: its winners are codes
(ops.megakernel.encode_winner), and tie_gaps reads a quad's, box's or
medium's t in float64 as the sphere's (a medium's with the ray's own
STREAM_MEDIUM draw).

`field_grad_faults` is the rule of tests/test_tile_grad.py at the level
of partition() and Camera fields (the kernel and the plain version
split the radius cotangent between pack rows 3 and 18 differently, so
packs are never compared): tables of <= 64 elements within 2e-3 max|g|,
larger ones with >= 99.5% of elements within it; camera fields within
1e-2 max|g|, max|g| taken no smaller than 1e-3 of the largest camera
gradient.
"""

import time
import types
from typing import NamedTuple

import torch

from .ops import megakernel as mk
from .ops import megakernel_train as mkt


class Agreement(NamedTuple):
    agree: torch.Tensor  # (P,) bool: every sample of the pixel agrees
    path_share: float  # share of (pixel, sample) paths that agree
    rad: torch.Tensor  # (P,3) the plain version's radiance sums
    lengths: torch.Tensor  # (spp, P) uint8 the plain version's bounces
    plain_seconds: float  # host seconds of the plain renders
    paths: torch.Tensor  # (spp, P) bool: the sample's path agrees
    # (spp, max_depth + 1, P) int16: the plain version's winner code of
    # each path's bounces (-1 a miss, -2 past the path)
    winners: torch.Tensor
    # (spp, WINNERS_PER_SAMPLE, P) int16: render_tiles_train's winners of
    # each sample traced alone (entry j: bounce j; past the path unset)
    alone: torch.Tensor


def sample_agreement(packs, kw) -> Agreement:
    """Render every sample of kw's range alone through the kernel
    (render_tiles_train) and the plain version, and compare their
    radiance and bounce counts (kw: render_tiles_train's keywords, its
    `solids` included). The plain renders also give that
    version's full radiance and lengths, so a caller need not run it
    again."""
    n_pix = kw["width"] * kw["height"]
    dev = packs[0].device
    agree = torch.ones((n_pix,), dtype=torch.bool, device=dev)
    rad = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    lengths, paths, winners, alone, plain_s = [], [], [], [], 0.0
    for s in range(kw["spp"]):
        one = dict(kw, sample_lo=kw["sample_lo"] + s, spp=1)
        a, _, a_length, a_win = mkt.render_tiles_train(*packs, **one)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        # render_tiles_train_reference, keeping every bounce's winner
        b, _, length, win = mk.trace_paths_reference(
            *packs, win_cap=kw["max_depth"] + 1, **one)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        plain_s += time.perf_counter() - t0
        ok = (((a - b).abs() <= 1e-3 * b.abs() + 1e-6).all(dim=1)
              & (a_length[0] == length[0]))
        agree &= ok
        rad += b
        lengths.append(length)
        paths.append(ok)
        winners.append(win)
        alone.append(a_win)
    paths = torch.stack(paths)
    return Agreement(agree, paths.float().mean().item(), rad,
                     torch.cat(lengths), plain_s, paths,
                     torch.stack(winners), torch.stack(alone))


def winner_faults(winners, lengths, agreement: Agreement) -> tuple:
    """A forward's stored winners (render_tiles_train's (cap, P), with
    its lengths (spp, P)) against the plain version's on the paths that
    agree, bounce by bounce. Returns (the entries that differ, the
    entries compared: the agreeing paths' segments inside the pool, the
    differing entries as (sample, bounce, pixel, forward's winner, plain
    winner) rows, an (n, 5) int64 tensor)."""
    cap = winners.shape[0]
    first = lengths.long().cumsum(dim=0) - lengths.long()
    bounce = torch.arange(agreement.winners.shape[1],
                          device=winners.device)[:, None]
    compared, differ = 0, []
    for s in range(lengths.shape[0]):
        j = first[s][None, :] + bounce
        valid = ((bounce < lengths[s].long()[None, :]) & (j < cap)
                 & agreement.paths[s][None, :])
        got = torch.gather(winners, 0, j.clamp(max=cap - 1))
        bad = (got != agreement.winners[s]) & valid
        b, p = bad.nonzero(as_tuple=True)
        differ.append(torch.stack([torch.full_like(b, s), b, p,
                                   got[b, p].long(),
                                   agreement.winners[s][b, p].long()], 1))
        compared += int(valid.sum())
    differ = torch.cat(differ)
    return differ.shape[0], compared, differ


def pool_faults(winners, lengths, agreement: Agreement) -> tuple:
    """A forward's pooled winners (render_tiles_train's (cap, P), with its
    lengths (spp, P)) against the same forward's winners of each sample
    traced alone (agreement.alone), on every path's bounces that both
    keep. The same code traces the same paths either way, so they are
    equal where the pool's layout is right: sample s's first entry at
    the sum of the pixel's earlier lengths, nothing past the pool's end.
    Returns (the entries that differ, the entries compared)."""
    cap = winners.shape[0]
    first = lengths.long().cumsum(dim=0) - lengths.long()
    bounce = torch.arange(agreement.alone.shape[1],
                          device=winners.device)[:, None]
    faults = compared = 0
    for s in range(lengths.shape[0]):
        j = first[s][None, :] + bounce
        valid = (bounce < lengths[s].long()[None, :]) & (j < cap)
        got = torch.gather(winners, 0, j.clamp(max=cap - 1))
        faults += int(((got != agreement.alone[s]) & valid).sum())
        compared += int(valid.sum())
    return faults, compared


def first_differences(differ):
    """The rows of winner_faults' differing entries at each path's first
    differing bounce."""
    if differ.shape[0] == 0:
        return differ
    path = differ[:, 0] * (int(differ[:, 2].max()) + 1) + differ[:, 2]
    _, inv = path.unique(return_inverse=True)
    first = torch.zeros_like(path[:int(inv.max()) + 1]).scatter_reduce(
        0, inv, differ[:, 1], "amin", include_self=False)
    return differ[differ[:, 1] == first[inv]]


class Ties(NamedTuple):
    """tie_gaps' reading of differing winners, one entry a row."""
    gap: torch.Tensor  # |t_a - t_b| / min(t_a, t_b), float64
    # |t_a - t_b| over the sum of the two roots' float32 rounding bounds
    # (_slot_t64): below 1, float32 arithmetic may order them either way,
    # a near-tie
    ulps: torch.Tensor
    replayed: torch.Tensor  # the plain replay's winner, -1 a miss


def tie_gaps(packs, kw, differ) -> Ties:
    """Whether winner_faults' differing entries are near-ties. For each
    row (sample, bounce, pixel, forward's winner, plain winner), each a
    winner code, replay the plain version's path of that pixel and sample
    (render._bounce, as trace_paths_reference) to that bounce and take
    both winners' t beyond t_min on its ray, in float64, with the bound
    on the rounding error of the same t in float32 (_slot_t64 for a
    sphere, _solid_t64 for a quad or box of kw's `solids`, _medium_t64
    for a medium, with the bounce's draw). Gaps are inf
    where either winner is -1 or has no such t; the replayed winners
    must be the rows' plain winners."""
    from . import rng
    from .camera import thin_lens_rays
    from .render import _bounce

    sph24, cam24, bg8 = packs
    dev = sph24.device
    n = differ.shape[0]
    gaps = torch.full((2, n), float("inf"), dtype=torch.float64, device=dev)
    replayed = torch.full((n,), -2, dtype=torch.int64, device=dev)
    solids = kw.get("solids")
    scene = mk._scene_from_packs(sph24, bg8, kw["moving"], solids)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    width = kw["width"]
    for s in differ[:, 0].unique().tolist():
        rows = (differ[:, 0] == s).nonzero()[:, 0]
        pix, at_pix = differ[rows, 2].unique(return_inverse=True)
        keys = rng.sample_keys(tuple(kw["seed_words"]), pix,
                               kw["sample_lo"] + s)
        o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                                  pix % width, pix // width, width,
                                  kw["height"], keys)
        for k in range(int(differ[rows, 1].max()) + 1):
            # Every pixel's ray goes on; a row's path is alive at its
            # bounce (its length agreed), and the others are not read.
            b = _bounce(scene, o, d, tm, keys, k,
                        torch.ones_like(pix, dtype=torch.bool), kw["t_min"],
                        kw["max_depth"])
            now = differ[rows, 1] == k
            at, u = rows[now], at_pix[now]
            if at.numel():
                replayed[at] = torch.where(
                    b.miss_mask, -1, mk.encode_winner(b.fam, b.win))[u]
                u_med = None if b.u_med is None else b.u_med[:, u]
                (ta, ea), (tb, eb) = (
                    _winner_t64(sph24, solids, o[:, u], d[:, u], tm[u],
                                differ[at, col], kw, u_med)
                    for col in (3, 4))
                gap = (ta - tb).abs()
                off = torch.isinf(ta) | torch.isinf(tb)
                gaps[0, at] = torch.where(off, float("inf"),
                                          gap / torch.minimum(ta, tb))
                gaps[1, at] = torch.where(off, float("inf"), gap / (ea + eb))
            o, d = b.new_o, b.new_d
    return Ties(gaps[0], gaps[1], replayed)


def _winner_t64(sph24, solids, o, d, time, code, kw, u_med=None) -> tuple:
    """_slot_t64 for winner codes: a sphere's by _slot_t64, a quad's or
    box's by _solid_t64, a medium's by _medium_t64 with u_med (n_media,
    n), the rays' draws; inf for -1."""
    from .geometry import FAM_MEDIUM, FAM_SPHERE
    fam, idx = mk.decode_winner(code)
    t, e = _slot_t64(sph24, o, d, time, torch.where(fam == FAM_SPHERE, idx,
                                                     -1), kw)
    if solids is not None:
        ts, es = _solid_t64(solids, o, d, fam, idx, kw["t_min"])
        solid = (fam != FAM_SPHERE) & (fam != FAM_MEDIUM) & (code >= 0)
        t, e = torch.where(solid, ts, t), torch.where(solid, es, e)
        if solids.n_media:
            tm, em = _medium_t64(solids, o, d, idx, kw["t_min"], u_med)
            med = fam == FAM_MEDIUM
            t, e = torch.where(med, tm, t), torch.where(med, em, e)
    return t, e


def _medium_t64(solids, o, d, idx, t_min, u_med) -> tuple:
    """Medium idx's scattering t on the rays (o, d (3, n)) in float64,
    its sampled distance from the rays' draws u_med (n_media, n), not
    clipped by any solid (inf where the ray does not scatter in it), and
    a first-order bound on the rounding error of the same t in float32:
    a few units of roundoff of the entry t and of the sampled distance
    over |d|."""
    from .geometry import intersect_media
    uu = 2.0 ** -24
    nm = solids.n_media
    i = idx.clamp(0, nm - 1)
    med = solids.med24[:nm].double()
    o, d = o.double(), d.double()
    t = torch.full((o.shape[1],), float("inf"), dtype=torch.float64,
                   device=o.device)
    for m in range(nm):  # one medium at a time: the others do not clip it
        one = types.SimpleNamespace(
            n_media_active=1, med_btype=med[m:m + 1, 0].round().int(),
            med_center=med[m:m + 1, 1:4], med_radius=med[m:m + 1, 4],
            med_half=med[m:m + 1, 5:8],
            med_rot=med[m:m + 1, 8:17].reshape(1, 3, 3),
            med_neg_inv_density=med[m:m + 1, 17],
            med_valid=med[m:m + 1, 18] > 0.5)
        tm, _ = intersect_media(one, o, d, t_min, float("inf"),
                                u_med[m:m + 1].double())
        t = torch.where(i == m, tm, t)
    scale = torch.where(torch.isfinite(t), t.abs(), 0.0)
    err = 8 * uu * (scale + (o.abs().sum(0) + med[i, 1:8].abs().sum(1))
                    / d.abs().sum(0).clamp(min=1e-30))
    return torch.where(t < 1e30, t, float("inf")), err


def _solid_t64(solids, o, d, fam, idx, t_min) -> tuple:
    """A quad's or box's t beyond t_min on the rays (o, d (3, n)), in
    float64 (inf where the ray misses it), and a first-order bound on
    the rounding error of the same t in float32 as the kernels compute
    it: a quad's (d_plane - n.o) / (n.d), a box's slab (side h - o_k) /
    d_k in its frame. fam, idx: the winners' families and slots (n,)."""
    from .geometry import FAM_QUAD, quad_roots, box_roots, quad_frames
    u = 2.0 ** -24
    o, d = o.double(), d.double()
    n = o.shape[1]
    t = torch.full((n,), float("inf"), dtype=torch.float64, device=o.device)
    err = torch.zeros_like(t)
    is_quad = fam == FAM_QUAD
    nq, nb = solids.n_quads, solids.n_boxes
    if nq:
        quad = solids.quad24[:, :nq].double()
        fr = quad_frames(quad[0:3], quad[3:6], quad[6:9])
        q = idx.clamp(0, nq - 1)
        tq = quad_roots(fr, quad[9] > 0.5, o, d, t_min, float("inf"))
        tq = tq.gather(1, q[:, None])[:, 0]
        n_o = (o.abs() * fr.n[:, q].abs()).sum(0)
        den = (d * fr.n[:, q]).sum(0).abs()
        e_q = (4 * u * (fr.d_plane[q].abs() + n_o)
               + 4 * u * tq.abs() * (d.abs() * fr.n[:, q].abs()).sum(0)) \
            / den + u * tq.abs()
        t = torch.where(is_quad, tq, t)
        err = torch.where(is_quad, e_q, err)
    if nb:
        box = solids.box24[:, :nb].double()
        b = idx.clamp(0, nb - 1)
        tb = box_roots(box[0:3].T, box[3:6].T, box[6], box[7], box[8] > 0.5,
                       o, d, t_min, float("inf"))
        tb = tb.gather(1, b[:, None])[:, 0]
        scale = (o - box[0:3, b]).abs().sum(0) + box[3:6, b].abs().sum(0)
        e_b = 6 * u * (scale / d.abs().sum(0).clamp(min=1e-30)
                       + tb.abs())
        t = torch.where(is_quad, t, tb)
        err = torch.where(is_quad, err, e_b)
    return torch.where(torch.isfinite(t) & (t < 1e30), t, float("inf")), err


def _slot_t64(sph24, o, d, time, slot, kw) -> tuple:
    """Slot `slot`'s (n,) first root beyond kw's t_min on the rays (o, d
    (3, n), time (n,)) in float64, inf for slot -1, an invalid slot or
    no such root; and the first-order bound on the rounding error of the
    same root evaluated in float32 as the kernels and the plain version
    do (the expanded quadratic: d.d, o.d - d.c, o.o - 2 o.c + |c|^2 -
    r^2, each within a few units of the float32 roundoff u of its terms'
    magnitudes), which the cancellation in o.o - 2 o.c + |c|^2 makes far
    larger than an ulp of t on a large or distant sphere. The center is
    the pack's, moved to the ray's time for moving spheres; the radius
    is the signed radius row's."""
    u = 2.0 ** -24
    s = slot.clamp(min=0)
    c = sph24[0:3, s].double()
    if kw["moving"]:
        c = c + time.double() * sph24[4:7, s].double()
    o, d = o.double(), d.double()
    oc = o - c
    r2 = sph24[18, s].double() ** 2
    a = (d * d).sum(0)
    half_b = (oc * d).sum(0)
    c_coef = (oc * oc).sum(0) - r2
    disc = half_b * half_b - a * c_coef
    sq = disc.clamp(min=0.0).sqrt()
    root0, root1 = (-half_b - sq) / a, (-half_b + sq) / a
    inf = torch.full_like(a, float("inf"))
    t = torch.where(root0 > kw["t_min"], root0,
                    torch.where(root1 > kw["t_min"], root1, inf))
    t = torch.where((slot >= 0) & (sph24[7, s] > 0.5) & (disc > 0), t, inf)
    n_o, n_d, n_c = (v.norm(dim=0) for v in (o, d, c))
    e_h = 4 * u * n_d * (n_o + n_c)
    e_c = 5 * u * ((n_o + n_c) ** 2 + r2)
    e_disc = 2 * half_b.abs() * e_h + a * e_c + 3 * u * (
        half_b * half_b + a * c_coef.abs())
    e_t = (e_h + e_disc / (2 * sq) + 2 * u * sq) / a + 2 * u * t.abs()
    return t, e_t


def field_grad_faults(kp: dict, kc, pp: dict, pc):
    """Kernel gradients (kp: partition() fields, kc: the nine Camera
    fields, or none) against the plain version's (pp, pc). Returns (the
    fields that break the rule, with what was found; the largest
    |difference| over all fields)."""
    faults, worst = [], 0.0
    for key in pp:
        a, b = kp[key], pp[key]
        if not bool(torch.isfinite(a).all()):
            faults.append((key, "non-finite"))
            continue
        scale = max(b.abs().max().item(), 1e-4)
        close = (a - b).abs() <= 2e-3 * scale
        share = close.float().mean().item()
        if not (share >= 0.995 if a.numel() > 64 else bool(close.all())):
            faults.append((key, share))
        worst = max(worst, (a - b).abs().max().item())
    cam_max = max((g.abs().max().item() for g in pc), default=0.0)
    for i, (a, b) in enumerate(zip(kc, pc)):
        if not bool(torch.isfinite(a).all()):
            faults.append((f"camera[{i}]", "non-finite"))
            continue
        scale = max(b.abs().max().item(), 1e-3 * cam_max, 1e-12)
        if not bool(((a - b).abs() <= 1e-2 * scale).all()):
            faults.append((f"camera[{i}]", a.tolist(), b.tolist()))
        worst = max(worst, (a - b).abs().max().item())
    return faults, worst


def replay_winners(sph24, cam24, bg8, *, seed_words, sample_lo: int,
                   width: int, height: int, spp: int, max_depth: int,
                   t_min: float, moving: bool, win_cap: int, solids=None):
    """The pooled winners (win_cap, P) int16 of samples [sample_lo,
    sample_lo + spp), built apart from the forward's plain version: each
    sample's paths replayed by megakernel_vjp.replay_steps (the
    backward's replay), their records' winner codes (-1 on a miss) laid
    out pixel by pixel in trace order, -2 past a pixel's segments;
    solids: the scene's SolidPacks, or None."""
    from .camera import thin_lens_rays
    from .ops import megakernel as mk
    from .ops.megakernel_vjp import replay_steps
    from . import rng

    scene = mk._scene_from_packs(sph24, bg8, moving, solids)
    basis = tuple(cam24[3 * i:3 * i + 3] for i in range(6))
    n_pix = width * height
    pix = torch.arange(n_pix, device=sph24.device)
    winners = torch.full((win_cap, n_pix), -2, dtype=torch.int16,
                         device=sph24.device)
    first = torch.zeros_like(pix)
    for s in range(spp):
        keys = rng.sample_keys(tuple(seed_words), pix, sample_lo + s)
        o, d, tm = thin_lens_rays(basis, cam24[18], cam24[19], cam24[20],
                                  pix % width, pix // width, width, height,
                                  keys)
        records, n_seg, _ = replay_steps(
            scene, o, d, tm, keys, torch.zeros_like(pix), max_depth + 1,
            max_depth=max_depth, t_min=t_min)
        for k, r in enumerate(records):
            p = pix[r["cur"]]
            j = first[p] + k
            ok = j < win_cap
            winners[j[ok], p[ok]] = torch.where(
                r["miss"], -1, mk.encode_winner(r["fam"], r["win"]))[ok].to(
                    torch.int16)
        first += n_seg
    return winners
