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

`field_grad_faults` is the rule of tests/test_tile_grad.py at the level
of partition() and Camera fields (the kernel and the plain version
split the radius cotangent between pack rows 3 and 18 differently, so
packs are never compared): tables of <= 64 elements within 2e-3 max|g|,
larger ones with >= 99.5% of elements within it; camera fields within
1e-2 max|g|, max|g| taken no smaller than 1e-3 of the largest camera
gradient.
"""

import time
from typing import NamedTuple

import torch

from .ops import megakernel_train as mkt


class Agreement(NamedTuple):
    agree: torch.Tensor  # (P,) bool: every sample of the pixel agrees
    path_share: float  # share of (pixel, sample) paths that agree
    rad: torch.Tensor  # (P,3) the plain version's radiance sums
    lengths: torch.Tensor  # (spp, P) uint8 the plain version's bounces
    plain_seconds: float  # host seconds of the plain renders


def sample_agreement(packs, kw) -> Agreement:
    """Render every sample of kw's range alone through the kernel
    (render_tiles_train) and the plain version, and compare their
    radiance and bounce counts. The plain renders also give that
    version's full radiance and lengths, so a caller need not run it
    again."""
    n_pix = kw["width"] * kw["height"]
    dev = packs[0].device
    agree = torch.ones((n_pix,), dtype=torch.bool, device=dev)
    rad = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    lengths, n_ok, plain_s = [], 0, 0.0
    for s in range(kw["spp"]):
        one = dict(kw, sample_lo=kw["sample_lo"] + s, spp=1)
        a, _, a_length = mkt.render_tiles_train(*packs, **one)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        b, _, length = mkt.render_tiles_train_reference(*packs, **one)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        plain_s += time.perf_counter() - t0
        ok = (((a - b).abs() <= 1e-3 * b.abs() + 1e-6).all(dim=1)
              & (a_length[0] == length[0]))
        n_ok += int(ok.sum())
        agree &= ok
        rad += b
        lengths.append(length)
    return Agreement(agree, n_ok / (n_pix * kw["spp"]), rad,
                     torch.cat(lengths), plain_s)


def field_grad_faults(kp: dict, kc, pp: dict, pc):
    """Kernel gradients (kp: partition() fields, kc: the nine Camera
    fields) against the plain version's (pp, pc). Returns (the fields
    that break the rule, with what was found; the largest |difference|
    over all fields)."""
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
    cam_max = max(g.abs().max().item() for g in pc)
    for i, (a, b) in enumerate(zip(kc, pc)):
        if not bool(torch.isfinite(a).all()):
            faults.append((f"camera[{i}]", "non-finite"))
            continue
        scale = max(b.abs().max().item(), 1e-3 * cam_max, 1e-12)
        if not bool(((a - b).abs() <= 1e-2 * scale).all()):
            faults.append((f"camera[{i}]", a.tolist(), b.tolist()))
        worst = max(worst, (a - b).abs().max().item())
    return faults, worst
