"""Probe #8: what one call of the draw mixer costs a thread.

The counterpart of rrt_tpu's benchmarks/probe_rng.py: ITERS calls of
Threefry-2x32 (20 rounds; ops/csrc/bounce.cuh threefry2x32, the code the
render kernels run, which draw about 8 times a bounce), of pcg4d
(Jarzynski and Olano, JCGT 2020) and of a trivial baseline body, on a
(1, 1024) u32 row (1024 threads on the card), each folding into a
two-word carry; the output is y0 ^ y1. The baseline's time is the
loop's own.

    python -m rrt_tpu_torch.probes.probe_rng

`mix` launches ops/csrc/probes.cu's rng_kernel on a CUDA tensor
(counted in `mix.launches`) and runs `mix_reference` on a CPU tensor.
u32 words travel in int32 tensors (their bits), as the render kernels'
keys do (rng.u32_bits).
"""

import sys

import torch

from .. import rng
from ..ops import _build
from ..ops.megakernel import _launch_error
from . import card_line, check_vector, int32_rate, median_ms, sm_clock_hz

ITERS = 20000
MODES = ("baseline", "threefry", "pcg4d")
# u32 operations a call, counted in the source with what the card fuses
# (a rotate is one funnel shift, a multiply-add one IMAD), the loop's own
# increment and test left out: the baseline's add and xor; Threefry's
# second counter word (1), key schedule (2), counter injection (2), 20
# rounds of add, rotate and xor (60) and five key injections of three
# adds (15); pcg4d's second counter word (1), 12 multiply-adds, 4 shifts
# and 4 xors, and the fold's 2 xors.
OPS_PER_CALL = {"baseline": 2, "threefry": 80, "pcg4d": 23}
_MASK16 = 0xFFFF


def _mul32(x, y):
    """x * y mod 2^32 of u32 words in int64 tensors, without an int64
    overflow."""
    lo = x * (y & _MASK16)
    hi = ((x * (y >> 16)) & _MASK16) << 16
    return (lo + hi) & rng.MASK32


def _pcg4d(a, b, c, d):
    m = rng.MASK32
    a = (a * 1664525 + 1013904223) & m
    b = (b * 1664525 + 1013904223) & m
    c = (c * 1664525 + 1013904223) & m
    d = (d * 1664525 + 1013904223) & m
    for shift in (False, True):
        if shift:
            a, b, c, d = (v ^ (v >> 16) for v in (a, b, c, d))
        a = (a + _mul32(b, d)) & m
        b = (b + _mul32(c, a)) & m
        c = (c + _mul32(a, b)) & m
        d = (d + _mul32(b, c)) & m
    return a, b, c, d


def mix(x, *, mode: str, iters: int):
    """iters calls of `mode` (one of MODES) on each element's carry
    (x, x), x a contiguous int32 tensor of u32 bits. Returns y0 ^ y1, an
    int32 tensor of x's shape."""
    check_vector(x, torch.int32)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.device.type == "cpu":
        return mix_reference(x, mode=mode, iters=iters)
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.rrt_probe_rng(
            x.data_ptr(), y.data_ptr(), x.numel(), iters, MODES.index(mode),
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch_error(lib, err, "rng")
    mix.launches += 1
    return y


mix.launches = 0


def mix_reference(x, *, mode: str, iters: int):
    """Plain version of `mix`, in int64 tensors of u32 words."""
    x0 = rng.from_u32_bits(x)
    x1 = x0
    for i in range(iters):
        if mode == "threefry":
            x0, x1 = rng.threefry2x32(x0, x1, i, i + 1)
        elif mode == "pcg4d":
            a, b, c, d = _pcg4d(x0, x1, torch.full_like(x0, i),
                                torch.full_like(x0, i + 1))
            x0, x1 = a ^ c, b ^ d
        else:
            x0, x1 = (x0 + i) & rng.MASK32, x1 ^ i
    return rng.u32_bits(x0 ^ x1)


def run(device, iters: int = ITERS):
    """Time each of MODES on a (1, 1024) row: a list of (mode, median
    ms, bound ms, ns a call)."""
    x = torch.full((1, 1024), 12345, dtype=torch.int32, device=device)
    rate = int32_rate(device)
    rows = []
    for mode in MODES:
        ms = median_ms(lambda: mix(x, mode=mode, iters=iters))
        bound = x.numel() * iters * OPS_PER_CALL[mode] / rate * 1e3
        rows.append((mode, ms, bound, ms * 1e6 / iters))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_rng: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    card = card_line()
    device = torch.device("cuda")
    print(f"{card}; max SM clock {sm_clock_hz() / 1e9:.3f} GHz; INT32 "
          f"{int32_rate(device) / 1e12:.2f} Tops/s; {ITERS} calls a thread",
          flush=True)
    for mode, ms, bound, ns in run(device):
        print(f"{mode:9s} median {ms:8.3f} ms  ({ns:7.1f} ns/call)  bound "
              f"{bound:.4f} ms ({OPS_PER_CALL[mode]} u32 ops a call over the "
              f"INT32 rate)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
