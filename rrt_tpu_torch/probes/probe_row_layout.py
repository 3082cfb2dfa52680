"""Probe #7: the f32 multiply-add chain at the TPU probe's four shapes.

The counterpart of rrt_tpu's benchmarks/probe_row_layout.py, which
asked whether the megakernel's (1, N) rows waste a TPU vector register
against dense (8, N/8) blocks. On the card a shape is a thread count
(one element a thread), so the four shapes differ only in how many
threads run the same dependent chain: the probe says with a measurement
whether that costs anything.

    python -m rrt_tpu_torch.probes.probe_row_layout

`fma_chain` launches ops/csrc/probes.cu's fma_chain_kernel on a CUDA
tensor (counted in `fma_chain.launches`) and runs `fma_chain_reference`
on a CPU tensor.
"""

import sys

import torch

from ..ops import _build
from ..ops.megakernel import _launch_error
from . import card_line, chain_bound_ms, check_vector, median_ms, sm_clock_hz

ITERS = 40000
OPS_PER_ITER = 16  # multiply-adds an iteration
MUL, ADD = 1.0000001, 1.0e-9
SHAPES = ((1, 1024), (8, 128), (8, 1024), (16, 1024))


def _launch(x, iters, mul, add, relayout):
    lib = _build.load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.rrt_probe_fma_chain(
            x.data_ptr(), y.data_ptr(), x.numel(), iters, mul, add,
            int(relayout), torch.cuda.current_stream(x.device).cuda_stream)
    _launch_error(lib, err, "fma_chain")
    return y


def fma_chain(x, *, iters: int, mul: float = MUL, add: float = ADD):
    """Each element of x (a contiguous float32 tensor) runs iters x 16
    dependent x = fmaf(x, mul, add). Returns a tensor of x's shape."""
    check_vector(x, torch.float32)
    if x.device.type == "cpu":
        return fma_chain_reference(x, iters=iters, mul=mul, add=add)
    y = _launch(x, iters, mul, add, relayout=False)
    fma_chain.launches += 1
    return y


fma_chain.launches = 0


def fmaf(y, mul: float, add: float):
    """y * mul + add rounded once to float32, as the kernel's fmaf: mul
    and add are first rounded to float32, the product of two float32
    values is exact in float64, and the float64 sum is rounded to odd
    (TwoSum's error decides the last bit) so that its rounding to
    float32 is the single rounding of the exact value."""
    m = torch.tensor(mul, dtype=torch.float32).item()
    b = torch.tensor(add, dtype=torch.float32).item()
    p = y.double() * m
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def fma_chain_reference(x, *, iters: int, mul: float = MUL,
                        add: float = ADD, relayout: bool = False):
    """Plain version: the kernel's iters x 16 steps of fmaf(x, mul, add),
    with probe_reshape's (1, 1024) <-> (8, 128) reshape around each
    iteration when `relayout`. (The JAX probe writes x * mul + add, and
    XLA on the CPU contracts it into the same single rounding.)"""
    y = x.clone()
    for _ in range(iters):
        if relayout:
            y = y.reshape(-1, 8, 128)
        for _ in range(OPS_PER_ITER):
            y = fmaf(y, mul, add)
        if relayout:
            y = y.reshape(x.shape)
    return y


def run(device, iters: int = ITERS):
    """Time fma_chain at each of SHAPES on the card: a list of (shape,
    median ms, bound ms, latency ms, throughput ms, GFLOP/s)."""
    rows = []
    for shape in SHAPES:
        x = torch.full(shape, 0.5, dtype=torch.float32, device=device)
        ms = median_ms(lambda: fma_chain(x, iters=iters))
        n = shape[0] * shape[1]
        bound, lat, thr = chain_bound_ms(n, iters, OPS_PER_ITER)
        rows.append((shape, ms, bound, lat, thr,
                     n * iters * OPS_PER_ITER * 2 / ms / 1e6))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_row_layout: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"{card}; max SM clock {sm_clock_hz() / 1e9:.3f} GHz; "
          f"{ITERS} x {OPS_PER_ITER} fmaf a thread", flush=True)
    for shape, ms, bound, lat, thr, gflops in run(torch.device("cuda")):
        print(f"{str(shape):12s} median {ms:8.3f} ms  ({gflops:7.1f} "
              f"GFLOP/s)  bound {bound:.3f} ms (chain latency {lat:.3f} ms, "
              f"throughput {thr:.4f} ms)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
