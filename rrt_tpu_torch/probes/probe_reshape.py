"""Probe #9: the cost of a (1, 1024) <-> (8, 128) relayout around the
multiply-add chain.

The counterpart of rrt_tpu's benchmarks/probe_reshape.py, which timed
Mosaic's relayout on the TPU. On the card the "flat" variant is
probe_row_layout's chain on 1024 threads, and the "reshape" variant
moves the row through shared memory into a sublane-major (8, 128)
assignment of elements to threads and back around every iteration
(ops/csrc/probes.cu fma_chain_relayout_kernel): two barrier pairs and
8-way bank conflicts an iteration.

    python -m rrt_tpu_torch.probes.probe_reshape

`fma_chain_relayout` launches the kernel on a CUDA tensor (counted in
`fma_chain_relayout.launches`) and runs the plain version on a CPU
tensor.
"""

import sys

import torch

from . import card_line, chain_bound_ms, check_vector, median_ms, sm_clock_hz
from .probe_row_layout import (ADD, MUL, OPS_PER_ITER, _launch, fma_chain,
                               fma_chain_reference)

ITERS = 40000
ROW = 1024


def fma_chain_relayout(x, *, iters: int, mul: float = MUL,
                       add: float = ADD):
    """fma_chain with each (1, 1024) row relaid out as (8, 128) and back
    around every iteration; x.numel() must be a multiple of 1024. The
    values are the flat chain's."""
    check_vector(x, torch.float32)
    if x.numel() % ROW:
        raise ValueError(f"the relayout probe takes rows of {ROW}, got "
                         f"{x.numel()} elements")
    if x.device.type == "cpu":
        return fma_chain_reference(x, iters=iters, mul=mul, add=add,
                                   relayout=True)
    y = _launch(x, iters, mul, add, relayout=True)
    fma_chain_relayout.launches += 1
    return y


fma_chain_relayout.launches = 0


def run(device, iters: int = ITERS):
    """Time the flat and the reshape variant on a (1, 1024) row: a list
    of (variant, median ms, bound ms, latency ms, throughput ms,
    GFLOP/s)."""
    x = torch.full((1, ROW), 0.5, dtype=torch.float32, device=device)
    bound, lat, thr = chain_bound_ms(ROW, iters, OPS_PER_ITER)
    rows = []
    for mode, fn in (("flat", fma_chain), ("reshape", fma_chain_relayout)):
        ms = median_ms(lambda: fn(x, iters=iters))
        rows.append((mode, ms, bound, lat, thr,
                     ROW * iters * OPS_PER_ITER * 2 / ms / 1e6))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_reshape: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"{card}; max SM clock {sm_clock_hz() / 1e9:.3f} GHz; "
          f"{ITERS} x {OPS_PER_ITER} fmaf a thread", flush=True)
    for mode, ms, bound, lat, thr, gflops in run(torch.device("cuda")):
        print(f"{mode:8s} median {ms:8.3f} ms  ({gflops:7.1f} GFLOP/s)  "
              f"bound {bound:.3f} ms (chain latency {lat:.3f} ms, "
              f"throughput {thr:.4f} ms)  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
