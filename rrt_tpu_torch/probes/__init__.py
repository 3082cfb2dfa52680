"""The probes: three small CUDA kernels (ops/csrc/probes.cu) that time
what a thread's dependent arithmetic, a relayout and a random-number
mixer cost on the card, the counterparts of rrt_tpu's
benchmarks/probe_row_layout.py, probe_rng.py and probe_reshape.py.

    python -m rrt_tpu_torch.probes.probe_row_layout
    python -m rrt_tpu_torch.probes.probe_rng
    python -m rrt_tpu_torch.probes.probe_reshape

Each module holds its kernel's wrapper (CUDA tensors launch the kernel,
counted in the wrapper's `launches`; CPU tensors run the plain version),
a plain PyTorch version with an `iters` argument, `run(device)`, which
times the JAX probe's variants at its full ITERS, and `main()`, which
prints them beside their bounds and the card's name and power limit.
This module holds what they and chip_smoke.py share: the card's
numbers, its name line, the timing and the bounds.
"""

import statistics
import subprocess

import torch

# An H100 SXM at a 700 W power limit (NVIDIA's data sheet): FP32
# operations a second outside the tensor cores (a fused multiply-add
# counts as two), and HBM3 bytes a second.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# Cycles from one dependent FP32 fused multiply-add to the next on
# Hopper, and INT32 lanes an SM (the Hopper architecture white paper).
FMA_LATENCY_CYCLES = 4
INT32_LANES_PER_SM = 64
TIMED_LAUNCHES = 5


def _smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return _smi("name,power.limit")


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm)."""
    return float(_smi("clocks.max.sm").split()[0]) * 1e6


def int32_rate(device) -> float:
    """INT32 operations a second: the SMs' INT32 lanes at the maximum
    SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT32_LANES_PER_SM * sm_clock_hz()


def median_ms(fn) -> float:
    """Median milliseconds of fn() over TIMED_LAUNCHES launches, each
    between two CUDA events, after a warm one."""
    fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chain_bound_ms(n: int, iters: int, ops: int) -> tuple:
    """(bound ms, latency ms, throughput ms) of n elements' chains of
    iters * ops dependent fused multiply-adds: the chain's latency at
    the maximum SM clock, or the FMAs (two operations each) over the
    FP32 peak, whichever is longer. The 8 bytes an element moves are
    far below either."""
    latency = iters * ops * FMA_LATENCY_CYCLES / sm_clock_hz() * 1e3
    throughput = n * iters * ops * 2 / FP32_PEAK * 1e3
    return max(latency, throughput), latency, throughput


def check_vector(x, dtype):
    if (not isinstance(x, torch.Tensor) or x.dtype != dtype
            or not x.is_contiguous() or x.numel() < 1):
        raise ValueError(f"the probe takes a contiguous non-empty {dtype} "
                         f"tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cuda or cpu, not {x.device}")
