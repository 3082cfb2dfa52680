"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from rrt_tpu_torch/ops/csrc with nvcc and holds each
against its plain PyTorch version on the card. Then drives the main
paths on chap12 (RTIOW final, 484 spheres), each with the launch counts
set to 0 just before it and read just after:

  [4] the forward render, 1200x800, 32 spp, depth 50, through the CLI;
  [7] training, rrt_tpu_torch.diff.make_train_step at 1200x800, 8 spp,
      depth 50, three SGD steps (train_fwd + train_bwd);
  [8] the 500-spp north-star step, routed to the chunked trainer;
  [Q2] the queue driver through the CLI, 1200x800, 32 spp, depth 50, in
      four progressive passes of 8 spp (bounce_steps);
  [Q3] the batch driver through the CLI, 1200x800, 4 spp, depth 50
      (intersect_only);
  [C2] bench.py's backward_chain in the port: chap12 1200x800, 262,144
      lanes at pixel ids * 3, depth 50, the gradient of the mean
      radiance through trace_batch(differentiable=True, fused_vjp=True)
      (bounce_steps forward, chain_bwd backward, chains 4, 4, 43);
  [C3] render_image(differentiable=True), 1200x800, 4 spp, depth 50, and
      the gradient of an L2 loss.

tile_render, bounce_steps, intersect_only and chain_bwd walk a BVH of
the spheres (rrt_tpu_torch/accel.py); the train kernels scan every
slot. [3] and [Q1] print the tree (nodes, depth, shared memory), the
walk's node and slot tests a segment on [Q1]'s rays
(accel.bvh_closest_reference), and [3], [Q1] and [C1] the walk's bound
beside the scan's.

[5] holds the train kernels against tile_render and their plain
versions, at two small shapes and at [7]'s: train_fwd's radiance,
traced counts and lengths equal tile_render's bit for bit (the scan
against the walk: the walk's exact gate, also on book2chap2 in [M1]),
its pooled
winners its own of each sample traced alone, and all but 1e-4 of them
the plain version's on the agreeing paths; train_bwd from the
winners gives the scan route's (winners=None) camera and background
cotangents bit for bit; it prints the path-length histogram and the
segments past the winner pool. [6] checks the gradients with finite
differences at full size; [Q1] holds bounce_steps against its plain
version at [Q2]'s queue shape, and intersect_only against its at that
shape and at [Q3]'s batch shape, on camera rays and after 1-4 bounces;
[C1] holds chain_bwd against its plain version on each of [C2]'s three
chains and on small cases. Then the motion-blur scene book2chap2 (the
same field with moving diffuse spheres, shutter [0, 1]) and the probes:

  [M1] each of the six kernels' moving variants against its plain
       version on book2chap2 at the shapes of [3] (2 spp), [Q1], [5]
       (1200x800, 8 spp) and [C1], each timed (moving_ms);
  [M2] the main path: python -m rrt_tpu_torch.cli with its defaults
       (book2chap2, 1200x800, 10 spp, the tile driver);
  [M3] the main path: one 8-spp make_train_step on book2chap2 with
       sphere_dc among the leaves, and finite differences of one moving
       sphere's sphere_dc;
  [P1] the main path: the three probes' main() at the JAX probes' full
       ITERS, each kernel held against its plain version at 8
       iterations.

[2] prints ptxas's registers and spills of every kernel; [7], [8] and
[M3] print the train kernels' times beside the step's least time
(`step_bound_ms`: one scan a segment, the backward's adjoint, the bytes)
and the peak memory, and [8] requires the 500-spp step to be one chunk.
Prints the card's name and power limit
beside every time, one JSON line of the kernels (with each one's
least time on the card, `bound_ms`), and as its last line {"ok": true,
"device": {...}}. Any failure raises and exits non-zero; without a CUDA
device it exits 2 before printing any result.

What the checks may rest on, so that a run passes or fails alike on any
H100 whatever else shares the machine:

  * never on torch.profiler: its tables are printed, and a profile
    without device events (CUPTI may record nothing where another
    client holds it) prints so and the run goes on. The kernel times of
    the JSON line come from CUDA events (graph_ms, cuda_ms);
  * bit-equality only on values that are equal by construction: each
    lane's input cotangent (one thread a lane) and sums taken in a fixed
    order. What atomics accumulate is held to a stated spread;
  * each gate has at least twice the margin of the worst reading seen
    on the card, written beside it.

Each phase prints its tag before it starts, its readings before the
checks they feed, and its wall time when it ends; [C1]-[C3] also print
their peak device memory.
"""

import contextlib
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from rrt_tpu_torch.probes import FP32_PEAK, HBM_RATE, card_line  # noqa: E402

MAIN = dict(scene="chap12", width=1200, height=800, spp=32, max_depth=50)
# tile_render's traced-ray count at MAIN, seed 0, on an H100: the kernel
# is deterministic, and moving its device code into bounce.cuh kept the
# count bit for bit.
MAIN_TRACED = 87_995_506
TRAIN = dict(width=1200, height=800, spp=8, max_depth=50)
NORTH_STAR_SPP = 500
MIX = (1.0, 0.7, 0.3)  # channel weights of the weighted-sum losses
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
QUEUE_LANES = 131072  # RenderConfig.queue_size, the CLI's default
QUEUE_CHUNK = 8  # [Q2]'s --spp-chunk: four progressive passes
BATCH_SPP = 4
# The batch driver's rays a pass: RenderConfig's tile_pixels x
# samples_per_pass (the last tile of 1200x800 has 38,912).
BATCH_RAYS = 16384 * 4
# bench.py's backward_chain: 262,144 lanes at pixel ids * 3 of chap12
# 1200x800, sample 0, depth 50.
CHAIN_LANES = 262144
# [M1]: tile_render's moving variant against its plain version at this
# many samples (the plain version's time grows with them).
MOTION_SPP = 2
# [P1]: the probes against their plain versions at this many iterations.
PROBE_CHECK_ITERS = 8

# The least time an H100 SXM could take: FP32_PEAK and HBM_RATE
# (rrt_tpu_torch.probes, NVIDIA's data sheet at a 700 W power limit).
# FP32 operations one ray-slot test needs (bounce.cuh closest_sphere),
# with what is constant per sphere (|c|^2 - r^2, 2c) hoisted out of it:
# d.c (5), o.2c (5), half_b (1), c_coef (2), disc (3) and the test of
# disc (1). The roots of the rare hit and the shading of the winner (a
# few hundred operations a bounce, under 3% of a 512-slot scan) are not
# counted: a lower bound.
FLOPS_PER_SLOT = 17
# A moving slot first takes its center at the ray's time, base + time *
# vel: three multiplies and three adds more.
FLOPS_PER_MOVING_SLOT = 23
# FP32 operations of the BVH walk (bounce.cuh closest_sphere_bvh) that
# every kernel but the train kernels runs instead of the scan: a node's slab
# test, six subtractions, six multiplies, twelve min / max, the far
# pad's multiply and the compare (26); a segment's set-up, three
# reciprocals and the origin's pad (WALK_RAY_FLOPS, 15); each slot it
# tests, FLOPS_PER_SLOT (moving: FLOPS_PER_MOVING_SLOT). The tests a
# segment needs are counted by accel.bvh_closest_reference on [Q1]'s
# rays (camera rays and after 1-4 bounces, walk_counts).
NODE_FLOPS = 26
WALK_RAY_FLOPS = 15
# FP32 operations of one bounce of chain.cu's reverse sweep beyond the
# replay's closest hit: scatter_adjoint recomputes the winner's
# quadratic and shade() and runs the transpose (a count of its source,
# transcendentals as one operation each): chain_bwd's bound.
ADJOINT_FLOPS = 300
# FP32 operations of one segment of train.cu's backward beyond any scan,
# counted from its source for the commonest segment (a lambertian hit on
# a solid texture), a transcendental as one operation, the warp sums
# uncounted, so a lower bound: the replay's ray dots, the stored
# winner's quadratic and roots (slot_t) and shade(), about 144; the
# sweep's recomputation of the same and the transpose, about 280.
BWD_SEGMENT_FLOPS = 420
# INT32 operations: a Threefry call is 80 (probe_rng.OPS_PER_CALL). A
# path draws 4 calls (its key and the camera's three pairs) and a
# segment that hits a sphere 4 more (shade()'s scatter draws); a path
# ends in at most one miss, which draws nothing, so at least segments -
# paths segments draw. train_fwd draws each once. train_bwd's replay
# draws them once again; its sweep reshades each hit from what the
# replay kept of the draws (shade's kForAdjoint) and draws nothing, so
# the backward's Threefry work is the forward's. Over [P1]'s INT32 rate
# (probes.int32_rate: 132 SMs x 64 lanes x the maximum SM clock).
THREEFRY_OPS = 80
THREEFRY_PER_HIT = 4
THREEFRY_PER_PATH = 4
# chain_bwd sums its pack cotangents with four-float atomic reductions
# into per-block partials in device memory, whose order within a block
# changes from run to run. With a seeded normal output cotangent the
# sums cancel, and on an H100 80GB HBM3 at 700 W two runs of the checker
# case of [C1] differed by up to 6.9e-7 of the largest pack cotangent
# over 40 repeats, at [C2]'s chains by up to 1.1e-7 (when the kernel
# summed them with shared-memory atomics: 1.5e-6 and 1.5e-7; train_bwd's
# 1e-6 failed there). A repeat, and a run at MAX_SLOTS, must agree within
# PACK_SPREAD of the largest, 14 times the worst reading (6.6 times the
# shared-memory atomics'); a cotangent sent to a wrong slot moves a
# whole contribution, far above it. [C1]
# repeats the checker case PACK_REPEATS times and prints the widest
# spread.
PACK_SPREAD = 1e-5
PACK_REPEATS = 40
# [C1] requires the kernel's and the plain chain's forwards to agree on
# at least this share of lanes (a near-tie winner flip, or hit points
# moved in their last digits on the ground sphere, parts a lane). Worst
# reading on an H100 80GB HBM3 at 700 W: 0.99949 on chain 1 of [C2]'s
# rays, a parted share of 5.1e-4; the gate allows 2e-3, four times it.
MIN_FORWARD_AGREE = 0.998
# [5] holds train_fwd's winners to the plain version's on the paths whose
# length and radiance agree (gradcheck.sample_agreement). Such a path
# can still have parted ways, by drift over many bounces or by an earlier
# decision, and agree: two paths that both end absorbed at max_depth + 1
# bounces have radiance 0. At chap12 1200x800, 8 spp, depth 50, 924 of
# 21,670,766 compared entries differed (4.3e-5) on an H100 80GB HBM3 at
# 700 W, on 149 paths, 82 of them 51 bounces long. At none of their
# first differing bounces were the two winners' roots on the plain
# version's ray within one float32 rounding bound of each other
# (gradcheck.tie_gaps: the closest 1.6 bounds; 85 with one root
# missing), so they are no near-ties (PERF.md, open questions).
# book2chap2: 909 of 21,419,333 on 213 paths; none at the two small
# shapes. The gate allows 1e-4, 2.3 times the reading. The pool's
# layout has its own exact gate: the pooled winners equal the kernel's
# own winners of each sample traced alone (gradcheck.pool_faults), and
# train_bwd checks every stored winner it replays (replay_mismatches).
MAX_WINNER_FAULTS = 1e-4
# The plain chain runs this many lanes at a time: at full width its
# replay's (slots, lanes) intersection tables would take gigabytes.
PLAIN_CHUNK = 65536
# Launches captured in one CUDA graph to time a kernel (graph_ms).
GRAPH_LAUNCHES = 20
# The gradient fields [7] and [C2] require to be finite and non-zero.
GRAD_FIELDS = ("sphere_c0", "sphere_radius", "tex_color1", "mat_fuzz",
               "mat_ior", "bg_top")


def bound(ops: float, n_bytes: float, int_ops: float = 0.0):
    """(bound_ms, bound_by): the largest of the FP32 operations over the
    FP32 peak, the INT32 operations over the INT32 rate, and the bytes
    (each input read once, each output written once) over the memory
    rate."""
    t_ops = max(ops / FP32_PEAK, int_ops / int32_rate() if int_ops else 0)
    t_bytes = n_bytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


@functools.cache
def int32_rate() -> float:
    from rrt_tpu_torch import probes
    return probes.int32_rate(torch.device("cuda:0"))


def train_bounds(traced, spp: int, n_slots: int, moving: bool):
    """The least times of one train launch whose forward traced `traced`
    (P,) segments a pixel: (train_fwd's, train_bwd's, the step's), each
    (ms, by). The forward scans every slot for every segment and writes
    the residual; the backward scans only for the segments past a
    pixel's winner pool (mkt.winner_capacity), and reads the residual.
    The step counts one scan a segment, both kernels' other work and
    both kernels' bytes."""
    from rrt_tpu_torch.ops import megakernel_train as mkt
    n_pix = traced.numel()
    segments = int(traced.sum())
    stored = int(traced.long().clamp(max=mkt.winner_capacity(spp)).sum())
    paths = n_pix * spp
    scan = segments * n_slots * slot_flops(moving)
    bwd_ops = (segments * BWD_SEGMENT_FLOPS
               + (segments - stored) * n_slots * slot_flops(moving))
    # The same draws in both kernels (THREEFRY_PER_HIT).
    fwd_int = bwd_int = THREEFRY_OPS * (
        THREEFRY_PER_HIT * (segments - paths) + THREEFRY_PER_PATH * paths)
    pack_bytes = 4 * (24 * n_slots + 24 + 8)
    residual = paths + 2 * stored  # lengths, stored winners
    fwd_bytes = pack_bytes + n_pix * (12 + 4) + residual
    bwd_bytes = 2 * pack_bytes + n_pix * 12 + residual + 4
    return (bound(scan, fwd_bytes, fwd_int),
            bound(bwd_ops, bwd_bytes, bwd_int),
            bound(scan + segments * BWD_SEGMENT_FLOPS,
                  fwd_bytes + bwd_bytes, fwd_int + bwd_int))


def residual_line(traced, lengths, spp: int) -> str:
    """The path-length histogram of a forward's lengths (spp, P) and the
    share of its segments past the winner pool."""
    from rrt_tpu_torch.ops import megakernel_train as mkt
    hist = torch.bincount(lengths.flatten().long()).tolist()
    head = ", ".join(f"{n}: {hist[n]}" for n in range(1, min(9, len(hist))))
    tail = sum(hist[9:])
    segments = int(traced.sum())
    past = segments - int(traced.long().clamp(
        max=mkt.winner_capacity(spp)).sum())
    return (f"path lengths {{{head}, >8: {tail}}}, longest "
            f"{len(hist) - 1}; {past} of {segments} segments "
            f"({past / segments:.3e}) past the pool of "
            f"{mkt.WINNERS_PER_SAMPLE} winners a sample")


def spread_line(v) -> str:
    """The least and largest of v and its 10%, 50% and 90% points."""
    ranked = v.sort().values.tolist()
    if not ranked:
        return "none"
    spots = ", ".join(
        f"{q}: {ranked[min(int(q * len(ranked)), len(ranked) - 1)]:.2e}"
        for q in (0.1, 0.5, 0.9))
    return f"{ranked[0]:.3e} to {ranked[-1]:.3e} ({spots})"


def slot_flops(moving: bool) -> int:
    return FLOPS_PER_MOVING_SLOT if moving else FLOPS_PER_SLOT


def tile_bounds(segments, paths, n_slots, counts, moving: bool):
    """tile_render's least times for `segments` segments of `paths`
    paths, each (ms, by): the walk's (its FP32 tests at `counts`' tests a
    segment, the Threefry draws as train_bounds counts them, the packs
    read and the pixels written once) and the scan's (every slot a
    segment, FP32 only: the work of the scan the kernel replaced)."""
    n_bytes = 4 * (24 * n_slots + 24 + 8) + (12 + 4) * (
        MAIN["width"] * MAIN["height"])
    draws = THREEFRY_OPS * (THREEFRY_PER_HIT * (segments - paths)
                            + THREEFRY_PER_PATH * paths)
    return (bound(walk_flops(segments, counts, moving), n_bytes, draws),
            bound(segments * n_slots * slot_flops(moving), n_bytes))


def tile_bvh(packs):
    """The BVH tile_render walks on the packs (sph24, cam24, ...): over
    the camera pack's shutter, rows 19-20 (render._packs' rule)."""
    from rrt_tpu_torch import accel
    cam24 = packs[1].detach()
    return accel.pack_bvh(packs[0].detach(),
                          (cam24[19], cam24[19] + cam24[20]))


def walk_counts(scene, cam, w, h, n, device):
    """The walk's tests on [Q1]'s rays: n camera rays of the w x h image
    (lane_state), and the live ones after 1-4 bounce steps, through
    accel.bvh_closest_reference. Returns {"depth": [(segments, node
    tests, slot tests) at each of the 5 depths], "nodes", "slots": the
    tests a segment over all 5, "bvh": the pack (render.trace_queue's:
    over the camera's shutter)}."""
    from rrt_tpu_torch import accel, render
    from rrt_tpu_torch.ops import megakernel as mk
    st, keys, sph, bg = lane_state(scene, cam, w, h, n, device)
    bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
    rows = []
    for depth in range(5):
        if depth:
            mk.bounce_steps(st, keys, sph, bg, k_steps=1,
                            max_depth=MAIN["max_depth"], t_min=1e-3,
                            moving=scene.has_moving, bvh=bvh)
        live = (st[14] > 0.5).nonzero()[:, 0]
        sel = st[:, live]
        _, _, _, nodes, slots = accel.bvh_closest_reference(
            sel[0:3].contiguous(), sel[3:6].contiguous(), sph, bvh,
            t_min=1e-3, time=sel[6].contiguous() if scene.has_moving
            else None)
        rows.append((live.numel(), int(nodes.sum()), int(slots.sum())))
    segments = sum(r[0] for r in rows)
    return dict(depth=rows, bvh=bvh,
                nodes=sum(r[1] for r in rows) / segments,
                slots=sum(r[2] for r in rows) / segments)


def walk_flops(segments, counts, moving: bool) -> float:
    """FP32 operations of `segments` walks at counts' tests a segment."""
    return segments * (WALK_RAY_FLOPS + counts["nodes"] * NODE_FLOPS
                       + counts["slots"] * slot_flops(moving))


def hits(st, out) -> int:
    """Segments that hit a sphere between a lane state st and the state
    out some bounce steps later: the traced segments less the lanes
    that missed (their pending radiance gained the background, which
    is not black in these scenes). A hit draws THREEFRY_PER_HIT calls."""
    segments = int((out[15] - st[15]).sum())
    return segments - int((out[10:13] != st[10:13]).any(dim=0).sum())


def walk_line(what, counts, moving: bool) -> str:
    """The tree's size and the walk's tests a segment, for printing."""
    b = counts["bvh"]
    per = ", ".join(f"{r[1] / r[0]:.2f}/{r[2] / r[0]:.2f}"
                    for r in counts["depth"])
    return (f"{what} BVH: {b.n_nodes} nodes, {b.n_rows} rows "
            f"({b.n_always} tested by every segment), depth {b.depth}, "
            f"{b.smem_bytes(moving)} bytes of shared memory; node/slot "
            f"tests a segment at depths 0-4: {per}; over all "
            f"{counts['nodes']:.3f}/{counts['slots']:.3f} (the scan: "
            f"{b.n_slots} slots)")


def check(ok: bool, what) -> None:
    """Fail the run (a check that `python -O` does not strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() over `repeats` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def graph_ms(fn, *wrappers) -> float:
    """Mean device milliseconds of one fn() call: GRAPH_LAUNCHES calls
    captured into a CUDA graph and replayed between two CUDA events, so
    the host's launch cost is not counted. fn launches on
    torch.cuda.current_stream(), as the wrappers do; it runs once first,
    so that nothing is built or loaded during the capture. The capture
    adds to the `wrappers`' launch and mismatch counts; they are put
    back as they were."""
    saved = [(w, dict(vars(w))) for w in wrappers]
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    for w, attrs in saved:
        vars(w).update(attrs)
    return start.elapsed_time(end) / GRAPH_LAUNCHES


class Phases:
    """Prints each phase's tag as it starts and its wall time as it
    ends (when the next one starts, or at `end`)."""

    def __init__(self):
        self.tag, self.t0 = None, 0.0

    def start(self, tag: str, title: str) -> None:
        self.end()
        print(f"[{tag}] {title}", flush=True)
        self.tag, self.t0 = tag, time.perf_counter()

    def end(self) -> None:
        if self.tag is not None:
            print(f"  [{self.tag}] wall {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
            self.tag = None


def peak_memory(what: str, device, card) -> None:
    print(f"  {what} peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB  [{card}]",
          flush=True)


def compare(mk, tscenes, device, card, *, width, height, spp, max_depth,
            repeats=1, name="chap12"):
    """Kernel vs plain version on the card, on the same packs. Returns
    (kernel out, plain out, kernel ms, plain ms)."""
    scene, cam = tscenes.SCENES[name](width, height)
    packs = (mk.pack_spheres_full(scene).to(device),
             mk.pack_camera(cam, width, height).to(device),
             mk.pack_bg(scene).to(device))
    kw = dict(seed_words=(0, 0), sample_lo=0, width=width, height=height,
              spp=spp, max_depth=max_depth, t_min=1e-3,
              moving=scene.has_moving)
    bvh = tile_bvh(packs)
    out = mk.render_tiles(*packs, bvh=bvh, **kw)  # warm-up
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw), repeats)
    t0 = time.perf_counter()
    ref = mk.render_tiles_reference(*packs, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"  {name} {width}x{height} {spp}spp d{max_depth}: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms  [{card}]", flush=True)
    return out, ref, ms, plain_ms


def checker_scene(w, h):
    """The checker-texture, solid-background scene of
    tests/test_torch_cuda.py: the kernels' branches chap12 does not
    reach."""
    from rrt_tpu_torch.camera import Camera
    from rrt_tpu_torch.scene import SceneBuilder
    b = SceneBuilder()
    tex = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=10.0)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(tex))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.metal((0.7, 0.6, 0.5), fuzz=0.3))
    b.sphere((-2.5, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.solid_background((0.3, 0.4, 0.5))
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=w / h, aperture=0.1,
                        focus_dist=10.0)
    return b.build(), cam


def wall_ms(fn):
    """(fn(), host milliseconds around it, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def train_vs_plain(name, w, h, spp, depth, device, card, *,
                   min_pixels=0.99, min_paths=0.0, plain_chunk=1 << 16):
    """[5] The train kernels against tile_render and their plain
    versions on one configuration, by rrt_tpu_torch.gradcheck's rule:
    at least `min_pixels` of pixels and `min_paths` of paths agree
    sample by sample; the pixels that do not get loss weight 0. The
    forward's rad, traced and lengths equal tile_render's bit for bit
    and its winners the plain version's on every agreeing path; the
    backward from the winners gives the camera and background
    cotangents of the scan alone (winners=None) bit for bit, and the
    pack's within PACK_SPREAD of their largest."""
    from rrt_tpu_torch import diff, gradcheck, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    build = checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=scene.has_moving)
    rad, traced, lengths, winners = mkt.render_tiles_train(*packs, **kw)
    ref_rad, ref_traced = mk.render_tiles(*packs, bvh=tile_bvh(packs), **kw)
    # tile_render walks the BVH, train_fwd scans: the walk's exact gate.
    check(torch.equal(rad, ref_rad) and torch.equal(traced, ref_traced),
          "train_fwd (the scan) differs from tile_render (the walk)")
    check(torch.equal(lengths.sum(dim=0, dtype=torch.int32), traced),
          "lengths do not add up to the traced counts")
    print(f"  {name} {w}x{h} {spp}spp d{depth}: "
          f"{residual_line(traced, lengths, spp)}", flush=True)
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    agreement = gradcheck.sample_agreement(packs, kw)
    frac = agreement.agree.float().mean().item()
    check(frac >= min_pixels and agreement.path_share >= min_paths,
          ("forward agreement", frac, agreement.path_share))
    w_faults, w_compared, differ = gradcheck.winner_faults(
        winners, lengths, agreement)
    key = differ[:, [1, 3, 4]]  # bounce, kernel's winner, plain's winner
    pairs, counts = key.unique(dim=0, return_counts=True) \
        if w_faults else (key, key[:, 0])
    top = [(tuple(pairs[i].tolist()), int(counts[i]))
           for i in counts.argsort(descending=True)[:5].tolist()]
    print(f"  winners: {w_faults} of {w_compared} stored entries of agreeing "
          f"paths differ from the plain version's "
          f"({w_faults / max(w_compared, 1):.2e}, gate "
          f"{MAX_WINNER_FAULTS:.0e}); by bounce "
          f"{torch.bincount(differ[:, 1]).tolist()}, most often (bounce, "
          f"kernel's, plain's): {top}", flush=True)
    firsts = gradcheck.first_differences(differ)
    ties = gradcheck.tie_gaps(packs, kw, firsts)
    ended = lengths[firsts[:, 0], firsts[:, 2]] == depth + 1
    both = ties.gap.isfinite()
    print(f"  {firsts.shape[0]} paths hold them, {int(ended.sum())} of them "
          f"{depth + 1} bounces long; at each one's first differing bounce, "
          f"on the plain version's ray (float64), one of the two winners "
          f"has no root on {int((~both).sum())}; on the others the roots "
          f"are apart by {spread_line(ties.gap[both])} relative and by "
          f"{spread_line(ties.ulps[both])} of their float32 rounding "
          f"bounds, {int((ties.ulps <= 1).sum())} within one (a near-tie); "
          f"the plain replay retraced "
          f"{int((ties.replayed == firsts[:, 4]).sum())}", flush=True)
    p_faults, p_compared = gradcheck.pool_faults(winners, lengths, agreement)
    print(f"  pooled winners vs each sample traced alone: {p_faults} of "
          f"{p_compared} differ (rule: 0)", flush=True)
    check(torch.equal(ties.replayed, firsts[:, 4]),
          "tie_gaps' replay differs from the plain version's winners")
    check(w_compared > 0 and w_faults <= MAX_WINNER_FAULTS * w_compared,
          ("winners vs the plain version", w_faults, w_compared))
    check(p_compared > 0 and p_faults == 0,
          ("pooled winners vs each sample alone", p_faults, p_compared))
    weight = torch.sin(torch.arange(w * h, device=device) * 0.1) \
        * agreement.agree
    d_rad = (weight[:, None] * torch.tensor(MIX, device=device)).contiguous()
    k = mkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, lengths,
                                               winners, **kw), 3)
    scan = mkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
    scan_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, lengths,
                                                None, **kw), 3)
    spread = ((k[0] - scan[0]).abs().max()
              / scan[0].abs().max().clamp(min=1e-30)).item()
    same = torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])
    p, bwd_plain_ms = wall_ms(lambda: mkt.tiles_adjoint_reference(
        *packs, d_rad, agreement.lengths, None, chunk=plain_chunk, **kw))
    mism, s_mism, p_mism = int(k[3]), int(scan[3]), int(p[3])
    print(f"  backward from the winners vs the scan "
          f"alone: d_cam and d_bg bit-equal {same}, d_sph within "
          f"{spread:.2e} of its largest (gate {PACK_SPREAD:.0e}); "
          f"replay_mismatches {mism}, {s_mism}, plain {p_mism}", flush=True)
    check(mism == 0 and s_mism == 0 and p_mism == 0,
          ("replay_mismatches", mism, s_mism, p_mism))
    check(same and spread <= PACK_SPREAD, ("winners vs scan", same, spread))
    kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], device=device)
    faults, err = gradcheck.field_grad_faults(kp, kc, pp, pc)
    check(not faults, ("gradients", faults))
    fwd_err = ((rad - agreement.rad).abs().max() / spp).item()
    fwd_plain_ms = agreement.plain_seconds * 1e3
    print(f"  {name} {w}x{h} {spp}spp d{depth}: train_fwd == tile_render, "
          f"{frac:.4f} of pixels and {agreement.path_share:.5f} of paths "
          f"agree with the plain version, replay_mismatches {mism}, max "
          f"|grad delta| {err:.3e}; train_fwd {fwd_ms:.3f} ms (plain "
          f"{fwd_plain_ms:.1f} ms), train_bwd {bwd_ms:.3f} ms, "
          f"{scan_ms:.3f} ms without the winners (plain "
          f"{bwd_plain_ms:.1f} ms)  [{card}]", flush=True)
    fwd_bound, bwd_bound, step_bound = train_bounds(
        traced, spp, packs[0].shape[1], scene.has_moving)
    print(f"  bounds: train_fwd {fwd_bound[0]:.4f} ms ({fwd_bound[1]}), "
          f"train_bwd {bwd_bound[0]:.4f} ms ({bwd_bound[1]}), the step "
          f"{step_bound[0]:.4f} ms ({step_bound[1]}) against the kernels' "
          f"{fwd_ms + bwd_ms:.3f} ms", flush=True)
    return dict(fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms, bwd_ms=bwd_ms,
                bwd_plain_ms=bwd_plain_ms, bwd_scan_ms=scan_ms,
                fwd_err=fwd_err, bwd_err=err, fwd_bound=fwd_bound,
                bwd_bound=bwd_bound, step_bound=step_bound)


def ground_texture(scene):
    return int(scene.mat_tex[scene.sphere_mat[0]])


def finite_differences(device, card):
    """[6] d loss / d (ground albedo red) and d loss / d bg_top[2] from
    train_bwd against central differences of the train_fwd forward at
    full size, loss = sum(MIX . radiance) in float64. Neither parameter
    changes a path decision, so eps = 1e-2 differences agree within 1e-2
    relative."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel_train as mkt
    scene, cam = tscenes.chap12_scene(TRAIN["width"], TRAIN["height"])
    cfg = render.RenderConfig(**TRAIN)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
              height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
              t_min=cfg.t_min, moving=False)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(*packs, **kw)

    packs, (rad, _, lengths, winners) = forward(scene)
    d_sph, d_cam, d_bg, _ = mkt.tiles_adjoint(
        *packs, mix.expand_as(rad).contiguous(), lengths, winners, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, d_sph, d_cam, d_bg,
                             device=device)
    eps = 1e-2
    for field, index in (("tex_color1", (ground_texture(scene), 0)),
                         ("bg_top", (2,))):
        def loss(delta):
            v = getattr(scene, field).clone()
            v[index] += delta
            r = forward(diff.combine(scene, {field: v}))[1][0]
            return (r.double() * mix.double()).sum().item()

        fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
        auto = gp[field][index].item()
        rel = abs(auto - fd) / abs(fd)
        print(f"  d loss / d {field}{list(index)}: train_bwd {auto:.6e}, "
              f"central difference {fd:.6e}, {rel:.2e} apart", flush=True)
        check(auto != 0.0 and rel < 1e-2, (field, auto, fd))


def timed(fn, log):
    """fn with CUDA events recorded around each call into `log` (the
    calls' device time, read after a synchronize)."""
    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        log.append((start, end))
        return out
    return wrapper


def events_ms(log):
    return sum(s.elapsed_time(e) for s, e in log)


def host_timed(fn, log):
    """fn with the host's milliseconds of each call appended to `log`
    (no synchronize: what the calling thread spends in it, waits for
    the device included)."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


@contextlib.contextmanager
def pack_clock():
    """Host clocks on the chain's BVH pack while the block runs: yields
    two logs, the ms of each render.chain_bvh call (its device-to-host
    read, which waits for the queued work, the host build and the copy
    to the card) and of each accel.pack_bvh call inside it (the host
    build alone)."""
    from rrt_tpu_torch import accel, render
    chain_bvh, pack_bvh = render.chain_bvh, accel.pack_bvh
    logs = ([], [])
    render.chain_bvh = host_timed(chain_bvh, logs[0])
    accel.pack_bvh = host_timed(pack_bvh, logs[1])
    try:
        yield logs
    finally:
        render.chain_bvh, accel.pack_bvh = chain_bvh, pack_bvh


@contextlib.contextmanager
def chain_events():
    """CUDA events around TileTrainChain's forward (train_fwd) and
    backward (train_bwd) while the block runs: yields their two logs;
    the launch counts stay on the wrappers."""
    from rrt_tpu_torch.ops import megakernel_train as mkt
    chain = mkt.TileTrainChain
    fwd, bwd = chain.forward, chain.backward
    logs = ([], [])
    chain.forward = staticmethod(timed(fwd, logs[0]))
    chain.backward = staticmethod(timed(bwd, logs[1]))
    try:
        yield logs
    finally:
        chain.forward = staticmethod(fwd)
        chain.backward = staticmethod(bwd)


def step_bound(scene, cam, cfg, device):
    """train_bounds' step bound of make_train_step at cfg, seed 0: one
    launch of cfg.spp samples (cfg.spp <= 64, or one chunk), whose paths
    tile_render traces alike (a color moves no path)."""
    from rrt_tpu_torch import render
    from rrt_tpu_torch.ops import megakernel as mk
    packs = render._packs(scene, cam, cfg, device)
    _, traced = mk.render_tiles(
        *[p.detach() for p in packs], bvh=tile_bvh(packs), seed_words=(0, 0),
        sample_lo=0,
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_depth=cfg.max_depth, t_min=cfg.t_min, moving=scene.has_moving)
    return train_bounds(traced, cfg.spp, packs[0].shape[1],
                        scene.has_moving)[2]


def print_step(what, fwd_ms, bwd_ms, bnd, device, card) -> None:
    kernels = fwd_ms + bwd_ms
    print(f"  {what}: train_fwd {fwd_ms:.2f} ms + train_bwd {bwd_ms:.2f} ms "
          f"= {kernels:.2f} ms; step_bound_ms {bnd[0]:.4f} ({bnd[1]}), "
          f"{bnd[0] / kernels:.2%} of the kernels' time; peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB  "
          f"[{card}]", flush=True)


# The profiler's readings are printed and never checked: whether CUPTI
# records the card's kernels depends on the machine, not on the port.


def profile_rows(events):
    """(name, device ms, count) of each device entry of a profile's
    key_averages()."""
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]


def print_profile(rows, wall, card) -> None:
    """Print the six largest rows and the device's busy share of `wall`
    host milliseconds, or that the profile holds no device events."""
    if not rows:
        print(f"    no device events recorded ({wall:.2f} ms wall)  "
              f"[{card}]", flush=True)
        return
    busy = sum(r[1] for r in rows)
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"    {t:10.3f} ms  x{n:<4d} {key[:70]}")
    print(f"    device busy {busy:.2f} ms of {wall:.2f} ms wall "
          f"({busy / max(wall, 1e-9):.1%})  [{card}]", flush=True)


def print_per_step(what, rows, wall, n, kernel, card) -> None:
    """Print a profiled run's wall, device busy and `kernel` time per
    step, over its n steps."""
    n = max(n, 1)
    if not rows:
        print(f"  per {what} ({n}): wall {wall / n:.3f} ms; no device events "
              f"recorded  [{card}]", flush=True)
        return
    busy = sum(r[1] for r in rows)
    k_ms = sum(t for key, t, _ in rows if kernel in key)
    print(f"  per {what} ({n}): wall {wall / n:.3f} ms, device busy "
          f"{busy / n:.3f} ms ({kernel} {k_ms / n:.3f} ms), device idle "
          f"{(wall - busy) / n:.3f} ms  [{card}]", flush=True)


def device_breakdown(fn, card):
    """Run fn() under torch.profiler and print its device time by kernel
    (print_profile). Returns (rows, wall ms) for print_per_step."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall = wall_ms(fn)
    rows = profile_rows(prof.key_averages())
    print_profile(rows, wall, card)
    return rows, wall


def lane_state(scene, cam, w, h, n, device):
    """A queue state of n camera rays at sample 0 (16, n), its key bits
    and the packs, on the device; the pixels are spread evenly over the
    w x h image."""
    from rrt_tpu_torch import render, rng
    from rrt_tpu_torch.ops import megakernel as mk
    pix = torch.arange(n, device=device) * max(1, w * h // n) % (w * h)
    keys = rng.sample_keys(rng.key_words(0), pix, 0)
    o, d, tm = render.generate_rays(cam.to(device), pix % w, pix // w, w, h,
                                    keys)
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                       one, zero)
    return (st, rng.u32_bits(keys), mk.pack_spheres_full(scene).to(device),
            mk.pack_bg(scene).to(device))


def intersect_vs_plain(what, o, d, tm, sph, moving, bvh):
    """intersect_only against its plain version on the rays (o, d): fam
    and idx equal on >= 99.9% of rays (the card's own spread: they agreed
    on every camera ray at full size), t within 1e-5 relative where they
    agree on a hit (both round every product), misses equal. Returns
    (share of rays agreeing, max |t delta| on agreeing hits, plain ms)."""
    from rrt_tpu_torch.ops import megakernel as mk
    kw = dict(t_min=1e-3, time=tm if moving else None)
    t, fam, idx = mk.intersect_only(o, d, sph, bvh=bvh, **kw)
    (rt, rfam, ridx), plain_ms = wall_ms(
        lambda: mk.intersect_only_reference(o, d, sph, **kw))
    same = (fam == rfam) & (idx == ridx)
    hit = same & (fam == 0)
    miss = same & (fam == -1)
    t_rel = ((t - rt).abs() / rt)[hit].max().item() if hit.any() else 0.0
    frac = same.float().mean().item()
    print(f"  intersect_only {what}: fam and idx agree on {frac:.5f} of "
          f"{o.shape[1]} rays, {int(hit.sum())} hits, t within {t_rel:.2e} "
          f"relative", flush=True)
    check(frac >= 0.999 and t_rel <= 1e-5
          and torch.equal(t[miss], rt[miss]),
          ("intersect_only", what, frac, t_rel))
    abs_err = (t - rt).abs()[hit].max().item() if hit.any() else 0.0
    return frac, abs_err, plain_ms


def queue_kernels_vs_plain(name, w, h, n, batch, device, card):
    """[Q1] bounce_steps (4 steps, depth 50) against its plain version on
    n lanes of camera rays, by the rule of tests/test_torch_queue.py at
    the card's own spread (kernel and plain agreed on 99.995% of lanes
    at full size): alive agrees on >= 99.9% of lanes, traced and bounce
    equal there, throughput and pending radiance within 1e-3 on >= 99.5%
    of them. intersect_only (intersect_vs_plain) on the same n camera
    rays, and on `batch` lanes, the batch driver's rays a pass, before
    and after each of 4 bounce steps (all lanes, the dead keeping their
    last ray, as trace_batch passes them)."""
    from rrt_tpu_torch import scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    build = checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    st, keys, sph, bg = lane_state(scene, cam, w, h, n, device)
    n_slots = sph.shape[1]
    moving = scene.has_moving
    counts = walk_counts(scene, cam, w, h, n, device)
    bvh = counts["bvh"]
    print(f"  {walk_line(name, counts, moving)}", flush=True)
    kw = dict(k_steps=4, max_depth=MAIN["max_depth"], t_min=1e-3,
              moving=moving)
    out = mk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref, plain_ms = wall_ms(
        lambda: mk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw))
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    frac = agree.float().mean().item()
    equal = (torch.equal(out[13][agree], ref[13][agree])
             and torch.equal(out[15][agree], ref[15][agree]))
    err = (out[7:13] - ref[7:13]).abs().amax(dim=0)[agree]
    close = (err < 1e-3).float().mean().item()
    work, log = torch.empty_like(st), []
    for _ in range(5):  # in place: each launch starts from the same state
        work.copy_(st)
        timed(mk.bounce_steps, log)(work, keys, sph, bg, bvh=bvh, **kw)
    torch.cuda.synchronize()
    ms = events_ms(log) / len(log)
    segments = int((out[15] - st[15]).sum())
    n_hits = hits(st, out)
    s_bytes = 4 * (n * (16 + 2 + 16) + 24 * n_slots + 8)
    b_ms, b_by = bound(walk_flops(segments, counts, moving), s_bytes,
                       THREEFRY_OPS * THREEFRY_PER_HIT * n_hits)
    scan_bound = bound(segments * n_slots * slot_flops(moving), s_bytes)
    print(f"  bounce_steps {name} {w}x{h}, {n} lanes, 4 steps: alive "
          f"agrees on {frac:.5f} of lanes, counts equal there, {close:.5f} "
          f"within 1e-3 (max {err.max().item():.3e}); {segments} segments, "
          f"{n_hits} hits; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; the walk at "
          f"{counts['nodes']:.2f} node and {counts['slots']:.2f} slot tests "
          f"a segment and the hits' draws), the scan's "
          f"{scan_bound[0]:.4f} ms ({scan_bound[1]})  [{card}]", flush=True)
    check(frac >= 0.999 and equal and close >= 0.995,
          ("bounce_steps", name, frac, equal, close))

    o, d, tm = st[0:3], st[3:6], st[6].contiguous()
    _, i_err, i_plain_ms = intersect_vs_plain(f"{name} {n} camera rays", o,
                                              d, tm, sph, moving, bvh)
    i_ms = graph_ms(lambda: mk.intersect_only(
        o, d, sph, t_min=1e-3, time=tm if moving else None, bvh=bvh),
        mk.intersect_only)
    i_bytes = 4 * (n * (6 + 3 + moving) + 24 * n_slots)
    i_scan_bound = bound(n * n_slots * slot_flops(moving), i_bytes)
    cam_rays, cam_nodes, cam_slots = counts["depth"][0]
    cam_counts = dict(nodes=cam_nodes / cam_rays, slots=cam_slots / cam_rays)
    i_walk = walk_flops(n, cam_counts, moving)
    i_bound = bound(i_walk, i_bytes)
    print(f"  intersect_only {name}, {n} rays: kernel {i_ms:.4f} ms, plain "
          f"{i_plain_ms:.1f} ms, bound {i_bound[0]:.4f} ms ({i_bound[1]}; "
          f"the walk's {cam_counts['nodes']:.2f} node and "
          f"{cam_counts['slots']:.2f} slot tests a ray, "
          f"{i_walk / FP32_PEAK * 1e3:.4f} ms of FP32), the scan's "
          f"{i_scan_bound[0]:.4f} ms ({i_scan_bound[1]})  [{card}]",
          flush=True)
    st_b, keys_b, _, _ = lane_state(scene, cam, w, h, batch, device)
    for depth in range(5):
        if depth:
            mk.bounce_steps(st_b, keys_b, sph, bg, k_steps=1,
                            max_depth=MAIN["max_depth"], t_min=1e-3,
                            moving=moving, bvh=bvh)
        alive = int((st_b[14] > 0.5).sum())
        _, e, _ = intersect_vs_plain(
            f"{name} batch of {batch} after {depth} bounces ({alive} alive)",
            st_b[0:3], st_b[3:6], st_b[6].contiguous(), sph, moving, bvh)
        i_err = max(i_err, e)
    return dict(ms=ms, plain_ms=plain_ms, err=err.max().item(),
                bound=(b_ms, b_by), scan_bound=scan_bound, i_ms=i_ms,
                i_plain_ms=i_plain_ms,
                i_err=i_err, i_bound=i_bound, i_scan_bound=i_scan_bound,
                counts=counts)


def hold_to_tile(what, image, n_traced, tile_image, tile_traced):
    """The rule of [Q2] and [Q3]: the same paths as tile_render, summed in
    another order, so image means within 0.1%, traced totals within
    0.05%, and >= 95% of pixels within 1e-3."""
    mean, tile_mean = image.mean(dim=(0, 1)), tile_image.mean(dim=(0, 1))
    rel = ((mean - tile_mean).abs() / tile_mean).max().item()
    dt = abs(n_traced - tile_traced) / tile_traced
    err = (image - tile_image).abs().amax(dim=2)
    close = (err < 1e-3).float().mean().item()
    print(f"  {what} vs tile: image means {rel:.5%} apart, traced {n_traced} "
          f"vs {tile_traced} ({dt:.5%}), {close:.5f} of pixels within 1e-3, "
          f"max pixel |delta| {err.max().item():.4f}", flush=True)
    check(rel < 1e-3 and dt < 5e-4 and close >= 0.95,
          (what, rel, dt, close))


def chain_rays(device, name="chap12"):
    """[C2]'s rays, bench.py's backward_chain: the scene at MAIN's size,
    CHAIN_LANES lanes at pixel ids * 3, sample 0. Returns (scene, cam,
    cfg, px, py, keys) with px, py, keys on the device."""
    from rrt_tpu_torch import render, rng, scenes as tscenes
    w, h = MAIN["width"], MAIN["height"]
    scene, cam = tscenes.SCENES[name](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=1,
                              max_depth=MAIN["max_depth"])
    ids = torch.arange(CHAIN_LANES, device=device) * (w * h // CHAIN_LANES)
    px, py = ids % w, (ids // w) % h
    keys = rng.sample_keys(rng.key_words(0), py * w + px, 0)
    return scene, cam, cfg, px, py, keys


def by_lanes(fn, *lane_args):
    """fn(*chunk) over PLAIN_CHUNK lanes at a time of the (rows, Q)
    `lane_args`. Each chunk is a contiguous copy, also when it spans all
    Q lanes: bounce_steps_reference updates its state in place. Returns
    the list of the chunks' results."""
    q = lane_args[0].shape[-1]
    return [fn(*(a[..., i:i + PLAIN_CHUNK].clone(
                memory_format=torch.contiguous_format) for a in lane_args))
            for i in range(0, q, PLAIN_CHUNK)]


def chain_vs_plain(what, st, keys, sph, bg, bvh, k_steps, scene, cam, cfg,
                   device, card):
    """[C1] chain_bwd against chain_adjoint_reference on one chain input.
    A lane agrees when the two forwards (bounce_steps and its plain
    version) end it with equal bounce and alive rows and rows 0-12
    within 1e-3 absolute and relative: a near-tie winner flip can leave
    the counts equal and send the lane's gradient to another sphere
    (with the counts alone, 1.4% of chap12's tex_color1 entries broke
    gradcheck's rule at 262,144 lanes on an H100), while the expanded
    quadratic's cancellation on the ground moves hit points in their
    last digits (with 1e-6 absolute, 1% of lanes failed). At least
    MIN_FORWARD_AGREE of lanes must agree; the others get a zero output
    cotangent, the rest a seeded normal one. Each version's replay is
    held to its own forward's bounce row. The plain versions run
    PLAIN_CHUNK lanes at a time (by_lanes).

    A second kernel run must repeat the input cotangent bit for bit (one
    thread computes each lane's, with no atomics) and the background's
    (warp shuffles, then warps and blocks summed in a fixed order), and
    the pack's, which atomic reductions sum, within PACK_SPREAD of their
    largest. Both kernels walk `bvh`. Then, by the rule of
    tests/test_torch_cuda.py: the input cotangent within 1e-3 of each
    row's largest on >= 99.5% of live lanes and equal to d_out on dead
    ones, rows 13-15 zero; the pack and background cotangents by
    rrt_tpu_torch.gradcheck's rule at the level of partition() fields;
    no replay mismatch in either.
    Returns the kernel's forward output and the numbers of the kernels
    line."""
    from rrt_tpu_torch import diff, gradcheck
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    kw = dict(k_steps=k_steps, max_depth=MAIN["max_depth"], t_min=1e-3,
              moving=scene.has_moving)
    out = mk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref_out = torch.cat(by_lanes(
        lambda s, k: mk.bounce_steps_reference(s, k, sph, bg, **kw), st,
        keys), dim=1)
    agree = ((out[mk.ROW_BOUNCE] == ref_out[mk.ROW_BOUNCE])
             & ((out[mk.ROW_ALIVE] > 0.5) == (ref_out[mk.ROW_ALIVE] > 0.5))
             & ((out[:13] - ref_out[:13]).abs()
                <= 1e-3 * ref_out[:13].abs() + 1e-3).all(dim=0))
    frac = agree.float().mean().item()
    gen = torch.Generator().manual_seed(k_steps)
    d_out = (torch.randn(tuple(st.shape), generator=gen).to(device)
             * agree).contiguous()
    ob, ref_ob = out[mk.ROW_BOUNCE].clone(), ref_out[mk.ROW_BOUNCE].clone()
    k = mkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    parts, plain_ms = wall_ms(lambda: by_lanes(
        lambda s, ks, g, b: mkv.chain_adjoint_reference(s, ks, sph, bg, g, b,
                                                        **kw),
        st, keys, d_out, ref_ob))
    # The phase's peak so far ([C1] resets it as it starts): the plain
    # chain is what sets it.
    plain_gb = torch.cuda.max_memory_allocated(device) / 1e9
    p = (torch.cat([x[0] for x in parts], dim=1),
         *(sum(x[j] for x in parts) for j in (1, 2, 3)))
    ms = graph_ms(lambda: mkv.chain_adjoint(st, keys, sph, bg, d_out, ob,
                                            bvh=bvh, **kw), mkv.chain_adjoint)
    k2 = mkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    repeat = ((k2[1] - k[1]).abs().max()
              / k[1].abs().max().clamp(min=1e-30)).item()
    same = torch.equal(k2[0], k[0]) and torch.equal(k2[2], k[2])
    mism = (int(k[3]), int(p[3]))
    live = st[mk.ROW_ALIVE] > 0.5
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    lanes = lane_ok[live].float().mean().item() if live.any() else 1.0
    dead_equal = torch.equal(k[0][:13, ~live], d_out[:13, ~live])
    no_cam = torch.zeros((24,), device=device)
    kp, kc = diff.field_grads(scene, cam, cfg, k[1], no_cam, k[2],
                              device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, p[1], no_cam, p[2],
                              device=device)
    faults, err = gradcheck.field_grad_faults(kp, kc, pp, pc)
    rel = max(((kp[f] - pp[f]).abs().max()
               / pp[f].abs().max().clamp(min=1e-30)).item() for f in pp)
    segments = int((out[mk.ROW_TRACED] - st[mk.ROW_TRACED]).sum())
    print(f"  chain_bwd {what}, {st.shape[1]} lanes ({int(live.sum())} "
          f"alive), k={k_steps}: forwards agree on {frac:.5f} of lanes "
          f"(rule {MIN_FORWARD_AGREE}), input cotangent within 1e-3 on "
          f"{lanes:.5f} of live lanes (rule 0.995), dead lanes pass d_out "
          f"{dead_equal}, replay_mismatches {mism}, max |field grad delta| "
          f"{err:.3e} (largest over a field's largest gradient: {rel:.3e}, "
          f"rule 2e-3); a repeat: input and background cotangents bit-equal "
          f"{same}, the pack's within {repeat:.2e} (rule {PACK_SPREAD:g}); "
          f"{segments} segments; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"([C1] peak so far {plain_gb:.3f} GB)  [{card}]", flush=True)
    check(frac >= MIN_FORWARD_AGREE and lanes >= 0.995 and dead_equal
          and not faults and mism == (0, 0) and not k[0][13:].any() and same
          and repeat <= PACK_SPREAD,
          ("chain_bwd", what, frac, lanes, dead_equal, faults, mism, same,
           repeat))
    return out, dict(ms=ms, plain_ms=plain_ms, segments=segments, err=err,
                     hits=hits(st, out), q=st.shape[1], n_slots=sph.shape[1],
                     moving=scene.has_moving)


def chain_small_cases(device, card):
    """[C1] on the checker scene at 64x32 lanes: chains of 4 and 1 steps
    from camera rays and of 12 after 3 steps; a chain whose lanes are
    all dead (the input cotangent is d_out); PACK_REPEATS runs at the
    pack's own slots and at MAX_SLOTS. The slots past the pack's copy its
    last slot, an empty one, which no ray hits: the same arithmetic runs
    for every lane, so its input cotangent and the fixed-order
    background sums are bit-equal by construction; the empty slots get
    no cotangent and the pack's (atomics) agree within PACK_SPREAD."""
    from rrt_tpu_torch import accel, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    w, h = 64, 32
    scene, cam = checker_scene(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=1, max_depth=50)
    st, keys, sph, bg = lane_state(scene, cam, w, h, w * h, device)
    bvh = accel.pack_bvh(sph)
    for k_steps, pre in ((4, 0), (1, 0), (12, 3)):
        s0 = st.clone()
        if pre:
            mk.bounce_steps(s0, keys, sph, bg, k_steps=pre, max_depth=50,
                            t_min=1e-3, moving=False, bvh=bvh)
        chain_vs_plain(f"checker after {pre} steps", s0, keys, sph, bg, bvh,
                       k_steps, scene, cam, cfg, device, card)
    kw = dict(k_steps=4, max_depth=50, t_min=1e-3, moving=False, bvh=bvh)
    gen = torch.Generator().manual_seed(1)
    d_out = torch.randn(tuple(st.shape), generator=gen).to(device)
    dead = st.clone()
    dead[mk.ROW_ALIVE] = 0.0
    d_st, d_sph, d_bg, mism = mkv.chain_adjoint(
        dead, keys, sph, bg, d_out, dead[mk.ROW_BOUNCE].clone(), **kw)
    dead_ok = (torch.equal(d_st[:13], d_out[:13]) and not d_st[13:].any()
               and not d_sph.any() and not d_bg.any() and int(mism) == 0)
    n = sph.shape[1]
    empty_pad = bool(sph[7, -1] < 0.5)  # the pack's last slot is empty
    wide = torch.cat([sph, sph[:, -1:].expand(-1, mk.MAX_SLOTS - n)],
                     dim=1).contiguous()
    wide_kw = dict(kw, bvh=accel.pack_bvh(wide))
    out = mk.bounce_steps(st.clone(), keys, sph, bg, **kw)
    ob = out[mk.ROW_BOUNCE].clone()
    a = mkv.chain_adjoint(st, keys, sph, bg, d_out, ob, **kw)
    largest = a[1].abs().max().item()
    spread = {"repeat": 0.0, f"{mk.MAX_SLOTS} slots": 0.0}
    equal = {k: True for k in spread}
    for _ in range(PACK_REPEATS):
        for what, pack, pkw in (("repeat", sph, kw),
                                (f"{mk.MAX_SLOTS} slots", wide, wide_kw)):
            b = mkv.chain_adjoint(st, keys, pack, bg, d_out, ob, **pkw)
            equal[what] &= (torch.equal(a[0], b[0])
                            and torch.equal(a[2], b[2])
                            and not b[1][:, n:].any() and int(b[3]) == 0)
            spread[what] = max(spread[what], (b[1][:, :n] - a[1]).abs()
                               .max().item() / largest)
    print(f"  chain_bwd checker: dead lanes pass d_out through {dead_ok}; "
          f"over {PACK_REPEATS} runs, each at {n} and at {mk.MAX_SLOTS} "
          f"slots (padded with an empty slot: {empty_pad}), the input and "
          f"background cotangents bit-equal, the padding without cotangent "
          f"and no mismatch: " + ", ".join(f"{v} ({k})" for k, v in
                                           equal.items())
          + "; the pack's within "
          + ", ".join(f"{v:.3e} ({k})" for k, v in spread.items())
          + f" of the largest, {largest:.4e} (rule {PACK_SPREAD:g})",
          flush=True)
    check(dead_ok, "chain_bwd on dead lanes")
    check(empty_pad and all(equal.values()), ("chain_bwd", equal))
    check(max(spread.values()) <= PACK_SPREAD, ("chain_bwd pack", spread))


def grads_check(what, gp, gc):
    """The gradients of [7], [C2] and [C3]: finite, and not zero for
    GRAD_FIELDS and the camera's look_from."""
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), (what, "non-finite", key))
    for key in GRAD_FIELDS:
        check(gp[key].abs().max().item() > 0, (what, "zero gradient", key))
    check(gc[0].abs().max().item() > 0, (what, "zero gradient: look_from"))


def batch_loss_and_grads(cfg, scene, cam, target, seed, device):
    """The MSE loss of render_image(differentiable=True) against `target`
    and its gradients: (image, n_traced, loss, partition() gradients,
    the nine Camera gradients)."""
    from rrt_tpu_torch import diff, render
    scene_d, params, camera = diff._leaves(scene, cam, device)
    img, n = render.render_image(scene_d, camera, cfg, seed,
                                 differentiable=True, device=device)
    loss = torch.mean((img - target) ** 2)
    gp, gc = diff._grads(loss, params, camera)
    return img.detach(), int(n), loss.detach(), gp, gc


def chain_bound(c1, counts):
    """chain_bwd's least times over [C1]'s three chains, each (ms, by):
    the walk's and the scan's. The walk's: the replay's walk at counts'
    tests a segment ([Q1]'s, walk_flops) and the draws of its hits
    (THREEFRY_PER_HIT calls; the sweep reshades from what the replay
    kept and draws nothing), ADJOINT_FLOPS a replayed segment; bytes: a
    lane's state, keys, output cotangent and bounce row in and its input
    cotangent out, the packs in and their cotangents out, each chain:
    what the function needs, as train_bounds counts it. The kernel's
    per-block partials of the pack cotangents are its design, not the
    function's work, and stay out of both bounds (partial_bytes prints
    them). The scan's, the work of the replay that scanned: every slot a
    replayed segment (FLOPS_PER_SLOT a ray-slot test) and ADJOINT_FLOPS,
    the same bytes."""
    n_slots, moving = c1[0]["n_slots"], c1[0]["moving"]
    segments = sum(c["segments"] for c in c1)
    lane_bytes = sum(4 * (c["q"] * (16 + 2 + 16 + 1 + 16) + 36 * n_slots
                          + 16) for c in c1)
    draws = THREEFRY_OPS * THREEFRY_PER_HIT * sum(c["hits"] for c in c1)
    return (bound(walk_flops(segments, counts, moving)
                  + segments * ADJOINT_FLOPS, lane_bytes, draws),
            bound(segments * (n_slots * slot_flops(moving) + ADJOINT_FLOPS),
                  lane_bytes))


def partial_bytes(c1) -> int:
    """The bytes chain_bwd's per-block partials of the pack cotangents
    take over [C1]'s chains (256 lanes a block, SLOT_COLS floats a slot
    and 8 of the background, written and read once): informational,
    outside chain_bound."""
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    n_slots = c1[0]["n_slots"]
    return sum(2 * 4 * -(-c["q"] // 256) * (mkv.SLOT_COLS * n_slots + 8)
               for c in c1)


def chain_kernel_phase(device, card, counts, name="chap12"):
    """[C1] chain_bwd against its plain version on each chain of [C2]'s
    path on the scene (the kernels' forward gives each chain's input;
    both walk the BVH render.trace_batch_fused builds, over the rays'
    own times) and, on chap12, on chain_small_cases. counts: [Q1]'s
    walk_counts on the scene, for the walk's bound. Returns (per-chain
    numbers, [C2]'s inputs)."""
    from rrt_tpu_torch import render, rng
    from rrt_tpu_torch.ops import megakernel as mk
    scene, cam, cfg, px, py, keys = chain_rays(device, name)
    sph = mk.pack_spheres_full(scene).to(device)
    bg = mk.pack_bg(scene).to(device)
    n = px.shape[0]
    o, d, tm = render.generate_rays(cam.to(device), px, py, cfg.width,
                                    cfg.height, keys)
    bvh = render.chain_bvh(sph, tm, scene.has_moving)
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                       one, zero)
    kbits, lane = rng.u32_bits(keys), torch.arange(n, device=device)
    schedule = render._fused_schedule(cfg.max_depth)
    c1 = []
    for j, k_steps in enumerate(schedule):
        out, numbers = chain_vs_plain(
            f"chain {j + 1} of {schedule}", st, kbits, sph, bg, bvh,
            k_steps, scene, cam, cfg, device, card)
        c1.append(numbers)
        if j < len(schedule) - 1:
            st, kbits, lane = render._compact_lanes(out, kbits, lane)
    if name == "chap12":
        chain_small_cases(device, card)
    (b_ms, b_by), scan = chain_bound(c1, counts)
    ms = sum(c["ms"] for c in c1)
    print(f"  {name}'s three chains: chain_bwd {ms:.4f} ms "
          f"({ms / len(c1):.4f} a launch), plain "
          f"{sum(c['plain_ms'] for c in c1):.1f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; the walk at {counts['nodes']:.2f} node and "
          f"{counts['slots']:.2f} slot tests a segment, the hits' draws), "
          f"the scan's {scan[0]:.4f} ms ({scan[1]}); the kernel's "
          f"partials {partial_bytes(c1) / 1e6:.1f} MB (outside the bound); "
          f"{sum(c['segments'] for c in c1)} replayed segments, "
          f"{sum(c['hits'] for c in c1)} hits  [{card}]", flush=True)
    return c1, (scene, cam, cfg, px, py, keys)


def chain_step_phase(chain, device, card):
    """[C2] the main path: bench.py's backward_chain in the port, a
    warm-up and three timed gradient steps, the chains' forwards and
    backwards by CUDA events, one more step under torch.profiler.
    Returns the launches of (bounce_steps, chain_bwd) in the timed
    steps."""
    from rrt_tpu_torch import diff, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    scene, cam, cfg, px, py, keys = chain

    def step():
        scene_d, params, camera = diff._leaves(scene, cam, device)
        o, d, tm = render.generate_rays(camera, px, py, cfg.width,
                                        cfg.height, keys)
        rad, n = render.trace_batch(scene_d, o, d, tm, keys, cfg.max_depth,
                                    1e-3, differentiable=True,
                                    fused_vjp=True)
        loss = rad[0].mean() + rad[1].mean() + rad[2].mean()
        gp, gc = diff._grads(loss, params, camera)
        return loss.detach(), gp, gc, int(n)

    fwd_log, bwd_log = [], []
    fn = mkv.BounceChain
    fwd, bwd = fn.forward, fn.backward
    fn.forward = staticmethod(timed(fwd, fwd_log))
    fn.backward = staticmethod(timed(bwd, bwd_log))
    step()  # warm-up
    mk.bounce_steps.launches = mkv.chain_adjoint.launches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    runs = []
    for i in range(3):
        fwd_log.clear()
        bwd_log.clear()
        with pack_clock() as (chain_log, build_log):
            (loss, gp, gc, traced), ms = wall_ms(step)
        runs.append((ms, events_ms(fwd_log), events_ms(bwd_log),
                     sum(chain_log), sum(build_log)))
        print(f"  step {i}: loss {loss.item():.6e}, {traced} traced "
              f"segments, chain forwards {runs[-1][1]:.2f} ms, chain "
              f"backwards {runs[-1][2]:.2f} ms, step {ms:.2f} ms, of it "
              f"the chain's BVH pack (render.chain_bvh, host clock) "
              f"{runs[-1][3]:.3f} ms ({100 * runs[-1][3] / ms:.1f}%; "
              f"{len(chain_log)} a step), its host build "
              f"(accel.pack_bvh) {runs[-1][4]:.3f} ms  [{card}]",
              flush=True)
    launches = (mk.bounce_steps.launches, mkv.chain_adjoint.launches)
    mismatches = int(mkv.chain_adjoint.replay_mismatches)
    fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
    med = sorted(runs)[1][0]
    print(f"  median step {med:.2f} ms: {traced / med / 1e3:.4f} Mrays/s "
          f"(traced segments over step wall); launches bounce_steps "
          f"{launches[0]}, chain_bwd {launches[1]}; replay_mismatches "
          f"{mismatches}  [{card}]", flush=True)
    check(min(launches) >= 3,
          ("the chain step did not launch the kernels", launches))
    check(mismatches == 0, ("replay_mismatches", mismatches))
    check(bool(torch.isfinite(loss)), "non-finite chain loss")
    grads_check("[C2]", gp, gc)
    print("  one more step under torch.profiler:", flush=True)
    device_breakdown(step, card)
    return launches


def differentiable_batch_phase(tile_image, tile_traced, device, card):
    """[C3] render_image(differentiable=True) at 1200x800, BATCH_SPP spp
    in one pass of 59 tiles, with the gradient of an L2 loss: held to
    the tile image (tile_image, tile_traced: render_image_tiles at the
    same samples) by hold_to_tile, gradients finite. Then at 240x160 the
    same loss through render_image_diff's route (the train kernels): the
    two drivers trace the same keys and only the eager camera rays
    differ from the kernel's in their last bits; prints how far the
    gradients lie apart, each partition() field against its largest
    gradient, each Camera field against the largest Camera gradient
    (information: no gate reads it)."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    cfg = render.RenderConfig(width=MAIN["width"], height=MAIN["height"],
                              spp=BATCH_SPP, max_depth=MAIN["max_depth"],
                              samples_per_pass=BATCH_SPP)
    scene, cam = tscenes.chap12_scene(cfg.width, cfg.height)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    mk.bounce_steps.launches = mkv.chain_adjoint.launches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    (img, n, loss, gp, gc), ms = wall_ms(lambda: batch_loss_and_grads(
        cfg, scene, cam, target, 0, device))
    launches = (mk.bounce_steps.launches, mkv.chain_adjoint.launches)
    mismatches = int(mkv.chain_adjoint.replay_mismatches)
    print(f"  loss {loss.item():.6e}, {n} traced segments, forward and "
          f"backward {ms / 1e3:.3f} s wall, launches bounce_steps "
          f"{launches[0]}, chain_bwd {launches[1]}, replay_mismatches "
          f"{mismatches}  [{card}]", flush=True)
    check(min(launches) >= 3 and mismatches == 0,
          ("[C3] launches", launches, mismatches))
    hold_to_tile("differentiable batch", img, n, tile_image, tile_traced)
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), ("[C3] non-finite", key))
    cfg_s = dataclasses.replace(cfg, width=240, height=160)
    scene_s, cam_s = tscenes.chap12_scene(240, 160)
    target_s, _ = render.render_image_tiles(scene_s, cam_s, cfg_s, 1,
                                            device=device)
    _, _, loss_b, gp_b, gc_b = batch_loss_and_grads(
        cfg_s, scene_s, cam_s, target_s, 0, device)
    loss_t, gp_t, gc_t = diff.loss_and_grads(cfg_s, scene_s, cam_s,
                                             target_s, 0, device=device)
    spread = {k: ((gp_b[k] - gp_t[k]).abs().max()
                  / gp_t[k].abs().max().clamp(min=1e-30)).item()
              for k in GRAD_FIELDS + ("bg_bottom",)}
    cam_max = max(g.abs().max().item() for g in gc_t)
    for i, f in enumerate(dataclasses.fields(cam_s)):
        spread["camera." + f.name] = (
            (gc_b[i] - gc_t[i]).abs().max().item() / cam_max)
    print(f"  240x160 {BATCH_SPP}spp: losses {loss_b.item():.8e} (batch) "
          f"and {loss_t.item():.8e} (train kernels); max |gradient "
          f"delta| / largest gradient: "
          + ", ".join(f"{k} {v:.3e}" for k, v in spread.items()),
          flush=True)


def motion_tile_phase(device, card):
    """[M1] tile_render's moving variant on book2chap2 at MAIN's size and
    depth: against its plain version at MOTION_SPP spp by [3]'s
    full-size rule, then timed at MAIN's spp. Returns its numbers."""
    from rrt_tpu_torch import scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, depth = MAIN["width"], MAIN["height"], MAIN["max_depth"]
    (rad, traced), (ref, ref_traced), _, plain_ms = compare(
        mk, tscenes, device, card, width=w, height=h, spp=MOTION_SPP,
        max_depth=depth, name="book2chap2")
    mean_k, mean_p = rad.mean(dim=0), ref.mean(dim=0)
    rel = ((mean_k - mean_p).abs() / mean_p).max().item()
    nt, nr = int(traced.sum()), int(ref_traced.sum())
    err = (rad - ref).abs().max(dim=1).values / MOTION_SPP
    close = (err < 1e-3).float().mean().item()
    print(f"  book2chap2 {w}x{h} {MOTION_SPP}spp: image means {rel:.4%} "
          f"apart, traced {nt} vs {nr}, {close:.4f} of pixels within 1e-3, "
          f"max pixel |delta| {err.max().item():.4f}", flush=True)
    check(rel < 1e-2 and abs(nt - nr) / nr < 1e-2 and close >= 0.9,
          ("[M1] tile_render", rel, nt, nr, close))
    scene, cam = tscenes.book2chap2_scene(w, h)
    packs = (mk.pack_spheres_full(scene).to(device),
             mk.pack_camera(cam, w, h).to(device),
             mk.pack_bg(scene).to(device))
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h,
              spp=MAIN["spp"], max_depth=depth, t_min=1e-3, moving=True)
    bvh = tile_bvh(packs)
    _, traced32 = mk.render_tiles(*packs, bvh=bvh, **kw)  # warm-up
    ms = cuda_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw), 3)
    n_slots = packs[0].shape[1]
    segments = int(traced32.sum())
    counts = walk_counts(scene, cam, w, h, QUEUE_LANES, device)
    bnd, scan_bnd = tile_bounds(segments, w * h * MAIN["spp"], n_slots,
                                counts, True)
    print(f"  {walk_line('book2chap2', counts, True)}", flush=True)
    print(f"  book2chap2 {w}x{h} {MAIN['spp']}spp d{depth}: tile_render "
          f"{ms:.3f} ms, {segments} segments, bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), the scan's {scan_bnd[0]:.4f} ms ({scan_bnd[1]})  "
          f"[{card}]", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, err=err.max().item(), bound=bnd,
                scan_bound=scan_bnd, counts=counts)


def motion_cli_phase(device, card):
    """[M2] python -m rrt_tpu_torch.cli with its defaults (book2chap2,
    1200x800, 10 spp, the tile driver), on the card. Returns
    tile_render's launches in the counted run."""
    from rrt_tpu_torch import cli
    from rrt_tpu_torch.ops import megakernel as mk
    png = os.path.join(OUT_DIR, "chip_smoke_book2chap2.png")
    args = cli.build_parser().parse_args(["--device", str(device),
                                          "--quiet", "-o", png])
    check((args.scene, args.resolution, args.samples, args.driver)
          == ("book2chap2", (1200, 800), 10, "auto"), "the CLI's defaults")
    with tempfile.TemporaryDirectory() as tmp:  # warm-up run
        cli.render(cli.build_parser().parse_args(
            ["--device", str(device), "--quiet", "-o",
             os.path.join(tmp, "warm.png")]))
    mk.render_tiles.launches = 0
    res = cli.render(args)
    launches = mk.render_tiles.launches
    n_paths = 1200 * 800 * 10
    nonzero = (res.image.amax(dim=2) > 0).float().mean().item()
    print(f"  {res.seconds:.4f} s wall, {res.n_traced} rays, "
          f"{res.n_traced / res.seconds / 1e6:.2f} Mrays/s, driver "
          f"{res.driver}, tile_render launches {launches}, non-zero pixels "
          f"{nonzero:.4f}  [{card}]", flush=True)
    check(launches >= 1 and res.driver == "tile",
          ("the CLI's default did not launch tile_render", launches,
           res.driver))
    check(bool(torch.isfinite(res.image).all()) and nonzero > 0.99,
          ("[M2] image", nonzero))
    check(n_paths <= res.n_traced <= n_paths * 51, ("traced", res.n_traced))
    check(os.path.getsize(png) > 0, "empty PNG")
    return launches


def moving_sphere_scene(w, h):
    """One moving mirror sphere filling the frame under the sky
    (tests/test_torch_motion.py's finite-difference scene): every path is
    camera -> sphere -> sky, smooth in the sphere's motion (a lambertian
    sphere's grazing scatters re-hit it now and then, which moves path
    lengths under a finite difference)."""
    from rrt_tpu_torch.camera import Camera
    from rrt_tpu_torch.scene import SceneBuilder
    b = SceneBuilder()
    b.moving_sphere((0.0, 0.0, -1.0), (0.05, 0.03, -1.0), 0.0, 1.0, 0.5,
                    b.metal((0.6, 0.3, 0.2), fuzz=0.0))
    cam = Camera.create(look_from=(0.0, 0.0, 1.0), look_at=(0.0, 0.0, -1.0),
                        fov_deg=10.0, aspect=w / h, time0=0.0, time1=1.0)
    return b.build(), cam


def motion_train_phase(device, card):
    """[M3] one 8-spp make_train_step on book2chap2 at 1200x800, depth
    50, with sphere_dc among the leaves; then d loss / d sphere_dc of
    one moving sphere (moving_sphere_scene at 1200x800, 8 spp) from
    train_bwd against central differences of train_fwd (eps 1e-3), loss
    = sum(MIX . radiance) in float64, within 1e-2 of the largest
    component (the plain versions agreed within 7.2e-7 of it at 120x80 on
    a CPU). Returns the launches of (train_fwd, train_bwd)."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel_train as mkt
    cfg = render.RenderConfig(**TRAIN)
    scene, cam = tscenes.book2chap2_scene(cfg.width, cfg.height)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    start = diff.combine(scene, {"sphere_dc": scene.sphere_dc * 0.5})
    step = diff.make_train_step(cfg, lr=1e-3, device=device)
    step(start, cam, target, 0)  # warm-up
    bnd = step_bound(start, cam, cfg, device)
    fwd, bwd = mkt.render_tiles_train, mkt.tiles_adjoint
    fwd.launches = bwd.launches = 0
    bwd.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    with chain_events() as (fwd_log, bwd_log):
        (new, _, loss), ms = wall_ms(lambda: step(start, cam, target, 0))
    launches = (fwd.launches, bwd.launches)
    mism = int(bwd.replay_mismatches)
    moved = (new.sphere_dc.cpu() - start.sphere_dc).abs().max().item()
    print(f"  book2chap2 step: loss {loss.item():.6e}, {ms:.2f} ms, launches "
          f"train_fwd {launches[0]}, train_bwd {launches[1]}, "
          f"replay_mismatches {mism}, sphere_dc moved by up to {moved:.3e}  "
          f"[{card}]", flush=True)
    print_step("the step", events_ms(fwd_log), events_ms(bwd_log), bnd,
               device, card)
    check(min(launches) >= 1 and mism == 0, ("[M3] step", launches, mism))
    check(bool(torch.isfinite(loss)) and moved > 0, ("[M3] sphere_dc",
                                                     moved))
    scene1, cam1 = moving_sphere_scene(cfg.width, cfg.height)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
              height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
              t_min=cfg.t_min, moving=True)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam1, cfg, device)]
        return packs, mkt.render_tiles_train(*packs, **kw)

    packs, (rad, _, lengths, winners) = forward(scene1)
    d_sph, d_cam, d_bg, mism = mkt.tiles_adjoint(
        *packs, mix.expand_as(rad).contiguous(), lengths, winners, **kw)
    gp, _ = diff.field_grads(scene1, cam1, cfg, d_sph, d_cam, d_bg,
                             device=device)
    auto = gp["sphere_dc"][0].cpu()
    eps = 1e-3
    fd = torch.zeros(3, dtype=torch.float64)
    for j in range(3):
        def loss_at(delta):
            dc = scene1.sphere_dc.clone()
            dc[0, j] += delta
            r = forward(diff.combine(scene1, {"sphere_dc": dc}))[1][0]
            return (r.double() * mix.double()).sum().item()
        fd[j] = (loss_at(eps) - loss_at(-eps)) / (2.0 * eps)
    worst = (auto.double() - fd).abs().max().item() / fd.abs().max().item()
    print(f"  d loss / d sphere_dc[0]: train_bwd {auto.tolist()}, central "
          f"differences {fd.tolist()}, {worst:.2e} of the largest apart, "
          f"replay_mismatches {int(mism)}", flush=True)
    check(int(mism) == 0 and worst < 1e-2 and fd.abs().max() > 0,
          ("[M3] finite differences", worst))
    return launches


def probe_phase(device, card):
    """[P1] the three probes: each kernel against its plain version at
    PROBE_CHECK_ITERS iterations (tests/test_torch_cuda.py's rule), then
    each probe's main() at the JAX probe's full ITERS, with the launch
    counts set to 0 just before and read just after. Returns the
    numbers of the kernels line."""
    from rrt_tpu_torch import probes, rng
    from rrt_tpu_torch.probes import probe_reshape, probe_rng, probe_row_layout
    it = PROBE_CHECK_ITERS
    gen = torch.Generator().manual_seed(0)
    # Values near 1, where a chain of 128 steps moves them by about 1.5e-5
    # relative, and values between 1e-8 and 1e-6, where the addend moves
    # them by at least 12%: the kernels are held bit for bit to their
    # plain versions (fmaf's single rounding) on both.
    inputs = ((0.5 + 0.5 * torch.rand((16, 1024), generator=gen)),
              10.0 ** (-8.0 + 2.0 * torch.rand((16, 1024), generator=gen)))
    plain = probe_row_layout.fma_chain_reference
    chain_err = relayout_err = 0.0
    plain_ms = []  # (chain, relayout) of each input
    moved = True
    for x in inputs:
        x = x.to(device)
        chain, chain_ms = wall_ms(lambda: plain(x, iters=it))
        y = probe_row_layout.fma_chain(x, iters=it)
        relayout = probe_reshape.fma_chain_relayout(x, iters=it)
        ref_relayout, relayout_ms = wall_ms(
            lambda: plain(x, iters=it, relayout=True))
        plain_ms.append((chain_ms, relayout_ms))
        moved &= not torch.equal(chain, x)
        chain_err = max(chain_err, (y - chain).abs().max().item())
        relayout_err = max(relayout_err,
                           (relayout - ref_relayout).abs().max().item())
    u = torch.randint(-2**31, 2**31, (1, 1024), generator=gen,
                      dtype=torch.int64).to(torch.int32).to(device)
    rng_err, rng_plain_ms = 0, 0.0
    for mode in probe_rng.MODES:
        ref, ms = wall_ms(lambda: probe_rng.mix_reference(u, mode=mode,
                                                          iters=it))
        rng_plain_ms += ms
        out = probe_rng.mix(u, mode=mode, iters=it)
        diff = rng.from_u32_bits(out) - rng.from_u32_bits(ref)
        rng_err = max(rng_err, diff.abs().max().item())
    print(f"  at {it} iterations, near 1 and between 1e-8 and 1e-6: "
          f"fma_chain's largest difference from its plain version "
          f"{chain_err:.3e}, fma_chain_relayout's {relayout_err:.3e} (rule: "
          f"0, fmaf's single rounding in both); the three mixers' largest "
          f"difference {rng_err} (rule: 0)", flush=True)
    check(moved and chain_err == 0.0 and relayout_err == 0.0
          and rng_err == 0,
          ("[P1] probes vs plain", moved, chain_err, relayout_err, rng_err))
    wrappers = (probe_row_layout.fma_chain, probe_reshape.fma_chain_relayout,
                probe_rng.mix)
    for w in wrappers:
        w.launches = 0
    for mod in (probe_row_layout, probe_rng, probe_reshape):
        check(mod.main() == 0, (mod.__name__, "main"))
    launches = [w.launches for w in wrappers]
    print(f"  launches: fma_chain {launches[0]}, fma_chain_relayout "
          f"{launches[1]}, rng {launches[2]}", flush=True)
    check(min(launches) >= 1, ("[P1] launches", launches))
    rows = probe_row_layout.run(device)
    reshape_rows = probe_reshape.run(device)
    rng_rows = probe_rng.run(device)
    clock = probes.sm_clock_hz()
    print(f"  max SM clock {clock / 1e9:.3f} GHz, INT32 "
          f"{probes.int32_rate(device) / 1e12:.2f} Tops/s  [{card}]",
          flush=True)
    return dict(
        row=rows, reshape=reshape_rows, rng=rng_rows, launches=launches,
        chain_err=chain_err, chain_plain_ms=plain_ms[0][0],
        relayout_plain_ms=plain_ms[0][1], rng_plain_ms=rng_plain_ms,
        rng_err=float(rng_err), relayout_err=relayout_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from rrt_tpu_torch import cli, diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import _build, megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt

    t_start = time.perf_counter()
    phases = Phases()
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    built = _build.build()
    print(f"[2] built {os.path.relpath(built.path, REPO)} in "
          f"{built.seconds:.1f} s; ptxas, registers (stack, spill stores "
          f"and loads in bytes):", flush=True)
    resources = _build.kernel_resources(built.log)
    for name, r in sorted(resources.items()):
        print(f"  {name}: {r.get('registers')} registers ({r.get('stack')}, "
              f"{r.get('spill_stores')}, {r.get('spill_loads')})")
    for line in built.log.splitlines():  # warnings, if any
        if line.strip() and "ptxas info" not in line \
                and "bytes stack frame" not in line:
            print(f"  {line.strip()}")

    phases.start("3", "kernel vs plain version on the card")
    # 64x32, 4 spp, depth 8: the tolerance of tests/test_torch_slice.py.
    (rad, traced), (ref, ref_traced), _, _ = compare(
        mk, tscenes, device, card, width=64, height=32, spp=4, max_depth=8)
    close = ((rad - ref).abs().max(dim=1).values / 4 < 1e-3).float().mean()
    dt = abs(int(traced.sum()) - int(ref_traced.sum())) / int(
        ref_traced.sum())
    print(f"  64x32: {close.item():.4f} of pixels within 1e-3, traced "
          f"totals {dt:.4%} apart", flush=True)
    check(close.item() >= 0.985 and dt < 1e-2, (close.item(), dt))
    # Depth 50: about 0.13% of paths part ways between two float
    # implementations (1% of 8-spp pixels at 240x160), so at 32 spp
    # about 4% of pixels hold one; the image means and traced totals
    # must agree within 1%, and 90% of pixels within 1e-3.
    for w, h, spp in ((240, 160, 8),
                      (MAIN["width"], MAIN["height"], MAIN["spp"])):
        (rad, traced), (ref, ref_traced), ms, plain_ms = compare(
            mk, tscenes, device, card, width=w, height=h, spp=spp,
            max_depth=MAIN["max_depth"], repeats=3)
        mean_k = rad.mean(dim=0) / spp
        mean_p = ref.mean(dim=0) / spp
        rel = ((mean_k - mean_p).abs() / mean_p).max().item()
        nt, nr = int(traced.sum()), int(ref_traced.sum())
        err = (rad - ref).abs().max(dim=1).values / spp
        close = (err < 1e-3).float().mean().item()
        max_err = err.max().item()
        print(f"  {w}x{h}: image means {mean_k.tolist()} vs "
              f"{mean_p.tolist()} ({rel:.4%} apart), traced {nt} vs {nr}, "
              f"{close:.4f} of pixels within 1e-3, max pixel |delta| "
              f"{max_err:.4f}", flush=True)
        check(rel < 1e-2 and abs(nt - nr) / nr < 1e-2 and close >= 0.9,
              (rel, nt, nr, close))
    tile_ms, main_plain_ms, main_err = ms, plain_ms, max_err
    n_slots = tscenes.chap12_scene(8, 8)[0].n_spheres
    n_pix = MAIN["width"] * MAIN["height"]
    scene3, cam3 = tscenes.chap12_scene(MAIN["width"], MAIN["height"])
    counts3 = walk_counts(scene3, cam3, MAIN["width"], MAIN["height"],
                          QUEUE_LANES, device)
    main_bound, main_scan_bound = tile_bounds(
        nt, MAIN["width"] * MAIN["height"] * MAIN["spp"], n_slots, counts3,
        False)
    print(f"  {walk_line('chap12', counts3, False)}", flush=True)
    print(f"  tile_render {MAIN['width']}x{MAIN['height']} {MAIN['spp']}spp: "
          f"{tile_ms:.3f} ms, bound {main_bound[0]:.4f} ms "
          f"({main_bound[1]}: {nt} segments at the walk's tests a segment, "
          f"{walk_flops(nt, counts3, False) / FP32_PEAK * 1e3:.4f} ms of "
          f"FP32, and the draws), the scan's {main_scan_bound[0]:.4f} ms "
          f"({main_scan_bound[1]})  [{card}]", flush=True)

    phases.start("4", "main path: rrt_tpu_torch.cli, chap12 1200x800 32spp d50")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "chip_smoke_chap12.png")
    argv = ["--scene", MAIN["scene"], "-r",
            f"{MAIN['width']}x{MAIN['height']}", "-s", str(MAIN["spp"]),
            "-e", "0", "--max-depth", str(MAIN["max_depth"]),
            "--device", "cuda:0", "--quiet"]
    with tempfile.TemporaryDirectory() as tmp:  # warm-up run
        cli.render(cli.build_parser().parse_args(
            argv + ["-o", os.path.join(tmp, "warm.png")]))
    if os.path.exists(png):
        os.remove(png)
    mk.render_tiles.launches = 0
    res = cli.render(cli.build_parser().parse_args(argv + ["-o", png]))
    launches = mk.render_tiles.launches
    img = res.image
    n_paths = MAIN["width"] * MAIN["height"] * MAIN["spp"]
    nonzero = (img.amax(dim=2) > 0).float().mean().item()
    print(f"  {res.seconds:.4f} s wall, {res.n_traced} rays, "
          f"{res.n_traced / res.seconds / 1e6:.2f} Mrays/s, kernel "
          f"launches {launches}, non-zero pixels {nonzero:.4f}  [{card}]",
          flush=True)
    check(launches >= 1, "the main path did not launch the kernel")
    check(bool(torch.isfinite(img).all()), "non-finite pixels")
    check(n_paths <= res.n_traced <= n_paths * (MAIN["max_depth"] + 1),
          ("traced", res.n_traced))
    check(nonzero > 0.99, ("non-zero pixels", nonzero))
    check(os.path.getsize(png) > 0, "empty PNG")
    check(res.n_traced == MAIN_TRACED, ("traced", res.n_traced, MAIN_TRACED))
    tile_image = img

    phases.start("5", "train kernels vs tile_render and their plain versions")
    train_vs_plain("chap12", 240, 160, 2, 50, device, card)
    train_vs_plain("checker", 64, 32, 4, 8, device, card)
    # At [7]'s shape. A path parts ways with the plain version with odds
    # near 0.4% (240x160, 2 spp: 99.25% of pixels agree), so a pixel of
    # 8 samples holds one with odds near 3%: the pixel share required is
    # 1 - 8 x 0.5%, and 99.5% of paths must agree.
    t5 = train_vs_plain("chap12", TRAIN["width"], TRAIN["height"],
                        TRAIN["spp"], TRAIN["max_depth"], device, card,
                        min_pixels=0.96, min_paths=0.995,
                        plain_chunk=1 << 19)

    phases.start("6", "finite differences at chap12 1200x800 8spp d50")
    finite_differences(device, card)

    phases.start("7", "main path: rrt_tpu_torch.diff.make_train_step, "
                 "chap12 1200x800 8spp d50, 3 SGD steps")
    cfg = render.RenderConfig(**TRAIN)
    scene, cam = tscenes.chap12_scene(cfg.width, cfg.height)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    tex = ground_texture(scene)
    color1 = scene.tex_color1.clone()
    color1[tex] += 0.1
    start = diff.combine(scene, {"tex_color1": color1,
                                 "bg_top": scene.bg_top * 0.8})
    # Gradients of the start (a warm-up, outside the counted run).
    loss0, gp, gc = diff.loss_and_grads(cfg, start, cam, target, 0,
                                        device=device)
    check(bool(torch.isfinite(loss0)), "non-finite loss")
    grads_check("[7]", gp, gc)
    step = diff.make_train_step(cfg, device=device)  # lr 1e-2, as rrt_tpu
    fwd_fn, bwd_fn = mkt.render_tiles_train, mkt.tiles_adjoint
    s_scene, s_cam = start, cam
    fwd_fn.launches = bwd_fn.launches = 0
    bwd_fn.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    step_ms = []
    with chain_events() as (fwd_log, bwd_log):
        for i in range(3):
            fwd_log.clear()
            bwd_log.clear()
            (s_scene, s_cam, loss), ms = wall_ms(
                lambda: step(s_scene, s_cam, target, 0))
            step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
            print(f"  step {i}: loss {loss.item():.6e}, forward "
                  f"{step_ms[-1][0]:.2f} ms, backward "
                  f"{step_ms[-1][1]:.2f} ms, total {ms:.2f} ms  [{card}]",
                  flush=True)
            check(bool(torch.isfinite(loss)), ("non-finite loss", i))
    fwd_launches, bwd_launches = fwd_fn.launches, bwd_fn.launches
    mismatches = int(bwd_fn.replay_mismatches)
    print_step("per step, median", sorted(m[0] for m in step_ms)[1],
               sorted(m[1] for m in step_ms)[1],
               step_bound(start, cam, cfg, device), device, card)
    print(f"  launches: train_fwd {fwd_launches}, train_bwd {bwd_launches}; "
          f"replay_mismatches {mismatches}; "
          f"ground albedo {start.tex_color1[tex].tolist()} -> "
          f"{s_scene.tex_color1[tex].tolist()} (true "
          f"{scene.tex_color1[tex].tolist()})", flush=True)
    check(fwd_launches >= 3 and bwd_launches >= 3,
          ("the train step did not launch the kernels", fwd_launches,
           bwd_launches))
    check(mismatches == 0, ("replay_mismatches", mismatches))
    check(not torch.equal(s_scene.tex_color1.cpu(), start.tex_color1)
          and not torch.equal(s_scene.bg_top.cpu(), start.bg_top),
          "the parameters did not move")
    print("  one more step under torch.profiler:", flush=True)
    device_breakdown(lambda: step(start, cam, target, 0), card)

    phases.start("8", f"north star: make_train_step at 1200x800 "
                 f"{NORTH_STAR_SPP}spp d50 (the chunked trainer)")
    cfg_ns = dataclasses.replace(cfg, spp=NORTH_STAR_SPP)
    chunk = diff.resolve_spp_chunk(cfg_ns, device=device)
    step_ns = diff.make_train_step(cfg_ns, device=device)
    check(step_ns.__qualname__.startswith("make_train_step_chunked"),
          "500 spp did not route to the chunked trainer")
    # Half the card's free memory holds the 500-spp residual (15.84 GB):
    # the step is one chunk, one train_fwd and one train_bwd.
    check(chunk == NORTH_STAR_SPP, ("north-star chunk", chunk))
    ns_bound = step_bound(start, cam, cfg_ns, device)
    fwd_fn.launches = bwd_fn.launches = 0
    bwd_fn.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)  # the step's peak alone
    with chain_events() as (fwd_log, bwd_log):
        (_, _, loss_ns), ns_ms = wall_ms(
            lambda: step_ns(start, cam, target, 0))
    ns_mismatches = int(bwd_fn.replay_mismatches)
    print(f"  chunk {chunk} spp, loss {loss_ns.item():.6e}, wall "
          f"{ns_ms / 1e3:.3f} s, launches train_fwd {fwd_fn.launches} "
          f"train_bwd {bwd_fn.launches}, replay_mismatches "
          f"{ns_mismatches}  [{card}]", flush=True)
    print_step("the step", events_ms(fwd_log), events_ms(bwd_log), ns_bound,
               device, card)
    check(bool(torch.isfinite(loss_ns)) and fwd_fn.launches == 1
          and bwd_fn.launches == 1, ("north-star step", fwd_fn.launches,
                                     bwd_fn.launches))
    check(ns_mismatches == 0, ("replay_mismatches", ns_mismatches))
    print("  one more north-star step under torch.profiler:", flush=True)
    device_breakdown(lambda: step_ns(start, cam, target, 0), card)
    l1, gp1, gc1 = diff.loss_and_grads(cfg, start, cam, target, 0,
                                       device=device)
    l4, gp4, gc4 = diff.loss_and_grads_chunked(cfg, start, cam, target, 0,
                                               spp_chunk=4, device=device)
    # Each partition() field against its largest gradient, the camera
    # fields against the largest camera gradient (tests/test_torch_train.py).
    cam_max = max(g.abs().max().item() for g in gc1)
    worst = 0.0
    for a, b in [(gp4[k], gp1[k]) for k in gp1]:
        scale = max(b.abs().max().item(), 1e-30)
        worst = max(worst, (a - b).abs().max().item() / scale)
    for a, b in zip(gc4, gc1):
        worst = max(worst, (a - b).abs().max().item() / cam_max)
    print(f"  chunked (spp_chunk=4) vs one-shot at 8 spp: losses "
          f"{l4.item():.8e} / {l1.item():.8e}, gradients within "
          f"{worst:.2e} relative", flush=True)
    check(worst < 1e-4 and abs(l4.item() - l1.item()) <= 1e-6 * l1.item(),
          ("chunked vs one-shot", worst))

    phases.start("Q1", "bounce_steps and intersect_only vs their plain "
                 "versions on the card")
    q1 = queue_kernels_vs_plain("chap12", MAIN["width"], MAIN["height"],
                                QUEUE_LANES, BATCH_RAYS, device, card)
    queue_kernels_vs_plain("checker", 64, 32, 64 * 32, 64 * 32, device,
                           card)

    phases.start("Q2", f"main path: the queue driver through "
                 f"rrt_tpu_torch.cli, chap12 1200x800 32spp d50, --spp-chunk "
                 f"{QUEUE_CHUNK}")
    argv_q = argv + ["--driver", "queue", "--spp-chunk", str(QUEUE_CHUNK)]
    with tempfile.TemporaryDirectory() as tmp:  # warm-up run
        warm = cli.render(cli.build_parser().parse_args(
            argv_q + ["-o", os.path.join(tmp, "warm.png")]))
    png_q = os.path.join(OUT_DIR, "chip_smoke_chap12_queue.png")
    mk.bounce_steps.launches = 0
    render.trace_queue.outer_steps = 0
    res_q = cli.render(cli.build_parser().parse_args(argv_q + ["-o", png_q]))
    q_launches = mk.bounce_steps.launches
    outer_steps = render.trace_queue.outer_steps
    print(f"  {res_q.seconds:.4f} s wall, {res_q.passes} passes, "
          f"{res_q.n_traced} rays, {res_q.n_traced / res_q.seconds / 1e6:.2f} "
          f"Mrays/s, bounce_steps launches {q_launches}, outer steps "
          f"{outer_steps}  [{card}]", flush=True)
    check(q_launches >= 1, "the queue driver did not launch bounce_steps")
    check(res_q.driver == "queue" and res_q.passes == 4, "queue passes")
    check(bool(torch.isfinite(res_q.image).all()), "non-finite pixels")
    repeat = (warm.image - res_q.image).abs().max().item()
    print(f"  same-seed queue renders: bitwise equal "
          f"{torch.equal(warm.image, res_q.image)}, max |delta| {repeat:.3e}, "
          f"traced {warm.n_traced} and {res_q.n_traced}", flush=True)
    check(warm.n_traced == res_q.n_traced and repeat < 1e-4,
          ("queue repeatability", repeat))
    hold_to_tile("queue", res_q.image, res_q.n_traced, tile_image,
                         MAIN_TRACED)
    print(f"  one {QUEUE_CHUNK}-spp pass of trace_queue under torch.profiler:",
          flush=True)
    cfg_q = render.RenderConfig(width=MAIN["width"], height=MAIN["height"],
                                spp=MAIN["spp"], max_depth=MAIN["max_depth"],
                                queue_size=QUEUE_LANES)
    scene_q, cam_q = tscenes.chap12_scene(cfg_q.width, cfg_q.height)
    ids = torch.arange(n_pix)
    before = render.trace_queue.outer_steps
    rows, wall = device_breakdown(lambda: render.trace_queue(
        scene_q, cam_q, ids % cfg_q.width, ids // cfg_q.width, cfg_q, 0, 0,
        QUEUE_CHUNK, device=device), card)
    print_per_step("outer step", rows, wall,
                   render.trace_queue.outer_steps - before,
                   "bounce_steps_kernel", card)

    phases.start("Q3", f"main path: the batch driver through "
                 f"rrt_tpu_torch.cli, chap12 1200x800 {BATCH_SPP}spp d50")
    argv_b = ["--scene", MAIN["scene"], "-r",
              f"{MAIN['width']}x{MAIN['height']}", "-s", str(BATCH_SPP),
              "-e", "0", "--max-depth", str(MAIN["max_depth"]), "--driver",
              "batch", "--device", "cuda:0", "--quiet"]
    png_b = os.path.join(OUT_DIR, "chip_smoke_chap12_batch.png")
    mk.intersect_only.launches = 0
    res_b = cli.render(cli.build_parser().parse_args(argv_b + ["-o", png_b]))
    b_launches = mk.intersect_only.launches
    print(f"  {res_b.seconds:.4f} s wall, {res_b.n_traced} rays, "
          f"{res_b.n_traced / res_b.seconds / 1e6:.2f} Mrays/s, "
          f"intersect_only launches {b_launches}  [{card}]", flush=True)
    check(b_launches >= 1, "the batch driver did not launch intersect_only")
    check(bool(torch.isfinite(res_b.image).all()), "non-finite pixels")
    cfg_b = render.RenderConfig(width=MAIN["width"], height=MAIN["height"],
                                spp=BATCH_SPP, max_depth=MAIN["max_depth"])
    tile_b, tile_b_traced = render.render_image_tiles(
        scene_q, cam_q, cfg_b, 0, device=device)
    hold_to_tile("batch", res_b.image, res_b.n_traced, tile_b,
                 int(tile_b_traced))
    # The middle tile (rows 395-409: spheres and ground); the first is
    # all sky and ends after one bounce step.
    print("  the middle tile of the batch render under torch.profiler:",
          flush=True)
    scene_d, cam_d = scene_q.to(device), cam_q.to(device)
    cfg_b = dataclasses.replace(cfg_b, samples_per_pass=BATCH_SPP)
    tiles = render._tile_coords(cfg_b, device)
    px, py = tiles[len(tiles) // 2]
    before = mk.intersect_only.launches
    rows, wall = device_breakdown(lambda: render.render_tile(
        scene_d, cam_d, px, py, cfg_b, 0, 0, 1), card)
    print_per_step(f"bounce step of {px.numel() * BATCH_SPP} rays", rows,
                   wall, mk.intersect_only.launches - before,
                   "intersect_kernel", card)

    phases.start("C1", "chain_bwd vs its plain version on the card")
    torch.cuda.reset_peak_memory_stats(device)
    c1, chain = chain_kernel_phase(device, card, q1["counts"])
    peak_memory("[C1]", device, card)
    phases.start("C2", f"main path: bench.py's backward_chain, chap12 "
                 f"{MAIN['width']}x{MAIN['height']}, {CHAIN_LANES} lanes, "
                 f"d{MAIN['max_depth']}, trace_batch(differentiable=True, "
                 f"fused_vjp=True)")
    torch.cuda.reset_peak_memory_stats(device)
    c2_launches = chain_step_phase(chain, device, card)
    peak_memory("[C2]", device, card)
    phases.start("C3", f"main path: render_image(differentiable=True), "
                 f"chap12 {MAIN['width']}x{MAIN['height']} {BATCH_SPP}spp "
                 f"d{MAIN['max_depth']}, gradient of an L2 loss")
    torch.cuda.reset_peak_memory_stats(device)
    differentiable_batch_phase(tile_b, int(tile_b_traced), device, card)
    peak_memory("[C3]", device, card)

    phases.start("M1", f"book2chap2 {MAIN['width']}x{MAIN['height']} "
                 f"d{MAIN['max_depth']}: the kernels' moving variants vs "
                 f"their plain versions")
    torch.cuda.reset_peak_memory_stats(device)
    m_tile = motion_tile_phase(device, card)
    m_q = queue_kernels_vs_plain("book2chap2", MAIN["width"], MAIN["height"],
                                 QUEUE_LANES, BATCH_RAYS, device, card)
    # The readings on an H100 80GB HBM3 at 700 W: 0.9786 of pixels and
    # 0.99724 of paths agreed; the gates allow twice their complements.
    m_t = train_vs_plain("book2chap2", TRAIN["width"], TRAIN["height"],
                         TRAIN["spp"], TRAIN["max_depth"], device, card,
                         min_pixels=0.955, min_paths=0.994,
                         plain_chunk=1 << 19)
    m_c1, _ = chain_kernel_phase(device, card, m_q["counts"], "book2chap2")
    peak_memory("[M1]", device, card)
    phases.start("M2", "main path: python -m rrt_tpu_torch.cli with its "
                 "defaults (book2chap2 1200x800 10spp, the tile driver)")
    m2_launches = motion_cli_phase(device, card)
    phases.start("M3", "main path: make_train_step on book2chap2 1200x800 "
                 "8spp d50, sphere_dc among the leaves; finite differences")
    torch.cuda.reset_peak_memory_stats(device)
    m3_launches = motion_train_phase(device, card)
    peak_memory("[M3]", device, card)
    phases.start("P1", "main path: the three probes at their full ITERS")
    p1 = probe_phase(device, card)
    phases.end()

    main_fwd = sum(m[0] for m in step_ms) / len(step_ms)
    main_bwd = sum(m[1] for m in step_ms) / len(step_ms)
    print(f"[9] total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    # ms / plain_ms / bound_ms: the same shape for each (tile_render at
    # MAIN, the train kernels at [5]'s chap12 1200x800, 8 spp, depth 50,
    # bounce_steps and intersect_only at [Q1]'s chap12 131072 lanes;
    # intersect_only's max_abs_err also covers [Q1]'s batch rays; its ms
    # and chain_bwd's are device time by graph_ms; chain_bwd's
    # ms, plain_ms and bound_ms are sums over [C1]'s three chains, its
    # max_abs_err the largest |field gradient delta| of gradcheck there);
    # main_ms: the train kernels' mean per step of [7] (the same shape).
    # moving_ms (and moving_bound_ms): the same kernel's moving variant on
    # book2chap2 at the same shape ([M1]); moving_launches: its launches
    # on [M2]'s and [M3]'s main paths. The probes ([P1]): ms and bound_ms
    # of the probe's headline variant at the JAX probe's full ITERS (the
    # (1, 1024) row, Threefry, the reshape; every variant in `variants`),
    # plain_ms and max_abs_err at PROBE_CHECK_ITERS iterations
    # (plain_iters). No single PyTorch call computes any of these
    # functions.
    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **extra}

    def moving(ms, bnd, **extra):
        return dict(moving_ms=ms, moving_bound_ms=bnd[0], **extra)

    def walk(scan_bnd, counts, moving_scan_bnd, moving_counts):
        # Every kernel but the train kernels walks the BVH: bound_ms is
        # the walk's; the scan's, which they ran before, beside it.
        return dict(scan_bound_ms=scan_bnd[0],
                    moving_scan_bound_ms=moving_scan_bnd[0],
                    walk_tests=[counts["nodes"], counts["slots"]],
                    moving_walk_tests=[moving_counts["nodes"],
                                       moving_counts["slots"]])

    def probe(name, replaces, launches, err, rows, plain_ms):
        return entry(name, csrc + "probes.cu", replaces, launches, err,
                     rows[0][1], plain_ms, (rows[0][2], "operations"),
                     plain_iters=PROBE_CHECK_ITERS,
                     variants={str(r[0]): {"ms": r[1], "bound_ms": r[2]}
                               for r in rows})

    csrc = "rrt_tpu_torch/ops/csrc/"
    c1_bound = chain_bound(c1, q1["counts"])
    m_c1_bound = chain_bound(m_c1, m_q["counts"])
    print(json.dumps({"kernels": [
        entry("tile_render", csrc + "tile_render.cu",
              "rrt_tpu/ops/megakernel.py:2048", launches, main_err,
              tile_ms, main_plain_ms, main_bound,
              **moving(m_tile["ms"], m_tile["bound"],
                       moving_launches=m2_launches),
              **walk(main_scan_bound, counts3, m_tile["scan_bound"],
                     m_tile["counts"]),
              registers=resources.get("tile_render_kernel")),
        entry("train_fwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:376", fwd_launches,
              t5["fwd_err"], t5["fwd_ms"], t5["fwd_plain_ms"],
              t5["fwd_bound"], main_ms=main_fwd,
              step_bound_ms=t5["step_bound"][0],
              registers=resources.get("train_fwd_kernel"),
              **moving(m_t["fwd_ms"], m_t["fwd_bound"],
                       moving_launches=m3_launches[0])),
        entry("train_bwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:463", bwd_launches,
              t5["bwd_err"], t5["bwd_ms"], t5["bwd_plain_ms"],
              t5["bwd_bound"], main_ms=main_bwd,
              step_bound_ms=t5["step_bound"][0],
              scan_ms=t5["bwd_scan_ms"],
              registers=resources.get("train_bwd_kernel"),
              **moving(m_t["bwd_ms"], m_t["bwd_bound"],
                       moving_launches=m3_launches[1])),
        entry("bounce_steps", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:645", q_launches, q1["err"],
              q1["ms"], q1["plain_ms"], q1["bound"],
              **moving(m_q["ms"], m_q["bound"]),
              **walk(q1["scan_bound"], q1["counts"], m_q["scan_bound"],
                     m_q["counts"]),
              registers=resources.get("bounce_steps_kernel")),
        entry("intersect_only", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:1683", b_launches, q1["i_err"],
              q1["i_ms"], q1["i_plain_ms"], q1["i_bound"],
              **moving(m_q["i_ms"], m_q["i_bound"]),
              **walk(q1["i_scan_bound"], q1["counts"], m_q["i_scan_bound"],
                     m_q["counts"])),
        entry("chain_bwd", csrc + "chain.cu",
              "rrt_tpu/ops/megakernel_vjp.py:487", c2_launches[1],
              max(c["err"] for c in c1), sum(c["ms"] for c in c1),
              sum(c["plain_ms"] for c in c1), c1_bound[0],
              **moving(sum(c["ms"] for c in m_c1), m_c1_bound[0]),
              **walk(c1_bound[1], q1["counts"], m_c1_bound[1],
                     m_q["counts"]),
              registers=resources.get("chain_bwd_kernel")),
        probe("fma_chain", "benchmarks/probe_row_layout.py:38",
              p1["launches"][0], p1["chain_err"], p1["row"],
              p1["chain_plain_ms"]),
        probe("rng", "benchmarks/probe_rng.py:56", p1["launches"][2],
              p1["rng_err"], [p1["rng"][i] for i in (1, 0, 2)],
              p1["rng_plain_ms"]),
        probe("fma_chain_relayout", "benchmarks/probe_reshape.py:38",
              p1["launches"][1], p1["relayout_err"], p1["reshape"][::-1],
              p1["relayout_plain_ms"])]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
