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

Then the Cornell box (quads, boxes rotated about Y, a light; the three
forward kernels' solid-family variants), at bench.py's scene-phase size
400x400, 32 spp, depth 50:

  [K1] tile_render, bounce_steps ([Q1]'s 131,072 lanes) and
       intersect_only ([Q3]'s 65,536 rays) against their plain versions,
       each timed by graph replay beside its bound (the 6 quad and 2 box
       tests a segment, the draws, the bytes); the exact gates: chap12
       through the solid-family variants with no quad or box gives the
       sphere variants' outputs bit for bit, and on mixed_scene (spheres,
       quads, boxes, a light) the BVH walk seeded by the quads' and
       boxes' t gives the seeded scan's (accel.pack_scan) in all three;
  [K2] the main path: python -m rrt_tpu_torch.cli --scene cornell -r
       400x400 -s 32 on the tile driver (auto), then the queue and batch
       drivers through the CLI held against the tile image;
  [K3] cornell's gradient on the card at 400x400, depth 50, 8 spp: the
       solid-family variants of train_fwd, train_bwd and chain_bwd
       against their plain versions (train_fwd against tile_render bit
       for bit, the winner codes, the gradients by gradcheck's rule,
       chain_bwd on the three chains of one pass of
       render_image(differentiable=True)'s first tile), finite
       differences of an albedo and the light's emission, the same
       checks on scenes.book2.mixed_scene (whose quad_q and box_center
       gradients are not 0); then the main path: make_train_step (three
       SGD steps; the loss falls), make_train_step_chunked and
       render_image(differentiable=True), with no replay mismatch.

Then constant media and the isotropic material on the Cornell smoke
box (cornell_smoke: cornell's walls, two rotated medium boxes of
density 0.01; the same size), through the kernels' solid-family
variants, whose media loop runs when a scene has media:

  [S1] tile_render (held to its plain version at SMOKE_PLAIN_SPP),
       bounce_steps and intersect_only (bit for bit) against their
       plain versions, each timed beside its bound; then the main path:
       the CLI with --scene cornell_smoke on the tile, queue and batch
       drivers, held against the tile image;
  [S2] its gradient at 8 spp: train_fwd and train_bwd against their
       plain versions (gradcheck's rule), finite differences of the
       white smoke's albedo, then the main path: make_train_step (three
       SGD steps; the loss falls) and its chunked step, no bounce_steps
       or chain_bwd launch, and render_image(differentiable=True) and
       the bounce chain raising before any launch (the chain leaves
       media out, as rrt_tpu's does);
  [S3] the media adjoint on scenes.book2.media_scene (a medium sphere
       and a medium box under the sky, 320x240, 4 spp, depth 8): the
       medium pack's cotangents against the plain version's.

Then the perlin-marble and image textures (simple_light: two marble
spheres, a quad light and a sphere light; earth: one sphere with an
image; RTTNW's 400x225, depth 50), through the kernels' texture
variants (kTex), one scene after the other:

  [T1] tile_render (32 spp, held to its plain version at
       TEXTURE_PLAIN_SPP) and bounce_steps ([Q1]'s 131,072 lanes)
       against their plain versions, each timed beside its bound; then
       the main path: the CLI on the tile, queue and batch drivers, held
       against the tile image;
  [T2] its gradient at 8 spp: train_fwd and train_bwd against their
       plain versions (gradcheck's rule, the atlas cotangent within its
       spread), chain_bwd on a tile pass's camera rays, simple_light's
       marble scale and color1 by central differences, then the main
       path: three make_train_step steps (the loss falls, no replay
       mismatch; simple_light's camera and geometry held, TEXTURE_TRAINED)
       and render_image(differentiable=True) on a 64x36 view.

Then the RTTNW final scene (rttnw_final: 400 ground boxes past
SOLID_CAP, a quad light, 1,006 spheres, one moving, two media, the
marble and the image; bench.py's 400x267, depth 50), through the
forward kernels' walks over the solid families' trees (kWalk):

  [F1] tile_render (32 spp, timed with the trees staged and in device
       memory, and as the solid scan; held to its plain version at
       RTTNW_PLAIN_SPP), bounce_steps ([Q1]'s 131,072 lanes) and
       intersect_only (131,072 rays, camera rays and after 1-4 bounces)
       against their plain versions (bounce_steps by [Q1]'s rule,
       intersect_only bit for bit), and all three
       walks against the solid scan (accel.solid_scan) bit for bit; the
       walks' node, box and sphere tests a segment beside the scan's
       1,407; blocks an SM; then the main path: the CLI on the tile,
       queue and batch drivers, held against the tile image; and the
       chain's route of its gradient (render_image(differentiable=True))
       raising naming its constant media (#9.4) before any launch;
  [F2] scenes.book2.many_solids_scene (81 boxes rotated about Y and 82
       quads under the sky, and its moving and marble variant): the
       three walks over both trees against the solid scan bit for bit,
       intersect_only against its plain version;
  [F4] chain_bwd's kWalk variants (its replay walks the solid trees):
       the four on many_solids_scene at [F2]'s size against their plain
       version ([C1]'s rule) and the solid scan; the (moving, solids,
       tex, walk) one on [C2]'s three chains of rttnw_final without its
       media at 400x267, timed beside its bound, held to its plain
       version on a stride of the lanes; then the main path:
       render_image(differentiable=True) on that scene at 400x267, 4
       spp, depth 50, with the gradient of an L2 loss (bounce_steps and
       chain_bwd launched, the train kernels not; no replay mismatch;
       the image the forward batch driver's; boxes past slot 63 with
       gradients; a box albedo past slot 63 against central
       differences), and render_image_diff at depth 80, which takes the
       chain.

Then Russian roulette (RenderConfig.rr_depth = RR_DEPTH, 4: the coin
from bounce 4 on, the detached 1 / p weight), through the five shading
kernels' runtime argument:

  [R1] tile_render on chap12 at MAIN and cornell at 400x400, 32 spp:
       its ms and traced totals beside rr_depth 0's, the image means'
       relative difference (RR_MEAN_GATE), the plain version at
       RR_PLAIN_SPP by the slice rule; bounce_steps by [Q1]'s rule on
       131,072 lanes after 4 steps; then the main path: the CLI with
       --rr-depth 4 on the tile and queue drivers, held to each other;
  [R2] the train kernels by [5]'s checks at 240x160, 2 spp, their ms at
       [7]'s shape beside rr_depth 0's, no replay mismatch, one
       make_train_step step (the main path) and one 500-spp step at
       rr_depth 0 and 4 (printed, no gate); chain_bwd on [C2]'s three
       chains against its plain version, then [C2]'s gradient step.

Then sharding (rrt_tpu_torch/parallel/mesh.py: dp over bands of rows,
sp over samples, one all_reduce assembling the image):

  [D1] the row window: tile_render at MAIN and train_fwd at TRAIN on two
       bands of rows, each the full launch's rows bit for bit, train_bwd's
       cotangents summed over the bands within PACK_SPREAD of the full
       launch's, each timed beside the full launch; then the main paths
       with ranks sharing the card under gloo, each rank a process
       started with a time limit: the CLI on chap12 at MAIN over the
       meshes 2x1 (the image bit for bit), 1x2 and 2x2 (within
       D1_SP_TOL), and one train step at TRAIN on 2x2 (the gradients
       within the larger of 1e-5 and twice two single-process runs'
       spread, every rank's parameters the same bit for bit), with each
       rank's wall, peak memory, launches and backend. Four ranks on one
       card measure nothing about scaling across cards.

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
import math
import os
import sys
import tempfile
import time

import numpy as np
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
# [R1]-[R2]: Russian roulette from this bounce (bench.py's rr4 cells:
# north_star_500spp_rr4_s, rttnw_final_rr4_wall_s), and the spp at which
# [R1] holds tile_render's plain version to it by the slice rule (the
# plain loop's time grows with the samples).
RR_DEPTH = 4
RR_PLAIN_SPP = 2
# [R1]: the image means' largest relative difference (over the three
# channels) between rr_depth RR_DEPTH and 0 on the same keys: the
# roulette changes the estimator's variance, not its mean. On an H100
# 80GB HBM3 at 700 W: 1.8e-5 on chap12 at 1200x800, 3.2e-4 on cornell at
# 400x400, 32 spp; the gate allows 60 times the worst.
RR_MEAN_GATE = 2e-2
# [R2]: the share of the stored winners of agreeing paths that may differ
# from the plain version's at rr_depth RR_DEPTH. A path the roulette kills
# banks nothing, so two paths that parted (by drift or an earlier
# decision) agree in radiance and length when the coin kills both at the
# same bounce (chap12's light is the sky, which neither reached), and
# gradcheck.sample_agreement keeps them: at 240x160, 2 spp, depth 50, 32
# of 191,971 entries differed (1.67e-4) on 23 paths, none at a near-tie
# (gradcheck.tie_gaps), where rr_depth 0 parted none there ([5]; an H100
# 80GB HBM3 at 700 W). The gate allows 3 times it, and those paths'
# pixels get loss weight 0 ([F3]'s exclude_parted).
RR_MAX_WINNER_FAULTS = 5e-4
# [K1]-[K3]: the Cornell box (rrt_tpu/scenes/book2.py, RTTNW ch. 8.2,
# BASELINE.json config #4's scene) at the size bench.py's scene phase
# renders it (bench.py:427-440); [K3]'s train step at bench.py's
# train_step_8spp sample count.
CORNELL = dict(scene="cornell", width=400, height=400, spp=32, max_depth=50)
CORNELL_TRAIN_SPP = 8
# [K3]: the pixels each of whose samples the train kernels and the plain
# version render alike (gradcheck.sample_agreement), on cornell at
# 400x400 8 spp and on the mixed scene at 320x240 4 spp. On an H100 80GB
# HBM3 at 700 W 0.99995 and 0.99885 agreed (0.99999 and 0.99971 of
# paths); the gates allow many times their complements.
CORNELL_MIN_AGREE = 0.98
MIXED_MIN_AGREE = 0.95
# [K3]'s mixed scene (scenes.book2.mixed_scene): the train kernels at
# this size, chain_bwd on one camera ray a pixel, held on the quads',
# boxes' and textures' fields (MIXED_FIELDS). Depth 8: its spheres rest
# on the ground and beside the boxes, and the short hops between them
# multiply derivatives chaotically; at depth 50 two float32 evaluations
# of the same code (the kernels' device functions compiled for the CPU,
# and the plain version) put box_center 20% and the camera 11% of their
# largest apart on agreeing pixels, at depth 8 within 4.8e-3 on one
# element, at depth 4 within 3.7e-3.
MIXED_TRAIN = dict(width=320, height=240, spp=4, max_depth=8)
MIXED_FIELDS = ("quad_q", "quad_u", "quad_v", "box_center", "box_half",
                "tex_color1", "tex_color2", "bg_bottom", "bg_top")
# The kernel's gradient of each of MIXED_FIELDS within this share of the
# field's largest from the plain version's. On an H100 80GB HBM3 at 700 W
# the worst reading was box_center's 4.74e-3 (box_half 4.21e-3, the
# quads' below 3e-4): one box element, whose paths hop between the box
# and a sphere beside it.
MIXED_FIELD_GATE = 1e-2
# FP32 operations of one quad test (bounce.cuh closest_solid): d.n and
# o.n (5 each), the parallel test (3), t (2), alpha and beta (13 each:
# two dot products, a multiply, an add and a subtract), the t window and
# the four range tests (6): 47. One box test: the offsets (3), the
# rotated offsets and direction (12), three slabs (the parallel test,
# the reciprocal, two multiplies, |inv|, a negate, two subtracts, a max
# and a min: 11 each), the far-face pick and the three tests (4): 52. A
# segment of the solid-family variants also takes |d| (1). A lower bound:
# the shading of the winner is not counted.
QUAD_TEST_FLOPS = 47
BOX_TEST_FLOPS = 52
# [K1]: cornell's pixels within 1e-3 of the plain version. On an H100
# 80GB HBM3 at 700 W all but a handful of the 160,000 agreed (a share
# of 1.0000 to four places; max pixel |delta| 0.16, traced 34,301,381
# vs 34,301,293); the gate allows 1% to part.
CORNELL_MIN_CLOSE = 0.99
# [K2]: the cornell tile image's non-zero pixels. The box is dark: 3% of
# its paths reach the light (tests/test_torch_golden.py), so at 32 spp
# 0.97^32 = 38% of pixels stay black; 0.5960 were lit on an H100 80GB
# HBM3 at 700 W. The gate requires half that.
CORNELL_MIN_LIT = 0.3
# [S1]-[S3]: constant media and the isotropic material. cornell_smoke
# (rrt_tpu/scenes/book2.py, RTTNW ch. 9.2: cornell's walls under a larger
# light, its boxes two rotated medium boxes of density 0.01, one black,
# one white; BASELINE.json config #5's constant-medium volumes) at
# CORNELL's size, uncut; [S3]'s scenes.book2.media_scene (a medium
# sphere inside a glass one, a rotated medium box, under the sky).
SMOKE = dict(CORNELL, scene="cornell_smoke")
# [S1]: tile_render against its plain version at this many spp (the
# kernel's time and bound are at SMOKE's 32); [S2]: the train kernels
# against theirs at this many (the main path's step at
# CORNELL_TRAIN_SPP): the plain versions' time grows with the samples.
SMOKE_PLAIN_SPP = 2
# [S1]: cornell_smoke's pixels within 1e-3 of the plain version, [K1]'s
# rule; [S2]: the pixels each of whose samples the train kernels and the
# plain version render alike, [K3]'s. On an H100 80GB HBM3 at 700 W
# 1.0000 (max pixel |delta| 0.0000, traced 1,849,620 vs 1,849,621) and
# 0.99999 agreed; the gates allow many times their complements.
SMOKE_MIN_CLOSE = 0.99
SMOKE_MIN_AGREE = 0.98
# [S3]: media_scene at this size; its agreeing pixels, [K3]'s mixed
# scene's rule; the fields held within MIXED_FIELD_GATE of their
# largest, the medium pack's cotangents (MED_COLS) within MEDIA_SPREAD
# of their largest. On an H100 80GB HBM3 at 700 W: 0.99938 of pixels
# agreed, 16 of 750,304 winner codes differed (MAX_WINNER_FAULTS),
# med_half read 3.2e-5 of its largest, the pack cotangents 5.0e-6.
MEDIA_ADJ = dict(width=320, height=240, spp=4, max_depth=8)
MEDIA_MIN_AGREE = 0.95
MEDIA_FIELDS = ("med_center", "med_radius", "med_half",
                "med_neg_inv_density", "tex_color1", "sphere_c0", "bg_top")
MEDIA_SPREAD = 1e-2
# FP32 operations of one medium test (bounce.cuh medium_t): a box
# boundary's offsets (3), three slabs (the rotated offset and direction,
# 5 each; the parallel test and the reciprocal, 3; t1 and t2, 5; the
# inside test, 2; min, max and the two selects, 4; the running max and
# min, 2: 26 each), the clips and their tests (6), the sampled distance
# (log, a multiply, the inside-length test, 4) and t (2): 93; a sphere
# boundary's offsets (3), half_b and c_coef (12), the discriminant (3),
# its root (2), the entry and exit (4) and its test (1), then the same
# 12: 37. A segment of a media scene also takes 1 / |d| (2); each pair of
# media draws one Threefry call (80 INT32 operations) a segment.
MEDIUM_BOX_FLOPS = 93
MEDIUM_SPHERE_FLOPS = 37

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
                   min_pixels=0.99, min_paths=0.0, plain_chunk=1 << 16,
                   rr_depth=0, max_winner_faults=MAX_WINNER_FAULTS,
                   exclude_parted=False):
    """[5] The train kernels against tile_render and their plain
    versions on one configuration, by rrt_tpu_torch.gradcheck's rule:
    at least `min_pixels` of pixels and `min_paths` of paths agree
    sample by sample; the pixels that do not get loss weight 0. The
    forward's rad, traced and lengths equal tile_render's bit for bit
    and its winners the plain version's on every agreeing path; the
    backward from the winners gives the camera and background
    cotangents of the scan alone (winners=None) bit for bit, and the
    pack's within PACK_SPREAD of their largest. rr_depth: Russian
    roulette's first bounce in every kernel and plain version ([R2]);
    max_winner_faults: the share of agreeing paths' stored winners that
    may differ; exclude_parted: the pixels holding such a winner get loss
    weight 0 too (solid_train_vs_plain's rule)."""
    from rrt_tpu_torch import diff, gradcheck, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    build = checker_scene if name == "checker" else tscenes.SCENES[name]
    scene, cam = build(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=scene.has_moving,
              rr_depth=rr_depth)
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
          f"{max_winner_faults:.0e}); by bounce "
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
    check(w_compared > 0 and w_faults <= max_winner_faults * w_compared,
          ("winners vs the plain version", w_faults, w_compared))
    check(p_compared > 0 and p_faults == 0,
          ("pooled winners vs each sample alone", p_faults, p_compared))
    agree = agreement.agree
    if exclude_parted and w_faults:
        parted = torch.zeros_like(agree)
        parted[differ[:, 2]] = True
        print(f"  the {int((parted & agree).sum())} agreeing pixels whose "
              f"stored winners part from the plain version's get loss "
              f"weight 0", flush=True)
        agree = agree & ~parted
    weight = torch.sin(torch.arange(w * h, device=device) * 0.1) * agree
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
    d_sph, d_cam, d_bg, _, _, _ = mkt.tiles_adjoint(
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


def intersect_vs_plain(what, o, d, tm, sph, moving, bvh, solids=None,
                       media=None):
    """intersect_only against its plain version on the rays (o, d): fam
    and idx equal on >= 99.9% of rays (the card's own spread: they agreed
    on every camera ray at full size), t within 1e-5 relative where they
    agree on a hit (both round every product), misses equal; media: the
    keys and bounce of a scene with media (medium_inputs). Returns
    (share of rays agreeing, max |t delta| on agreeing hits, plain ms)."""
    from rrt_tpu_torch.ops import megakernel as mk
    kw = dict(t_min=1e-3, time=tm if moving else None, solids=solids,
              **(media or {}))
    t, fam, idx = mk.intersect_only(o, d, sph, bvh=bvh, **kw)
    (rt, rfam, ridx), plain_ms = wall_ms(
        lambda: mk.intersect_only_reference(o, d, sph, **kw))
    same = (fam == rfam) & (idx == ridx)
    hit = same & (fam >= 0)
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
                   device, card, solids=None, radiance_only=False, tex=None,
                   rr_depth=0, min_agree=MIN_FORWARD_AGREE, scan=None):
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
    no replay mismatch in either. solids: the scene's SolidPacks (the
    kernels' solid-family variants; the quad and box packs' cotangents
    join the fields), or None. radiance_only: the output cotangent on
    the pending radiance rows (10-12) alone, as a render's loss gives
    the last chain of a path (no later chain reads its o, d or
    throughput). tex: the scene's TexPack (the texture variants), or
    None; with images the atlas cotangents of the kernel and the plain
    version are held within PACK_SPREAD of their largest (`atlas`).
    rr_depth: Russian roulette's first bounce, in both forwards and both
    backwards ([R2]). min_agree: the share of lanes whose forwards must
    agree. scan: the solid scan's SolidPacks (accel.solid_scan: the same
    packs, every family a loop) of a walking variant's solids ([F4]),
    whose kernel run must give the walk's input and background
    cotangents bit for bit and its pack cotangents within PACK_SPREAD.
    Returns the kernel's forward output and the numbers of the kernels
    line."""
    from rrt_tpu_torch import diff, gradcheck
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    kw = dict(k_steps=k_steps, max_depth=MAIN["max_depth"], t_min=1e-3,
              moving=scene.has_moving, solids=solids, tex=tex,
              rr_depth=rr_depth)
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
             * agree)
    if radiance_only:
        d_out[:10] = 0.0
        d_out[13:] = 0.0
    d_out = d_out.contiguous()
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
         *(sum(x[j] for x in parts) for j in (1, 2, 3)),
         None if solids is None else dataclasses.replace(
             solids, quad24=sum(x[4].quad24 for x in parts),
             box24=sum(x[4].box24 for x in parts)),
         None if k[5] is None else sum(x[5] for x in parts))
    ms = graph_ms(lambda: mkv.chain_adjoint(st, keys, sph, bg, d_out, ob,
                                            bvh=bvh, **kw), mkv.chain_adjoint)
    k2 = mkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh, **kw)
    repeat = max(((b - a).abs().max() / a.abs().max().clamp(min=1e-30))
                 .item() for a, b in [(k[1], k2[1])] + ([] if solids is None
                 else [(k[4].quad24, k2[4].quad24),
                       (k[4].box24, k2[4].box24)]))
    same = torch.equal(k2[0], k[0]) and torch.equal(k2[2], k[2])
    if scan is not None:
        ks = mkv.chain_adjoint(st, keys, sph, bg, d_out, ob, bvh=bvh,
                               **dict(kw, solids=scan))
        scan_spread = max(
            ((b - a).abs().max() / a.abs().max().clamp(min=1e-30)).item()
            for a, b in ((k[1], ks[1]), (k[4].quad24, ks[4].quad24),
                         (k[4].box24, ks[4].box24)))
        scan_same = (torch.equal(ks[0], k[0]) and torch.equal(ks[2], k[2])
                     and int(ks[3]) == 0)
        print(f"  chain_bwd {what}: the walk vs the solid scan, input and "
              f"background cotangents bit-equal and no mismatch "
              f"{scan_same}, the pack's within {scan_spread:.2e} (rule "
              f"{PACK_SPREAD:g})", flush=True)
        check(scan_same and scan_spread <= PACK_SPREAD,
              ("chain_bwd", what, "walk vs scan", scan_same, scan_spread))
    mism = (int(k[3]), int(p[3]))
    live = st[mk.ROW_ALIVE] > 0.5
    scale = p[0][:13].abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    lane_ok = ((k[0][:13] - p[0][:13]).abs() <= 1e-3 * scale).all(dim=0)
    lanes = lane_ok[live].float().mean().item() if live.any() else 1.0
    dead_equal = torch.equal(k[0][:13, ~live], d_out[:13, ~live])
    no_cam = torch.zeros((24,), device=device)
    kp, kc = diff.field_grads(scene, cam, cfg, k[1], no_cam, k[2], k[4],
                              device=device)
    pp, pc = diff.field_grads(scene, cam, cfg, p[1], no_cam, p[2], p[4],
                              device=device)
    faults, err = gradcheck.field_grad_faults(kp, kc, pp, pc)
    rel = max(((kp[f] - pp[f]).abs().max()
               / pp[f].abs().max().clamp(min=1e-30)).item() for f in pp)
    atlas = None if k[5] is None else (
        (k[5] - p[5]).abs().max() / p[5].abs().max().clamp(min=1e-30)).item()
    if atlas is not None:
        print(f"  chain_bwd {what}: the atlas cotangent within {atlas:.2e} "
              f"of its largest (rule {PACK_SPREAD:g}; the plain version's "
              f"largest {p[5].abs().max().item():.4e})", flush=True)
        check(atlas <= PACK_SPREAD and p[5].abs().max().item() > 0,
              ("chain_bwd", what, "atlas", atlas))
    segments = int((out[mk.ROW_TRACED] - st[mk.ROW_TRACED]).sum())
    print(f"  chain_bwd {what}, {st.shape[1]} lanes ({int(live.sum())} "
          f"alive), k={k_steps}: forwards agree on {frac:.5f} of lanes "
          f"(rule {min_agree}), input cotangent within 1e-3 on "
          f"{lanes:.5f} of live lanes (rule 0.995), dead lanes pass d_out "
          f"{dead_equal}, replay_mismatches {mism}, max |field grad delta| "
          f"{err:.3e} (largest over a field's largest gradient: {rel:.3e}, "
          f"rule 2e-3); a repeat: input and background cotangents bit-equal "
          f"{same}, the pack's within {repeat:.2e} (rule {PACK_SPREAD:g}); "
          f"{segments} segments; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"([C1] peak so far {plain_gb:.3f} GB)  [{card}]", flush=True)
    check(frac >= min_agree and lanes >= 0.995 and dead_equal
          and not faults and mism == (0, 0) and not k[0][13:].any() and same
          and repeat <= PACK_SPREAD,
          ("chain_bwd", what, frac, lanes, dead_equal, faults, mism, same,
           repeat))
    return out, dict(ms=ms, plain_ms=plain_ms, segments=segments, err=err,
                     hits=hits(st, out), q=st.shape[1], n_slots=sph.shape[1],
                     moving=scene.has_moving, grads=pp,
                     drawing=drawing_segments(st, out), atlas=atlas)


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
    d_st, d_sph, d_bg, mism, _, _ = mkv.chain_adjoint(
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


def chain_kernel_phase(device, card, counts, name="chap12", rr_depth=0):
    """[C1] chain_bwd against its plain version on each chain of [C2]'s
    path on the scene (the kernels' forward gives each chain's input;
    both walk the BVH render.trace_batch_fused builds, over the rays'
    own times) and, on chap12 without Russian roulette, on
    chain_small_cases; rr_depth: the roulette's first bounce ([R2]).
    counts: [Q1]'s walk_counts on the scene, for the walk's bound.
    Returns (per-chain numbers, [C2]'s inputs)."""
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
            k_steps, scene, cam, cfg, device, card, rr_depth=rr_depth)
        c1.append(numbers)
        if j < len(schedule) - 1:
            st, kbits, lane = render._compact_lanes(out, kbits, lane)
    if name == "chap12" and not rr_depth:
        chain_small_cases(device, card)
    (b_ms, b_by), scan = chain_bound(c1, counts)
    ms = sum(c["ms"] for c in c1)
    rr_tag = f" at rr_depth {rr_depth}" if rr_depth else ""
    print(f"  {name}'s three chains{rr_tag}: chain_bwd {ms:.4f} ms "
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
    d_sph, d_cam, d_bg, mism, _, _ = mkt.tiles_adjoint(
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


def solid_flops(segments, solids) -> float:
    """FP32 operations of `segments` segments' quad, box and medium
    tests (no medium term without media, so [K1]-[K3] count as before)."""
    flops = segments * (solids.n_quads * QUAD_TEST_FLOPS
                        + solids.n_boxes * BOX_TEST_FLOPS + 1)
    n_media = getattr(solids, "n_media", 0)
    if n_media:
        boxes = int((solids.med24[:n_media, 0] > 0.5).sum())
        flops += segments * (boxes * MEDIUM_BOX_FLOPS + 2 + (
            n_media - boxes) * MEDIUM_SPHERE_FLOPS)
    return flops


def media_draws(segments, solids) -> float:
    """INT32 operations of `segments` segments' STREAM_MEDIUM draws: a
    Threefry call a pair of media."""
    return THREEFRY_OPS * segments * ((getattr(solids, "n_media", 0) + 1)
                                      // 2)


def pack_bytes(*packs) -> int:
    """Bytes of the packs, each read once."""
    return sum(4 * p.numel() for p in packs)


def drawing_segments(st, out) -> int:
    """Segments between a lane state st and the state out some bounce
    steps later that drew the scatter's 4 Threefry calls, at least: the
    traced segments less the lanes that ended (a miss or a light ends a
    lane without drawing)."""
    ended = int(((st[14] > 0.5) & (out[14] <= 0.5)).sum())
    return int((out[15] - st[15]).sum()) - ended


def launch_copy_ms(fn, work, st, *wrappers) -> float:
    """Device ms of one in-place launch fn() on `work` reset from st:
    the graph of copy and launch less the graph of the copy alone."""
    def both():
        work.copy_(st)
        fn()
    return graph_ms(both, *wrappers) - graph_ms(lambda: work.copy_(st))


def tile_vs_plain(what, packs, bvh, kw, card, *, min_close):
    """tile_render against its plain version on the packs (sph, cam,
    bg): image means and traced totals within 1%, min_close of pixels
    within 1e-3. Returns (rad, traced, kernel ms by graph replay, plain
    ms, max pixel |delta|)."""
    from rrt_tpu_torch.ops import megakernel as mk
    rad, traced = mk.render_tiles(*packs, bvh=bvh, **kw)
    ms = graph_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw),
                  mk.render_tiles)
    (ref, ref_traced), plain_ms = wall_ms(
        lambda: mk.render_tiles_reference(*packs, **kw))
    spp = kw["spp"]
    mean_k, mean_p = rad.mean(dim=0) / spp, ref.mean(dim=0) / spp
    rel = ((mean_k - mean_p).abs() / mean_p).max().item()
    nt, nr = int(traced.sum()), int(ref_traced.sum())
    err = (rad - ref).abs().max(dim=1).values / spp
    close = (err < 1e-3).float().mean().item()
    print(f"  tile_render {what} {kw['width']}x{kw['height']} {spp}spp "
          f"d{kw['max_depth']}: image means {mean_k.tolist()} vs "
          f"{mean_p.tolist()} ({rel:.4%} apart), traced {nt} vs {nr}, "
          f"{close:.4f} of pixels within 1e-3, max pixel |delta| "
          f"{err.max().item():.4f}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms  [{card}]", flush=True)
    check(rel < 1e-2 and abs(nt - nr) / nr < 1e-2 and close >= min_close,
          ("tile_render", what, rel, nt, nr, close))
    return rad, traced, ms, plain_ms, err.max().item()


def bounce_vs_plain(what, st, keys, sph, bg, bvh, solids, card,
                    exact=False, tex=None, moving=False):
    """bounce_steps (4 steps, depth 50) against its plain version, [Q1]'s
    rule; with `exact`, bit for bit; tex: the scene's TexPack or None;
    moving: the moving variant. Returns (out, kernel ms, plain ms, max
    |delta|)."""
    from rrt_tpu_torch.ops import megakernel as mk
    kw = dict(k_steps=4, max_depth=MAIN["max_depth"], t_min=1e-3,
              moving=moving, solids=solids, tex=tex)
    out = mk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref, plain_ms = wall_ms(
        lambda: mk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw))
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    frac = agree.float().mean().item()
    equal = (torch.equal(out[13][agree], ref[13][agree])
             and torch.equal(out[15][agree], ref[15][agree]))
    err = (out[7:13] - ref[7:13]).abs().amax(dim=0)[agree]
    close = (err < 1e-3).float().mean().item()
    work = torch.empty_like(st)
    ms = launch_copy_ms(lambda: mk.bounce_steps(work, keys, sph, bg, bvh=bvh,
                                                **kw), work, st,
                        mk.bounce_steps)
    print(f"  bounce_steps {what}, {st.shape[1]} lanes, 4 steps: alive "
          f"agrees on {frac:.5f} of lanes, counts equal there, {close:.5f} "
          f"within 1e-3 (max {err.max().item():.3e}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms  [{card}]", flush=True)
    check(frac >= 0.999 and equal and close >= 0.995,
          ("bounce_steps", what, frac, equal, close))
    if exact:
        same_bits(f"bounce_steps {what}, kernel vs plain", [out], [ref])
    return out, ms, plain_ms, err.max().item()


def same_bits(what, a, b):
    """Print and require that two kernels' outputs are equal bit for
    bit."""
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"  {what}: bit for bit {equal}", flush=True)
    check(equal, what)


def cornell_kernels_phase(device, card):
    """[K1] the solid-family variants of tile_render, bounce_steps and
    intersect_only against their plain versions on cornell (tile_render
    at CORNELL's 400x400, 32 spp, depth 50, the plain version in lane
    chunks; bounce_steps at [Q1]'s 131,072 lanes, 4 steps; intersect_only
    at [Q3]'s 65,536 rays, camera rays and after 1-4 bounces), each timed
    by graph replay beside its bound (the 6 quad and 2 box tests a
    segment, the draws, the bytes); the exact gates: chap12 through the
    solid-family variants with empty solid packs gives the sphere
    variants' outputs, and on scenes.book2.mixed_scene the walk seeded by
    the quads' and boxes' t gives the seeded scan's (accel.pack_scan)
    bit for bit in all three kernels; the mixed scene against the plain
    versions too."""
    from rrt_tpu_torch import accel, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.scenes import book2
    w, h, spp = CORNELL["width"], CORNELL["height"], CORNELL["spp"]
    depth = CORNELL["max_depth"]
    scene, cam = tscenes.cornell_box_scene(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = mk.pack_solids(scene, device)
    print(f"  cornell: {solids.n_quads} quads, {solids.n_boxes} boxes, "
          f"{scene.n_spheres_active} spheres (BVH: {bvh.n_nodes} nodes, "
          f"{bvh.n_rows} rows)", flush=True)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=False, solids=solids)
    rad, traced, ms, plain_ms, err = tile_vs_plain(
        "cornell", packs, bvh, kw, card, min_close=CORNELL_MIN_CLOSE)
    segments, paths = int(traced.sum()), w * h * spp
    t_bytes = pack_bytes(*packs, solids.quad24, solids.box24) + 16 * w * h
    t_bound = bound(solid_flops(segments, solids), t_bytes, THREEFRY_OPS * (
        THREEFRY_PER_PATH * paths + THREEFRY_PER_HIT * (segments - paths)))
    print(f"  tile_render cornell: {segments} segments "
          f"({segments / paths:.2f} a path), bound {t_bound[0]:.4f} ms "
          f"({t_bound[1]}: "
          f"{solid_flops(segments, solids) / FP32_PEAK * 1e3:.4f}"
          f" ms of FP32 tests, the draws), kernel {ms:.3f} ms  [{card}]",
          flush=True)
    tile = dict(ms=ms, plain_ms=plain_ms, err=err, bound=t_bound,
                traced=segments)

    st, keys, sph, bg = lane_state(scene, cam, w, h, QUEUE_LANES, device)
    q_bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
    out, q_ms, q_plain_ms, q_err = bounce_vs_plain(
        "cornell", st, keys, sph, bg, q_bvh, solids, card)
    q_bytes = 4 * QUEUE_LANES * (16 + 2 + 16) + pack_bytes(
        sph, bg, solids.quad24, solids.box24)
    q_segments = int((out[15] - st[15]).sum())
    q_bound = bound(solid_flops(q_segments, solids), q_bytes,
                    THREEFRY_OPS * THREEFRY_PER_HIT
                    * drawing_segments(st, out))
    print(f"  bounce_steps cornell: {q_segments} segments, bound "
          f"{q_bound[0]:.4f} ms ({q_bound[1]}), kernel {q_ms:.4f} ms  "
          f"[{card}]", flush=True)
    queue = dict(ms=q_ms, plain_ms=q_plain_ms, err=q_err, bound=q_bound)

    st_b, keys_b, _, _ = lane_state(scene, cam, w, h, BATCH_RAYS, device)
    o, d = st_b[0:3].clone(), st_b[3:6].clone()  # the camera rays
    i_err, i_plain = 0.0, []
    for k in range(5):
        if k:
            mk.bounce_steps(st_b, keys_b, sph, bg, k_steps=1, max_depth=depth,
                            t_min=1e-3, moving=False, bvh=q_bvh,
                            solids=solids)
        _, e, p_ms = intersect_vs_plain(
            f"cornell batch of {BATCH_RAYS} after {k} bounces",
            st_b[0:3].contiguous(), st_b[3:6].contiguous(), None, sph,
            False, q_bvh, solids)
        i_err = max(i_err, e)
        i_plain.append(p_ms)
    i_ms = graph_ms(lambda: mk.intersect_only(o, d, sph, t_min=1e-3,
                                              bvh=q_bvh, solids=solids),
                    mk.intersect_only)
    i_bound = bound(solid_flops(BATCH_RAYS, solids),
                    4 * BATCH_RAYS * 9 + pack_bytes(sph, solids.quad24,
                                                    solids.box24))
    print(f"  intersect_only cornell, {BATCH_RAYS} camera rays: kernel "
          f"{i_ms:.4f} ms, bound {i_bound[0]:.4f} ms ({i_bound[1]})  "
          f"[{card}]", flush=True)
    inter = dict(ms=i_ms, plain_ms=i_plain[0], err=i_err, bound=i_bound)

    # Exact gate 1: the sphere scenes through the solid-family variants.
    scene12, cam12 = tscenes.chap12_scene(240, 160)
    cfg12 = render.RenderConfig(width=240, height=160, spp=4, max_depth=depth)
    *p12, b12 = render._packs(scene12, cam12, cfg12, device, bvh=True)
    empty = mk.SolidPacks(solids.quad24, solids.box24, 0, 0)
    kw12 = dict(kw, width=240, height=160, spp=4, solids=None)
    same_bits("tile_render chap12 240x160 4spp d50, the solid-family "
              "variant with no quad or box vs the sphere variant",
              mk.render_tiles(*p12, bvh=b12, **kw12),
              mk.render_tiles(*p12, bvh=b12, **dict(kw12, solids=empty)))
    st12, k12, s12, bg12 = lane_state(scene12, cam12, 240, 160, 38400, device)
    kwq = dict(k_steps=4, max_depth=depth, t_min=1e-3, moving=False, bvh=b12)
    same_bits("bounce_steps chap12, the same",
              [mk.bounce_steps(st12.clone(), k12, s12, bg12, **kwq)],
              [mk.bounce_steps(st12.clone(), k12, s12, bg12, solids=empty,
                               **kwq)])
    same_bits("intersect_only chap12, the same",
              mk.intersect_only(st12[0:3], st12[3:6], s12, t_min=1e-3,
                                bvh=b12),
              mk.intersect_only(st12[0:3], st12[3:6], s12, t_min=1e-3,
                                bvh=b12, solids=empty))

    # Exact gate 2: the seeded walk against the seeded scan, and the mixed
    # scene against the plain versions.
    mixed, mcam = book2.mixed_scene(320, 240)
    cfgm = render.RenderConfig(width=320, height=240, spp=4, max_depth=depth)
    *pm, bm = render._packs(mixed, mcam, cfgm, device, bvh=True)
    sm = mk.pack_solids(mixed, device)
    scan = accel.pack_scan(pm[0])
    kwm = dict(kw, width=320, height=240, spp=4, solids=sm)
    print(f"  mixed: {sm.n_quads} quads, {sm.n_boxes} boxes, "
          f"{mixed.n_spheres_active} spheres, BVH {bm.n_nodes} nodes, "
          f"{bm.n_always} always tested", flush=True)
    same_bits("tile_render mixed 320x240 4spp d50, the walk vs the scan",
              mk.render_tiles(*pm, bvh=bm, **kwm),
              mk.render_tiles(*pm, bvh=scan, **kwm))
    stm, km, sphm, bgm = lane_state(mixed, mcam, 320, 240, 76800, device)
    for k in range(4):
        same_bits(f"intersect_only mixed after {k} bounces, the walk vs "
                  f"the scan",
                  mk.intersect_only(stm[0:3], stm[3:6], sphm, t_min=1e-3,
                                    bvh=bm, solids=sm),
                  mk.intersect_only(stm[0:3], stm[3:6], sphm, t_min=1e-3,
                                    bvh=scan, solids=sm))
        kwb = dict(k_steps=1, max_depth=depth, t_min=1e-3, moving=False,
                   solids=sm)
        walked = mk.bounce_steps(stm.clone(), km, sphm, bgm, bvh=bm, **kwb)
        same_bits(f"bounce_steps mixed step {k + 1}, the walk vs the scan",
                  [walked], [mk.bounce_steps(stm.clone(), km, sphm, bgm,
                                             bvh=scan, **kwb)])
        stm = walked
    small, scam = book2.mixed_scene(64, 32)
    cfgs = render.RenderConfig(width=64, height=32, spp=4, max_depth=8)
    *ps, bs = render._packs(small, scam, cfgs, device, bvh=True)
    tile_vs_plain("mixed", ps, bs, dict(kwm, width=64, height=32,
                                        max_depth=8), card, min_close=0.985)
    stm, km, sphm, bgm = lane_state(mixed, mcam, 320, 240, 76800, device)
    bounce_vs_plain("mixed", stm, km, sphm, bgm, bm, sm, card)
    intersect_vs_plain("mixed camera rays", stm[0:3].contiguous(),
                       stm[3:6].contiguous(), None, sphm, False, bm, sm)
    return dict(tile=tile, queue=queue, inter=inter)


def cornell_cli_phase(device, card, name="cornell"):
    """[K2] the main path: python -m rrt_tpu_torch.cli --scene cornell
    -r 400x400 -s 32 on the tile driver (auto), launches counted; then
    the queue driver (four passes of 8 spp) and the batch driver (4 spp)
    through the CLI, each held against the tile image of its samples by
    [Q2]'s and [Q3]'s rule (hold_to_tile): on an H100 80GB HBM3 at 700 W
    their image means were 5.7e-6 and 0 apart, traced totals 2.6e-6 and
    1.1e-5, pixels within 1e-3 0.99997 and 1. [S1] runs it on
    cornell_smoke (`name`), whose light emits 7.
    Returns (tile_render launches, bounce_steps launches, intersect_only
    launches)."""
    from rrt_tpu_torch import cli, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, spp = CORNELL["width"], CORNELL["height"], CORNELL["spp"]
    argv = ["--scene", name, "-r", f"{w}x{h}", "-s", str(spp), "-e",
            "0", "--max-depth", str(CORNELL["max_depth"]), "--device",
            "cuda:0", "--quiet"]
    os.makedirs(OUT_DIR, exist_ok=True)

    def run(extra, name, counter):
        with tempfile.TemporaryDirectory() as tmp:  # warm-up run
            cli.render(cli.build_parser().parse_args(
                argv + extra + ["-o", os.path.join(tmp, "warm.png")]))
        counter.launches = 0
        res = cli.render(cli.build_parser().parse_args(
            argv + extra + ["-o", os.path.join(OUT_DIR, name)]))
        launches = counter.launches
        print(f"  {res.driver}: {res.seconds:.4f} s wall, {res.passes} "
              f"passes, {res.n_traced} rays, "
              f"{res.n_traced / res.seconds / 1e6:.2f} Mrays/s, "
              f"{counter.__name__} launches {launches}  [{card}]", flush=True)
        check(launches >= 1 and bool(torch.isfinite(res.image).all()),
              (res.driver, launches))
        return res, launches

    res, t_launches = run([], f"chip_smoke_{name}.png", mk.render_tiles)
    img = res.image
    n_paths = w * h * spp
    nonzero = (img.amax(dim=2) > 0).float().mean().item()
    peak = img.max().item()
    scene, cam = tscenes.SCENES[name](w, h)
    light = scene.tex_color1[
        scene.mat_tex[scene.mat_type == 3].long()].max().item()
    print(f"  tile image: non-zero pixels {nonzero:.4f}, largest value "
          f"{peak} (the light's emission, {light:g}, on pixels whose every "
          f"sample sees it)", flush=True)
    check(res.driver == "tile", ("auto driver", res.driver))
    check(n_paths <= res.n_traced <= n_paths * (CORNELL["max_depth"] + 1),
          ("traced", res.n_traced))
    check(nonzero > CORNELL_MIN_LIT and peak == light,
          (f"{name} image", nonzero, peak))
    res_q, q_launches = run(["--driver", "queue", "--spp-chunk",
                             str(QUEUE_CHUNK)], f"chip_smoke_{name}_queue.png",
                            mk.bounce_steps)
    check(res_q.passes == spp // QUEUE_CHUNK, "queue passes")
    hold_to_tile(f"{name} queue", res_q.image, res_q.n_traced, img,
                 res.n_traced)
    res_b, b_launches = run(["-s", str(BATCH_SPP), "--driver", "batch"],
                            f"chip_smoke_{name}_batch.png", mk.intersect_only)
    cfg_b = render.RenderConfig(width=w, height=h, spp=BATCH_SPP,
                                max_depth=CORNELL["max_depth"])
    tile_b, tile_b_n = render.render_image_tiles(scene, cam, cfg_b, 0,
                                                 device=device)
    hold_to_tile(f"{name} batch", res_b.image, res_b.n_traced, tile_b,
                 int(tile_b_n))
    return t_launches, q_launches, b_launches


def replay_solid_flops(segments, stored, solids) -> float:
    """train_bwd's quad and box tests over `segments` segments of which
    `stored` have a stored winner: one test each of those (the families'
    mean test), every active slot's for the rest (solid_flops)."""
    per_test = (solids.n_quads * QUAD_TEST_FLOPS
                + solids.n_boxes * BOX_TEST_FLOPS) / max(
        solids.n_quads + solids.n_boxes, 1)
    return stored * per_test + solid_flops(segments - stored, solids)


def solid_train_bounds(traced, spp, solids, n_slots):
    """train_fwd's and train_bwd's least times on a solid-family scene
    without spheres ([K3]: cornell), each (ms, by), counted as [K1]'s:
    each segment's quad and box tests (solid_flops), the draws
    (THREEFRY_PER_PATH calls a path, THREEFRY_PER_HIT a segment that
    scatters: segments less paths, an over-count by the lights' hits),
    and the bytes. train_bwd: one recomputed test a stored segment, the
    full tests for the segments past the pool, BWD_SEGMENT_FLOPS of
    adjoint a segment, the same draws, the residual read and d_rad."""
    from rrt_tpu_torch.ops import megakernel_train as mkt
    n_pix = traced.numel()
    segments = int(traced.sum())
    stored = int(traced.long().clamp(max=mkt.winner_capacity(spp)).sum())
    paths = n_pix * spp
    draws = THREEFRY_OPS * (THREEFRY_PER_HIT * (segments - paths)
                            + THREEFRY_PER_PATH * paths) \
        + media_draws(segments, solids)
    med = getattr(solids, "med24", None)
    packs = 4 * (24 * (n_slots + solids.quad24.shape[1]
                       + solids.box24.shape[1]) + 24 + 8) \
        + (0 if med is None else 4 * med.numel())
    residual = paths + 2 * stored
    bwd_ops = (replay_solid_flops(segments, stored, solids)
               + segments * BWD_SEGMENT_FLOPS)
    return (bound(solid_flops(segments, solids),
                  packs + n_pix * (12 + 4) + residual, draws),
            bound(bwd_ops, 2 * packs + n_pix * 12 + residual + 4, draws))


def cornell_chain_lanes(scene, cam, w, h, device):
    """The lanes of one pass of render_image(differentiable=True)'s first
    tile (render.render_tile): tile_pixels pixels times samples_per_pass
    samples, pixel-major within each sample, sample 0's keys first."""
    from rrt_tpu_torch import render, rng
    from rrt_tpu_torch.ops import megakernel as mk
    cfg = render.RenderConfig(width=w, height=h)
    spc, p = cfg.samples_per_pass, min(cfg.tile_pixels, w * h)
    pix = torch.arange(p, device=device).repeat(spc)
    sample = torch.arange(spc, device=device).repeat_interleave(p)
    keys = rng.sample_keys(rng.key_words(0), pix, sample)
    o, d, tm = render.generate_rays(cam.to(device), pix % w, pix // w, w, h,
                                    keys)
    n = pix.numel()
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                       one, zero)
    return st, rng.u32_bits(keys)


def solid_chain_bound(c1, solids):
    """chain_bwd's least time over [K3]'s chains of a solid-family scene
    without spheres, (ms, by): each replayed segment's quad and box tests
    and ADJOINT_FLOPS, the draws of the segments that scatter, and the
    bytes chain_bound counts (the packs' included)."""
    segments = sum(c["segments"] for c in c1)
    lane_bytes = sum(4 * c["q"] * (16 + 2 + 16 + 1 + 16) for c in c1) \
        + len(c1) * 2 * pack_bytes(solids.quad24, solids.box24)
    draws = THREEFRY_OPS * THREEFRY_PER_HIT * sum(c["drawing"] for c in c1)
    return bound(solid_flops(segments, solids) + segments * ADJOINT_FLOPS,
                 lane_bytes, draws)


def solid_train_vs_plain(what, scene, cam, cfg, device, card, *,
                         min_pixels, fields=None,
                         max_winner_faults=MAX_WINNER_FAULTS,
                         exclude_parted=False):
    """The train kernels' solid-family variants against tile_render and
    their plain versions on one scene, [5]'s rule (gradcheck): train_fwd
    gives tile_render's radiance and traced counts bit for bit, its
    pooled winner codes each sample's traced alone (0 faults) and the
    plain version's on the agreeing paths (MAX_WINNER_FAULTS); the
    agreeing pixels (min_pixels at least) weight the backward, whose
    partition() and Camera gradients (the quads' and boxes' fields
    among them) follow gradcheck.field_grad_faults against the plain
    version's (fields: only these partition() fields, each within
    MIXED_FIELD_GATE of its largest, and no camera field); no replay
    mismatch, from the winners or without them. max_winner_faults: the
    share of the plain version's winners on agreeing paths that may
    differ (a scene's own gate where it has one). exclude_parted: the
    gate weights out, besides, the agreeing pixels whose stored winners
    part from the plain version's (another way the agreement rule cannot
    see: rttnw_final's), and the comparison with them weighted in is
    printed beside it.
    Returns the numbers of the kernels line and the plain gradients."""
    from rrt_tpu_torch import diff, gradcheck, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    solids = mk.pack_solids(scene, device)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
              height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
              t_min=cfg.t_min, moving=scene.has_moving, solids=solids,
              tex=mk.pack_textures(scene, device))
    rad, traced, lengths, winners = mkt.render_tiles_train(*packs, **kw)
    ref_rad, ref_traced = mk.render_tiles(*packs, bvh=tile_bvh(packs), **kw)
    same = torch.equal(rad, ref_rad) and torch.equal(traced, ref_traced)
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    agreement = gradcheck.sample_agreement(packs, kw)
    frac = agreement.agree.float().mean().item()
    w_faults, w_compared, differ = gradcheck.winner_faults(
        winners, lengths, agreement)
    p_faults, p_compared = gradcheck.pool_faults(winners, lengths, agreement)
    if w_faults:
        firsts = gradcheck.first_differences(differ)
        kf, _ = mk.decode_winner(firsts[:, 3])
        pf, _ = mk.decode_winner(firsts[:, 4])
        pairs, counts = torch.stack([kf, pf], 1).unique(dim=0,
                                                       return_counts=True)
        print(f"  {what}: the differing winners lie on {firsts.shape[0]} "
              f"paths; at each one's first, (kernel's family, plain's "
              f"family): " + ", ".join(
                  f"{tuple(p_.tolist())} {int(c)}"
                  for p_, c in zip(pairs, counts))
              + " (-1 none, 0 sphere, 1 quad, 2 medium, 3 box)", flush=True)
    print(f"  {what} {cfg.width}x{cfg.height} {cfg.spp}spp "
          f"d{cfg.max_depth}: train_fwd == tile_render {same}; "
          f"{residual_line(traced, lengths, cfg.spp)}; {frac:.5f} of pixels "
          f"and {agreement.path_share:.5f} of paths agree with the plain "
          f"version (gate {min_pixels}); winner codes: {w_faults} of "
          f"{w_compared} differ from the plain version's (gate "
          f"{max_winner_faults:.0e}), {p_faults} of {p_compared} from each "
          f"sample traced alone (gate 0)", flush=True)
    check(same, (what, "train_fwd vs tile_render"))
    check(frac >= min_pixels, (what, "agreement", frac))
    check(w_compared > 0 and w_faults <= max_winner_faults * w_compared,
          (what, "winners", w_faults, w_compared))
    check(p_compared > 0 and p_faults == 0,
          (what, "pooled winners", p_faults, p_compared))
    n_pix = cfg.width * cfg.height
    names = fields or ("quad_q", "quad_u", "quad_v", "box_center",
                       "box_half", "tex_color1", "bg_bottom")

    def backward(agree):
        """The kernels' and the plain version's gradients for the loss
        these pixels weight: (kernel's, without the winners', plain's,
        faults, max |delta|, each field's worst over its largest, rule,
        the plain field gradients, d_rad, the plain version's ms)."""
        weight = torch.sin(torch.arange(n_pix, device=device) * 0.1) * agree
        d_rad = (weight[:, None]
                 * torch.tensor(MIX, device=device)).contiguous()
        k = mkt.tiles_adjoint(*packs, d_rad, lengths, winners, **kw)
        scan = mkt.tiles_adjoint(*packs, d_rad, lengths, None, **kw)
        p, plain_ms = wall_ms(lambda: mkt.tiles_adjoint_reference(
            *packs, d_rad, agreement.lengths, None, chunk=1 << 19, **kw))
        kp, kc = diff.field_grads(scene, cam, cfg, *k[:3], k[4],
                                  device=device)
        pp, pc = diff.field_grads(scene, cam, cfg, *p[:3], p[4],
                                  device=device)
        worst = {f: ((kp[f] - pp[f]).abs().max()
                     / pp[f].abs().max().clamp(min=1e-30)).item()
                 for f in names}
        if fields is None:
            faults, err = gradcheck.field_grad_faults(kp, kc, pp, pc)
            rule = "gradcheck's rule, 2e-3 of each field's largest"
        else:
            faults = [(f, v) for f, v in worst.items()
                      if v > MIXED_FIELD_GATE]
            err = max((kp[f] - pp[f]).abs().max().item() for f in fields)
            rule = f"{MIXED_FIELD_GATE:g} of each field's largest"
        return k, scan, p, faults, err, worst, rule, pp, d_rad, plain_ms

    agree = agreement.agree
    if exclude_parted:
        parted = torch.zeros_like(agree)
        if w_faults:
            parted[differ[:, 2]] = True
        parted &= agree
        _, _, _, faults, err, worst, rule, _, _, _ = backward(agree)
        print(f"  {what}: with the {int(parted.sum())} agreeing pixels whose "
              f"stored winners part from the plain version's weighted in: "
              f"field faults {faults} ({rule}); max |grad delta| {err:.3e}; "
              f"over each field's largest: " + ", ".join(
                  f"{f} {v:.2e}" for f, v in worst.items()), flush=True)
        agree = agree & ~parted
    k, scan, p, faults, err, worst, rule, pp, d_rad, bwd_plain_ms = \
        backward(agree)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, lengths,
                                               winners, **kw), 3)
    mism = (int(k[3]), int(scan[3]), int(p[3]))
    print(f"  {what}: replay_mismatches {mism} (gate 0); d_cam and d_bg "
          f"from the winners vs without bit-equal "
          f"{torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2])}; "
          f"field faults {faults} ({rule}"
          + (f"; the {int(parted.sum())} pixels weighted out"
             if exclude_parted else "")
          + f"); max |grad delta| {err:.3e}; "
          f"over each field's largest: " + ", ".join(f"{f} {v:.2e} (largest "
                                   f"{pp[f].abs().max().item():.3e})"
                                   for f, v in worst.items())
          + f"; train_fwd {fwd_ms:.3f} ms (plain "
          f"{agreement.plain_seconds * 1e3:.1f} ms), train_bwd {bwd_ms:.3f} "
          f"ms (plain {bwd_plain_ms:.1f} ms)  [{card}]", flush=True)
    check(mism == (0, 0, 0), (what, "replay_mismatches", mism))
    check(torch.equal(k[1], scan[1]) and torch.equal(k[2], scan[2]),
          (what, "winners vs scan"))
    check(not faults, (what, "gradients", faults))
    fwd_err = ((rad - agreement.rad).abs().max() / cfg.spp).item()
    return dict(fwd_ms=fwd_ms, fwd_plain_ms=agreement.plain_seconds * 1e3,
                bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, fwd_err=fwd_err,
                bwd_err=err, traced=traced, solids=solids,
                n_slots=packs[0].shape[1], grads=pp, packs=packs, kw=kw,
                winners=winners, d_solids=(k[4], p[4]), d_atlas=(k[5], p[5]))


def cornell_finite_differences(t, scene, cam, cfg, device):
    """d loss / d (red wall's albedo, red) and d loss / d (the light's
    emission, red) from train_bwd against central differences of the
    train_fwd forward, loss = sum(MIX . radiance) in float64 (eps 1e-2
    and 1e-1: neither moves a path; the CPU's 48x48 readings agreed
    within 5e-6, the gate is [6]'s 1e-2). quad_u[2][1] (the light's
    tilt) is printed beside its central difference without a gate:
    cornell's radiance is a product of albedos and the emission, so
    path-replay gives its geometry no gradient (0, as rrt_tpu's), and
    the difference comes from silhouettes crossing pixels and paths,
    which the estimator leaves out."""
    from rrt_tpu_torch import diff, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    kw = t["kw"]
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(
            *packs, **dict(kw, solids=mk.pack_solids(s, device)))

    packs, (rad, _, lengths, winners) = forward(scene)
    out = mkt.tiles_adjoint(*packs, mix.expand_as(rad).contiguous(), lengths,
                            winners, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, *out[:3], out[4],
                             device=device)
    light = int(scene.mat_tex[scene.quad_mat[int(
        (scene.mat_type[scene.quad_mat[:scene.n_quads_active]] == 3)
        .nonzero()[0, 0])]])
    red = int(scene.mat_tex[scene.quad_mat[1]])
    worst = 0.0
    for field, index, eps, gated in (("tex_color1", (red, 0), 1e-2, True),
                                     ("tex_color1", (light, 0), 1e-1, True),
                                     ("quad_u", (2, 1), 1.0, False)):
        def loss(delta):
            v = getattr(scene, field).clone()
            v[index] += delta
            r = forward(diff.combine(scene, {field: v}))[1][0]
            return (r.double() * mix.double()).sum().item()

        fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
        auto = gp[field][index].item()
        rel = abs(auto - fd) / max(abs(fd), 1e-30)
        print(f"  d loss / d {field}{list(index)}: train_bwd {auto:.6e}, "
              f"central difference (eps {eps:g}) {fd:.6e}, {rel:.2e} apart"
              + (" (gate 1e-2)" if gated else " (no gate: silhouettes)"),
              flush=True)
        if gated:
            worst = max(worst, rel)
            check(auto != 0.0 and rel < 1e-2, (field, index, auto, fd))
        else:
            check(auto == 0.0, (field, index, "geometry gradient", auto))
    return worst


def cornell_train_phase(device, card, resources):
    """[K3] cornell's gradient on the card, at 400x400, depth 50, 8 spp
    (bench.py's train_step_8spp count): the train kernels' and
    chain_bwd's solid-family variants against their plain versions
    (solid_train_vs_plain; chain_vs_plain on the three chains of one
    pass of render_image(differentiable=True)'s first tile), finite
    differences (cornell_finite_differences), the same on
    scenes.book2.mixed_scene at 320x240, 4 spp, depth 8, whose quad_q and
    box_center gradients are not 0; then the main path with the launch
    counts set to 0: make_train_step (three SGD steps, the loss must
    fall), make_train_step_chunked (two chunks of 4 spp) and
    render_image(differentiable=True) at 4 spp with an L2 loss's
    gradient. Returns the numbers of the kernels line."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    from rrt_tpu_torch.scenes import book2
    w, h, depth = CORNELL["width"], CORNELL["height"], CORNELL["max_depth"]
    cfg = render.RenderConfig(width=w, height=h, spp=CORNELL_TRAIN_SPP,
                              max_depth=depth)
    scene, cam = tscenes.cornell_box_scene(w, h)
    torch.cuda.reset_peak_memory_stats(device)
    t = solid_train_vs_plain("cornell", scene, cam, cfg, device, card,
                             min_pixels=CORNELL_MIN_AGREE)
    fwd_bound, bwd_bound = solid_train_bounds(t["traced"], cfg.spp,
                                              t["solids"], t["n_slots"])
    print(f"  cornell train bounds: train_fwd {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}), train_bwd {bwd_bound[0]:.4f} ms "
          f"({bwd_bound[1]}); {int(t['traced'].sum())} segments", flush=True)
    fd_worst = cornell_finite_differences(t, scene, cam, cfg, device)

    st, keys = cornell_chain_lanes(scene, cam, w, h, device)
    solids = t["solids"]
    sph, bg = t["packs"][0], t["packs"][2]
    bvh = render.chain_bvh(sph, st[6], False)
    lane = torch.arange(st.shape[1], device=device)
    c1 = []
    schedule = render._fused_schedule(depth)
    # The last chain's geometric cotangents stay 0, as the loss gives
    # them: 43 steps of random ones in the closed box grew to 2.6e6 on one
    # lane of 65,536, where float32 rounding put the kernel's and the
    # plain version's box_center gradients 15% apart (an H100 80GB HBM3
    # at 700 W; the other lanes within 1e-3).
    for j, k_steps in enumerate(schedule):
        out, numbers = chain_vs_plain(
            f"cornell chain {j + 1} of {schedule}", st, keys, sph, bg, bvh,
            k_steps, scene, cam, cfg, device, card, solids=solids,
            radiance_only=j == len(schedule) - 1)
        c1.append(numbers)
        if j < len(schedule) - 1:
            st, keys, lane = render._compact_lanes(out, keys, lane)
    c_bound = solid_chain_bound(c1, solids)
    c_ms = sum(c["ms"] for c in c1)
    print(f"  cornell's three chains: chain_bwd {c_ms:.4f} ms, plain "
          f"{sum(c['plain_ms'] for c in c1):.1f} ms, bound "
          f"{c_bound[0]:.4f} ms ({c_bound[1]}); "
          f"{sum(c['segments'] for c in c1)} replayed segments  [{card}]",
          flush=True)

    mw, mh = MIXED_TRAIN["width"], MIXED_TRAIN["height"]
    mixed, mcam = book2.mixed_scene(mw, mh)
    mcfg = render.RenderConfig(**MIXED_TRAIN)
    m = solid_train_vs_plain("mixed", mixed, mcam, mcfg, device, card,
                             min_pixels=MIXED_MIN_AGREE, fields=MIXED_FIELDS)
    mst, mkeys, msph, mbg = lane_state(mixed, mcam, mw, mh, mw * mh, device)
    msol = mk.pack_solids(mixed, device)
    # Radiance cotangents only: a random one on o and d at 76,800 lanes
    # meets grazing hits on the quads and boxes, whose t moves as 1 /
    # (d.n), and two float32 evaluations of the same code part there
    # (the CPU: box_center outside the rule on 2 lanes of 76,800).
    _, mc = chain_vs_plain("mixed camera rays", mst, mkeys, msph, mbg,
                           render.chain_bvh(msph, mst[6], False), 4, mixed,
                           mcam, mcfg, device, card, solids=msol,
                           radiance_only=True)
    for key in ("quad_q", "box_center"):
        largest = (m["grads"][key].abs().max().item(),
                   mc["grads"][key].abs().max().item())
        print(f"  mixed: the plain versions' largest {key} gradient "
              f"{largest[0]:.4e} (train), {largest[1]:.4e} (chain)",
              flush=True)
        check(min(largest) > 0, ("mixed", key, largest))
    peak_memory("[K3] kernels vs plain versions", device, card)

    # The main path, launches counted from 0.
    bcfg = dataclasses.replace(cfg, spp=BATCH_SPP, samples_per_pass=BATCH_SPP)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    target_b, _ = render.render_image_tiles(scene, cam, bcfg, 1,
                                            device=device)
    n_tex = scene.tex_color1.shape[0]
    start = diff.combine(scene, {"tex_color1": scene.tex_color1
                                 * torch.linspace(0.8, 1.1, n_tex)[:, None]})
    step = diff.make_train_step(cfg, device=device)
    chunked = diff.make_train_step_chunked(cfg, spp_chunk=4, device=device)
    chunked(start, cam, target, 0)  # warm-up (a build, the first packs)
    counters = (mkt.render_tiles_train, mkt.tiles_adjoint, mk.bounce_steps,
                mkv.chain_adjoint, mk.render_tiles)
    for c in counters:
        c.launches = 0
    mkt.tiles_adjoint.replay_mismatches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    s_scene, s_cam = start, cam
    with chain_events() as (fwd_log, bwd_log):
        for i in range(3):
            fwd_log.clear()
            bwd_log.clear()
            (s_scene, s_cam, loss), ms = wall_ms(
                lambda: step(s_scene, s_cam, target, 0))
            losses.append(loss.item())
            step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
            print(f"  make_train_step {i}: loss {losses[-1]:.8e}, train_fwd "
                  f"{step_ms[-1][0]:.3f} ms, train_bwd {step_ms[-1][1]:.3f} "
                  f"ms, step {ms:.2f} ms  [{card}]", flush=True)
        (_, _, c_loss), c_wall = wall_ms(lambda: chunked(start, cam, target,
                                                         0))
    print(f"  make_train_step_chunked (2 chunks of 4 spp): loss "
          f"{c_loss.item():.8e} (one-shot's first {losses[0]:.8e}), step "
          f"{c_wall:.2f} ms  [{card}]", flush=True)
    (img, n, b_loss, gp, gc), b_ms = wall_ms(lambda: batch_loss_and_grads(
        bcfg, start, cam, target_b, 0, device))
    launches = [c.launches for c in counters]
    mism = (int(mkt.tiles_adjoint.replay_mismatches),
            int(mkv.chain_adjoint.replay_mismatches))
    print(f"  render_image(differentiable=True) {BATCH_SPP}spp: loss "
          f"{b_loss.item():.8e}, {n} traced segments, {b_ms / 1e3:.3f} s "
          f"wall", flush=True)
    print(f"  launches train_fwd {launches[0]}, train_bwd {launches[1]}, "
          f"bounce_steps {launches[2]}, chain_bwd {launches[3]}, "
          f"tile_render {launches[4]}; replay_mismatches {mism} (gate 0); "
          f"losses {losses} (must fall)  [{card}]", flush=True)
    peak_memory("[K3] main path", device, card)
    check(launches[0] >= 5 and launches[1] >= 5 and launches[2] >= 3
          and launches[3] >= 3, ("[K3] launches", launches))
    check(mism == (0, 0), ("[K3] replay_mismatches", mism))
    check(losses[2] < losses[1] < losses[0], ("[K3] the loss", losses))
    check(abs(c_loss.item() - losses[0]) <= 1e-5 * losses[0],
          ("[K3] chunked vs one-shot", c_loss.item(), losses[0]))
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), ("[K3] non-finite", key))
    check(gp["tex_color1"].abs().max().item() > 0, "[K3] zero albedo grad")
    fwd_main = sum(m_[0] for m_ in step_ms) / len(step_ms)
    bwd_main = sum(m_[1] for m_ in step_ms) / len(step_ms)

    def numbers(ms, plain_ms, err, bnd, n_launch, name):
        return dict(cornell_ms=ms, cornell_plain_ms=plain_ms,
                    cornell_bound_ms=bnd[0], cornell_bound_by=bnd[1],
                    cornell_max_abs_err=err, cornell_launches=n_launch,
                    cornell_registers=resources.get(name + " (solids)"))

    return dict(
        fd_worst=fd_worst,
        train_fwd=numbers(t["fwd_ms"], t["fwd_plain_ms"], t["fwd_err"],
                          fwd_bound, launches[0], "train_fwd_kernel"),
        train_bwd=numbers(t["bwd_ms"], t["bwd_plain_ms"], t["bwd_err"],
                          bwd_bound, launches[1], "train_bwd_kernel"),
        chain_bwd=numbers(c_ms, sum(c["plain_ms"] for c in c1),
                          max(c["err"] for c in c1), c_bound, launches[3],
                          "chain_bwd_kernel"),
        step_ms=(fwd_main, bwd_main))


def smoke_kernels_phase(device, card):
    """[S1] the media variants of tile_render, bounce_steps and
    intersect_only on cornell_smoke against their plain versions:
    tile_render at SMOKE's 400x400, 32 spp, depth 50 timed by graph
    replay and held to the plain version at SMOKE_PLAIN_SPP by [K1]'s
    rule; bounce_steps at [Q1]'s 131,072 lanes, 4 steps, and
    intersect_only at [Q3]'s 65,536 rays (camera rays and after 1-4
    bounces, each with its keys and bounce counter for the media's
    draws) bit for bit (quads and media: the same arithmetic, CUDA's libm
    in both); each beside its bound (each segment's 6 quad and 2 medium
    tests, the draws, the bytes)."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, spp = SMOKE["width"], SMOKE["height"], SMOKE["spp"]
    depth = SMOKE["max_depth"]
    scene, cam = tscenes.cornell_smoke_scene(w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = mk.pack_solids(scene, device)
    print(f"  cornell_smoke: {solids.n_quads} quads, {solids.n_boxes} "
          f"boxes, {solids.n_media} media (medium boxes rotated about Y, "
          f"density 0.01), {scene.n_spheres_active} spheres", flush=True)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=False, solids=solids)
    rad, traced = mk.render_tiles(*packs, bvh=bvh, **kw)
    ms = graph_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw),
                  mk.render_tiles)
    _, _, _, plain_ms, err = tile_vs_plain(
        "cornell_smoke", packs, bvh, dict(kw, spp=SMOKE_PLAIN_SPP), card,
        min_close=SMOKE_MIN_CLOSE)
    segments, paths = int(traced.sum()), w * h * spp
    t_bytes = pack_bytes(*packs, solids.quad24, solids.box24,
                         solids.med24) + 16 * w * h
    t_bound = bound(solid_flops(segments, solids), t_bytes, THREEFRY_OPS * (
        THREEFRY_PER_PATH * paths + THREEFRY_PER_HIT * (segments - paths))
        + media_draws(segments, solids))
    print(f"  tile_render cornell_smoke {w}x{h} {spp}spp d{depth}: "
          f"{segments} segments ({segments / paths:.2f} a path), bound "
          f"{t_bound[0]:.4f} ms ({t_bound[1]}: "
          f"{solid_flops(segments, solids) / FP32_PEAK * 1e3:.4f} ms of FP32 "
          f"tests, the draws), kernel {ms:.3f} ms  [{card}]", flush=True)
    tile = dict(ms=ms, plain_ms=plain_ms, err=err, bound=t_bound,
                traced=segments)

    st, keys, sph, bg = lane_state(scene, cam, w, h, QUEUE_LANES, device)
    q_bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
    out, q_ms, q_plain_ms, q_err = bounce_vs_plain(
        "cornell_smoke", st, keys, sph, bg, q_bvh, solids, card, exact=True)
    q_bytes = 4 * QUEUE_LANES * (16 + 2 + 16) + pack_bytes(
        sph, bg, solids.quad24, solids.box24, solids.med24)
    q_segments = int((out[15] - st[15]).sum())
    q_bound = bound(solid_flops(q_segments, solids), q_bytes,
                    THREEFRY_OPS * THREEFRY_PER_HIT
                    * drawing_segments(st, out)
                    + media_draws(q_segments, solids))
    print(f"  bounce_steps cornell_smoke: {q_segments} segments, bound "
          f"{q_bound[0]:.4f} ms ({q_bound[1]}), kernel {q_ms:.4f} ms  "
          f"[{card}]", flush=True)
    queue = dict(ms=q_ms, plain_ms=q_plain_ms, err=q_err, bound=q_bound)

    st_b, keys_b, _, _ = lane_state(scene, cam, w, h, BATCH_RAYS, device)
    i_plain, scattered = [], 0
    for k in range(5):
        if k:
            mk.bounce_steps(st_b, keys_b, sph, bg, k_steps=1, max_depth=depth,
                            t_min=1e-3, moving=False, bvh=q_bvh,
                            solids=solids)
        ikw = dict(t_min=1e-3, solids=solids, keys=keys_b,
                   bounce=st_b[13].to(torch.int32))
        o, d = st_b[0:3].contiguous(), st_b[3:6].contiguous()
        hit = mk.intersect_only(o, d, sph, bvh=q_bvh, **ikw)
        ref, p_ms = wall_ms(lambda: mk.intersect_only_reference(o, d, sph,
                                                                **ikw))
        i_plain.append(p_ms)
        scattered += int((hit[1] == 2).sum())
        same_bits(f"intersect_only cornell_smoke, {BATCH_RAYS} rays after "
                  f"{k} bounces, kernel vs plain", hit, ref)
        if k == 0:
            i_ms = graph_ms(lambda: mk.intersect_only(o, d, sph, bvh=q_bvh,
                                                      **ikw),
                            mk.intersect_only)
    i_bound = bound(solid_flops(BATCH_RAYS, solids),
                    4 * BATCH_RAYS * 12 + pack_bytes(
                        sph, solids.quad24, solids.box24, solids.med24),
                    media_draws(BATCH_RAYS, solids))
    print(f"  intersect_only cornell_smoke, {BATCH_RAYS} camera rays: "
          f"kernel {i_ms:.4f} ms, bound {i_bound[0]:.4f} ms ({i_bound[1]}); "
          f"{scattered} of the rays over the 5 sets scatter in a medium  "
          f"[{card}]", flush=True)
    check(scattered > 0, "[S1] no ray scattered in a medium")
    inter = dict(ms=i_ms, plain_ms=i_plain[0], err=0.0, bound=i_bound)
    return dict(tile=tile, queue=queue, inter=inter)


def smoke_finite_differences(t, scene, cam, cfg, device):
    """d loss / d (the white smoke's albedo, red) from train_bwd against
    central differences of the train_fwd forward, loss = sum(MIX .
    radiance) in float64, eps 1e-2 (the albedo scales the throughput of
    the paths that scatter in the smoke and moves no path), the gate
    [6]'s 1e-2 (1.44e-4 on an H100 80GB HBM3 at 700 W). Returns the
    relative difference."""
    from rrt_tpu_torch import diff, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    kw = dict(t["kw"], spp=cfg.spp)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(
            *packs, **dict(kw, solids=mk.pack_solids(s, device)))

    packs, (rad, _, lengths, winners) = forward(scene)
    out = mkt.tiles_adjoint(*packs, mix.expand_as(rad).contiguous(), lengths,
                            winners, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, *out[:3], out[4],
                             device=device)
    white = int(scene.mat_tex[scene.med_mat[1]])
    eps = 1e-2

    def loss(delta):
        v = scene.tex_color1.clone()
        v[white, 0] += delta
        r = forward(diff.combine(scene, {"tex_color1": v}))[1][0]
        return (r.double() * mix.double()).sum().item()

    fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
    auto = gp["tex_color1"][white, 0].item()
    rel = abs(auto - fd) / max(abs(fd), 1e-30)
    print(f"  d loss / d tex_color1[{white}][0] (the white smoke's albedo): "
          f"train_bwd {auto:.6e}, central difference (eps {eps:g}) "
          f"{fd:.6e}, {rel:.2e} apart (gate 1e-2)", flush=True)
    check(auto != 0.0 and rel < 1e-2, ("[S2] smoke albedo", auto, fd))
    return rel


def smoke_train_phase(device, card, resources):
    """[S2] cornell_smoke's gradient on the card at 400x400, depth 50:
    the train kernels' media variants against tile_render and their
    plain versions at SMOKE_PLAIN_SPP (solid_train_vs_plain,
    gradcheck's rule), timed at CORNELL_TRAIN_SPP beside their bounds;
    central differences of the white smoke's albedo; then the main path
    with the launch counts set to 0: make_train_step at 8 spp (three SGD
    steps, the loss must fall) and make_train_step_chunked (two chunks of
    4 spp), with no replay mismatch, no bounce_steps or chain_bwd launch;
    render_image(differentiable=True) and the bounce chain must raise
    before any launch (rrt_tpu's chain leaves media out, and the port
    keeps the scan off the card). Returns the numbers of the kernels
    line."""
    from rrt_tpu_torch import diff, render, rng, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    w, h, depth = SMOKE["width"], SMOKE["height"], SMOKE["max_depth"]
    cfg = render.RenderConfig(width=w, height=h, spp=CORNELL_TRAIN_SPP,
                              max_depth=depth)
    scene, cam = tscenes.cornell_smoke_scene(w, h)
    torch.cuda.reset_peak_memory_stats(device)
    t = solid_train_vs_plain("cornell_smoke", scene, cam,
                             dataclasses.replace(cfg, spp=SMOKE_PLAIN_SPP),
                             device, card, min_pixels=SMOKE_MIN_AGREE)
    packs, kw = t["packs"], dict(t["kw"], spp=cfg.spp)
    fwd = mkt.render_tiles_train(*packs, **kw)
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    d_rad = torch.ones_like(fwd[0])
    bwd = mkt.tiles_adjoint(*packs, d_rad, *fwd[2:], **kw)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, *fwd[2:],
                                               **kw), 3)
    fwd_bound, bwd_bound = solid_train_bounds(fwd[1], cfg.spp, t["solids"],
                                              t["n_slots"])
    print(f"  cornell_smoke {w}x{h} {cfg.spp}spp d{depth}: train_fwd "
          f"{fwd_ms:.3f} ms (bound {fwd_bound[0]:.4f}, {fwd_bound[1]}), "
          f"train_bwd {bwd_ms:.3f} ms (bound {bwd_bound[0]:.4f}, "
          f"{bwd_bound[1]}); replay mismatches {int(bwd[3])}; "
          f"{int(fwd[1].sum())} segments  [{card}]", flush=True)
    check(int(bwd[3]) == 0, ("[S2] replay_mismatches", int(bwd[3])))
    fd_rel = smoke_finite_differences(t, scene, cam, cfg, device)
    peak_memory("[S2] kernels vs plain versions", device, card)

    # The main path, launches counted from 0.
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    n_tex = scene.tex_color1.shape[0]
    start = diff.combine(scene, {"tex_color1": scene.tex_color1
                                 * torch.linspace(0.8, 1.1, n_tex)[:, None]})
    step = diff.make_train_step(cfg, device=device)
    chunked = diff.make_train_step_chunked(cfg, spp_chunk=4, device=device)
    chunked(start, cam, target, 0)  # warm-up
    counters = (mkt.render_tiles_train, mkt.tiles_adjoint, mk.bounce_steps,
                mkv.chain_adjoint, mk.render_tiles)
    for c in counters:
        c.launches = 0
    mkt.tiles_adjoint.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    s_scene, s_cam = start, cam
    with chain_events() as (fwd_log, bwd_log):
        for i in range(3):
            fwd_log.clear()
            bwd_log.clear()
            (s_scene, s_cam, loss), ms = wall_ms(
                lambda: step(s_scene, s_cam, target, 0))
            losses.append(loss.item())
            step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
            print(f"  make_train_step {i}: loss {losses[-1]:.8e}, train_fwd "
                  f"{step_ms[-1][0]:.3f} ms, train_bwd {step_ms[-1][1]:.3f} "
                  f"ms, step {ms:.2f} ms  [{card}]", flush=True)
        (_, _, c_loss), c_wall = wall_ms(lambda: chunked(start, cam, target,
                                                         0))
    print(f"  make_train_step_chunked (2 chunks of 4 spp): loss "
          f"{c_loss.item():.8e} (one-shot's first {losses[0]:.8e}), step "
          f"{c_wall:.2f} ms  [{card}]", flush=True)
    launches = [c.launches for c in counters]
    mism = int(mkt.tiles_adjoint.replay_mismatches)
    raised = []
    for what, fn in (
            ("render_image(differentiable=True)",
             lambda: render.render_image(start, cam, cfg, 0,
                                         differentiable=True,
                                         device=device)),
            ("trace_batch_fused", lambda: render.trace_batch_fused(
                start.to(device), *smoke_chain_rays(start, cam, device),
                depth, 1e-3))):
        try:
            fn()
        except NotImplementedError as e:
            raised.append(what)
            print(f"  {what} raises: {e}", flush=True)
    after = [c.launches for c in counters]
    print(f"  launches train_fwd {launches[0]}, train_bwd {launches[1]}, "
          f"bounce_steps {launches[2]}, chain_bwd {launches[3]}, "
          f"tile_render {launches[4]}; after the two raises {after}; "
          f"replay_mismatches {mism} (gate 0); losses {losses} (must "
          f"fall)  [{card}]", flush=True)
    peak_memory("[S2] main path", device, card)
    check(launches[0] >= 5 and launches[1] >= 5 and launches[2] == 0
          and launches[3] == 0, ("[S2] launches", launches))
    check(after == launches and len(raised) == 2, ("[S2] raises", raised,
                                                   after))
    check(mism == 0, ("[S2] replay_mismatches", mism))
    check(all(math.isfinite(x) for x in losses)
          and losses[2] < losses[1] < losses[0], ("[S2] the loss", losses))
    check(abs(c_loss.item() - losses[0]) <= 1e-5 * losses[0],
          ("[S2] chunked vs one-shot", c_loss.item(), losses[0]))

    def numbers(ms, plain_ms, err, bnd, n_launch, name):
        return dict(smoke_ms=ms, smoke_plain_ms=plain_ms,
                    smoke_bound_ms=bnd[0], smoke_bound_by=bnd[1],
                    smoke_max_abs_err=err, smoke_launches=n_launch,
                    smoke_registers=resources.get(name + " (solids)"))

    return dict(
        fd_rel=fd_rel,
        train_fwd=numbers(fwd_ms, t["fwd_plain_ms"], t["fwd_err"], fwd_bound,
                          launches[0], "train_fwd_kernel"),
        train_bwd=numbers(bwd_ms, t["bwd_plain_ms"], t["bwd_err"], bwd_bound,
                          launches[1], "train_bwd_kernel"))


def smoke_chain_rays(scene, cam, device):
    """(o, d, time, keys) of 4,096 camera rays of `scene` at 64x64, the
    bounce chain's inputs for [S2]'s raise."""
    from rrt_tpu_torch import render, rng
    pix = torch.arange(4096, device=device)
    keys = rng.sample_keys(rng.key_words(0), pix, 0)
    o, d, tm = render.generate_rays(cam.to(device), pix % 64, pix // 64, 64,
                                    64, keys)
    return o, d, tm, keys


def media_adjoint_phase(device, card):
    """[S3] the media adjoint on scenes.book2.media_scene at MEDIA_ADJ
    (320x240, 4 spp, depth 8), where the sky gives the media a gradient
    (cornell_smoke's black background and constant albedos give its
    media's positions none, as rrt_tpu's): train_fwd and train_bwd
    against their plain versions (solid_train_vs_plain: MEDIA_FIELDS
    within MIXED_FIELD_GATE of their largest), the medium pack's
    cotangents within MEDIA_SPREAD of their largest; both media, the
    sphere boundary (inside the glass sphere) and the box one, must be
    hit, and get non-zero center and density cotangents."""
    from rrt_tpu_torch import render
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    from rrt_tpu_torch.scenes import book2
    scene, cam = book2.media_scene(MEDIA_ADJ["width"], MEDIA_ADJ["height"])
    cfg = render.RenderConfig(**MEDIA_ADJ)
    torch.cuda.reset_peak_memory_stats(device)
    m = solid_train_vs_plain("media", scene, cam, cfg, device, card,
                             min_pixels=MEDIA_MIN_AGREE, fields=MEDIA_FIELDS)
    k_med, p_med = (d.med24 for d in m["d_solids"])
    cols = list(mkv.MED_COLS)
    largest = p_med[:, cols].abs().max().item()
    spread = (k_med - p_med)[:, cols].abs().max().item() / largest
    hits = [int((m["winners"] == mk.MEDIUM_CODE + i).sum())
            for i in range(scene.n_media_active)]
    print(f"  media: stored medium winners {hits} (sphere, box); medium "
          f"pack cotangents: kernel vs plain {spread:.3e} of their largest "
          f"{largest:.4e} (gate {MEDIA_SPREAD:g}); plain center "
          f"{p_med[:2, 1:4].tolist()}, -1/density {p_med[:2, 17].tolist()}",
          flush=True)
    peak_memory("[S3]", device, card)
    check(min(hits) > 0, ("[S3] both boundaries hit", hits))
    check(spread <= MEDIA_SPREAD, ("[S3] med24 spread", spread))
    # The sphere medium fills the glass sphere, so its paths start on its
    # boundary (t_min clamps the entry: no center gradient, as in
    # rrt_tpu); the box medium's are entered from outside.
    check(p_med[:2, 17].abs().min().item() > 0
          and p_med[1, 1:4].abs().max().item() > 0,
          ("[S3] zero media cotangents", p_med[:2].tolist()))
    return dict(spread=spread, hits=hits)


# [T1]-[T2]: the perlin-marble and image textures. simple_light (RTTNW
# ch. 7.1: two marble spheres, a quad light and a sphere light, a black
# background) and earth (ch. 6: one sphere with the 128x256 procedural
# stand-in image under the sky; BASELINE.json config #4) at RTTNW's
# 400x225, depth 50, uncut; [T1] tile_render at 32 spp, [T2] the train
# step at 8 spp.
TEXTURE = dict(width=400, height=225, spp=32, max_depth=50)
TEXTURE_SCENES = ("simple_light", "earth")
# The plain versions run at this many spp ([T1] tile_render, [T2] the
# train kernels): their time grows with the samples.
TEXTURE_PLAIN_SPP = 2
# [T1]: pixels within 1e-3 of the plain version (the slice rule, 98.5%);
# [T2]: pixels each of whose samples agree, [S2]'s gate. The kernels and
# the plain versions pick the same texel by the same polynomial rule
# (geometry.sphere_uv); rsqrtf, sinf and the hash products may differ in
# the last bits, and a marble's radiance with them.
TEXTURE_MIN_CLOSE = 0.985
TEXTURE_MIN_AGREE = 0.98
# FP32 and INT32 operations of one marble (bounce.cuh turbulence): 7
# octaves, each the floor, fraction and hermite weights (18), 8 corners
# of the gradient (3 conversions, 3 scale-and-shift pairs, the squared
# length, its clamp and rsqrtf, 3 scalings: 19), the dot (8), the
# weight (2) and the sum (2), and |n| and the weighted sum (3): 270 an
# octave; then the phase, the sine and the albedo (8). The hash is 12
# INT32 operations a corner. One image lookup: the sphere's uv (two
# atan2 of 17 and the rest, 55) or the quad's (14), and the texel's
# index (12). Lower bounds: the rest of the shading is not counted.
MARBLE_FLOPS = 7 * 270 + 8
MARBLE_INT_OPS = 7 * 8 * 12
IMAGE_FLOPS = 67
# [T2]: the marble's texture scale and color1 by central differences
# (eps below) against train_bwd, [6]'s gate.
TEXTURE_FD_EPS = 1e-2
# [T1]: the lit share of the CLI's tile image, about half of what an
# H100 80GB HBM3 at 700 W read: simple_light 0.3180 (a black
# background: a pixel is lit when a path reaches a light), earth 1.0000
# (the sky).
TEXTURE_MIN_LIT = {"simple_light": 0.15, "earth": 0.5}
# [T2]: simple_light's three make_train_step steps keep its camera and
# geometry (each step gets the first step's camera, and from the step's
# scene these fields alone: the albedos and the background). The
# marble's 7 octaves of turbulence, 10 times the phase, make the loss
# rough along the camera's and the spheres' parameters, and a step there
# moves the lights' silhouettes, a change path replay does not see: with
# every field trained the loss rose at the default learning rate 1e-2
# (0.02803 -> 0.02812 -> 0.02844) and at 1e-4 (0.028033 -> 0.028038 ->
# 0.028050) on an H100 80GB HBM3 at 700 W, and was not monotone at 1e-5
# (the plain versions on the CPU at the same size). earth trains every
# field.
TEXTURE_TRAINED = {"simple_light": ("tex_color1", "tex_color2", "bg_bottom",
                                    "bg_top")}
# [T2]: train_bwd's atlas cotangent against its plain version's, over
# the plain version's largest: float atomics in another order, on the
# agreeing paths (which read the same texels).
TEXTURE_ATLAS_SPREAD = 1e-4


def texture_bound(segments, paths, tex, solids, n_bytes, stored=None):
    """(bound_ms, by) of `segments` traced segments of `paths` paths on a
    textured scene: each scattering segment (segments less paths, every
    surface of simple_light and earth but the lights) evaluates its
    texture once (MARBLE_FLOPS and MARBLE_INT_OPS, or IMAGE_FLOPS), the
    solid families' tests, the draws; n_bytes: the packs, the atlas and
    the outputs. With `stored` (the segments with a stored winner),
    train_bwd's, counted as solid_train_bounds counts it: the same
    texture work and draws once, the solid tests of the replay
    (replay_solid_flops) and BWD_SEGMENT_FLOPS of adjoint a segment."""
    hits = segments - paths
    flops = hits * (MARBLE_FLOPS if tex.has_perlin else IMAGE_FLOPS)
    ints = THREEFRY_OPS * (THREEFRY_PER_HIT * hits + THREEFRY_PER_PATH * paths)
    if tex.has_perlin:
        ints += hits * MARBLE_INT_OPS
    if stored is not None:
        flops += segments * BWD_SEGMENT_FLOPS
    if solids is not None:
        flops += (solid_flops(segments, solids) if stored is None
                  else replay_solid_flops(segments, stored, solids))
    return bound(flops, n_bytes, ints)


def texture_kernels_phase(name, device, card):
    """[T1] tile_render's and bounce_steps' texture variants on `name` at
    TEXTURE's size against their plain versions: tile_render timed at 32
    spp by graph replay and held to its plain version at
    TEXTURE_PLAIN_SPP ([K1]'s rule with TEXTURE_MIN_CLOSE); bounce_steps
    at [Q1]'s 131,072 lanes, 4 steps, by [Q1]'s rule; each beside its
    bound (texture_bound). Returns the numbers of the kernels line."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, spp = TEXTURE["width"], TEXTURE["height"], TEXTURE["spp"]
    depth = TEXTURE["max_depth"]
    scene, cam = tscenes.SCENES[name](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = mk.pack_solids(scene, device)
    tex = mk.pack_textures(scene, device)
    print(f"  {name}: {scene.n_spheres_active} spheres, "
          f"{scene.n_quads_active} quads, perlin {tex.has_perlin}, images "
          f"{tex.has_images} (atlas {tex.shape}, {4 * tex.atlas.numel()} "
          f"bytes)", flush=True)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=False, solids=solids,
              tex=tex)
    rad, traced = mk.render_tiles(*packs, bvh=bvh, **kw)
    ms = graph_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw),
                  mk.render_tiles)
    _, _, _, plain_ms, err = tile_vs_plain(
        name, packs, bvh, dict(kw, spp=TEXTURE_PLAIN_SPP), card,
        min_close=TEXTURE_MIN_CLOSE)
    segments, paths = int(traced.sum()), w * h * spp
    solid_packs = () if solids is None else (solids.quad24, solids.box24)
    t_bound = texture_bound(segments, paths, tex, solids, pack_bytes(
        *packs, *solid_packs, tex.atlas) + 16 * w * h)
    print(f"  tile_render {name} {w}x{h} {spp}spp d{depth}: {segments} "
          f"segments ({segments / paths:.2f} a path), bound "
          f"{t_bound[0]:.4f} ms ({t_bound[1]}), kernel {ms:.3f} ms  "
          f"[{card}]", flush=True)
    st, keys, sph, bg = lane_state(scene, cam, w, h, QUEUE_LANES, device)
    q_bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
    out, q_ms, q_plain_ms, q_err = bounce_vs_plain(
        name, st, keys, sph, bg, q_bvh, solids, card, tex=tex)
    q_segments = int((out[15] - st[15]).sum())
    q_bound = texture_bound(
        q_segments, q_segments - drawing_segments(st, out), tex, solids,
        4 * QUEUE_LANES * (16 + 2 + 16) + pack_bytes(sph, bg, *solid_packs,
                                                     tex.atlas))
    print(f"  bounce_steps {name}: {q_segments} segments, bound "
          f"{q_bound[0]:.4f} ms ({q_bound[1]}), kernel {q_ms:.4f} ms  "
          f"[{card}]", flush=True)
    return dict(tile=dict(ms=ms, plain_ms=plain_ms, err=err, bound=t_bound),
                queue=dict(ms=q_ms, plain_ms=q_plain_ms, err=q_err,
                           bound=q_bound))


def texture_cli_phase(name, device, card, size=TEXTURE, min_lit=None):
    """[T1]'s main path: python -m rrt_tpu_torch.cli --scene `name` -r
    400x225 -s 32 (`size`) on the tile driver (auto), then the queue
    driver (four passes of 8 spp) and the batch driver (4 spp), each
    held against the tile image of its samples by [Q2]'s and [Q3]'s rule
    (hold_to_tile), launches counted from 0 for each; the tile image's
    lit share above min_lit (default TEXTURE_MIN_LIT's). Returns
    (tile_render, bounce_steps, intersect_only) launches."""
    from rrt_tpu_torch import cli, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, spp = size["width"], size["height"], size["spp"]
    min_lit = TEXTURE_MIN_LIT[name] if min_lit is None else min_lit
    argv = ["--scene", name, "-r", f"{w}x{h}", "-s", str(spp), "-e", "0",
            "--max-depth", str(size["max_depth"]), "--device", "cuda:0",
            "--quiet"]
    os.makedirs(OUT_DIR, exist_ok=True)

    def run(extra, out, counter):
        with tempfile.TemporaryDirectory() as tmp:  # warm-up run
            cli.render(cli.build_parser().parse_args(
                argv + extra + ["-o", os.path.join(tmp, "warm.png")]))
        counter.launches = 0
        res = cli.render(cli.build_parser().parse_args(
            argv + extra + ["-o", os.path.join(OUT_DIR, out)]))
        launches = counter.launches
        print(f"  {name} {res.driver}: {res.seconds:.4f} s wall, "
              f"{res.passes} passes, {res.n_traced} rays, "
              f"{res.n_traced / res.seconds / 1e6:.2f} Mrays/s, "
              f"{counter.__name__} launches {launches}  [{card}]", flush=True)
        check(launches >= 1 and bool(torch.isfinite(res.image).all()),
              (name, res.driver, launches))
        return res, launches

    res, t_launches = run([], f"chip_smoke_{name}.png", mk.render_tiles)
    lit = (res.image.amax(dim=2) > 0).float().mean().item()
    print(f"  {name} tile image: lit pixels {lit:.4f}, mean "
          f"{res.image.mean().item():.6f}", flush=True)
    check(res.driver == "tile" and lit > min_lit, (name, res.driver, lit))
    res_q, q_launches = run(["--driver", "queue", "--spp-chunk",
                             str(QUEUE_CHUNK)], f"chip_smoke_{name}_queue.png",
                            mk.bounce_steps)
    hold_to_tile(f"{name} queue", res_q.image, res_q.n_traced, res.image,
                 res.n_traced)
    res_b, b_launches = run(["-s", str(BATCH_SPP), "--driver", "batch"],
                            f"chip_smoke_{name}_batch.png", mk.intersect_only)
    scene, cam = tscenes.SCENES[name](w, h)
    cfg_b = render.RenderConfig(width=w, height=h, spp=BATCH_SPP,
                                max_depth=size["max_depth"])
    tile_b, tile_b_n = render.render_image_tiles(scene, cam, cfg_b, 0,
                                                 device=device)
    hold_to_tile(f"{name} batch", res_b.image, res_b.n_traced, tile_b,
                 int(tile_b_n))
    return t_launches, q_launches, b_launches


def marble_finite_differences(t, scene, cam, cfg, device):
    """d loss / d (the marble's texture scale) and d loss / d (its
    color1, red) from train_bwd against central differences of the
    train_fwd forward, loss = sum(MIX . radiance) in float64, eps
    TEXTURE_FD_EPS (the scale moves the marble's phase; neither moves a
    path), the gate [6]'s 1e-2. Returns the worst relative difference."""
    from rrt_tpu_torch import diff, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    from rrt_tpu_torch.scene import TEX_PERLIN
    kw = dict(t["kw"], spp=cfg.spp)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(
            *packs, **dict(kw, solids=mk.pack_solids(s, device),
                           tex=mk.pack_textures(s, device)))

    packs, (rad, _, lengths, winners) = forward(scene)
    out = mkt.tiles_adjoint(*packs, mix.expand_as(rad).contiguous(), lengths,
                            winners, **kw)
    gp, _ = diff.field_grads(scene, cam, cfg, *out[:3], out[4],
                             device=device)
    marble = int((scene.tex_type == TEX_PERLIN).nonzero()[0, 0])
    eps, worst = TEXTURE_FD_EPS, 0.0
    for field, idx in (("tex_scale", (marble,)), ("tex_color1", (marble, 0))):
        def loss(delta):
            v = getattr(scene, field).clone()
            v[idx] += delta
            r = forward(diff.combine(scene, {field: v}))[1][0]
            return (r.double() * mix.double()).sum().item()

        fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
        auto = gp[field][idx].item()
        rel = abs(auto - fd) / max(abs(fd), 1e-30)
        worst = max(worst, rel)
        print(f"  d loss / d {field}{list(idx)} (the marble): train_bwd "
              f"{auto:.6e}, central difference (eps {eps:g}) {fd:.6e}, "
              f"{rel:.2e} apart (gate 1e-2)", flush=True)
        check(auto != 0.0 and rel < 1e-2, ("[T2] marble", field, auto, fd))
    return worst


def texture_train_phase(name, device, card, resources):
    """[T2] `name`'s gradient on the card at TEXTURE's size, depth 50:
    the train kernels' texture variants against tile_render and their
    plain versions at TEXTURE_PLAIN_SPP (solid_train_vs_plain,
    gradcheck's rule; with images the atlas cotangent within
    TEXTURE_ATLAS_SPREAD of the plain version's largest), timed at
    CORNELL_TRAIN_SPP; chain_bwd against its plain version on one pass of
    render_image(differentiable=True)'s first tile (four steps, the
    radiance's cotangent); simple_light's marble by central differences
    (marble_finite_differences); then the main path with the launch
    counts set to 0: make_train_step at 8 spp (three SGD steps, on
    simple_light of the fields TEXTURE_TRAINED names, the loss must
    fall, no replay mismatch) and render_image(differentiable=True)
    at 4 spp on a 64x36 crop of the camera's view with an L2 loss's
    gradient (bounce_steps and chain_bwd). Returns the numbers of the
    kernels line."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    w, h, depth = TEXTURE["width"], TEXTURE["height"], TEXTURE["max_depth"]
    cfg = render.RenderConfig(width=w, height=h, spp=CORNELL_TRAIN_SPP,
                              max_depth=depth)
    scene, cam = tscenes.SCENES[name](w, h)
    torch.cuda.reset_peak_memory_stats(device)
    t = solid_train_vs_plain(name, scene, cam,
                             dataclasses.replace(cfg, spp=TEXTURE_PLAIN_SPP),
                             device, card, min_pixels=TEXTURE_MIN_AGREE)
    k_atlas, p_atlas = t["d_atlas"]
    atlas_rel = None
    if p_atlas is not None:
        atlas_rel = ((k_atlas - p_atlas).abs().max()
                     / p_atlas.abs().max().clamp(min=1e-30)).item()
        print(f"  {name}: train_bwd's atlas cotangent within "
              f"{atlas_rel:.2e} of the plain version's largest "
              f"({p_atlas.abs().max().item():.4e}; float atomics, rule "
              f"{TEXTURE_ATLAS_SPREAD:g})", flush=True)
        check(atlas_rel <= TEXTURE_ATLAS_SPREAD
              and p_atlas.abs().max().item() > 0, (name, "atlas", atlas_rel))
    packs, kw = t["packs"], dict(t["kw"], spp=cfg.spp)
    fwd = mkt.render_tiles_train(*packs, **kw)
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    d_rad = torch.ones_like(fwd[0])
    bwd = mkt.tiles_adjoint(*packs, d_rad, *fwd[2:], **kw)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, *fwd[2:],
                                               **kw), 3)
    tex, solids = kw["tex"], kw["solids"]
    segments, paths = int(fwd[1].sum()), w * h * cfg.spp
    solid_packs = () if solids is None else (solids.quad24, solids.box24)
    all_packs = pack_bytes(*packs, *solid_packs, tex.atlas)
    fwd_bound = texture_bound(segments, paths, tex, solids,
                              all_packs + w * h * 16 + paths * 33)
    # The backward reads the packs and writes their cotangents (the
    # atlas's among them), reads d_rad, the lengths and the stored
    # winners.
    stored = int(fwd[1].long().clamp(max=mkt.winner_capacity(cfg.spp)).sum())
    bwd_bound = texture_bound(segments, paths, tex, solids,
                              2 * all_packs + w * h * 12 + paths + 2 * stored,
                              stored=stored)
    print(f"  {name} {w}x{h} {cfg.spp}spp d{depth}: train_fwd {fwd_ms:.3f} "
          f"ms (bound {fwd_bound[0]:.4f}, {fwd_bound[1]}), train_bwd "
          f"{bwd_ms:.3f} ms (bound {bwd_bound[0]:.4f}, {bwd_bound[1]}); "
          f"replay mismatches {int(bwd[3])}; {segments} segments  [{card}]",
          flush=True)
    check(int(bwd[3]) == 0, ("[T2] replay_mismatches", name, int(bwd[3])))
    fd_rel = (marble_finite_differences(t, scene, cam, cfg, device)
              if tex.has_perlin else None)

    st, keys = cornell_chain_lanes(scene, cam, w, h, device)
    sph, bg = packs[0], packs[2]
    _, c1 = chain_vs_plain(f"{name} camera rays", st, keys, sph, bg,
                           render.chain_bvh(sph, st[6], False), 4, scene,
                           cam, cfg, device, card, solids=solids,
                           radiance_only=True, tex=tex)
    c_bound = texture_bound(2 * c1["segments"], 2 * c1["q"], tex, solids,
                            pack_bytes(sph, bg, *solid_packs, tex.atlas)
                            + 4 * c1["q"] * (16 * 3 + 2))
    print(f"  chain_bwd {name}: {c1['ms']:.4f} ms, bound {c_bound[0]:.4f} "
          f"ms ({c_bound[1]})  [{card}]", flush=True)
    peak_memory(f"[T2] {name} kernels vs plain versions", device, card)

    # The main path, launches counted from 0.
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    n_tex = scene.tex_color1.shape[0]
    start = diff.combine(scene, {"tex_color1": scene.tex_color1
                                 * torch.linspace(0.8, 1.1, n_tex)[:, None]})
    step = diff.make_train_step(cfg, device=device)
    step(start, cam, target, 0)  # warm-up
    bw, bh = 64, 36
    bcfg = render.RenderConfig(width=bw, height=bh, spp=BATCH_SPP,
                               max_depth=depth, samples_per_pass=BATCH_SPP)
    b_scene, b_cam = tscenes.SCENES[name](bw, bh)
    target_b, _ = render.render_image_tiles(b_scene, b_cam, bcfg, 1,
                                            device=device)
    counters = (mkt.render_tiles_train, mkt.tiles_adjoint, mk.bounce_steps,
                mkv.chain_adjoint, mk.render_tiles)
    for c in counters:
        c.launches = 0
    mkt.tiles_adjoint.replay_mismatches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    s_scene, s_cam = start, cam
    with chain_events() as (fwd_log, bwd_log):
        for i in range(3):
            fwd_log.clear()
            bwd_log.clear()
            (s_scene, s_cam, loss), ms = wall_ms(
                lambda: step(s_scene, s_cam, target, 0))
            if name in TEXTURE_TRAINED:
                s_scene = diff.combine(start, {
                    k: getattr(s_scene, k) for k in TEXTURE_TRAINED[name]})
                s_cam = cam
            losses.append(loss.item())
            step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
            print(f"  {name} make_train_step {i}: loss {losses[-1]:.8e}, "
                  f"train_fwd {step_ms[-1][0]:.3f} ms, train_bwd "
                  f"{step_ms[-1][1]:.3f} ms, step {ms:.2f} ms  [{card}]",
                  flush=True)
    (img, n, b_loss, gp, gc), b_ms = wall_ms(lambda: batch_loss_and_grads(
        bcfg, diff.combine(b_scene, {"tex_color1": start.tex_color1}), b_cam,
        target_b, 0, device))
    launches = [c.launches for c in counters]
    mism = (int(mkt.tiles_adjoint.replay_mismatches),
            int(mkv.chain_adjoint.replay_mismatches))
    print(f"  {name} render_image(differentiable=True) {bw}x{bh} "
          f"{BATCH_SPP}spp: loss {b_loss.item():.8e}, {n} traced segments, "
          f"{b_ms / 1e3:.3f} s wall", flush=True)
    print(f"  {name} launches train_fwd {launches[0]}, train_bwd "
          f"{launches[1]}, bounce_steps {launches[2]}, chain_bwd "
          f"{launches[3]}, tile_render {launches[4]}; replay_mismatches "
          f"{mism} (gate 0); losses {losses} (must fall)  [{card}]",
          flush=True)
    peak_memory(f"[T2] {name} main path", device, card)
    check(launches[0] >= 3 and launches[1] >= 3 and launches[2] >= 1
          and launches[3] >= 1, ("[T2] launches", name, launches))
    check(mism == (0, 0), ("[T2] replay_mismatches", name, mism))
    check(all(math.isfinite(x) for x in losses)
          and losses[2] < losses[1] < losses[0], ("[T2] the loss", name,
                                                  losses))
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), ("[T2] non-finite", name, key))
    fwd_main = sum(m_[0] for m_ in step_ms) / len(step_ms)
    bwd_main = sum(m_[1] for m_ in step_ms) / len(step_ms)
    prefix = "light" if name == "simple_light" else name

    def numbers(ms, plain_ms, err, bnd, n_launch, kernel, **extra):
        return {f"{prefix}_ms": ms, f"{prefix}_plain_ms": plain_ms,
                f"{prefix}_bound_ms": bnd[0], f"{prefix}_bound_by": bnd[1],
                f"{prefix}_max_abs_err": err, f"{prefix}_launches": n_launch,
                f"{prefix}_registers": resources.get(
                    kernel + (" (solids, tex)" if solids is not None
                              else " (tex)")),
                **{f"{prefix}_{k}": v for k, v in extra.items()}}

    return dict(
        fd_rel=fd_rel,
        train_fwd=numbers(fwd_ms, t["fwd_plain_ms"], t["fwd_err"], fwd_bound,
                          launches[0], "train_fwd_kernel", main_ms=fwd_main),
        train_bwd=numbers(bwd_ms, t["bwd_plain_ms"], t["bwd_err"], bwd_bound,
                          launches[1], "train_bwd_kernel", main_ms=bwd_main,
                          atlas_spread=atlas_rel),
        chain_bwd=numbers(c1["ms"], c1["plain_ms"], c1["err"], c_bound,
                          launches[3], "chain_bwd_kernel",
                          atlas_spread=c1["atlas"]),
        queue_launches=launches[2])


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


# [F1]-[F3]: the RTTNW final scene (rrt_tpu/scenes/book2.py, RTTNW ch.
# 10; bench.py's second scene, uncut: 400x267, 32 spp, depth 50): 1,006
# spheres (one moving), a quad light, 400 ground boxes past SOLID_CAP,
# two constant media, the marble and the earth image, in Morton order.
# The forward kernels and train_fwd walk the boxes' tree
# (accel.SolidBvh), train_bwd loops over them ([F3]: its gradient on
# the card); chain_bwd walks them too ([F4]), but leaves the constant
# media out (#9.4), so the chain's route raises on the card for this
# scene and takes it without its media. [F2]: a test scene of
# 81 rotated boxes and 82 quads under the sky
# (scenes.book2.many_solids_scene).
RTTNW = dict(scene="rttnw_final", width=400, height=267, spp=32, max_depth=50)
# [F1]: tile_render against its plain version at this many spp (the
# plain version's time grows with them), by the slice rule: 98.5% of
# pixels within 1e-3, image means and traced totals within 1%.
RTTNW_PLAIN_SPP = 2
RTTNW_MIN_CLOSE = 0.985
# [F1]: the rays the walk's tests are counted on (accel's plain walks,
# eager on the card), a stride of [Q1]'s lanes.
RTTNW_COUNT_RAYS = 16384
# [F1]: the lit share of the CLI's tile image, 0.3826 on an H100 80GB
# HBM3 at 700 W (a black background: the pixels whose paths miss the
# light stay black); the gate half of it.
RTTNW_MIN_LIT = 0.19
MANY = dict(width=320, height=240, spp=4, max_depth=50)
# The scan's tests a segment of rttnw_final: its active quads, boxes and
# spheres.
RTTNW_SCAN_TESTS = 1 + 400 + 1006
# [F3]: the train kernels against their plain versions at this many spp
# (the plain backward's time grows with them), the agreeing pixels at
# least [S2]'s share; timed, and the main path run, at
# CORNELL_TRAIN_SPP. make_train_step's three steps keep the camera and
# the geometry (each step gets the first step's camera, and from the
# step's scene the fields RTTNW_TRAINED), as [T2] does on simple_light:
# the marble's turbulence and the glass make the loss rough along them.
RTTNW_TRAIN_PLAIN_SPP = 1
RTTNW_MIN_AGREE = 0.98
# [F3]: the winners of agreeing paths that may differ from the plain
# version's. On an H100 80GB HBM3 at 700 W 82 of 363,013 did (2.26e-4,
# [5]'s MAX_WINNER_FAULTS allows 1e-4), on 21 paths, each of whose first
# differing winners names a sphere on one side: the plain version's
# sphere shading rounds otherwise on rttnw_final ([F1]'s
# parting_families, ROADMAP Queue C), and under its black background
# two paths that part often bank the same radiance in as many bounces,
# which the agreement rule cannot see. The gate allows 2.2 times the
# reading; the pool's layout keeps its exact gate (pool_faults), train_bwd
# checks every stored winner it replays, and the pixels of such paths
# get no weight in the gradients' comparison.
RTTNW_MAX_WINNER_FAULTS = 5e-4
RTTNW_TRAINED = ("tex_color1", "tex_color2", "bg_bottom", "bg_top")


def medium_inputs(st, keys):
    """intersect_only's media arguments for the lanes of a queue state
    st (16, Q) and their key bits: keys and the bounce row as int32."""
    return dict(keys=keys, bounce=st[13].to(torch.int32).contiguous())


def solid_walk_counts(scene, cam, st, keys, sph, bg, bvh, solids, tex,
                      depth):
    """The walks' tests a segment on a stride of RTTNW_COUNT_RAYS of the
    lanes of st: camera rays, then the live ones after 1-4 bounce steps
    (the kernel's), through accel.solid_closest_reference (quads, boxes)
    and accel.bvh_closest_reference seeded by the solids' t (spheres).
    Returns {"segments", "nodes", "solids", "spheres": tests a segment,
    "depth": [(segments, node, solid and sphere tests) a depth]}."""
    from rrt_tpu_torch import accel
    from rrt_tpu_torch.ops import megakernel as mk
    stride = max(1, st.shape[1] // RTTNW_COUNT_RAYS)
    st, keys = st[:, ::stride].clone(), keys[:, ::stride].contiguous()
    rows = []
    for k in range(5):
        if k:
            mk.bounce_steps(st, keys, sph, bg, k_steps=1, max_depth=depth,
                            t_min=1e-3, moving=scene.has_moving, bvh=bvh,
                            solids=solids, tex=tex)
        live = (st[14] > 0.5).nonzero()[:, 0]
        o, d = st[0:3, live].contiguous(), st[3:6, live].contiguous()
        ts, _, _, s_nodes, s_tests = accel.solid_closest_reference(
            o, d, solids.quad24, solids.box24, solids.tree, t_min=1e-3)
        _, _, _, b_nodes, b_tests = accel.bvh_closest_reference(
            o, d, sph, bvh, t_min=1e-3, time=st[6, live].contiguous()
            if scene.has_moving else None, seed=ts)
        rows.append((live.numel(), int(s_nodes.sum() + b_nodes.sum()),
                     int(s_tests.sum()), int(b_tests.sum())))
    n = sum(r[0] for r in rows)
    return dict(segments=n, depth=rows, nodes=sum(r[1] for r in rows) / n,
                solids=sum(r[2] for r in rows) / n,
                spheres=sum(r[3] for r in rows) / n)


def rttnw_flops(segments, counts, moving: bool, n_media: int) -> float:
    """FP32 operations of `segments` segments of rttnw_final at counts'
    tests a segment: the walks' node, box and sphere tests, and the
    media's (sphere boundaries)."""
    return segments * (WALK_RAY_FLOPS + counts["nodes"] * NODE_FLOPS
                       + counts["solids"] * BOX_TEST_FLOPS
                       + counts["spheres"] * slot_flops(moving)
                       + n_media * MEDIUM_SPHERE_FLOPS + 2)


def rttnw_bound(segments, paths, counts, scene, tex, n_bytes):
    """(bound_ms, by) of `segments` segments of `paths` paths on
    rttnw_final: the walks' tests at counts', the media, the texture of
    each scattering segment (the marble's or the image's, whichever
    costs less: a lower bound), the Threefry draws and the media's, and
    n_bytes."""
    hits = segments - paths
    flops = rttnw_flops(segments, counts, scene.has_moving,
                        scene.n_media_active) + hits * IMAGE_FLOPS
    ints = THREEFRY_OPS * (THREEFRY_PER_HIT * hits + THREEFRY_PER_PATH * paths
                           + segments * ((scene.n_media_active + 1) // 2))
    return bound(flops, n_bytes, ints)


def rttnw_bwd_bound(segments, stored, paths, families, counts, scene, tex,
                    n_bytes):
    """train_bwd's (bound_ms, by) on rttnw_final, counted as
    solid_train_bounds counts it: one test of each stored winner (its
    family's: families, the stored codes by family), the walk's tests
    (rttnw_flops at counts') for the segments past the pool,
    BWD_SEGMENT_FLOPS of adjoint a segment and the texture of each
    scattering segment (rttnw_bound's IMAGE_FLOPS), the forward's draws
    once (the replay draws them again; the sweep draws nothing but a
    medium's, which rttnw_bound counts once a segment), and n_bytes."""
    hits = segments - paths
    tests = (families["sphere"] * slot_flops(scene.has_moving)
             + families["quad"] * QUAD_TEST_FLOPS
             + families["box"] * BOX_TEST_FLOPS
             + families["medium"] * MEDIUM_SPHERE_FLOPS)
    flops = (tests + rttnw_flops(segments - stored, counts, scene.has_moving,
                                 scene.n_media_active)
             + segments * BWD_SEGMENT_FLOPS + hits * IMAGE_FLOPS)
    ints = THREEFRY_OPS * (THREEFRY_PER_HIT * hits + THREEFRY_PER_PATH * paths
                           + segments * ((scene.n_media_active + 1) // 2))
    return bound(flops, n_bytes, ints)


def blocks_line(mk, kernel, sph, bvh, moving, solids, tex) -> str:
    """The blocks an SM of a forward kernel's instantiation at the shared
    memory its launch takes (mk.forward_blocks)."""
    b = mk.forward_blocks(kernel, sph, bvh, moving=moving, solids=solids,
                          tex=tex)
    return (f"  {kernel} blocks an SM: {b['blocks']}, {b['smem_bytes']} B "
            f"of shared memory")


def parting_families(st, keys, sph, bg, bvh, solids, tex, depth):
    """[F1]: the lanes of st where one bounce_steps step and its plain
    version part (any row's bits), by the family of the segment's winner
    (intersect_only's, held bit for bit to its plain version on these
    lanes in [F1]). Requires every such lane's winner to be a sphere: the
    winners agree, and the plain version's sphere shading rounds
    otherwise (as on chap12), so the walk over the boxes parts no lane.
    Returns {family: lanes}."""
    from rrt_tpu_torch import geometry
    from rrt_tpu_torch.ops import megakernel as mk
    kw = dict(k_steps=1, max_depth=depth, t_min=1e-3, moving=True,
              solids=solids, tex=tex)
    out = mk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh, **kw)
    ref = mk.bounce_steps_reference(st.clone(), keys, sph, bg, **kw)
    parted = (out.view(torch.int32) != ref.view(torch.int32)).any(dim=0)
    _, fam, _ = mk.intersect_only(
        st[0:3].contiguous(), st[3:6].contiguous(), sph, bvh=bvh,
        t_min=1e-3, time=st[6].contiguous(), solids=solids,
        **medium_inputs(st, keys))
    names = ((geometry.FAM_SPHERE, "sphere"), (geometry.FAM_QUAD, "quad"),
             (geometry.FAM_BOX, "box"), (geometry.FAM_MEDIUM, "medium"),
             (geometry.FAM_NONE, "miss"))
    live = st[14] > 0.5
    won = {name: int((live & (fam == f)).sum()) for f, name in names}
    part = {name: int((parted & (fam == f)).sum()) for f, name in names}
    print(f"  bounce_steps rttnw_final, one step, kernel vs plain: "
          f"{int(parted.sum())} of {st.shape[1]} lanes part; by their "
          f"winner {part}, of the live lanes' winners {won}", flush=True)
    check(int(parted.sum()) == part["sphere"],
          ("bounce_steps rttnw_final lanes parted off a sphere", part))
    return part


def rttnw_kernels_phase(device, card, resources):
    """[F1] rttnw_final's forward kernels (kMoving, kSolids, kTex) on the
    card: tile_render at 32 spp timed by graph replay and held to its
    plain version at RTTNW_PLAIN_SPP by the slice rule, the solid scan's
    time beside it; bounce_steps at [Q1]'s 131,072 lanes, 4 steps, and
    intersect_only on 131,072 rays (camera rays and after 1-4 bounces)
    against their plain versions, bounce_steps by [Q1]'s rule (the
    sphere hits' shading rounds otherwise in the plain version, as on
    chap12: parting_families holds every lane it parts on one step to a
    sphere winner), intersect_only bit for bit; the three walks against
    the solid scan (accel.solid_scan) bit for bit; the walks' tests a
    segment beside the scan's; blocks an SM."""
    from rrt_tpu_torch import accel, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    w, h, spp = RTTNW["width"], RTTNW["height"], RTTNW["spp"]
    depth = RTTNW["max_depth"]
    scene, cam = tscenes.SCENES["rttnw_final"](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    solids = mk.pack_solids(scene, device)
    tex = mk.pack_textures(scene, device)
    scan = dataclasses.replace(solids, tree=accel.solid_scan(solids.tree))
    tree = solids.tree
    print(f"  rttnw_final: {scene.n_spheres_active} spheres (moving "
          f"{scene.has_moving}), {solids.n_quads} quads, {solids.n_boxes} "
          f"boxes, {solids.n_media} media, perlin {tex.has_perlin}, images "
          f"{tex.has_images}; spheres' BVH {bvh.n_nodes} nodes, "
          f"{bvh.n_rows} rows, {bvh.smem_bytes(True)} B; boxes' tree "
          f"{tree.box.n_nodes} nodes, {tree.box.n_rows} rows, depth "
          f"{tree.box.depth}, quads' {tree.quad.n_nodes} nodes (a loop "
          f"up to {accel.SOLID_CAP}); the trees "
          f"{tree.smem_bytes()} B", flush=True)
    for tag in (" (moving, solids, tex, walk)", " (moving, solids, walk)",
                " (moving, solids, tex)", " (moving, solids)"):
        for k in ("tile_render_kernel", "bounce_steps_kernel",
                  "intersect_kernel"):
            if k + tag in resources:
                r = resources[k + tag]
                print(f"  {k}{tag}: {r.get('registers')} registers "
                      f"({r.get('stack')}, {r.get('spill_stores')}, "
                      f"{r.get('spill_loads')})", flush=True)
    for kernel, t in (("tile_render", tex), ("bounce_steps", tex),
                      ("intersect_only", None)):
        print(blocks_line(mk, kernel, packs[0], bvh, True, solids, t),
              flush=True)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=True, solids=solids,
              tex=tex)
    rad, traced = mk.render_tiles(*packs, bvh=bvh, **kw)
    ms = graph_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **kw),
                  mk.render_tiles)
    print(f"  tile_render rttnw_final {w}x{h} {spp}spp d{depth}: {ms:.3f} "
          f"ms  [{card}]", flush=True)
    scan_ms = graph_ms(lambda: mk.render_tiles(*packs, bvh=bvh, **dict(
        kw, solids=scan)), mk.render_tiles)
    print(f"  tile_render rttnw_final, the solid scan (every quad and box "
          f"a segment): {scan_ms:.3f} ms  [{card}]", flush=True)
    kw2 = dict(kw, spp=RTTNW_PLAIN_SPP)
    same_bits(f"tile_render rttnw_final {RTTNW_PLAIN_SPP}spp, the walk vs "
              f"the solid scan", mk.render_tiles(*packs, bvh=bvh, **kw2),
              mk.render_tiles(*packs, bvh=bvh, **dict(kw2, solids=scan)))
    _, _, _, plain_ms, err = tile_vs_plain(
        "rttnw_final", packs, bvh, kw2, card, min_close=RTTNW_MIN_CLOSE)

    st, keys, sph, bg = lane_state(scene, cam, w, h, QUEUE_LANES, device)
    q_bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
    counts = solid_walk_counts(scene, cam, st, keys, sph, bg, q_bvh, solids,
                               tex, depth)
    per = ", ".join(f"{r[1] / r[0]:.2f}/{r[2] / r[0]:.2f}/{r[3] / r[0]:.2f}"
                    for r in counts["depth"])
    print(f"  the walks on {counts['segments']} segments (camera rays and "
          f"1-4 bounces): node/box/sphere tests a segment {per} at depths "
          f"0-4; over all {counts['nodes']:.3f} nodes, "
          f"{counts['solids']:.3f} quads and boxes, {counts['spheres']:.3f} "
          f"spheres, against the scan's {RTTNW_SCAN_TESTS} quad, box and "
          f"sphere tests", flush=True)
    segments, paths = int(traced.sum()), w * h * spp
    t_bytes = pack_bytes(*packs, solids.quad24, solids.box24, solids.med24,
                         tex.atlas) + 16 * w * h
    t_bound = rttnw_bound(segments, paths, counts, scene, tex, t_bytes)
    print(f"  tile_render rttnw_final: {segments} segments "
          f"({segments / paths:.2f} a path), bound {t_bound[0]:.4f} ms "
          f"({t_bound[1]}), kernel {ms:.3f} ms  [{card}]", flush=True)
    tile = dict(ms=ms, plain_ms=plain_ms, err=err, bound=t_bound,
                scan_ms=scan_ms)

    # [Q1]'s rule: the sphere hits' shading rounds otherwise in the plain
    # version (as on chap12; parting_families), so bit for bit only the
    # walk vs the scan.
    parting_families(st, keys, sph, bg, q_bvh, solids, tex, depth)
    out, q_ms, q_plain_ms, q_err = bounce_vs_plain(
        "rttnw_final", st, keys, sph, bg, q_bvh, solids, card, tex=tex,
        moving=True)
    kwq = dict(k_steps=4, max_depth=depth, t_min=1e-3, moving=True, tex=tex)
    same_bits("bounce_steps rttnw_final, the walk vs the solid scan",
              [mk.bounce_steps(st.clone(), keys, sph, bg, bvh=q_bvh,
                               solids=solids, **kwq)],
              [mk.bounce_steps(st.clone(), keys, sph, bg, bvh=q_bvh,
                               solids=scan, **kwq)])
    q_segments = int((out[15] - st[15]).sum())
    q_bound = rttnw_bound(
        q_segments, q_segments - drawing_segments(st, out), counts, scene,
        tex, 4 * QUEUE_LANES * (16 + 2 + 16) + pack_bytes(
            sph, bg, solids.quad24, solids.box24, solids.med24, tex.atlas))
    print(f"  bounce_steps rttnw_final: {q_segments} segments, bound "
          f"{q_bound[0]:.4f} ms ({q_bound[1]}), kernel {q_ms:.4f} ms  "
          f"[{card}]", flush=True)
    queue = dict(ms=q_ms, plain_ms=q_plain_ms, err=q_err, bound=q_bound)

    st_b, keys_b = st.clone(), keys
    i_plain = []
    for k in range(5):
        if k:
            mk.bounce_steps(st_b, keys_b, sph, bg, k_steps=1, max_depth=depth,
                            t_min=1e-3, moving=True, bvh=q_bvh, solids=solids,
                            tex=tex)
        ikw = dict(t_min=1e-3, time=st_b[6].contiguous(), solids=solids,
                   **medium_inputs(st_b, keys_b))
        o, d = st_b[0:3].contiguous(), st_b[3:6].contiguous()
        got = mk.intersect_only(o, d, sph, bvh=q_bvh, **ikw)
        ref, p_ms = wall_ms(lambda: mk.intersect_only_reference(o, d, sph,
                                                                **ikw))
        i_plain.append(p_ms)
        same_bits(f"intersect_only rttnw_final, {QUEUE_LANES} rays after {k} "
                  f"bounces, kernel vs plain", got, ref)
        same_bits(f"intersect_only rttnw_final after {k} bounces, the walk "
                  f"vs the solid scan", got, mk.intersect_only(
                      o, d, sph, bvh=q_bvh, **dict(ikw, solids=scan)))
    o, d = st[0:3].contiguous(), st[3:6].contiguous()
    ikw = dict(t_min=1e-3, time=st[6].contiguous(), solids=solids,
               **medium_inputs(st, keys))
    i_ms = graph_ms(lambda: mk.intersect_only(o, d, sph, bvh=q_bvh, **ikw),
                    mk.intersect_only)
    i_flops = QUEUE_LANES * (WALK_RAY_FLOPS + counts["depth"][0][1]
                             / counts["depth"][0][0] * NODE_FLOPS
                             + counts["depth"][0][2] / counts["depth"][0][0]
                             * BOX_TEST_FLOPS + counts["depth"][0][3]
                             / counts["depth"][0][0] * slot_flops(True)
                             + scene.n_media_active * MEDIUM_SPHERE_FLOPS)
    i_bound = bound(i_flops, 4 * QUEUE_LANES * (3 + 3 + 1 + 2 + 1 + 3)
                    + pack_bytes(sph, solids.quad24, solids.box24,
                                 solids.med24),
                    THREEFRY_OPS * QUEUE_LANES
                    * ((scene.n_media_active + 1) // 2))
    print(f"  intersect_only rttnw_final, {QUEUE_LANES} camera rays: kernel "
          f"{i_ms:.4f} ms, bound {i_bound[0]:.4f} ms ({i_bound[1]})  "
          f"[{card}]", flush=True)
    inter = dict(ms=i_ms, plain_ms=i_plain[0], err=0.0, bound=i_bound)
    return dict(tile=tile, queue=queue, inter=inter, counts=counts)


def rttnw_gradient_raises(device, card):
    """[F1]: the chain's route of rttnw_final's gradient on the card
    (render_image(differentiable=True)) raises NotImplementedError naming
    its constant media (#9.4: the chain leaves them out, as rrt_tpu's
    does) before any launch; the train kernels take its gradient ([F3]),
    and the chain takes the scene without its media ([F4])."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    scene, cam = tscenes.SCENES["rttnw_final"](64, 43)
    cfg = render.RenderConfig(width=64, height=43, spp=4, max_depth=8)
    wrappers = (mk.render_tiles, mk.bounce_steps, mk.intersect_only,
                mkt.render_tiles_train, mkt.tiles_adjoint, mkv.chain_adjoint)
    before = [w.launches for w in wrappers]
    what = "render_image(differentiable=True)"
    try:
        render.render_image(scene, cam, cfg, 0, differentiable=True,
                            device=device)
    except NotImplementedError as e:
        print(f"  {what} on the card raises: {e}", flush=True)
        check("#9.4" in str(e) and "constant media" in str(e),
              (what, str(e)))
    else:
        check(False, (what, "did not raise"))
    after = [w.launches for w in wrappers]
    print(f"  launches during the raise: {after} (before {before})",
          flush=True)
    check(after == before, ("launches during the raise", before, after))


def rttnw_cli_phase(device, card):
    """[F1]'s main path: python -m rrt_tpu_torch.cli --scene rttnw_final
    -r 400x267 -s 32 on the tile driver (auto), then the queue driver
    (four passes of 8 spp) and the batch driver (4 spp), each held to the
    tile image of its samples (hold_to_tile). Returns the launches."""
    return texture_cli_phase("rttnw_final", device, card, size=RTTNW,
                             min_lit=RTTNW_MIN_LIT)


def box_albedo_scene(scene, slot: int):
    """The scene with box `slot`'s material and texture copied into a
    material and a texture of their own (the same values, so the same
    render): (that scene, the new texture's row), whose tex_color1 row is
    that box's albedo alone."""
    mat = int(scene.box_mat[slot])
    tex = int(scene.mat_tex[mat])
    n_mat, n_tex = scene.mat_type.shape[0], scene.tex_type.shape[0]

    def grow(name, row):
        x = getattr(scene, name)
        return torch.cat([x, x[row:row + 1]])

    fields = {f: grow(f, mat) for f in ("mat_type", "mat_fuzz", "mat_ior")}
    fields.update({f: grow(f, tex) for f in ("tex_type", "tex_color1",
                                             "tex_color2", "tex_scale",
                                             "tex_image")})
    fields["mat_tex"] = torch.cat([scene.mat_tex,
                                   scene.mat_tex.new_tensor([n_tex])])
    box_mat = scene.box_mat.clone()
    box_mat[slot] = n_mat
    return dataclasses.replace(scene, box_mat=box_mat, **fields), n_tex


def rttnw_finite_differences(t, scene, cam, cfg, device):
    """d loss / d (the albedo, red, of the ground box past slot 63 that
    the most camera rays of [F3]'s plain-spp forward hit first, given a
    material of its own: box_albedo_scene) from train_bwd against
    central differences of the train_fwd forward, loss = sum(MIX .
    radiance) in float64, eps 1e-2 (the albedo scales the throughput of
    the paths that bounce off that box and moves no path), the gate
    [6]'s 1e-2. The box's own material renders as before, bit for bit.
    Returns (the box's slot, the relative difference)."""
    from rrt_tpu_torch import diff, render
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    first = t["winners"][0].long()
    past = first[(first >= mk.BOX_CODE + mk.SOLID_CAP)
                 & (first < mk.MEDIUM_CODE)] - mk.BOX_CODE
    check(past.numel() > 0, "[F3] no camera ray hits a box past slot 63")
    slot = int(torch.bincount(past).argmax())
    own, row = box_albedo_scene(scene, slot)
    kw = dict(t["kw"], spp=cfg.spp)
    mix = torch.tensor(MIX, device=device)

    def forward(s):
        packs = [p.detach() for p in render._packs(s, cam, cfg, device)]
        return packs, mkt.render_tiles_train(
            *packs, **dict(kw, solids=mk.pack_solids(s, device)))

    _, (base, _, _, _) = forward(scene)
    packs, (rad, _, lengths, winners) = forward(own)
    same = torch.equal(rad, base)
    out = mkt.tiles_adjoint(*packs, mix.expand_as(rad).contiguous(), lengths,
                            winners, **dict(kw, solids=mk.pack_solids(
                                own, device)))
    gp, _ = diff.field_grads(own, cam, cfg, *out[:3], out[4], device=device)
    eps = 1e-2

    def loss(delta):
        v = own.tex_color1.clone()
        v[row, 0] += delta
        r = forward(diff.combine(own, {"tex_color1": v}))[1][0]
        return (r.double() * mix.double()).sum().item()

    fd = (loss(eps) - loss(-eps)) / (2.0 * eps)
    auto = gp["tex_color1"][row, 0].item()
    rel = abs(auto - fd) / max(abs(fd), 1e-30)
    print(f"  d loss / d (box {slot}'s albedo, red), the box past slot 63 "
          f"the most camera rays hit first ({int((past == slot).sum())} of "
          f"{cfg.width * cfg.height}): train_bwd {auto:.6e}, central "
          f"difference (eps {eps:g}) {fd:.6e}, {rel:.2e} apart (gate "
          f"1e-2); its own material renders bit for bit as before {same}",
          flush=True)
    check(same, "[F3] the box's own material changed the render")
    check(auto != 0.0 and rel < 1e-2, ("[F3] box albedo", slot, auto, fd))
    return slot, rel


def rttnw_train_phase(device, card, resources, counts):
    """[F3] rttnw_final's gradient on the card at [F1]'s 400x267, depth
    50: train_fwd's kWalk instantiation and train_bwd (its loop over the
    400 boxes past the pool) against tile_render and their plain versions
    at RTTNW_TRAIN_PLAIN_SPP (solid_train_vs_plain, gradcheck's rule),
    then at CORNELL_TRAIN_SPP: train_fwd against tile_render bit for
    bit, both timed by CUDA events beside their bounds (rttnw_bound, at
    [F1]'s walk counts), the stored codes' families, the share of
    segments past the pool, the ptxas lines and the blocks an SM; central
    differences of a ground box's albedo past slot 63; then the main
    path with the launch counts set to 0: make_train_step at 8 spp
    (three SGD steps of RTTNW_TRAINED, the loss must fall) and
    make_train_step_chunked (two chunks of 4 spp) within 1e-5 of the
    one-shot loss, with no replay mismatch and no bounce_steps or
    chain_bwd launch; render_image(differentiable=True) must raise
    before any launch. Returns the numbers of the kernels line."""
    from rrt_tpu_torch import diff, geometry, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    w, h, depth = RTTNW["width"], RTTNW["height"], RTTNW["max_depth"]
    cfg = render.RenderConfig(width=w, height=h, spp=CORNELL_TRAIN_SPP,
                              max_depth=depth)
    scene, cam = tscenes.SCENES["rttnw_final"](w, h)
    torch.cuda.reset_peak_memory_stats(device)
    names = {"train_fwd": "train_fwd_kernel (moving, solids, tex, walk)",
             "train_bwd": "train_bwd_kernel (moving, solids, tex)"}
    for k in names.values():
        r = resources.get(k, {})
        print(f"  {k}: {r.get('registers')} registers ({r.get('stack')}, "
              f"{r.get('spill_stores')}, {r.get('spill_loads')})",
              flush=True)
    t = solid_train_vs_plain(
        "rttnw_final", scene, cam,
        dataclasses.replace(cfg, spp=RTTNW_TRAIN_PLAIN_SPP), device, card,
        min_pixels=RTTNW_MIN_AGREE, max_winner_faults=RTTNW_MAX_WINNER_FAULTS,
        exclude_parted=True)
    packs, kw = t["packs"], dict(t["kw"], spp=cfg.spp)
    solids, tex = kw["solids"], kw["tex"]
    fwd = mkt.render_tiles_train(*packs, **kw)
    ref = mk.render_tiles(*packs, bvh=tile_bvh(packs), **kw)
    same = torch.equal(fwd[0], ref[0]) and torch.equal(fwd[1], ref[1])
    fwd_ms = cuda_ms(lambda: mkt.render_tiles_train(*packs, **kw), 3)
    d_rad = torch.ones_like(fwd[0])
    bwd = mkt.tiles_adjoint(*packs, d_rad, *fwd[2:], **kw)
    bwd_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, *fwd[2:],
                                               **kw), 3)
    # Without the winners every segment loops over every slot: what the
    # segments past the pool cost, each.
    scan_ms = cuda_ms(lambda: mkt.tiles_adjoint(*packs, d_rad, fwd[2], None,
                                                **kw), 1)
    segments, paths = int(fwd[1].sum()), w * h * cfg.spp
    # The entries past each pixel's segments are not written.
    cap = mkt.winner_capacity(cfg.spp)
    kept = torch.arange(cap, device=device)[:, None] < fwd[1].long().clamp(
        max=cap)[None, :]
    stored = int(kept.sum())
    codes = fwd[3][kept & (fwd[3] >= 0)]
    fam, idx = mk.decode_winner(codes)
    families = {name: int((fam == f).sum()) for f, name in (
        (geometry.FAM_SPHERE, "sphere"), (geometry.FAM_QUAD, "quad"),
        (geometry.FAM_BOX, "box"), (geometry.FAM_MEDIUM, "medium"))}
    past63 = int(((fam == geometry.FAM_BOX) & (idx >= mk.SOLID_CAP)).sum())
    past_pool = (segments - stored) / segments
    all_packs = pack_bytes(*packs, solids.quad24, solids.box24, solids.med24,
                           tex.atlas)
    fwd_bound = rttnw_bound(segments, paths, counts, scene, tex,
                            all_packs + w * h * 16 + paths * 33)
    # The backward reads the packs and writes their cotangents (the
    # atlas's among them), reads d_rad, the lengths and the stored
    # winners.
    bwd_bound = rttnw_bwd_bound(segments, stored, paths, families, counts,
                                scene, tex, 2 * all_packs + w * h * 12
                                + paths + 2 * stored)
    blocks = {k: mkt.train_blocks(k, packs[0], moving=True, solids=solids,
                                  tex=tex) for k in mkt.TRAIN_KERNELS}
    print(f"  rttnw_final {w}x{h} {cfg.spp}spp d{depth}: train_fwd == "
          f"tile_render {same}; {residual_line(fwd[1], fwd[2], cfg.spp)}; "
          f"stored codes by family {families}, {past63} of them a box past "
          f"slot {mk.SOLID_CAP - 1}; max code {int(codes.max())}",
          flush=True)
    for k, b in blocks.items():
        print(f"  {k} blocks an SM: {b['blocks']}, {b['smem_bytes']} B of "
              f"shared memory", flush=True)
    print(f"  rttnw_final {w}x{h} {cfg.spp}spp d{depth}: train_fwd "
          f"{fwd_ms:.3f} ms (bound {fwd_bound[0]:.4f}, {fwd_bound[1]}), "
          f"train_bwd {bwd_ms:.3f} ms (bound {bwd_bound[0]:.4f}, "
          f"{bwd_bound[1]}), {scan_ms:.3f} ms without the winners (every "
          f"segment loops over {packs[0].shape[1]} sphere slots, "
          f"{solids.n_quads + solids.n_boxes} quads and boxes, "
          f"{solids.n_media} media); replay mismatches {int(bwd[3])}; "
          f"{segments} segments  [{card}]", flush=True)
    check(same, "[F3] train_fwd vs tile_render at 8 spp")
    check(int(bwd[3]) == 0, ("[F3] replay_mismatches", int(bwd[3])))
    check(past63 > 0, "[F3] no stored box past slot 63")
    fd_slot, fd_rel = rttnw_finite_differences(t, scene, cam, cfg, device)
    peak_memory("[F3] kernels vs plain versions", device, card)

    # The main path, launches counted from 0.
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    n_tex = scene.tex_color1.shape[0]
    start = diff.combine(scene, {"tex_color1": scene.tex_color1
                                 * torch.linspace(0.8, 1.1, n_tex)[:, None]})
    step = diff.make_train_step(cfg, device=device)
    chunked = diff.make_train_step_chunked(cfg, spp_chunk=4, device=device)
    chunked(start, cam, target, 0)  # warm-up
    counters = (mkt.render_tiles_train, mkt.tiles_adjoint, mk.bounce_steps,
                mkv.chain_adjoint, mk.render_tiles)
    for c in counters:
        c.launches = 0
    mkt.tiles_adjoint.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms = [], []
    s_scene, s_cam = start, cam
    with chain_events() as (fwd_log, bwd_log):
        for i in range(3):
            fwd_log.clear()
            bwd_log.clear()
            (s_scene, s_cam, loss), ms = wall_ms(
                lambda: step(s_scene, s_cam, target, 0))
            s_scene = diff.combine(start, {k: getattr(s_scene, k)
                                           for k in RTTNW_TRAINED})
            s_cam = cam
            losses.append(loss.item())
            step_ms.append((events_ms(fwd_log), events_ms(bwd_log), ms))
            print(f"  make_train_step {i}: loss {losses[-1]:.8e}, train_fwd "
                  f"{step_ms[-1][0]:.3f} ms, train_bwd {step_ms[-1][1]:.3f} "
                  f"ms, step {ms:.2f} ms  [{card}]", flush=True)
        (_, _, c_loss), c_wall = wall_ms(lambda: chunked(start, cam, target,
                                                         0))
    print(f"  make_train_step_chunked (2 chunks of 4 spp): loss "
          f"{c_loss.item():.8e} (one-shot's first {losses[0]:.8e}), step "
          f"{c_wall:.2f} ms  [{card}]", flush=True)
    launches = [c.launches for c in counters]
    mism = int(mkt.tiles_adjoint.replay_mismatches)
    raised = False
    try:
        render.render_image(start, cam, cfg, 0, differentiable=True,
                            device=device)
    except NotImplementedError as e:
        raised = "#9.4" in str(e)
        print(f"  render_image(differentiable=True) raises: {e}", flush=True)
    after = [c.launches for c in counters]
    print(f"  launches train_fwd {launches[0]}, train_bwd {launches[1]}, "
          f"bounce_steps {launches[2]}, chain_bwd {launches[3]}, "
          f"tile_render {launches[4]}; after the raise {after}; "
          f"replay_mismatches {mism} (gate 0); losses {losses} (must "
          f"fall)  [{card}]", flush=True)
    peak_memory("[F3] main path", device, card)
    check(launches[0] >= 5 and launches[1] >= 5 and launches[2] == 0
          and launches[3] == 0, ("[F3] launches", launches))
    check(raised and after == launches, ("[F3] the chain's raise", after))
    check(mism == 0, ("[F3] replay_mismatches", mism))
    check(all(math.isfinite(x) for x in losses)
          and losses[2] < losses[1] < losses[0], ("[F3] the loss", losses))
    check(abs(c_loss.item() - losses[0]) <= 1e-5 * losses[0],
          ("[F3] chunked vs one-shot", c_loss.item(), losses[0]))
    main = [sum(m_[j] for m_ in step_ms) / len(step_ms) for j in (0, 1)]

    def numbers(ms, plain_ms, err, bnd, n_launch, kernel, main_ms):
        return dict(rttnw_ms=ms, rttnw_plain_ms=plain_ms,
                    rttnw_bound_ms=bnd[0], rttnw_bound_by=bnd[1],
                    rttnw_max_abs_err=err, rttnw_launches=n_launch,
                    rttnw_registers=resources.get(names[kernel]),
                    rttnw_main_ms=main_ms,
                    rttnw_blocks=blocks[kernel]["blocks"],
                    rttnw_past_pool=past_pool,
                    **({"rttnw_scan_ms": scan_ms}
                       if kernel == "train_bwd" else {}))

    return dict(
        fd=(fd_slot, fd_rel),
        train_fwd=numbers(fwd_ms, t["fwd_plain_ms"], t["fwd_err"], fwd_bound,
                          launches[0], "train_fwd", main[0]),
        train_bwd=numbers(bwd_ms, t["bwd_plain_ms"], t["bwd_err"], bwd_bound,
                          launches[1], "train_bwd", main[1]))


def many_solids_phase(device, card):
    """[F2] scenes.book2.many_solids_scene (81 boxes rotated about Y, 82
    quads, spheres, under the sky) at MANY's size, its moving and marble
    variants too: the three forward kernels' walks over both families'
    trees against the solid scan (accel.solid_scan) bit for bit
    (tile_render at 4 spp, bounce_steps 4 steps and intersect_only on
    every pixel's camera ray and after 1-3 bounces), intersect_only
    against its plain version by [Q1]'s rule."""
    from rrt_tpu_torch import accel, render
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.scenes import book2
    w, h = MANY["width"], MANY["height"]
    depth = MANY["max_depth"]
    for moving, marble in ((False, False), (True, True)):
        scene, cam = book2.many_solids_scene(w, h, moving=moving,
                                             marble=marble)
        cfg = render.RenderConfig(width=w, height=h, spp=MANY["spp"],
                                  max_depth=depth)
        *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
        solids = mk.pack_solids(scene, device)
        tex = mk.pack_textures(scene, device)
        scan = dataclasses.replace(solids,
                                   tree=accel.solid_scan(solids.tree))
        what = f"many_solids (moving {moving}, marble {marble})"
        print(f"  {what}: {solids.n_quads} quads ({solids.tree.quad.n_nodes}"
              f" nodes), {solids.n_boxes} boxes ({solids.tree.box.n_nodes} "
              f"nodes)", flush=True)
        kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h,
                  spp=MANY["spp"], max_depth=depth, t_min=1e-3, moving=moving,
                  tex=tex)
        same_bits(f"tile_render {what} {w}x{h} {MANY['spp']}spp d{depth}, "
                  f"the walk vs the solid scan",
                  mk.render_tiles(*packs, bvh=bvh, solids=solids, **kw),
                  mk.render_tiles(*packs, bvh=bvh, solids=scan, **kw))
        st, keys, sph, bg = lane_state(scene, cam, w, h, w * h, device)
        q_bvh = render.pack_scene(scene, device, render._shutter(cam))["bvh"]
        kwq = dict(k_steps=1, max_depth=depth, t_min=1e-3, moving=moving,
                   tex=tex)
        for k in range(4):
            o, d = st[0:3].contiguous(), st[3:6].contiguous()
            ikw = dict(t_min=1e-3, time=st[6].contiguous() if moving
                       else None)
            got = mk.intersect_only(o, d, sph, bvh=q_bvh, solids=solids,
                                    **ikw)
            same_bits(f"intersect_only {what} after {k} bounces, the walk "
                      f"vs the solid scan", got, mk.intersect_only(
                          o, d, sph, bvh=q_bvh, solids=scan, **ikw))
            intersect_vs_plain(f"{what} after {k} bounces", o, d,
                               ikw["time"], sph, moving, q_bvh, solids)
            walked = mk.bounce_steps(st.clone(), keys, sph, bg, bvh=q_bvh,
                                     solids=solids, **kwq)
            same_bits(f"bounce_steps {what} step {k + 1}, the walk vs the "
                      f"solid scan", [walked],
                      [mk.bounce_steps(st.clone(), keys, sph, bg, bvh=q_bvh,
                                       solids=scan, **kwq)])
            st = walked


# [F4]: chain_bwd's kWalk instantiations (its replay walks the solid
# trees past SOLID_CAP, as bounce_steps' kWalk does) on many_solids_scene
# at MANY's size and on rttnw_final without its media (RTTNW_NO_MEDIA:
# its constant media stay off the chain, #9.4), whose gradient's main
# path at RTTNW_DIFF is render_image(differentiable=True).
RTTNW_NO_MEDIA = frozenset({"media"})
RTTNW_DIFF = dict(width=400, height=267, spp=4, max_depth=50)
# [F4]: the plain chain runs on every RTTNW_CHAIN_STRIDE-th lane of [C2]'s
# chains of rttnw_final (the plain replay scans its 1,407 quads, boxes
# and spheres a segment); the kernel is timed on all of them.
RTTNW_CHAIN_STRIDE = 16
# [F4]: the share of those lanes whose forwards (bounce_steps and its
# plain version) must agree: the plain version's sphere shading rounds
# otherwise on rttnw_final (Queue C; [F1]'s parting_families), more
# often than on chap12's ground ([C1]'s MIN_FORWARD_AGREE). Worst
# reading on an H100 80GB HBM3 at 700 W: 0.99866 on chain 1 at this
# stride (a parted share of 1.34e-3; chains 2 and 3 0.99969 and
# 0.99957; every 8th lane 0.99893); the gate allows 3e-3, 2.2 times it.
RTTNW_CHAIN_MIN_AGREE = 0.997
# [F4]: the differentiable image against the forward batch driver's
# image of the same seed (tests/test_torch_chain.py's
# test_differentiable_image_equals_forward, which holds on the CPU within
# 2e-4 with equal traced counts): on the card the chain shades in
# bounce_steps and the forward batch driver eagerly, whose sphere
# shading rounds otherwise on rttnw_final (Queue C), so a path may part:
# the share of pixels within 2e-4 and the traced counts' relative gap.
# On an H100 80GB HBM3 at 700 W, over the whole image, 144 of 106,800
# pixels parted (0.998652 within 2e-4; the largest |delta| 1.75, a path
# that found the light in one version) and the traced counts 1,237,125
# and 1,236,653 (3.8e-4 apart); the gates allow 3e-3 of pixels (2.2
# times) and 1e-3 (2.6 times). [F4] holds the first tile to them.
RTTNW_DIFF_MIN_CLOSE = 0.997
RTTNW_DIFF_TRACED_GAP = 1e-3
# [F4]: a box's albedo past slot 63: the chain's gradient against central
# differences of the same differentiable render's loss, [F3]'s gate (the
# first reading 2.3e-4).
RTTNW_FD_GATE = 1e-2


def walk_chain_many_solids(device, card):
    """[F4] chain_bwd's four kWalk variants on many_solids_scene at MANY's
    size (static, moving, marble, both; every pixel's camera ray after
    one bounce step, a chain of 4) against chain_adjoint_reference by
    chain_vs_plain's rule ([C1]'s), and against the same kernel walking
    the solid scan (accel.solid_scan). Returns {variant: numbers}."""
    from rrt_tpu_torch import accel, render
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.scenes import book2
    w, h = MANY["width"], MANY["height"]
    out = {}
    for moving, marble in ((False, False), (True, False), (False, True),
                           (True, True)):
        scene, cam = book2.many_solids_scene(w, h, moving=moving,
                                             marble=marble)
        cfg = render.RenderConfig(width=w, height=h, spp=1,
                                  max_depth=MANY["max_depth"])
        st, keys, sph, bg = lane_state(scene, cam, w, h, w * h, device)
        packed = render.pack_scene(scene, device, render._shutter(cam))
        solids, tex, bvh = packed["solids"], packed["tex"], packed["bvh"]
        scan = dataclasses.replace(solids, tree=accel.solid_scan(solids.tree))
        mk.bounce_steps(st, keys, sph, bg, k_steps=1,
                        max_depth=MANY["max_depth"], t_min=1e-3,
                        moving=moving, bvh=bvh, solids=solids, tex=tex)
        tag = "solids" + (", moving" if moving else "") + (
            ", tex" if marble else "")
        _, numbers = chain_vs_plain(
            f"many_solids ({tag}, walk) after 1 bounce", st, keys, sph, bg,
            bvh, 4, scene, cam, cfg, device, card, solids=solids, tex=tex,
            scan=scan)
        out[(moving, marble)] = numbers
    return out


def rttnw_chain_rays(device):
    """[C2]'s CHAIN_LANES lanes on rttnw_final without its media at
    RTTNW_DIFF's size: lane i at pixel i mod (w h), sample i div (w h), so
    every pixel's first samples. Returns (scene, cam, cfg, px, py, keys)
    as chain_rays does."""
    from rrt_tpu_torch import render, rng
    from rrt_tpu_torch.scenes import book2
    w, h = RTTNW_DIFF["width"], RTTNW_DIFF["height"]
    scene, cam = book2.rttnw_final_scene(w, h, ablate=RTTNW_NO_MEDIA)
    cfg = render.RenderConfig(width=w, height=h, spp=1,
                              max_depth=RTTNW_DIFF["max_depth"])
    ids = torch.arange(CHAIN_LANES, device=device)
    px, py = ids % w, (ids // w) % h
    keys = rng.sample_keys(rng.key_words(0), py * w + px, ids // (w * h))
    return scene, cam, cfg, px, py, keys


def walk_chain_bound(c1, counts, scene, solids, tex):
    """chain_bwd's least time over [F4]'s chains of rttnw_final without
    media, (ms, by), as chain_bound counts [C1]'s: each replayed segment's
    walks at counts' tests a segment (rttnw_flops) and ADJOINT_FLOPS, the
    texture of each scattering segment (rttnw_bound's IMAGE_FLOPS), the
    draws of the segments that scatter; the lanes' bytes and the packs
    read and their cotangents written, each chain. The per-block partials
    stay out, as in chain_bound."""
    segments = sum(c["segments"] for c in c1)
    drawing = sum(c["drawing"] for c in c1)
    packs = pack_bytes(c1[0]["sph"], solids.quad24, solids.box24)
    lane_bytes = sum(4 * c["q"] * (16 + 2 + 16 + 1 + 16) for c in c1) \
        + len(c1) * (2 * packs + pack_bytes(tex.atlas))
    flops = (rttnw_flops(segments, counts, scene.has_moving, 0)
             + segments * ADJOINT_FLOPS + drawing * IMAGE_FLOPS)
    return bound(flops, lane_bytes, THREEFRY_OPS * THREEFRY_PER_HIT * drawing)


def walk_chain_rttnw(device, card):
    """[F4] chain_bwd's (moving, solids, tex, walk) variant on [C2]'s three
    chains of rttnw_final without its media (rttnw_chain_rays, chains 4,
    4, 43, each chain's input the kernels' forward of the one before,
    compacted): each timed by graph replay on all its lanes, and held to
    its plain version by chain_vs_plain on every RTTNW_CHAIN_STRIDE-th
    lane (forwards agreeing on RTTNW_CHAIN_MIN_AGREE, the solid scan's
    cotangents as the walk's); the walks' tests a segment
    (solid_walk_counts) and the bound (walk_chain_bound). Returns the
    kernels line's numbers."""
    from rrt_tpu_torch import accel, render, rng
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_vjp as mkv
    scene, cam, cfg, px, py, keys = rttnw_chain_rays(device)
    sph = mk.pack_spheres_full(scene).to(device)
    bg = mk.pack_bg(scene).to(device)
    solids = mk.pack_solids(scene, device)
    tex = mk.pack_textures(scene, device)
    scan = dataclasses.replace(solids, tree=accel.solid_scan(solids.tree))
    n = px.shape[0]
    o, d, tm = render.generate_rays(cam.to(device), px, py, cfg.width,
                                    cfg.height, keys)
    bvh = render.chain_bvh(sph, tm, scene.has_moving)
    one = torch.ones((n,), device=device)
    zero = torch.zeros((n,), device=device)
    st = mk.pack_state(o, d, tm, one.expand(3, n), zero.expand(3, n), zero,
                       one, zero)
    kbits, lane = rng.u32_bits(keys), torch.arange(n, device=device)
    counts = solid_walk_counts(scene, cam, st, kbits, sph, bg, bvh, solids,
                               tex, cfg.max_depth)
    schedule = render._fused_schedule(cfg.max_depth)
    kw = dict(max_depth=cfg.max_depth, t_min=1e-3, moving=scene.has_moving,
              solids=solids, tex=tex)
    c1 = []
    for j, k_steps in enumerate(schedule):
        out = mk.bounce_steps(st.clone(), kbits, sph, bg, bvh=bvh,
                              k_steps=k_steps, **kw)
        gen = torch.Generator().manual_seed(k_steps)
        d_out = torch.randn(tuple(st.shape), generator=gen).to(device)
        ob = out[mk.ROW_BOUNCE].clone()
        ms = graph_ms(lambda: mkv.chain_adjoint(
            st, kbits, sph, bg, d_out, ob, bvh=bvh, k_steps=k_steps, **kw),
            mkv.chain_adjoint)
        sub = slice(None, None, RTTNW_CHAIN_STRIDE)
        _, numbers = chain_vs_plain(
            f"rttnw_final without media, chain {j + 1} of {schedule}, every "
            f"{RTTNW_CHAIN_STRIDE}th lane", st[:, sub].contiguous(),
            kbits[:, sub].contiguous(), sph, bg, bvh, k_steps, scene, cam,
            cfg, device, card, solids=solids, tex=tex,
            min_agree=RTTNW_CHAIN_MIN_AGREE, scan=scan)
        c1.append(dict(numbers, ms=ms, q=n, sph=sph,
                       segments=int((out[mk.ROW_TRACED]
                                     - st[mk.ROW_TRACED]).sum()),
                       drawing=drawing_segments(st, out),
                       sub_ms=numbers["ms"], sub_q=numbers["q"]))
        print(f"  chain {j + 1}: chain_bwd on all {n} lanes {ms:.4f} ms, "
              f"{c1[-1]['segments']} replayed segments  [{card}]",
              flush=True)
        if j < len(schedule) - 1:
            st, kbits, lane = render._compact_lanes(out, kbits, lane)
    b = walk_chain_bound(c1, counts, scene, solids, tex)
    ms = sum(c["ms"] for c in c1)
    part = sum(2 * 4 * -(-c["q"] // 256)
               * (mkv.SLOT_COLS * (sph.shape[1] + solids.n_quads
                                   + solids.n_boxes) + 8) for c in c1)
    print(f"  rttnw_final without media, the three chains: chain_bwd "
          f"{ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}; the walks at "
          f"{counts['nodes']:.3f} node, {counts['solids']:.3f} quad and box "
          f"and {counts['spheres']:.3f} sphere tests a segment), plain "
          f"{sum(c['plain_ms'] for c in c1):.1f} ms on every "
          f"{RTTNW_CHAIN_STRIDE}th lane; the kernel's partials "
          f"{part / 1e6:.1f} MB (outside the bound)  [{card}]", flush=True)
    return dict(ms=ms, plain_ms=sum(c["plain_ms"] for c in c1),
                err=max(c["err"] for c in c1), bound=b, counts=counts,
                partial_mb=part / 1e6)


def walk_chain_main_path(device, card):
    """[F4] the main path: render_image(differentiable=True) on rttnw_final
    without its media at RTTNW_DIFF (one pass of BATCH_SPP samples, 7
    tiles), the gradient of an L2 loss against the tile driver's image at
    seed 1, the launch counts set to 0 just before: bounce_steps and
    chain_bwd launched, the train kernels not, no replay mismatch; on the
    first tile the image is the chain's render of that tile bit for bit,
    and the forward batch driver's of the same seed on
    RTTNW_DIFF_MIN_CLOSE of its pixels, the traced counts within
    RTTNW_DIFF_TRACED_GAP; the box fields past
    slot 63 finite, some not 0; the albedo of the box past slot 63 that
    the most camera rays hit first (given a material of its own:
    box_albedo_scene) against central differences of the same render's
    loss under no_grad (the albedo moves no path), RTTNW_FD_GATE. Then one
    render_image_diff at depth 80 at 64x43, 2 spp: the chain's route, one
    fallback line, chain_bwd launched. Returns (launches, numbers)."""
    import logging
    from rrt_tpu_torch import diff, geometry, render
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    from rrt_tpu_torch.scenes import book2
    w, h = RTTNW_DIFF["width"], RTTNW_DIFF["height"]
    cfg = render.RenderConfig(**RTTNW_DIFF, samples_per_pass=BATCH_SPP)
    scene, cam = book2.rttnw_final_scene(w, h, ablate=RTTNW_NO_MEDIA)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    counters = (mk.bounce_steps, mkv.chain_adjoint, mkt.render_tiles_train,
                mkt.tiles_adjoint, mk.intersect_only, mk.render_tiles)
    for c in counters:
        c.launches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    torch.cuda.reset_peak_memory_stats(device)
    (img, n, loss, gp, gc), ms = wall_ms(lambda: batch_loss_and_grads(
        cfg, scene, cam, target, 0, device))
    launches = [c.launches for c in counters]
    mism = int(mkv.chain_adjoint.replay_mismatches)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"  [F4] main path: render_image(differentiable=True) "
          f"rttnw_final without media {w}x{h} {cfg.spp}spp "
          f"d{cfg.max_depth}: loss {loss.item():.6e}, {n} traced segments, "
          f"forward and backward {ms / 1e3:.3f} s wall, peak memory "
          f"{peak:.3f} GB; launches bounce_steps {launches[0]}, chain_bwd "
          f"{launches[1]}, train_fwd {launches[2]}, train_bwd {launches[3]}, "
          f"intersect_only {launches[4]}, tile_render {launches[5]}; "
          f"replay_mismatches {mism}  [{card}]", flush=True)
    check(launches[0] >= 3 and launches[1] >= 3 and launches[2] == 0
          and launches[3] == 0 and mism == 0,
          ("[F4] launches", launches, mism))
    for key, g in list(gp.items()) + [("camera", g) for g in gc]:
        check(bool(torch.isfinite(g).all()), ("[F4] non-finite", key))
    # The box fields past slot 63 (their albedos are their materials').
    past = {k: gp[k][mk.SOLID_CAP:] for k in ("box_center", "box_half")}
    nonzero = {k: int((v.abs().amax(dim=1) > 0).sum()) for k, v in
               past.items()}
    print(f"  [F4] boxes past slot 63 with a gradient: {nonzero} of "
          f"{scene.n_boxes_active - mk.SOLID_CAP}", flush=True)
    check(sum(nonzero.values()) > 0, ("[F4] box fields past slot 63", nonzero))

    # The first tile (the forward batch driver's eager shading is what
    # costs): the main path's pixels there are the chain's render of the
    # tile bit for bit, which is held to the forward's.
    px, py = render._tile_coords(cfg, device)[0]
    s_dev, c_dev = scene.to(device), cam.to(device)
    with torch.no_grad():
        packed = render.pack_scene(s_dev, device, render._shutter(c_dev))
        tiles = [render.render_tile(s_dev, c_dev, px, py, cfg, 0, 0, 1,
                                    differentiable=d, packed=packed)
                 for d in (True, False)]
    (chain, n_chain), (fwd, n_fwd) = [(r / cfg.spp, int(t)) for r, t in tiles]
    same = torch.equal(img.reshape(-1, 3)[py * w + px], chain)
    delta = (chain - fwd).abs().amax(dim=1)
    err = delta.max().item()
    close = (delta <= 2e-4).float().mean().item()
    gap = abs(n_chain - n_fwd) / n_fwd
    print(f"  [F4] the differentiable render's first tile ({px.numel()} "
          f"pixels; the main path's image there bit for bit {same}) vs the "
          f"forward batch driver's: {close:.6f} of pixels within 2e-4 (gate "
          f"{RTTNW_DIFF_MIN_CLOSE}), {int((delta > 2e-4).sum())} not; max "
          f"pixel |delta| {err:.3e}; traced {n_chain} vs {n_fwd} ({gap:.2e} "
          f"apart, gate {RTTNW_DIFF_TRACED_GAP:g})", flush=True)
    check(same and close >= RTTNW_DIFF_MIN_CLOSE
          and gap <= RTTNW_DIFF_TRACED_GAP,
          ("[F4] image vs forward", same, close, err, n_chain, n_fwd))

    # The box past slot 63 that the most camera rays hit first.
    st, _, sph, _ = lane_state(scene, cam, w, h, w * h, device)
    packed = render.pack_scene(scene, device, render._shutter(cam))
    _, fam, idx = mk.intersect_only(
        st[0:3].contiguous(), st[3:6].contiguous(), sph, t_min=1e-3,
        time=st[6].contiguous(), bvh=packed["bvh"], solids=packed["solids"])
    first = idx[(fam == geometry.FAM_BOX) & (idx >= mk.SOLID_CAP)]
    check(first.numel() > 0, "[F4] no camera ray hits a box past slot 63")
    slot = int(torch.bincount(first).argmax())
    own, row = box_albedo_scene(scene, slot)
    _, _, _, gp_own, _ = batch_loss_and_grads(cfg, own, cam, target, 0,
                                              device)
    eps = 1e-2

    def fd_loss(delta):
        v = own.tex_color1.clone()
        v[row, 0] += delta
        with torch.no_grad():
            image, _ = render.render_image(
                diff.combine(own, {"tex_color1": v}), cam, cfg, 0,
                differentiable=True, device=device)
        return torch.mean((image.double() - target.double()) ** 2).item()

    fd = (fd_loss(eps) - fd_loss(-eps)) / (2.0 * eps)
    auto = gp_own["tex_color1"][row, 0].item()
    rel = abs(auto - fd) / max(abs(fd), 1e-30)
    print(f"  [F4] d loss / d (box {slot}'s albedo, red): chain_bwd "
          f"{auto:.6e}, central difference (eps {eps:g}) of the "
          f"differentiable render's forward {fd:.6e}, {rel:.2e} apart (gate "
          f"{RTTNW_FD_GATE:g})", flush=True)
    check(auto != 0.0 and rel < RTTNW_FD_GATE, ("[F4] box albedo", slot,
                                                auto, fd))

    deep = render.RenderConfig(width=64, height=43, spp=2, max_depth=80,
                               samples_per_pass=2)
    small, small_cam = book2.rttnw_final_scene(64, 43, ablate=RTTNW_NO_MEDIA)
    lines = []

    class Catch(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Catch()
    logger = logging.getLogger("rrt_tpu_torch.render")
    logger.addHandler(handler)
    render._warned_fallbacks.clear()
    before = [c.launches for c in counters]
    try:
        scene_d, params, camera = diff._leaves(small, small_cam, device)
        d_img, _ = render.render_image_diff(scene_d, camera, deep, 0,
                                            device=device)
        d_img.sum().backward()
    finally:
        logger.removeHandler(handler)
    after = [c.launches for c in counters]
    fallback = [m for m in lines if "batch driver's differentiable" in m]
    print(f"  [F4] render_image_diff at depth 80 (64x43, 2 spp): "
          f"{len(fallback)} fallback line ({fallback[:1]}), launches "
          f"{before} -> {after}", flush=True)
    check(len(fallback) == 1 and after[1] > before[1]
          and after[2:4] == before[2:4]
          and bool(torch.isfinite(d_img).all()),
          ("[F4] render_image_diff at depth 80", fallback, before, after))
    return launches, dict(fd=(slot, rel), image_err=err, image_close=close,
                          traced_gap=gap,
                          past_cap=nonzero, wall_ms=ms)


def rr_tile_phase(name, w, h, device, card, counts=None):
    """[R1] tile_render with rr_depth RR_DEPTH on `name` at w x h, MAIN's
    spp and depth: its ms beside rr_depth 0's (CUDA events, in turns),
    both traced totals and the image means' relative difference
    (RR_MEAN_GATE); then, at RR_PLAIN_SPP, against its plain version by
    the slice rule (tests/test_torch_slice.py: per-pixel max |delta| <
    1e-3 on >= 98.5% of pixels, traced totals within 1%). counts: [3]'s
    walk_counts on chap12 for the walk's bound (tile_bounds: a lower
    bound, which leaves out the coin's Threefry call a scattering segment
    past RR_DEPTH, as it leaves out the shading), or None. Returns the
    kernels line's numbers."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    spp, depth = MAIN["spp"], MAIN["max_depth"]
    scene, cam = tscenes.SCENES[name](w, h)
    cfg = render.RenderConfig(width=w, height=h, spp=spp, max_depth=depth)
    *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
    kw = dict(seed_words=(0, 0), sample_lo=0, width=w, height=h, spp=spp,
              max_depth=depth, t_min=1e-3, moving=scene.has_moving,
              solids=mk.pack_solids(scene, device),
              tex=mk.pack_textures(scene, device))

    def run(rr, **over):
        return mk.render_tiles(*packs, bvh=bvh, **dict(kw, rr_depth=rr,
                                                       **over))

    outs = {rr: run(rr) for rr in (0, RR_DEPTH)}  # and the warm-ups
    times = {rr: [] for rr in outs}
    for _ in range(3):
        for rr in times:
            times[rr].append(cuda_ms(lambda: run(rr), 1))
    ms = {rr: sorted(t)[1] for rr, t in times.items()}
    traced = {rr: int(o[1].sum()) for rr, o in outs.items()}
    means = {rr: o[0].mean(dim=0) / spp for rr, o in outs.items()}
    rel = ((means[RR_DEPTH] - means[0]).abs() / means[0]).max().item()
    print(f"  tile_render {name} {w}x{h} {spp}spp d{depth}: rr_depth "
          f"{RR_DEPTH} {ms[RR_DEPTH]:.3f} ms (in turns {times[RR_DEPTH]}), "
          f"{traced[RR_DEPTH]} traced; rr_depth 0 {ms[0]:.3f} ms "
          f"({times[0]}), {traced[0]} traced; wall {ms[RR_DEPTH] / ms[0]:.4f}"
          f" and traced {traced[RR_DEPTH] / traced[0]:.4f} of rr_depth 0's; "
          f"image means {means[RR_DEPTH].tolist()} vs {means[0].tolist()}, "
          f"{rel:.4e} apart (gate {RR_MEAN_GATE:g})  [{card}]", flush=True)
    small = dict(kw, spp=RR_PLAIN_SPP, rr_depth=RR_DEPTH)
    k_out = mk.render_tiles(*packs, bvh=bvh, **small)
    ref, plain_ms = wall_ms(lambda: mk.render_tiles_reference(*packs,
                                                              **small))
    err = (k_out[0] - ref[0]).abs().max(dim=1).values / RR_PLAIN_SPP
    close = (err < 1e-3).float().mean().item()
    nt, nr = int(k_out[1].sum()), int(ref[1].sum())
    print(f"  vs the plain version at {RR_PLAIN_SPP} spp: {close:.5f} of "
          f"pixels within 1e-3 (rule 0.985), traced {nt} vs {nr} "
          f"({abs(nt - nr) / nr:.4%}, rule 1%), max pixel |delta| "
          f"{err.max().item():.4f}; plain {plain_ms:.1f} ms  [{card}]",
          flush=True)
    check(traced[RR_DEPTH] < traced[0], ("[R1] roulette", name, traced))
    check(rel < RR_MEAN_GATE, ("[R1] image mean", name, rel))
    check(close >= 0.985 and abs(nt - nr) / nr < 1e-2,
          ("[R1] tile_render vs plain", name, close, nt, nr))
    bnd = None if counts is None else tile_bounds(
        traced[RR_DEPTH], w * h * spp, packs[0].shape[1], counts,
        scene.has_moving)[0]
    if bnd is not None:
        print(f"  bound at rr_depth {RR_DEPTH}: {bnd[0]:.4f} ms ({bnd[1]}; "
              f"{traced[RR_DEPTH]} segments at the walk's tests a segment)",
              flush=True)
    return dict(ms=ms[RR_DEPTH], off_ms=ms[0], plain_ms=plain_ms,
                err=err.max().item(), traced=traced[RR_DEPTH],
                off_traced=traced[0], mean_rel=rel, bound=bnd)


def rr_bounce_phase(name, w, h, device, card, counts=None):
    """[R1] bounce_steps with rr_depth RR_DEPTH against its plain version
    by [Q1]'s rule, on QUEUE_LANES lanes of `name`'s camera rays after
    RR_DEPTH bounce steps, so that the roulette acts at each of the 4
    steps; its ms beside rr_depth 0's from the same state (CUDA events,
    in turns). counts: [Q1]'s walk_counts for the bound (chap12, whose
    sky shows every miss to hits()), or None."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    scene, cam = tscenes.SCENES[name](w, h)
    st, keys, sph, bg = lane_state(scene, cam, w, h, QUEUE_LANES, device)
    packed = render.pack_scene(scene, device, render._shutter(cam))
    bvh = packed["bvh"]
    kw = dict(max_depth=MAIN["max_depth"], t_min=1e-3,
              moving=scene.has_moving, solids=packed["solids"],
              tex=packed["tex"])
    mk.bounce_steps(st, keys, sph, bg, bvh=bvh, k_steps=RR_DEPTH, **kw)
    step = dict(kw, k_steps=4)
    outs = {rr: mk.bounce_steps(st.clone(), keys, sph, bg, bvh=bvh,
                                rr_depth=rr, **step) for rr in (0, RR_DEPTH)}
    out = outs[RR_DEPTH]
    ref, plain_ms = wall_ms(lambda: mk.bounce_steps_reference(
        st.clone(), keys, sph, bg, rr_depth=RR_DEPTH, **step))
    agree = (out[14] > 0.5) == (ref[14] > 0.5)
    frac = agree.float().mean().item()
    equal = (torch.equal(out[13][agree], ref[13][agree])
             and torch.equal(out[15][agree], ref[15][agree]))
    err = (out[7:13] - ref[7:13]).abs().amax(dim=0)[agree]
    close = (err < 1e-3).float().mean().item()
    work, logs = torch.empty_like(st), {rr: [] for rr in outs}
    for _ in range(5):  # in place: each launch starts from the same state
        for rr, log in logs.items():
            work.copy_(st)
            timed(mk.bounce_steps, log)(work, keys, sph, bg, bvh=bvh,
                                        rr_depth=rr, **step)
    torch.cuda.synchronize()
    ms = {rr: events_ms(log) / len(log) for rr, log in logs.items()}
    segments = {rr: int((o[15] - st[15]).sum()) for rr, o in outs.items()}
    live = int((st[14] > 0.5).sum())
    print(f"  bounce_steps {name}, {QUEUE_LANES} lanes ({live} alive after "
          f"{RR_DEPTH} steps), 4 steps at rr_depth {RR_DEPTH}: alive agrees "
          f"on {frac:.5f} of lanes, counts equal there {equal}, {close:.5f} "
          f"within 1e-3 (max {err.max().item():.3e}); {segments[RR_DEPTH]} "
          f"segments, kernel {ms[RR_DEPTH]:.4f} ms; rr_depth 0: "
          f"{segments[0]} segments, {ms[0]:.4f} ms; plain {plain_ms:.1f} ms"
          f"  [{card}]", flush=True)
    check(frac >= 0.999 and equal and close >= 0.995,
          ("[R1] bounce_steps", name, frac, equal, close))
    check(segments[RR_DEPTH] < segments[0], ("[R1] roulette", name, segments))
    bnd = None
    if counts is not None:
        s_bytes = 4 * (QUEUE_LANES * (16 + 2 + 16) + 24 * sph.shape[1] + 8)
        bnd = bound(walk_flops(segments[RR_DEPTH], counts, scene.has_moving),
                    s_bytes, THREEFRY_OPS * THREEFRY_PER_HIT * hits(st, out))
        print(f"  bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return dict(ms=ms[RR_DEPTH], off_ms=ms[0], plain_ms=plain_ms,
                err=err.max().item(), bound=bnd)


def rr_cli_phase(device, card):
    """[R1] the main paths with --rr-depth RR_DEPTH through the CLI,
    chap12 at MAIN: the tile driver (render_tiles' launches counted from
    0) and the queue driver in four passes (bounce_steps'), held to the
    tile image by [Q2]'s rule (hold_to_tile: the same paths). Returns
    the launches (tile_render, bounce_steps)."""
    from rrt_tpu_torch import cli
    from rrt_tpu_torch.ops import megakernel as mk
    argv = ["--scene", MAIN["scene"], "-r",
            f"{MAIN['width']}x{MAIN['height']}", "-s", str(MAIN["spp"]),
            "-e", "0", "--max-depth", str(MAIN["max_depth"]), "--rr-depth",
            str(RR_DEPTH), "--device", "cuda:0", "--quiet"]
    results, launches = {}, []
    for driver, wrapper in (("tile", mk.render_tiles),
                            ("queue", mk.bounce_steps)):
        extra = ["--driver", driver, "--spp-chunk",
                 str(QUEUE_CHUNK if driver == "queue" else MAIN["spp"])]
        with tempfile.TemporaryDirectory() as tmp:
            cli.render(cli.build_parser().parse_args(  # warm-up
                argv + extra + ["-o", os.path.join(tmp, "warm.png")]))
            wrapper.launches = 0
            res = cli.render(cli.build_parser().parse_args(
                argv + extra + ["-o", os.path.join(tmp, "o.png")]))
        launches.append(wrapper.launches)
        results[driver] = res
        print(f"  {driver}: {res.seconds:.4f} s wall, {res.passes} passes, "
              f"{res.n_traced} rays ({res.n_traced / MAIN_TRACED:.4f} of "
              f"[4]'s at rr_depth 0), {res.n_traced / res.seconds / 1e6:.2f} "
              f"Mrays/s, {wrapper.__name__} launches {launches[-1]}  "
              f"[{card}]", flush=True)
        check(launches[-1] >= 1 and bool(torch.isfinite(res.image).all()),
              ("[R1]", driver, launches[-1]))
        check(res.n_traced < MAIN_TRACED, ("[R1] roulette", driver))
    hold_to_tile("queue at rr_depth 4", results["queue"].image,
                 results["queue"].n_traced, results["tile"].image,
                 results["tile"].n_traced)
    return launches


def rr_train_phase(device, card, counts):
    """[R2] the train kernels and chain_bwd with rr_depth RR_DEPTH: [5]'s
    checks on chap12 at 240x160, 2 spp, depth 50 (train_vs_plain: the
    kernels against tile_render and their plain versions, the gradients
    by gradcheck's rule, no replay mismatch); train_fwd's and train_bwd's
    ms at [7]'s 1200x800, 8 spp beside rr_depth 0's (CUDA events, in
    turns) with their traced totals and no replay mismatch; the main
    path: one make_train_step step at [7]'s shape with the launch counts
    from 0; one 500-spp step at rr_depth 0 and at RR_DEPTH (printed, no
    gate); [C1] on [C2]'s three chains (chain_kernel_phase) and the main
    path: one [C2] gradient step, both at RR_DEPTH. counts: [Q1]'s
    walk_counts, for chain_bwd's bound. Returns the kernels line's
    numbers."""
    from rrt_tpu_torch import diff, render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk
    from rrt_tpu_torch.ops import megakernel_train as mkt
    from rrt_tpu_torch.ops import megakernel_vjp as mkv
    crop = train_vs_plain("chap12", 240, 160, 2, MAIN["max_depth"], device,
                          card, rr_depth=RR_DEPTH,
                          max_winner_faults=RR_MAX_WINNER_FAULTS,
                          exclude_parted=True)
    cfg = render.RenderConfig(**TRAIN)
    scene, cam = tscenes.chap12_scene(cfg.width, cfg.height)
    packs = [p.detach() for p in render._packs(scene, cam, cfg, device)]
    kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
              height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
              t_min=cfg.t_min, moving=False)
    d_rad = torch.tensor(MIX, device=device).expand(
        cfg.width * cfg.height, 3).contiguous()
    fwd = {rr: mkt.render_tiles_train(*packs, rr_depth=rr, **kw)
           for rr in (0, RR_DEPTH)}
    f_log, b_log = {rr: [] for rr in fwd}, {rr: [] for rr in fwd}
    mism = {rr: torch.zeros((1,), dtype=torch.int32, device=device)
            for rr in fwd}
    for _ in range(3):
        for rr, out in fwd.items():
            timed(mkt.render_tiles_train, f_log[rr])(*packs, rr_depth=rr,
                                                     **kw)
            k = timed(mkt.tiles_adjoint, b_log[rr])(
                *packs, d_rad, out[2], out[3], rr_depth=rr, **kw)
            mism[rr] += k[3]
    torch.cuda.synchronize()

    def median(log):
        return sorted(s.elapsed_time(e) for s, e in log)[len(log) // 2]

    f_ms = {rr: median(log) for rr, log in f_log.items()}
    b_ms = {rr: median(log) for rr, log in b_log.items()}
    traced = {rr: int(out[1].sum()) for rr, out in fwd.items()}
    mism = {rr: int(m) for rr, m in mism.items()}
    f_bnd, b_bnd, _ = train_bounds(fwd[RR_DEPTH][1], cfg.spp,
                                   packs[0].shape[1], False)
    print(f"  chap12 {cfg.width}x{cfg.height} {cfg.spp}spp: rr_depth "
          f"{RR_DEPTH}: train_fwd {f_ms[RR_DEPTH]:.3f} ms, train_bwd "
          f"{b_ms[RR_DEPTH]:.3f} ms, {traced[RR_DEPTH]} traced, "
          f"replay_mismatches {mism[RR_DEPTH]}; rr_depth 0: train_fwd "
          f"{f_ms[0]:.3f} ms, train_bwd {b_ms[0]:.3f} ms, {traced[0]} "
          f"traced, replay_mismatches {mism[0]}; traced "
          f"{traced[RR_DEPTH] / traced[0]:.4f} of rr_depth 0's; bounds at "
          f"rr_depth {RR_DEPTH}: train_fwd {f_bnd[0]:.4f} ms ({f_bnd[1]}), "
          f"train_bwd {b_bnd[0]:.4f} ms ({b_bnd[1]})  [{card}]", flush=True)
    check(mism == {0: 0, RR_DEPTH: 0}, ("[R2] replay_mismatches", mism))
    check(traced[RR_DEPTH] < traced[0], ("[R2] roulette", traced))

    cfg_rr = dataclasses.replace(cfg, rr_depth=RR_DEPTH)
    target, _ = render.render_image_tiles(scene, cam, cfg, 1, device=device)
    step = diff.make_train_step(cfg_rr, device=device)
    step(scene, cam, target, 0)  # warm-up
    fwd_fn, bwd_fn = mkt.render_tiles_train, mkt.tiles_adjoint
    fwd_fn.launches = bwd_fn.launches = 0
    bwd_fn.replay_mismatches = 0
    (_, _, loss), ms = wall_ms(lambda: step(scene, cam, target, 0))
    step_launches = (fwd_fn.launches, bwd_fn.launches)
    step_mism = int(bwd_fn.replay_mismatches)
    print(f"  make_train_step at rr_depth {RR_DEPTH}: loss "
          f"{loss.item():.6e}, {ms:.2f} ms wall, launches train_fwd "
          f"{step_launches[0]}, train_bwd {step_launches[1]}, "
          f"replay_mismatches {step_mism}  [{card}]", flush=True)
    check(bool(torch.isfinite(loss)) and min(step_launches) >= 1
          and step_mism == 0, ("[R2] train step", step_launches, step_mism))
    for rr in (0, RR_DEPTH):
        step_ns = diff.make_train_step(dataclasses.replace(
            cfg, spp=NORTH_STAR_SPP, rr_depth=rr), device=device)
        (_, _, loss_ns), ns_ms = wall_ms(
            lambda: step_ns(scene, cam, target, 0))
        print(f"  {NORTH_STAR_SPP}-spp make_train_step at rr_depth {rr}: "
              f"{ns_ms / 1e3:.3f} s wall, loss {loss_ns.item():.6e}  "
              f"[{card}]", flush=True)

    c1, chain = chain_kernel_phase(device, card, counts, rr_depth=RR_DEPTH)
    c_scene, c_cam, c_cfg, px, py, keys = chain

    def chain_step(rr):
        scene_d, params, camera = diff._leaves(c_scene, c_cam, device)
        o, d, tm = render.generate_rays(camera, px, py, c_cfg.width,
                                        c_cfg.height, keys)
        rad, n = render.trace_batch(scene_d, o, d, tm, keys,
                                    c_cfg.max_depth, 1e-3,
                                    differentiable=True, fused_vjp=True,
                                    rr_depth=rr)
        loss = rad[0].mean() + rad[1].mean() + rad[2].mean()
        gp, gc = diff._grads(loss, params, camera)
        return loss.detach(), gp, gc, int(n)

    chain_step(RR_DEPTH)  # warm-up
    mk.bounce_steps.launches = mkv.chain_adjoint.launches = 0
    mkv.chain_adjoint.replay_mismatches = 0
    (c_loss, gp, gc, c_traced), c_ms = wall_ms(lambda: chain_step(RR_DEPTH))
    chain_launches = (mk.bounce_steps.launches, mkv.chain_adjoint.launches)
    c_mism = int(mkv.chain_adjoint.replay_mismatches)
    (_, _, _, off_traced), off_ms = wall_ms(lambda: chain_step(0))
    print(f"  [C2]'s gradient step at rr_depth {RR_DEPTH}: loss "
          f"{c_loss.item():.6e}, {c_traced} traced, {c_ms:.2f} ms wall "
          f"(rr_depth 0: {off_traced} traced, {off_ms:.2f} ms), launches "
          f"bounce_steps {chain_launches[0]}, chain_bwd {chain_launches[1]},"
          f" replay_mismatches {c_mism}  [{card}]", flush=True)
    check(min(chain_launches) >= 1 and c_mism == 0
          and c_traced < off_traced, ("[R2] chain step", chain_launches,
                                      c_mism, c_traced, off_traced))
    grads_check("[R2]", gp, gc)
    (cb_ms, cb_by), _ = chain_bound(c1, counts)
    return dict(
        train_fwd=dict(ms=f_ms[RR_DEPTH], off_ms=f_ms[0],
                       plain_ms=crop["fwd_plain_ms"], err=crop["fwd_err"],
                       bound=f_bnd, launches=step_launches[0],
                       traced=traced[RR_DEPTH], off_traced=traced[0]),
        train_bwd=dict(ms=b_ms[RR_DEPTH], off_ms=b_ms[0],
                       plain_ms=crop["bwd_plain_ms"], err=crop["bwd_err"],
                       bound=b_bnd, launches=step_launches[1]),
        chain_bwd=dict(ms=sum(c["ms"] for c in c1),
                       plain_ms=sum(c["plain_ms"] for c in c1),
                       err=max(c["err"] for c in c1), bound=(cb_ms, cb_by),
                       launches=chain_launches[1]))


# [D1]: the row window and ranks sharing the card (parallel/mesh.py).
# The forward kernels' bands are the full launch's rows bit for bit by
# construction (a pixel's keys are its id in the whole image); train_bwd's
# cotangents summed over bands are held to PACK_SPREAD, its atomics'
# spread. The bands: two halves of MAIN's 800 rows.
D1_BANDS = ((0, 400), (400, 800))
# The meshes of the forward through the CLI, ranks sharing the one card
# under gloo; the train step's mesh.
D1_MESHES = ("2x1", "1x2", "2x2")
D1_TRAIN_MESH = "2x2"
# A rank's time limit (the ranks of a run share it): a rank reaches the
# card in about 8 s, loads the built kernels and renders in well under a
# second; 120 s is several times a run.
D1_TIMEOUT = 120
# Under sp > 1 a pixel's samples are summed in another order than in one
# process: every pixel of the mean image within D1_SP_TOL x max(1, |v|).
# Worst reading on an H100 80GB HBM3 at 700 W: 4.8e-7 (1x2 and 2x2), the
# sums' order; the gate is 21 times it.
D1_SP_TOL = 1e-5
# The sharded train step's gradients against one process's: within the
# larger of 1e-5 of each field's largest (at least 1e-6, the gradient
# rules' floor in tests/_torch_helpers.py) and twice the spread two
# single-process runs of the same step show (train_bwd's atomics). On an
# H100 80GB HBM3 at 700 W: two single-process steps 1.07e-7 apart, the
# 2x2 step's worst field (tex_color1) 6.64e-6 from one process's, nearly
# all of it the order of its sums over bands and sample shares, which
# runs repeat (so the reading moves by about the 1.07e-7 spread).
D1_GRAD_FLOOR = 1e-5


def window_phase(device, card):
    """[D1] tile_render (MAIN), train_fwd and train_bwd (TRAIN) on the two
    bands of D1_BANDS against the full launch, each timed by CUDA events
    beside it."""
    from rrt_tpu_torch import render, scenes as tscenes
    from rrt_tpu_torch.ops import megakernel as mk, megakernel_train as mkt
    scene, cam = tscenes.SCENES["chap12"](MAIN["width"], MAIN["height"])
    out = {}
    for what, spec in (("tile", MAIN), ("train", TRAIN)):
        cfg = render.RenderConfig(width=spec["width"], height=spec["height"],
                                  spp=spec["spp"],
                                  max_depth=spec["max_depth"])
        *packs, bvh = render._packs(scene, cam, cfg, device, bvh=True)
        packs = [p.detach() for p in packs]
        kw = dict(seed_words=(0, 0), sample_lo=0, width=cfg.width,
                  height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                  t_min=1e-3, moving=False)
        if what == "tile":
            def fwd(**win):
                return mk.render_tiles(*packs, bvh=bvh, **kw, **win)
        else:
            def fwd(**win):
                return mkt.render_tiles_train(*packs, **kw, **win)
        full = fwd()
        parts = [fwd(row_lo=lo, row_hi=hi) for lo, hi in D1_BANDS]
        same = [torch.equal(torch.cat([p[i] for p in parts]), full[i])
                for i in range(2)]
        if what == "train":
            same.append(torch.equal(torch.cat([p[2] for p in parts], dim=1),
                                    full[2]))
            written = (torch.arange(full[3].shape[0], device=device)[:, None]
                       < full[1][None, :])
            same.append(torch.equal(
                torch.cat([p[3] for p in parts], dim=1)[written],
                full[3][written]))
        full_ms = cuda_ms(fwd, 3)
        band_ms = [cuda_ms(lambda lo=lo, hi=hi: fwd(row_lo=lo, row_hi=hi), 3)
                   for lo, hi in D1_BANDS]
        name = "tile_render" if what == "tile" else "train_fwd"
        print(f"  {name} {cfg.width}x{cfg.height} {cfg.spp}spp "
              f"d{cfg.max_depth}: bands {list(D1_BANDS)} are the full "
              f"launch's rows bit for bit {same}; {full_ms:.3f} ms full, "
              f"{band_ms[0]:.3f} + {band_ms[1]:.3f} ms banded  [{card}]",
              flush=True)
        check(all(same), (f"[D1] {name} bands", same))
        out[name] = dict(full_ms=full_ms, band_ms=band_ms)
        if what != "train":
            continue
        weight = torch.sin(torch.arange(cfg.width * cfg.height,
                                        device=device) * 0.1)
        d_rad = (weight[:, None] * torch.tensor(MIX, device=device))
        w = cfg.width

        def bwd(lo=0, hi=cfg.height, res=full):
            return mkt.tiles_adjoint(*packs, d_rad[lo * w:hi * w].contiguous(),
                                     res[2], res[3], **kw, row_lo=lo,
                                     row_hi=hi)
        k = bwd()
        bands = [bwd(lo, hi, p) for (lo, hi), p in zip(D1_BANDS, parts)]
        spreads = [((sum(b[i] for b in bands) - k[i]).abs().max()
                    / k[i].abs().max().clamp(min=1e-30)).item()
                   for i in range(3)]
        mism = [int(k[3])] + [int(b[3]) for b in bands]
        full_ms = cuda_ms(bwd, 3)
        band_ms = [cuda_ms(lambda lo=lo, hi=hi, p=p: bwd(lo, hi, p), 3)
                   for (lo, hi), p in zip(D1_BANDS, parts)]
        print(f"  train_bwd: the bands' d_sph, d_cam, d_bg summed against the "
              f"full launch's: {', '.join(f'{s:.2e}' for s in spreads)} of "
              f"their largest (gate {PACK_SPREAD:.0e}); replay_mismatches "
              f"{mism}; {full_ms:.3f} ms full, {band_ms[0]:.3f} + "
              f"{band_ms[1]:.3f} ms banded  [{card}]", flush=True)
        check(max(spreads) <= PACK_SPREAD and not any(mism),
              ("[D1] train_bwd bands", spreads, mism))
        out["train_bwd"] = dict(full_ms=full_ms, band_ms=band_ms,
                                spread=max(spreads))
    return out


def _rank_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def sharded_forward_phase(device, card):
    """[D1] the main path: python -m rrt_tpu_torch.cli on chap12 at MAIN
    over each mesh of D1_MESHES, its ranks sharing the card (gloo),
    against one process's image; each rank's wall, peak memory and
    tile_render launches. Returns {mesh: tile_render launches a rank}."""
    from rrt_tpu_torch import cli, io as tio
    from rrt_tpu_torch.parallel.launch import launch
    argv = ["--scene", MAIN["scene"], "-r",
            f"{MAIN['width']}x{MAIN['height']}", "-s", str(MAIN["spp"]),
            "--max-depth", str(MAIN["max_depth"]), "--device", "cuda"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        one = os.path.join(tmp, "one.npz")
        cli.main(argv + ["--quiet", "--checkpoint", one, "-o",
                         os.path.join(tmp, "one.png")])
        ref = tio.load_checkpoint(one)[0] / MAIN["spp"]
        for mesh in D1_MESHES:
            dp, sp = map(int, mesh.split("x"))
            ck = os.path.join(tmp, f"{mesh}.npz")
            t0 = time.perf_counter()
            logs = launch(["rrt_tpu_torch.cli", *argv, "--mesh", mesh,
                           "--checkpoint", ck, "-o",
                           os.path.join(tmp, f"{mesh}.png")], dp * sp,
                          timeout=D1_TIMEOUT, env=_rank_env(), cwd=REPO)
            wall = time.perf_counter() - t0
            lines = [ln for log in logs for ln in log.splitlines()
                     if ln.startswith(("backend", "rank "))]
            for ln in lines:
                print(f"    {ln}")
            launches = [int(ln.split("render_tiles ")[1].split(",")[0])
                        for ln in lines if ln.startswith("rank ")]
            img = tio.load_checkpoint(ck)[0] / MAIN["spp"]
            err = np.abs(img - ref) / np.maximum(1.0, np.abs(ref))
            same = bool(np.array_equal(img, ref))
            print(f"  mesh {mesh}: {dp * sp} ranks on one card, {wall:.1f} s "
                  f"wall with the ranks' start; the image bit for bit "
                  f"{same}, largest |delta| / max(1, |v|) {err.max():.3e}; "
                  f"tile_render launches a rank {launches}  [{card}]",
                  flush=True)
            check(len(launches) == dp * sp and min(launches) >= 1,
                  ("[D1] launches", mesh, launches))
            check(same if sp == 1 else err.max() <= D1_SP_TOL,
                  ("[D1] sharded image", mesh, same, float(err.max())))
            check(any("backend gloo" in ln for ln in lines),
                  ("[D1] backend", mesh))
            out[mesh] = launches
    return out


def sharded_train_phase(device, card):
    """[D1] the main path: one make_train_step step (and loss_and_grads)
    of chap12 at TRAIN on D1_TRAIN_MESH's ranks sharing the card, through
    python -m rrt_tpu_torch.parallel.train_step, against the same step
    in this process, run twice for the spread. Returns the train kernels'
    launches a rank."""
    from rrt_tpu_torch import render
    from rrt_tpu_torch.parallel import train_step
    from rrt_tpu_torch.parallel.launch import launch
    cfg = render.RenderConfig(width=TRAIN["width"], height=TRAIN["height"],
                              spp=TRAIN["spp"], max_depth=TRAIN["max_depth"])
    one = [train_step.run(cfg, "chap12", device) for _ in range(2)]
    keys = [k for k in one[0] if k.startswith("grad/")]

    def rel(a, b, k):
        return float(np.abs(a[k] - b[k]).max()
                     / max(np.abs(b[k]).max(), 1e-6))
    spread = {k: rel(one[1], one[0], k) for k in keys}
    worst = max(spread, key=spread.get)
    print(f"  two single-process steps: gradients apart by up to "
          f"{spread[worst]:.3e} of a field's largest ({worst}); "
          f"{one[0]['wall_s']:.3f} s, {one[1]['wall_s']:.3f} s, peak "
          f"{one[0]['peak_bytes'] / 1e9:.3f} GB  [{card}]", flush=True)
    gate = {k: max(D1_GRAD_FLOOR, 2.0 * s) for k, s in spread.items()}
    dp, sp = map(int, D1_TRAIN_MESH.split("x"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        logs = launch(["rrt_tpu_torch.parallel.train_step", "--scene",
                       "chap12", "-r", f"{cfg.width}x{cfg.height}", "-s",
                       str(cfg.spp), "--max-depth", str(cfg.max_depth),
                       "--device", "cuda", "--mesh", D1_TRAIN_MESH, "--out",
                       tmp], dp * sp, timeout=D1_TIMEOUT, env=_rank_env(),
                      cwd=REPO)
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{i}.npz")))
                 for i in range(dp * sp)]
    print(f"    {logs[0].splitlines()[-1] if logs[0] else ''}")
    for i, r in enumerate(ranks):
        print(f"    rank {i}: backend {r['backend']}, loss "
              f"{float(r['loss']):.6e}"
              f" (one process {float(one[0]['loss']):.6e}), "
              f"{float(r['wall_s']):.3f} s, peak "
              f"{int(r['peak_bytes']) / 1e9:.3f} GB, launches train_fwd "
              f"{int(r['launches'][0])}, train_bwd {int(r['launches'][1])}",
              flush=True)
    err = {k: max(rel(r, one[0], k) for r in ranks) for k in keys}
    over = {k: (e, gate[k]) for k, e in err.items() if e > gate[k]}
    worst = max(err, key=err.get)
    params = [k for k in ranks[0] if k.startswith("param/")]
    same = all(np.array_equal(r[k], ranks[0][k])
               for r in ranks for k in params)
    print(f"  mesh {D1_TRAIN_MESH}: {dp * sp} ranks, {wall:.1f} s wall with "
          f"the ranks' start; gradients within {err[worst]:.3e} of a field's "
          f"largest of one process's ({worst}), over their gates: {over}; "
          f"every rank's parameters the same bit for bit {same}  [{card}]",
          flush=True)
    launches = [int(r["launches"][0]) for r in ranks] + [
        int(r["launches"][1]) for r in ranks]
    check(not over and same and min(launches) >= 1,
          ("[D1] sharded train step", over, same, launches))
    check(all(str(r["backend"]) == "gloo" for r in ranks), "[D1] backend")
    return [int(r["launches"][0]) for r in ranks], [
        int(r["launches"][1]) for r in ranks]


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
    phases.start("K1", f"cornell {CORNELL['width']}x{CORNELL['height']}: "
                 f"the kernels' solid-family variants vs their plain "
                 f"versions; the seeded walk's exact gates")
    torch.cuda.reset_peak_memory_stats(device)
    k1 = cornell_kernels_phase(device, card)
    peak_memory("[K1]", device, card)
    phases.start("K2", f"main path: python -m rrt_tpu_torch.cli --scene "
                 f"cornell -r {CORNELL['width']}x{CORNELL['height']} -s "
                 f"{CORNELL['spp']} (tile), then the queue and batch "
                 f"drivers")
    k2_launches = cornell_cli_phase(device, card)
    phases.start("K3", f"cornell's gradient on the card at "
                 f"{CORNELL['width']}x{CORNELL['height']} "
                 f"{CORNELL_TRAIN_SPP}spp d{CORNELL['max_depth']}: the train "
                 f"kernels and chain_bwd (solid families) vs their plain "
                 f"versions, then make_train_step, its chunked step and "
                 f"render_image(differentiable=True)")
    k3 = cornell_train_phase(device, card, resources)
    phases.start("S1", f"cornell_smoke {SMOKE['width']}x{SMOKE['height']}: "
                 f"the kernels' media variants vs their plain versions, then "
                 f"the main path: python -m rrt_tpu_torch.cli --scene "
                 f"cornell_smoke -s {SMOKE['spp']} (tile), the queue and "
                 f"batch drivers")
    torch.cuda.reset_peak_memory_stats(device)
    s1 = smoke_kernels_phase(device, card)
    s1_launches = cornell_cli_phase(device, card, "cornell_smoke")
    peak_memory("[S1]", device, card)
    phases.start("S2", f"cornell_smoke's gradient on the card at "
                 f"{SMOKE['width']}x{SMOKE['height']} {CORNELL_TRAIN_SPP}spp "
                 f"d{SMOKE['max_depth']}: the train kernels' media variants "
                 f"vs their plain versions, finite differences, then "
                 f"make_train_step and its chunked step; the chain's raises")
    s2 = smoke_train_phase(device, card, resources)
    phases.start("S3", f"the media adjoint on media_scene "
                 f"{MEDIA_ADJ['width']}x{MEDIA_ADJ['height']} "
                 f"{MEDIA_ADJ['spp']}spp d{MEDIA_ADJ['max_depth']}")
    media_adjoint_phase(device, card)
    t1, t1_launches = {}, {}
    for name in TEXTURE_SCENES:
        phases.start("T1", f"{name} {TEXTURE['width']}x{TEXTURE['height']}: "
                     f"the kernels' texture variants vs their plain "
                     f"versions, then the main path: python -m "
                     f"rrt_tpu_torch.cli --scene {name} -s {TEXTURE['spp']} "
                     f"(tile), the queue and batch drivers")
        torch.cuda.reset_peak_memory_stats(device)
        t1[name] = texture_kernels_phase(name, device, card)
        t1_launches[name] = texture_cli_phase(name, device, card)
        peak_memory(f"[T1] {name}", device, card)
    t2 = {}
    for name in TEXTURE_SCENES:
        phases.start("T2", f"{name}'s gradient on the card at "
                     f"{TEXTURE['width']}x{TEXTURE['height']} "
                     f"{CORNELL_TRAIN_SPP}spp d{TEXTURE['max_depth']}: the "
                     f"train kernels' and chain_bwd's texture variants vs "
                     f"their plain versions, the atlas cotangent, finite "
                     f"differences, then make_train_step and "
                     f"render_image(differentiable=True)")
        t2[name] = texture_train_phase(name, device, card, resources)
    phases.start("F1", f"rttnw_final {RTTNW['width']}x{RTTNW['height']} "
                 f"d{RTTNW['max_depth']}: the forward kernels' walks over "
                 f"400 boxes vs their plain versions and the solid scan, "
                 f"then the main path: python -m rrt_tpu_torch.cli --scene "
                 f"rttnw_final -s {RTTNW['spp']} (tile), the queue and "
                 f"batch drivers; the chain's raise")
    torch.cuda.reset_peak_memory_stats(device)
    f1 = rttnw_kernels_phase(device, card, resources)
    f1_launches = rttnw_cli_phase(device, card)
    rttnw_gradient_raises(device, card)
    peak_memory("[F1]", device, card)
    phases.start("F3", f"rttnw_final's gradient on the card at "
                 f"{RTTNW['width']}x{RTTNW['height']} {CORNELL_TRAIN_SPP}spp "
                 f"d{RTTNW['max_depth']}: train_fwd's walk and train_bwd vs "
                 f"tile_render and their plain versions, finite differences "
                 f"of a box's albedo past slot 63, then make_train_step and "
                 f"its chunked step; the chain's raise")
    f3 = rttnw_train_phase(device, card, resources, f1["counts"])
    phases.start("F2", f"many_solids {MANY['width']}x{MANY['height']}: 81 "
                 f"boxes and 82 quads, the walks vs the solid scan")
    many_solids_phase(device, card)
    phases.start("F4", f"chain_bwd's walks: many_solids "
                 f"{MANY['width']}x{MANY['height']} vs the plain version and "
                 f"the solid scan, rttnw_final without media on [C2]'s "
                 f"chains, then the main path: render_image("
                 f"differentiable=True) {RTTNW_DIFF['width']}x"
                 f"{RTTNW_DIFF['height']} {RTTNW_DIFF['spp']}spp "
                 f"d{RTTNW_DIFF['max_depth']}, render_image_diff at depth 80")
    torch.cuda.reset_peak_memory_stats(device)
    f4_many = walk_chain_many_solids(device, card)
    f4 = walk_chain_rttnw(device, card)
    f4_launches, f4_main = walk_chain_main_path(device, card)
    peak_memory("[F4]", device, card)
    phases.start("R1", f"Russian roulette at rr_depth {RR_DEPTH}: tile_render "
                 f"and bounce_steps vs rr_depth 0 and their plain versions "
                 f"on chap12 {MAIN['width']}x{MAIN['height']} and cornell "
                 f"{CORNELL['width']}x{CORNELL['height']}, then the main "
                 f"path: the CLI's tile and queue drivers")
    torch.cuda.reset_peak_memory_stats(device)
    r1 = {"tile": rr_tile_phase("chap12", MAIN["width"], MAIN["height"],
                                device, card, counts3),
          "queue": rr_bounce_phase("chap12", MAIN["width"], MAIN["height"],
                                   device, card, q1["counts"])}
    rr_tile_phase("cornell", CORNELL["width"], CORNELL["height"], device,
                  card)
    rr_bounce_phase("cornell", CORNELL["width"], CORNELL["height"], device,
                    card)
    r1_launches = rr_cli_phase(device, card)
    peak_memory("[R1]", device, card)
    phases.start("R2", f"Russian roulette's gradient at rr_depth {RR_DEPTH}: "
                 f"the train kernels vs their plain versions and rr_depth 0, "
                 f"make_train_step at 8 and {NORTH_STAR_SPP} spp, chain_bwd "
                 f"on [C2]'s chains and the [C2] step")
    torch.cuda.reset_peak_memory_stats(device)
    r2 = rr_train_phase(device, card, q1["counts"])
    peak_memory("[R2]", device, card)
    phases.start("D1", f"the row window: tile_render, train_fwd and "
                 f"train_bwd on bands {list(D1_BANDS)} vs the full launch; "
                 f"then the main paths over ranks sharing the card: the CLI "
                 f"on meshes {', '.join(D1_MESHES)}, the train step on "
                 f"{D1_TRAIN_MESH}")
    torch.cuda.reset_peak_memory_stats(device)
    d1 = window_phase(device, card)
    d1_fwd = sharded_forward_phase(device, card)
    d1_train = sharded_train_phase(device, card)
    print("  [D1] ranks that share one card measure nothing about scaling "
          "across cards: they take turns on its SMs", flush=True)
    peak_memory("[D1]", device, card)
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
    # (plain_iters). The train kernels' rttnw_* fields: [F3] (ms at
    # CORNELL_TRAIN_SPP, plain_ms and max_abs_err at
    # RTTNW_TRAIN_PLAIN_SPP, launches and main_ms on its main path, the
    # blocks an SM, the share of segments past the winner pool). No
    # single PyTorch call computes any of these functions.
    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                **extra}

    def moving(ms, bnd, **extra):
        return dict(moving_ms=ms, moving_bound_ms=bnd[0], **extra)

    def cornell(k, launches, name):
        # The kernel's solid-family variant on cornell ([K1], [K2]).
        return dict(cornell_ms=k["ms"], cornell_plain_ms=k["plain_ms"],
                    cornell_bound_ms=k["bound"][0],
                    cornell_bound_by=k["bound"][1],
                    cornell_max_abs_err=k["err"], cornell_launches=launches,
                    cornell_registers=resources.get(name + " (solids)"))

    def smoke(k, launches, name):
        # The kernel's media variant on cornell_smoke ([S1]: tile_render's
        # plain_ms and max_abs_err at SMOKE_PLAIN_SPP; launches on [S1]'s
        # CLI main path; the train kernels' from [S2]).
        return dict(smoke_ms=k["ms"], smoke_plain_ms=k["plain_ms"],
                    smoke_bound_ms=k["bound"][0],
                    smoke_bound_by=k["bound"][1],
                    smoke_max_abs_err=k["err"], smoke_launches=launches,
                    smoke_registers=resources.get(name + " (solids)"))

    def textured(kernel, part, launch_idx, name):
        # The kernel's texture variants ([T1]: tile_render and
        # bounce_steps, plain_ms and max_abs_err of tile_render at
        # TEXTURE_PLAIN_SPP, launches on [T1]'s CLI main path; [T2]: the
        # train kernels and chain_bwd, launches on [T2]'s main path):
        # light_* on simple_light, earth_* on earth.
        out = {}
        for scene_name, prefix in (("simple_light", "light"),
                                   ("earth", "earth")):
            if part in ("tile", "queue"):
                k = t1[scene_name][part]
                tag = (" (solids, tex)" if scene_name == "simple_light"
                       else " (tex)")
                out.update({f"{prefix}_ms": k["ms"],
                            f"{prefix}_plain_ms": k["plain_ms"],
                            f"{prefix}_bound_ms": k["bound"][0],
                            f"{prefix}_bound_by": k["bound"][1],
                            f"{prefix}_max_abs_err": k["err"],
                            f"{prefix}_launches":
                                t1_launches[scene_name][launch_idx],
                            f"{prefix}_registers":
                                resources.get(name + tag)})
            else:
                out.update(t2[scene_name][part])
        return out

    def rttnw(k, launches, name):
        # The kernel's (moving, solids, tex) variant on rttnw_final ([F1]:
        # tile_render's plain_ms and max_abs_err at RTTNW_PLAIN_SPP,
        # launches on [F1]'s CLI main path; the walks' tests a segment).
        c = f1["counts"]
        return dict(rttnw_ms=k["ms"], rttnw_plain_ms=k["plain_ms"],
                    rttnw_bound_ms=k["bound"][0],
                    rttnw_bound_by=k["bound"][1],
                    rttnw_max_abs_err=k["err"], rttnw_launches=launches,
                    rttnw_walk_tests=[c["nodes"], c["solids"], c["spheres"]],
                    rttnw_registers=resources.get(
                        name + " (moving, solids"
                        + (", tex" if name != "intersect_kernel" else "")
                        + ", walk)"))

    def rr(k, launches):
        # The kernel at rr_depth RR_DEPTH ([R1]: tile_render at MAIN,
        # plain_ms and max_abs_err at RR_PLAIN_SPP, launches on [R1]'s CLI
        # main path; bounce_steps on [Q1]'s lanes after RR_DEPTH steps;
        # [R2]: the train kernels at [7]'s shape, plain_ms and max_abs_err
        # at [R2]'s 240x160, launches on its make_train_step step; chain_bwd
        # on [C2]'s chains, launches on its [C2] step).
        return dict(rr_depth=RR_DEPTH, rr_ms=k["ms"],
                    rr_off_ms=k.get("off_ms"), rr_plain_ms=k["plain_ms"],
                    rr_max_abs_err=k["err"], rr_bound_ms=k["bound"][0],
                    rr_bound_by=k["bound"][1], rr_launches=launches)

    def walk(scan_bnd, counts, moving_scan_bnd, moving_counts):
        # Every kernel but the train kernels walks the BVH: bound_ms is
        # the walk's; the scan's, which they ran before, beside it.
        return dict(scan_bound_ms=scan_bnd[0],
                    moving_scan_bound_ms=moving_scan_bnd[0],
                    walk_tests=[counts["nodes"], counts["slots"]],
                    moving_walk_tests=[moving_counts["nodes"],
                                       moving_counts["slots"]])

    def walked():
        # chain_bwd's kWalk variants ([F4]): walk_ms, walk_bound_ms the
        # (moving, solids, tex, walk) one summed over [C2]'s three chains
        # of rttnw_final without media (device time by graph_ms on all
        # lanes), walk_plain_ms and walk_max_abs_err on every
        # RTTNW_CHAIN_STRIDE-th lane, walk_launches on [F4]'s main path;
        # walk_many_ms each variant on a chain of 4 of many_solids at
        # MANY's size, the plain version's beside it.
        tags = {(False, False): " (solids, walk)",
                (True, False): " (moving, solids, walk)",
                (False, True): " (solids, tex, walk)",
                (True, True): " (moving, solids, tex, walk)"}
        return dict(
            walk_ms=f4["ms"], walk_plain_ms=f4["plain_ms"],
            walk_bound_ms=f4["bound"][0], walk_bound_by=f4["bound"][1],
            walk_max_abs_err=f4["err"], walk_launches=f4_launches[1],
            walk_partials_mb=f4["partial_mb"],
            walk_many_ms={tags[v][2:-1]: {"ms": c["ms"],
                                          "plain_ms": c["plain_ms"]}
                          for v, c in f4_many.items()},
            walk_registers={tags[v][2:-1]: resources.get(
                "chain_bwd_kernel" + tags[v]) for v in tags})

    def windowed(name, launches):
        # [D1]: the kernel on D1_BANDS' two bands (window_band_ms) beside
        # its full launch (window_full_ms), tile_render at MAIN, the train
        # kernels at TRAIN; sharded_launches: each rank's launches on
        # [D1]'s main paths (the CLI's meshes, the train step's ranks).
        return dict(window_full_ms=d1[name]["full_ms"],
                    window_band_ms=d1[name]["band_ms"],
                    sharded_launches=launches)

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
              **cornell(k1["tile"], k2_launches[0], "tile_render_kernel"),
              **smoke(s1["tile"], s1_launches[0], "tile_render_kernel"),
              **textured("tile_render", "tile", 0, "tile_render_kernel"),
              **rttnw(f1["tile"], f1_launches[0], "tile_render_kernel"),
              **rr(r1["tile"], r1_launches[0]),
              **windowed("tile_render", d1_fwd),
              registers=resources.get("tile_render_kernel")),
        entry("train_fwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:376", fwd_launches,
              t5["fwd_err"], t5["fwd_ms"], t5["fwd_plain_ms"],
              t5["fwd_bound"], main_ms=main_fwd,
              step_bound_ms=t5["step_bound"][0],
              registers=resources.get("train_fwd_kernel"),
              **k3["train_fwd"], **s2["train_fwd"],
              **textured("train_fwd", "train_fwd", 0, "train_fwd_kernel"),
              **f3["train_fwd"], **rr(r2["train_fwd"],
                                      r2["train_fwd"]["launches"]),
              **windowed("train_fwd", d1_train[0]),
              **moving(m_t["fwd_ms"], m_t["fwd_bound"],
                       moving_launches=m3_launches[0])),
        entry("train_bwd", csrc + "train.cu",
              "rrt_tpu/ops/megakernel_train.py:463", bwd_launches,
              t5["bwd_err"], t5["bwd_ms"], t5["bwd_plain_ms"],
              t5["bwd_bound"], main_ms=main_bwd,
              step_bound_ms=t5["step_bound"][0],
              scan_ms=t5["bwd_scan_ms"],
              registers=resources.get("train_bwd_kernel"),
              **k3["train_bwd"], **s2["train_bwd"],
              **textured("train_bwd", "train_bwd", 1, "train_bwd_kernel"),
              **f3["train_bwd"], **rr(r2["train_bwd"],
                                      r2["train_bwd"]["launches"]),
              **windowed("train_bwd", d1_train[1]),
              window_spread=d1["train_bwd"]["spread"],
              **moving(m_t["bwd_ms"], m_t["bwd_bound"],
                       moving_launches=m3_launches[1])),
        entry("bounce_steps", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:645", q_launches, q1["err"],
              q1["ms"], q1["plain_ms"], q1["bound"],
              **moving(m_q["ms"], m_q["bound"]),
              **walk(q1["scan_bound"], q1["counts"], m_q["scan_bound"],
                     m_q["counts"]),
              **cornell(k1["queue"], k2_launches[1], "bounce_steps_kernel"),
              **smoke(s1["queue"], s1_launches[1], "bounce_steps_kernel"),
              **textured("bounce_steps", "queue", 1, "bounce_steps_kernel"),
              **rttnw(f1["queue"], f1_launches[1], "bounce_steps_kernel"),
              **rr(r1["queue"], r1_launches[1]),
              registers=resources.get("bounce_steps_kernel")),
        entry("intersect_only", csrc + "queue.cu",
              "rrt_tpu/ops/megakernel.py:1683", b_launches, q1["i_err"],
              q1["i_ms"], q1["i_plain_ms"], q1["i_bound"],
              **moving(m_q["i_ms"], m_q["i_bound"]),
              **walk(q1["i_scan_bound"], q1["counts"], m_q["i_scan_bound"],
                     m_q["counts"]),
              **cornell(k1["inter"], k2_launches[2], "intersect_kernel"),
              **smoke(s1["inter"], s1_launches[2], "intersect_kernel"),
              **rttnw(f1["inter"], f1_launches[2], "intersect_kernel")),
        entry("chain_bwd", csrc + "chain.cu",
              "rrt_tpu/ops/megakernel_vjp.py:487", c2_launches[1],
              max(c["err"] for c in c1), sum(c["ms"] for c in c1),
              sum(c["plain_ms"] for c in c1), c1_bound[0],
              **moving(sum(c["ms"] for c in m_c1), m_c1_bound[0]),
              **walk(c1_bound[1], q1["counts"], m_c1_bound[1],
                     m_q["counts"]),
              registers=resources.get("chain_bwd_kernel"),
              **k3["chain_bwd"], **rr(r2["chain_bwd"],
                                      r2["chain_bwd"]["launches"]),
              **textured("chain_bwd", "chain_bwd", 3, "chain_bwd_kernel"),
              **walked()),
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
