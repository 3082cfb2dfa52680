// The bounce chain's backward: replay K bounce steps of a (16, Q) lane
// state and sweep them in reverse.
//
// chain_bwd_kernel replaces rrt_tpu/ops/megakernel_vjp.py::_bwd_kernel
// (body _bwd_tile_body, launched by _bwd_call) for the scenes of
// tile_render.cu: static and moving spheres (a kMoving instantiation),
// and quads, boxes rotated about Y and diffuse_light (a kSolids
// instantiation: the solid families staged after the BVH, as
// bounce_steps_kernel stages them), and perlin-marble and image textures
// (a kTex instantiation: a marble's cotangents reach its color1, texture
// scale and, through the turbulence's gradient, the hit point; an
// image's go to its texel of the atlas cotangent, four-float atomics in
// device memory; a light's emission then takes emit_adjoint_tex), and
// Russian roulette from bounce rr_depth (0 off): the replay redraws the
// coin at the state's bounce row plus its step, and the sweep gives a
// surviving throughput the detached 1 / p (adjoint.cuh).
// rrt_tpu_torch/ops/megakernel_vjp.py holds the wrapper
// (chain_adjoint), its plain PyTorch version (chain_adjoint_reference)
// and the autograd.Function BounceChain, whose forward is queue.cu's
// bounce_steps_kernel and whose backward is this kernel.
//
// One thread a lane, 256 lanes a block. A lane that is alive on entry
//  1. replays up to k_steps bounces through bounce.cuh's bounce_step with
//     the BVH walk (BvhWalk over the tree the forward walked, staged in
//     shared memory), the function bounce_steps_kernel runs, from the
//     chain's saved input state and the lane's key, with the bounce
//     counter of state row 13, so its decisions are the forward's bit for
//     bit (with kSolids the walk seeded by the quads and boxes, as the
//     forward's); it keeps a record of each bounce (origin, direction,
//     throughput, winner or its winner_code) and what its scatter draws
//     decided (`kept`: a metal's point in the unit sphere, a dielectric's
//     reflection, a light's checker parity) in
//     thread-local storage (kMaxRecords; the wrapper refuses k_steps
//     above it);
//  2. counts in `mismatches` a lane whose replayed bounce row differs
//     from the forward output's (expected 0: the same code runs);
//  3. sweeps the records in reverse, seeded by the output cotangent rows
//     0-12 (o, d, time, throughput, pending radiance): a scattering
//     bounce through scatter_adjoint (adjoint.cuh, shared with
//     train.cu), which reshades the winner from its record and what the
//     replay kept, so the sweep draws nothing; the bounce that missed
//     passes o, d and throughput through and adds the background's
//     adjoint with the pending radiance's cotangent, the one that ends on
//     a light adds its emission's (emit_adjoint); a bounce that ends on a
//     surface (absorbed, or a hit at max_depth) is the identity. A quad's
//     or box's bounce goes through solid_scatter_adjoint.
//     Pending radiance passes through every bounce; so does time, which
//     with moving spheres also gains each scattering bounce's vel . (the
//     center's cotangent), as rrt_tpu's _make_diff_step gives it under
//     jax.vjp.
// A lane that is dead on entry went through the forward unchanged: its
// input cotangent is the output's, the GPU form of the TPU kernel's
// dead-tile pass-through. Rows 13-15 (bounce, alive, traced) get none.
//
// The sphere pack's 12 (15 moving) gradient rows, and with kSolids the
// active quads' and boxes' columns after them, accumulate as in
// train_bwd: each scattering bounce adds its winner's cotangents to its
// block's row of per-block partials in device memory (kSlotCols floats a
// slot, zeroed by the block first) with four-float atomic reductions
// (add_slot); reduce_partials then sums the rows in a fixed order of
// blocks. The background's six rows are warp sums added in a fixed order
// of warps and blocks, so they are bit-identical from run to run; the
// pack's may differ in the last bits (the order of the reductions within
// a block). Nothing is carried over from the TPU's one-hot MXU scatter
// or its (K*16, TN) VMEM scratch.
//
// What bounds it, and what the design does. The least time is the
// replay's walk (about 20 node and 7 slot tests a segment) and its
// draws, the sweep's transpose (about 300 FP32 operations a bounce) and
// the bytes of the lanes and of the partials: some tens of microseconds
// for the three chains of backward_chain (PERF.md). The walk in place of
// a scan of every slot, the kept draws and the reductions in device
// memory in place of shared-memory float atomics (a compare-and-swap
// loop on this card, spinning on the ground sphere's column) each took a
// part: on an H100 80GB HBM3 at 700 W the three chains take 1.07-1.10
// ms where they took 2.80-2.82 ms with none of them. The reductions also
// leave shared memory to the tree, which at 3,072 slots would not fit
// beside an accumulator. A grid sized to the card, its blocks looping
// over the lanes, ran 4% slower. Built with -fmad=false, as the other
// kernels (ops/_build.py): the replay must repeat the forward's
// arithmetic.

#include "adjoint.cuh"

namespace {

// Rows of the (16, Q) lane state (rrt_tpu/ops/megakernel.py pack_state).
constexpr int kStO = 0, kStD = 3, kStTime = 6, kStThr = 7, kStPend = 10,
              kStBounce = 13, kStAlive = 14, kStRows = 16;
constexpr int kDiffRows = 13;  // o, d, time, throughput, pending radiance
constexpr int kThreads = 256;
constexpr int kBgCols = 8;  // 6 background rows, 2 pad

// The backward of one lane: writes its rows of d_in, adds its pack
// cotangents to `acc` (its block's row of the partials, kSlotCols floats
// a slot: the spheres', then with kSolids the active quads' and boxes')
// and its background ones to g_bg. kTex: sv's textures.
template <bool kMoving, bool kSolids, bool kTex>
__device__ __forceinline__ void adjoint_lane(
    const BvhWalk<kMoving>& walk, const float* sph, int n_slots,
    const Solids& sv, const float* bg, const float* st,
    const uint32_t* keys, size_t n,
    int lane, const float* d_out, const float* out_bounce, int k_steps,
    int max_depth, int rr_depth, float t_min, float* d_in, float* acc,
    float* g_bg, int* mismatches) {
  const float* row = st + lane;
  const float* dso = d_out + lane;
  float* dsi = d_in + lane;
  for (int r = kDiffRows; r < kStRows; ++r) dsi[r * n] = 0.0f;
  if (!(row[kStAlive * n] > 0.5f)) {  // dead: the chain was the identity
    for (int r = 0; r < kDiffRows; ++r) dsi[r * n] = dso[r * n];
    return;
  }
  const uint32_t k0 = keys[lane], k1 = keys[n + lane];
  const bool sky = bg[6] < 0.5f;  // BG_SKY == 0
  Path p;
  p.ray.ox = row[(kStO + 0) * n];
  p.ray.oy = row[(kStO + 1) * n];
  p.ray.oz = row[(kStO + 2) * n];
  p.ray.dx = row[(kStD + 0) * n];
  p.ray.dy = row[(kStD + 1) * n];
  p.ray.dz = row[(kStD + 2) * n];
  p.ray.time = kMoving ? row[kStTime * n] : 0.0f;
  for (int c = 0; c < 3; ++c) p.thr[c] = row[(kStThr + c) * n];
  const int bounce0 = static_cast<int>(row[kStBounce * n]);

  // 1. replay, keeping each bounce's input, winner and what its draws
  // decided.
  Record rec[kMaxRecords];
  float kept[kMaxRecords][3];
  int n_rec = 0, last = kScattered;
  for (int k = 0; k < k_steps; ++k) {
    Record& r = rec[n_rec++];
    r.o[0] = p.ray.ox; r.o[1] = p.ray.oy; r.o[2] = p.ray.oz;
    r.d[0] = p.ray.dx; r.d[1] = p.ray.dy; r.d[2] = p.ray.dz;
    r.thr[0] = p.thr[0]; r.thr[1] = p.thr[1]; r.thr[2] = p.thr[2];
    float c[3];
    last = bounce_step<kMoving, kSolids, kTex>(walk, sph, n_slots, bg, sky,
                                               k0, k1, bounce0 + k, max_depth,
                                               rr_depth, t_min, p, c, r.win,
                                               kept[k], &sv);
    if (last != kScattered) break;
  }
  // 2. the replay must end on the forward's bounce row.
  const int n_scattered = last == kScattered ? n_rec : n_rec - 1;
  if (static_cast<float>(bounce0 + n_scattered) != out_bounce[lane]) {
    atomicAdd(mismatches, 1);
  }

  // 3. reverse sweep.
  float go[3], gd[3], gt[3], gp[3];
  for (int j = 0; j < 3; ++j) {
    go[j] = dso[(kStO + j) * n];
    gd[j] = dso[(kStD + j) * n];
    gt[j] = dso[(kStThr + j) * n];
    gp[j] = dso[(kStPend + j) * n];
  }
  float g_time = dso[kStTime * n];
  int k = n_rec - 1;
  if (last == kMissed) {
    miss_adjoint(rec[k], gp, bg, sky, gd, gt, g_bg);
  }
  if constexpr (kSolids) {
    if (last == kEmitted) {
      if constexpr (kTex) {
        emit_adjoint_tex<kMoving>(sph, n_slots, sv, rec[k], k0, k1,
                                  bounce0 + k, t_min, p.ray.time, kept[k], gp,
                                  go, gd, gt, g_time, acc);
      } else {
        emit_adjoint(sph, n_slots, sv, rec[k], kept[k], gp, gt, acc);
      }
    }
  }
  // A surface that absorbs or ends the depth: the identity.
  if (last != kScattered) --k;
  for (; k >= 0; --k) {
    if constexpr (kSolids) {
      int slot;
      const int fam = code_family(rec[k].win, slot);
      if (fam != kFamSphere) {
        constexpr int kRows = kTex ? kTexRows : kSolidRows;
        RowSums<kRows> sums{};
        solid_scatter_adjoint<decltype(sums), kTex>(sv, fam, slot, rec[k], k0,
                                                    k1, bounce0 + k, rr_depth,
                                                    t_min, go, gd, gt, sums,
                                                    kept[k]);
        add_slot<kRows>(acc + winner_column(n_slots, &sv, fam, slot),
                        sums.g);
        continue;
      }
    }
    constexpr int kRows = sphere_rows(kMoving, kTex);
    RowSums<kRows> sums;
    if constexpr (kTex) sums = RowSums<kRows>{};
    scatter_adjoint<kMoving, decltype(sums), true, kTex>(
        sph, n_slots, rec[k], k0, k1, bounce0 + k, rr_depth, t_min,
        p.ray.time, go, gd, gt, sums, g_time, kept[k], &sv.tex);
    add_slot<kRows>(acc + rec[k].win * kSlotCols, sums.g);
  }
  for (int j = 0; j < 3; ++j) {
    dsi[(kStO + j) * n] = go[j];
    dsi[(kStD + j) * n] = gd[j];
    dsi[(kStThr + j) * n] = gt[j];
    dsi[(kStPend + j) * n] = gp[j];
  }
  dsi[kStTime * n] = g_time;
}

template <bool kMoving, bool kSolids, bool kTex>
__global__ void __launch_bounds__(kThreads)
    chain_bwd_kernel(const float* __restrict__ st,
                     const uint32_t* __restrict__ keys, int q,
                     const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ nodes_g,
                     const int* __restrict__ rows_g, int n_nodes, int n_rows,
                     int n_always, const float* __restrict__ quad,
                     int quad_slots, int n_quads,
                     const float* __restrict__ box, int box_slots,
                     int n_boxes, TexView tex,
                     const float* __restrict__ bg_g,
                     const float* __restrict__ d_out,
                     const float* __restrict__ out_bounce, int k_steps,
                     int max_depth, int rr_depth, float t_min,
                     float* __restrict__ d_in,
                     float* __restrict__ partials,
                     int* __restrict__ mismatches) {
  // Dynamic shared memory (bvh_bytes): the staged BVH, then with kSolids
  // the solid families (as bounce_steps_kernel stages them). The pack
  // cotangents go to this block's row of the partials, zeroed here.
  extern __shared__ float4 smem[];
  __shared__ float bg[8];
  __shared__ float warp_part[kThreads / 32][kBgCols];
  const BvhWalk<kMoving> walk{stage_bvh<kMoving>(
      sph, n_slots, nodes_g, rows_g, n_nodes, n_rows, n_always, smem)};
  Solids sv{};
  if constexpr (kSolids) {
    sv = stage_solids(quad, quad_slots, n_quads, box, box_slots, n_boxes,
                      smem + aligned16(bvh_bytes(n_nodes, n_rows, kMoving)) /
                                 sizeof(float4));
  }
  sv.tex = tex;
  const int tid = threadIdx.x;
  if (tid < 8) bg[tid] = bg_g[tid];
  const int n_acc =
      kSlotCols * (kSolids ? n_slots + n_quads + n_boxes : n_slots);
  float* out =
      partials + blockIdx.x * (static_cast<size_t>(n_acc) + kBgCols);
  for (int i = tid; i < n_acc; i += kThreads) out[i] = 0.0f;
  __syncthreads();

  float g_bg[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int lane = blockIdx.x * blockDim.x + tid;
  if (lane < q) {  // no early return: all threads sync below
    adjoint_lane<kMoving, kSolids, kTex>(walk, sph, n_slots, sv, bg, st,
                                         keys, static_cast<size_t>(q), lane,
                                         d_out, out_bounce, k_steps,
                                         max_depth, rr_depth, t_min, d_in,
                                         out, g_bg, mismatches);
  }

  // Background: warp sums, then warps in order.
  const int warp_lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < kBgCols; ++j) {
    const float w = warp_sum(j < 6 ? g_bg[j] : 0.0f);
    if (warp_lane == 0) warp_part[warp][j] = w;
  }
  __syncthreads();
  if (tid < kBgCols) {
    float v = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) v += warp_part[w][tid];
    out[n_acc + tid] = v;
  }
}

}  // namespace

// The chain's backward on `stream`; returns cudaGetLastError() (0 on
// success). st: the chain's input state (16, q) f32; keys: (2, q) u32;
// sph: (24, n_slots) f32; the BVH as rrt_tile_render's, the one the
// forward walked; solids: the quad and box packs for the solid-family
// variant, or null, as rrt_bounce_steps'; bg: (8,) f32; d_out: (16, q)
// f32, the output state's cotangent; out_bounce: (q,) f32, the forward
// output's bounce row; moving: nonzero for the moving-sphere variant.
// Outputs: d_in (16, q) f32; scratch: (n_blocks + ceil(n_blocks / 64)) *
// n_cols f32 with n_blocks = ceil(q / 256) and n_cols = kSlotCols *
// (n_slots + n_quads + n_boxes) + 8; sums: (n_cols,) f32 (slot-major:
// kSlotCols floats a slot, a sphere's 12 (15 when moving) gradient rows
// then zeros, then the active quads' and boxes' columns (adjoint.cuh
// kQuadAccPlane ...); then 6 background rows, 2 pad); mismatches: one
// int32, zeroed by the caller; tex: the atlas for the texture variant,
// or null, its d_atlas (with images) the atlas cotangent, zeroed by the
// caller; rr_depth: the forward's Russian roulette (0: off).
extern "C" int rrt_chain_bwd(const float* st, const uint32_t* keys, int q,
                             const float* sph, int n_slots,
                             const float* nodes, const int* rows,
                             int n_nodes, int n_rows, int n_always,
                             const SolidArgs* solids, const TexArgs* tex,
                             const float* bg, const float* d_out, const float* out_bounce,
                             int k_steps, int max_depth, int rr_depth,
                             float t_min, int moving, float* d_in, float* scratch,
                             float* sums, int* mismatches, void* stream) {
  if (k_steps < 1 || k_steps > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SolidArgs none{nullptr, 0, 0, nullptr, 0, 0};
  const SolidArgs& sa = solids != nullptr ? *solids : none;
  const int n_cols = kSlotCols * (n_slots + sa.n_quads + sa.n_boxes) +
                     kBgCols;
  if (q == 0) {
    return static_cast<int>(
        cudaMemsetAsync(sums, 0, sizeof(float) * n_cols, s));
  }
  size_t smem = bvh_bytes(n_nodes, n_rows, moving != 0);
  if (solids) smem = aligned16(smem) + solid_bytes(sa.n_quads, sa.n_boxes);
  auto kernel = RRT_PICK3(chain_bwd_kernel, moving != 0, solids != nullptr,
                          tex != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (q + kThreads - 1) / kThreads;
  kernel<<<n_blocks, kThreads, smem, s>>>(
      st, keys, q, sph, n_slots, nodes, rows, n_nodes, n_rows, n_always,
      sa.quad, sa.quad_slots, sa.n_quads, sa.box, sa.box_slots, sa.n_boxes,
      tex_view(tex), bg, d_out, out_bounce, k_steps, max_depth, rr_depth, t_min,
      d_in, scratch, mismatches);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(scratch, n_blocks, n_cols, sums, s));
}
