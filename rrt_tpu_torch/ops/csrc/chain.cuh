// The bounce chain's backward kernel (chain.cu holds its note and its
// entry point): the kernel and its launch as templates, included by
// chain.cu, which instantiates the loops' variants, and by chain_walk.cu,
// which instantiates the kWalk ones. Two files, so that nvcc builds them
// side by side (ops/_build.py starts one nvcc a source).

#pragma once

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
template <bool kMoving, bool kSolids, bool kTex, bool kWalk>
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
    last = bounce_step<kMoving, kSolids, kTex, kWalk>(
        walk, sph, n_slots, bg, sky, k0, k1, bounce0 + k, max_depth,
        rr_depth, t_min, p, c, r.win, kept[k], &sv);
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

// The kWalk instantiations' blocks an SM (__launch_bounds__; 0, the
// loops' instantiations, leaves ptxas its own choice). At 2 the (moving,
// solids, tex, walk) variant took 128 registers and spilled 232 bytes
// (213 registers and no spill at 1), and rttnw_final's three chains ran
// 4% slower (4.78-4.82 against 4.59-4.61 ms in turns on an H100 80GB
// HBM3 at 700 W; PERF.md). An explicit 1 on the loops' instantiations
// changed their registers (the static one 80 -> 102) and moved chap12's
// first chain by +11%, its last by -2%.
constexpr int kChainWalkBlocks = 1;

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
__global__ void __launch_bounds__(kThreads, kWalk ? kChainWalkBlocks : 0)
    chain_bwd_kernel(const float* __restrict__ st,
                     const uint32_t* __restrict__ keys, int q,
                     const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ nodes_g,
                     const int* __restrict__ rows_g, int n_nodes, int n_rows,
                     int n_always, const SolidArgs sa, TexView tex,
                     const float* __restrict__ bg_g,
                     const float* __restrict__ d_out,
                     const float* __restrict__ out_bounce, int k_steps,
                     int max_depth, int rr_depth, float t_min,
                     float* __restrict__ d_in,
                     float* __restrict__ partials,
                     int* __restrict__ mismatches) {
  // Dynamic shared memory (forward_smem): the staged BVH, then with
  // kSolids the solid families and with kWalk their trees, as
  // bounce_steps_kernel stages them. The pack cotangents go to this
  // block's row of the partials, zeroed here.
  extern __shared__ float4 smem[];
  __shared__ float bg[8];
  __shared__ float warp_part[kThreads / 32][kBgCols];
  const BvhWalk<kMoving> walk{stage_bvh<kMoving>(
      sph, n_slots, nodes_g, rows_g, n_nodes, n_rows, n_always, smem)};
  Solids sv{};
  if constexpr (kSolids) {
    sv = stage_solids_of<kWalk>(
        sa, smem + aligned16(bvh_bytes(n_nodes, n_rows, kMoving)) /
                       sizeof(float4));
  }
  sv.tex = tex;
  const int tid = threadIdx.x;
  if (tid < 8) bg[tid] = bg_g[tid];
  const int n_acc =
      kSlotCols * (kSolids ? n_slots + sa.n_quads + sa.n_boxes : n_slots);
  float* out =
      partials + blockIdx.x * (static_cast<size_t>(n_acc) + kBgCols);
  for (int i = tid; i < n_acc; i += kThreads) out[i] = 0.0f;
  __syncthreads();

  float g_bg[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int lane = blockIdx.x * blockDim.x + tid;
  if (lane < q) {  // no early return: all threads sync below
    adjoint_lane<kMoving, kSolids, kTex, kWalk>(
        walk, sph, n_slots, sv, bg, st, keys, static_cast<size_t>(q), lane,
        d_out, out_bounce, k_steps, max_depth, rr_depth, t_min, d_in, out,
        g_bg, mismatches);
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

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
int launch_chain_bwd(cudaStream_t s, const float* st, const uint32_t* keys,
                     int q, const float* sph, int n_slots,
                     const float* nodes, const int* rows, int n_nodes,
                     int n_rows, int n_always, const SolidArgs* solids,
                     TexView tex, const float* bg, const float* d_out,
                     const float* out_bounce, int k_steps, int max_depth,
                     int rr_depth, float t_min, float* d_in,
                     float* partials, int* mismatches) {
  auto kernel = chain_bwd_kernel<kMoving, kSolids, kTex, kWalk>;
  size_t smem;
  const int err = forward_smem(kernel, bvh_bytes(n_nodes, n_rows, kMoving),
                               solids, smem);
  if (err != 0) return err;
  const SolidArgs none{};
  const int n_blocks = (q + kThreads - 1) / kThreads;
  kernel<<<n_blocks, kThreads, smem, s>>>(
      st, keys, q, sph, n_slots, nodes, rows, n_nodes, n_rows, n_always,
      solids != nullptr ? *solids : none, tex, bg, d_out, out_bounce,
      k_steps, max_depth, rr_depth, t_min, d_in, partials, mismatches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kWalk instantiations' launch (chain_walk.cu): launch_chain_bwd<moving,
// true, tex, true>; returns a cudaError_t (0 on success).
int chain_bwd_walk(bool moving, bool tex, cudaStream_t s, const float* st,
                   const uint32_t* keys, int q, const float* sph, int n_slots,
                   const float* nodes, const int* rows, int n_nodes,
                   int n_rows, int n_always, const SolidArgs* solids,
                   TexView tv, const float* bg, const float* d_out,
                   const float* out_bounce, int k_steps, int max_depth,
                   int rr_depth, float t_min, float* d_in, float* partials,
                   int* mismatches);
