// Train kernels: the differentiable tile render of a sphere scene.
//
// train_fwd replaces rrt_tpu/ops/megakernel_train.py::_train_fwd_kernel
// (launched by _fwd_launch), train_bwd replaces _train_bwd_kernel
// (launched by _bwd_launch), for the sphere subset of tile_render.cu,
// static and moving spheres (a kMoving instantiation of each, as
// tile_render's).
// rrt_tpu_torch/ops/megakernel_train.py holds the wrappers
// (render_tiles_train, tiles_adjoint, the autograd.Function
// TileTrainChain) and their plain PyTorch versions.
//
// train_fwd: one thread a pixel (16x16 blocks) traces its samples back
// to back through bounce.cuh's trace_pixel, tile_render's loop, with
// the closest-sphere scan where tile_render walks its BVH (the same
// winners and t bit for bit), so rad and traced are tile_render's bit
// for bit. It keeps the residual the backward needs:
//  * lengths[s * P + pixel], each path's executed bounce count (uint8);
//  * winners[j * P + pixel], the winning slot of the pixel's j-th
//    segment in trace order (int16, -1 on a miss), for j < win_cap
//    (the wrapper's WINNERS_PER_SAMPLE = 16 entries a sample, pooled
//    over the pixel's samples so that a long path borrows what short
//    ones leave); a segment past the pool is not stored.
// On the TPU the residual was the 24-row loop carry at segment
// boundaries; here a path restarts from its counter-addressed key, and
// the winners are what the backward would otherwise scan for.
//
// What bounds train_fwd: arithmetic, the closest-sphere scan over every
// slot (17 FP32 operations a slot test, 23 moving) for every segment;
// the residual is 2 bytes a segment and 1 a path. What the design does:
//  * back to back, a thread whose path ends starts its next sample at
//    once, so a warp waits for its slowest pixel's total rather than for
//    each sample's longest path; the scan's loop has the same trip count
//    on every lane, so lanes at different samples still run it together;
//  * each static slot's |c|^2 is computed once while staging
//    (center_sq), not once a slot a bounce: the same expression, so the
//    same bits; a moving slot's center changes with the ray's time;
//  * __launch_bounds__(256, kFwdMinBlocks) holds it to 64 registers and
//    4 blocks an SM, tile_render's occupancy (left to itself ptxas took
//    about 104 registers and 2 blocks).
//
// train_bwd: one thread a pixel (16x16 blocks). For each sample it
//  1. replays the path and keeps a record of each bounce in
//     thread-local storage: origin, direction, throughput, winner
//     (kMaxRecords records; max_depth + 1 may not exceed it), and what
//     its scatter draws decided that the adjoint reads (`kept`: a
//     metal's point in the unit sphere, a dielectric's reflection). A
//     segment with a stored winner recomputes only that slot's quadratic
//     (slot_t: the scan's arithmetic, so the scan's t bit for bit) and
//     shades as the forward did; a stored miss banks the background; a
//     segment past the pool runs the scan. Sample s's first entry is
//     the sum of the forward's lengths before it;
//  2. counts in `mismatches` the paths whose replayed length differs
//     from the forward's, and the stored winners that are no slot or
//     whose recomputed quadratic gives no root beyond t_min (those
//     segments then scan); expected 0: both kernels run the same code;
//  3. sweeps the records in reverse with the hand-written transpose of
//     megakernel_vjp.diff_step (adjoint.cuh, shared with chain.cu's
//     bounce-chain backward), seeded by d_rad[pixel]: each bounce's
//     intermediates are recomputed from the record, the winner's pack
//     column and what the replay kept of its draws, so the sweep draws
//     nothing (shade's kForAdjoint); the sweep ends in the adjoint of
//     camera_ray, into d_cam.
// With win_cap = 0 (tiles_adjoint(winners=None)) every segment scans,
// as the replay did before the residual. A sample's radiance enters its
// pixel's sum with weight 1, so unlike the TPU kernel there is no
// regenerate / flush adjoint.
//
// Gradients reach 12 sphere-pack rows (center xyz, r^2, aux, color1,
// color2, signed radius; with moving spheres also the velocity xyz,
// through the center at the ray's time), the camera pack (with moving
// spheres its shutter rows 19-20 too, through each ray's time) and the
// background's six colors. A bounce adds its winner's pack cotangents
// to its block's row of the partials in device memory, kSlotCols floats
// a slot, with four-float atomic reductions (add_slot); the camera and
// background cotangents take a fixed-order warp-shuffle reduction into
// the same row; reduce_blocks sums the rows in a fixed order of blocks.
//
// Determinism: d_cam and d_bg are bit-identical from run to run, and
// with or without the winners (the same replayed arithmetic). d_sph is
// not: the order of the atomics varies, so its sums may differ in the
// last bits from run to run.
//
// What bounds train_bwd: with the winners there is no scan but the
// unstored segments' (0.05% of chap12's at 8 spp); a segment costs its
// shading twice (the replay's, with its four Threefry calls and three
// Box-Muller pairs; the sweep's, without them) and the transpose, plus
// 52 bytes of local memory written and read. On an H100 the
// accumulation of the pack cotangents takes about 60% of the kernel:
// without it the backward ran in about 14 ms of 35 at chap12 1200x800,
// 8 spp, and every way tried to accumulate (shared-memory atomics, a
// float compare-and-swap loop there; warp sums over lanes that share a
// winner; a per-thread cache of two winners; staggered rows; reductions
// in device memory) cost about the same (PERF.md).

#include "adjoint.cuh"

namespace {

constexpr int kCamBgCols = 32;  // 24 camera rows, 6 background, 2 pad
constexpr int kBwdThreads = 256;  // a 16x16 block
// The forward's blocks a multiprocessor must hold: at 256 threads,
// 4 caps a thread at 64 registers, tile_render's occupancy.
constexpr int kFwdMinBlocks = 4;

// train_fwd's dynamic shared memory: staged_bytes, and with static
// spheres a float a slot for its center_sq, computed once while staging.
inline size_t fwd_smem(int n_slots, bool moving) {
  return staged_bytes(n_slots, moving) +
         (moving ? 0 : sizeof(float) * n_slots);
}

template <bool kMoving>
__global__ void __launch_bounds__(256, kFwdMinBlocks)
    train_fwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g, uint32_t s0,
                     uint32_t s1, uint32_t lo, int width, int height,
                     int spp, int max_depth, float t_min, int win_cap,
                     float* __restrict__ rad, int* __restrict__ traced,
                     uint8_t* __restrict__ lengths,
                     int16_t* __restrict__ winners) {
  // Dynamic shared memory (fwd_smem): the staged rows of every slot
  // (float4: intersection rows, then velocity rows when moving), then,
  // for static spheres, every slot's center_sq.
  constexpr bool kHoist = !kMoving;
  extern __shared__ float4 sph4[];
  float4* vel4 = kMoving ? sph4 + n_slots : nullptr;
  float* csq = kHoist ? reinterpret_cast<float*>(sph4 + n_slots) : nullptr;
  __shared__ float cam[24];
  __shared__ float bg[8];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  if (kHoist) stage_center_sq(sph, n_slots, csq);
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const SlotScan<kMoving, kHoist> scan{sph4, vel4, csq, n_slots};
  trace_pixel<kMoving, true>(scan, sph, n_slots, cam, bg, s0, s1, lo, px, py,
                             width, width * height, spp, max_depth, t_min,
                             win_cap, rad, traced, lengths, winners);
}

// Adjoint of camera_ray: the cotangents of the bounce-0 origin,
// direction and (with moving spheres) time into the camera pack's rows
// (g_cam, per thread).
template <bool kMoving>
__device__ __forceinline__ void camera_adjoint(const float* cam,
                                               const CamDraws& c, float pxf,
                                               float pyf, const float* go,
                                               const float* gd, float g_time,
                                               float* g_cam) {
  const float s = (pxf + c.jx) / cam[kCamW];
  const float t = ((cam[kCamHm1] - pyf) + c.jy) / cam[kCamH];
  const float rdx = cam[kCamLens] * c.dcx;
  const float rdy = cam[kCamLens] * c.dcy;
  float g_rdx = 0.0f, g_rdy = 0.0f, g_s = 0.0f, g_t = 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float g_o = go[j] - gd[j];  // d = ... - o
    g_cam[kCamOrigin + j] += g_o;
    g_cam[kCamU + j] += g_o * rdx;
    g_cam[kCamV + j] += g_o * rdy;
    g_rdx += g_o * cam[kCamU + j];
    g_rdy += g_o * cam[kCamV + j];
    g_cam[kCamLowerLeft + j] += gd[j];
    g_cam[kCamHorizontal + j] += gd[j] * s;
    g_cam[kCamVertical + j] += gd[j] * t;
    g_s += gd[j] * cam[kCamHorizontal + j];
    g_t += gd[j] * cam[kCamVertical + j];
  }
  g_cam[kCamLens] += g_rdx * c.dcx + g_rdy * c.dcy;
  g_cam[kCamW] += -g_s * s / cam[kCamW];
  g_cam[kCamHm1] += g_t / cam[kCamH];
  g_cam[kCamH] += -g_t * t / cam[kCamH];
  if (kMoving) {  // time = time0 + dt * u
    g_cam[kCamTime0] += g_time;
    g_cam[kCamDt] += g_time * c.tu;
  }
}

// A winner entry that holds nothing: the segment is past the pixel's
// pool, or past its path's forward length.
constexpr int kUnstored = -2;

// One bounce of the backward's replay: the forward's winner when it was
// stored (-1: the forward missed), recomputed alone (slot_t), otherwise
// the scan. A stored winner that is no slot, or gives no root beyond
// t_min, counts in `bad`, and the bounce scans instead. `win` gets the
// winner (-1 on a miss). Returns the Outcome, as bounce_step.
template <bool kMoving>
__device__ __forceinline__ int replay_step(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const float* bg, bool sky, uint32_t k0, uint32_t k1, int bounce,
    int max_depth, float t_min, int stored, Path& p, int& win, int& bad,
    float* kept) {
  const RayDots q = ray_dots(p.ray);
  float t_best = kInf;
  win = stored;
  if (stored >= n_slots) {
    ++bad;
    stored = kUnstored;
  }
  if (stored >= 0) {
    t_best = slot_t<kMoving>(sph4, vel4, stored, p.ray, q, t_min);
    if (!(t_best < kInf)) {
      ++bad;
      stored = kUnstored;
    }
  }
  if (stored == kUnstored) {
    t_best =
        closest_sphere<kMoving>(sph4, vel4, n_slots, p.ray, q, t_min, win);
  }
  float c[3];
  return finish_bounce<kMoving>(sph, n_slots, bg, sky, k0, k1, bounce,
                                max_depth, q, t_best, p, c, win, kept);
}

// The backward of one pixel's samples [lo, lo + spp): pack cotangents
// into `acc` (the block's row of the partials, kSlotCols floats a slot),
// camera and background ones into g_cam / g_bg.
template <bool kMoving>
__device__ __forceinline__ void adjoint_pixel(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const float* cam, const float* bg, uint32_t s0, uint32_t s1,
    uint32_t lo, int px, int py, int width, int n_pix, int spp,
    int max_depth, float t_min, const float* d_rad, const uint8_t* lengths,
    const int16_t* winners, int win_cap, float* acc, float* g_cam,
    float* g_bg, int* mismatches) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  const bool sky = bg[6] < 0.5f;
  const float dr[3] = {d_rad[3 * gid], d_rad[3 * gid + 1],
                       d_rad[3 * gid + 2]};
  Record rec[kMaxRecords];
  float kept[kMaxRecords][3];  // what each bounce's draws decided (shade)
  int first = 0;  // the sample's first winner entry
  int bad = 0;
  for (int s = 0; s < spp; ++s) {
    uint32_t k0, k1;
    Path p;
    const CamDraws cd = start_path(cam, s0, s1, gid,
                                   lo + static_cast<uint32_t>(s), px, py,
                                   k0, k1, p);
    const int length = lengths[static_cast<size_t>(s) * n_pix + gid];

    // 1. replay, keeping each bounce's input state and winner.
    int n = 0, last = kAbsorbed;
    for (int bounce = 0; bounce <= max_depth; ++bounce) {
      Record& r = rec[n++];
      r.o[0] = p.ray.ox; r.o[1] = p.ray.oy; r.o[2] = p.ray.oz;
      r.d[0] = p.ray.dx; r.d[1] = p.ray.dy; r.d[2] = p.ray.dz;
      r.thr[0] = p.thr[0]; r.thr[1] = p.thr[1]; r.thr[2] = p.thr[2];
      const int j = first + bounce;
      const int stored =
          bounce < length && j < win_cap
              ? winners[static_cast<size_t>(j) * n_pix + gid]
              : kUnstored;
      last = replay_step<kMoving>(sph, sph4, vel4, n_slots, bg, sky, k0, k1,
                                  bounce, max_depth, t_min, stored, p, r.win,
                                  bad, kept[n - 1]);
      if (last != kScattered) break;
    }
    first += length;
    // 2. the replay must retrace the forward's path.
    if (n != length) ++bad;
    // 3. reverse sweep. The last record ended the path: a miss banks
    // the background, a surface that absorbs or ends the depth banks 0.
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f},
          gt[3] = {0.0f, 0.0f, 0.0f}, g_time = 0.0f;
    if (last == kMissed) miss_adjoint(rec[n - 1], dr, bg, sky, gd, gt, g_bg);
    for (int k = n - 2; k >= 0; --k) {
      RowSums<grad_rows(kMoving)> sums;
      scatter_adjoint<kMoving, decltype(sums), true>(
          sph, n_slots, rec[k], k0, k1, k, t_min, p.ray.time, go, gd, gt,
          sums, g_time, kept[k]);
      add_slot<grad_rows(kMoving)>(acc + rec[k].win * kSlotCols, sums.g);
    }
    camera_adjoint<kMoving>(cam, cd, static_cast<float>(px),
                            static_cast<float>(py), go, gd, g_time, g_cam);
  }
  if (bad != 0) atomicAdd(mismatches, bad);
}

template <bool kMoving>
__global__ void __launch_bounds__(kBwdThreads)
    train_bwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g,
                     const float* __restrict__ d_rad,
                     const uint8_t* __restrict__ lengths,
                     const int16_t* __restrict__ winners, int win_cap,
                     uint32_t s0, uint32_t s1, uint32_t lo, int width,
                     int height, int spp, int max_depth, float t_min,
                     float* __restrict__ partials,
                     int* __restrict__ mismatches) {
  // Dynamic shared memory (staged_bytes): the staged rows of every slot
  // (float4: intersection rows, then velocity rows when moving). The
  // pack cotangents go to this block's row of the partials, zeroed here.
  extern __shared__ float4 smem[];
  float4* sph4 = smem;
  float4* vel4 = kMoving ? smem + n_slots : nullptr;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_acc = kSlotCols * n_slots;
  float* out = partials + block * (static_cast<size_t>(n_acc) + kCamBgCols);
  __shared__ float cam[24];
  __shared__ float bg[8];
  __shared__ float warp_part[kBwdThreads / 32][kCamBgCols];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_acc; i += kBwdThreads) out[i] = 0.0f;
  __syncthreads();

  float g_cam[24], g_bg[6];
  for (int j = 0; j < 24; ++j) g_cam[j] = 0.0f;
  for (int j = 0; j < 6; ++j) g_bg[j] = 0.0f;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) {  // no early return: all sync below
    adjoint_pixel<kMoving>(sph, sph4, vel4, n_slots, cam, bg, s0, s1, lo,
                           px, py, width, width * height, spp, max_depth,
                           t_min, d_rad, lengths, winners, win_cap, out,
                           g_cam, g_bg, mismatches);
  }

  // Camera and background: warp sums, then warps in order.
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < kCamBgCols; ++j) {
    const float v = j < 24 ? g_cam[j] : (j < 30 ? g_bg[j - 24] : 0.0f);
    const float w = warp_sum(v);
    if (lane == 0) warp_part[warp][j] = w;
  }
  __syncthreads();
  if (tid < kCamBgCols) {
    float v = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) v += warp_part[w][tid];
    out[n_acc + tid] = v;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32 on the device;
// moving: nonzero for the moving-sphere variant; outputs rad:
// (width*height, 3) f32, traced: (width*height,) i32, lengths: (spp,
// width*height) uint8, winners: (win_cap, width*height) int16 (the
// entries past a pixel's segments are left as they were).
extern "C" int rrt_train_fwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, uint32_t s0, uint32_t s1,
                             uint32_t lo, int width, int height, int spp,
                             int max_depth, float t_min, int moving,
                             int win_cap, float* rad, int* traced,
                             uint8_t* lengths, int16_t* winners,
                             void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const size_t smem = fwd_smem(n_slots, moving != 0);
  // As tile_render: 3072 slots need the opt-in above 48 KB.
  auto kernel = moving ? train_fwd_kernel<true> : train_fwd_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_slots, cam, bg, s0, s1, lo, width, height, spp, max_depth, t_min,
      win_cap, rad, traced, lengths, winners);
  return static_cast<int>(cudaGetLastError());
}

// The backward: train_bwd_kernel, then two fixed-order reductions of its
// per-block partials. d_rad: (width*height, 3) f32; lengths and winners
// as written by rrt_train_fwd with the same win_cap (win_cap 0: no
// winners, every segment scans; winners may be null); scratch: (n_blocks
// + ceil(n_blocks / 64)) * n_cols f32 with n_blocks = ceil(width/16) *
// ceil(height/16) and n_cols = kSlotCols * n_slots + 32; sums: (n_cols,)
// f32 out (slot-major: kSlotCols floats a slot, its 12 (15 when moving)
// gradient rows then zeros; then 24 camera rows, 6 background, 2 pad);
// mismatches: one int32, zeroed by the caller.
extern "C" int rrt_train_bwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, const float* d_rad,
                             const uint8_t* lengths, const int16_t* winners,
                             int win_cap, uint32_t s0, uint32_t s1,
                             uint32_t lo, int width, int height, int spp,
                             int max_depth, float t_min, int moving,
                             float* scratch, float* sums, int* mismatches,
                             void* stream) {
  if (max_depth + 1 > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const int n_blocks = static_cast<int>(grid.x * grid.y);
  const int n_cols = kSlotCols * n_slots + kCamBgCols;
  const size_t smem = staged_bytes(n_slots, moving != 0);
  auto kernel = moving ? train_bwd_kernel<true> : train_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, st>>>(
      sph, n_slots, cam, bg, d_rad, lengths, winners, win_cap, s0, s1, lo,
      width, height, spp, max_depth, t_min, scratch, mismatches);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce_partials(scratch, n_blocks, n_cols, sums, st));
}
