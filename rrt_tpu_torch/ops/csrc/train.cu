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
// train_fwd: tile_render's kernel (bounce.cuh render_pixel) with the
// residual switched on: each (sample, pixel) path's executed bounce
// count, one uint8, lengths[s * P + pixel]. Radiance and traced counts
// are tile_render's bit for bit. On the TPU the residual was the 24-row
// loop carry at segment boundaries, because one lane ran many pixels'
// samples in one loop; here a thread owns a pixel and a path restarts
// from its counter-addressed key, so nothing else is parked.
//
// train_bwd: one thread per pixel (16x16 blocks). For each sample it
//  1. replays the path through the same bounce.cuh code (so the same
//     decisions, bit for bit) and keeps a record of each bounce in
//     thread-local storage: origin, direction, throughput, winner
//     (kMaxRecords records; max_depth + 1 may not exceed it);
//  2. counts in `mismatches` the paths whose replayed length differs
//     from the forward's (expected 0: both kernels run the same code);
//  3. sweeps the records in reverse with the hand-written transpose of
//     megakernel_vjp.diff_step (adjoint.cuh, shared with chain.cu's
//     bounce-chain backward), seeded by d_rad[pixel]: each bounce's
//     forward intermediates are recomputed from the record and the
//     winner's pack column (shade() again, the same arithmetic), the
//     random draws re-derived from the key; the sweep ends in the
//     adjoint of camera_ray, into d_cam.
// A sample's radiance enters its pixel's sum with weight 1, so unlike
// the TPU kernel there is no regenerate / flush adjoint.
//
// Gradients reach 12 sphere-pack rows (center xyz, r^2, aux, color1,
// color2, signed radius; with moving spheres also the velocity xyz,
// through the center at the ray's time), the camera pack (with moving
// spheres its shutter rows 19-20 too, through each ray's time) and the
// background's six colors. Each block accumulates its pack cotangents
// in shared memory (12 rows x S slots, beside the 4-row staging: 64 B a
// slot, so the 3072-slot maximum takes 192 KB through the opt-in above
// 48 KB; 15 rows and 8 rows of staging with moving spheres, 92 B a slot,
// at most MAX_SLOTS_MOVING = 2048 slots) with
// shared-memory atomics, and its camera and background cotangents by
// a fixed-order warp-shuffle reduction; it writes them as per-block
// partials, which reduce_blocks sums in a fixed order of blocks.
//
// Determinism: d_cam and d_bg are bit-identical from run to run. d_sph
// is not: the order of shared-memory atomics within a block varies, so
// its sums may differ in the last bits from run to run (about half of
// chap12's hits land on the ground sphere's one column).
//
// What bounds it: the replay is a full forward (the closest-sphere scan
// over every slot dominates); the reverse sweep touches only the winner
// and costs about a bounce's shading per record, plus 40 bytes of local
// memory written and read per bounce and the shared atomics, which
// serialise on the ground sphere's column. This first version is a
// simple one: no attempt at speed.

#include "adjoint.cuh"

namespace {

constexpr int kCamBgCols = 32;  // 24 camera rows, 6 background, 2 pad

template <bool kMoving>
__global__ void __launch_bounds__(256)
    train_fwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g, uint32_t s0,
                     uint32_t s1, uint32_t lo, int width, int height,
                     int spp, int max_depth, float t_min,
                     float* __restrict__ rad, int* __restrict__ traced,
                     uint8_t* __restrict__ lengths) {
  extern __shared__ float4 sph4[];
  float4* vel4 = kMoving ? sph4 + n_slots : nullptr;
  __shared__ float cam[24];
  __shared__ float bg[8];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  render_pixel<true, kMoving>(sph, sph4, vel4, n_slots, cam, bg, s0, s1, lo,
                              px, py, width, width * height, spp, max_depth,
                              t_min, rad, traced, lengths);
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

// The backward of one pixel's samples [lo, lo + spp): pack cotangents
// into `acc` (shared), camera and background ones into g_cam / g_bg.
template <bool kMoving>
__device__ __forceinline__ void adjoint_pixel(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const float* cam,
    const float* bg, uint32_t s0, uint32_t s1, uint32_t lo, int px, int py,
    int width, int n_pix, int spp, int max_depth, float t_min,
    const float* d_rad, const uint8_t* lengths, float* acc, float* g_cam,
    float* g_bg, int* mismatches) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  const bool sky = bg[6] < 0.5f;
  const float dr[3] = {d_rad[3 * gid], d_rad[3 * gid + 1],
                       d_rad[3 * gid + 2]};
  Record rec[kMaxRecords];
  for (int s = 0; s < spp; ++s) {
    uint32_t k0, k1;
    threefry2x32(s0, s1, gid, lo + static_cast<uint32_t>(s), k0, k1);
    const CamDraws cd = camera_draws(k0, k1);
    Path p;
    p.ray = camera_ray(cam, cd, static_cast<float>(px),
                       static_cast<float>(py));
    p.thr[0] = p.thr[1] = p.thr[2] = 1.0f;

    // 1. replay, keeping each bounce's input state and winner.
    int n = 0, last = kAbsorbed;
    for (int bounce = 0; bounce <= max_depth; ++bounce) {
      Record& r = rec[n++];
      r.o[0] = p.ray.ox; r.o[1] = p.ray.oy; r.o[2] = p.ray.oz;
      r.d[0] = p.ray.dx; r.d[1] = p.ray.dy; r.d[2] = p.ray.dz;
      r.thr[0] = p.thr[0]; r.thr[1] = p.thr[1]; r.thr[2] = p.thr[2];
      float c[3];
      last = bounce_step<kMoving>(sph, sph4, vel4, n_slots, bg, sky, k0,
                                  k1, bounce, max_depth, t_min, p, c, r.win);
      if (last != kScattered) break;
    }
    // 2. the replay must retrace the forward's path.
    if (n != lengths[static_cast<size_t>(s) * n_pix + gid]) {
      atomicAdd(mismatches, 1);
    }
    // 3. reverse sweep. The last record ended the path: a miss banks
    // the background, a surface that absorbs or ends the depth banks 0.
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f},
          gt[3] = {0.0f, 0.0f, 0.0f}, g_time = 0.0f;
    if (last == kMissed) miss_adjoint(rec[n - 1], dr, bg, sky, gd, gt, g_bg);
    for (int k = n - 2; k >= 0; --k) {
      scatter_adjoint<kMoving>(sph, n_slots, rec[k], k0, k1, k, t_min,
                               p.ray.time, go, gd, gt, acc, g_time);
    }
    camera_adjoint<kMoving>(cam, cd, static_cast<float>(px),
                            static_cast<float>(py), go, gd, g_time, g_cam);
  }
}

template <bool kMoving>
__global__ void __launch_bounds__(256)
    train_bwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g,
                     const float* __restrict__ d_rad,
                     const uint8_t* __restrict__ lengths, uint32_t s0,
                     uint32_t s1, uint32_t lo, int width, int height,
                     int spp, int max_depth, float t_min,
                     float* __restrict__ partials,
                     int* __restrict__ mismatches) {
  // Dynamic shared memory (adjoint_smem): the staged rows of every slot
  // (float4: intersection rows, then velocity rows when moving), then
  // the gradient rows of every slot.
  extern __shared__ float4 smem[];
  float4* sph4 = smem;
  float4* vel4 = kMoving ? smem + n_slots : nullptr;
  float* acc = reinterpret_cast<float*>(smem + (kMoving ? 2 : 1) * n_slots);
  __shared__ float cam[24];
  __shared__ float bg[8];
  __shared__ float warp_part[8][kCamBgCols];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_acc = grad_rows(kMoving) * n_slots;
  for (int i = tid; i < n_acc; i += blockDim.x * blockDim.y) acc[i] = 0.0f;
  __syncthreads();

  float g_cam[24], g_bg[6];
  for (int j = 0; j < 24; ++j) g_cam[j] = 0.0f;
  for (int j = 0; j < 6; ++j) g_bg[j] = 0.0f;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) {  // no early return: all sync below
    adjoint_pixel<kMoving>(sph, sph4, vel4, n_slots, cam, bg, s0, s1, lo,
                           px, py, width, width * height, spp, max_depth,
                           t_min, d_rad, lengths, acc, g_cam, g_bg,
                           mismatches);
  }

  // Camera and background: warp sums, then warps in order.
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < kCamBgCols; ++j) {
    const float v = j < 24 ? g_cam[j] : (j < 30 ? g_bg[j - 24] : 0.0f);
    const float w = warp_sum(v);
    if (lane == 0) warp_part[warp][j] = w;
  }
  __syncthreads();
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t n_cols = static_cast<size_t>(n_acc) + kCamBgCols;
  float* out = partials + block * n_cols;
  const int n_warps = (blockDim.x * blockDim.y) >> 5;
  if (tid < kCamBgCols) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += warp_part[w][tid];
    out[n_acc + tid] = v;
  }
  for (int i = tid; i < n_acc; i += blockDim.x * blockDim.y) out[i] = acc[i];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32 on the device;
// moving: nonzero for the moving-sphere variant; outputs rad:
// (width*height, 3) f32, traced: (width*height,) i32, lengths: (spp,
// width*height) uint8.
extern "C" int rrt_train_fwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, uint32_t s0, uint32_t s1,
                             uint32_t lo, int width, int height, int spp,
                             int max_depth, float t_min, int moving,
                             float* rad, int* traced, uint8_t* lengths,
                             void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const size_t smem = staged_bytes(n_slots, moving != 0);
  // As tile_render: 3072 slots need the opt-in above 48 KB.
  auto kernel = moving ? train_fwd_kernel<true> : train_fwd_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_slots, cam, bg, s0, s1, lo, width, height, spp, max_depth, t_min,
      rad, traced, lengths);
  return static_cast<int>(cudaGetLastError());
}

// The backward: train_bwd_kernel, then two fixed-order reductions of its
// per-block partials. d_rad: (width*height, 3) f32; lengths as written
// by rrt_train_fwd; scratch: (n_blocks + ceil(n_blocks / 64)) * n_cols
// f32 with n_blocks = ceil(width/16) * ceil(height/16) and n_cols =
// R * n_slots + 32, R = 12 (15 when moving); sums: (n_cols,) f32 out (R
// pack rows x n_slots, then 24 camera rows, 6 background, 2 pad);
// mismatches: one int32, zeroed by the caller.
extern "C" int rrt_train_bwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, const float* d_rad,
                             const uint8_t* lengths, uint32_t s0,
                             uint32_t s1, uint32_t lo, int width, int height,
                             int spp, int max_depth, float t_min, int moving,
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
  const int n_cols = grad_rows(moving != 0) * n_slots + kCamBgCols;
  const size_t smem = adjoint_smem(n_slots, moving != 0);
  auto kernel = moving ? train_bwd_kernel<true> : train_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, st>>>(
      sph, n_slots, cam, bg, d_rad, lengths, s0, s1, lo, width, height, spp,
      max_depth, t_min, scratch, mismatches);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce_partials(scratch, n_blocks, n_cols, sums, st));
}
