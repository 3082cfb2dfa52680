// Tile-render kernel: the forward render of a sphere scene, every pixel's
// samples in one launch.
//
// Replaces rrt_tpu/ops/megakernel.py::_tile_render_kernel (launched by
// _render_tiles_launch) for the scenes rrt_tpu_torch renders: stationary
// and moving spheres, solid and checker textures, lambertian / metal /
// dielectric materials, sky or solid background, a thin-lens camera with
// a shutter, no Russian roulette. A scene with moving spheres launches
// the kMoving instantiation (bounce.cuh), which stages the velocity rows
// too and tests each slot's center at the ray's time.
// rrt_tpu_torch/ops/megakernel.py holds the wrapper (render_tiles), the
// packs' layouts and the plain PyTorch version (render_tiles_reference).
//
// What bounds it: arithmetic. Each bounce tests the ray against every
// sphere slot (about 25 FLOPs a slot, 512 slots on chap12), while the whole
// sphere pack is 24 x 512 x 4 B = 48 KB and stays on chip: the four
// intersection rows are staged in shared memory (8 KB on chap12), and the
// winner's shading rows are one cached load of column `win`. A pixel
// writes 16 bytes once. This first version makes no attempt at speed: one
// thread per pixel, a linear scan of all slots (no BVH, no culling), no
// ray sorting or regrouping of divergent paths.
//
// Design, against the TPU kernel:
//  * one thread per pixel in 16x16 blocks, so a warp's primary rays are
//    coherent; the thread traces its pixel's spp samples back to back
//    (the TPU lane's regenerate-on-death loop becomes a plain loop);
//  * sample s uses the key threefry2x32(s0, s1, gid, lo + s), the camera
//    draws counter 0 and the scatter draws counter bounce*8+1, word pair
//    p at pair*0x9E3779B9+pair: the same addressing as rrt_tpu.rng, so a
//    path's random numbers are bit-identical to the reference's;
//  * the closest hit is a strict `<` running minimum over the slots in
//    order, the first minimum winning like argmin; the winner's
//    attributes are a direct load, not the TPU's one-hot MXU select;
//  * radiance is summed per pixel in sample order, bounce by bounce, with
//    no atomics, so a run is deterministic.
// The bounce itself (Threefry, camera ray, closest-sphere scan, shading)
// lives in bounce.cuh, which the train kernels (train.cu) share.
// Floats: built with -fmad=false (ops/_build.py). The expanded sphere
// quadratic cancels catastrophically on the radius-1000 ground sphere,
// and contracting its mul+add pairs into FMAs changes where rays leaving
// a surface hit it again: with contraction the kernel traced 0.68% fewer
// rays than the plain version at chap12 240x160, 8 spp, depth 50; without
// it, 64x32 at 4 spp matched the plain version on every pixel and 240x160
// stayed within 0.13%, for 19% more kernel time at 1200x800, 32 spp
// (0.184 s -> 0.219 s; H100 80GB HBM3, 700 W power limit). sinf, logf and
// expf still differ from XLA's and PyTorch's by ulps, so results match
// the plain version within a tolerance, not bit for bit.

#include "bounce.cuh"

namespace {

template <bool kMoving>
__global__ void __launch_bounds__(256)
    tile_render_kernel(const float* __restrict__ sph, int n_slots,
                       const float* __restrict__ cam_g,
                       const float* __restrict__ bg_g, uint32_t s0,
                       uint32_t s1, uint32_t lo, int width, int height,
                       int spp, int max_depth, float t_min,
                       float* __restrict__ rad, int* __restrict__ traced) {
  extern __shared__ float4 sph4[];
  float4* vel4 = kMoving ? sph4 + n_slots : nullptr;
  __shared__ float cam[24];
  __shared__ float bg[8];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  render_pixel<false, kMoving>(sph, sph4, vel4, n_slots, cam, bg, s0, s1,
                               lo, px, py, width, width * height, spp,
                               max_depth, t_min, rad, traced, nullptr);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32 on the device;
// moving: nonzero for the moving-sphere variant; rad: (width*height, 3)
// f32 and traced: (width*height,) i32 outputs.
extern "C" int rrt_tile_render(const float* sph, int n_slots,
                               const float* cam, const float* bg, uint32_t s0,
                               uint32_t s1, uint32_t lo, int width, int height,
                               int spp, int max_depth, float t_min,
                               int moving, float* rad, int* traced,
                               void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const size_t smem = staged_bytes(n_slots, moving != 0);
  // MAX_SLOTS (3072) slots stage 48 KB (96 KB moving), which with the
  // static cam/bg arrays passes the 48 KB a block gets without the
  // opt-in.
  auto kernel = moving ? tile_render_kernel<true> : tile_render_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      sph, n_slots, cam, bg, s0, s1, lo, width, height, spp, max_depth, t_min,
      rad, traced);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
