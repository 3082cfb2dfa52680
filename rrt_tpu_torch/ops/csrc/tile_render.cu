// Tile-render kernel: the forward render of a scene, every pixel's
// samples in one launch.
//
// Replaces rrt_tpu/ops/megakernel.py::_tile_render_kernel (launched by
// _render_tiles_launch) for the scenes rrt_tpu_torch renders: stationary
// and moving spheres, quads, boxes and constant media, solid, checker,
// perlin-marble and image textures, lambertian / metal / dielectric / diffuse_light / isotropic
// materials, sky or solid background, a thin-lens camera with a shutter,
// and Russian roulette from bounce rr_depth (a runtime argument, 0 off:
// bounce.cuh finish_bounce). A
// scene with moving spheres launches the kMoving instantiation
// (bounce.cuh), which stages the velocity rows too and tests each slot's
// center at the ray's time; a scene with quads, boxes or a light the
// kSolids one, which stages the active quads' plane frames and boxes'
// rows after the BVH (stage_solids) and tests them before the walk,
// seeding it (the Cornell box: six quads, two boxes, no sphere), then
// the media against the closest solid's t, their rows read from the
// medium pack in device memory (cornell_smoke: six quads, two media);
// a scene with perlin or image textures the kTex one (simple_light:
// kSolids and kTex; earth: kTex alone), which shades them (bounce.cuh);
// a scene whose quads or boxes have a tree (SolidArgs' trees, past
// kSolidCap of a family) the kWalk one, which walks it (rttnw_final:
// kMoving, kSolids, kTex and kWalk; its 400 ground boxes' tree and rows
// staged after the spheres' BVH, 80 KB, so 2 blocks an SM).
// rrt_tpu_torch/ops/megakernel.py holds the wrapper (render_tiles), the
// packs' layouts and the plain PyTorch version (render_tiles_reference).
//
// What bounds it: arithmetic, the closest-sphere test of every segment,
// while the whole sphere pack is 24 x 512 x 4 B = 48 KB and stays on
// chip, and a pixel writes 16 bytes once. A linear scan tests every
// slot (17 FP32 operations a slot, 23 moving, 512 slots on chap12);
// this kernel walks a BVH instead (bounce.cuh closest_sphere_bvh, built
// by rrt_tpu_torch/accel.py's pack_bvh), whose padded boxes make its
// (t, winner) the scan's bit for bit, so it renders the paths of
// train_fwd, which scans.
//
// Design, against the TPU kernel:
//  * one thread per pixel in 16x16 blocks, so a warp's primary rays are
//    coherent; the thread traces its pixel's spp samples back to back
//    (bounce.cuh trace_pixel, train_fwd's loop: the TPU lane's
//    regenerate-on-death loop), so a warp waits for its slowest pixel's
//    total, not for each sample's longest path;
//  * the BVH's nodes and its rows in walk order (center and r^2, each
//    static slot's |c|^2 staged once, the velocity rows when moving)
//    sit in dynamic shared memory; a thread walks them with a stack of
//    far children, near child first, after testing the few slots too
//    large to box usefully (chap12's ground sphere); rrt_tpu's kernel
//    culled whole tiles of slots by their boxes instead, the TPU's
//    answer to the reference's BVH walk;
//  * __launch_bounds__(256, 4): 64 registers, 4 blocks an SM; the kWalk
//    instantiations (256, kWalkBlocks): their staged trees leave room
//    for 2 blocks on rttnw_final, and a cap of 64 registers only spilled;
//  * sample s uses the key threefry2x32(s0, s1, gid, lo + s), the camera
//    draws counter 0 and the scatter draws counter bounce*8+1, word pair
//    p at pair*0x9E3779B9+pair: the same addressing as rrt_tpu.rng, so a
//    path's random numbers are bit-identical to the reference's;
//  * the closest hit is the first minimum over the slots in slot order,
//    like argmin; the winner's attributes are a direct load, not the
//    TPU's one-hot MXU select;
//  * radiance is summed per pixel in sample order, bounce by bounce, with
//    no atomics, so a run is deterministic.
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

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
__global__ void __launch_bounds__(256, kWalk ? kWalkBlocks : 4)
    tile_render_kernel(const float* __restrict__ sph, int n_slots,
                       const float* __restrict__ cam_g,
                       const float* __restrict__ bg_g,
                       const float* __restrict__ nodes_g,
                       const int* __restrict__ rows_g, int n_nodes,
                       int n_rows, int n_always, const SolidArgs sa,
                       TexView tex, uint32_t s0, uint32_t s1,
                       uint32_t lo, int width, int row_lo, int row_hi,
                       int spp, int max_depth, int rr_depth, float t_min,
                       float* __restrict__ rad, int* __restrict__ traced) {
  extern __shared__ float4 smem[];
  __shared__ float cam[24];
  __shared__ float bg[8];
  const BvhWalk<kMoving> walk{stage_bvh<kMoving>(
      sph, n_slots, nodes_g, rows_g, n_nodes, n_rows, n_always, smem)};
  Solids sv{};
  if constexpr (kSolids) {
    sv = stage_solids_of<kWalk>(
        sa, smem + aligned16(bvh_bytes(n_nodes, n_rows, kMoving)) /
                       sizeof(float4));
  }
  sv.tex = tex;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 24) cam[tid] = cam_g[tid];
  if (tid < 8) bg[tid] = bg_g[tid];
  __syncthreads();

  // The grid covers the rows [row_lo, row_hi); a pixel's key is its id
  // in the whole image, its output slot its id in the band.
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = row_lo + static_cast<int>(blockIdx.y * blockDim.y +
                                           threadIdx.y);
  if (px >= width || py >= row_hi) return;
  trace_pixel<kMoving, false, kSolids, kTex, kWalk>(
      walk, sph, n_slots, cam, bg, s0, s1, lo, px, py, width, row_lo,
      width * (row_hi - row_lo), spp, max_depth, rr_depth, t_min, 0, rad,
      traced, nullptr, nullptr, &sv);
}

constexpr int kThreads = 256;  // a 16x16 block

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
int launch(dim3 grid, dim3 block, cudaStream_t stream, const float* sph,
           int n_slots, const float* cam, const float* bg,
           const float* nodes, const int* rows, int n_nodes, int n_rows,
           int n_always, const SolidArgs* solids, TexView tex, uint32_t s0,
           uint32_t s1, uint32_t lo, int width, int row_lo, int row_hi,
           int spp, int max_depth, int rr_depth, float t_min, float* rad,
           int* traced) {
  // Past 48 KB only after the opt-in; accel.pack_bvh keeps a pack within
  // what the card allows.
  auto kernel = tile_render_kernel<kMoving, kSolids, kTex, kWalk>;
  size_t smem;
  const int err = forward_smem(kernel, bvh_bytes(n_nodes, n_rows, kMoving),
                               solids, smem);
  if (err != 0) return err;
  const SolidArgs none{};
  kernel<<<grid, block, smem, stream>>>(
      sph, n_slots, cam, bg, nodes, rows, n_nodes, n_rows, n_always,
      solids != nullptr ? *solids : none, tex, s0, s1, lo, width, row_lo,
      row_hi, spp, max_depth, rr_depth, t_min, rad, traced);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32, and the BVH
// (accel.BvhPack): nodes (n_nodes, 8) f32, rows (n_rows,) i32 of which
// the first n_always are tested by every segment, all on the device;
// moving: nonzero for the moving-sphere variant; solids: the quad and box
// packs, their trees and the medium pack for the solid-family variant, or
// null; tex: the atlas for the texture variant, or null; rr_depth:
// Russian roulette's first bounce (0: off); the rows [row_lo, row_hi)
// of a width-wide image are rendered (0 <= row_lo < row_hi <= the
// image's height, checked by the wrapper), each pixel keyed by its id
// in the whole image: rad: ((row_hi-row_lo)*width, 3) f32 and traced:
// ((row_hi-row_lo)*width,) i32 outputs, the band's pixels in scan-line
// order.
extern "C" int rrt_tile_render(const float* sph, int n_slots,
                               const float* cam, const float* bg,
                               const float* nodes, const int* rows,
                               int n_nodes, int n_rows, int n_always,
                               const SolidArgs* solids,
                               const TexArgs* tex, uint32_t s0,
                               uint32_t s1, uint32_t lo, int width,
                               int row_lo, int row_hi, int spp,
                               int max_depth, int rr_depth, float t_min,
                               int moving, float* rad,
                               int* traced, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (row_hi - row_lo + block.y - 1) / block.y);
  const auto st = static_cast<cudaStream_t>(stream);
  auto go = has_tree(solids)
                 ? RRT_PICK_WALK(launch, moving != 0, tex != nullptr)
                 : RRT_PICK3(launch, moving != 0, solids != nullptr,
                             tex != nullptr);
  return go(grid, block, st, sph, n_slots, cam, bg, nodes, rows, n_nodes,
            n_rows, n_always, solids, tex_view(tex), s0, s1, lo, width,
            row_lo, row_hi, spp, max_depth, rr_depth, t_min, rad, traced);
}

// The blocks an SM of the instantiation rrt_tile_render would launch for
// a BVH of n_nodes nodes and n_rows rows, `solids` (or null) and a
// texture variant (tex nonzero), at the shared memory it would take:
// blocks and the bytes. Returns a cudaError_t.
extern "C" int rrt_tile_render_blocks(int n_nodes, int n_rows, int moving,
                                      const SolidArgs* solids, int tex,
                                      int* blocks, long long* smem) {
  auto kernel = has_tree(solids)
                    ? RRT_PICK_WALK(tile_render_kernel, moving != 0, tex != 0)
                    : RRT_PICK3(tile_render_kernel, moving != 0,
                                solids != nullptr, tex != 0);
  return forward_blocks(kernel, kThreads,
                        bvh_bytes(n_nodes, n_rows, moving != 0), solids,
                        blocks, smem);
}

extern "C" const char* rrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
