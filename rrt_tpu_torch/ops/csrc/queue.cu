// The queue driver's bounce-steps kernel and the batch driver's
// intersect-only kernel.
//
// bounce_steps_kernel replaces rrt_tpu/ops/megakernel.py::
// _bounce_megakernel (launched by _bounce_steps_launch): k_steps bounces
// of every live lane of the queue state, for the sphere subset of
// tile_render.cu (stationary and moving spheres, solid and checker
// textures, lambertian / metal / dielectric, sky or solid background, no
// Russian roulette). intersect_kernel replaces _intersect_kernel
// (launched by intersect_only) for the sphere family: the closest hit (t,
// family, slot) of each ray. Each has a kMoving instantiation for scenes
// with moving spheres: bounce_steps reads each lane's time from state row
// 6 (rrt_tpu's pack_state puts it there), intersect takes the rays' times
// as a (Q,) row beside the (3, Q) origins and directions.
// rrt_tpu_torch/ops/megakernel.py holds the wrappers
// (bounce_steps, intersect_only) and the plain PyTorch versions
// (bounce_steps_reference, intersect_only_reference).
//
// What bounds them: arithmetic, as tile_render. bounce_steps tests each
// bounce's ray against every sphere slot (at least 17 FP32 operations a
// slot, 23 for a moving one, 512 slots on chap12 and book2chap2), on
// sphere rows staged in shared memory; a lane moves 136 bytes (16 state
// rows and 2 key words read, 16 rows written). intersect walks
// tile_render's BVH instead (bounce.cuh closest_sphere_bvh, the scan's
// (t, slot) bit for bit), staged in shared memory with each static
// slot's |c|^2; a ray moves 36 bytes (o and d read; t, family and slot
// written; 40 with the time).
//
// Design, against the TPU kernels:
//  * one thread per lane, 256 lanes a block; the state is (16, Q)
//    row-major, so each row is lane-contiguous and a warp's loads and
//    stores coalesce;
//  * a lane runs its k_steps bounces through bounce_step of bounce.cuh,
//    the same function tile_render's paths go through, so a ray the
//    queue traces takes the path tile_render gives it;
//  * a dead lane returns at once and writes nothing: its state passes
//    through unchanged, the GPU form of the TPU kernel's whole-tile
//    early-out (a warp of dead lanes costs one load each);
//  * the wrapper updates the state in place: each thread reads and
//    writes only its own lane;
//  * the scatter draws' counter comes from the f32 bounce row, as in
//    rrt_tpu (bounce * 8 + 1), and the keys are the lanes' u32 words.
// Built with -fmad=false, as the other kernels (ops/_build.py).

#include "bounce.cuh"

namespace {

// Rows of the (16, Q) queue state (rrt_tpu/ops/megakernel.py pack_state).
constexpr int kStO = 0, kStD = 3, kStTime = 6, kStThr = 7, kStPend = 10,
              kStBounce = 13, kStAlive = 14, kStTraced = 15;
constexpr int kThreads = 256;

template <bool kMoving>
__global__ void __launch_bounds__(kThreads)
    bounce_steps_kernel(float* __restrict__ st,
                        const uint32_t* __restrict__ keys, int q,
                        const float* __restrict__ sph, int n_slots,
                        const float* __restrict__ bg_g, int k_steps,
                        int max_depth, float t_min) {
  extern __shared__ float4 sph4[];
  float4* vel4 = kMoving ? sph4 + n_slots : nullptr;
  __shared__ float bg[8];
  stage_spheres(sph, n_slots, sph4, vel4);
  if (threadIdx.x < 8) bg[threadIdx.x] = bg_g[threadIdx.x];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;
  const size_t n = static_cast<size_t>(q);
  float* row = st + lane;
  if (!(row[kStAlive * n] > 0.5f)) return;  // dead: write through

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
  float pend[3];
  for (int c = 0; c < 3; ++c) {
    p.thr[c] = row[(kStThr + c) * n];
    pend[c] = row[(kStPend + c) * n];
  }
  int bounce = static_cast<int>(row[kStBounce * n]);
  float traced = row[kStTraced * n];
  float alive = 1.0f;
  for (int k = 0; k < k_steps; ++k) {
    traced += 1.0f;
    float c[3];
    int win;
    const int out = bounce_step<kMoving>(sph, sph4, vel4, n_slots, bg, sky,
                                         k0, k1, bounce, max_depth, t_min, p,
                                         c, win);
    if (out == kMissed) {
      pend[0] += c[0];
      pend[1] += c[1];
      pend[2] += c[2];
    }
    if (out != kScattered) {
      alive = 0.0f;
      break;
    }
    ++bounce;
  }
  row[(kStO + 0) * n] = p.ray.ox;
  row[(kStO + 1) * n] = p.ray.oy;
  row[(kStO + 2) * n] = p.ray.oz;
  row[(kStD + 0) * n] = p.ray.dx;
  row[(kStD + 1) * n] = p.ray.dy;
  row[(kStD + 2) * n] = p.ray.dz;
  for (int c = 0; c < 3; ++c) {
    row[(kStThr + c) * n] = p.thr[c];
    row[(kStPend + c) * n] = pend[c];
  }
  row[kStBounce * n] = static_cast<float>(bounce);
  row[kStAlive * n] = alive;
  row[kStTraced * n] = traced;
}

// o, d: (3, Q) rows x y z of the rays' origins and directions; time:
// (Q,) the rays' times (kMoving only); the BVH as tile_render's. The
// media family, which this kernel does not cover yet, will also need
// each ray's bounce.
template <bool kMoving>
__global__ void __launch_bounds__(kThreads)
    intersect_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ time, int q,
                     const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ nodes_g,
                     const int* __restrict__ rows_g, int n_nodes, int n_rows,
                     int n_always, float t_min, float* __restrict__ t_out,
                     int* __restrict__ fam_out, int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  const BvhView b = stage_bvh<kMoving>(sph, n_slots, nodes_g, rows_g,
                                       n_nodes, n_rows, n_always, smem);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;
  const size_t n = static_cast<size_t>(q);
  Ray r;
  r.ox = o[lane];
  r.oy = o[n + lane];
  r.oz = o[2 * n + lane];
  r.dx = d[lane];
  r.dy = d[n + lane];
  r.dz = d[2 * n + lane];
  r.time = kMoving ? time[lane] : 0.0f;
  int win;
  const float t = closest_sphere_bvh<kMoving>(b, r, ray_dots(r), t_min, win);
  t_out[lane] = t;
  fam_out[lane] = t < kInf ? 0 : -1;  // sphere family, or a miss
  idx_out[lane] = win;                // 0 on a miss
}

// Shared memory of a launch: the staged sphere rows. MAX_SLOTS (3072)
// slots stage 48 KB (96 KB moving), which with bg passes the 48 KB a
// block gets without the opt-in.
template <typename Kernel>
int set_smem(Kernel kernel, int n_slots, bool moving, size_t& smem) {
  smem = staged_bytes(n_slots, moving);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// st: (16, q) f32, updated in place; keys: (2, q) u32; sph: (24, n_slots)
// f32; bg: (8,) f32; all on the device; moving: nonzero for the
// moving-sphere variant.
extern "C" int rrt_bounce_steps(float* st, const uint32_t* keys, int q,
                                const float* sph, int n_slots,
                                const float* bg, int k_steps, int max_depth,
                                float t_min, int moving, void* stream) {
  if (q == 0) return 0;
  auto kernel =
      moving ? bounce_steps_kernel<true> : bounce_steps_kernel<false>;
  size_t smem;
  const int err = set_smem(kernel, n_slots, moving != 0, smem);
  if (err != 0) return err;
  const int grid = (q + kThreads - 1) / kThreads;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      st, keys, q, sph, n_slots, bg, k_steps, max_depth, t_min);
  return static_cast<int>(cudaGetLastError());
}

// o, d: (3, q) f32; time: (q,) f32 when moving (else unused, may be
// null); the BVH as rrt_tile_render's; outputs t (q,) f32, fam (q,) i32,
// idx (q,) i32.
extern "C" int rrt_intersect(const float* o, const float* d,
                             const float* time, int q, const float* sph,
                             int n_slots, const float* nodes, const int* rows,
                             int n_nodes, int n_rows, int n_always,
                             float t_min, int moving, float* t, int* fam,
                             int* idx, void* stream) {
  if (q == 0) return 0;
  auto kernel = moving ? intersect_kernel<true> : intersect_kernel<false>;
  const size_t smem = bvh_bytes(n_nodes, n_rows, moving != 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (q + kThreads - 1) / kThreads;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, time, q, sph, n_slots, nodes, rows, n_nodes, n_rows, n_always,
      t_min, t, fam, idx);
  return static_cast<int>(cudaGetLastError());
}
