// The queue driver's bounce-steps kernel and the batch driver's
// intersect-only kernel.
//
// bounce_steps_kernel replaces rrt_tpu/ops/megakernel.py::
// _bounce_megakernel (launched by _bounce_steps_launch): k_steps bounces
// of every live lane of the queue state, for the scenes of
// tile_render.cu (stationary and moving spheres, quads, boxes and
// constant media, solid, checker, perlin-marble and image textures,
// lambertian / metal / dielectric / diffuse_light / isotropic, sky or
// solid background, Russian roulette from bounce rr_depth, 0 off, the
// coin drawn at each lane's bounce row). intersect_kernel replaces
// _intersect_kernel
// (launched by intersect_only): the closest hit (t, family, slot) of each
// ray over the spheres and, in its kSolids instantiation, the quads,
// boxes and media (rrt_tpu's megakernel.py:1804-1840), a medium's draw
// addressed by the ray's keys and bounce, as rrt_tpu's rays8 row 7 gives
// it. rrt_tpu's intersect kernel has no box family (its batch driver
// intersects box scenes in XLA); this one has, so the port's batch driver
// intersects every scene it renders on the card here. Each has a kMoving
// instantiation for scenes with moving spheres: bounce_steps reads each
// lane's time from state row 6 (rrt_tpu's pack_state puts it there),
// intersect takes the rays' times
// as a (Q,) row beside the (3, Q) origins and directions; and a kSolids
// one for scenes with quads, boxes or a light (bounce.cuh's, the solid
// families staged after the BVH), and a kWalk one for scenes whose quads
// or boxes have a tree (tile_render's); bounce_steps also a kTex one for
// scenes with perlin or image textures (intersect does not shade).
// rrt_tpu_torch/ops/megakernel.py holds the wrappers
// (bounce_steps, intersect_only) and the plain PyTorch versions
// (bounce_steps_reference, intersect_only_reference).
//
// What bounds them. Both walk tile_render's BVH (bounce.cuh
// closest_sphere_bvh, the linear scan's (t, slot) bit for bit), staged in
// shared memory with each static slot's |c|^2 (stage_bvh). intersect: a
// ray moves 36 bytes (o and d read; t, family and slot written; 40 with
// the time) and walks about 20 nodes and 7 slots. bounce_steps: a lane
// moves 136 bytes (16 state rows and 2 key words read, 16 rows written);
// a segment walks the tree, and one that hits shades its winner, whose
// pack column it reads from device memory, and draws 4 Threefry calls
// (80 INT32 operations each). On an H100 80GB HBM3 at 700 W, at 131,072
// camera-ray lanes of chap12 1200x800 and 4 steps, bounce_steps took
// 0.1052-0.1237 ms in turns with the scan, which took 0.3304-0.3410
// (book2chap2 0.1222-0.1332 where 0.4229-0.4339), and 0.1172-0.1415 ms
// (0.1374-0.1550) in chip_smoke.py's runs, against a least time of some
// microseconds (PERF.md).
// At __launch_bounds__(256) ptxas gave it 64 registers, 4 blocks an SM,
// and (256, 4) ran no faster; since the media (PR 12) the solid-family
// variant needs (256, 4) to keep 4 blocks.
//
// Design, against the TPU kernels:
//  * one thread per lane, 256 lanes a block; the state is (16, Q)
//    row-major, so each row is lane-contiguous and a warp's loads and
//    stores coalesce;
//  * a lane runs its k_steps bounces through bounce_step of bounce.cuh
//    with the walk (BvhWalk), the function tile_render's paths go
//    through, so a ray the queue traces takes the path tile_render gives
//    it, and the same winners as the scan the TPU kernel runs;
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

// The solid families as tile_render stages them: after the BVH's rows.
template <bool kMoving, bool kSolids, bool kWalk>
__device__ __forceinline__ Solids stage_solids_after(float4* smem,
                                                     int n_nodes, int n_rows,
                                                     const SolidArgs& sa) {
  Solids sv{};
  if constexpr (kSolids) {
    sv = stage_solids_of<kWalk>(
        sa, smem + aligned16(bvh_bytes(n_nodes, n_rows, kMoving)) /
                       sizeof(float4));
  }
  return sv;
}

// st: (16, Q) state, updated in place; keys: (2, Q); the BVH and the
// solid families as tile_render's. At least 4 blocks an SM, 64
// registers: with the media code the solid-family variant took 75
// registers and 3 blocks, and cornell's 512 blocks two waves on 132 SMs
// (30% slower in turns on an H100). The kWalk instantiations at
// kWalkBlocks, as tile_render's.
template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
__global__ void __launch_bounds__(kThreads, kWalk ? kWalkBlocks : 4)
    bounce_steps_kernel(float* __restrict__ st,
                        const uint32_t* __restrict__ keys, int q,
                        const float* __restrict__ sph, int n_slots,
                        const float* __restrict__ nodes_g,
                        const int* __restrict__ rows_g, int n_nodes,
                        int n_rows, int n_always, const SolidArgs sa,
                        TexView tex,
                        const float* __restrict__ bg_g,
                        int k_steps,
                        int max_depth, int rr_depth, float t_min) {
  extern __shared__ float4 smem[];
  __shared__ float bg[8];
  const BvhWalk<kMoving> walk{stage_bvh<kMoving>(
      sph, n_slots, nodes_g, rows_g, n_nodes, n_rows, n_always, smem)};
  Solids sv = stage_solids_after<kMoving, kSolids, kWalk>(smem, n_nodes,
                                                         n_rows, sa);
  sv.tex = tex;
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
    const int out = bounce_step<kMoving, kSolids, kTex, kWalk>(
        walk, sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth,
        t_min, p, c, win, nullptr, &sv);
    if (out == kMissed || (kSolids && out == kEmitted)) {
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
// (Q,) the rays' times (kMoving only); keys (2, Q) and bounce (Q,): each
// ray's u32 key words and bounce counter, read with media only (their
// STREAM_MEDIUM draws); the BVH and the solid families as tile_render's.
// The solid-family variant at 5 blocks an SM (51 registers at most), its
// register count before media: at 64 cornell's rays ran 9-15% slower in
// turns on an H100. The kWalk instantiations at kWalkBlocks, as
// tile_render's.
template <bool kMoving, bool kSolids, bool kWalk = false>
__global__ void __launch_bounds__(kThreads,
                                  kWalk ? kWalkBlocks : (kSolids ? 5 : 1))
    intersect_kernel(const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ time,
                     const uint32_t* __restrict__ keys,
                     const int* __restrict__ bounce, int q,
                     const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ nodes_g,
                     const int* __restrict__ rows_g, int n_nodes, int n_rows,
                     int n_always, const SolidArgs sa, float t_min,
                     float* __restrict__ t_out,
                     int* __restrict__ fam_out, int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  const BvhWalk<kMoving> walk{stage_bvh<kMoving>(
      sph, n_slots, nodes_g, rows_g, n_nodes, n_rows, n_always, smem)};
  const Solids sv = stage_solids_after<kMoving, kSolids, kWalk>(
      smem, n_nodes, n_rows, sa);
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
  int fam, win;
  float t;
  // A scene without media takes the closest hit without the media's code.
  if (kSolids && sv.n_media > 0) {
    t = closest_hit<kSolids, BvhWalk<kMoving>, true, kWalk>(
        walk, &sv, r, ray_dots(r), t_min, fam, win, keys[lane],
        keys[n + lane], bounce[lane]);
  } else {
    t = closest_hit<kSolids, BvhWalk<kMoving>, false, kWalk>(
        walk, &sv, r, ray_dots(r), t_min, fam, win);
  }
  t_out[lane] = t;
  fam_out[lane] = fam;  // kFamNone (-1) on a miss
  idx_out[lane] = win;  // 0 on a miss
}

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
int launch_bounce_steps(cudaStream_t stream, float* st, const uint32_t* keys,
                        int q, const float* sph, int n_slots,
                        const float* nodes, const int* rows, int n_nodes,
                        int n_rows, int n_always, const SolidArgs* solids,
                        TexView tex, const float* bg, int k_steps,
                        int max_depth, int rr_depth, float t_min) {
  auto kernel = bounce_steps_kernel<kMoving, kSolids, kTex, kWalk>;
  size_t smem;
  const int err = forward_smem(kernel, bvh_bytes(n_nodes, n_rows, kMoving),
                               solids, smem);
  if (err != 0) return err;
  const SolidArgs none{};
  const int grid = (q + kThreads - 1) / kThreads;
  kernel<<<grid, kThreads, smem, stream>>>(
      st, keys, q, sph, n_slots, nodes, rows, n_nodes, n_rows, n_always,
      solids != nullptr ? *solids : none, tex, bg, k_steps, max_depth,
      rr_depth, t_min);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMoving, bool kSolids, bool kWalk = false>
int launch_intersect(cudaStream_t stream, const float* o, const float* d,
                     const float* time, const uint32_t* keys,
                     const int* bounce, int q, const float* sph, int n_slots,
                     const float* nodes, const int* rows, int n_nodes,
                     int n_rows, int n_always, const SolidArgs* solids,
                     float t_min, float* t, int* fam, int* idx) {
  auto kernel = intersect_kernel<kMoving, kSolids, kWalk>;
  size_t smem;
  const int err = forward_smem(kernel, bvh_bytes(n_nodes, n_rows, kMoving),
                               solids, smem);
  if (err != 0) return err;
  const SolidArgs none{};
  const int grid = (q + kThreads - 1) / kThreads;
  kernel<<<grid, kThreads, smem, stream>>>(
      o, d, time, keys, bounce, q, sph, n_slots, nodes, rows, n_nodes,
      n_rows, n_always, solids != nullptr ? *solids : none, t_min, t, fam,
      idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// st: (16, q) f32, updated in place; keys: (2, q) u32; sph: (24, n_slots)
// f32; the BVH, the solid families (solids, or null) and the textures
// (tex, or null) as rrt_tile_render's; bg: (8,) f32; all on the device;
// rr_depth: Russian roulette's first bounce (0: off); moving: nonzero
// for the moving-sphere variant.
extern "C" int rrt_bounce_steps(float* st, const uint32_t* keys, int q,
                                const float* sph, int n_slots,
                                const float* nodes, const int* rows,
                                int n_nodes, int n_rows, int n_always,
                                const SolidArgs* solids, const TexArgs* tex,
                                const float* bg, int k_steps, int max_depth,
                                int rr_depth, float t_min, int moving,
                                void* stream) {
  if (q == 0) return 0;
  auto go = has_tree(solids)
                 ? RRT_PICK_WALK(launch_bounce_steps, moving != 0,
                                 tex != nullptr)
                 : RRT_PICK3(launch_bounce_steps, moving != 0,
                             solids != nullptr, tex != nullptr);
  return go(static_cast<cudaStream_t>(stream), st, keys, q, sph, n_slots,
            nodes, rows, n_nodes, n_rows, n_always, solids, tex_view(tex), bg,
            k_steps, max_depth, rr_depth, t_min);
}

// o, d: (3, q) f32; time: (q,) f32 when moving (else unused, may be
// null); keys: (2, q) u32 and bounce: (q,) i32 when solids holds media
// (else unused, may be null); the BVH and the solid families (solids, or
// null) as rrt_tile_render's; outputs t (q,) f32, fam (q,) i32 (-1 on a
// miss, 0 sphere, 1 quad, 2 medium, 3 box), idx (q,) i32.
extern "C" int rrt_intersect(const float* o, const float* d,
                             const float* time, const uint32_t* keys,
                             const int* bounce, int q, const float* sph,
                             int n_slots, const float* nodes, const int* rows,
                             int n_nodes, int n_rows, int n_always,
                             const SolidArgs* solids, float t_min,
                             int moving, float* t, int* fam, int* idx,
                             void* stream) {
  if (q == 0) return 0;
  auto go = has_tree(solids)
                 ? (moving ? launch_intersect<true, true, true>
                           : launch_intersect<false, true, true>)
                 : moving ? (solids ? launch_intersect<true, true>
                                    : launch_intersect<true, false>)
                          : (solids ? launch_intersect<false, true>
                                    : launch_intersect<false, false>);
  return go(static_cast<cudaStream_t>(stream), o, d, time, keys, bounce, q,
            sph, n_slots, nodes, rows, n_nodes, n_rows, n_always, solids,
            t_min, t, fam, idx);
}

// The blocks an SM of the instantiation rrt_bounce_steps (kernel 0) or
// rrt_intersect (kernel 1, which has no texture variant) would launch, as
// rrt_tile_render_blocks reports tile_render's.
extern "C" int rrt_queue_blocks(int kernel, int n_nodes, int n_rows,
                                int moving, const SolidArgs* solids, int tex,
                                int* blocks, long long* smem) {
  const size_t base = bvh_bytes(n_nodes, n_rows, moving != 0);
  if (kernel == 0) {
    auto k = has_tree(solids)
                 ? RRT_PICK_WALK(bounce_steps_kernel, moving != 0, tex != 0)
                 : RRT_PICK3(bounce_steps_kernel, moving != 0,
                             solids != nullptr, tex != 0);
    return forward_blocks(k, kThreads, base, solids, blocks, smem);
  }
  auto k = has_tree(solids)
               ? (moving ? intersect_kernel<true, true, true>
                         : intersect_kernel<false, true, true>)
               : moving ? (solids ? intersect_kernel<true, true>
                                  : intersect_kernel<true, false>)
                        : (solids ? intersect_kernel<false, true>
                                  : intersect_kernel<false, false>);
  return forward_blocks(k, kThreads, base, solids, blocks, smem);
}
