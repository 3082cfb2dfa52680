// Train kernels: the differentiable tile render.
//
// train_fwd replaces rrt_tpu/ops/megakernel_train.py::_train_fwd_kernel
// (launched by _fwd_launch), train_bwd replaces _train_bwd_kernel
// (launched by _bwd_launch), for the scenes of tile_render.cu: static
// and moving spheres (a kMoving instantiation of each, as
// tile_render's), and quads, boxes rotated about Y, diffuse_light and
// up to 8 constant media (a kSolids instantiation, the Cornell box's and
// cornell_smoke's; bounce.cuh's solid families, the quads and boxes
// staged in shared memory after the spheres, the media read from their
// pack in device memory), and perlin-marble and image textures (a kTex
// instantiation of each: simple_light's and earth's; the backward adds
// a marble's cotangents to its color1, texture scale and hit point, and
// an image's to its texel of the atlas cotangent in device memory with
// four-float atomics, so that output repeats only within a spread), and
// Russian roulette from bounce rr_depth (a runtime argument, 0 off): the
// forward draws its coin in finish_bounce, the replay redraws it, and
// the sweep gives a surviving throughput the detached 1 / p (adjoint.cuh
// rr_inv_p, recomputed from the record's throughput and attenuation).
// rrt_tpu_torch/ops/megakernel_train.py holds the wrappers
// (render_tiles_train, tiles_adjoint, the autograd.Function
// TileTrainChain) and their plain PyTorch versions.
//
// train_fwd: one thread a pixel (16x16 blocks) traces its samples back
// to back through bounce.cuh's trace_pixel, tile_render's loop, with
// the closest-sphere scan where tile_render walks its BVH (the same
// winners and t bit for bit), so rad and traced are tile_render's bit
// for bit. A scene with a solid family past kSolidCap active slots
// (rttnw_final's 400 ground boxes) runs the kWalk instantiation, which
// walks that family's tree as the forward kernels do (solid_walk, the
// loop's (t, slot) bit for bit; the rows and trees staged after the
// spheres, stage_forward_solids); the spheres keep the scan. It keeps
// the residual the backward needs:
//  * lengths[s * P + pixel], each path's executed bounce count (uint8);
//  * winners[j * P + pixel], the winner of the pixel's j-th segment in
//    trace order (int16: a sphere's slot, or with kSolids bounce.cuh's
//    winner_code, kQuadCode + a quad's slot, kBoxCode + a box's or
//    kMediumCode + a medium's; -1 on a miss: 3,072 sphere slots and
//    kCodeSpan (8,192) slots of each later family fit), for j <
//    win_cap
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
//    about 104 registers and 2 blocks); the kWalk instantiations
//    (256, kWalkBlocks), as the forward kernels' walks, which spilled
//    under a cap of 64 registers (PERF.md).
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
//     segment past the pool runs the scan. With kSolids a stored quad
//     or box winner is recomputed alone too (bounce.cuh solid_t, the
//     forward's arithmetic on the same staged rows, so its t bit for
//     bit; replay_solid_step), as is a stored medium winner (bounce.cuh
//     medium_slot_t, its recomputed STREAM_MEDIUM draw), the scan is
//     seeded by the quads and boxes as the forward's was and followed by
//     the media, and a light's hit ends the path (kEmitted) keeping its
//     checker parity. The replay needs no tree: a stored solid winner is
//     tested alone whatever its slot, and a segment past the pool loops
//     over every active quad and box, whose (t, slot) is the walk's bit
//     for bit. Sample s's first entry is the sum of the forward's
//     lengths before it;
//  2. counts in `mismatches` the paths whose replayed length differs
//     from the forward's, and the stored winners that are no slot or
//     whose recomputed quadratic gives no root beyond t_min (those
//     segments then scan); expected 0: both kernels run the same code;
//  3. sweeps the records in reverse with the hand-written transpose of
//     megakernel_vjp.diff_step (adjoint.cuh, shared with chain.cu's
//     bounce-chain backward), seeded by d_rad[pixel]: each bounce's
//     intermediates are recomputed from the record, the winner's pack
//     column and what the replay kept of its draws, so the sweep draws
//     nothing (shade's kForAdjoint); a light's emission, a quad's and a
//     box's bounce go through emit_adjoint and solid_scatter_adjoint, a
//     medium's through medium_adjoint (its draw recomputed);
//     the sweep ends in the adjoint of camera_ray, into d_cam.
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
// With kSolids the active quads' and boxes' columns follow the spheres'
// in the row (adjoint.cuh winner_column): a quad's frame normal and
// d_plane, a box's center, half extents and rotation, and the material
// rows of both, then a medium's 11 (center, radius, half extents,
// -1/density, albedo: megakernel_vjp.MED_COLS); the wrapper takes a
// quad's frame cotangents to its q, u and v (geometry.quad_frame_vjp).
// Accumulating on the staged frame rows keeps the transpose of
// geometry.quad_frames out of every segment: it runs once a quad.
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
__host__ __device__ inline size_t fwd_smem(int n_slots, bool moving) {
  return staged_bytes(n_slots, moving) +
         (moving ? 0 : sizeof(float) * n_slots);
}

// The staged solid families (kSolids) after a kernel's `base` bytes of
// staged spheres at `smem`: with kWalk their rows and trees
// (stage_forward_solids), else the rows of the loops; the caller syncs
// the block after.
template <bool kSolids, bool kWalk = false>
__device__ __forceinline__ Solids stage_solids_at(float4* smem, size_t base,
                                                  const SolidArgs& sa) {
  Solids sv{};
  if constexpr (kSolids) {
    sv = stage_solids_of<kWalk>(sa, smem + aligned16(base) / sizeof(float4));
  }
  return sv;
}

// A launch's dynamic shared memory: `base` bytes of staged spheres, then
// the solid families' (solids not null): with their trees when `walk`
// (forward_solid_bytes), else their rows.
inline size_t with_solids(size_t base, const SolidArgs* solids,
                          bool walk = false) {
  if (solids == nullptr) return base;
  return aligned16(base) + (walk ? forward_solid_bytes(*solids)
                                 : solid_bytes(solids->n_quads,
                                               solids->n_boxes));
}

template <bool kMoving, bool kSolids, bool kTex, bool kWalk = false>
__global__ void __launch_bounds__(256, kWalk ? kWalkBlocks : kFwdMinBlocks)
    train_fwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g, const SolidArgs sa,
                     TexView tex, uint32_t s0, uint32_t s1, uint32_t lo,
                     int width, int row_lo, int row_hi, int spp,
                     int max_depth, int rr_depth, float t_min, int win_cap,
                     float* __restrict__ rad, int* __restrict__ traced,
                     uint8_t* __restrict__ lengths,
                     int16_t* __restrict__ winners) {
  // Dynamic shared memory (fwd_smem): the staged rows of every slot
  // (float4: intersection rows, then velocity rows when moving), then,
  // for static spheres, every slot's center_sq; with kSolids, then the
  // solid families (stage_solids_at; with kWalk their trees too).
  constexpr bool kHoist = !kMoving;
  extern __shared__ float4 sph4[];
  float4* vel4 = kMoving ? sph4 + n_slots : nullptr;
  float* csq = kHoist ? reinterpret_cast<float*>(sph4 + n_slots) : nullptr;
  __shared__ float cam[24];
  __shared__ float bg[8];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  if (kHoist) stage_center_sq(sph, n_slots, csq);
  Solids sv = stage_solids_at<kSolids, kWalk>(
      sph4, fwd_smem(n_slots, kMoving), sa);
  sv.tex = tex;
  __syncthreads();

  // The grid covers the rows [row_lo, row_hi), as tile_render's.
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = row_lo + static_cast<int>(blockIdx.y * blockDim.y +
                                           threadIdx.y);
  if (px >= width || py >= row_hi) return;
  const SlotScan<kMoving, kHoist> scan{sph4, vel4, csq, n_slots};
  trace_pixel<kMoving, true, kSolids, kTex, kWalk>(
      scan, sph, n_slots, cam, bg, s0, s1, lo, px, py, width, row_lo,
      width * (row_hi - row_lo), spp, max_depth, rr_depth, t_min, win_cap,
      rad, traced, lengths, winners, &sv);
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
// winner (-1 on a miss). Returns the Outcome, as bounce_step (with
// Russian roulette's coin redrawn from bounce rr_depth on). kTex: the
// textures of sv.
template <bool kMoving, bool kTex>
__device__ __forceinline__ int replay_step(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const Solids& sv, const float* bg, bool sky, uint32_t k0, uint32_t k1,
    int bounce, int max_depth, int rr_depth, float t_min, int stored, Path& p,
    int& win, int& bad, float* kept) {
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
  return finish_bounce<kMoving, false, true, kTex>(
      sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth, q, t_best, p,
      c, win, kept, kFamSphere, &sv);
}

// replay_step of the solid-family variant: `stored` is a winner_code,
// the forward's quad or box winner recomputed alone (solid_t), a medium
// alone with its draw (medium_slot_t), a sphere as replay_step's; the
// scan is seeded by the quads and boxes of sv and followed by its media. A
// light's hit ends the path (kEmitted) and keeps its checker parity in
// kept[0]. `win` gets the winner's code (-1 on a miss). kMedia = false:
// sv has no media, and their code is left out. kTex: sv's textures.
template <bool kMoving, bool kMedia, bool kTex>
__device__ __forceinline__ int replay_solid_step(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const Solids& sv, const float* bg, bool sky, uint32_t k0, uint32_t k1,
    int bounce, int max_depth, int rr_depth, float t_min, int stored, Path& p,
    int& win, int& bad, float* kept) {
  const RayDots q = ray_dots(p.ray);
  float t_best = kInf;
  int fam = kFamNone, slot = -1;
  if (stored >= 0) {
    fam = code_family(stored, slot);
    const int n = fam == kFamQuad
                      ? sv.n_quads
                      : (fam == kFamBox
                             ? sv.n_boxes
                             : (fam == kFamMedium ? sv.n_media : n_slots));
    if (slot < n) {
      if (fam == kFamSphere) {
        t_best = slot_t<kMoving>(sph4, vel4, slot, p.ray, q, t_min);
      } else if (kMedia && fam == kFamMedium) {
        t_best = medium_slot_t(sv, slot, p.ray, q, t_min, k0, k1, bounce);
      } else {
        t_best = solid_t(sv, fam, slot, p.ray, q, t_min);
      }
    }
    if (!(t_best < kInf)) {
      ++bad;
      stored = kUnstored;
    }
  }
  if (stored == kUnstored) {
    const SlotScan<kMoving, false> scan{sph4, vel4, nullptr, n_slots};
    t_best = closest_hit<true, SlotScan<kMoving, false>, kMedia>(
        scan, &sv, p.ray, q, t_min, fam, slot, k0, k1, bounce);
  }
  float c[3];
  const int out = finish_bounce<kMoving, true, kMedia, kTex>(
      sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth, q, t_best, p,
      c, slot, kept, fam, &sv);
  win = winner_code(fam, slot);
  return out;
}

// The backward of one pixel's samples [lo, lo + spp): pack cotangents
// into `acc` (the block's row of the partials, kSlotCols floats a slot:
// the spheres', then with kSolids the active quads', boxes' and media's),
// camera and background ones into g_cam / g_bg. The pixel's key is its
// id in the whole image, gid = py * width + px; its d_rad, lengths and
// winners are at band_id = (py - row_lo) * width + px of the band of
// rows from row_lo (n_pix its pixels). kMedia = false: sv has
// no media, and their code is left out. kTex: sv's textures (a light's
// emission then through emit_adjoint_tex). rr_depth: Russian roulette's
// first bounce (0: off), whose coin the replay redraws and whose weight
// the sweep transposes.
template <bool kMoving, bool kSolids, bool kMedia, bool kTex>
__device__ __forceinline__ void adjoint_pixel(
    const float* sph, const float4* sph4, const float4* vel4, int n_slots,
    const Solids& sv, const float* cam, const float* bg, uint32_t s0,
    uint32_t s1, uint32_t lo, int px, int py, int width, int row_lo,
    int n_pix, int spp, int max_depth, int rr_depth, float t_min,
    const float* d_rad, const uint8_t* lengths, const int16_t* winners,
    int win_cap, float* acc, float* g_cam, float* g_bg, int* mismatches) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  const uint32_t band_id = static_cast<uint32_t>((py - row_lo) * width + px);
  const bool sky = bg[6] < 0.5f;
  const float dr[3] = {d_rad[3 * band_id], d_rad[3 * band_id + 1],
                       d_rad[3 * band_id + 2]};
  // The pixel's columns of the residual, so that the loops below keep
  // one pixel id live (gid, the key's).
  lengths += band_id;
  winners = winners != nullptr ? winners + band_id : winners;
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
    const int length = lengths[static_cast<size_t>(s) * n_pix];

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
              ? winners[static_cast<size_t>(j) * n_pix]
              : kUnstored;
      if constexpr (kSolids) {
        last = replay_solid_step<kMoving, kMedia, kTex>(
            sph, sph4, vel4, n_slots, sv, bg, sky, k0, k1, bounce, max_depth,
            rr_depth, t_min, stored, p, r.win, bad, kept[n - 1]);
      } else {
        last = replay_step<kMoving, kTex>(sph, sph4, vel4, n_slots, sv, bg,
                                          sky, k0, k1, bounce, max_depth,
                                          rr_depth, t_min, stored, p, r.win,
                                          bad, kept[n - 1]);
      }
      if (last != kScattered) break;
    }
    first += length;
    // 2. the replay must retrace the forward's path.
    if (n != length) ++bad;
    // 3. reverse sweep. The last record ended the path: a miss banks
    // the background, a light its emission, a surface that absorbs or
    // ends the depth banks 0.
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f},
          gt[3] = {0.0f, 0.0f, 0.0f}, g_time = 0.0f;
    if (last == kMissed) miss_adjoint(rec[n - 1], dr, bg, sky, gd, gt, g_bg);
    if constexpr (kSolids) {
      if (last == kEmitted) {
        if constexpr (kTex) {
          emit_adjoint_tex<kMoving>(sph, n_slots, sv, rec[n - 1], k0, k1,
                                    n - 1, t_min, p.ray.time, kept[n - 1],
                                    dr, go, gd, gt, g_time, acc);
        } else {
          emit_adjoint(sph, n_slots, sv, rec[n - 1], kept[n - 1], dr, gt,
                       acc);
        }
      }
    }
    for (int k = n - 2; k >= 0; --k) {
      if constexpr (kSolids) {
        int slot;
        const int fam = code_family(rec[k].win, slot);
        if (kMedia && fam == kFamMedium) {
          RowSums<kMediumRows> sums{};
          medium_adjoint(sv, slot, rec[k], k0, k1, k, rr_depth, t_min, go, gd,
                         gt, sums);
          add_slot<kMediumRows>(acc + winner_column(n_slots, &sv, fam, slot),
                                sums.g);
          continue;
        }
        if (fam != kFamSphere) {
          constexpr int kRows = kTex ? kTexRows : kSolidRows;
          RowSums<kRows> sums{};
          solid_scatter_adjoint<decltype(sums), kTex>(sv, fam, slot, rec[k],
                                                      k0, k1, k, rr_depth,
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
          sph, n_slots, rec[k], k0, k1, k, rr_depth, t_min, p.ray.time, go,
          gd, gt, sums, g_time, kept[k], &sv.tex);
      add_slot<kRows>(acc + rec[k].win * kSlotCols, sums.g);
    }
    camera_adjoint<kMoving>(cam, cd, static_cast<float>(px),
                            static_cast<float>(py), go, gd, g_time, g_cam);
  }
  if (bad != 0) atomicAdd(mismatches, bad);
}

template <bool kMoving, bool kSolids, bool kTex>
__global__ void __launch_bounds__(kBwdThreads)
    train_bwd_kernel(const float* __restrict__ sph, int n_slots,
                     const float* __restrict__ cam_g,
                     const float* __restrict__ bg_g, const SolidArgs sa,
                     TexView tex, const float* __restrict__ d_rad,
                     const uint8_t* __restrict__ lengths,
                     const int16_t* __restrict__ winners, int win_cap,
                     uint32_t s0, uint32_t s1, uint32_t lo, int width,
                     int row_lo, int row_hi, int spp, int max_depth,
                     int rr_depth, float t_min, float* __restrict__ partials,
                     int* __restrict__ mismatches) {
  // Dynamic shared memory (staged_bytes): the staged rows of every slot
  // (float4: intersection rows, then velocity rows when moving); with
  // kSolids, then the solid families. The pack cotangents go to this
  // block's row of the partials, zeroed here.
  extern __shared__ float4 smem[];
  float4* sph4 = smem;
  float4* vel4 = kMoving ? smem + n_slots : nullptr;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_media = sa.n_media;
  const int n_acc =
      kSlotCols *
      (kSolids ? n_slots + sa.n_quads + sa.n_boxes + n_media : n_slots);
  float* out = partials + block * (static_cast<size_t>(n_acc) + kCamBgCols);
  __shared__ float cam[24];
  __shared__ float bg[8];
  __shared__ float warp_part[kBwdThreads / 32][kCamBgCols];
  stage_packs(sph, n_slots, cam_g, bg_g, sph4, vel4, cam, bg);
  Solids sv = stage_solids_at<kSolids>(smem, staged_bytes(n_slots, kMoving),
                                       sa);
  sv.tex = tex;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_acc; i += kBwdThreads) out[i] = 0.0f;
  __syncthreads();

  float g_cam[24], g_bg[6];
  for (int j = 0; j < 24; ++j) g_cam[j] = 0.0f;
  for (int j = 0; j < 6; ++j) g_bg[j] = 0.0f;
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = row_lo + static_cast<int>(blockIdx.y * blockDim.y +
                                           threadIdx.y);
  if (px < width && py < row_hi) {  // no early return: all sync below
    // A scene without media takes the pixel's backward without the media's
    // code, the kernel's before media: with it, cornell's backward ran 5%
    // slower in turns on an H100 (more spills in the sweep).
    if (kSolids && n_media > 0) {
      adjoint_pixel<kMoving, kSolids, true, kTex>(
          sph, sph4, vel4, n_slots, sv, cam, bg, s0, s1, lo, px, py, width,
          row_lo, width * (row_hi - row_lo), spp, max_depth, rr_depth, t_min,
          d_rad, lengths, winners, win_cap, out, g_cam, g_bg, mismatches);
    } else {
      adjoint_pixel<kMoving, kSolids, false, kTex>(
          sph, sph4, vel4, n_slots, sv, cam, bg, s0, s1, lo, px, py, width,
          row_lo, width * (row_hi - row_lo), spp, max_depth, rr_depth, t_min,
          d_rad, lengths, winners, win_cap, out, g_cam, g_bg, mismatches);
    }
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

// Opt `kernel` into `smem` bytes of dynamic shared memory (past 48 KB at
// 3072 slots), then launch it on `grid` blocks of 16x16.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                 Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, dim3(16, 16), smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// train_fwd's instantiation for a launch and its dynamic shared memory
// (fwd_smem, then the solid families: with their trees for kWalk, which
// a scene with a tree runs).
auto fwd_kernel(int n_slots, bool moving, const SolidArgs* solids, bool tex,
                size_t& smem) {
  const bool walk = has_tree(solids);
  smem = with_solids(fwd_smem(n_slots, moving), solids, walk);
  return walk ? RRT_PICK_WALK(train_fwd_kernel, moving, tex)
              : RRT_PICK3(train_fwd_kernel, moving, solids != nullptr, tex);
}

// train_bwd's instantiation and its dynamic shared memory (staged_bytes,
// then the solid rows).
auto bwd_kernel(int n_slots, bool moving, const SolidArgs* solids, bool tex,
                size_t& smem) {
  smem = with_solids(staged_bytes(n_slots, moving), solids);
  return RRT_PICK3(train_bwd_kernel, moving, solids != nullptr, tex);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32 on the device;
// solids: the quad, box and medium packs for the solid-family variant,
// with the families' trees for the kWalk one (a family past kSolidCap
// active slots must have its tree), or null; tex: the atlas for the
// texture variant, or null; moving: nonzero for the moving-sphere
// variant; the rows [row_lo, row_hi) of a width-wide image are traced
// (0 <= row_lo < row_hi <= the image's height, checked by the wrapper),
// each pixel keyed by its id in the whole image, and with P =
// (row_hi-row_lo)*width the band's pixels in scan-line order: outputs
// rad: (P, 3) f32, traced: (P,) i32, lengths: (spp, P) uint8, winners:
// (win_cap, P) int16, winner codes (the entries past a pixel's segments
// are left as they were); rr_depth: Russian roulette's first bounce (0:
// off).
extern "C" int rrt_train_fwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, const SolidArgs* solids,
                             const TexArgs* tex, uint32_t s0, uint32_t s1,
                             uint32_t lo, int width, int row_lo,
                             int row_hi, int spp, int max_depth,
                             int rr_depth, float t_min, int moving,
                             int win_cap, float* rad, int* traced,
                             uint8_t* lengths, int16_t* winners,
                             void* stream) {
  const dim3 grid((width + 15) / 16, (row_hi - row_lo + 15) / 16);
  const SolidArgs none{};
  size_t smem;
  // As tile_render: 3072 slots need the opt-in above 48 KB.
  const auto kernel =
      fwd_kernel(n_slots, moving != 0, solids, tex != nullptr, smem);
  return launch_tiles(kernel, grid, smem, static_cast<cudaStream_t>(stream),
                      sph, n_slots, cam, bg,
                      solids != nullptr ? *solids : none, tex_view(tex), s0,
                      s1, lo, width, row_lo, row_hi, spp, max_depth,
                      rr_depth, t_min, win_cap, rad, traced, lengths,
                      winners);
}

// The backward: train_bwd_kernel, then two fixed-order reductions of its
// per-block partials. solids as rrt_train_fwd's (the trees are not
// read: the replay tests a stored winner alone and loops over every
// active quad and box past the pool); the rows [row_lo, row_hi) as
// rrt_train_fwd's, with P its pixels: d_rad: (P, 3) f32;
// lengths and winners as written by rrt_train_fwd with the same win_cap
// and solids (win_cap 0: no winners, every segment scans; winners may be
// null); scratch: (n_blocks + ceil(n_blocks / 64)) * n_cols f32 with
// n_blocks = ceil(width/16) * ceil((row_hi-row_lo)/16) and n_cols =
// kSlotCols * (n_slots + n_quads + n_boxes + n_media) + 32; sums:
// (n_cols,) f32 out
// (slot-major: kSlotCols floats a slot, a sphere's 12 (15 when moving)
// gradient rows then zeros, then the active quads', boxes' and media's
// columns (adjoint.cuh kQuadAccPlane, kMedAccRadius ...); then 24 camera
// rows, 6 background, 2 pad); mismatches: one int32, zeroed by the
// caller; tex: as rrt_train_fwd's, its d_atlas (with images) the atlas
// cotangent, zeroed by the caller, which a marble's texture scale does
// not use (it goes to its slot's column kAccTexScale); rr_depth: the
// forward's.
extern "C" int rrt_train_bwd(const float* sph, int n_slots, const float* cam,
                             const float* bg, const SolidArgs* solids,
                             const TexArgs* tex, const float* d_rad,
                             const uint8_t* lengths, const int16_t* winners,
                             int win_cap, uint32_t s0, uint32_t s1,
                             uint32_t lo, int width, int row_lo,
                             int row_hi, int spp, int max_depth,
                             int rr_depth, float t_min, int moving,
                             float* scratch, float* sums, int* mismatches,
                             void* stream) {
  if (max_depth + 1 > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((width + 15) / 16, (row_hi - row_lo + 15) / 16);
  const SolidArgs none{};
  const SolidArgs& sa = solids != nullptr ? *solids : none;
  const int n_blocks = static_cast<int>(grid.x * grid.y);
  const int n_cols =
      kSlotCols * (n_slots + sa.n_quads + sa.n_boxes + sa.n_media) +
      kCamBgCols;
  size_t smem;
  const auto kernel =
      bwd_kernel(n_slots, moving != 0, solids, tex != nullptr, smem);
  const int err = launch_tiles(kernel, grid, smem, st, sph, n_slots, cam, bg,
                               sa, tex_view(tex), d_rad, lengths, winners,
                               win_cap, s0, s1, lo, width, row_lo, row_hi,
                               spp, max_depth, rr_depth, t_min, scratch,
                               mismatches);
  if (err != 0) return err;
  return static_cast<int>(
      reduce_partials(scratch, n_blocks, n_cols, sums, st));
}

// The instantiation rrt_train_fwd (kernel 0) or rrt_train_bwd (kernel 1)
// would launch for n_slots sphere slots, `solids` (or null) and a
// texture variant (tex nonzero) on the current device: the dynamic shared
// memory it would take (smem_out), what a block of it may opt into (the
// device's opt-in limit less the kernel's static arrays: room_out), and
// its blocks an SM at those bytes (0 when they pass the room). The
// wrappers call it before every launch and raise when smem_out passes
// room_out. Returns a cudaError_t.
extern "C" int rrt_train_blocks(int kernel, int n_slots, int moving,
                                const SolidArgs* solids, int tex,
                                int* blocks, long long* smem_out,
                                long long* room_out) {
  size_t smem;
  const void* fn =
      kernel == 0 ? reinterpret_cast<const void*>(fwd_kernel(
                        n_slots, moving != 0, solids, tex != 0, smem))
                  : reinterpret_cast<const void*>(bwd_kernel(
                        n_slots, moving != 0, solids, tex != 0, smem));
  *smem_out = static_cast<long long>(smem);
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *room_out = static_cast<long long>(optin) -
              static_cast<long long>(attr.sharedSizeBytes);
  *blocks = 0;
  if (*smem_out > *room_out) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                        kBwdThreads, smem);
  }
  return static_cast<int>(err);
}
