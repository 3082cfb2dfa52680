// Device functions of one path-tracing bounce, shared by the forward
// (tile_render.cu), the train kernels (train.cu), the queue and batch
// drivers' kernels (queue.cu) and the bounce chain's backward
// (chain.cu), so that all of them run the same arithmetic under the same
// flags (-fmad=false, see the note on floats in tile_render.cu):
// Threefry, uniforms, Box-Muller, the thin-lens camera ray, the
// closest-sphere scan (train_fwd, train_bwd) and the BVH walk that gives
// the scan's (t, winner) bit for bit (every other kernel), the shading
// step of the winner, which exposes its decisions and intermediates to
// the backward, one bounce over either (bounce_step) and the
// back-to-back loop over a pixel's samples (trace_pixel: tile_render and
// train_fwd).
//
// Subset of rrt_tpu/ops/megakernel.py::_one_bounce: stationary and
// moving spheres, quads, boxes and constant media, solid, checker,
// perlin-marble and image textures, lambertian / metal / dielectric /
// diffuse_light / isotropic materials, sky or solid background, and
// Russian roulette (finish_bounce: rr_depth, a runtime argument).
//
// The solid families (kSolids = true: quads, boxes and emission, which
// the scenes with quads, boxes or a diffuse_light launch): each segment
// first tests the active quads, then the active boxes, as scalar loops
// over their rows staged in shared memory (stage_solids), each family
// seeded by the one before and won only by a strictly smaller t, so a
// quad wins an exact tie, then a box; the sphere scan or BVH walk is
// then seeded by that t (rrt_tpu's _one_bounce, megakernel.py:811-1150).
// The forward kernels', train_fwd's and chain_bwd's kWalk
// instantiations (a scene with a family past kSolidCap active slots,
// rttnw_final's 400 ground boxes) walk that
// family's tree instead (solid_walk: the loop's (t, slot) bit for bit),
// staged after the rows (stage_forward_solids); the other instantiations
// never compile it.
// A quad's normal is n / |n|, a box's the axis of its frame whose |q_k| -
// h_k is largest at the hit point, rotated back; a hit on a diffuse_light
// banks throughput x its color and ends the path (:1457-1489). Then the
// constant media (RTTNW ch. 9, :1153-1233), a loop over the active media
// whose length is set at run time, read from their pack in device memory
// (every thread of a warp reads the same row): each medium's boundary
// interval (a sphere's quadratic, an oriented box's slabs), clipped to
// [t_min, the closest solid's t] and to t >= 0, holds a distance
// -log(u) / density along the ray, u the medium's STREAM_MEDIUM draw; the
// first medium with the strictly smallest such t wins if it is strictly
// below the solid's. A medium's hit scatters isotropically (the in-sphere
// draw), its normal the constant (1, 0, 0), its albedo its pack's. The
// kSolids = false instantiations, which the sphere scenes launch, are the
// sphere subset's code as it was; a scene of media alone runs kSolids
// with no quad or box.
//
// Moving spheres (kMoving = true, the scene's has_moving): a sphere's
// center at a ray's time is base + time * vel, pack rows 0-2 and 4-6, in
// the closest-sphere scan (rrt_tpu's megakernel.py:1033-1038) and in the
// shading normal (:1247-1250); each ray carries its time, the camera's
// shutter draw. The velocity rows are staged in shared memory beside the
// intersection rows (a second float4 a slot, 8 KB at 512 slots). The
// kMoving = false instantiation reads no time and runs the static
// arithmetic unchanged.
//
// Textures (kTex = true, a scene with perlin or image textures; the
// kTex = false instantiations never compile this code): the marble
// (RTTNW ch. 5.7, rrt_tpu's _noise_rows / _turb_rows and :1351-1357) is
// 7 octaves of a hashed gradient lattice, 8 corners each, u32 hashes
// and rsqrtf a corner, blended by the hermite weights, its albedo 0.5 (1
// + sin(scale z + 10 turb)) color1; the image (:1358-1404) reads one
// texel of the atlas in device memory (ops/megakernel.py TexPack: rgb
// and a pad, one 16-byte load, L2-resident) at the winner's uv: a
// sphere's from rrt_tpu's kernel polynomials for atan2 and acos (so the
// plain versions, geometry.sphere_uv, pick the same texel), a quad's
// (alpha, beta) on its staged frame. The TPU's one-hot MXU contraction
// of the atlas is not carried over. The adjoint (adjoint.cuh) replays
// the texel and differentiates the marble analytically.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The host's argument of the solid families (ops/_build.py SolidArgs):
// the quad (24, quad_slots) and box (24, box_slots) packs in device
// memory, whose first n_quads and n_boxes slots are tested; a null
// pointer in its place launches the sphere variant. The forward kernels,
// train_fwd and chain_bwd also read the families' trees
// (rrt_tpu_torch/accel.py SolidBvh; none, n_nodes 0, for a family they
// loop over, and for train_bwd, which loops). Outside the anonymous
// namespace: the extern "C" entry points take it, and a type of internal
// linkage in their signature would hide them.
struct SolidArgs {
  const float* quad;
  int quad_slots, n_quads;
  const float* box;
  int box_slots, n_boxes;
  const float* med;  // the (D, 24) medium pack, rows [0, n_media) tested
  int n_media;
  const float* quad_nodes;  // (quad_n_nodes, 8) f32, accel.py's layout
  const int* quad_rows;     // (quad_n_rows,) the quads' slots, walk order
  int quad_n_nodes, quad_n_rows, quad_n_always;
  const float* box_nodes;
  const int* box_rows;
  int box_n_nodes, box_n_rows, box_n_always;
};

// The host's argument of the textures (ops/_build.py TexArgs): the atlas
// of n_img * ah * aw texels, four floats each (rgb, 0), and the
// backward's atlas cotangent of the same layout (null in a forward); a
// null pointer in its place launches the variant without textures.
struct TexArgs {
  const float* atlas;
  float* d_atlas;
  int n_img, ah, aw;
};

// A kernel's view of the textures (kTex): TexArgs as float4 texels.
struct TexView {
  const float4* atlas;
  float4* d_atlas;
  int n_img, ah, aw;
};

inline TexView tex_view(const TexArgs* t) {
  TexView v{nullptr, nullptr, 1, 1, 1};
  if (t != nullptr) {
    v.atlas = reinterpret_cast<const float4*>(t->atlas);
    v.d_atlas = reinterpret_cast<float4*>(t->d_atlas);
    v.n_img = t->n_img;
    v.ah = t->ah;
    v.aw = t->aw;
  }
  return v;
}

// One of the 8 instantiations F<kMoving, kSolids, kTex> of a launch
// function, chosen at run time; RRT_PICK_WALK one of the 4 with solid
// trees to walk, F<kMoving, true, kTex, true> (a kWalk instantiation).
#define RRT_PICK3(F, a, b, c)                                             \
  ((a) ? ((b) ? ((c) ? F<true, true, true> : F<true, true, false>)       \
              : ((c) ? F<true, false, true> : F<true, false, false>))    \
       : ((b) ? ((c) ? F<false, true, true> : F<false, true, false>)     \
              : ((c) ? F<false, false, true> : F<false, false, false>)))
#define RRT_PICK_WALK(F, a, c)                                            \
  ((a) ? ((c) ? F<true, true, true, true> : F<true, true, false, true>)  \
       : ((c) ? F<false, true, true, true> : F<false, true, false, true>))

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTwoPi = 6.28318548f;  // f32(2 pi), as the reference rounds
constexpr uint32_t kPairStep = 0x9E3779B9u;
constexpr uint32_t kNumStreams = 8u;
constexpr uint32_t kStreamScatter = 1u;
constexpr uint32_t kStreamMedium = 2u;
constexpr uint32_t kStreamRr = 3u;

// Sphere pack rows (row-major (24, S)).
constexpr int kRowR2 = 3;  // r^2 (-1 on invalid slots)
constexpr int kRowVel = 4;  // 4-6: motion velocity (0 on static slots)
constexpr int kRowMatType = 8;
constexpr int kRowAux = 9;  // fuzz (metal) or ior (dielectric)
constexpr int kRowColor1 = 10;
constexpr int kRowColor2 = 13;
constexpr int kRowTexType = 16;
constexpr int kRowTexScale = 17;
constexpr int kRowRadius = 18;  // signed: negative flips the normal
constexpr int kRowImage = 19;  // the texture's image index

// Camera pack (24,).
constexpr int kCamOrigin = 0, kCamLowerLeft = 3, kCamHorizontal = 6,
              kCamVertical = 9, kCamU = 12, kCamV = 15, kCamLens = 18,
              kCamTime0 = 19, kCamDt = 20, kCamW = 21, kCamH = 22,
              kCamHm1 = 23;

// A winner's material rows, from its pack's material row on (spheres 8,
// quads 10, boxes 9), a row a pack width apart: type, aux (fuzz or ior),
// color1 rgb, color2 rgb, texture type, texture scale.
constexpr int kMatType = 0, kMatAux = 1, kMatColor1 = 2, kMatColor2 = 5,
              kMatTexType = 8, kMatTexScale = 9;
constexpr int kQuadMatRow = 10, kBoxMatRow = 9;
constexpr int kQuadImageRow = 20;  // a quad's image index

constexpr float kMatLambertian = 0.0f, kMatMetal = 1.0f,
                kMatDielectric = 2.0f, kMatDiffuseLight = 3.0f,
                kMatIsotropic = 4.0f, kTexChecker = 1.0f,
                kTexPerlin = 2.0f, kTexImage = 3.0f;

// Families of a closest hit (rrt_tpu.geometry's FAM_*).
constexpr int kFamNone = -1, kFamSphere = 0, kFamQuad = 1, kFamMedium = 2,
              kFamBox = 3;

// A winner as one int (train_fwd's int16 residual, the backwards'
// records; ops/megakernel.py encode_winner): a sphere's slot, kQuadCode
// + a quad's, kBoxCode + a box's, kMediumCode + a medium's; -1 a miss.
// kQuadCode is the most sphere slots a kernel stages (MAX_SLOTS); each
// later family gets kCodeSpan codes (ops/megakernel.py CODE_SPAN), more
// slots than a block's shared memory stages (32 bytes a box), and the
// last code, kMediumCode + kCodeSpan - 1, fits an int16.
constexpr int kCodeSpan = 8192;
constexpr int kQuadCode = 3072, kBoxCode = kQuadCode + kCodeSpan,
              kMediumCode = kBoxCode + kCodeSpan;

__device__ __forceinline__ int winner_code(int fam, int win) {
  return fam == kFamQuad
             ? kQuadCode + win
             : (fam == kFamBox ? kBoxCode + win
                               : (fam == kFamMedium ? kMediumCode + win
                                                    : win));
}

// The family and slot of a winner code >= 0.
__device__ __forceinline__ int code_family(int code, int& slot) {
  if (code >= kMediumCode) {
    slot = code - kMediumCode;
    return kFamMedium;
  }
  if (code >= kBoxCode) {
    slot = code - kBoxCode;
    return kFamBox;
  }
  if (code >= kQuadCode) {
    slot = code - kQuadCode;
    return kFamQuad;
  }
  slot = code;
  return kFamSphere;
}

// What a bounce did: the path banked the background, or ended on a
// surface, or goes on, or banked a light's emission and ended.
enum Outcome { kMissed = 0, kAbsorbed = 1, kScattered = 2, kEmitted = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

// Threefry-2x32, 20 rounds (rrt_tpu/rng.py threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += ks2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += ks2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += ks2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += ks2; x1 += k0 + 5u;
  o0 = x0; o1 = x1;
}

// u32 -> [0, 1) from the top 24 bits, through int32 like the reference.
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return static_cast<float>(static_cast<int32_t>(bits >> 8)) *
         (1.0f / 16777216.0f);
}

// Russian roulette (rrt_tpu's _one_bounce RR block, render._apply_rr):
// from bounce rr_depth on (rr_depth > 0), a path that scatters below
// max_depth goes on with probability p = clip(max(tn), 0.05, 1) of its
// throughput after the attenuation, tn = thr * att, and its throughput
// becomes tn * (1 / p); otherwise it is absorbed where it stands.
__host__ __device__ __forceinline__ bool rr_on(int bounce, int rr_depth) {
  return rr_depth > 0 && bounce >= rr_depth;
}

__device__ __forceinline__ float rr_p(const float* tn) {
  return fminf(fmaxf(fmaxf(tn[0], fmaxf(tn[1], tn[2])), 0.05f), 1.0f);
}

// The coin at `bounce`: word a of threefry2x32(k0, k1, bounce * 8 +
// STREAM_RR, 0) (rng.rr_draw), threefry2x32's arithmetic in rolled loops
// (the key words rotate through the five injections). Inlined unrolled,
// the coin's 20 rounds slowed chap12's train_fwd by 4-6% on an H100
// although an rr_depth 0 launch never draws it; rolled, by 0-2% (PERF.md
// §6, Russian roulette).
__device__ __forceinline__ float rr_uniform(uint32_t k0, uint32_t k1,
                                            int bounce) {
  uint32_t ka = k1, kb = k0 ^ k1 ^ 0x1BD11BDAu, kc = k0;
  uint32_t x0 = static_cast<uint32_t>(bounce) * kNumStreams + kStreamRr + k0;
  uint32_t x1 = k1;
#pragma unroll 1
  for (uint32_t i = 0; i < 5; ++i) {
    // Rotations 13, 15, 26, 6 after even injections, 17, 29, 16, 24 after
    // odd ones, a byte each.
    const uint32_t rot = (i & 1u) ? 0x18101D11u : 0x061A0F0Du;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const int r = static_cast<int>((rot >> (8 * j)) & 0xFFu);
      x0 += x1;
      x1 = rotl(x1, r) ^ x0;
    }
    x0 += ka;
    x1 += kb + i + 1u;
    const uint32_t t = ka;
    ka = kb;
    kb = kc;
    kc = t;
  }
  return to_uniform(x0);
}

// The 1 / p a surviving bounce's throughput took (1 where RR does not
// act), recomputed from its input throughput thr and attenuation att in
// the forward's order: the backwards' detached weight.
__device__ __forceinline__ float rr_inv_p(const float* thr, const float* att,
                                          int bounce, int rr_depth) {
  if (!rr_on(bounce, rr_depth)) return 1.0f;
  const float tn[3] = {thr[0] * att[0], thr[1] * att[1], thr[2] * att[2]};
  return 1.0f / rr_p(tn);
}

// 2*n_pairs uniforms of one counter (rrt_tpu/rng.py _words).
template <int kPairs>
__device__ __forceinline__ void uniforms(uint32_t k0, uint32_t k1,
                                         uint32_t counter, float* u) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    uint32_t a, b;
    threefry2x32(k0, k1, counter, static_cast<uint32_t>(p) * kPairStep + p,
                 a, b);
    u[2 * p] = to_uniform(a);
    u[2 * p + 1] = to_uniform(b);
  }
}

__device__ __forceinline__ void box_muller(float u1, float u2, float& g0,
                                           float& g1) {
  const float r = sqrtf(-2.0f * logf(fmaxf(1.0f - u1, 1e-12f)));
  const float th = kTwoPi * u2;
  g0 = r * cosf(th);
  g1 = r * sinf(th);
}

// The camera's draws of one sample: pixel jitter, lens disc and the
// shutter draw.
struct CamDraws {
  float jx, jy, dcx, dcy, tu;
};

__device__ __forceinline__ CamDraws camera_draws(uint32_t k0, uint32_t k1) {
  float u[6];
  uniforms<3>(k0, k1, 0u, u);
  const float r = sqrtf(u[2]);
  const float theta = kTwoPi * u[3];
  CamDraws c;
  c.jx = u[0];
  c.jy = u[1];
  c.dcx = r * cosf(theta);
  c.dcy = r * sinf(theta);
  c.tu = u[4];
  return c;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float time;  // read by the moving-sphere variant only
};

// Thin-lens camera ray (rrt_tpu/ops/megakernel.py _camera_rays); the
// time is time0 + (time1 - time0) * u, as megakernel_vjp.camera_ray_rows.
__device__ __forceinline__ Ray camera_ray(const float* cam,
                                          const CamDraws& c, float pxf,
                                          float pyf) {
  const float s = (pxf + c.jx) / cam[kCamW];
  const float t = ((cam[kCamHm1] - pyf) + c.jy) / cam[kCamH];
  const float rdx = cam[kCamLens] * c.dcx;
  const float rdy = cam[kCamLens] * c.dcy;
  Ray ray;
  ray.ox = cam[kCamOrigin + 0] + cam[kCamU + 0] * rdx + cam[kCamV + 0] * rdy;
  ray.oy = cam[kCamOrigin + 1] + cam[kCamU + 1] * rdx + cam[kCamV + 1] * rdy;
  ray.oz = cam[kCamOrigin + 2] + cam[kCamU + 2] * rdx + cam[kCamV + 2] * rdy;
  ray.dx = cam[kCamLowerLeft + 0] + cam[kCamHorizontal + 0] * s +
           cam[kCamVertical + 0] * t - ray.ox;
  ray.dy = cam[kCamLowerLeft + 1] + cam[kCamHorizontal + 1] * s +
           cam[kCamVertical + 1] * t - ray.oy;
  ray.dz = cam[kCamLowerLeft + 2] + cam[kCamHorizontal + 2] * s +
           cam[kCamVertical + 2] * t - ray.oz;
  ray.time = cam[kCamTime0] + cam[kCamDt] * c.tu;
  return ray;
}

// The ray's dot products the sphere quadratic reuses for every slot.
struct RayDots {
  float a, o_dot_d, o_dot_o, inv_a;
};

__device__ __forceinline__ RayDots ray_dots(const Ray& r) {
  RayDots q;
  q.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  q.o_dot_d = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  q.o_dot_o = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  q.inv_a = 1.0f / q.a;
  return q;
}

// The expanded quadratic of _one_bounce for one sphere (center c,
// squared radius r2): half_b, c_coef and the discriminant.
struct Quadratic {
  float half_b, c_coef, disc;
};

// |c|^2 of a center, as quadratic() computes it.
__device__ __forceinline__ float center_sq(float cx, float cy, float cz) {
  return cx * cx + cy * cy + cz * cz;
}

// quadratic() with |c|^2 given (center_sq, computed once a slot).
__device__ __forceinline__ Quadratic quadratic(const Ray& r,
                                               const RayDots& q, float cx,
                                               float cy, float cz,
                                               float c_sq, float r2) {
  const float d_c = r.dx * cx + r.dy * cy + r.dz * cz;
  const float o_c = r.ox * cx + r.oy * cy + r.oz * cz;
  Quadratic k;
  k.half_b = q.o_dot_d - d_c;
  k.c_coef = q.o_dot_o - 2.0f * o_c + c_sq - r2;
  k.disc = k.half_b * k.half_b - q.a * k.c_coef;
  return k;
}

__device__ __forceinline__ Quadratic quadratic(const Ray& r,
                                               const RayDots& q, float cx,
                                               float cy, float cz,
                                               float r2) {
  return quadratic(r, q, cx, cy, cz, center_sq(cx, cy, cz), r2);
}

// Slot i's staged center and r^2 (x, y, z, w), the center at `time`
// when the spheres move (base + time * vel).
template <bool kMoving>
__device__ __forceinline__ float4 slot_center(const float4* sph4,
                                              const float4* vel4, int i,
                                              float time) {
  float4 c = sph4[i];
  if (kMoving) {
    const float4 v = vel4[i];
    c.x = c.x + time * v.x;
    c.y = c.y + time * v.y;
    c.z = c.z + time * v.z;
  }
  return c;
}

// The nearer root of a quadratic with a positive discriminant that
// clears t_min, kInf when neither does.
__device__ __forceinline__ float nearest_root(const Quadratic& k,
                                              const RayDots& q,
                                              float t_min) {
  const float sq = sqrtf(k.disc);
  const float root0 = (-k.half_b - sq) * q.inv_a;
  const float root1 = (-k.half_b + sq) * q.inv_a;
  const float t0c = root0 > t_min ? root0 : kInf;
  const float t1c = root1 > t_min ? root1 : kInf;
  return fminf(t0c, t1c);
}

// Closest sphere: a strict `<` running minimum over the slots in order,
// the first minimum winning like argmin. sph4: rows 0-3 of each slot;
// vel4: rows 4-6 (kMoving only), the center at the ray's time being
// base + time * vel. With kCsq (static spheres only), csq holds each
// slot's center_sq (stage_center_sq), the same bits as computing it
// here. Returns t (kInf on a miss) and the winner in `win`. Seeded by
// another family's t_seed, a sphere must beat it strictly, and t_seed
// comes back when none does.
template <bool kMoving, bool kCsq = false>
__device__ __forceinline__ float closest_sphere(const float4* sph4,
                                                const float4* vel4,
                                                int n_slots, const Ray& r,
                                                const RayDots& q,
                                                float t_min, int& win,
                                                const float* csq = nullptr,
                                                float t_seed = kInf) {
  static_assert(!(kMoving && kCsq), "a moving center's |c|^2 varies");
  float t_best = t_seed;
  win = 0;
  for (int i = 0; i < n_slots; ++i) {
    const float4 c = slot_center<kMoving>(sph4, vel4, i, r.time);
    const Quadratic k = kCsq ? quadratic(r, q, c.x, c.y, c.z, csq[i], c.w)
                             : quadratic(r, q, c.x, c.y, c.z, c.w);
    if (k.disc > 0.0f) {
      const float t_cand = nearest_root(k, q, t_min);
      if (t_cand < t_best) {
        t_best = t_cand;
        win = i;
      }
    }
  }
  return t_best;
}

// The closest_sphere test of slot i alone: its t (kInf when it gives no
// root beyond t_min), by the scan's arithmetic on the same staged rows,
// so a recomputed winner has the scan's t bit for bit.
template <bool kMoving>
__device__ __forceinline__ float slot_t(const float4* sph4,
                                        const float4* vel4, int i,
                                        const Ray& r, const RayDots& q,
                                        float t_min) {
  const float4 c = slot_center<kMoving>(sph4, vel4, i, r.time);
  const Quadratic k = quadratic(r, q, c.x, c.y, c.z, c.w);
  return k.disc > 0.0f ? nearest_root(k, q, t_min) : kInf;
}

// The miss shader: sky lerp or solid background. Also gives tsky and
// the direction's inverse length for the backward.
__device__ __forceinline__ void background(const float* bg, bool sky,
                                           float dy, float a, float* rgb,
                                           float& tsky, float& inv_len) {
  inv_len = rsqrtf(fmaxf(a, 1e-20f));
  tsky = 0.5f * (dy * inv_len + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[c] = sky ? (1.0f - tsky) * bg[c] + tsky * bg[3 + c] : bg[c];
  }
}

// The winner's shading step and every intermediate the backward needs.
struct Shade {
  float h[3];      // hit point
  float inv_r;     // 1 / signed radius
  float sgn;       // +1 front face, -1 back face
  float n[3];      // normal against the ray
  float mtype, aux;
  bool front, use_c2;
  float alb[3];
  float unit[3];   // lambertian draw: unit vector
  float sv[3];     // metal draw: point in the unit sphere
  bool degen;      // lambertian n + unit ~ 0: direction n
  float inv_dl;    // 1 / |d| (metal, dielectric)
  float ud[3], ud_n, rf[3];
  float ratio, cos_t, rp[3];
  bool reflect;    // dielectric reflects
  float nd[3];     // new direction
  bool scattered;
  // Textures (kTex): the caller's uv (the image's column and row
  // coordinates in [0, 1]) and image index; the marble's factor and
  // phase and (the adjoint's) its turbulence's gradient; the texel read.
  float tu, tv, img;
  float marble, phase, dturb[3];
  int texel;
};

// ---------------------------------------------------------------------------
// Textures (kTex)
// ---------------------------------------------------------------------------

// The gradient at an integer lattice point (rrt_tpu/textures.py
// _lattice_grad): a u32 hash, three 10-bit fields in [-1, 1), scaled to
// about unit length.
__device__ __forceinline__ void lattice_grad(int ix, int iy, int iz,
                                             float& gx, float& gy,
                                             float& gz) {
  uint32_t h = static_cast<uint32_t>(ix) * 0x8DA6B343u +
               static_cast<uint32_t>(iy) * 0xD8163841u +
               static_cast<uint32_t>(iz) * 0xCB1AB31Fu;
  h = h ^ (h >> 13);
  h = h * 0x85EBCA6Bu;
  h = h ^ (h >> 16);
  constexpr float kScale = 2.0f / 1024.0f;
  gx = static_cast<float>(static_cast<int>(h & 1023u)) * kScale - 1.0f;
  gy = static_cast<float>(static_cast<int>((h >> 10) & 1023u)) * kScale -
       1.0f;
  gz = static_cast<float>(static_cast<int>((h >> 20) & 1023u)) * kScale -
       1.0f;
  const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-6f));
  gx = gx * inv;
  gy = gy * inv;
  gz = gz * inv;
}

// Gradient-lattice noise at q (rrt_tpu's _noise_rows): the hermite
// blend of the 8 corners' gradient dots, in its order. With kGrad, also
// its gradient in q (floor and the hash are constant).
template <bool kGrad>
__device__ __forceinline__ float lattice_noise(float qx, float qy, float qz,
                                               float* grad) {
  const float fx = floorf(qx), fy = floorf(qy), fz = floorf(qz);
  const float ux = qx - fx, uy = qy - fy, uz = qz - fz;
  const int i = static_cast<int>(fx), j = static_cast<int>(fy),
            k = static_cast<int>(fz);
  const float s[3] = {ux * ux * (3.0f - 2.0f * ux),
                      uy * uy * (3.0f - 2.0f * uy),
                      uz * uz * (3.0f - 2.0f * uz)};
  // The hermite weights' derivatives, 6 u (1 - u).
  const float ds[3] = {6.0f * ux * (1.0f - ux), 6.0f * uy * (1.0f - uy),
                       6.0f * uz * (1.0f - uz)};
  float acc = 0.0f;
  if (kGrad) grad[0] = grad[1] = grad[2] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
    float gx, gy, gz;
    lattice_grad(i + di, j + dj, k + dk, gx, gy, gz);
    const float dotv = gx * (ux - static_cast<float>(di)) +
                       gy * (uy - static_cast<float>(dj)) +
                       gz * (uz - static_cast<float>(dk));
    const float wx = di ? s[0] : 1.0f - s[0];
    const float wy = dj ? s[1] : 1.0f - s[1];
    const float wz = dk ? s[2] : 1.0f - s[2];
    acc = acc + wx * wy * wz * dotv;
    if (kGrad) {
      const float dwx = di ? ds[0] : -ds[0];
      const float dwy = dj ? ds[1] : -ds[1];
      const float dwz = dk ? ds[2] : -ds[2];
      grad[0] += dwx * wy * wz * dotv + wx * wy * wz * gx;
      grad[1] += wx * dwy * wz * dotv + wx * wy * wz * gy;
      grad[2] += wx * wy * dwz * dotv + wx * wy * wz * gz;
    }
  }
  return acc;
}

// Turbulence at p, sum over 7 octaves of 0.5^k |noise(2^k p)| (rrt_tpu's
// _turb_rows); with kGrad, also its gradient in p (d|n|/dn = sign(n),
// 0 at 0).
template <bool kGrad>
__device__ __forceinline__ float turbulence(const float* p, float* grad) {
  float acc = 0.0f, w = 1.0f, sc = 1.0f;
  if (kGrad) grad[0] = grad[1] = grad[2] = 0.0f;
#pragma unroll 1
  for (int od = 0; od < 7; ++od) {
    float g[3];
    const float n = lattice_noise<kGrad>(p[0] * sc, p[1] * sc, p[2] * sc, g);
    acc = acc + w * fabsf(n);
    if (kGrad) {
      const float k = n > 0.0f ? w * sc : (n < 0.0f ? -w * sc : 0.0f);
      grad[0] += k * g[0];
      grad[1] += k * g[1];
      grad[2] += k * g[2];
    }
    w = w * 0.5f;
    sc = sc * 2.0f;
  }
  return acc;
}

// atan on [-1, 1] (rrt_tpu's _atan_poly, max error about 1e-5) and the
// atan2 and acos built on it (_atan2_rows, _acos_rows), the plain
// versions' geometry.atan2_poly and sphere_uv.
__device__ __forceinline__ float atan_poly(float z) {
  const float z2 = z * z;
  return z * (0.9998660f +
              z2 * (-0.3302995f +
                    z2 * (0.1801410f + z2 * (-0.0851330f + z2 * 0.0208351f))));
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = swap ? ax : ay;
  const float den = fmaxf(swap ? ay : ax, 1e-30f);
  float r = atan_poly(num / den);
  r = swap ? 1.57079637f - r : r;  // f32(pi / 2) - r
  r = x < 0.0f ? 3.14159274f - r : r;
  return y < 0.0f ? -r : r;
}

// A sphere's texture coordinates at the hit point h, center c, signed
// radius srad: tu = clip((atan2(-z, x) + pi) / (2 pi)), tv = 1 -
// clip(acos(-y) / pi) of the unit outward vector (rrt_tpu's kernel).
__device__ __forceinline__ void sphere_uv(const float* h, const float* c,
                                          float srad, float& tu, float& tv) {
  const float inv_ar = 1.0f / fmaxf(fabsf(srad), 1e-20f);
  const float ux = (h[0] - c[0]) * inv_ar;
  const float uy = (h[1] - c[1]) * inv_ar;
  const float uz = (h[2] - c[2]) * inv_ar;
  const float y = fminf(fmaxf(-uy, -1.0f), 1.0f);
  const float theta = atan2_poly(sqrtf(fmaxf(1.0f - y * y, 0.0f)), y);
  const float phi = atan2_poly(-uz, ux) + 3.14159274f;
  tu = fminf(fmaxf(phi * 0.159154937f, 0.0f), 1.0f);  // f32(0.5 / pi)
  tv = 1.0f - fminf(fmaxf(theta * 0.318309873f, 0.0f), 1.0f);  // f32(1/pi)
}

// The texel a nearest lookup reads at (tu, tv) of image `img`:
// x = int(tu aw), y = int(tv ah), clipped to the grid.
__device__ __forceinline__ int texel_index(const TexView& t, float tu,
                                           float tv, float img) {
  const int xi = min(max(static_cast<int>(tu * static_cast<float>(t.aw)), 0),
                     t.aw - 1);
  const int yi = min(max(static_cast<int>(tv * static_cast<float>(t.ah)), 0),
                     t.ah - 1);
  const int im = min(max(static_cast<int>(img), 0), t.n_img - 1);
  return (im * t.ah + yi) * t.aw + xi;
}

// The winner's center at the ray's time: pack rows 0-2, plus time times
// rows 4-6 when the spheres move.
template <bool kMoving>
__device__ __forceinline__ void center_at(const float* col, int n_slots,
                                          float time, float* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    c[j] = kMoving ? col[j * n_slots] + time * col[(kRowVel + j) * n_slots]
                   : col[j * n_slots];
  }
}

// The mirror direction of a metal or dielectric hit: 1/|d|, the unit
// direction, its cosine with the normal and the reflection.
__device__ __forceinline__ void mirror(const Ray& r, float a, Shade& sh) {
  const float nx = sh.n[0], ny = sh.n[1], nz = sh.n[2];
  sh.inv_dl = 1.0f / fmaxf(sqrtf(a), 1e-20f);
  sh.ud[0] = r.dx * sh.inv_dl;
  sh.ud[1] = r.dy * sh.inv_dl;
  sh.ud[2] = r.dz * sh.inv_dl;
  sh.ud_n = sh.ud[0] * nx + sh.ud[1] * ny + sh.ud[2] * nz;
  sh.rf[0] = sh.ud[0] - 2.0f * sh.ud_n * nx;
  sh.rf[1] = sh.ud[1] - 2.0f * sh.ud_n * ny;
  sh.rf[2] = sh.ud[2] - 2.0f * sh.ud_n * nz;
}

// A dielectric's refracted direction (rp, then nd), once it refracts.
__device__ __forceinline__ void refract(Shade& sh) {
  const float nx = sh.n[0], ny = sh.n[1], nz = sh.n[2];
  sh.rp[0] = sh.ratio * (sh.ud[0] + sh.cos_t * nx);
  sh.rp[1] = sh.ratio * (sh.ud[1] + sh.cos_t * ny);
  sh.rp[2] = sh.ratio * (sh.ud[2] + sh.cos_t * nz);
  const float rlen = sqrtf(fmaxf(
      1.0f - (sh.rp[0] * sh.rp[0] + sh.rp[1] * sh.rp[1] +
              sh.rp[2] * sh.rp[2]),
      0.0f));
  sh.nd[0] = sh.rp[0] - rlen * nx;
  sh.nd[1] = sh.rp[1] - rlen * ny;
  sh.nd[2] = sh.rp[2] - rlen * nz;
}

// The in-sphere draw of a metal's fuzz and an isotropic scatter: the unit
// vector of three normals times cbrt(u), as exp(log(u) / 3).
__device__ __forceinline__ void in_sphere(float g3, float g4, float g5,
                                          float u, float* sv) {
  const float inv2 = rsqrtf(fmaxf(g3 * g3 + g4 * g4 + g5 * g5, 1e-20f));
  const float rad3 = expf(logf(fmaxf(u, 1e-12f)) * (1.0f / 3.0f));
  sv[0] = g3 * inv2 * rad3;
  sv[1] = g4 * inv2 * rad3;
  sv[2] = g5 * inv2 * rad3;
}

// The material half of a shade: the face against the ray of the winner's
// outward normal `out`, its material and texture at the hit point sh.h
// (the rows from `mat` on, a row `stride` floats apart: kMatType ...),
// and the scatter (shade's `kept` and kForAdjoint). With kEmit, a
// diffuse_light draws nothing and does not scatter, and keeps its
// checker parity in kept[0] (1 or 0: the emission's adjoint reads it).
// With kTex, a marble or image texture gives the albedo (the image's
// uv and index from the caller, in sh.tu, sh.tv, sh.img; the atlas
// `tex`); kForAdjoint then also keeps the turbulence's gradient.
template <bool kForAdjoint, bool kEmit = false, bool kTex = false>
__device__ __forceinline__ void shade_material(const float* mat, int stride,
                                               const Ray& r, float a,
                                               const float* out,
                                               uint32_t k0, uint32_t k1,
                                               int bounce, Shade& sh,
                                               float* kept,
                                               const TexView* tex = nullptr) {
  sh.front = r.dx * out[0] + r.dy * out[1] + r.dz * out[2] < 0.0f;
  sh.sgn = sh.front ? 1.0f : -1.0f;
  sh.n[0] = out[0] * sh.sgn;
  sh.n[1] = out[1] * sh.sgn;
  sh.n[2] = out[2] * sh.sgn;
  sh.mtype = mat[kMatType * stride];
  sh.aux = mat[kMatAux * stride];

  // --- texture: solid or checker (RTTNW ch. 4.3 sine form).
  sh.use_c2 = false;
  if (mat[kMatTexType * stride] == kTexChecker) {
    const float ts = mat[kMatTexScale * stride];
    sh.use_c2 = sinf(ts * sh.h[0]) * sinf(ts * sh.h[1]) * sinf(ts * sh.h[2]) <
                0.0f;
  }
  const int c_row = sh.use_c2 ? kMatColor2 : kMatColor1;
  sh.alb[0] = mat[c_row * stride];
  sh.alb[1] = mat[(c_row + 1) * stride];
  sh.alb[2] = mat[(c_row + 2) * stride];
  if constexpr (kTex) {
    const float tt = mat[kMatTexType * stride];
    if (tt == kTexPerlin) {
      const float turb = turbulence<kForAdjoint>(sh.h, sh.dturb);
      sh.phase = mat[kMatTexScale * stride] * sh.h[2] + 10.0f * turb;
      sh.marble = 0.5f * (1.0f + sinf(sh.phase));
      sh.alb[0] = sh.marble * sh.alb[0];
      sh.alb[1] = sh.marble * sh.alb[1];
      sh.alb[2] = sh.marble * sh.alb[2];
    } else if (tt == kTexImage) {
      sh.texel = texel_index(*tex, sh.tu, sh.tv, sh.img);
      const float4 c = tex->atlas[sh.texel];
      sh.alb[0] = c.x;
      sh.alb[1] = c.y;
      sh.alb[2] = c.z;
    }
  }

  if constexpr (kForAdjoint) {
    sh.reflect = false;
    if (sh.mtype == kMatLambertian) return;
    mirror(r, a, sh);
    if (sh.mtype == kMatMetal) {
      sh.sv[0] = kept[0];
      sh.sv[1] = kept[1];
      sh.sv[2] = kept[2];
    } else if (sh.mtype == kMatDielectric) {
      sh.ratio = sh.front ? 1.0f / fmaxf(sh.aux, 1e-20f) : sh.aux;
      sh.cos_t = fminf(-sh.ud_n, 1.0f);
      sh.reflect = kept[0] != 0.0f;
      if (!sh.reflect) refract(sh);
    }
    return;
  }
  if constexpr (kEmit) {
    if (sh.mtype == kMatDiffuseLight) {  // emits sh.alb; draws nothing
      sh.scattered = false;
      if (kept != nullptr) kept[0] = sh.use_c2 ? 1.0f : 0.0f;
      return;
    }
  }

  // --- scatter draws (rrt_tpu/ops/megakernel.py _draws).
  float u[8];
  uniforms<4>(k0, k1,
              static_cast<uint32_t>(bounce) * kNumStreams + kStreamScatter,
              u);
  float g0, g1, g2, g3, g4, g5;
  box_muller(u[0], u[1], g0, g1);
  box_muller(u[2], u[3], g2, g3);
  box_muller(u[4], u[5], g4, g5);

  // --- materials.
  const float nx = sh.n[0], ny = sh.n[1], nz = sh.n[2];
  sh.degen = false;
  sh.reflect = false;
  if (sh.mtype == kMatLambertian) {
    const float inv = rsqrtf(fmaxf(g0 * g0 + g1 * g1 + g2 * g2, 1e-20f));
    sh.unit[0] = g0 * inv;
    sh.unit[1] = g1 * inv;
    sh.unit[2] = g2 * inv;
    sh.nd[0] = nx + sh.unit[0];
    sh.nd[1] = ny + sh.unit[1];
    sh.nd[2] = nz + sh.unit[2];
    sh.degen = fabsf(sh.nd[0]) < 1e-8f && fabsf(sh.nd[1]) < 1e-8f &&
               fabsf(sh.nd[2]) < 1e-8f;
    if (sh.degen) {
      sh.nd[0] = nx; sh.nd[1] = ny; sh.nd[2] = nz;
    }
    sh.scattered = true;
    return;
  }
  mirror(r, a, sh);
  if (sh.mtype == kMatMetal) {
    in_sphere(g3, g4, g5, u[6], sh.sv);
    sh.nd[0] = sh.rf[0] + sh.aux * sh.sv[0];
    sh.nd[1] = sh.rf[1] + sh.aux * sh.sv[1];
    sh.nd[2] = sh.rf[2] + sh.aux * sh.sv[2];
    sh.scattered = sh.nd[0] * nx + sh.nd[1] * ny + sh.nd[2] * nz > 0.0f;
    if (kept != nullptr) {
      kept[0] = sh.sv[0];
      kept[1] = sh.sv[1];
      kept[2] = sh.sv[2];
    }
  } else if (sh.mtype == kMatDielectric) {
    sh.ratio = sh.front ? 1.0f / fmaxf(sh.aux, 1e-20f) : sh.aux;
    sh.cos_t = fminf(-sh.ud_n, 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - sh.cos_t * sh.cos_t, 0.0f));
    float r0 = (1.0f - sh.ratio) / (1.0f + sh.ratio);
    r0 = r0 * r0;
    const float omc = 1.0f - sh.cos_t;
    const float schlick = r0 + (1.0f - r0) * omc * omc * omc * omc * omc;
    sh.reflect = sh.ratio * sin_t > 1.0f || schlick > u[7];
    if (sh.reflect) {
      sh.nd[0] = sh.rf[0]; sh.nd[1] = sh.rf[1]; sh.nd[2] = sh.rf[2];
    } else {
      refract(sh);
    }
    if (kept != nullptr) kept[0] = sh.reflect ? 1.0f : 0.0f;
    sh.scattered = true;
  } else {  // outside this kernel's material set: absorb
    sh.nd[0] = r.dx; sh.nd[1] = r.dy; sh.nd[2] = r.dz;
    sh.scattered = false;
  }
}

// Shade the hit at t on the sphere whose pack column starts at `col`
// (row r at col[r * n_slots]); a is |d|^2. `kept`, when given, receives
// what the scatter draws decided that the adjoint reads: a metal's point
// in the unit sphere (sv), a dielectric's reflect-or-refract (kept[0],
// 1 or 0).
//
// kForAdjoint (the backward's sweep) takes those from `kept` instead of
// drawing: it fills only what scatter_adjoint reads (not unit, degen,
// scattered, nor nd but for a refraction). kEmit, kTex and `tex`:
// shade_material's (the image's uv is the sphere's, sphere_uv).
template <bool kMoving, bool kForAdjoint = false, bool kEmit = false,
          bool kTex = false>
__device__ __forceinline__ void shade(const float* col, int n_slots,
                                      const Ray& r, float a, float t,
                                      uint32_t k0, uint32_t k1, int bounce,
                                      Shade& sh, float* kept = nullptr,
                                      const TexView* tex = nullptr) {
  sh.h[0] = r.ox + t * r.dx;
  sh.h[1] = r.oy + t * r.dy;
  sh.h[2] = r.oz + t * r.dz;
  const float srad = col[kRowRadius * n_slots];
  sh.inv_r = 1.0f / (fabsf(srad) > 1e-20f ? srad : 1.0f);
  float c[3];
  center_at<kMoving>(col, n_slots, r.time, c);
  const float out[3] = {(sh.h[0] - c[0]) * sh.inv_r,
                        (sh.h[1] - c[1]) * sh.inv_r,
                        (sh.h[2] - c[2]) * sh.inv_r};
  if constexpr (kTex) {
    if (col[kRowTexType * n_slots] == kTexImage) {
      sphere_uv(sh.h, c, srad, sh.tu, sh.tv);
      sh.img = col[kRowImage * n_slots];
    }
  }
  shade_material<kForAdjoint, kEmit, kTex>(col + kRowMatType * n_slots,
                                           n_slots, r, a, out, k0, k1, bounce,
                                           sh, kept, tex);
}

// ---------------------------------------------------------------------------
// The solid families: quads and boxes (kSolids)
// ---------------------------------------------------------------------------
//
// rrt_tpu_torch/ops/megakernel.py packs them: a quad (24, Q) pack holds
// q (rows 0-2), u (3-5), v (6-8), valid (9) and the material rows from
// 10; a box (24, B) pack rrt_tpu's center (0-2), half extents (3-5, 0 on
// an invalid slot), cos and sin of the world-from-box Y rotation (6, 7),
// valid (8) and the material rows from 9. A block stages its scene's
// active slots' test rows in shared memory (stage_solids): each quad's
// plane frame (geometry.quad_frames' arithmetic: n = u x v, g, h,
// d_plane, q.g, q.h, eps_n), each box's center, half extents, cos, sin.

// The active slots of each family the kernels loop over (the forward
// kernels, train_fwd and chain_bwd walk a tree past it, train_bwd loops
// over any number: ops/megakernel.py SOLID_CAP).
constexpr int kSolidCap = 64;

// The blocks an SM the kWalk instantiations (the forward kernels' and
// train_fwd's) are built for (__launch_bounds__, so up to 128 registers
// a thread): rttnw_final's staged spheres, rows and trees (80 KB a
// forward block) leave room for 2.
constexpr int kWalkBlocks = 2;


// A solid family's tree as a walk reads it (SolidArgs' quad_* or box_*
// fields): nodes, two float4 each (the spheres' BVH layout), and rows,
// the family's slots in walk order, the first n_always tested by every
// segment; n_nodes 0: the family is a loop over its active slots.
struct SolidTree {
  const float4* nodes;
  const int* rows;
  int n_nodes, n_always;
};

// A block's staged solid families and their packs in device memory.
struct Solids {
  const float4* qn;  // n.xyz, d_plane
  const float4* qg;  // g.xyz, q.g
  const float4* qh;  // h.xyz, q.h
  const float* qe;   // eps_n; kInf on an invalid slot (never not parallel)
  const float4* bc;  // center.xyz, cos
  const float4* bh;  // half.xyz, sin
  int n_quads, n_boxes;
  const float* quad;  // the (24, quad_slots) pack
  int quad_slots;
  const float* box;   // the (24, box_slots) pack
  int box_slots;
  const float* med;   // the (D, 24) medium pack in device memory
  int n_media;        // its rows [0, n_media) are tested
  TexView tex;        // the textures (kTex; every variant carries it)
  SolidTree qt, bt;   // the quads' and boxes' trees (none: loops)
};

// Shared memory of the staged solids (after the BVH, 16-byte aligned).
__host__ __device__ inline size_t solid_bytes(int n_quads, int n_boxes) {
  return 16 * static_cast<size_t>(3 * n_quads + 2 * n_boxes) +
         4 * static_cast<size_t>(n_quads);
}

__host__ __device__ inline size_t aligned16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Stage the active quads' frames and boxes' rows in `smem` (16-byte
// aligned, solid_bytes long); the caller syncs the block after.
// The media are not staged: sv.med points at their pack (med, n_media;
// none by default).
__device__ __forceinline__ Solids stage_solids(const float* quad,
                                               int quad_slots, int n_quads,
                                               const float* box,
                                               int box_slots, int n_boxes,
                                               float4* smem,
                                               const float* med = nullptr,
                                               int n_media = 0) {
  Solids sv{};
  float4* qn = smem;
  float4* qg = qn + n_quads;
  float4* qh = qg + n_quads;
  float4* bc = qh + n_quads;
  float4* bh = bc + n_boxes;
  float* qe = reinterpret_cast<float*>(bh + n_boxes);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int qs = quad_slots;
  for (int i = tid; i < n_quads; i += n_threads) {
    const float q0 = quad[i], q1 = quad[qs + i], q2 = quad[2 * qs + i];
    const float u0 = quad[3 * qs + i], u1 = quad[4 * qs + i],
                u2 = quad[5 * qs + i];
    const float v0 = quad[6 * qs + i], v1 = quad[7 * qs + i],
                v2 = quad[8 * qs + i];
    const float n0 = u1 * v2 - u2 * v1;
    const float n1 = u2 * v0 - u0 * v2;
    const float n2 = u0 * v1 - u1 * v0;
    const float nn = n0 * n0 + n1 * n1 + n2 * n2;
    const float inv_nn = 1.0f / fmaxf(nn, 1e-20f);
    const float g0 = (v1 * n2 - v2 * n1) * inv_nn;
    const float g1 = (v2 * n0 - v0 * n2) * inv_nn;
    const float g2 = (v0 * n1 - v1 * n0) * inv_nn;
    const float h0 = (n1 * u2 - n2 * u1) * inv_nn;
    const float h1 = (n2 * u0 - n0 * u2) * inv_nn;
    const float h2 = (n0 * u1 - n1 * u0) * inv_nn;
    qn[i] = make_float4(n0, n1, n2, n0 * q0 + n1 * q1 + n2 * q2);
    qg[i] = make_float4(g0, g1, g2, g0 * q0 + g1 * q1 + g2 * q2);
    qh[i] = make_float4(h0, h1, h2, h0 * q0 + h1 * q1 + h2 * q2);
    qe[i] = quad[9 * qs + i] > 0.5f ? 1e-8f * sqrtf(fmaxf(nn, 1e-20f))
                                    : kInf;
  }
  const int bs = box_slots;
  for (int i = tid; i < n_boxes; i += n_threads) {
    bc[i] = make_float4(box[i], box[bs + i], box[2 * bs + i],
                        box[6 * bs + i]);
    bh[i] = make_float4(box[3 * bs + i], box[4 * bs + i], box[5 * bs + i],
                        box[7 * bs + i]);
  }
  sv.qn = qn; sv.qg = qg; sv.qh = qh; sv.qe = qe;
  sv.bc = bc; sv.bh = bh;
  sv.n_quads = n_quads; sv.n_boxes = n_boxes;
  sv.quad = quad; sv.quad_slots = quad_slots;
  sv.box = box; sv.box_slots = box_slots;
  sv.med = med; sv.n_media = n_media;
  return sv;
}

// Shared memory of the solid trees (accel.SolidBvh.smem_bytes): two
// float4 a node, an int a row.
__host__ __device__ inline size_t solid_tree_bytes(const SolidArgs& sa) {
  return 32 * static_cast<size_t>(sa.quad_n_nodes + sa.box_n_nodes) +
         4 * static_cast<size_t>(sa.quad_n_rows + sa.box_n_rows);
}

// The forward kernels' shared memory after the spheres' BVH: the solid
// rows (solid_bytes), then the trees (ops/megakernel.py
// forward_smem_bytes, which refuses a scene past what a block may opt
// into before the launch).
__host__ __device__ inline size_t forward_solid_bytes(const SolidArgs& sa) {
  return aligned16(solid_bytes(sa.n_quads, sa.n_boxes)) + solid_tree_bytes(sa);
}

// The walking kernels' solid families (tile_render, bounce_steps,
// intersect, train_fwd): stage_solids' rows in `smem`, then the trees
// of SolidArgs (forward_solid_bytes). The caller syncs the block after.
__device__ __forceinline__ Solids stage_forward_solids(const SolidArgs& sa,
                                                       float4* smem) {
  Solids sv = stage_solids(sa.quad, sa.quad_slots, sa.n_quads, sa.box,
                           sa.box_slots, sa.n_boxes, smem, sa.med, sa.n_media);
  const int q_nodes = sa.quad_n_nodes, b_nodes = sa.box_n_nodes;
  float4* nodes =
      smem + aligned16(solid_bytes(sa.n_quads, sa.n_boxes)) / sizeof(float4);
  int* rows = reinterpret_cast<int*>(nodes + 2 * (q_nodes + b_nodes));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const float4* qn = reinterpret_cast<const float4*>(sa.quad_nodes);
  const float4* bn = reinterpret_cast<const float4*>(sa.box_nodes);
  for (int i = tid; i < 2 * (q_nodes + b_nodes); i += n_threads) {
    nodes[i] = i < 2 * q_nodes ? qn[i] : bn[i - 2 * q_nodes];
  }
  const int q_rows = sa.quad_n_rows;
  for (int j = tid; j < q_rows + sa.box_n_rows; j += n_threads) {
    rows[j] = j < q_rows ? sa.quad_rows[j] : sa.box_rows[j - q_rows];
  }
  sv.qt = SolidTree{nodes, rows, q_nodes, sa.quad_n_always};
  sv.bt = SolidTree{nodes + 2 * q_nodes, rows + q_rows, b_nodes,
                    sa.box_n_always};
  return sv;
}

// Whether a forward launch walks solid trees (its kWalk instantiation).
__host__ __device__ inline bool has_tree(const SolidArgs* sa) {
  return sa != nullptr && sa->quad_n_nodes + sa->box_n_nodes > 0;
}

// A forward launch's dynamic shared memory `smem`: `base` bytes (the
// spheres' BVH), then with solids (sa non-null) forward_solid_bytes. Opts
// `kernel` into smem. Returns a cudaError_t (0 on success).
template <typename Kernel>
int forward_smem(Kernel kernel, size_t base, const SolidArgs* sa,
                 size_t& smem) {
  smem = sa != nullptr ? aligned16(base) + forward_solid_bytes(*sa) : base;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// A forward kernel's blocks an SM at a launch's shared memory
// (forward_smem), for the host's report: blocks and the bytes.
template <typename Kernel>
int forward_blocks(Kernel kernel, int threads, size_t base,
                   const SolidArgs* sa, int* blocks, long long* smem_out) {
  size_t smem;
  int err = forward_smem(kernel, base, sa, smem);
  if (err == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, smem));
  }
  *smem_out = static_cast<long long>(smem);
  return err;
}

// A forward kernel's solid families after the spheres' BVH (`smem` past
// its bvh_bytes): with kWalk stage_forward_solids, else stage_solids'
// rows of the loops, as the train kernels stage them.
template <bool kWalk>
__device__ __forceinline__ Solids stage_solids_of(const SolidArgs& sa,
                                                  float4* smem) {
  if constexpr (kWalk) {
    return stage_forward_solids(sa, smem);
  } else {
    return stage_solids(sa.quad, sa.quad_slots, sa.n_quads, sa.box,
                        sa.box_slots, sa.n_boxes, smem, sa.med, sa.n_media);
  }
}

// One axis of the box slab test, rrt_tpu's closed form: with inv = 1/db
// (1e18 where |db| <= 1e-12), the slab is [-ob inv - h |inv|, h |inv| -
// ob inv].
__device__ __forceinline__ void slab(float ob, float db, float hk, float& lo,
                                     float& hi) {
  const float inv = fabsf(db) <= 1e-12f ? 1e18f : 1.0f / db;
  const float a_t = ob * inv;
  const float b_t = hk * fabsf(inv);
  lo = fmaxf(lo, -a_t - b_t);
  hi = fminf(hi, b_t - a_t);
}

// Quad i's test: its plane's t, and whether the ray hits the
// parallelogram beyond t_min (d_len = |d|).
__device__ __forceinline__ bool quad_hit(const Solids& sv, int i,
                                         const Ray& r, float d_len,
                                         float t_min, float& t) {
  const float4 n = sv.qn[i];
  const float denom = r.dx * n.x + r.dy * n.y + r.dz * n.z;
  const float o_n = r.ox * n.x + r.oy * n.y + r.oz * n.z;
  const bool not_par = fabsf(denom) > sv.qe[i] * d_len;
  t = (n.w - o_n) / (not_par ? denom : 1.0f);
  const float4 g = sv.qg[i];
  const float4 h = sv.qh[i];
  const float alpha = (r.ox * g.x + r.oy * g.y + r.oz * g.z) +
                      t * (r.dx * g.x + r.dy * g.y + r.dz * g.z) - g.w;
  const float beta = (r.ox * h.x + r.oy * h.y + r.oz * h.z) +
                     t * (r.dx * h.x + r.dy * h.y + r.dz * h.z) - h.w;
  return not_par && t > t_min && alpha >= 0.0f && alpha <= 1.0f &&
         beta >= 0.0f && beta <= 1.0f;
}

// Box i's slab test: its t (the far face from inside), and whether the
// ray enters it beyond t_min.
__device__ __forceinline__ bool box_hit(const Solids& sv, int i,
                                        const Ray& r, float t_min,
                                        float& t) {
  const float4 c = sv.bc[i];
  const float4 h = sv.bh[i];
  const float wx = r.ox - c.x, wy = r.oy - c.y, wz = r.oz - c.z;
  float lo = -kInf, hi = kInf;
  slab(c.w * wx - h.w * wz, c.w * r.dx - h.w * r.dz, h.x, lo, hi);
  slab(wy, r.dy, h.y, lo, hi);
  slab(h.w * wx + c.w * wz, h.w * r.dx + c.w * r.dz, h.z, lo, hi);
  t = lo > t_min ? lo : hi;  // inside: the far face
  return lo < hi && t > t_min;
}

// The walks' per-thread stack of far children (a tree's depth may not
// exceed it: accel.BVH_STACK); rrt_tpu's far pad float32(1 + 2 gamma(3)) of the
// slab test; the ray's pad, times the L1 norm of its origin
// (accel.RAY_PAD).
constexpr int kBvhStack = 32;
constexpr float kFarPad = 1.00000036f;
constexpr float kRayPad = 0.00390625f;  // 2^-8

// The walks' node test (the spheres' and the solid families'): the
// ray's reciprocal direction and its origin moved out by the ray's pad
// (kRayPad times the L1 norm of the origin) either way.
struct NodeRay {
  float ix, iy, iz, px, py, pz, mx, my, mz;
};

__device__ __forceinline__ NodeRay node_ray(const Ray& r) {
  const float pad = kRayPad * (fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz));
  return NodeRay{1.0f / r.dx, 1.0f / r.dy, 1.0f / r.dz,
                 r.ox + pad,  r.oy + pad,  r.oz + pad,
                 r.ox - pad,  r.oy - pad,  r.oz - pad};
}

// Whether a walk enters the node (lo, hi): the slab test of its box
// padded by the ray's pad, the near distance clamped to t_min, the far
// one to the best t so far, times kFarPad, so a slot tied with the best
// is still reached.
__device__ __forceinline__ bool node_enter(const float4& lo, const float4& hi,
                                           const NodeRay& nr, float t_min,
                                           float t_best) {
  const float ax = (lo.x - nr.px) * nr.ix, bx = (hi.x - nr.mx) * nr.ix;
  const float ay = (lo.y - nr.py) * nr.iy, by = (hi.y - nr.my) * nr.iy;
  const float az = (lo.z - nr.pz) * nr.iz, bz = (hi.z - nr.mz) * nr.iz;
  const float t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                             fmaxf(fminf(az, bz), t_min));
  const float t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                            fminf(fmaxf(az, bz), t_best)) *
                      kFarPad;
  return t_near <= t_far;
}

// Solid `slot`'s test (a box's with kBox, else a quad's), kept when its t
// is strictly below the best or equal to it on a lower slot: the loop's
// first minimum in slot order, whatever order a walk tests them in.
template <bool kBox>
__device__ __forceinline__ void solid_row(const Solids& sv, int slot,
                                          const Ray& r, float d_len,
                                          float t_min, float& t_best,
                                          int& win) {
  float t;
  const bool hit = kBox ? box_hit(sv, slot, r, t_min, t)
                        : quad_hit(sv, slot, r, d_len, t_min, t);
  if (hit && (t < t_best || (t == t_best && slot < win))) {
    t_best = t;
    win = slot;
  }
}

// A ray whose direction's largest component is below it tests every box
// instead of walking their tree (accel.TINY_DIR: past slab's 1e-12
// parallel rule a hit's point drifts along the axis by up to 1e-12 t).
constexpr float kTinyDir = 9.5367431640625e-07f;  // 2^-20

// The closest solid of family kBox (boxes, else quads) by the walk over
// its tree `tr` (accel.py's rule: a node is skipped only when no slot in
// it can give a t at or below the best): closest_solid's loop's (t,
// slot) bit for bit. Seeded by t_seed < kInf (the quads' t), a slot must
// beat it strictly: win starts at -1, which no tie replaces, and stays
// -1 (with t_seed returned) when none does.
template <bool kBox>
__device__ __forceinline__ float solid_walk(const Solids& sv,
                                            const SolidTree& tr,
                                            const Ray& r, float d_len,
                                            float t_min, float t_seed,
                                            int& win) {
  float t_best = t_seed;
  win = t_seed < kInf ? -1 : 0;
  for (int j = 0; j < tr.n_always; ++j) {
    solid_row<kBox>(sv, tr.rows[j], r, d_len, t_min, t_best, win);
  }
  if (kBox &&
      fmaxf(fabsf(r.dx), fmaxf(fabsf(r.dy), fabsf(r.dz))) < kTinyDir) {
    for (int i = 0; i < sv.n_boxes; ++i) {
      solid_row<true>(sv, i, r, d_len, t_min, t_best, win);
    }
    return t_best;
  }
  const NodeRay nr = node_ray(r);
  int stack[kBvhStack];
  int sp = 0, node = 0;
  for (;;) {
    const float4 lo = tr.nodes[2 * node];
    const float4 hi = tr.nodes[2 * node + 1];
    if (node_enter(lo, hi, nr, t_min, t_best)) {
      const int w0 = __float_as_int(lo.w), w1 = __float_as_int(hi.w);
      if (w1 < 0) {  // inner: left child node + 1, right w0, axis -1 - w1
        const int axis = -1 - w1;
        const float dir = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        stack[sp++] = dir < 0.0f ? node + 1 : w0;
        node = dir < 0.0f ? w0 : node + 1;
        continue;
      }
      for (int j = w0; j < w0 + w1; ++j) {  // leaf: rows w0 .. w0 + w1
        solid_row<kBox>(sv, tr.rows[j], r, d_len, t_min, t_best, win);
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return t_best;
}

// The closest quad, then box: each family by a strict `<` running
// minimum over its active slots in order, or with kWalk (the forward
// kernels' instantiations for a scene whose families have trees) by the
// walk over a family's tree when it has one (solid_walk, the same (t,
// slot)), the boxes seeded by the quads' t (a quad wins an exact tie
// with a box): t (kInf on a miss), its family (kFamNone on a miss) and
// slot. Without kWalk the walk's code is not compiled, so the loops'
// instantiations keep their registers.
template <bool kWalk = false>
__device__ __forceinline__ float closest_solid(const Solids& sv,
                                               const Ray& r, const RayDots& q,
                                               float t_min, int& fam,
                                               int& win) {
  float t_best = kInf;
  fam = kFamNone;
  win = 0;
  const float d_len = sqrtf(q.a);
  if (!kWalk || sv.qt.n_nodes == 0) {
    for (int i = 0; i < sv.n_quads; ++i) {
      float t;
      if (quad_hit(sv, i, r, d_len, t_min, t) && t < t_best) {
        t_best = t;
        fam = kFamQuad;
        win = i;
      }
    }
  } else {
    int w;
    t_best = solid_walk<false>(sv, sv.qt, r, d_len, t_min, kInf, w);
    if (t_best < kInf) {
      fam = kFamQuad;
      win = w;
    }
  }
  if (!kWalk || sv.bt.n_nodes == 0) {
    for (int i = 0; i < sv.n_boxes; ++i) {
      float t;
      if (box_hit(sv, i, r, t_min, t) && t < t_best) {
        t_best = t;
        fam = kFamBox;
        win = i;
      }
    }
  } else {
    int w;
    const float t = solid_walk<true>(sv, sv.bt, r, d_len, t_min, t_best, w);
    if (t < t_best) {
      t_best = t;
      fam = kFamBox;
      win = w;
    }
  }
  return t_best;
}

// The closest_solid test of quad or box `slot` alone (fam kFamQuad or
// kFamBox): its t, kInf when the ray misses it, by closest_solid's
// arithmetic on the same staged rows, so a recomputed winner has the
// forward's t bit for bit.
__device__ __forceinline__ float solid_t(const Solids& sv, int fam, int slot,
                                         const Ray& r, const RayDots& q,
                                         float t_min) {
  float t;
  const bool hit = fam == kFamQuad
                       ? quad_hit(sv, slot, r, sqrtf(q.a), t_min, t)
                       : box_hit(sv, slot, r, t_min, t);
  return hit ? t : kInf;
}

// The outward normal of solid `win` of family `fam` at the hit point h,
// and its material rows (shade_material's `mat`, `stride`).
__device__ __forceinline__ const float* solid_surface(const Solids& sv,
                                                      int fam, int win,
                                                      const float* h,
                                                      float* out,
                                                      int& stride) {
  if (fam == kFamQuad) {
    const float4 n = sv.qn[win];
    const float inv = rsqrtf(fmaxf(n.x * n.x + n.y * n.y + n.z * n.z,
                                   1e-20f));
    out[0] = n.x * inv;
    out[1] = n.y * inv;
    out[2] = n.z * inv;
    stride = sv.quad_slots;
    return sv.quad + kQuadMatRow * stride + win;
  }
  const float4 c = sv.bc[win];
  const float4 hb = sv.bh[win];
  const float wx = h[0] - c.x, wy = h[1] - c.y, wz = h[2] - c.z;
  const float qx = c.w * wx - hb.w * wz;
  const float qz = hb.w * wx + c.w * wz;
  const float fx = fabsf(qx) - hb.x;
  const float fy = fabsf(wy) - hb.y;
  const float fz = fabsf(qz) - hb.z;
  const bool use_x = fx >= fy && fx >= fz;
  const bool use_y = !use_x && fy >= fz;
  const float nbx = use_x ? (qx >= 0.0f ? 1.0f : -1.0f) : 0.0f;
  const float nby = use_y ? (wy >= 0.0f ? 1.0f : -1.0f) : 0.0f;
  const float nbz = use_x || use_y ? 0.0f : (qz >= 0.0f ? 1.0f : -1.0f);
  out[0] = c.w * nbx + hb.w * nbz;
  out[1] = nby;
  out[2] = -hb.w * nbx + c.w * nbz;
  stride = sv.box_slots;
  return sv.box + kBoxMatRow * stride + win;
}

// The image coordinates of solid `win` of family `fam` at the hit
// point sh.h (kTex): a quad's (clip(alpha), 1 - clip(beta)) on its
// staged frame, alpha = h.g - q.g and beta = h.h - q.h, and its image
// index (pack row 20); a box's 0 (a box with an image is built as
// quads).
__device__ __forceinline__ void solid_uv(const Solids& sv, int fam, int win,
                                         Shade& sh) {
  sh.tu = 0.0f;
  sh.tv = 1.0f;
  sh.img = 0.0f;
  if (fam != kFamQuad) return;
  const float4 g = sv.qg[win];
  const float4 h = sv.qh[win];
  const float alpha = (sh.h[0] * g.x + sh.h[1] * g.y + sh.h[2] * g.z) - g.w;
  const float beta = (sh.h[0] * h.x + sh.h[1] * h.y + sh.h[2] * h.z) - h.w;
  sh.tu = fminf(fmaxf(alpha, 0.0f), 1.0f);
  sh.tv = 1.0f - fminf(fmaxf(beta, 0.0f), 1.0f);
  sh.img = sv.quad[kQuadImageRow * sv.quad_slots + win];
}

// The medium pack's columns (ops/megakernel.py pack_media: (D, 24)
// row-major, rrt_tpu's layout): boundary type (0 sphere, 1 box), center,
// radius, half extents, the world-from-box rotation row major,
// -1/density, valid, the isotropic albedo.
constexpr int kMedCols = 24, kMedCenter = 1, kMedRadius = 4, kMedHalf = 5,
              kMedRot = 8, kMedNid = 17, kMedValid = 18, kMedAlbedo = 19;

// Medium `slot`'s STREAM_MEDIUM uniform at `bounce`: word slot % 2 of the
// counter's pair slot / 2 (rrt_tpu.rng.medium_draws).
__device__ __forceinline__ float medium_uniform(uint32_t k0, uint32_t k1,
                                                int bounce, int slot) {
  const uint32_t pair = static_cast<uint32_t>(slot >> 1);
  uint32_t a, b;
  threefry2x32(k0, k1,
               static_cast<uint32_t>(bounce) * kNumStreams + kStreamMedium,
               pair * kPairStep + pair, a, b);
  return to_uniform((slot & 1) ? b : a);
}

// Medium row m's boundary interval over the unbounded line of the ray:
// (t_enter, t_exit), and whether the line crosses it. A sphere by the
// quadratic of o - c; an oriented box by the slab test in its frame, an
// axis with |d_k| <= 1e-12 bounding nothing or everything as the origin
// lies inside its slab or not (rrt_tpu's _one_bounce, :1172-1209).
__device__ __forceinline__ bool medium_interval(const float* m, const Ray& r,
                                                const RayDots& q,
                                                float& t_enter,
                                                float& t_exit) {
  const float ocx = r.ox - m[kMedCenter], ocy = r.oy - m[kMedCenter + 1],
              ocz = r.oz - m[kMedCenter + 2];
  if (m[0] < 0.5f) {  // a sphere boundary
    const float half_b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c_coef =
        ocx * ocx + ocy * ocy + ocz * ocz - m[kMedRadius] * m[kMedRadius];
    const float disc = half_b * half_b - q.a * c_coef;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    t_enter = (-half_b - sq) * q.inv_a;
    t_exit = (-half_b + sq) * q.inv_a;
    return disc > 0.0f;
  }
  float lo = -kInf, hi = kInf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float r0 = m[kMedRot + k], r1 = m[kMedRot + 3 + k],
                r2 = m[kMedRot + 6 + k];
    const float ob = r0 * ocx + r1 * ocy + r2 * ocz;
    const float db = r0 * r.dx + r1 * r.dy + r2 * r.dz;
    const float hk = m[kMedHalf + k];
    const bool par = fabsf(db) <= 1e-12f;
    const float inv_db = 1.0f / (par ? 1.0f : db);
    const float t1 = (-hk - ob) * inv_db;
    const float t2 = (hk - ob) * inv_db;
    const float big = fabsf(ob) <= hk ? kInf : -kInf;
    lo = fmaxf(lo, par ? -big : fminf(t1, t2));
    hi = fminf(hi, par ? big : fmaxf(t1, t2));
  }
  t_enter = lo;
  t_exit = hi;
  return lo < hi;
}

// Where the ray scatters in medium row m, kInf if it passes through: the
// boundary interval clipped to [t_min, t_clip] and to t >= 0, and the
// sampled distance hit_dist = (-1/density) log(u) inside it; t = te +
// hit_dist / |d| (d_len = |d|, inv_dlen = 1 / max(|d|, 1e-20)).
__device__ __forceinline__ float medium_t(const float* m, const Ray& r,
                                          const RayDots& q, float d_len,
                                          float inv_dlen, float t_min,
                                          float t_clip, float u) {
  float t_enter, t_exit;
  bool ok = medium_interval(m, r, q, t_enter, t_exit) && m[kMedValid] > 0.5f;
  float te = fmaxf(t_enter, t_min);
  const float tx = fminf(t_exit, t_clip);
  ok = ok && te < tx;
  te = fmaxf(te, 0.0f);
  ok = ok && te < tx;
  const float hit_dist = m[kMedNid] * logf(fmaxf(u, 1e-12f));
  ok = ok && hit_dist <= (tx - te) * d_len;
  return ok ? te + hit_dist * inv_dlen : kInf;
}

// The closest medium of sv: a strict `<` running minimum over its media
// in order, each clipped by t_solid (the closest solid's t, kInf on a
// miss), each with its own draw at `bounce`. Returns t (kInf when the ray
// scatters in none) and the medium in `win`. Inlined: as a call (not
// inlined) the kSolids variants of cornell, which never take it, ran
// 2-34% slower in turns on an H100, the call's stack and spills in their
// hot loops (PERF.md, PR 12).
__device__ __forceinline__ float closest_medium(const Solids& sv,
                                                const Ray& r,
                                                const RayDots& q,
                                                float t_min, float t_solid,
                                                uint32_t k0, uint32_t k1,
                                                int bounce, int& win) {
  const float d_len = sqrtf(q.a);
  const float inv_dlen = 1.0f / fmaxf(d_len, 1e-20f);
  const uint32_t counter =
      static_cast<uint32_t>(bounce) * kNumStreams + kStreamMedium;
  float t_best = kInf, ua = 0.0f, ub = 0.0f;
  win = 0;
  for (int i = 0; i < sv.n_media; ++i) {
    if ((i & 1) == 0) {  // one Threefry call draws a pair of media
      const uint32_t pair = static_cast<uint32_t>(i >> 1);
      uint32_t a, b;
      threefry2x32(k0, k1, counter, pair * kPairStep + pair, a, b);
      ua = to_uniform(a);
      ub = to_uniform(b);
    }
    const float t = medium_t(sv.med + i * kMedCols, r, q, d_len, inv_dlen,
                             t_min, t_solid, (i & 1) ? ub : ua);
    if (t < t_best) {
      t_best = t;
      win = i;
    }
  }
  return t_best;
}

// Medium `slot`'s t alone (train_bwd's replay of a stored medium winner):
// closest_medium's arithmetic without the solid's clip, which moves no t.
__device__ __forceinline__ float medium_slot_t(const Solids& sv, int slot,
                                               const Ray& r,
                                               const RayDots& q, float t_min,
                                               uint32_t k0, uint32_t k1,
                                               int bounce) {
  const float d_len = sqrtf(q.a);
  return medium_t(sv.med + slot * kMedCols, r, q, d_len,
                  1.0f / fmaxf(d_len, 1e-20f), t_min, kInf,
                  medium_uniform(k0, k1, bounce, slot));
}

// The shade of a scatter in medium row m at t: the isotropic model, its
// normal the constant (1, 0, 0), front face, its albedo the pack's, its
// new direction the in-sphere draw of the bounce's scatter draws.
__device__ __forceinline__ void shade_medium(const float* m, const Ray& r,
                                             float t, uint32_t k0,
                                             uint32_t k1, int bounce,
                                             Shade& sh) {
  sh.h[0] = r.ox + t * r.dx;
  sh.h[1] = r.oy + t * r.dy;
  sh.h[2] = r.oz + t * r.dz;
  sh.n[0] = 1.0f;
  sh.n[1] = 0.0f;
  sh.n[2] = 0.0f;
  sh.front = true;
  sh.sgn = 1.0f;
  sh.mtype = kMatIsotropic;
  sh.aux = 0.0f;
  sh.use_c2 = false;
  sh.degen = false;
  sh.reflect = false;
  sh.alb[0] = m[kMedAlbedo];
  sh.alb[1] = m[kMedAlbedo + 1];
  sh.alb[2] = m[kMedAlbedo + 2];
  float u[8];
  uniforms<4>(k0, k1,
              static_cast<uint32_t>(bounce) * kNumStreams + kStreamScatter,
              u);
  float g2, g3, g4, g5;
  box_muller(u[2], u[3], g2, g3);
  box_muller(u[4], u[5], g4, g5);
  in_sphere(g3, g4, g5, u[6], sh.sv);
  sh.nd[0] = sh.sv[0];
  sh.nd[1] = sh.sv[1];
  sh.nd[2] = sh.sv[2];
  sh.scattered = true;
}

// Path state between bounces.
struct Path {
  Ray ray;
  float thr[3];
};

// The rest of a bounce once its closest hit is known (t_best, win;
// t_best = kInf on a miss): the background on a miss (its radiance,
// throughput included, into `rad`; win becomes -1) or the winner's
// shading and scatter (`kept`: as shade's). With kSolids the winner is
// of family `fam` (a quad, box or medium of `sv`, or a sphere), and a hit
// on a diffuse_light banks throughput x its color into `rad` and ends
// the path (kEmitted). kMedia = false leaves the media's shade out (a
// caller that knows the scene has none). kTex: textures, sv->tex (sv is
// then given with or without kSolids). From bounce rr_depth on (rr_depth
// > 0) a scatter below max_depth draws Russian roulette's coin (rr_on):
// a loss absorbs the path (kAbsorbed, so every caller's bookkeeping holds),
// a survivor's throughput takes the weight 1 / p. Returns the Outcome; on
// kScattered the path has moved on (its time stays).
template <bool kMoving, bool kSolids = false, bool kMedia = true,
          bool kTex = false>
__device__ __forceinline__ int finish_bounce(const float* sph, int n_slots,
                                             const float* bg, bool sky,
                                             uint32_t k0, uint32_t k1,
                                             int bounce, int max_depth,
                                             int rr_depth,
                                             const RayDots& q, float t_best,
                                             Path& p, float* rad, int& win,
                                             float* kept = nullptr,
                                             int fam = kFamSphere,
                                             const Solids* sv = nullptr) {
  if (!(t_best < kInf)) {  // miss: bank the background and stop
    float rgb[3], tsky, inv_len;
    background(bg, sky, p.ray.dy, q.a, rgb, tsky, inv_len);
    rad[0] = p.thr[0] * rgb[0];
    rad[1] = p.thr[1] * rgb[1];
    rad[2] = p.thr[2] * rgb[2];
    win = -1;
    return kMissed;
  }
  Shade sh;
  if constexpr (kSolids) {
    if (fam == kFamSphere) {
      shade<kMoving, false, true, kTex>(sph + win, n_slots, p.ray, q.a,
                                        t_best, k0, k1, bounce, sh, kept,
                                        &sv->tex);
    } else if (kMedia && fam == kFamMedium) {
      shade_medium(sv->med + win * kMedCols, p.ray, t_best, k0, k1, bounce,
                   sh);
    } else {
      sh.h[0] = p.ray.ox + t_best * p.ray.dx;
      sh.h[1] = p.ray.oy + t_best * p.ray.dy;
      sh.h[2] = p.ray.oz + t_best * p.ray.dz;
      float out[3];
      int stride;
      const float* mat = solid_surface(*sv, fam, win, sh.h, out, stride);
      if constexpr (kTex) solid_uv(*sv, fam, win, sh);
      shade_material<false, true, kTex>(mat, stride, p.ray, q.a, out, k0, k1,
                                        bounce, sh, kept, &sv->tex);
    }
    if (sh.mtype == kMatDiffuseLight) {  // emits and ends, at any depth
      rad[0] = p.thr[0] * sh.alb[0];
      rad[1] = p.thr[1] * sh.alb[1];
      rad[2] = p.thr[2] * sh.alb[2];
      return kEmitted;
    }
  } else {
    shade<kMoving, false, false, kTex>(sph + win, n_slots, p.ray, q.a,
                                       t_best, k0, k1, bounce, sh, kept,
                                       kTex ? &sv->tex : nullptr);
  }
  if (!sh.scattered || bounce >= max_depth) return kAbsorbed;
  if (rr_on(bounce, rr_depth)) {
    const bool die = sh.mtype == kMatDielectric;
    const float tn[3] = {p.thr[0] * (die ? 1.0f : sh.alb[0]),
                         p.thr[1] * (die ? 1.0f : sh.alb[1]),
                         p.thr[2] * (die ? 1.0f : sh.alb[2])};
    const float pr = rr_p(tn);
    if (!(rr_uniform(k0, k1, bounce) < pr)) return kAbsorbed;
    const float inv_p = 1.0f / pr;  // the reciprocal, then the product
    p.thr[0] = tn[0] * inv_p;
    p.thr[1] = tn[1] * inv_p;
    p.thr[2] = tn[2] * inv_p;
  } else if (sh.mtype != kMatDielectric) {  // dielectrics attenuate by 1
    p.thr[0] *= sh.alb[0];
    p.thr[1] *= sh.alb[1];
    p.thr[2] *= sh.alb[2];
  }
  p.ray.ox = sh.h[0]; p.ray.oy = sh.h[1]; p.ray.oz = sh.h[2];
  p.ray.dx = sh.nd[0]; p.ray.dy = sh.nd[1]; p.ray.dz = sh.nd[2];
  return kScattered;
}

// The closest hit of a segment: with kSolids the closest quad or box of
// `sv` (closest_solid), then the spheres by `closest` seeded by its t,
// which a sphere wins only with a strictly smaller t, then sv's media
// against that t (closest_medium, their draws at `bounce` of the keys
// k0, k1), which a medium wins only with a strictly smaller t; without,
// the spheres alone. kMedia = false leaves the media out (a caller that
// knows the scene has none). Returns t (kInf on a miss), the winner's
// family `fam` and slot `win` (0 on a miss).
template <bool kSolids, typename Closest, bool kMedia = true,
          bool kWalk = false>
__device__ __forceinline__ float closest_hit(const Closest& closest,
                                             const Solids* sv, const Ray& r,
                                             const RayDots& q, float t_min,
                                             int& fam, int& win,
                                             uint32_t k0 = 0, uint32_t k1 = 0,
                                             int bounce = 0) {
  if constexpr (!kSolids) {
    const float t = closest(r, q, t_min, win);
    fam = t < kInf ? kFamSphere : kFamNone;
    return t;
  } else {
    const float t_solid = closest_solid<kWalk>(*sv, r, q, t_min, fam, win);
    int ws;
    float t = closest(r, q, t_min, ws, t_solid);
    if (t < t_solid) {
      fam = kFamSphere;
      win = ws;
    }
    if (kMedia && sv->n_media > 0) {
      int wm;
      const float tm = closest_medium(*sv, r, q, t_min, t, k0, k1, bounce,
                                      wm);
      if (tm < t) {
        t = tm;
        fam = kFamMedium;
        win = wm;
      }
    }
    return t;
  }
}

// One bounce of a path: the closest hit by `closest` (SlotScan or
// BvhWalk, below: the same (t, win) bit for bit; with kSolids seeded by
// the quads and boxes of `sv`, closest_hit), then finish_bounce. `win`
// is the winner, -1 on a miss (with kSolids its winner_code); `kept`: as
// shade's; kTex and rr_depth: finish_bounce's.
template <bool kMoving, bool kSolids = false, bool kTex = false,
          bool kWalk = false, typename Closest>
__device__ __forceinline__ int bounce_step(const Closest& closest,
                                           const float* sph, int n_slots,
                                           const float* bg, bool sky,
                                           uint32_t k0, uint32_t k1,
                                           int bounce, int max_depth,
                                           int rr_depth,
                                           float t_min, Path& p, float* rad,
                                           int& win, float* kept = nullptr,
                                           const Solids* sv = nullptr) {
  const RayDots q = ray_dots(p.ray);
  if constexpr (!kSolids) {
    const float t_best = closest(p.ray, q, t_min, win);
    return finish_bounce<kMoving, false, true, kTex>(
        sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth, q, t_best,
        p, rad, win, kept, kFamSphere, sv);
  } else {
    int fam;
    const float t_best = closest_hit<true, Closest, true, kWalk>(
        closest, sv, p.ray, q, t_min, fam, win, k0, k1, bounce);
    const int out = finish_bounce<kMoving, true, true, kTex>(
        sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth, q, t_best,
        p, rad, win, kept, fam, sv);
    win = winner_code(fam, win);
    return out;
  }
}

// The first ray of sample `sample` of pixel (px, py), gid = py * width +
// px: its key threefry2x32(s0, s1, gid, sample), the camera's draws and
// the thin-lens ray, with throughput 1. Returns the draws (the backward's
// camera adjoint reads them).
__device__ __forceinline__ CamDraws start_path(const float* cam,
                                               uint32_t s0, uint32_t s1,
                                               uint32_t gid, uint32_t sample,
                                               int px, int py, uint32_t& k0,
                                               uint32_t& k1, Path& p) {
  threefry2x32(s0, s1, gid, sample, k0, k1);
  const CamDraws cd = camera_draws(k0, k1);
  p.ray = camera_ray(cam, cd, static_cast<float>(px),
                     static_cast<float>(py));
  p.thr[0] = p.thr[1] = p.thr[2] = 1.0f;
  return cd;
}

// Stage the intersection rows (0-3) of every slot in shared memory as
// float4 (invalid slots carry r^2 = -1 and so never have a positive
// discriminant) and, when vel4 is given, the velocity rows (4-6) as a
// second float4 a slot.
__device__ __forceinline__ void stage_spheres(const float* sph, int n_slots,
                                              float4* sph4, float4* vel4) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < n_slots; i += n_threads) {
    sph4[i] = make_float4(sph[i], sph[n_slots + i], sph[2 * n_slots + i],
                          sph[kRowR2 * n_slots + i]);
    if (vel4 != nullptr) {
      vel4[i] = make_float4(sph[kRowVel * n_slots + i],
                            sph[(kRowVel + 1) * n_slots + i],
                            sph[(kRowVel + 2) * n_slots + i], 0.0f);
    }
  }
}

// Each slot's center_sq into csq (a block's threads share the work).
__device__ __forceinline__ void stage_center_sq(const float* sph,
                                                int n_slots, float* csq) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n_slots; i += blockDim.x * blockDim.y) {
    csq[i] = center_sq(sph[i], sph[n_slots + i], sph[2 * n_slots + i]);
  }
}

// Shared memory of a block's staged sphere rows: one float4 a slot, two
// with moving spheres; vel4 starts n_slots float4 after sph4.
__host__ __device__ inline size_t staged_bytes(int n_slots, bool moving) {
  return sizeof(float4) * static_cast<size_t>(n_slots) * (moving ? 2 : 1);
}

// Stage a block's packs in shared memory: the spheres' intersection
// rows (and velocity rows), the camera and the background.
__device__ __forceinline__ void stage_packs(const float* sph, int n_slots,
                                            const float* cam_g,
                                            const float* bg_g, float4* sph4,
                                            float4* vel4, float* cam,
                                            float* bg) {
  stage_spheres(sph, n_slots, sph4, vel4);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 24) cam[tid] = cam_g[tid];
  if (tid < 8) bg[tid] = bg_g[tid];
}

// The closest-sphere scan as bounce_step's closest-hit functor: sph4 and
// vel4 as closest_sphere's, csq each slot's staged center_sq (kCsq).
template <bool kMoving, bool kCsq>
struct SlotScan {
  const float4* sph4;
  const float4* vel4;
  const float* csq;
  int n_slots;
  __device__ __forceinline__ float operator()(const Ray& r, const RayDots& q,
                                              float t_min, int& win,
                                              float t_seed = kInf) const {
    return closest_sphere<kMoving, kCsq>(sph4, vel4, n_slots, r, q, t_min,
                                         win, csq, t_seed);
  }
};

// ---------------------------------------------------------------------------
// The BVH walk (tile_render, bounce_steps, intersect and chain_bwd)
// ---------------------------------------------------------------------------
//
// rrt_tpu_torch/accel.py builds the tree (pack_bvh) and states the rule
// that makes the walk's result the scan's bit for bit: every box is
// padded so that no slot inside a skipped node can produce a root below
// the best t under this file's arithmetic. On chap12 a segment tests
// some tens of nodes and slots instead of 512 slots.

// A block's staged BVH (stage_bvh): nodes, two float4 each (lo.xyz and
// w0, hi.xyz and w1, w0 and w1 int32 bits; accel.py's layout), and the
// rows in walk order, the always-tested first: each row's center and
// r^2, its velocity (kMoving) or its center_sq (static), and its slot.
struct BvhView {
  const float4* nodes;
  const float4* sph4;
  const float4* vel4;
  const float* csq;
  const int* slot;
  int n_nodes, n_always;
};

// Shared memory of a staged BVH (accel.BvhPack.smem_bytes).
__host__ __device__ inline size_t bvh_bytes(int n_nodes, int n_rows,
                                            bool moving) {
  return 32 * static_cast<size_t>(n_nodes) +
         static_cast<size_t>(n_rows) * (16 + (moving ? 16 : 4) + 4);
}

// Stage the BVH of the sphere pack `sph` (24, n_slots) in `smem`: the
// nodes (n_nodes x 8 f32 in device memory, 16-byte aligned) and the
// rows of the slots rows_g[0:n_rows]. The same values as stage_spheres
// and stage_center_sq, so every slot test has the scan's bits.
template <bool kMoving>
__device__ __forceinline__ BvhView stage_bvh(const float* sph, int n_slots,
                                             const float* nodes_g,
                                             const int* rows_g, int n_nodes,
                                             int n_rows, int n_always,
                                             float4* smem) {
  float4* nodes = smem;
  float4* sph4 = nodes + 2 * n_nodes;
  float4* vel4 = kMoving ? sph4 + n_rows : nullptr;
  float* csq = kMoving ? nullptr : reinterpret_cast<float*>(sph4 + n_rows);
  int* slot = kMoving ? reinterpret_cast<int*>(vel4 + n_rows)
                      : reinterpret_cast<int*>(csq + n_rows);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const float4* src = reinterpret_cast<const float4*>(nodes_g);
  for (int i = tid; i < 2 * n_nodes; i += n_threads) nodes[i] = src[i];
  for (int j = tid; j < n_rows; j += n_threads) {
    const int s = rows_g[j];
    slot[j] = s;
    sph4[j] = make_float4(sph[s], sph[n_slots + s], sph[2 * n_slots + s],
                          sph[kRowR2 * n_slots + s]);
    if (kMoving) {
      vel4[j] = make_float4(sph[kRowVel * n_slots + s],
                            sph[(kRowVel + 1) * n_slots + s],
                            sph[(kRowVel + 2) * n_slots + s], 0.0f);
    } else {
      csq[j] = center_sq(sph[s], sph[n_slots + s], sph[2 * n_slots + s]);
    }
  }
  BvhView b;
  b.nodes = nodes;
  b.sph4 = sph4;
  b.vel4 = vel4;
  b.csq = csq;
  b.slot = slot;
  b.n_nodes = n_nodes;
  b.n_always = n_always;
  return b;
}

// Row j's test: the scan's arithmetic on the same staged values, so the
// same t; the update keeps the scan's first minimum in slot order.
template <bool kMoving>
__device__ __forceinline__ void bvh_test(const BvhView& b, int j,
                                         const Ray& r, const RayDots& q,
                                         float t_min, float& t_best,
                                         int& win) {
  const float4 c = slot_center<kMoving>(b.sph4, b.vel4, j, r.time);
  const Quadratic k = kMoving
                          ? quadratic(r, q, c.x, c.y, c.z, c.w)
                          : quadratic(r, q, c.x, c.y, c.z, b.csq[j], c.w);
  if (k.disc > 0.0f) {
    const float t = nearest_root(k, q, t_min);
    const int s = b.slot[j];
    if (t < t_best || (t == t_best && s < win)) {
      t_best = t;
      win = s;
    }
  }
}

// Closest sphere by the BVH walk: closest_sphere's (t, win), kInf and 0
// on a miss. The always-tested rows first, then the tree, near child
// first by the sign of the ray's direction on the split axis; a node is
// skipped only when its slab test misses or its near distance exceeds
// the best t (times kFarPad), so a tied lower slot is still reached.
// Seeded by another family's t_seed < kInf, a sphere must beat it
// strictly: win starts at -1, which no tie replaces, and stays -1 (with
// t_seed returned) when no sphere does.
template <bool kMoving>
__device__ __forceinline__ float closest_sphere_bvh(const BvhView& b,
                                                    const Ray& r,
                                                    const RayDots& q,
                                                    float t_min, int& win,
                                                    float t_seed = kInf) {
  float t_best = t_seed;
  win = t_seed < kInf ? -1 : 0;
  for (int j = 0; j < b.n_always; ++j) {
    bvh_test<kMoving>(b, j, r, q, t_min, t_best, win);
  }
  if (b.n_nodes == 0) return t_best;
  const NodeRay nr = node_ray(r);
  int stack[kBvhStack];
  int sp = 0, node = 0;
  for (;;) {
    const float4 lo = b.nodes[2 * node];
    const float4 hi = b.nodes[2 * node + 1];
    if (node_enter(lo, hi, nr, t_min, t_best)) {
      const int w0 = __float_as_int(lo.w), w1 = __float_as_int(hi.w);
      if (w1 < 0) {  // inner: left child node + 1, right w0, axis -1 - w1
        const int axis = -1 - w1;
        const float dir = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        stack[sp++] = dir < 0.0f ? node + 1 : w0;
        node = dir < 0.0f ? w0 : node + 1;
        continue;
      }
      for (int j = w0; j < w0 + w1; ++j) {  // leaf: rows w0 .. w0 + w1
        bvh_test<kMoving>(b, j, r, q, t_min, t_best, win);
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return t_best;
}

// The walk as bounce_step's closest-hit functor (t_seed: as
// closest_sphere_bvh's).
template <bool kMoving>
struct BvhWalk {
  BvhView b;
  __device__ __forceinline__ float operator()(const Ray& r, const RayDots& q,
                                              float t_min, int& win,
                                              float t_seed = kInf) const {
    return closest_sphere_bvh<kMoving>(b, r, q, t_min, win, t_seed);
  }
};

// ---------------------------------------------------------------------------
// A pixel's samples, back to back (tile_render and train_fwd)
// ---------------------------------------------------------------------------

// Trace samples [lo, lo + spp) of pixel (px, py), gid = py * width + px,
// into output slot (py - row_lo) * width + px (a band of rows from
// row_lo; n_pix its pixels, the residual's stride), back to back: one
// loop over segments that starts sample s + 1's camera ray as soon as
// sample s misses, is absorbed or reaches max_depth, as the TPU kernel
// regenerates a dead path, so a warp waits for its slowest pixel's total
// rather than for each sample's longest path. Sample s uses the key
// threefry2x32(s0, s1, gid, lo + s), the camera draws counter 0 and the
// scatter draws counter bounce*8+1 (rrt_tpu.rng's addressing, so a
// path's random numbers are bit-identical to the reference's). Radiance
// is summed in sample order, bounce by bounce. `closest` finds each
// segment's closest hit (SlotScan or BvhWalk: the same (t, win) bit for
// bit; with kSolids seeded by the quads and boxes of `sv`). With
// kResidual (train_fwd) it keeps the backward's residual: each path's
// bounce count in lengths[s * n_pix + slot], and the winner of the
// pixel's j-th segment in winners[j * n_pix + slot] for j < win_cap (-1
// on a miss; with kSolids its winner_code); the two pointers move to the
// pixel's column once, so the loop keeps one pixel id live (gid, the
// key's). kTex: bounce_step's (sv given); rr_depth: Russian roulette's
// first bounce (0: off; finish_bounce), whose kill ends a sample as an
// absorption does.
template <bool kMoving, bool kResidual, bool kSolids = false,
          bool kTex = false, bool kWalk = false, typename Closest>
__device__ __forceinline__ void trace_pixel(
    const Closest& closest, const float* sph, int n_slots, const float* cam,
    const float* bg, uint32_t s0, uint32_t s1, uint32_t lo, int px, int py,
    int width, int row_lo, int n_pix, int spp, int max_depth, int rr_depth,
    float t_min, int win_cap, float* rad, int* traced, uint8_t* lengths,
    int16_t* winners, const Solids* sv = nullptr) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  if constexpr (kResidual) {  // this pixel's column of the residual
    const uint32_t col = static_cast<uint32_t>((py - row_lo) * width + px);
    lengths += col;
    winners += col;
  }
  const bool sky = bg[6] < 0.5f;  // BG_SKY == 0
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n_traced = 0;  // also the next segment's winner entry
  int s = 0, bounce = 0;
  uint32_t k0, k1;
  Path p;
  start_path(cam, s0, s1, gid, lo, px, py, k0, k1, p);
  for (;;) {
    float c[3];
    int win;
    const int out = bounce_step<kMoving, kSolids, kTex, kWalk>(
        closest, sph, n_slots, bg, sky, k0, k1, bounce, max_depth, rr_depth,
        t_min, p, c, win, nullptr, sv);
    if (kResidual && n_traced < win_cap) {
      winners[static_cast<size_t>(n_traced) * n_pix] =
          static_cast<int16_t>(win);
    }
    ++n_traced;
    if (out == kMissed || (kSolids && out == kEmitted)) {
      acc_r += c[0];
      acc_g += c[1];
      acc_b += c[2];
    }
    if (out == kScattered) {
      ++bounce;
      continue;
    }
    if (kResidual) {
      lengths[static_cast<size_t>(s) * n_pix] =
          static_cast<uint8_t>(bounce + 1);
    }
    if (++s == spp) break;
    bounce = 0;
    start_path(cam, s0, s1, gid, lo + static_cast<uint32_t>(s), px, py, k0,
               k1, p);
  }
  const uint32_t slot = static_cast<uint32_t>((py - row_lo) * width + px);
  rad[3 * slot + 0] = acc_r;
  rad[3 * slot + 1] = acc_g;
  rad[3 * slot + 2] = acc_b;
  traced[slot] = n_traced;
}

}  // namespace
