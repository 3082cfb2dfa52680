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
// Sphere subset of rrt_tpu/ops/megakernel.py::_one_bounce: stationary
// and moving spheres, solid and checker textures, lambertian / metal /
// dielectric materials, sky or solid background, no Russian roulette.
//
// Moving spheres (kMoving = true, the scene's has_moving): a sphere's
// center at a ray's time is base + time * vel, pack rows 0-2 and 4-6, in
// the closest-sphere scan (rrt_tpu's megakernel.py:1033-1038) and in the
// shading normal (:1247-1250); each ray carries its time, the camera's
// shutter draw. The velocity rows are staged in shared memory beside the
// intersection rows (a second float4 a slot, 8 KB at 512 slots). The
// kMoving = false instantiation reads no time and runs the static
// arithmetic unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTwoPi = 6.28318548f;  // f32(2 pi), as the reference rounds
constexpr uint32_t kPairStep = 0x9E3779B9u;
constexpr uint32_t kNumStreams = 8u;
constexpr uint32_t kStreamScatter = 1u;

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

// Camera pack (24,).
constexpr int kCamOrigin = 0, kCamLowerLeft = 3, kCamHorizontal = 6,
              kCamVertical = 9, kCamU = 12, kCamV = 15, kCamLens = 18,
              kCamTime0 = 19, kCamDt = 20, kCamW = 21, kCamH = 22,
              kCamHm1 = 23;

constexpr float kMatLambertian = 0.0f, kMatMetal = 1.0f,
                kMatDielectric = 2.0f, kTexChecker = 1.0f;

// What a bounce did: the path banked the background, or ended on a
// surface, or goes on.
enum Outcome { kMissed = 0, kAbsorbed = 1, kScattered = 2 };

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
// here. Returns t (kInf on a miss) and the winner in `win`.
template <bool kMoving, bool kCsq = false>
__device__ __forceinline__ float closest_sphere(const float4* sph4,
                                                const float4* vel4,
                                                int n_slots, const Ray& r,
                                                const RayDots& q,
                                                float t_min, int& win,
                                                const float* csq = nullptr) {
  static_assert(!(kMoving && kCsq), "a moving center's |c|^2 varies");
  float t_best = kInf;
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
};

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

// Shade the hit at t on the winner whose pack column starts at `col`
// (row r at col[r * n_slots]); a is |d|^2. `kept`, when given, receives
// what the scatter draws decided that the adjoint reads: a metal's point
// in the unit sphere (sv), a dielectric's reflect-or-refract (kept[0],
// 1 or 0).
//
// kForAdjoint (the backward's sweep) takes those from `kept` instead of
// drawing: it fills only what scatter_adjoint reads (not unit, degen,
// scattered, nor nd but for a refraction).
template <bool kMoving, bool kForAdjoint = false>
__device__ __forceinline__ void shade(const float* col, int n_slots,
                                      const Ray& r, float a, float t,
                                      uint32_t k0, uint32_t k1, int bounce,
                                      Shade& sh, float* kept = nullptr) {
  sh.h[0] = r.ox + t * r.dx;
  sh.h[1] = r.oy + t * r.dy;
  sh.h[2] = r.oz + t * r.dz;
  const float srad = col[kRowRadius * n_slots];
  sh.inv_r = 1.0f / (fabsf(srad) > 1e-20f ? srad : 1.0f);
  float c[3];
  center_at<kMoving>(col, n_slots, r.time, c);
  const float outx = (sh.h[0] - c[0]) * sh.inv_r;
  const float outy = (sh.h[1] - c[1]) * sh.inv_r;
  const float outz = (sh.h[2] - c[2]) * sh.inv_r;
  sh.front = r.dx * outx + r.dy * outy + r.dz * outz < 0.0f;
  sh.sgn = sh.front ? 1.0f : -1.0f;
  sh.n[0] = outx * sh.sgn;
  sh.n[1] = outy * sh.sgn;
  sh.n[2] = outz * sh.sgn;
  sh.mtype = col[kRowMatType * n_slots];
  sh.aux = col[kRowAux * n_slots];

  // --- texture: solid or checker (RTTNW ch. 4.3 sine form).
  sh.use_c2 = false;
  if (col[kRowTexType * n_slots] == kTexChecker) {
    const float ts = col[kRowTexScale * n_slots];
    sh.use_c2 = sinf(ts * sh.h[0]) * sinf(ts * sh.h[1]) * sinf(ts * sh.h[2]) <
                0.0f;
  }
  const int c_row = sh.use_c2 ? kRowColor2 : kRowColor1;
  sh.alb[0] = col[c_row * n_slots];
  sh.alb[1] = col[(c_row + 1) * n_slots];
  sh.alb[2] = col[(c_row + 2) * n_slots];

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
    const float inv2 = rsqrtf(fmaxf(g3 * g3 + g4 * g4 + g5 * g5, 1e-20f));
    const float rad3 = expf(logf(fmaxf(u[6], 1e-12f)) * (1.0f / 3.0f));
    sh.sv[0] = g3 * inv2 * rad3;
    sh.sv[1] = g4 * inv2 * rad3;
    sh.sv[2] = g5 * inv2 * rad3;
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

// Path state between bounces.
struct Path {
  Ray ray;
  float thr[3];
};

// The rest of a bounce once its closest hit is known (t_best, win;
// t_best = kInf on a miss): the background on a miss (its radiance,
// throughput included, into `rad`; win becomes -1) or the winner's
// shading and scatter (`kept`: as shade's). Returns the Outcome; on
// kScattered the path has moved on (its time stays).
template <bool kMoving>
__device__ __forceinline__ int finish_bounce(const float* sph, int n_slots,
                                             const float* bg, bool sky,
                                             uint32_t k0, uint32_t k1,
                                             int bounce, int max_depth,
                                             const RayDots& q, float t_best,
                                             Path& p, float* rad, int& win,
                                             float* kept = nullptr) {
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
  shade<kMoving>(sph + win, n_slots, p.ray, q.a, t_best, k0, k1, bounce,
                 sh, kept);
  if (!sh.scattered || bounce >= max_depth) return kAbsorbed;
  if (sh.mtype != kMatDielectric) {  // dielectrics attenuate by 1
    p.thr[0] *= sh.alb[0];
    p.thr[1] *= sh.alb[1];
    p.thr[2] *= sh.alb[2];
  }
  p.ray.ox = sh.h[0]; p.ray.oy = sh.h[1]; p.ray.oz = sh.h[2];
  p.ray.dx = sh.nd[0]; p.ray.dy = sh.nd[1]; p.ray.dz = sh.nd[2];
  return kScattered;
}

// One bounce of a path: the closest hit by `closest` (SlotScan or
// BvhWalk, below: the same (t, win) bit for bit), then finish_bounce.
// `win` is the winner, -1 on a miss; `kept`: as shade's.
template <bool kMoving, typename Closest>
__device__ __forceinline__ int bounce_step(const Closest& closest,
                                           const float* sph, int n_slots,
                                           const float* bg, bool sky,
                                           uint32_t k0, uint32_t k1,
                                           int bounce, int max_depth,
                                           float t_min, Path& p, float* rad,
                                           int& win, float* kept = nullptr) {
  const RayDots q = ray_dots(p.ray);
  const float t_best = closest(p.ray, q, t_min, win);
  return finish_bounce<kMoving>(sph, n_slots, bg, sky, k0, k1, bounce,
                                max_depth, q, t_best, p, rad, win, kept);
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
inline size_t staged_bytes(int n_slots, bool moving) {
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
                                              float t_min, int& win) const {
    return closest_sphere<kMoving, kCsq>(sph4, vel4, n_slots, r, q, t_min,
                                         win, csq);
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

// The per-thread stack of far children (the tree's depth may not exceed
// it: accel.BVH_STACK); rrt_tpu's far pad float32(1 + 2 gamma(3)) of the
// slab test; the ray's pad, times the L1 norm of its origin
// (accel.RAY_PAD).
constexpr int kBvhStack = 32;
constexpr float kFarPad = 1.00000036f;
constexpr float kRayPad = 0.00390625f;  // 2^-8

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
inline size_t bvh_bytes(int n_nodes, int n_rows, bool moving) {
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
template <bool kMoving>
__device__ __forceinline__ float closest_sphere_bvh(const BvhView& b,
                                                    const Ray& r,
                                                    const RayDots& q,
                                                    float t_min, int& win) {
  float t_best = kInf;
  win = 0;
  for (int j = 0; j < b.n_always; ++j) {
    bvh_test<kMoving>(b, j, r, q, t_min, t_best, win);
  }
  if (b.n_nodes == 0) return t_best;
  const float pad = kRayPad * (fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz));
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const float px = r.ox + pad, py = r.oy + pad, pz = r.oz + pad;
  const float mx = r.ox - pad, my = r.oy - pad, mz = r.oz - pad;
  int stack[kBvhStack];
  int sp = 0, node = 0;
  for (;;) {
    const float4 lo = b.nodes[2 * node];
    const float4 hi = b.nodes[2 * node + 1];
    const float ax = (lo.x - px) * ix, bx = (hi.x - mx) * ix;
    const float ay = (lo.y - py) * iy, by = (hi.y - my) * iy;
    const float az = (lo.z - pz) * iz, bz = (hi.z - mz) * iz;
    const float t_near = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                               fmaxf(fminf(az, bz), t_min));
    const float t_far = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                              fminf(fmaxf(az, bz), t_best)) *
                        kFarPad;
    if (t_near <= t_far) {
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

// The walk as bounce_step's closest-hit functor.
template <bool kMoving>
struct BvhWalk {
  BvhView b;
  __device__ __forceinline__ float operator()(const Ray& r, const RayDots& q,
                                              float t_min, int& win) const {
    return closest_sphere_bvh<kMoving>(b, r, q, t_min, win);
  }
};

// ---------------------------------------------------------------------------
// A pixel's samples, back to back (tile_render and train_fwd)
// ---------------------------------------------------------------------------

// Trace samples [lo, lo + spp) of pixel (px, py), gid = py * width + px,
// back to back: one loop over segments that starts sample s + 1's
// camera ray as soon as sample s misses, is absorbed or reaches
// max_depth, as the TPU kernel regenerates a dead path, so a warp waits
// for its slowest pixel's total rather than for each sample's longest
// path. Sample s uses the key threefry2x32(s0, s1, gid, lo + s), the
// camera draws counter 0 and the scatter draws counter bounce*8+1
// (rrt_tpu.rng's addressing, so a path's random numbers are
// bit-identical to the reference's). Radiance is summed in sample order,
// bounce by bounce. `closest` finds each segment's closest hit
// (SlotScan or BvhWalk: the same (t, win) bit for bit). With kResidual
// (train_fwd) it keeps the backward's residual: each path's bounce
// count in lengths[s * n_pix + gid], and the winner of the pixel's j-th
// segment in winners[j * n_pix + gid] for j < win_cap (-1 on a miss).
template <bool kMoving, bool kResidual, typename Closest>
__device__ __forceinline__ void trace_pixel(
    const Closest& closest, const float* sph, int n_slots, const float* cam,
    const float* bg, uint32_t s0, uint32_t s1, uint32_t lo, int px, int py,
    int width, int n_pix, int spp, int max_depth, float t_min, int win_cap,
    float* rad, int* traced, uint8_t* lengths, int16_t* winners) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
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
    const int out = bounce_step<kMoving>(closest, sph, n_slots, bg, sky, k0,
                                         k1, bounce, max_depth, t_min, p, c,
                                         win);
    if (kResidual && n_traced < win_cap) {
      winners[static_cast<size_t>(n_traced) * n_pix + gid] =
          static_cast<int16_t>(win);
    }
    ++n_traced;
    if (out == kMissed) {
      acc_r += c[0];
      acc_g += c[1];
      acc_b += c[2];
    }
    if (out == kScattered) {
      ++bounce;
      continue;
    }
    if (kResidual) {
      lengths[static_cast<size_t>(s) * n_pix + gid] =
          static_cast<uint8_t>(bounce + 1);
    }
    if (++s == spp) break;
    bounce = 0;
    start_path(cam, s0, s1, gid, lo + static_cast<uint32_t>(s), px, py, k0,
               k1, p);
  }
  rad[3 * gid + 0] = acc_r;
  rad[3 * gid + 1] = acc_g;
  rad[3 * gid + 2] = acc_b;
  traced[gid] = n_traced;
}

}  // namespace
