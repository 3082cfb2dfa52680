// Device functions of one path-tracing bounce, shared by the forward
// (tile_render.cu), the train kernels (train.cu) and the queue and batch
// drivers' kernels (queue.cu), so that all of them run the same
// arithmetic under the same flags (-fmad=false, see the
// note on floats in tile_render.cu): Threefry, uniforms, Box-Muller, the
// thin-lens camera ray, the closest-sphere scan, and the shading step
// of the winner, which exposes its decisions and intermediates to the
// backward.
//
// Sphere subset of rrt_tpu/ops/megakernel.py::_one_bounce: stationary
// spheres, solid and checker textures, lambertian / metal / dielectric
// materials, sky or solid background, no Russian roulette.

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
              kCamW = 21, kCamH = 22, kCamHm1 = 23;

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

// The camera's draws of one sample: pixel jitter and lens disc.
struct CamDraws {
  float jx, jy, dcx, dcy;
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
  return c;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Thin-lens camera ray (rrt_tpu/ops/megakernel.py _camera_rays).
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

__device__ __forceinline__ Quadratic quadratic(const Ray& r,
                                               const RayDots& q, float cx,
                                               float cy, float cz,
                                               float r2) {
  const float d_c = r.dx * cx + r.dy * cy + r.dz * cz;
  const float o_c = r.ox * cx + r.oy * cy + r.oz * cz;
  const float c_sq = cx * cx + cy * cy + cz * cz;
  Quadratic k;
  k.half_b = q.o_dot_d - d_c;
  k.c_coef = q.o_dot_o - 2.0f * o_c + c_sq - r2;
  k.disc = k.half_b * k.half_b - q.a * k.c_coef;
  return k;
}

// Closest sphere: a strict `<` running minimum over the slots in order,
// the first minimum winning like argmin. sph4: rows 0-3 of each slot.
// Returns t (kInf on a miss) and the winner in `win`.
__device__ __forceinline__ float closest_sphere(const float4* sph4,
                                                int n_slots, const Ray& r,
                                                const RayDots& q,
                                                float t_min, int& win) {
  float t_best = kInf;
  win = 0;
  for (int i = 0; i < n_slots; ++i) {
    const float4 c = sph4[i];
    const Quadratic k = quadratic(r, q, c.x, c.y, c.z, c.w);
    if (k.disc > 0.0f) {
      const float sq = sqrtf(k.disc);
      const float root0 = (-k.half_b - sq) * q.inv_a;
      const float root1 = (-k.half_b + sq) * q.inv_a;
      const float t0c = root0 > t_min ? root0 : kInf;
      const float t1c = root1 > t_min ? root1 : kInf;
      const float t_cand = fminf(t0c, t1c);
      if (t_cand < t_best) {
        t_best = t_cand;
        win = i;
      }
    }
  }
  return t_best;
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

// Shade the hit at t on the winner whose pack column starts at `col`
// (row r at col[r * n_slots]); a is |d|^2.
__device__ __forceinline__ void shade(const float* col, int n_slots,
                                      const Ray& r, float a, float t,
                                      uint32_t k0, uint32_t k1, int bounce,
                                      Shade& sh) {
  sh.h[0] = r.ox + t * r.dx;
  sh.h[1] = r.oy + t * r.dy;
  sh.h[2] = r.oz + t * r.dz;
  const float srad = col[kRowRadius * n_slots];
  sh.inv_r = 1.0f / (fabsf(srad) > 1e-20f ? srad : 1.0f);
  const float outx = (sh.h[0] - col[0]) * sh.inv_r;
  const float outy = (sh.h[1] - col[n_slots]) * sh.inv_r;
  const float outz = (sh.h[2] - col[2 * n_slots]) * sh.inv_r;
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
  sh.inv_dl = 1.0f / fmaxf(sqrtf(a), 1e-20f);
  sh.ud[0] = r.dx * sh.inv_dl;
  sh.ud[1] = r.dy * sh.inv_dl;
  sh.ud[2] = r.dz * sh.inv_dl;
  sh.ud_n = sh.ud[0] * nx + sh.ud[1] * ny + sh.ud[2] * nz;
  sh.rf[0] = sh.ud[0] - 2.0f * sh.ud_n * nx;
  sh.rf[1] = sh.ud[1] - 2.0f * sh.ud_n * ny;
  sh.rf[2] = sh.ud[2] - 2.0f * sh.ud_n * nz;
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

// One bounce of a path: closest sphere, then the background on a miss
// (its radiance, throughput included, into `rad`) or the winner's shading
// and scatter. `win` is the winner, -1 on a miss. Returns the Outcome;
// on kScattered the path has moved on.
__device__ __forceinline__ int bounce_step(const float* sph,
                                           const float4* sph4, int n_slots,
                                           const float* bg, bool sky,
                                           uint32_t k0, uint32_t k1,
                                           int bounce, int max_depth,
                                           float t_min, Path& p, float* rad,
                                           int& win) {
  const RayDots q = ray_dots(p.ray);
  const float t_best = closest_sphere(sph4, n_slots, p.ray, q, t_min, win);
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
  shade(sph + win, n_slots, p.ray, q.a, t_best, k0, k1, bounce, sh);
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

// Stage the intersection rows (0-3) of every slot in shared memory as
// float4 (invalid slots carry r^2 = -1 and so never have a positive
// discriminant).
__device__ __forceinline__ void stage_spheres(const float* sph, int n_slots,
                                              float4* sph4) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < n_slots; i += n_threads) {
    sph4[i] = make_float4(sph[i], sph[n_slots + i], sph[2 * n_slots + i],
                          sph[kRowR2 * n_slots + i]);
  }
}

// Stage a block's packs in shared memory: the spheres' intersection
// rows, the camera and the background.
__device__ __forceinline__ void stage_packs(const float* sph, int n_slots,
                                            const float* cam_g,
                                            const float* bg_g, float4* sph4,
                                            float* cam, float* bg) {
  stage_spheres(sph, n_slots, sph4);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 24) cam[tid] = cam_g[tid];
  if (tid < 8) bg[tid] = bg_g[tid];
}

// Trace samples [lo, lo + spp) of pixel (px, py): sample s uses the key
// threefry2x32(s0, s1, gid, lo + s), the camera draws counter 0 and the
// scatter draws counter bounce*8+1 (rrt_tpu.rng's addressing, so a
// path's random numbers are bit-identical to the reference's). Radiance
// is summed in sample order, bounce by bounce. With kLengths, each
// path's bounce count goes to lengths[s * n_pix + gid].
template <bool kLengths>
__device__ __forceinline__ void render_pixel(
    const float* sph, const float4* sph4, int n_slots, const float* cam,
    const float* bg, uint32_t s0, uint32_t s1, uint32_t lo, int px, int py,
    int width, int n_pix, int spp, int max_depth, float t_min, float* rad,
    int* traced, uint8_t* lengths) {
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  const bool sky = bg[6] < 0.5f;  // BG_SKY == 0
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n_traced = 0;
  for (int s = 0; s < spp; ++s) {
    uint32_t k0, k1;
    threefry2x32(s0, s1, gid, lo + static_cast<uint32_t>(s), k0, k1);
    Path p;
    p.ray = camera_ray(cam, camera_draws(k0, k1), static_cast<float>(px),
                       static_cast<float>(py));
    p.thr[0] = p.thr[1] = p.thr[2] = 1.0f;
    int n_bounces = 0;
    for (int bounce = 0; bounce <= max_depth; ++bounce) {
      ++n_traced;
      ++n_bounces;
      float c[3];
      int win;
      const int out = bounce_step(sph, sph4, n_slots, bg, sky, k0, k1,
                                  bounce, max_depth, t_min, p, c, win);
      if (out == kMissed) {
        acc_r += c[0];
        acc_g += c[1];
        acc_b += c[2];
      }
      if (out != kScattered) break;
    }
    if (kLengths) {
      lengths[static_cast<size_t>(s) * n_pix + gid] =
          static_cast<uint8_t>(n_bounces);
    }
  }
  rad[3 * gid + 0] = acc_r;
  rad[3 * gid + 1] = acc_g;
  rad[3 * gid + 2] = acc_b;
  traced[gid] = n_traced;
}

}  // namespace
