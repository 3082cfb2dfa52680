// Tile-render kernel: the forward render of a sphere scene, every pixel's
// samples in one launch.
//
// Replaces rrt_tpu/ops/megakernel.py::_tile_render_kernel (launched by
// _render_tiles_launch) for the scenes rrt_tpu_torch renders: stationary
// spheres, solid and checker textures, lambertian / metal / dielectric
// materials, sky or solid background, a thin-lens camera, no Russian
// roulette. rrt_tpu_torch/ops/megakernel.py holds the wrapper
// (render_tiles), the packs' layouts and the plain PyTorch version
// (render_tiles_reference).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTwoPi = 6.28318548f;  // f32(2 pi), as the reference rounds
constexpr uint32_t kPairStep = 0x9E3779B9u;
constexpr uint32_t kNumStreams = 8u;
constexpr uint32_t kStreamScatter = 1u;

// Sphere pack rows (row-major (24, S)).
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

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Thin-lens camera ray (rrt_tpu/ops/megakernel.py _camera_rays).
__device__ Ray camera_ray(const float* cam, uint32_t k0, uint32_t k1,
                          float pxf, float pyf) {
  float u[6];
  uniforms<3>(k0, k1, 0u, u);
  const float r = sqrtf(u[2]);
  const float theta = kTwoPi * u[3];
  const float dcx = r * cosf(theta);
  const float dcy = r * sinf(theta);
  const float s = (pxf + u[0]) / cam[kCamW];
  const float t = ((cam[kCamHm1] - pyf) + u[1]) / cam[kCamH];
  const float rdx = cam[kCamLens] * dcx;
  const float rdy = cam[kCamLens] * dcy;
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

__global__ void __launch_bounds__(256)
    tile_render_kernel(const float* __restrict__ sph, int n_slots,
                       const float* __restrict__ cam_g,
                       const float* __restrict__ bg_g, uint32_t s0,
                       uint32_t s1, uint32_t lo, int width, int height,
                       int spp, int max_depth, float t_min,
                       float* __restrict__ rad, int* __restrict__ traced) {
  // Intersection rows 0-3 (center xyz, r^2) of every slot; invalid slots
  // carry r^2 = -1 and so never have a positive discriminant.
  extern __shared__ float4 sph4[];
  __shared__ float cam[24];
  __shared__ float bg[8];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < n_slots; i += n_threads) {
    sph4[i] = make_float4(sph[i], sph[n_slots + i], sph[2 * n_slots + i],
                          sph[3 * n_slots + i]);
  }
  if (tid < 24) cam[tid] = cam_g[tid];
  if (tid < 8) bg[tid] = bg_g[tid];
  __syncthreads();

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const uint32_t gid = static_cast<uint32_t>(py * width + px);
  const bool sky = bg[6] < 0.5f;  // BG_SKY == 0

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int n_traced = 0;
  for (int s = 0; s < spp; ++s) {
    uint32_t k0, k1;
    threefry2x32(s0, s1, gid, lo + static_cast<uint32_t>(s), k0, k1);
    Ray ray = camera_ray(cam, k0, k1, static_cast<float>(px),
                         static_cast<float>(py));
    float ox = ray.ox, oy = ray.oy, oz = ray.oz;
    float dx = ray.dx, dy = ray.dy, dz = ray.dz;
    float thr_r = 1.0f, thr_g = 1.0f, thr_b = 1.0f;
    for (int bounce = 0; bounce <= max_depth; ++bounce) {
      ++n_traced;
      // --- closest sphere: the expanded quadratic of _one_bounce.
      const float a = dx * dx + dy * dy + dz * dz;
      const float o_dot_d = ox * dx + oy * dy + oz * dz;
      const float o_dot_o = ox * ox + oy * oy + oz * oz;
      const float inv_a = 1.0f / a;
      float t_best = kInf;
      int win = 0;
      for (int i = 0; i < n_slots; ++i) {
        const float4 c = sph4[i];
        const float d_c = dx * c.x + dy * c.y + dz * c.z;
        const float o_c = ox * c.x + oy * c.y + oz * c.z;
        const float c_sq = c.x * c.x + c.y * c.y + c.z * c.z;
        const float half_b = o_dot_d - d_c;
        const float c_coef = o_dot_o - 2.0f * o_c + c_sq - c.w;
        const float disc = half_b * half_b - a * c_coef;
        if (disc > 0.0f) {
          const float sq = sqrtf(disc);
          const float root0 = (-half_b - sq) * inv_a;
          const float root1 = (-half_b + sq) * inv_a;
          const float t0c = root0 > t_min ? root0 : kInf;
          const float t1c = root1 > t_min ? root1 : kInf;
          const float t_cand = fminf(t0c, t1c);
          if (t_cand < t_best) {
            t_best = t_cand;
            win = i;
          }
        }
      }

      if (!(t_best < kInf)) {  // miss: bank the background and stop
        const float tsky = 0.5f * (dy * rsqrtf(fmaxf(a, 1e-20f)) + 1.0f);
        const float bgr = sky ? (1.0f - tsky) * bg[0] + tsky * bg[3] : bg[0];
        const float bgg = sky ? (1.0f - tsky) * bg[1] + tsky * bg[4] : bg[1];
        const float bgb = sky ? (1.0f - tsky) * bg[2] + tsky * bg[5] : bg[2];
        acc_r += thr_r * bgr;
        acc_g += thr_g * bgg;
        acc_b += thr_b * bgb;
        break;
      }

      // --- the winner's surface.
      const float* col = sph + win;  // row r of the winner: col[r * S]
      const float hx = ox + t_best * dx;
      const float hy = oy + t_best * dy;
      const float hz = oz + t_best * dz;
      const float srad = col[kRowRadius * n_slots];
      const float inv_r = 1.0f / (fabsf(srad) > 1e-20f ? srad : 1.0f);
      const float outx = (hx - col[0]) * inv_r;
      const float outy = (hy - col[n_slots]) * inv_r;
      const float outz = (hz - col[2 * n_slots]) * inv_r;
      const bool front = dx * outx + dy * outy + dz * outz < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      const float nx = outx * sgn, ny = outy * sgn, nz = outz * sgn;
      const float mtype = col[kRowMatType * n_slots];
      const float aux = col[kRowAux * n_slots];

      // --- texture: solid or checker (RTTNW ch. 4.3 sine form).
      int c_row = kRowColor1;
      if (col[kRowTexType * n_slots] == kTexChecker) {
        const float ts = col[kRowTexScale * n_slots];
        if (sinf(ts * hx) * sinf(ts * hy) * sinf(ts * hz) < 0.0f) {
          c_row = kRowColor2;
        }
      }
      const float alb_r = col[c_row * n_slots];
      const float alb_g = col[(c_row + 1) * n_slots];
      const float alb_b = col[(c_row + 2) * n_slots];

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
      float ndx, ndy, ndz;
      bool scattered;
      if (mtype == kMatLambertian) {
        const float inv = rsqrtf(fmaxf(g0 * g0 + g1 * g1 + g2 * g2, 1e-20f));
        ndx = nx + g0 * inv;
        ndy = ny + g1 * inv;
        ndz = nz + g2 * inv;
        if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
          ndx = nx; ndy = ny; ndz = nz;
        }
        scattered = true;
      } else {
        const float inv_dl = 1.0f / fmaxf(sqrtf(a), 1e-20f);
        const float udx = dx * inv_dl, udy = dy * inv_dl, udz = dz * inv_dl;
        const float ud_n = udx * nx + udy * ny + udz * nz;
        const float rfx = udx - 2.0f * ud_n * nx;
        const float rfy = udy - 2.0f * ud_n * ny;
        const float rfz = udz - 2.0f * ud_n * nz;
        if (mtype == kMatMetal) {
          const float inv2 =
              rsqrtf(fmaxf(g3 * g3 + g4 * g4 + g5 * g5, 1e-20f));
          const float rad3 = expf(logf(fmaxf(u[6], 1e-12f)) * (1.0f / 3.0f));
          ndx = rfx + aux * (g3 * inv2 * rad3);
          ndy = rfy + aux * (g4 * inv2 * rad3);
          ndz = rfz + aux * (g5 * inv2 * rad3);
          scattered = ndx * nx + ndy * ny + ndz * nz > 0.0f;
        } else if (mtype == kMatDielectric) {
          const float ratio = front ? 1.0f / fmaxf(aux, 1e-20f) : aux;
          const float cos_t = fminf(-ud_n, 1.0f);
          const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
          float r0 = (1.0f - ratio) / (1.0f + ratio);
          r0 = r0 * r0;
          const float omc = 1.0f - cos_t;
          const float schlick = r0 + (1.0f - r0) * omc * omc * omc * omc * omc;
          if (ratio * sin_t > 1.0f || schlick > u[7]) {
            ndx = rfx; ndy = rfy; ndz = rfz;
          } else {
            const float rpx = ratio * (udx + cos_t * nx);
            const float rpy = ratio * (udy + cos_t * ny);
            const float rpz = ratio * (udz + cos_t * nz);
            const float rlen = sqrtf(
                fmaxf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0f));
            ndx = rpx - rlen * nx;
            ndy = rpy - rlen * ny;
            ndz = rpz - rlen * nz;
          }
          scattered = true;
        } else {  // outside this kernel's material set: absorb
          ndx = dx; ndy = dy; ndz = dz;
          scattered = false;
        }
      }

      if (!scattered || bounce >= max_depth) break;
      if (mtype != kMatDielectric) {  // dielectrics attenuate by 1
        thr_r *= alb_r;
        thr_g *= alb_g;
        thr_b *= alb_b;
      }
      ox = hx; oy = hy; oz = hz;
      dx = ndx; dy = ndy; dz = ndz;
    }
  }
  rad[3 * gid + 0] = acc_r;
  rad[3 * gid + 1] = acc_g;
  rad[3 * gid + 2] = acc_b;
  traced[gid] = n_traced;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// sph: (24, n_slots) f32, cam: (24,) f32, bg: (8,) f32 on the device;
// rad: (width*height, 3) f32 and traced: (width*height,) i32 outputs.
extern "C" int rrt_tile_render(const float* sph, int n_slots,
                               const float* cam, const float* bg, uint32_t s0,
                               uint32_t s1, uint32_t lo, int width, int height,
                               int spp, int max_depth, float t_min, float* rad,
                               int* traced, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const size_t smem = sizeof(float4) * static_cast<size_t>(n_slots);
  tile_render_kernel<<<grid, block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      sph, n_slots, cam, bg, s0, s1, lo, width, height, spp, max_depth, t_min,
      rad, traced);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
