// Adjoints of one bounce, shared by the train backward (train.cu) and the
// bounce chain's backward (chain.cu): the hand-written transpose of
// rrt_tpu_torch/ops/megakernel_vjp.py diff_step for a miss and for a
// scattering bounce, the four-float reductions of the sphere pack's
// cotangents into per-block partials in device memory (add_slot), and
// the fixed-order reduction of those partials.

#pragma once

#include "bounce.cuh"

namespace {

// Bounce records a thread keeps while it replays a path or a chain.
constexpr int kMaxRecords = 64;
// Pack rows with gradients, in accumulator order (megakernel_vjp.py
// GRAD_ROWS): center (motion base) 0-2, r^2 3, aux 4, color1 5-7,
// color2 8-10, signed radius 11, and with moving spheres the velocity
// 12-14 (pack rows 4-6): a static scene's accumulator keeps 12 rows.
constexpr int kGradRows = 12;
constexpr int kGradRowsMoving = 15;
constexpr int kAccR2 = 3, kAccAux = 4, kAccColor1 = 5, kAccColor2 = 8,
              kAccRadius = 11, kAccVel = 12;

__host__ __device__ constexpr int grad_rows(bool moving) {
  return moving ? kGradRowsMoving : kGradRows;
}
// Rows of a reduction group of per-block partials.
constexpr int kReduceGroup = 64;

// The input of one replayed bounce.
struct Record {
  float o[3], d[3], thr[3];
  int win;  // -1 on a miss
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Where scatter_adjoint puts the winner's pack cotangents, one add() a
// gradient row (accumulator order): RowSums keeps them for the caller,
// which adds them to its block's partials with add_slot.
template <int kRows>
struct RowSums {
  float g[kRows];
  __device__ __forceinline__ void add(int row, float v) { g[row] = v; }
};

// Pack cotangent floats a slot in the backwards' per-block partials in
// device memory (slot-major: grad rows 0-11, or 0-14 with moving spheres,
// then zeros), so that a bounce adds its cotangents with four-float
// atomics.
constexpr int kSlotCols = 16;

// Add a bounce's pack cotangents g (kRows <= kSlotCols rows) to its
// winner's kSlotCols floats of the block's partials in device memory
// (16-byte aligned): four-float reductions, done in L2 without a reply.
template <int kRows>
__device__ __forceinline__ void add_slot(float* slot, const float* g) {
#pragma unroll
  for (int r = 0; r < kRows; r += 4) {
    atomicAdd(reinterpret_cast<float4*>(slot + r),
              make_float4(g[r], r + 1 < kRows ? g[r + 1] : 0.0f,
                          r + 2 < kRows ? g[r + 2] : 0.0f,
                          r + 3 < kRows ? g[r + 3] : 0.0f));
  }
}

// Adjoint of a miss: the pending radiance gains thr * background(d) and
// o, d and thr pass through. dr: the pending radiance's cotangent. ADDS
// the cotangents of d and thr to gd and gt (a caller with nothing after
// the miss passes them zeroed) and the background's to g_bg.
__device__ __forceinline__ void miss_adjoint(const Record& r,
                                             const float* dr,
                                             const float* bg, bool sky,
                                             float* gd, float* gt,
                                             float* g_bg) {
  const float a = r.d[0] * r.d[0] + r.d[1] * r.d[1] + r.d[2] * r.d[2];
  float rgb[3], tsky, inv_len;
  background(bg, sky, r.d[1], a, rgb, tsky, inv_len);
  for (int c = 0; c < 3; ++c) gt[c] += dr[c] * rgb[c];
  if (!sky) {
    for (int c = 0; c < 3; ++c) g_bg[c] += dr[c] * r.thr[c];
    return;
  }
  float g_tsky = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float w = dr[c] * r.thr[c];
    g_bg[c] += w * (1.0f - tsky);
    g_bg[3 + c] += w * tsky;
    g_tsky += w * (bg[3 + c] - bg[c]);
  }
  // tsky = 0.5 (d_y / |d| + 1)
  gd[1] += 0.5f * g_tsky * inv_len;
  if (a > 1e-20f) {
    const float g_a = 0.5f * g_tsky * r.d[1] * (-0.5f) * inv_len * inv_len *
                      inv_len;
    for (int c = 0; c < 3; ++c) gd[c] += 2.0f * g_a * r.d[c];
  }
}

// Adjoint of a scattering bounce (the sphere branch of diff_step with
// survives = true). In: go, gd, gt, the cotangents of the new origin,
// direction and throughput. Out: the same arrays hold the cotangents of
// the bounce's input origin, direction and throughput; the winner's
// pack cotangents go to `sink` (RowSums, above), one add() a gradient
// row. With kMoving the center
// is base + time * vel (time: the path's time): base gets the center's
// cotangent, vel time times it, and g_time gains vel . it. With
// kKept the shading is recomputed without the scatter draws, from what
// the replay's shade() kept of them (`kept`: shade's kForAdjoint).
template <bool kMoving, class Sink, bool kKept = false>
__device__ __forceinline__ void scatter_adjoint(
    const float* sph, int n_slots, const Record& rec, uint32_t k0,
    uint32_t k1, int bounce, float t_min, float time, float* go, float* gd,
    float* gt, Sink& sink, float& g_time, float* kept = nullptr) {
  Ray ray;
  ray.ox = rec.o[0]; ray.oy = rec.o[1]; ray.oz = rec.o[2];
  ray.dx = rec.d[0]; ray.dy = rec.d[1]; ray.dz = rec.d[2];
  ray.time = time;
  const float* col = sph + rec.win;
  float c[3];
  center_at<kMoving>(col, n_slots, time, c);
  const RayDots q = ray_dots(ray);
  const Quadratic k =
      quadratic(ray, q, c[0], c[1], c[2], col[kRowR2 * n_slots]);
  // The root the forward took (the scan's rule: the near root when it
  // clears t_min), recomputed with the scan's arithmetic.
  const bool disc_ok = k.disc > 0.0f;
  const float sq = sqrtf(disc_ok ? k.disc : 1.0f);
  const float root0 = (-k.half_b - sq) * q.inv_a;
  const float root1 = (-k.half_b + sq) * q.inv_a;
  const bool pick0 = root0 > t_min;
  const float t = pick0 ? root0 : root1;
  Shade sh;
  shade<kMoving, kKept>(col, n_slots, ray, q.a, t, k0, k1, bounce, sh,
                        kept);

  const bool is_lam = sh.mtype == kMatLambertian;
  const bool is_met = sh.mtype == kMatMetal;
  const bool is_die = sh.mtype == kMatDielectric;
  const float* n = sh.n;

  // --- throughput: thr' = thr * att, att = albedo (1 on dielectrics).
  float g_alb[3] = {0.0f, 0.0f, 0.0f};
  float g_thr[3];
  for (int j = 0; j < 3; ++j) {
    g_thr[j] = is_die ? gt[j] : gt[j] * sh.alb[j];
    if (!is_die) g_alb[j] = gt[j] * rec.thr[j];
  }

  // --- direction.
  float g_n[3] = {0.0f, 0.0f, 0.0f};
  float g_d[3] = {0.0f, 0.0f, 0.0f};
  float g_a = 0.0f;
  float g_aux = 0.0f;
  if (is_lam) {  // n + unit, or n when degenerate
    for (int j = 0; j < 3; ++j) g_n[j] += gd[j];
  } else if (is_met || is_die) {
    float g_rf[3] = {0.0f, 0.0f, 0.0f};
    float g_ud[3] = {0.0f, 0.0f, 0.0f};
    float g_udn = 0.0f;
    if (is_met) {  // rf + aux * sv
      for (int j = 0; j < 3; ++j) g_rf[j] = gd[j];
      g_aux += dot3(gd, sh.sv);
    } else if (sh.reflect) {
      for (int j = 0; j < 3; ++j) g_rf[j] = gd[j];
    } else {  // rp - rlen * n, rp = ratio * (ud + cos_t * n)
      const float rpar_sq =
          1.0f - (sh.rp[0] * sh.rp[0] + sh.rp[1] * sh.rp[1] +
                  sh.rp[2] * sh.rp[2]);
      const bool refr_ok = rpar_sq > 1e-12f;
      const float rlen = refr_ok ? sqrtf(rpar_sq) : 0.0f;
      float g_rp[3];
      const float g_rlen = -dot3(gd, n);
      for (int j = 0; j < 3; ++j) {
        g_rp[j] = gd[j];
        g_n[j] += -rlen * gd[j];
      }
      if (refr_ok) {
        const float g_rpsq = g_rlen * 0.5f / rlen;
        for (int j = 0; j < 3; ++j) g_rp[j] += -2.0f * g_rpsq * sh.rp[j];
      }
      float w[3], g_w[3];
      for (int j = 0; j < 3; ++j) {
        w[j] = sh.ud[j] + sh.cos_t * n[j];
        g_w[j] = sh.ratio * g_rp[j];
        g_ud[j] += g_w[j];
        g_n[j] += sh.cos_t * g_w[j];
      }
      const float g_ratio = dot3(g_rp, w);
      const float g_cos = dot3(g_w, n);
      if (-sh.ud_n <= 1.0f) g_udn += -g_cos;  // cos_t = min(-ud_n, 1)
      if (sh.front) {  // ratio = 1 / aux (guarded), else aux
        if (sh.aux > 1e-10f) g_aux += -g_ratio / (sh.aux * sh.aux);
      } else {
        g_aux += g_ratio;
      }
    }
    // rf = ud - 2 ud_n n
    const float g_rf_n = dot3(g_rf, n);
    for (int j = 0; j < 3; ++j) {
      g_ud[j] += g_rf[j];
      g_n[j] += -2.0f * sh.ud_n * g_rf[j];
    }
    g_udn += -2.0f * g_rf_n;
    // ud_n = ud . n
    for (int j = 0; j < 3; ++j) {
      g_ud[j] += g_udn * n[j];
      g_n[j] += g_udn * sh.ud[j];
    }
    // ud = d / max(|d|, 1e-20)
    const float g_inv_dl = dot3(g_ud, rec.d);
    for (int j = 0; j < 3; ++j) g_d[j] += g_ud[j] * sh.inv_dl;
    const float len = sqrtf(q.a);
    if (len > 1e-20f) {
      g_a += -g_inv_dl * sh.inv_dl * sh.inv_dl * 0.5f / len;
    }
  }

  // --- albedo -> color1 or color2, aux -> its row.
  for (int j = 0; j < 3; ++j) {
    sink.add(kAccColor1 + j, sh.use_c2 ? 0.0f : g_alb[j]);
    sink.add(kAccColor2 + j, sh.use_c2 ? g_alb[j] : 0.0f);
  }
  sink.add(kAccAux, g_aux);

  // --- normal: n = (h - c) * inv_r * sgn.
  float g_p[3], g_c[3];
  float g_inv_r = 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float g_out = g_n[j] * sh.sgn;
    g_p[j] = go[j] + g_out * sh.inv_r;
    g_c[j] = -g_out * sh.inv_r;
    g_inv_r += g_out * (sh.h[j] - c[j]);
  }
  const float srad = col[kRowRadius * n_slots];
  sink.add(kAccRadius,
           fabsf(srad) > 1e-20f ? -g_inv_r * sh.inv_r * sh.inv_r : 0.0f);

  // --- hit point: h = o + t d.
  float g_o[3];
  for (int j = 0; j < 3; ++j) {
    g_o[j] = g_p[j];
    g_d[j] += t * g_p[j];
  }
  const float g_t = dot3(g_p, rec.d);

  // --- t = (-half_b + s sq) inv_a, s = -1 on root 0.
  const float s = pick0 ? -1.0f : 1.0f;
  float g_h = -g_t * q.inv_a;
  const float g_sq = s * g_t * q.inv_a;
  const float g_inv_a = g_t * (-k.half_b + s * sq);
  g_a += -g_inv_a * q.inv_a * q.inv_a;
  const float g_disc = disc_ok ? g_sq * 0.5f / sq : 0.0f;
  // disc = half_b^2 - a c_coef
  g_h += 2.0f * k.half_b * g_disc;
  g_a += -k.c_coef * g_disc;
  const float g_cc = -q.a * g_disc;
  // c_coef = o.o - 2 o.c + c.c - r^2; half_b = o.d - d.c; a = d.d
  for (int j = 0; j < 3; ++j) {
    g_o[j] += g_h * rec.d[j] + 2.0f * g_cc * rec.o[j] - 2.0f * g_cc * c[j];
    g_d[j] += g_h * rec.o[j] - g_h * c[j] + 2.0f * g_a * rec.d[j];
    g_c[j] += -g_h * rec.d[j] - 2.0f * g_cc * rec.o[j] + 2.0f * g_cc * c[j];
    sink.add(j, g_c[j]);
    if constexpr (kMoving) {
      sink.add(kAccVel + j, time * g_c[j]);
      g_time += col[(kRowVel + j) * n_slots] * g_c[j];
    }
  }
  sink.add(kAccR2, -g_cc);

  for (int j = 0; j < 3; ++j) {
    go[j] = g_o[j];
    gd[j] = g_d[j];
    gt[j] = g_thr[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// out[g, j] = sum over rows r of group g (rows g*group .. g*group +
// group - 1, in order) of in[r, j]: a fixed-order reduction.
__global__ void reduce_blocks_kernel(const float* __restrict__ in,
                                     int n_rows, int n_cols, int group,
                                     float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_cols) return;
  const int r0 = blockIdx.y * group;
  const int r1 = min(r0 + group, n_rows);
  float v = 0.0f;
  for (int r = r0; r < r1; ++r) v += in[static_cast<size_t>(r) * n_cols + j];
  out[static_cast<size_t>(blockIdx.y) * n_cols + j] = v;
}

// Sum the per-block partials (n_blocks rows of n_cols at `scratch`) into
// `sums` in a fixed order: groups of kReduceGroup blocks into the rows
// below them, then the groups. scratch holds (n_blocks +
// ceil(n_blocks / kReduceGroup)) rows.
inline cudaError_t reduce_partials(float* scratch, int n_blocks, int n_cols,
                                   float* sums, cudaStream_t st) {
  const int n_groups = (n_blocks + kReduceGroup - 1) / kReduceGroup;
  float* mid = scratch + static_cast<size_t>(n_blocks) * n_cols;
  const dim3 rgrid((n_cols + 255) / 256, n_groups);
  reduce_blocks_kernel<<<rgrid, 256, 0, st>>>(scratch, n_blocks, n_cols,
                                              kReduceGroup, mid);
  reduce_blocks_kernel<<<dim3((n_cols + 255) / 256, 1), 256, 0, st>>>(
      mid, n_groups, n_cols, n_groups, sums);
  return cudaGetLastError();
}

}  // namespace
