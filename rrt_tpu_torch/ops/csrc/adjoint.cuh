// Adjoints of one bounce, shared by the train backward (train.cu) and the
// bounce chain's backward (chain.cu): the hand-written transpose of
// rrt_tpu_torch/ops/megakernel_vjp.py diff_step for a miss, a light's
// emission and a scattering bounce on a sphere, a quad, a box or in a
// constant medium, with (kTex) the marble's and the image's albedo, the
// atlas cotangent by float atomics into device memory, Russian
// roulette's detached 1 / p on a surviving throughput (rr_inv_p), the
// four-float reductions of the pack cotangents into per-block partials
// in device memory (add_slot), and the fixed-order reduction of those
// partials.

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
// A marble's texture scale: the last column of a sphere's, quad's or
// box's kSlotCols (megakernel_vjp.py TEX_SCALE_COL), which the variants
// with textures (kTex) add.
constexpr int kAccTexScale = 15, kTexRows = 16;

__host__ __device__ constexpr int grad_rows(bool moving) {
  return moving ? kGradRowsMoving : kGradRows;
}
// The columns a sphere's adjoint fills: grad_rows, or with textures all
// of kSlotCols, the texture scale last.
__host__ __device__ constexpr int sphere_rows(bool moving, bool tex) {
  return tex ? kTexRows : grad_rows(moving);
}
// Rows of a reduction group of per-block partials.
constexpr int kReduceGroup = 64;
// The columns of a quad's and a box's cotangents in the partials
// (megakernel_vjp.py QUAD_MAT_ROWS, BOX_GRAD_ROWS): aux, color1 and
// color2 at a sphere's (kAccAux, kAccColor1, kAccColor2); a quad's frame
// normal n xyz at 0-2 and d_plane at 3 (geometry.quad_frame_vjp takes
// them to q, u, v); a box's center at 0-2, cos at 3, sin at 11 and half
// extents at 12-14. kSolidRows: the columns either fills.
constexpr int kQuadAccPlane = 3;
constexpr int kBoxAccCos = 3, kBoxAccSin = 11, kBoxAccHalf = 12;
constexpr int kSolidRows = 15;
// A medium's columns (megakernel_vjp.py MED_COLS, its pack's columns 1-7,
// 17, 19-21): center 0-2, radius 3, half extents 4-6, -1/density 7,
// albedo 8-10.
constexpr int kMedAccRadius = 3, kMedAccHalf = 4, kMedAccNid = 7,
              kMedAccAlbedo = 8, kMediumRows = 11;

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
// which adds them to its block's partials with add_slot. The adjoints
// that fill only some rows take it zeroed (RowSums<k> sums{}).
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

// The albedo's cotangent g_alb to its source, for a shade `sh` of the
// winner whose material rows start at `mat` (a row `stride` floats
// apart): color1 or color2 (the checker's parity); with kTex, a marble's
// color1 (times its factor), texture scale (kAccTexScale) and hit point
// (ADDED to g_p, through the turbulence's gradient sh.dturb), or an
// image's texel, whose atlas cotangent gains g_alb (a four-float atomic
// in device memory; nothing flows to uv, the texel is replayed).
template <bool kTex, class Sink>
__device__ __forceinline__ void albedo_adjoint(const Shade& sh,
                                               const float* mat, int stride,
                                               const float* g_alb,
                                               const TexView* tex, float* g_p,
                                               Sink& sink) {
  if constexpr (kTex) {
    const float tt = mat[kMatTexType * stride];
    if (tt == kTexPerlin) {
      float g_m = 0.0f;
      for (int j = 0; j < 3; ++j) {
        sink.add(kAccColor1 + j, g_alb[j] * sh.marble);
        sink.add(kAccColor2 + j, 0.0f);
        g_m += g_alb[j] * mat[(kMatColor1 + j) * stride];
      }
      // marble = 0.5 (1 + sin(phase)), phase = scale z + 10 turb(h)
      const float g_phase = g_m * 0.5f * cosf(sh.phase);
      sink.add(kAccTexScale, g_phase * sh.h[2]);
      g_p[2] += g_phase * mat[kMatTexScale * stride];
      for (int j = 0; j < 3; ++j) g_p[j] += g_phase * 10.0f * sh.dturb[j];
      return;
    }
    sink.add(kAccTexScale, 0.0f);
    if (tt == kTexImage) {
      for (int j = 0; j < 3; ++j) {
        sink.add(kAccColor1 + j, 0.0f);
        sink.add(kAccColor2 + j, 0.0f);
      }
      atomicAdd(tex->d_atlas + sh.texel,
                make_float4(g_alb[0], g_alb[1], g_alb[2], 0.0f));
      return;
    }
  }
  for (int j = 0; j < 3; ++j) {
    sink.add(kAccColor1 + j, sh.use_c2 ? 0.0f : g_alb[j]);
    sink.add(kAccColor2 + j, sh.use_c2 ? g_alb[j] : 0.0f);
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
// the replay's shade() kept of them (`kept`: shade's kForAdjoint). kTex:
// the albedo's texture (albedo_adjoint; `tex` the atlas and its
// cotangent). From bounce rr_depth on (rr_depth > 0) the new throughput
// is thr * att / p, p detached (bounce.cuh rr_inv_p). A light's emission
// (thr * albedo) has this adjoint with the pending radiance's cotangent
// in gt, none in go and gd, and rr_depth 0 (emit_adjoint_tex).
template <bool kMoving, class Sink, bool kKept = false, bool kTex = false>
__device__ __forceinline__ void scatter_adjoint(
    const float* sph, int n_slots, const Record& rec, uint32_t k0,
    uint32_t k1, int bounce, int rr_depth, float t_min, float time,
    float* go, float* gd,
    float* gt, Sink& sink, float& g_time, float* kept = nullptr,
    const TexView* tex = nullptr) {
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
  shade<kMoving, kKept, false, kTex>(col, n_slots, ray, q.a, t, k0, k1,
                                     bounce, sh, kept, tex);

  const bool is_lam = sh.mtype == kMatLambertian;
  const bool is_met = sh.mtype == kMatMetal;
  const bool is_die = sh.mtype == kMatDielectric;
  const float* n = sh.n;

  // --- throughput: thr' = thr * att * inv_p, att = albedo (1 on
  // dielectrics), inv_p the detached RR weight (1 where RR is off).
  const float att[3] = {is_die ? 1.0f : sh.alb[0], is_die ? 1.0f : sh.alb[1],
                        is_die ? 1.0f : sh.alb[2]};
  const float inv_p = rr_inv_p(rec.thr, att, bounce, rr_depth);
  float g_alb[3] = {0.0f, 0.0f, 0.0f};
  float g_thr[3];
  for (int j = 0; j < 3; ++j) {
    const float g = gt[j] * inv_p;
    g_thr[j] = is_die ? g : g * sh.alb[j];
    if (!is_die) g_alb[j] = g * rec.thr[j];
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

  // --- albedo -> color1 or color2 (or its texture), aux -> its row.
  float g_tex[3] = {0.0f, 0.0f, 0.0f};
  albedo_adjoint<kTex>(sh, col + kRowMatType * n_slots, n_slots, g_alb, tex,
                       g_tex, sink);
  sink.add(kAccAux, g_aux);

  // --- normal: n = (h - c) * inv_r * sgn.
  float g_p[3], g_c[3];
  float g_inv_r = 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float g_out = g_n[j] * sh.sgn;
    g_p[j] = go[j] + g_out * sh.inv_r;
    if constexpr (kTex) g_p[j] += g_tex[j];
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

// The material rows of a winner (shade_material's `mat` and `stride`):
// sphere slot `slot` of the pack sph (24, n_slots), or quad or box
// `slot` of sv's packs.
__device__ __forceinline__ const float* winner_material(const float* sph,
                                                       int n_slots,
                                                       const Solids* sv,
                                                       int fam, int slot,
                                                       int& stride) {
  if (fam == kFamQuad) {
    stride = sv->quad_slots;
    return sv->quad + kQuadMatRow * stride + slot;
  }
  if (fam == kFamBox) {
    stride = sv->box_slots;
    return sv->box + kBoxMatRow * stride + slot;
  }
  stride = n_slots;
  return sph + kRowMatType * n_slots + slot;
}

// Where a winner's cotangents start in a block's row of the partials:
// kSlotCols floats a slot, the n_slots spheres', then sv's active quads',
// then its boxes', then its media's.
__device__ __forceinline__ int winner_column(int n_slots, const Solids* sv,
                                             int fam, int slot) {
  const int i =
      fam == kFamQuad
          ? n_slots + slot
          : (fam == kFamBox
                 ? n_slots + sv->n_quads + slot
                 : (fam == kFamMedium
                        ? n_slots + sv->n_quads + sv->n_boxes + slot
                        : slot));
  return i * kSlotCols;
}

// Adjoint of a scatter in medium `slot` of sv (diff_step's medium branch
// with survives = true): the new origin is h = o + t d with t = te +
// (-1/density) log(u) / |d|, te = max(t_enter, t_min, 0) the boundary's
// entry t, the new throughput thr * albedo, the new direction the
// in-sphere draw (no gradient). The boundary's type, its rotation, the
// slab that bounds te and its side, and the clamps are replayed
// decisions: ties between them go to the first, where rrt_tpu's scan
// splits them (measure zero). In: go, gd, gt, the cotangents of the new
// origin, direction and throughput; out: those of the bounce's input.
// The medium's 11 cotangents go to `sink` (zeroed by the caller) in its
// columns (kMedAccRadius ...). From bounce rr_depth on the throughput
// takes the detached 1 / p of the albedo-attenuated throughput, the
// albedo folded in before the coin, as in the forward.
template <class Sink>
__device__ __forceinline__ void medium_adjoint(const Solids& sv, int slot,
                                               const Record& rec,
                                               uint32_t k0, uint32_t k1,
                                               int bounce, int rr_depth,
                                               float t_min,
                                               float* go, float* gd,
                                               float* gt, Sink& sink) {
  const float* m = sv.med + slot * kMedCols;
  const float a = dot3(rec.d, rec.d);
  const float inv_a = 1.0f / a;
  const float d_len = sqrtf(a);
  const float inv_dlen = 1.0f / fmaxf(d_len, 1e-20f);
  const float logu = logf(fmaxf(medium_uniform(k0, k1, bounce, slot),
                                1e-12f));
  float oc[3];
  for (int j = 0; j < 3; ++j) oc[j] = rec.o[j] - m[kMedCenter + j];

  // --- the forward: the entry t, and what its gradient follows.
  const bool is_sph = m[0] < 0.5f;
  float t_enter, hb = 0.0f, cc = 0.0f, sq = 1.0f, inv_db = 0.0f;
  float side = 0.0f;  // the box slab's t: (side h_k - ob_k) / db_k
  int axis = -1;
  if (is_sph) {
    hb = dot3(oc, rec.d);
    cc = dot3(oc, oc) - m[kMedRadius] * m[kMedRadius];
    const float disc = hb * hb - a * cc;
    sq = sqrtf(disc > 0.0f ? disc : 1.0f);
    t_enter = (-hb - sq) * inv_a;
  } else {
    t_enter = -kInf;
    for (int k = 0; k < 3; ++k) {
      const float r0 = m[kMedRot + k], r1 = m[kMedRot + 3 + k],
                  r2 = m[kMedRot + 6 + k];
      const float ob = r0 * oc[0] + r1 * oc[1] + r2 * oc[2];
      const float db = r0 * rec.d[0] + r1 * rec.d[1] + r2 * rec.d[2];
      const float hk = m[kMedHalf + k];
      // A parallel axis bounds nothing on a ray that scattered inside
      // (it starts inside that slab), and carries no gradient.
      if (fabsf(db) <= 1e-12f) continue;
      const float inv = 1.0f / db;
      const float t1 = (-hk - ob) * inv, t2 = (hk - ob) * inv;
      const float klo = fminf(t1, t2);
      if (klo > t_enter) {
        t_enter = klo;
        axis = k;
        side = t1 <= t2 ? -1.0f : 1.0f;
        inv_db = inv;
      }
    }
  }
  const float te0 = fmaxf(t_enter, t_min);
  const float te = fmaxf(te0, 0.0f);
  const float hit_dist = m[kMedNid] * logu;
  const float t = te + hit_dist * inv_dlen;

  // --- throughput: thr' = thr * albedo * inv_p.
  const float inv_p = rr_inv_p(rec.thr, m + kMedAlbedo, bounce, rr_depth);
  for (int j = 0; j < 3; ++j) {
    const float g = gt[j] * inv_p;
    sink.add(kMedAccAlbedo + j, g * rec.thr[j]);
    gt[j] = g * m[kMedAlbedo + j];
  }
  // --- the new origin h = o + t d.
  float g_o[3], g_d[3], g_oc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < 3; ++j) {
    g_o[j] = go[j];
    g_d[j] = t * go[j];
  }
  const float g_t = dot3(go, rec.d);
  // t = te + hit_dist * inv_dlen, inv_dlen = 1 / max(sqrt(a), 1e-20).
  sink.add(kMedAccNid, g_t * inv_dlen * logu);
  float g_a = 0.0f;
  if (d_len > 1e-20f) {
    g_a += -g_t * hit_dist * inv_dlen * inv_dlen * 0.5f / d_len;
  }
  const float g_enter = t_enter > t_min && te0 > 0.0f ? g_t : 0.0f;
  if (is_sph) {  // t_enter = (-hb - sq) inv_a
    float g_hb = -g_enter * inv_a;
    g_a += -g_enter * (-hb - sq) * inv_a * inv_a;
    const float g_disc = -g_enter * inv_a * 0.5f / sq;
    g_hb += 2.0f * hb * g_disc;
    g_a += -cc * g_disc;
    const float g_cc = -a * g_disc;
    for (int j = 0; j < 3; ++j) {  // hb = oc.d, cc = oc.oc - r^2
      g_oc[j] = g_hb * rec.d[j] + 2.0f * g_cc * oc[j];
      g_d[j] += g_hb * oc[j];
    }
    sink.add(kMedAccRadius, -2.0f * m[kMedRadius] * g_cc);
  } else if (axis >= 0) {  // t_enter = (side h - ob) inv_db
    const float hk = m[kMedHalf + axis];
    const float ob = m[kMedRot + axis] * oc[0] +
                     m[kMedRot + 3 + axis] * oc[1] +
                     m[kMedRot + 6 + axis] * oc[2];
    const float g_ob = -g_enter * inv_db;
    const float g_db = -g_enter * (side * hk - ob) * inv_db * inv_db;
    sink.add(kMedAccHalf + axis, side * g_enter * inv_db);
    for (int j = 0; j < 3; ++j) {
      const float rk = m[kMedRot + 3 * j + axis];
      g_oc[j] = g_ob * rk;
      g_d[j] += g_db * rk;
    }
  }
  for (int j = 0; j < 3; ++j) {  // oc = o - c; a = d.d
    g_o[j] += g_oc[j];
    sink.add(j, -g_oc[j]);
    g_d[j] += 2.0f * g_a * rec.d[j];
    go[j] = g_o[j];
    gd[j] = g_d[j];
  }
}

// Adjoint of the bounce that ends a path on a diffuse_light (either
// side), winner code rec.win: the pending radiance gains thr * albedo.
// kept: what the replay kept (kept[0]: the checker parity); dr: the
// pending radiance's cotangent. ADDS the throughput's cotangent to gt,
// and the albedo's to the light's color rows in `acc` (the block's row
// of the partials).
__device__ __forceinline__ void emit_adjoint(const float* sph, int n_slots,
                                             const Solids& sv,
                                             const Record& rec,
                                             const float* kept,
                                             const float* dr, float* gt,
                                             float* acc) {
  int slot, stride;
  const int fam = code_family(rec.win, slot);
  const float* mat = winner_material(sph, n_slots, &sv, fam, slot, stride);
  const bool c2 = kept[0] != 0.0f;
  const int row = c2 ? kMatColor2 : kMatColor1;
  RowSums<kSolidRows> sums{};
  for (int j = 0; j < 3; ++j) {
    gt[j] += dr[j] * mat[(row + j) * stride];
    sums.add((c2 ? kAccColor2 : kAccColor1) + j, dr[j] * rec.thr[j]);
  }
  add_slot<kSolidRows>(acc + winner_column(n_slots, &sv, fam, slot), sums.g);
}

// The material half of a scattering bounce's adjoint, for a shade `sh`
// of the winner recomputed with kForAdjoint: from gd and gt, the
// cotangents of the new direction and throughput, the throughput's
// (g_thr), the albedo's (g_alb), the face normal's (g_n), the incoming
// direction's through its unit vector (g_d) and |d|^2 (g_a), and aux's
// (g_aux); the throughput's and the albedo's take Russian roulette's
// detached 1 / p from bounce rr_depth on. scatter_adjoint's arithmetic;
// the sphere's copy there stays as it was, so that the sphere variants
// compile unchanged.
__device__ __forceinline__ void material_adjoint(
    const Shade& sh, const Record& rec, float a, int bounce, int rr_depth,
    const float* gd, const float* gt, float* g_thr, float* g_alb, float* g_n,
    float* g_d, float& g_a, float& g_aux) {
  const bool is_lam = sh.mtype == kMatLambertian;
  const bool is_met = sh.mtype == kMatMetal;
  const bool is_die = sh.mtype == kMatDielectric;
  const float* n = sh.n;
  const float att[3] = {is_die ? 1.0f : sh.alb[0], is_die ? 1.0f : sh.alb[1],
                        is_die ? 1.0f : sh.alb[2]};
  const float inv_p = rr_inv_p(rec.thr, att, bounce, rr_depth);
  for (int j = 0; j < 3; ++j) {
    const float g = gt[j] * inv_p;
    g_thr[j] = is_die ? g : g * sh.alb[j];
    g_alb[j] = is_die ? 0.0f : g * rec.thr[j];
    g_n[j] = 0.0f;
    g_d[j] = 0.0f;
  }
  g_a = 0.0f;
  g_aux = 0.0f;
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
    const float len = sqrtf(a);
    if (len > 1e-20f) {
      g_a += -g_inv_dl * sh.inv_dl * sh.inv_dl * 0.5f / len;
    }
  }
}

// Adjoint of a scattering bounce on quad or box `slot` (fam) of the
// staged solids sv: diff_step's quad and box branches with survives =
// true. The forward's t is recomputed alone (solid_t, its bits) and the
// winner reshaded from what the replay kept (shade_material's
// kForAdjoint). A quad's t is (d_plane - n.o) / (n.d) and its normal
// n / |n|; a box's t is that of its face nearest the forward's t, (side
// h_k - o_k) / d_k in the box's frame, and its normal the frame axis
// solid_surface picks, rotated back: the face, the axis and their signs
// are detached. In: go, gd, gt, the cotangents of the new origin,
// direction and throughput; out: those of the bounce's input. The
// winner's cotangents go to `sink` (zeroed by the caller) in the quad's
// or box's columns (kQuadAccPlane, kBoxAccCos, ...). kTex and rr_depth:
// as scatter_adjoint's (the atlas sv.tex).
template <class Sink, bool kTex = false>
__device__ __forceinline__ void solid_scatter_adjoint(
    const Solids& sv, int fam, int slot, const Record& rec, uint32_t k0,
    uint32_t k1, int bounce, int rr_depth, float t_min, float* go, float* gd,
    float* gt, Sink& sink, float* kept) {
  Ray ray;
  ray.ox = rec.o[0]; ray.oy = rec.o[1]; ray.oz = rec.o[2];
  ray.dx = rec.d[0]; ray.dy = rec.d[1]; ray.dz = rec.d[2];
  ray.time = 0.0f;
  const RayDots q = ray_dots(ray);
  const float t = solid_t(sv, fam, slot, ray, q, t_min);
  Shade sh;
  for (int j = 0; j < 3; ++j) sh.h[j] = rec.o[j] + t * rec.d[j];
  float out[3];
  int stride;
  const float* mat = solid_surface(sv, fam, slot, sh.h, out, stride);
  if constexpr (kTex) solid_uv(sv, fam, slot, sh);
  shade_material<true, false, kTex>(mat, stride, ray, q.a, out, k0, k1,
                                    bounce, sh, kept, &sv.tex);

  float g_thr[3], g_alb[3], g_n[3], g_d[3], g_a, g_aux;
  material_adjoint(sh, rec, q.a, bounce, rr_depth, gd, gt, g_thr, g_alb, g_n,
                   g_d, g_a, g_aux);
  // The hit point's cotangent: the new origin's, and the texture's.
  float g_h[3] = {go[0], go[1], go[2]};
  albedo_adjoint<kTex>(sh, mat, stride, g_alb, &sv.tex, g_h, sink);
  sink.add(kAccAux, g_aux);

  // --- the hit point h = o + t d; the outward normal's cotangent.
  float g_o[3], g_out[3];
  for (int j = 0; j < 3; ++j) {
    g_o[j] = g_h[j];
    g_d[j] += t * g_h[j] + 2.0f * g_a * rec.d[j];  // and a = d.d
    g_out[j] = g_n[j] * sh.sgn;
  }
  const float g_t = dot3(g_h, rec.d);

  if (fam == kFamQuad) {
    const float4 nw = sv.qn[slot];
    const float n[3] = {nw.x, nw.y, nw.z};
    // out = n rsqrt(n.n), guarded as diff_step.
    const float nn = dot3(n, n);
    const float qinv = rsqrtf(nn > 1e-20f ? nn : 1.0f);
    const float g_nn =
        nn > 1e-20f ? dot3(g_out, n) * -0.5f * qinv * qinv * qinv : 0.0f;
    // t = (d_plane - o.n) / (d.n)
    const float denom = dot3(rec.d, n);
    const float inv = 1.0f / denom;
    const float num = nw.w - dot3(rec.o, n);
    const float g_num = g_t * inv;
    const float g_den = -g_t * num * inv * inv;
    for (int j = 0; j < 3; ++j) {
      sink.add(j, g_out[j] * qinv + 2.0f * g_nn * n[j] - g_num * rec.o[j] +
                      g_den * rec.d[j]);
      g_o[j] += -g_num * n[j];
      g_d[j] += g_den * n[j];
    }
    sink.add(kQuadAccPlane, g_num);
  } else {
    const float4 c4 = sv.bc[slot];
    const float4 h4 = sv.bh[slot];
    const float cth = c4.w, sth = h4.w;
    // The normal: out = (cth nbx + sth nbz, nby, -sth nbx + cth nbz).
    const float wx = sh.h[0] - c4.x, wy = sh.h[1] - c4.y,
                wz = sh.h[2] - c4.z;
    const float qx = cth * wx - sth * wz;
    const float qz = sth * wx + cth * wz;
    const float fx = fabsf(qx) - h4.x;
    const float fy = fabsf(wy) - h4.y;
    const float fz = fabsf(qz) - h4.z;
    const bool use_x = fx >= fy && fx >= fz;
    const bool use_y = !use_x && fy >= fz;
    const float nbx = use_x ? (qx >= 0.0f ? 1.0f : -1.0f) : 0.0f;
    const float nbz = use_x || use_y ? 0.0f : (qz >= 0.0f ? 1.0f : -1.0f);
    float g_cos = g_out[0] * nbx + g_out[2] * nbz;
    float g_sin = g_out[0] * nbz - g_out[2] * nbx;
    // t: the face (axis k, side) whose t is nearest the forward's.
    const float bw[3] = {rec.o[0] - c4.x, rec.o[1] - c4.y, rec.o[2] - c4.z};
    const float half[3] = {h4.x, h4.y, h4.z};
    float ob[3], db[3];
    ob[0] = cth * bw[0] - sth * bw[2];
    db[0] = cth * rec.d[0] - sth * rec.d[2];
    ob[1] = bw[1];
    db[1] = rec.d[1];
    ob[2] = sth * bw[0] + cth * bw[2];
    db[2] = sth * rec.d[0] + cth * rec.d[2];
    int axis = 0;
    float side = -1.0f, best = kInf;
    for (int k = 0; k < 3; ++k) {
      if (!(fabsf(db[k]) > 1e-12f)) continue;
      const float inv_db = 1.0f / db[k];
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        const float err =
            fabsf((static_cast<float>(sgn) * half[k] - ob[k]) * inv_db - t);
        if (err < best) {
          best = err;
          axis = k;
          side = static_cast<float>(sgn);
        }
      }
    }
    // t = (side h_k - ob_k) / db_k
    const float inv_db = 1.0f / db[axis];
    const float g_ob = -g_t * inv_db;
    const float g_db = -g_t * (side * half[axis] - ob[axis]) * inv_db * inv_db;
    sink.add(kBoxAccHalf + axis, side * g_t * inv_db);
    float g_w[3] = {0.0f, 0.0f, 0.0f};
    if (axis == 0) {  // ob = cth wx - sth wz, db = cth dx - sth dz
      g_cos += g_ob * bw[0] + g_db * rec.d[0];
      g_sin += -g_ob * bw[2] - g_db * rec.d[2];
      g_w[0] = g_ob * cth;
      g_w[2] = -g_ob * sth;
      g_d[0] += g_db * cth;
      g_d[2] += -g_db * sth;
    } else if (axis == 1) {
      g_w[1] = g_ob;
      g_d[1] += g_db;
    } else {  // ob = sth wx + cth wz, db = sth dx + cth dz
      g_sin += g_ob * bw[0] + g_db * rec.d[0];
      g_cos += g_ob * bw[2] + g_db * rec.d[2];
      g_w[0] = g_ob * sth;
      g_w[2] = g_ob * cth;
      g_d[0] += g_db * sth;
      g_d[2] += g_db * cth;
    }
    for (int j = 0; j < 3; ++j) {  // w = o - center
      g_o[j] += g_w[j];
      sink.add(j, -g_w[j]);
    }
    sink.add(kBoxAccCos, g_cos);
    sink.add(kBoxAccSin, g_sin);
  }
  for (int j = 0; j < 3; ++j) {
    go[j] = g_o[j];
    gd[j] = g_d[j];
    gt[j] = g_thr[j];
  }
}

// Adjoint of the bounce that ends a path on a diffuse_light in a scene
// with textures (kTex; emit_adjoint without): its emission thr * albedo
// is a scatter's throughput thr * albedo, so this is the winner's
// scatter adjoint with the pending radiance's cotangent dr in the
// throughput's place and none for the new origin and direction, which
// the path does not take (nor Russian roulette's weight: rr_depth 0): a
// textured light's albedo depends on the hit point, whose cotangent
// reaches t, the ray and the geometry. Its
// results are ADDED to go, gd, gt (and g_time), the winner's cotangents
// to its columns of `acc` (the block's row of the partials).
template <bool kMoving>
__device__ __forceinline__ void emit_adjoint_tex(
    const float* sph, int n_slots, const Solids& sv, const Record& rec,
    uint32_t k0, uint32_t k1, int bounce, float t_min, float time,
    float* kept, const float* dr, float* go, float* gd, float* gt,
    float& g_time, float* acc) {
  float eo[3] = {0.0f, 0.0f, 0.0f}, ed[3] = {0.0f, 0.0f, 0.0f};
  float et[3] = {dr[0], dr[1], dr[2]};
  int slot;
  const int fam = code_family(rec.win, slot);
  if (fam == kFamSphere) {
    RowSums<sphere_rows(kMoving, true)> sums{};
    scatter_adjoint<kMoving, decltype(sums), true, true>(
        sph, n_slots, rec, k0, k1, bounce, 0, t_min, time, eo, ed, et, sums,
        g_time, kept, &sv.tex);
    add_slot<sphere_rows(kMoving, true)>(acc + slot * kSlotCols, sums.g);
  } else {
    RowSums<kTexRows> sums{};
    solid_scatter_adjoint<decltype(sums), true>(sv, fam, slot, rec, k0, k1,
                                                bounce, 0, t_min, eo, ed, et,
                                                sums, kept);
    add_slot<kTexRows>(acc + winner_column(n_slots, &sv, fam, slot),
                       sums.g);
  }
  for (int j = 0; j < 3; ++j) {
    go[j] += eo[j];
    gd[j] += ed[j];
    gt[j] += et[j];
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
