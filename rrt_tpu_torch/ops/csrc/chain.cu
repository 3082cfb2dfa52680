// The bounce chain's backward: replay K bounce steps of a (16, Q) lane
// state and sweep them in reverse.
//
// chain_bwd_kernel replaces rrt_tpu/ops/megakernel_vjp.py::_bwd_kernel
// (body _bwd_tile_body, launched by _bwd_call) for the scenes of
// tile_render.cu: static and moving spheres (a kMoving instantiation),
// and quads, boxes rotated about Y and diffuse_light (a kSolids
// instantiation: the solid families staged after the BVH, as
// bounce_steps_kernel stages them), and perlin-marble and image textures
// (a kTex instantiation: a marble's cotangents reach its color1, texture
// scale and, through the turbulence's gradient, the hit point; an
// image's go to its texel of the atlas cotangent, four-float atomics in
// device memory; a light's emission then takes emit_adjoint_tex), and
// Russian roulette from bounce rr_depth (0 off): the replay redraws the
// coin at the state's bounce row plus its step, and the sweep gives a
// surviving throughput the detached 1 / p (adjoint.cuh). A scene with a
// solid family past kSolidCap active slots (rttnw_final's 400 ground
// boxes, without its constant media, which the chain leaves out as
// rrt_tpu's does) runs the kWalk instantiation: its replay walks the
// families' trees (accel.SolidBvh), staged in shared memory after the
// rows exactly as bounce_steps_kernel's kWalk instantiation stages and
// walks them (stage_solids_of, bounce_step<..., kWalk>), so its winners
// are the forward's bit for bit and the sweep is unchanged; the records
// hold winner codes of kCodeSpan slots a family, and the partials a
// column of every active quad and box (winner_column), whatever their
// number. chain.cuh holds the kernel and its launch; this file the
// loops' instantiations and the entry point, chain_walk.cu the kWalk
// ones (one nvcc each, side by side: ops/_build.py).
// rrt_tpu_torch/ops/megakernel_vjp.py holds the wrapper
// (chain_adjoint), its plain PyTorch version (chain_adjoint_reference)
// and the autograd.Function BounceChain, whose forward is queue.cu's
// bounce_steps_kernel and whose backward is this kernel.
//
// One thread a lane, 256 lanes a block. A lane that is alive on entry
//  1. replays up to k_steps bounces through bounce.cuh's bounce_step with
//     the BVH walk (BvhWalk over the tree the forward walked, staged in
//     shared memory; with kWalk the solid trees' walk too), the function
//     bounce_steps_kernel runs, from the
//     chain's saved input state and the lane's key, with the bounce
//     counter of state row 13, so its decisions are the forward's bit for
//     bit (with kSolids the walk seeded by the quads and boxes, as the
//     forward's); it keeps a record of each bounce (origin, direction,
//     throughput, winner or its winner_code) and what its scatter draws
//     decided (`kept`: a metal's point in the unit sphere, a dielectric's
//     reflection, a light's checker parity) in
//     thread-local storage (kMaxRecords; the wrapper refuses k_steps
//     above it);
//  2. counts in `mismatches` a lane whose replayed bounce row differs
//     from the forward output's (expected 0: the same code runs);
//  3. sweeps the records in reverse, seeded by the output cotangent rows
//     0-12 (o, d, time, throughput, pending radiance): a scattering
//     bounce through scatter_adjoint (adjoint.cuh, shared with
//     train.cu), which reshades the winner from its record and what the
//     replay kept, so the sweep draws nothing; the bounce that missed
//     passes o, d and throughput through and adds the background's
//     adjoint with the pending radiance's cotangent, the one that ends on
//     a light adds its emission's (emit_adjoint); a bounce that ends on a
//     surface (absorbed, or a hit at max_depth) is the identity. A quad's
//     or box's bounce goes through solid_scatter_adjoint.
//     Pending radiance passes through every bounce; so does time, which
//     with moving spheres also gains each scattering bounce's vel . (the
//     center's cotangent), as rrt_tpu's _make_diff_step gives it under
//     jax.vjp.
// A lane that is dead on entry went through the forward unchanged: its
// input cotangent is the output's, the GPU form of the TPU kernel's
// dead-tile pass-through. Rows 13-15 (bounce, alive, traced) get none.
//
// The sphere pack's 12 (15 moving) gradient rows, and with kSolids the
// active quads' and boxes' columns after them, accumulate as in
// train_bwd: each scattering bounce adds its winner's cotangents to its
// block's row of per-block partials in device memory (kSlotCols floats a
// slot, zeroed by the block first) with four-float atomic reductions
// (add_slot); reduce_partials then sums the rows in a fixed order of
// blocks. The background's six rows are warp sums added in a fixed order
// of warps and blocks, so they are bit-identical from run to run; the
// pack's may differ in the last bits (the order of the reductions within
// a block). Nothing is carried over from the TPU's one-hot MXU scatter
// or its (K*16, TN) VMEM scratch.
//
// What bounds it, and what the design does. The least time is the
// replay's walk (about 20 node and 7 slot tests a segment) and its
// draws, the sweep's transpose (about 300 FP32 operations a bounce) and
// the bytes of the lanes and of the partials: some tens of microseconds
// for the three chains of backward_chain (PERF.md). The walk in place of
// a scan of every slot, the kept draws and the reductions in device
// memory in place of shared-memory float atomics (a compare-and-swap
// loop on this card, spinning on the ground sphere's column) each took a
// part: on an H100 80GB HBM3 at 700 W the three chains take 1.07-1.10
// ms where they took 2.80-2.82 ms with none of them. The reductions also
// leave shared memory to the tree, which at 3,072 slots would not fit
// beside an accumulator. A grid sized to the card, its blocks looping
// over the lanes, ran 4% slower. Built with -fmad=false, as the other
// kernels (ops/_build.py): the replay must repeat the forward's
// arithmetic.


#include "chain.cuh"

// The chain's backward on `stream`; returns cudaGetLastError() (0 on
// success). st: the chain's input state (16, q) f32; keys: (2, q) u32;
// sph: (24, n_slots) f32; the BVH as rrt_tile_render's, the one the
// forward walked; solids: the quad and box packs for the solid-family
// variant, or null, as rrt_bounce_steps'; bg: (8,) f32; d_out: (16, q)
// f32, the output state's cotangent; out_bounce: (q,) f32, the forward
// output's bounce row; moving: nonzero for the moving-sphere variant.
// Outputs: d_in (16, q) f32; scratch: (n_blocks + ceil(n_blocks / 64)) *
// n_cols f32 with n_blocks = ceil(q / 256) and n_cols = kSlotCols *
// (n_slots + n_quads + n_boxes) + 8; sums: (n_cols,) f32 (slot-major:
// kSlotCols floats a slot, a sphere's 12 (15 when moving) gradient rows
// then zeros, then the active quads' and boxes' columns (adjoint.cuh
// kQuadAccPlane ...); then 6 background rows, 2 pad); mismatches: one
// int32, zeroed by the caller; tex: the atlas for the texture variant,
// or null, its d_atlas (with images) the atlas cotangent, zeroed by the
// caller; rr_depth: the forward's Russian roulette (0: off).
extern "C" int rrt_chain_bwd(const float* st, const uint32_t* keys, int q,
                             const float* sph, int n_slots,
                             const float* nodes, const int* rows,
                             int n_nodes, int n_rows, int n_always,
                             const SolidArgs* solids, const TexArgs* tex,
                             const float* bg, const float* d_out, const float* out_bounce,
                             int k_steps, int max_depth, int rr_depth,
                             float t_min, int moving, float* d_in, float* scratch,
                             float* sums, int* mismatches, void* stream) {
  if (k_steps < 1 || k_steps > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SolidArgs none{};
  const SolidArgs& sa = solids != nullptr ? *solids : none;
  const int n_cols = kSlotCols * (n_slots + sa.n_quads + sa.n_boxes) +
                     kBgCols;
  if (q == 0) {
    return static_cast<int>(
        cudaMemsetAsync(sums, 0, sizeof(float) * n_cols, s));
  }
  const int err =
      has_tree(solids)
          ? chain_bwd_walk(moving != 0, tex != nullptr, s, st, keys, q, sph,
                           n_slots, nodes, rows, n_nodes, n_rows, n_always,
                           solids, tex_view(tex), bg, d_out, out_bounce,
                           k_steps, max_depth, rr_depth, t_min, d_in, scratch,
                           mismatches)
          : RRT_PICK3(launch_chain_bwd, moving != 0, solids != nullptr,
                      tex != nullptr)(
                s, st, keys, q, sph, n_slots, nodes, rows, n_nodes, n_rows,
                n_always, solids, tex_view(tex), bg, d_out, out_bounce,
                k_steps, max_depth, rr_depth, t_min, d_in, scratch,
                mismatches);
  if (err != 0) return err;
  const int n_blocks = (q + kThreads - 1) / kThreads;
  return static_cast<int>(reduce_partials(scratch, n_blocks, n_cols, sums, s));
}
