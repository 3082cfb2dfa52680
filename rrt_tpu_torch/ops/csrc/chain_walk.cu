// chain_bwd's kWalk instantiations (chain.cu, chain.cuh): the replay
// walks the solid families' trees past kSolidCap active slots, as
// bounce_steps_kernel's kWalk instantiation does. In a file of their own
// so that nvcc builds them beside chain.cu's loops.

#include "chain.cuh"

int chain_bwd_walk(bool moving, bool tex, cudaStream_t s, const float* st,
                   const uint32_t* keys, int q, const float* sph, int n_slots,
                   const float* nodes, const int* rows, int n_nodes,
                   int n_rows, int n_always, const SolidArgs* solids,
                   TexView tv, const float* bg, const float* d_out,
                   const float* out_bounce, int k_steps, int max_depth,
                   int rr_depth, float t_min, float* d_in, float* partials,
                   int* mismatches) {
  return RRT_PICK_WALK(launch_chain_bwd, moving, tex)(
      s, st, keys, q, sph, n_slots, nodes, rows, n_nodes, n_rows, n_always,
      solids, tv, bg, d_out, out_bounce, k_steps, max_depth, rr_depth, t_min,
      d_in, partials, mismatches);
}
