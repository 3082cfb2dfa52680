// The three probe kernels: what a lane's dependent arithmetic, a
// relayout and a random-number mixer cost on the card.
//
// fma_chain_kernel replaces benchmarks/probe_row_layout.py::kern: each
// element runs `iters` iterations of 16 dependent x = x * a + b, one
// fused multiply-add each (fmaf: the build's -fmad=false would split
// x * a + b into two rounded operations). On the TPU the element's place
// in a (1, N) row or an (8, N/8) block chose how much of a vector
// register the chain used; on the card a "shape" is only a thread count,
// one element a thread, 128 threads a block.
//
// fma_chain_relayout_kernel replaces benchmarks/probe_reshape.py::kern's
// "reshape" variant: the same chain with a (1, 1024) <-> (8, 128)
// reshape around it every iteration. A block of 1024 threads holds one
// row; in the (1, 1024) layout thread t holds element t, in the (8, 128)
// layout element (t % 8) * 128 + t / 8 (a sublane-major tile); each
// reshape moves the row through shared memory between two barriers. The
// values are those of the flat chain: the relayout moves elements, it
// does not change them.
//
// rng_kernel replaces benchmarks/probe_rng.py::kern: `iters` calls of
// one mixer on a two-word carry, y = y0 ^ y1 at the end. kMode 0 is the
// baseline body (x0 + i, x1 ^ i), 1 is bounce.cuh's threefry2x32 (the
// code the render kernels run) keyed by the carry on the counter (i,
// i + 1), 2 is pcg4d (Jarzynski and Olano, JCGT 2020) on (x0, x1, i,
// i + 1), folded as (a ^ c, b ^ d).
//
// What bounds them: arithmetic, and in it the chain's latency: each
// element's operations depend on the one before, so a thread issues one
// every few cycles whatever the thread count; at the probes' thread
// counts the card's throughput is far from the limit. The multiplier, the
// addend and the iteration count are kernel arguments, so nvcc folds
// nothing.

#include "bounce.cuh"

namespace {

constexpr int kChainOps = 16;  // fused multiply-adds an iteration
constexpr int kFlatThreads = 128;
constexpr int kRow = 1024;  // the relayout probe's row

__global__ void __launch_bounds__(kFlatThreads)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ y,
                     int n, int iters, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChainOps; ++k) v = fmaf(v, a, b);
  }
  y[i] = v;
}

__global__ void __launch_bounds__(kRow)
    fma_chain_relayout_kernel(const float* __restrict__ x,
                              float* __restrict__ y, int iters, float a,
                              float b) {
  __shared__ float row[kRow];
  const int t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * kRow;
  const int e = (t & 7) * 128 + (t >> 3);  // this thread's (8, 128) element
  float v = x[base + t];
  for (int it = 0; it < iters; ++it) {
    row[t] = v;  // (1, 1024) -> (8, 128)
    __syncthreads();
    v = row[e];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChainOps; ++k) v = fmaf(v, a, b);
    row[e] = v;  // (8, 128) -> (1, 1024)
    __syncthreads();
    v = row[t];
    __syncthreads();
  }
  y[base + t] = v;
}

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  const uint32_t mul = 1664525u, inc = 1013904223u;
  a = a * mul + inc;
  b = b * mul + inc;
  c = c * mul + inc;
  d = d * mul + inc;
  a = a + b * d;
  b = b + c * a;
  c = c + a * b;
  d = d + b * c;
  a = a ^ (a >> 16);
  b = b ^ (b >> 16);
  c = c ^ (c >> 16);
  d = d ^ (d >> 16);
  a = a + b * d;
  b = b + c * a;
  c = c + a * b;
  d = d + b * c;
}

template <int kMode>
__global__ void __launch_bounds__(kFlatThreads)
    rng_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
               int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = x[i], x1 = x[i];
  for (int it = 0; it < iters; ++it) {
    const uint32_t ci = static_cast<uint32_t>(it);
    if (kMode == 1) {
      uint32_t o0, o1;
      threefry2x32(x0, x1, ci, ci + 1u, o0, o1);
      x0 = o0;
      x1 = o1;
    } else if (kMode == 2) {
      uint32_t a = x0, b = x1, c = ci, d = ci + 1u;
      pcg4d(a, b, c, d);
      x0 = a ^ c;
      x1 = b ^ d;
    } else {
      x0 = x0 + ci;
      x1 = x1 ^ ci;
    }
  }
  y[i] = x0 ^ x1;
}

}  // namespace

// The f32 chain on `stream`; returns cudaGetLastError() (0 on success).
// x, y: (n,) f32 on the device. relayout: nonzero for the reshape
// variant, which needs n to be a multiple of 1024.
extern "C" int rrt_probe_fma_chain(const float* x, float* y, int n,
                                   int iters, float a, float b, int relayout,
                                   void* stream) {
  if (n <= 0 || iters < 0 || (relayout && n % kRow != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relayout) {
    fma_chain_relayout_kernel<<<n / kRow, kRow, 0, s>>>(x, y, iters, a, b);
  } else {
    fma_chain_kernel<<<(n + kFlatThreads - 1) / kFlatThreads, kFlatThreads,
                       0, s>>>(x, y, n, iters, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// The u32 mixer on `stream`; x, y: (n,) u32; mode 0 baseline, 1
// threefry2x32, 2 pcg4d.
extern "C" int rrt_probe_rng(const uint32_t* x, uint32_t* y, int n,
                             int iters, int mode, void* stream) {
  if (n <= 0 || iters < 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = mode == 1 ? rng_kernel<1>
                          : (mode == 2 ? rng_kernel<2> : rng_kernel<0>);
  kernel<<<(n + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(x, y, n, iters);
  return static_cast<int>(cudaGetLastError());
}
