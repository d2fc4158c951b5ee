// What the tensor-core step of the port's 1x1 products (pw::mma in
// ops/kernels/csrc/pointwise_mma.cuh: mma.sync m16n8k8 TF32 with float32
// accumulators) reaches on this card, with nothing else in the loop:
//
//   rate:    every warp of every block issues CHAINS independent MMAs
//            (separate accumulators) ITERS times; no loads, no barriers.
//   latency: one warp, one accumulator, ITERS dependent MMAs between two
//            clock64 stamps.
//
// Built and timed by dsgcn_tpu_torch/tools/mma_ceiling.py.
#include "pointwise_mma.cuh"

namespace {

using dsgcn::pw::mma;

template <int CHAINS>
__global__ void rate_kernel(float *out, int iters) {
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u,
                         0x3e000000u};  // 1, 1/2, 1/4, 1/8: exact in TF32
  const uint32_t b0 = 0x3c000000u, b1 = 0x3b800000u;
  float acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma(acc[c], a, b0, b1);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void latency_kernel(float *out, long long *clocks, int iters) {
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u,
                         0x3e000000u};
  const uint32_t b0 = 0x3c000000u, b1 = 0x3b800000u;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) mma(acc, a, b0, b1);
  // the last MMA's result is read before the second stamp
  const float s = acc[0] + acc[1] + acc[2] + acc[3];
  __syncwarp();
  const long long t1 = clock64();
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) *clocks = t1 - t0;
}

template <int CHAINS>
int launch_rate(float *out, int blocks, int threads, int iters,
                cudaStream_t st) {
  rate_kernel<CHAINS><<<blocks, threads, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// out: blocks * threads floats.  chains: 1, 2, 4, 8 or 16.
extern "C" int mma_ceiling_rate(float *out, int blocks, int threads,
                                int chains, int iters, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks < 1 || threads < 32 || threads % 32 || threads > 1024 ||
      iters < 1)
    return (int)cudaErrorInvalidValue;
  switch (chains) {
    case 1: return launch_rate<1>(out, blocks, threads, iters, st);
    case 2: return launch_rate<2>(out, blocks, threads, iters, st);
    case 4: return launch_rate<4>(out, blocks, threads, iters, st);
    case 8: return launch_rate<8>(out, blocks, threads, iters, st);
    case 16: return launch_rate<16>(out, blocks, threads, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: 32 floats; clocks: one int64, the clocks of iters dependent MMAs.
extern "C" int mma_ceiling_latency(float *out, long long *clocks, int iters,
                                   void *stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out, clocks, iters);
  return (int)cudaGetLastError();
}
