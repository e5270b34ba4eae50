// int8 x int8 -> int32 matmul with an fp32 dequant, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (body `_kernel`). The Pallas body accumulates in fp32; this kernel follows
// the reference oracle (repro/kernels/ref.py::quant_matmul_ref) instead: an
// exact int32 accumulate, then out = float(acc) * (a_scale * b_scale), the
// scale product formed once in fp32, so it is bit-exact against the oracle
// (integer sums are exact in any order).
//
// What bounds it on an H100: on the serving path it is the SNN output head,
// M = bucket (1..64) rows of spike counts by K = 1152 by N = 10 classes —
// about 0.1 MOP on some 12-85 KB, far below one wave of the card, so it is
// bound by launch and memory latency, not by the int8 tensor-core rate.
//
// Design: a plain tiled kernel. A 16 x 16 thread block owns a 16 x 16 output
// tile; per 64-deep K step it stages the A tile and the transposed B tile as
// int8 in shared memory, and each thread runs 16 dp4a (4-way int8 dot
// products into int32) over its row of A and column of B. Ragged M, K and N
// edges are masked by zero-filling the staged tiles and guarding the store —
// no host-side padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;   // output tile side
constexpr int kK = 64;   // K step

__global__ void __launch_bounds__(kT * kT)
quant_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    const float* __restrict__ a_scale,
                    const float* __restrict__ b_scale, float* __restrict__ out,
                    int M, int K, int N) {
  __shared__ __align__(16) int8_t as[kT][kK];   // as[m][k]
  __shared__ __align__(16) int8_t bs[kT][kK];   // bs[n][k] (B transposed)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kT + tx;
  const int m0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  int32_t acc = 0;
  for (int k0 = 0; k0 < K; k0 += kK) {
    for (int i = tid; i < kT * kK; i += kT * kT) {
      const int r = i / kK, k = k0 + i % kK;
      as[r][i % kK] = (m0 + r < M && k < K) ? a[(size_t)(m0 + r) * K + k] : 0;
    }
    for (int i = tid; i < kT * kK; i += kT * kT) {
      const int k = i / kT, c = n0 + i % kT;   // consecutive threads, consecutive n
      bs[i % kT][k] = (k0 + k < K && c < N) ? b[(size_t)(k0 + k) * N + c] : 0;
    }
    __syncthreads();
    const int* arow = reinterpret_cast<const int*>(as[ty]);
    const int* bcol = reinterpret_cast<const int*>(bs[tx]);
#pragma unroll
    for (int j = 0; j < kK / 4; ++j) acc = __dp4a(arow[j], bcol[j], acc);
    __syncthreads();
  }
  if (m0 + ty < M && n0 + tx < N) {
    const float scale = __fmul_rn(a_scale[0], b_scale[0]);
    out[(size_t)(m0 + ty) * N + n0 + tx] = __fmul_rn(__int2float_rn(acc), scale);
  }
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, a_scale/b_scale 0-d fp32 on the device,
// out (M, N) fp32. Returns cudaGetLastError() after the launch.
int quant_matmul(const void* a, const void* b, const void* a_scale,
                 const void* b_scale, void* out, int M, int K, int N,
                 void* stream) {
  dim3 grid((N + kT - 1) / kT, (M + kT - 1) / kT);
  quant_matmul_kernel<<<grid, dim3(kT, kT), 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
