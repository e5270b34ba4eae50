// MoE dispatch row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gather.py::moe_gather
// (body `_kernel`): capacity slot s receives row indices[s] of the token
// activations x (T, d), or zeros where the index is negative; an index past
// the last row is clamped to it (the reference oracle's clip). The TPU
// kernel prefetches the indices as scalars and copies block_rows rows per
// grid step.
//
// What bounds it on an H100: device-memory bytes, the gathered rows read
// once and the S rows written once; there is no arithmetic.
//
// Design: one warp per slot, eight slots per block. The warp reads its
// index once and copies the row as raw bytes, so every dtype works: the
// wrapper picks the widest unit (16, 8, 4, 2 or 1 bytes) that divides the
// row size and both base pointers, and consecutive lanes move consecutive
// units, so loads and stores coalesce. A copy is exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // slots per block

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
moe_gather_kernel(const char* __restrict__ x, const int32_t* __restrict__ idx,
                  char* __restrict__ out, int T, int S, int row_bytes) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const int n = row_bytes / (int)sizeof(V);
  V* dst = reinterpret_cast<V*>(out + (size_t)s * row_bytes);
  const int tok = idx[s];
  if (tok < 0) {
    const V zero{};
    for (int i = lane; i < n; i += 32) dst[i] = zero;
    return;
  }
  const V* src = reinterpret_cast<const V*>(
      x + (size_t)min(tok, T - 1) * row_bytes);
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

template <typename V>
int launch(const void* x, const void* idx, void* out, int T, int S,
           int row_bytes, cudaStream_t stream) {
  moe_gather_kernel<V><<<(S + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      static_cast<const char*>(x), static_cast<const int32_t*>(idx),
      static_cast<char*>(out), T, S, row_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (T, row_bytes bytes), idx (S,) int32 -> out (S, row_bytes bytes); vec in
// {16, 8, 4, 2, 1} divides row_bytes and both pointers. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// vec).
int moe_gather(const void* x, const void* idx, void* out, int T, int S,
               int row_bytes, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch<uint4>(x, idx, out, T, S, row_bytes, st);
    case 8: return launch<uint2>(x, idx, out, T, S, row_bytes, st);
    case 4: return launch<uint32_t>(x, idx, out, T, S, row_bytes, st);
    case 2: return launch<uint16_t>(x, idx, out, T, S, row_bytes, st);
    case 1: return launch<uint8_t>(x, idx, out, T, S, row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
