// One time step's event accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/event_accum.py::event_accum
// (body `_kernel`), with a leading row axis N (the samples of a batch): for
// every row n, every live slot of the packed AE queues words (N, C_in, K*K,
// D) adds its K x K SAME-conv fan-out w[dy, dx, c, :] into the membrane
// v_mem (N, H, W, C_out). Slot d of queue (c, ph) is live when its window
// row i_c = (word >> bits) & mask is below n_win AND d < counts[n, c, ph],
// as in the TPU kernel: the uncompressed AE format's invalid word decodes to
// i_c = 0, so only the count kills it there. The result goes to a new
// membrane; the input one is read once.
//
// The membrane and weights are fp32, or both bf16 as the TPU kernel takes
// them: then every add is rounded to bf16, as the Pallas kernel's `cur + w`
// in bf16 is, in the same (c, phase) order. The add runs in fp32 and
// __float2bfloat16_rn rounds it once: fp32's 24 bits are more than
// 2 * 8 + 2, so that double rounding gives the correctly rounded bf16 sum.
//
// What bounds it on an H100: the membrane read and write and the queue
// words are the device-memory traffic, (2*N*H*W*C_out*sizeof(T) +
// N*C_in*K*K*D*4) B / 3.35 TB/s; the work is one shared-memory
// read-modify-write per (live event, in-bounds offset, output channel),
// the engine's `add_ops`.
//
// Design (a scatter over a membrane tile in shared memory):
// - One block per (n, 32-wide C_out tile); lane l of every warp owns output
//   channel tile*32 + l. The block's (H, W, 32) membrane tile lives in
//   shared memory for the whole step: 32*32*32*4 B = 128 KiB in fp32 at the
//   largest CIFAR-10 stage (64 KiB in bf16), hence the dynamic opt-in. It
//   is loaded from v_mem once and stored once.
// - The paper's phase interlacing makes the K x K footprints of all events
//   of one (c, phase) queue disjoint, so the block's warps apply a whole
//   queue at once (warp w takes slots w, w+8, ...) with plain shared-memory
//   adds and no atomics; a __syncthreads() separates queues. Every output
//   element receives its adds in one fixed (c, phase) order, independent of
//   N and of the run, so a row's result depends only on that row.
//   (The TPU kernel adds in (c, slot, phase) order, the reference
//   event_conv2d offset by offset: on Gaussian weights the three differ in
//   rounding; on dyadic weights they are equal.)
// - Each lane keeps its K x K weights of the current channel in registers;
//   an event's K x K targets are distinct, so their loads are all issued
//   before the adds and stores. Empty queues are skipped (the branch is
//   block-uniform).
// - A row's words and counts may sit at any stride from the next row's (a
//   step's slice of a (B, T, C, K*K, D) queue), so no copy is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;  // output channels per block, one per lane

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero(__nv_bfloat16) {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ float add_rn(float a, float b) { return a + b; }
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a,
                                               __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <int K, typename T>
__global__ void __launch_bounds__(kWarps * 32)
event_accum_kernel(const int32_t* __restrict__ words,
                   const int32_t* __restrict__ counts,
                   const T* __restrict__ w,
                   const T* __restrict__ v_in, T* __restrict__ v_out,
                   long long words_stride, long long counts_stride, int C_in,
                   int D, int n_win, int bits, int H, int W, int C_out) {
  constexpr int K2 = K * K;
  constexpr int pad = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vm = reinterpret_cast<T*>(smem);  // H * W * kTile
  const int HW = H * W;
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int co = blockIdx.y * kTile + lane;
  const int mask = (1 << bits) - 1;

  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) {
    const int pix = i / kTile, o = blockIdx.y * kTile + i % kTile;
    vm[i] = o < C_out ? v_in[((size_t)n * HW + pix) * C_out + o]
                      : zero(T());
  }
  __syncthreads();

  const int32_t* q_row = words + n * words_stride;
  const int32_t* c_row = counts + n * counts_stride;
  for (int c = 0; c < C_in; ++c) {
    T wreg[K2];
#pragma unroll
    for (int kk = 0; kk < K2; ++kk)
      wreg[kk] = co < C_out ? w[((size_t)kk * C_in + c) * C_out + co]
                            : zero(T());
#pragma unroll 1
    for (int ph = 0; ph < K2; ++ph) {
      const int m = min(c_row[c * K2 + ph], D);
      if (m <= 0) continue;  // block-uniform
      const int32_t* q = q_row + ((size_t)c * K2 + ph) * D;
      const int ky = ph / K, kx = ph % K;
      for (int e = warp; e < m; e += kWarps) {
        const int word = q[e];
        const int i_c = (word >> bits) & mask;
        if (i_c >= n_win) continue;  // warp-uniform: a dead slot
        const int y = i_c * K + ky;
        const int x = (word & mask) * K + kx;
        int idx[K2];
        T v[K2];
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int ty = y - dy + pad, tx = x - dx + pad;
            const bool ok = ty >= 0 && ty < H && tx >= 0 && tx < W;
            idx[dy * K + dx] = ok ? (ty * W + tx) * kTile + lane : -1;
          }
        }
#pragma unroll
        for (int kk = 0; kk < K2; ++kk)
          v[kk] = idx[kk] >= 0 ? vm[idx[kk]] : zero(T());
#pragma unroll
        for (int kk = 0; kk < K2; ++kk)
          if (idx[kk] >= 0) vm[idx[kk]] = add_rn(v[kk], wreg[kk]);
      }
      __syncthreads();  // footprints of different queues overlap
    }
  }
  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) {
    const int pix = i / kTile, o = blockIdx.y * kTile + i % kTile;
    if (o < C_out) v_out[((size_t)n * HW + pix) * C_out + o] = vm[i];
  }
}

template <int K, typename T>
int launch(const void* words, const void* counts, const void* w,
           const void* v_in, void* v_out, int N, long long words_stride,
           long long counts_stride, int C_in, int D, int n_win, int bits,
           int H, int W, int C_out, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)H * W * kTile;
  static size_t opted_in = 48 * 1024;  // the default dynamic limit
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        event_accum_kernel<K, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  dim3 grid(N, (C_out + kTile - 1) / kTile);
  event_accum_kernel<K, T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(counts),
      static_cast<const T*>(w), static_cast<const T*>(v_in),
      static_cast<T*>(v_out), words_stride, counts_stride, C_in, D, n_win,
      bits, H, W, C_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int K, const void* words, const void* counts, const void* w,
             const void* v_in, void* v_out, int N, long long words_stride,
             long long counts_stride, int C_in, int D, int n_win, int bits,
             int H, int W, int C_out, cudaStream_t s) {
  switch (K) {
    case 1: return launch<1, T>(words, counts, w, v_in, v_out, N, words_stride, counts_stride, C_in, D, n_win, bits, H, W, C_out, s);
    case 3: return launch<3, T>(words, counts, w, v_in, v_out, N, words_stride, counts_stride, C_in, D, n_win, bits, H, W, C_out, s);
    case 5: return launch<5, T>(words, counts, w, v_in, v_out, N, words_stride, counts_stride, C_in, D, n_win, bits, H, W, C_out, s);
    case 7: return launch<7, T>(words, counts, w, v_in, v_out, N, words_stride, counts_stride, C_in, D, n_win, bits, H, W, C_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// words (N, C_in, K*K, D) int32 with row stride words_stride, counts (N,
// C_in, K*K) int32 with row stride counts_stride, w (K, K, C_in, C_out),
// v_in and v_out (N, H, W, C_out), all fp32, or all bf16 with bf16 != 0; K
// in {1, 3, 5, 7}. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another K).
int event_accum(const void* words, const void* counts, const void* w,
                const void* v_in, void* v_out, int N, int words_stride,
                int counts_stride, int C_in, int K, int D, int n_win,
                int bits, int H, int W, int C_out, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 != 0)
    return launch_k<__nv_bfloat16>(K, words, counts, w, v_in, v_out, N,
                                   words_stride, counts_stride, C_in, D,
                                   n_win, bits, H, W, C_out, s);
  return launch_k<float>(K, words, counts, w, v_in, v_out, N, words_stride,
                         counts_stride, C_in, D, n_win, bits, H, W, C_out, s);
}

}  // extern "C"
