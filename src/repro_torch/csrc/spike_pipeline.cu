// Fused spike compaction + event accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spike_pipeline.py::
// fused_spike_accum_pallas (body `_kernel`). For every row n (= sample*step)
// and input channel c, the per-phase occupancy (N, C_in, K*K, P) is compacted
// into AE queue words, events past `depth` per (c, phase) queue are dropped
// in window-row-major order (exactly repro.core.aeq.segment_keep), and each
// surviving event adds its K x K SAME-conv fan-out w[dy, dx, c, :] into the
// (H, W, C_out) charge map.
//
// What bounds it on an H100: the occupancy read and the charge write are the
// only device-memory traffic (the words never leave the SM), so the floor is
// bytes / 3.35 TB/s; the work itself is shared-memory read-modify-writes,
// one per (surviving event, in-bounds offset, output channel), i.e. the
// engine's `add_ops` count.
//
// Design:
// - One block per (n, 32-wide C_out tile); lane l of every warp owns output
//   channel tile*32 + l. The block's (H, W, 32) fp32 charge map stays in
//   shared memory while it walks c_in (32*32*32*4 B = 128 KiB at the largest
//   CIFAR-10 stage, hence the dynamic shared-memory opt-in; one such block
//   fits an SM), and is written to device memory once at the end.
// - Compaction: one warp per phase queue, a ballot + popcount prefix sum over
//   32 positions at a time gives each event its queue slot; events whose slot
//   is >= depth are dropped, and the scan stops once the queue is full. The
//   packed words (wy << bits | wx) live in shared memory only.
// - Accumulation: the paper's phase interlacing makes the K x K footprints
//   of all events in one (c, phase) queue disjoint, so the block's warps apply
//   a whole queue at once — warp w takes events w, w+8, ... — with plain
//   shared-memory adds and no atomics. A __syncthreads() separates queues.
//   Every output element therefore receives its additions in one fixed order
//   (c-major, phase-minor): a row's result depends only on that row's inputs
//   and is the same on every run (the serving mask contract rests on this).
//   Each lane keeps its K x K weights of the current channel in registers,
//   and the K x K targets of one event are distinct, so their shared-memory
//   loads are all issued before the adds and stores.
// - Empty queues are skipped (the branch is block-uniform), so the work is
//   proportional to the surviving events, not to the dense map.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;  // output channels per block, one per lane

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
fused_spike_accum_kernel(const int32_t* __restrict__ occ,
                         const float* __restrict__ w,
                         float* __restrict__ out,
                         int C_in, int n_win, int bits, int depth,
                         int H, int W, int C_out) {
  constexpr int K2 = K * K;
  constexpr int pad = K / 2;
  extern __shared__ float smem[];
  const int P = n_win * n_win;
  const int cap = min(depth, P);
  const int HW = H * W;
  float* charge = smem;                                  // HW * kTile
  int32_t* words = reinterpret_cast<int32_t*>(charge + HW * kTile);  // K2*cap
  int32_t* counts = words + K2 * cap;                    // K2

  const int n = blockIdx.x;
  const int co = blockIdx.y * kTile + (threadIdx.x & 31);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mask = (1 << bits) - 1;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) charge[i] = 0.f;

  for (int c = 0; c < C_in; ++c) {
    // this lane's K x K weights of input channel c, kept in registers
    float wreg[K2];
#pragma unroll
    for (int kk = 0; kk < K2; ++kk)
      wreg[kk] = co < C_out ? w[((size_t)kk * C_in + c) * C_out + co] : 0.f;
    __syncthreads();  // the previous channel's readers of words/counts
    for (int ph = warp; ph < K2; ph += kWarps) {
      const int32_t* row = occ + (((size_t)n * C_in + c) * K2 + ph) * P;
      int count = 0;  // warp-uniform queue write pointer
      for (int p0 = 0; p0 < P && count < depth; p0 += 32) {
        const int p = p0 + lane;
        const bool fired = p < P && row[p] > 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, fired);
        const int slot = count + __popc(ballot & lanes_below);
        if (fired && slot < depth)
          words[ph * cap + slot] = ((p / n_win) << bits) | (p % n_win);
        count += __popc(ballot);
      }
      if (lane == 0) counts[ph] = min(count, depth);
    }
    __syncthreads();
#pragma unroll 1
    for (int ph = 0; ph < K2; ++ph) {
      const int m = counts[ph];
      if (m == 0) continue;  // block-uniform
      const int ky = ph / K, kx = ph % K;
      for (int e = warp; e < m; e += kWarps) {
        const int word = words[ph * cap + e];
        const int y = ((word >> bits) & mask) * K + ky;
        const int x = (word & mask) * K + kx;
        // the K*K targets of one event are distinct: load all, then add
        // and store, so the shared-memory round trips overlap
        int idx[K2];
        float v[K2];
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
          v[kk] = idx[kk] >= 0 ? charge[idx[kk]] : 0.f;
#pragma unroll
        for (int kk = 0; kk < K2; ++kk)
          if (idx[kk] >= 0) charge[idx[kk]] = v[kk] + wreg[kk];
      }
      __syncthreads();  // footprints of different phases overlap
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) {
    const int pix = i / kTile, o = blockIdx.y * kTile + i % kTile;
    if (o < C_out) out[((size_t)n * HW + pix) * C_out + o] = charge[i];
  }
}

template <int K>
int launch(const void* occ, const void* w, void* out, int N, int C_in,
           int n_win, int bits, int depth, int H, int W, int C_out,
           size_t smem, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // the default dynamic limit
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_spike_accum_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  dim3 grid(N, (C_out + kTile - 1) / kTile);
  fused_spike_accum_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(occ), static_cast<const float*>(w),
      static_cast<float*>(out), C_in, n_win, bits, depth, H, W, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t fused_spike_accum_smem(int K, int n_win, int depth, int H, int W) {
  const int K2 = K * K, cap = depth < n_win * n_win ? depth : n_win * n_win;
  return sizeof(float) * (size_t)H * W * kTile
       + sizeof(int32_t) * ((size_t)K2 * cap + K2);
}

// occ (N, C_in, K*K, n_win*n_win) int32, w (K, K, C_in, C_out) fp32,
// out (N, H, W, C_out) fp32; K in {1, 3, 5, 7}. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another K).
int fused_spike_accum(const void* occ, const void* w, void* out, int N,
                      int C_in, int K, int n_win, int bits, int depth, int H,
                      int W, int C_out, void* stream) {
  const size_t smem = fused_spike_accum_smem(K, n_win, depth, H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch<1>(occ, w, out, N, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    case 3: return launch<3>(occ, w, out, N, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    case 5: return launch<5>(occ, w, out, N, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    case 7: return launch<7>(occ, w, out, N, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
