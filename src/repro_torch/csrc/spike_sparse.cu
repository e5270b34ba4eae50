// Occupancy-gated sparse spike compaction + accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spike_sparse.py::
// fused_spike_accum_sparse_pallas (body `_sparse_kernel`). It computes what
// the fused pipeline (spike_pipeline.cu) computes — per row n (= sample *
// step) and input channel c, the occupancy (N, C_in, K*K, P) is compacted
// into AE queue words, events past `depth` per (c, phase) queue are dropped
// in window-row-major order, and each surviving event adds its K x K
// SAME-conv fan-out w[dy, dx, c, :] into the (H, W, C_out) charge map — with
// the work gated by occupancy, and optionally an int-quantized accumulate:
//
// - a gate pass reads the occupancy once and writes, per (n, c) cell, its
//   event total and fill bound (1 + its last active position), and per row
//   whether it holds any event;
// - a one-block pass orders the rows active-first (a stable prefix sum, as
//   the reference's ragged dispatch does), so the accumulate grid covers
//   only the first `n_rows` rows; the wrapper zero-fills the output, and
//   rows that are never launched stay exact zeros;
// - the accumulate pass skips every cell whose total is 0 with a
//   block-uniform branch, before any barrier, and fills a cell's queues
//   only over positions [0, fill bound). This is the occupancy gate: the
//   work drops with the spike rate.
// - quant != 0: the weights arrive as symmetric-quantized int8, the charge
//   map accumulates their integer values exactly in int32 (the largest
//   fan-in, 9 * 128 * 127, is far inside int32), and one fp32 multiply by
//   the scale dequantizes at the end: bit-exact in any order.
//
// What bounds it on an H100: the occupancy read and the charge write are the
// only device-memory traffic of size (the words never leave the SM), so the
// floor is bytes / 3.35 TB/s, or the adds, one per (surviving event,
// in-bounds offset, output channel), at the fp32 or int32 rate.
//
// Design of the accumulate pass (that of spike_pipeline.cu, gated):
// - One block per (active row, 32-wide C_out tile); lane l of every warp
//   owns output channel tile*32 + l. The block's (H, W, 32) charge map
//   stays in shared memory (128 KiB at 32x32, hence the dynamic opt-in) while
//   it walks c_in, and is written to device memory once at the end.
// - Compaction: one warp per phase queue, a ballot + popcount prefix sum
//   over 32 positions at a time gives each event its queue slot.
// - Accumulation: events of one (c, phase) queue have disjoint K x K
//   footprints, so the block applies a whole queue at once with plain
//   shared-memory adds and no atomics; a barrier separates queues. Every
//   output element therefore receives its additions in one fixed (c, phase)
//   order, spike_pipeline.cu's: the fp32 result equals B1's bit for bit,
//   and a row's result does not depend on the other rows of the batch. The
//   scatter oracle adds offset by offset (all events' (dy, dx) = (0, 0)
//   first), another order, so fp32 agrees with it and with the plain
//   version to rounding only; the int path is exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;       // output channels per block, one per lane
constexpr int kRowThreads = 1024;

// One block per row; warp w takes cells c = w, w + 8, ...
__global__ void __launch_bounds__(kWarps * 32)
sparse_gate_kernel(const int32_t* __restrict__ occ,
                   int32_t* __restrict__ cell_tot,
                   int32_t* __restrict__ cell_pmax,
                   int32_t* __restrict__ row_act, int C_in, int K2, int P) {
  __shared__ int active;
  const int n = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) active = 0;
  __syncthreads();
  const int cell = K2 * P;
  for (int c = warp; c < C_in; c += kWarps) {
    const int32_t* src = occ + ((size_t)n * C_in + c) * cell;
    int tot = 0, pmax = 0;
    for (int i = lane; i < cell; i += 32) {
      if (src[i] > 0) {
        ++tot;
        pmax = max(pmax, i % P + 1);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    }
    if (lane == 0) {
      cell_tot[(size_t)n * C_in + c] = tot;
      cell_pmax[(size_t)n * C_in + c] = pmax;
      if (tot > 0) active = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) row_act[n] = active;
}

// One block: order[0, n_act) = active rows ascending, then the others.
__global__ void __launch_bounds__(kRowThreads)
sparse_rows_kernel(const int32_t* __restrict__ row_act,
                   int32_t* __restrict__ order, int N) {
  __shared__ int warp_count[kRowThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n_act = 0;
  for (int r0 = 0; r0 < N; r0 += kRowThreads) {
    const int r = r0 + tid;
    n_act += __syncthreads_count(r < N && row_act[r] != 0);
  }
  int before = 0;  // active rows in earlier chunks (block-uniform)
  for (int r0 = 0; r0 < N; r0 += kRowThreads) {
    const int r = r0 + tid;
    const bool act = r < N && row_act[r] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int rank = before + __popc(ballot & ((1u << lane) - 1u));
    int chunk = 0;
    for (int w = 0; w < kRowThreads / 32; ++w) {
      if (w < warp) rank += warp_count[w];
      chunk += warp_count[w];
    }
    if (r < N) order[act ? rank : n_act + (r - rank)] = r;
    before += chunk;
    __syncthreads();  // warp_count is rewritten by the next chunk
  }
}

template <int K, typename Wt, typename Acc>
__global__ void __launch_bounds__(kWarps * 32)
sparse_accum_kernel(const int32_t* __restrict__ occ,
                    const Wt* __restrict__ w,
                    const float* __restrict__ w_scale,
                    const int32_t* __restrict__ cell_tot,
                    const int32_t* __restrict__ cell_pmax,
                    const int32_t* __restrict__ order,
                    float* __restrict__ out,
                    int C_in, int n_win, int bits, int depth,
                    int H, int W, int C_out) {
  constexpr int K2 = K * K;
  constexpr int pad = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = n_win * n_win;
  const int cap = min(depth, P);
  const int HW = H * W;
  Acc* charge = reinterpret_cast<Acc*>(smem);                 // HW * kTile
  int32_t* words = reinterpret_cast<int32_t*>(charge + HW * kTile);  // K2*cap
  int32_t* counts = words + K2 * cap;                          // K2

  const int n = order[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int co = blockIdx.y * kTile + lane;
  const int mask = (1 << bits) - 1;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) charge[i] = Acc(0);

  for (int c = 0; c < C_in; ++c) {
    // the occupancy gate: a block-uniform skip of an empty cell, before
    // any barrier
    if (cell_tot[(size_t)n * C_in + c] == 0) continue;
    const int pmax = cell_pmax[(size_t)n * C_in + c];
    // this lane's K x K weights of input channel c, kept in registers
    Acc wreg[K2];
#pragma unroll
    for (int kk = 0; kk < K2; ++kk)
      wreg[kk] = co < C_out ? Acc(w[((size_t)kk * C_in + c) * C_out + co])
                            : Acc(0);
    __syncthreads();  // the previous cell's readers of words/counts
    for (int ph = warp; ph < K2; ph += kWarps) {
      const int32_t* row = occ + (((size_t)n * C_in + c) * K2 + ph) * P;
      int count = 0;  // warp-uniform queue write pointer
      for (int p0 = 0; p0 < pmax && count < depth; p0 += 32) {
        const int p = p0 + lane;
        const bool fired = p < pmax && row[p] > 0;
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
        Acc v[K2];
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
          v[kk] = idx[kk] >= 0 ? charge[idx[kk]] : Acc(0);
#pragma unroll
        for (int kk = 0; kk < K2; ++kk)
          if (idx[kk] >= 0) charge[idx[kk]] = v[kk] + wreg[kk];
      }
      __syncthreads();  // footprints of different phases overlap
    }
  }
  __syncthreads();
  float scale = 1.f;
  if constexpr (std::is_same<Acc, int32_t>::value) scale = w_scale[0];
  for (int i = threadIdx.x; i < HW * kTile; i += blockDim.x) {
    const int pix = i / kTile, o = blockIdx.y * kTile + i % kTile;
    if (o >= C_out) continue;
    float val;
    if constexpr (std::is_same<Acc, int32_t>::value)
      val = __fmul_rn(__int2float_rn(charge[i]), scale);
    else
      val = charge[i];
    out[((size_t)n * HW + pix) * C_out + o] = val;
  }
}

template <int K, typename Wt, typename Acc>
int launch_accum(const void* occ, const void* w, const void* w_scale,
                 const int32_t* cell_tot, const int32_t* cell_pmax,
                 const int32_t* order, void* out, int n_rows, int C_in,
                 int n_win, int bits, int depth, int H, int W, int C_out,
                 size_t smem, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;  // the default dynamic limit
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_accum_kernel<K, Wt, Acc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  dim3 grid(n_rows, (C_out + kTile - 1) / kTile);
  sparse_accum_kernel<K, Wt, Acc><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(occ), static_cast<const Wt*>(w),
      static_cast<const float*>(w_scale), cell_tot, cell_pmax, order,
      static_cast<float*>(out), C_in, n_win, bits, depth, H, W, C_out);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(bool quant, const void* occ, const void* w, const void* w_scale,
             const int32_t* cell_tot, const int32_t* cell_pmax,
             const int32_t* order, void* out, int n_rows, int C_in,
             int n_win, int bits, int depth, int H, int W, int C_out,
             size_t smem, cudaStream_t s) {
  if (quant)
    return launch_accum<K, int8_t, int32_t>(occ, w, w_scale, cell_tot,
                                            cell_pmax, order, out, n_rows,
                                            C_in, n_win, bits, depth, H, W,
                                            C_out, smem, s);
  return launch_accum<K, float, float>(occ, w, w_scale, cell_tot, cell_pmax,
                                       order, out, n_rows, C_in, n_win, bits,
                                       depth, H, W, C_out, smem, s);
}

}  // namespace

extern "C" {

// occ (N, C_in, K*K, n_win*n_win) int32; w (K, K, C_in, C_out) fp32, or
// int8 with quant != 0 and then w_scale a 0-d fp32 on the device (else
// unused); scratch 2*N*C_in + 2*N int32; out (N, H, W, C_out) fp32, zeros
// in every row past the first n_rows active-first rows (the caller
// zero-fills it when n_rows < N). K in {1, 3, 5, 7}. Returns the first
// non-zero cudaGetLastError() of its launches (cudaErrorInvalidValue for
// another K).
int fused_spike_accum_sparse(const void* occ, const void* w,
                             const void* w_scale, void* scratch, void* out,
                             int N, int n_rows, int C_in, int K, int n_win,
                             int bits, int depth, int H, int W, int C_out,
                             int quant, void* stream) {
  if (K != 1 && K != 3 && K != 5 && K != 7) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K2 = K * K, P = n_win * n_win;
  int32_t* cell_tot = static_cast<int32_t*>(scratch);
  int32_t* cell_pmax = cell_tot + (size_t)N * C_in;
  int32_t* row_act = cell_pmax + (size_t)N * C_in;
  int32_t* order = row_act + N;

  sparse_gate_kernel<<<N, kWarps * 32, 0, s>>>(
      static_cast<const int32_t*>(occ), cell_tot, cell_pmax, row_act, C_in,
      K2, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparse_rows_kernel<<<1, kRowThreads, 0, s>>>(row_act, order, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_rows == 0) return 0;

  const int cap = depth < P ? depth : P;
  const size_t smem = sizeof(float) * (size_t)H * W * kTile
                    + sizeof(int32_t) * ((size_t)K2 * cap + K2);
  const bool q = quant != 0;
  switch (K) {
    case 1: return launch_k<1>(q, occ, w, w_scale, cell_tot, cell_pmax, order, out, n_rows, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    case 3: return launch_k<3>(q, occ, w, w_scale, cell_tot, cell_pmax, order, out, n_rows, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    case 5: return launch_k<5>(q, occ, w, w_scale, cell_tot, cell_pmax, order, out, n_rows, C_in, n_win, bits, depth, H, W, C_out, smem, s);
    default: return launch_k<7>(q, occ, w, w_scale, cell_tot, cell_pmax, order, out, n_rows, C_in, n_win, bits, depth, H, W, C_out, smem, s);
  }
}

}  // extern "C"
