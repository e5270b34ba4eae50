// One time step's event accumulation for Hopper (sm_90a): B4.
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
// The membrane is fp32, or bf16 as the TPU kernel takes it (the wrapper
// widens bf16 weights to fp32, which is exact): then every add is rounded
// to bf16, as the Pallas kernel's `cur + w` in bf16 is, in the same (c,
// phase) order.
//
// What bounds it on an H100: the membrane read and write and the live queue
// words are the device-memory traffic, (2*N*H*W*C_out*sizeof(T) + live*4 +
// N*C_in*K*K*4) B / 3.35 TB/s; the work is one add per (live event,
// in-bounds offset, output channel), the engine's `add_ops`.
//
// Design: two launches, decode then gather.
// - Decode (event_accum_decode_kernel): one warp per (n, c) cell reads the
//   counts of the cell's K*K queues and only their live words, and sets bit
//   p = i_c * n_win + j_c of the queue's packed bits (atomicOr in the
//   warp's shared scratch), then writes every word of the cell: bits (N,
//   C_in, K*K, NW) uint32, NW = ceil(n_win^2 / 32), the kept-bit format of
//   B1's encode pass. A live word with j_c >= n_win names no position of
//   the grid and is skipped, as the reference's scatter drops it. A cell
//   whose bits number fewer than its live in-grid words repeats a position
//   in some queue: it then also counts every position's live words into
//   mult (N, C_in, K*K, n_win^2) int32 (zeroed and counted by the warp
//   itself), and its flags entry (N, C_in) is 1; every cell writes its
//   flag, so nothing needs a memset, and cells without repeats (all that
//   compact_spikes and B5 write) touch no multiplicity.
// - Gather (event_accum_gather_kernel): the barrier-free gather of
//   spike_accum.cuh, each output's sum starting from v_in and every add
//   rounded to the membrane's type. Phase interlacing gives each output at
//   most one position per (c, phase) queue, and the gather adds c
//   ascending, then phase ascending, a flagged channel's position as many
//   times as live words name it, back to back: the order of the scatter
//   form, so the fp32 and bf16 results are that form's bit for bit, and a
//   row's result depends only on that row. It holds no membrane map, so
//   any map size whose staged bits fit a block runs. Grids whose 8-cell
//   blocks would not cover the SMs once (the 3x3 stages: 64 window cells
//   a step) take 2 cells a block instead, four times the blocks, and K
//   warps a cell, one pixel row each.
// - A row's words and counts may sit at any stride from the next row's (a
//   step's slice of a (B, T, C, K*K, D) queue), so no copy is needed.
#include <algorithm>

#include "spike_accum.cuh"

namespace {

using spike_accum::kTile;
using spike_accum::kWarps;
constexpr int kFewCells = 2;  // window cells a block for small grids

// KC = K for the unrolled K in {1, 3, 5, 7}; 0 for any other K, whose K*K
// comes in K2rt. blockDim.x / 32 warps a block (fewer than kWarps where
// their scratch would pass 48 KiB), each with K2 * NW words of scratch.
template <int KC>
__global__ void __launch_bounds__(kWarps * 32)
event_accum_decode_kernel(const int32_t* __restrict__ words,
                          const int32_t* __restrict__ counts,
                          uint32_t* __restrict__ bits,
                          int32_t* __restrict__ mult,
                          int32_t* __restrict__ flags, long long words_stride,
                          long long counts_stride, int n_cells, int C_in,
                          int D, int n_win, int nbits, int K2rt) {
  const int K2 = KC > 0 ? KC * KC : K2rt;
  extern __shared__ uint32_t scratch[];  // [warps][K2 * NW]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cell >= n_cells) return;  // warp-uniform
  const int n = cell / C_in, c = cell - n * C_in;
  const int NW = (n_win * n_win + 31) >> 5, QW = K2 * NW;
  const int mask = (1 << nbits) - 1;
  const int32_t* q = words + n * words_stride + (size_t)c * K2 * D;
  const int32_t* cnt = counts + n * counts_stride + (size_t)c * K2;
  uint32_t* s = scratch + (size_t)warp * QW;
  for (int i = lane; i < QW; i += 32) s[i] = 0u;
  __syncwarp();
  int named = 0;  // this lane's live words that name a grid position
  // 32 queues at a time: lane l holds the live slots of queue q0 + l
#pragma unroll
  for (int q0 = 0; q0 < K2; q0 += 32) {
    const int m_l = q0 + lane < K2 ? min(cnt[q0 + lane], D) : 0;
    const int qn = min(32, K2 - q0);
#pragma unroll
    for (int j = 0; j < qn; ++j) {
      const int ph = q0 + j;
      const int m = __shfl_sync(0xffffffffu, m_l, j);
      for (int d = lane; d < m; d += 32) {
        const int word = q[ph * D + d];
        const int i_c = (word >> nbits) & mask, j_c = word & mask;
        if (i_c < n_win && j_c < n_win) {
          const int p = i_c * n_win + j_c;
          atomicOr(&s[ph * NW + (p >> 5)], 1u << (p & 31));
          ++named;
        }
      }
    }
  }
  __syncwarp();
  uint32_t* dst = bits + (size_t)cell * QW;
  int set = 0;  // bits set: fewer than the words that name positions
  for (int i = lane; i < QW; i += 32) {  // <=> some position repeats
    dst[i] = s[i];
    set += __popc(s[i]);
  }
  const bool repeat = __reduce_add_sync(0xffffffffu, set)
                      < __reduce_add_sync(0xffffffffu, named);
  if (lane == 0) flags[cell] = repeat ? 1 : 0;
  if (!repeat) return;  // warp-uniform
  // a repeat: count every live word of the cell by position
  const int P = n_win * n_win;
  int32_t* mc = mult + (size_t)cell * K2 * P;
  for (int i = lane; i < K2 * P; i += 32) mc[i] = 0;
  __syncwarp();  // orders the zeros before the warp's atomics
  for (int q0 = 0; q0 < K2; q0 += 32) {
    const int m_l = q0 + lane < K2 ? min(cnt[q0 + lane], D) : 0;
    const int qn = min(32, K2 - q0);
    for (int j = 0; j < qn; ++j) {
      const int ph = q0 + j;
      const int m = __shfl_sync(0xffffffffu, m_l, j);
      for (int d = lane; d < m; d += 32) {
        const int word = q[ph * D + d];
        const int i_c = (word >> nbits) & mask, j_c = word & mask;
        if (i_c < n_win && j_c < n_win)
          atomicAdd(&mc[ph * P + i_c * n_win + j_c], 1);
      }
    }
  }
}

// the 8-cell gather's threads an SM must hold, as B1's gather
template <int K, int Cells, bool Split>
constexpr int min_blocks() {
  constexpr int t = spike_accum::gather_warps<K, Cells, Split>() * 32;
  constexpr int n = kWarps * 32 * spike_accum::min_blocks<K>() / t;
  return n > 0 ? n : 1;
}

template <int K, typename T, int Cells, bool Split>
__global__ void
__launch_bounds__(spike_accum::gather_warps<K, Cells, Split>() * 32,
                  min_blocks<K, Cells, Split>())
event_accum_gather_kernel(const uint32_t* __restrict__ bits,
                          const int32_t* __restrict__ mult,
                          const int32_t* __restrict__ flags,
                          const float* __restrict__ w,
                          const T* __restrict__ v_in, T* __restrict__ v_out,
                          int n_tasks, int C_in, int n_win, int H, int W,
                          int C_out) {
  spike_accum::gather<K, false, true, T, Cells, Split, true>(
      bits, w, nullptr, nullptr, nullptr, v_out, n_tasks, C_in, n_win, H, W,
      C_out, v_in, mult, flags);
}

// any other odd K: the rolled gather, one warp per output pixel
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
event_accum_gather_kernel_rt(const uint32_t* __restrict__ bits,
                             const int32_t* __restrict__ mult,
                             const int32_t* __restrict__ flags,
                             const float* __restrict__ w,
                             const T* __restrict__ v_in,
                             T* __restrict__ v_out, long long n_pix,
                             int C_in, int K, int n_win, int H, int W,
                             int C_out) {
  spike_accum::gather_rt<false, true, T, true>(
      bits, w, nullptr, nullptr, nullptr, v_out, n_pix, C_in, K, n_win, H, W,
      C_out, v_in, mult, flags);
}

int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int K, typename T, int Cells, bool Split>
int gather(const uint32_t* bits, const int32_t* mult, const int32_t* flags,
           const float* w, const T* v_in, T* v_out, long long n_tasks,
           int C_in, int n_win, int H, int W, int C_out,
           cudaStream_t stream) {
  const size_t smem = spike_accum::gather_smem<K, Cells>(n_win, H, W);
  if (smem > (size_t)spike_accum::kSmemMax) return (int)cudaErrorInvalidValue;
  const int err = spike_accum::opt_in_smem<
      event_accum_gather_kernel<K, T, Cells, Split>>();
  if (err != 0) return err;
  dim3 grid((unsigned)((n_tasks + Cells - 1) / Cells),
            (C_out + kTile - 1) / kTile);
  event_accum_gather_kernel<K, T, Cells, Split>
      <<<grid, spike_accum::gather_warps<K, Cells, Split>() * 32, smem,
         stream>>>(bits, mult, flags, w, v_in, v_out, (int)n_tasks, C_in,
                   n_win, H, W, C_out);
  return (int)cudaGetLastError();
}

// bytes of one (n, c) cell's decoded bits
inline size_t decode_cell_bytes(int K, int n_win) {
  return sizeof(uint32_t) * K * K * (((size_t)n_win * n_win + 31) / 32);
}

// cells (warps) a decode block holds: as many as keep it within 48 KiB
inline int decode_warps(size_t cell_bytes) {
  return (int)std::max<size_t>(1,
                               std::min<size_t>(kWarps, 49152 / cell_bytes));
}

// whether the gather takes kFewCells-cell blocks: 8-cell ones would not
// give every SM a block
inline bool few_cells(long long n_tasks, int C_out) {
  const long long blocks =
      (n_tasks + kWarps - 1) / kWarps * ((C_out + kTile - 1) / kTile);
  return blocks < sm_count();
}

// The decode of K (KC = K, or 0 for a K without its own kernel): a warp per
// (n, c) cell, as many warps a block as keep the scratch within 48 KiB,
// one warp (opted in past 48 KiB) where one cell's words need more.
template <int KC>
int decode(int K, const void* words, const void* counts, uint32_t* bits,
           int32_t* mult, int32_t* flags, int N, long long words_stride,
           long long counts_stride, int C_in, int D, int n_win, int nbits,
           cudaStream_t stream) {
  const int n_cells = N * C_in;
  const size_t cell_bytes = decode_cell_bytes(K, n_win);
  if (cell_bytes > (size_t)spike_accum::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int warps = decode_warps(cell_bytes);
  if (warps * cell_bytes > 49152) {
    const int err = spike_accum::opt_in_smem<event_accum_decode_kernel<KC>>();
    if (err != 0) return err;
  }
  event_accum_decode_kernel<KC>
      <<<(n_cells + warps - 1) / warps, warps * 32, warps * cell_bytes,
         stream>>>(static_cast<const int32_t*>(words),
                   static_cast<const int32_t*>(counts), bits, mult, flags,
                   words_stride, counts_stride, n_cells, C_in, D, n_win,
                   nbits, K * K);
  return (int)cudaGetLastError();
}

template <int K, typename T>
int launch(const void* words, const void* counts, const void* w,
           const void* v_in, void* v_out, void* bits, void* mult,
           void* flags, int N, long long words_stride,
           long long counts_stride, int C_in, int D, int n_win, int nbits,
           int H, int W, int C_out, cudaStream_t stream) {
  uint32_t* b = static_cast<uint32_t*>(bits);
  int32_t* mu = static_cast<int32_t*>(mult);
  int32_t* fl = static_cast<int32_t*>(flags);
  int err = decode<K>(K, words, counts, b, mu, fl, N, words_stride,
                      counts_stride, C_in, D, n_win, nbits, stream);
  if (err != 0) return err;
  const long long n_tasks =
      (long long)N * ((H + K - 1) / K) * ((W + K - 1) / K);
  const float* wf = static_cast<const float*>(w);
  const T* vi = static_cast<const T*>(v_in);
  T* vo = static_cast<T*>(v_out);
  if (few_cells(n_tasks, C_out))
    return gather<K, T, kFewCells, true>(b, mu, fl, wf, vi, vo, n_tasks,
                                         C_in, n_win, H, W, C_out, stream);
  return gather<K, T, kWarps, false>(b, mu, fl, wf, vi, vo, n_tasks, C_in,
                                     n_win, H, W, C_out, stream);
}

template <typename T>
int launch_rt(int K, const void* words, const void* counts, const void* w,
              const void* v_in, void* v_out, void* bits, void* mult,
              void* flags, int N, long long words_stride,
              long long counts_stride, int C_in, int D, int n_win, int nbits,
              int H, int W, int C_out, cudaStream_t stream) {
  uint32_t* b = static_cast<uint32_t*>(bits);
  int32_t* mu = static_cast<int32_t*>(mult);
  int32_t* fl = static_cast<int32_t*>(flags);
  int err = decode<0>(K, words, counts, b, mu, fl, N, words_stride,
                      counts_stride, C_in, D, n_win, nbits, stream);
  if (err != 0) return err;
  const long long n_pix = (long long)N * H * W;
  dim3 grid((unsigned)((n_pix + kWarps - 1) / kWarps),
            (C_out + kTile - 1) / kTile);
  event_accum_gather_kernel_rt<T><<<grid, kWarps * 32, 0, stream>>>(
      b, mu, fl, static_cast<const float*>(w), static_cast<const T*>(v_in),
      static_cast<T*>(v_out), n_pix, C_in, K, n_win, H, W, C_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int K, const void* words, const void* counts, const void* w,
             const void* v_in, void* v_out, void* bits, void* mult,
             void* flags, int N, long long words_stride,
             long long counts_stride, int C_in, int D, int n_win, int nbits,
             int H, int W, int C_out, cudaStream_t s) {
  switch (K) {
    case 1: return launch<1, T>(words, counts, w, v_in, v_out, bits, mult, flags, N, words_stride, counts_stride, C_in, D, n_win, nbits, H, W, C_out, s);
    case 3: return launch<3, T>(words, counts, w, v_in, v_out, bits, mult, flags, N, words_stride, counts_stride, C_in, D, n_win, nbits, H, W, C_out, s);
    case 5: return launch<5, T>(words, counts, w, v_in, v_out, bits, mult, flags, N, words_stride, counts_stride, C_in, D, n_win, nbits, H, W, C_out, s);
    case 7: return launch<7, T>(words, counts, w, v_in, v_out, bits, mult, flags, N, words_stride, counts_stride, C_in, D, n_win, nbits, H, W, C_out, s);
    default:
      if (K < 1 || K % 2 == 0) return (int)cudaErrorInvalidValue;
      return launch_rt<T>(K, words, counts, w, v_in, v_out, bits, mult, flags, N, words_stride, counts_stride, C_in, D, n_win, nbits, H, W, C_out, s);
  }
}

}  // namespace

extern "C" {

// words (N, C_in, K*K, D) int32 with row stride words_stride, counts (N,
// C_in, K*K) int32 with row stride counts_stride, w (K, K, C_in, C_out)
// fp32, v_in and v_out (N, H, W, C_out), fp32, or bf16 with bf16 != 0;
// bits (N, C_in, K*K, ceil(n_win^2 / 32)) uint32 and flags (N, C_in)
// int32 scratch, every word written by the decode; mult (N, C_in, K*K,
// n_win^2) int32 scratch, written only for flagged cells; N, C_in, C_out
// >= 1; K odd (1, 3, 5, 7 unrolled, any other rolled). Returns the first
// non-zero cudaGetLastError() of its two launches (cudaErrorInvalidValue
// for an even K, or for a map whose staged bits, or one cell's decoded
// words, do not fit a block's shared memory).
int event_accum(const void* words, const void* counts, const void* w,
                const void* v_in, void* v_out, void* bits, void* mult,
                void* flags, int N, int words_stride, int counts_stride,
                int C_in, int K, int D, int n_win, int nbits, int H, int W,
                int C_out, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 != 0)
    return launch_k<__nv_bfloat16>(K, words, counts, w, v_in, v_out, bits,
                                   mult, flags, N, words_stride,
                                   counts_stride, C_in, D, n_win, nbits, H,
                                   W, C_out, s);
  return launch_k<float>(K, words, counts, w, v_in, v_out, bits, mult, flags,
                         N, words_stride, counts_stride, C_in, D, n_win,
                         nbits, H, W, C_out, s);
}

// The dynamic shared memory event_accum requests per block of its decode
// and of its gather at this geometry, on the current card (the gather's
// cells depend on its SM count): kernels/event_accum.py's smem_blocks adds
// up the same numbers. Returns cudaErrorInvalidValue for an even K.
int event_accum_smem(int N, int K, int n_win, int H, int W, int C_out,
                     long long* decode_bytes, long long* gather_bytes) {
  if (K < 1 || K % 2 == 0) return (int)cudaErrorInvalidValue;
  const size_t cell_bytes = decode_cell_bytes(K, n_win);
  *decode_bytes = (long long)(decode_warps(cell_bytes) * cell_bytes);
  const long long n_tasks =
      (long long)N * ((H + K - 1) / K) * ((W + K - 1) / K);
  *gather_bytes = few_cells(n_tasks, C_out)
                      ? spike_accum::gather_smem_k<kFewCells>(K, n_win, H, W)
                      : spike_accum::gather_smem_k<kWarps>(K, n_win, H, W);
  return 0;
}

}  // extern "C"
