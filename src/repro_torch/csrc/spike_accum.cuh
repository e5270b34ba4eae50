// The accumulate shared by the fused spike kernels B1 (spike_pipeline.cu)
// and B3 (spike_sparse.cu) and the event accumulate B4 (event_accum.cu) on
// Hopper (sm_90a): a barrier-free gather that keeps the (c, phase) order of
// adds of the scatter form it replaces.
//
// Both kernels compute, for occupancy occ (N, C_in, K*K, P) int32 and HWIO
// weights w (K, K, C_in, C_out), the (N, H, W, C_out) charge of the events
// that survive a depth-`depth` queue per (n, c, phase): events past `depth`
// in window-row-major order are dropped (repro.core.aeq.segment_keep), and
// each survivor at (y, x) adds w[dy, dx, c, :] to output (y - dy + K/2,
// x - dx + K/2) for every in-bounds offset. Two passes:
//
// 1. encode (`encode`): one warp per (n, c) cell reads the cell's K*K
//    occupancy rows once, coalesced, ranks the fired positions of each
//    phase queue with a ballot + popcount prefix, and writes packed kept
//    bits: bits (N, C_in, K*K, NW) uint32, NW = ceil(P / 32), bit p % 32 of
//    word p / 32 set <=> position p fired and has rank < depth. With the
//    gate outputs it also writes each cell's kept-event total and marks
//    the rows that hold any event (B3's occupancy gate). B1's encode
//    instead adds up each sample's queue statistics (encode<true>, or
//    encode_packed where a queue fits in a word; then add_block_stats).
// 2. gather (`gather`), output-stationary. The paper's phase interlacing
//    gives, for each output pixel, input channel c and phase (ky, kx),
//    exactly one position in the pixel's K x K window with y % K == ky and
//    x % K == kx, so at most one event of queue (c, phase) reaches it. Each
//    pixel therefore loops c ascending, then phase ascending, tests that
//    one kept bit and adds one weight: the same sequence of fp32 adds,
//    starting from 0, as the scatter kernel's per-queue passes, with no
//    charge map and no barrier inside. A pixel's result depends only on
//    its row's inputs (the serving mask contract rests on this) and on no
//    launch geometry.
//
// The gather's unit of work: a warp takes one window cell (a, b) of one
// row, i.e. the K x K output pixels (K a + i, K b + j); lane l owns output
// channel tile*32 + l and keeps the K*K pixels' sums in registers. For such
// a pixel, phase (ky, kx) lands in window cell (a + ro, b + co) with ro,
// co in {-1, 0, 1} and at offset (dy, dx), all four fixed by (i, j, ky,
// kx) alone, so after full unrolling every bit position and every weight
// index is a compile-time constant. Per input channel the warp loads the
// K*K weights once (shared by the K*K pixels) and runs K^4 predicated
// adds over K*K independent sums.
//
// B4 reaches the gather from packed AE words instead of occupancy (its own
// decode pass writes the same kept bits) and with template arguments B1
// and B3 leave at their defaults: Init starts each sum from the
// membrane v_in instead of 0, Mult adds a kept position once per live word
// that names it where the decode flagged a repeat (the flag is read once a
// chunk, the multiplicities only for flagged channels), and the
// membrane's type T sets the rounding
// (bf16: every add is __float2bfloat16_rn of the fp32 sum, widened back;
// fp32's 24 bits are more than 2 * 8 + 2, so that double rounding is the
// correctly rounded bf16 sum). For grids too small to cover the SMs (B4's
// 3x3 stages: 64 window cells a step) B4 also lowers Cells, the window
// cells a block takes, and sets Split: K warps share a cell, one pixel row
// each, so each warp's chain of adds is K times shorter. No block ever
// splits C_in, which would change the order of adds.
//
// The gather walks C_in in chunks of CC channels. A chunk's weights
// (K*K, CC, 32) and the kept bits its warps read are staged in shared
// memory with cp.async, double-buffered: the next chunk loads while this
// one is added. The only barriers are between chunks. A window cell (a, b)
// reads window rows a-1..a+1 only, so per (row, channel, phase) queue a
// block stages just the words that cover its cells' window rows plus one
// row of halo on each side (a contiguous range of the row-major packing p
// = wy * n_win + wx): SW words, set by the map's width, not its area
// (staged_words). That is what lets maps of 512 x 512 and more run. Within a chunk lane l first gathers, for channel c0 + l, the 3x3
// window neighbourhood of cell (a, b) in each phase queue (9 bits a phase,
// three phases a word); the warp then walks the chunk's channels,
// broadcasting each channel's words with shuffles. The branches are
// warp-uniform. A pixel's window is the window grid [0, n_win*K), not
// [0, H): the scatter form decodes events over the whole grid.
//
// B3's int path (Scaled) adds the quantized integer weights. Where every
// partial sum is an integer of magnitude at most K*K * C_in * 127 < 2^24,
// the wrapper passes them as fp32 and each fp32 add is exact, in any order,
// so the sum equals the int32 one bit for bit, at the fp32 rate, twice the
// int32 rate of an H100 SM. Past 2^24 the wrapper passes them as int32 and
// the gather sums in int32 (IntAcc), exact in any order too. One
// __fmul_rn(__int2float_rn(sum), scale) per output element dequantizes.
//
// K in {1, 3, 5, 7} runs the unrolled gather above. Every other odd K runs
// gather_rt: one warp per output pixel, lane l its output channel, loops
// rolled, c ascending and phase ascending as above (so it too equals the
// ordered oracle bit for bit); the lanes look up 32 phases' kept bits at
// once and a ballot walks the set ones in phase order. It stages nothing:
// weights and bits come through L1, so it has no limit on K or the map.
//
// What bounds it on an H100: the occupancy read (once, in pass 1) and the
// charge write are the device-memory traffic; the work is one add per
// (kept event, in-bounds offset, output channel), the engine's `add_ops`;
// the predicated adds run K*K per (pixel, channel) whether or not the
// bit is set.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "per_device.cuh"

namespace spike_accum {
// Internal linkage: every library that includes this header keeps its own
// kernels and its own opt-in flags (a function-local static of an inline
// function would otherwise be one object across all loaded libraries).
namespace {

constexpr int kWarps = 8;         // warps per block, one window cell each
constexpr int kTile = 32;         // output channels per block, one per lane
// shared memory one Hopper block may use: one number for the Python side
// and every source, passed by kernels/_cuda.py from audit/contracts.py
#ifndef REPRO_SMEM_MAX
#error "build with -DREPRO_SMEM_MAX=<bytes> (kernels/_cuda.py passes it)"
#endif
constexpr int kSmemMax = REPRO_SMEM_MAX;

// input channels per staged chunk: the weights of two chunks must fit
template <int K>
__host__ __device__ constexpr int chunk_channels() {
  return K <= 3 ? 32 : (K == 5 ? 16 : 8);
}

// blocks per SM the registers must allow: K*K sums and weights per lane
template <int K>
__host__ __device__ constexpr int min_blocks() {
  return K <= 3 ? 2 : 1;
}

// words per (row, channel) in shared memory: K*K*NW, made odd so that the
// lanes (one channel each) read distinct banks
inline __host__ __device__ int cell_words(int K2, int NW) {
  return (K2 * NW) | 1;
}

// most rows `tasks` consecutive entries of the (row, cell) list can touch
inline __host__ __device__ int rows_spanned(int tasks, int cells) {
  return (tasks + cells - 2) / cells + 1;
}

// words a block stages per (row, channel, phase) queue: the window rows
// that Cells consecutive cells of one row can span (cells_x to a window
// row, cells_y rows), one row of halo on each side, and one word for the
// range's start inside a word; never more than the queue's NW words
inline __host__ __device__ int staged_words(int Cells, int n_win, int cells_x,
                                            int cells_y) {
  const int NW = (n_win * n_win + 31) >> 5;
  const int rows = min(rows_spanned(Cells, cells_x), cells_y) + 2;
  return min(NW, (rows * n_win + 31) / 32 + 1);
}

// the first staged word of a queue for a block whose cells in this row
// start in window row a (the row above it is the halo)
inline __host__ __device__ int first_word(int a, int n_win) {
  return (max(a - 1, 0) * n_win) >> 5;
}

// The shared memory of a gather block (kernels/spike_pipeline.py's
// gather_smem computes the same number): two buffers of one chunk's weights
// and of the staged words of the rows its cells span.
template <int K, int Cells = kWarps>
inline size_t gather_smem(int n_win, int H, int W) {
  constexpr int K2 = K * K, CC = chunk_channels<K>();
  const int cells_x = (W + K - 1) / K, cells_y = (H + K - 1) / K;
  const int SW = staged_words(Cells, n_win, cells_x, cells_y);
  return 4 * (2 * (size_t)K2 * CC * kTile
              + 2 * (size_t)rows_spanned(Cells, cells_x * cells_y) * CC
                    * cell_words(K2, SW));
}

// The dynamic shared memory launch_gather requests for a gather block of K
// over Cells window cells: 0 for the rolled gather (it stages nothing),
// -1 for an even K. kernels/spike_pipeline.py's smem_blocks adds up the
// same number; the *_smem queries of the sources return this one.
template <int Cells = kWarps>
inline long long gather_smem_k(int K, int n_win, int H, int W) {
  switch (K) {
    case 1: return (long long)gather_smem<1, Cells>(n_win, H, W);
    case 3: return (long long)gather_smem<3, Cells>(n_win, H, W);
    case 5: return (long long)gather_smem<5, Cells>(n_win, H, W);
    case 7: return (long long)gather_smem<7, Cells>(n_win, H, W);
    default: return (K < 1 || K % 2 == 0) ? -1 : 0;
  }
}

// warps of a gather block: one per window cell, or K with Split
template <int K, int Cells, bool Split>
__host__ __device__ constexpr int gather_warps() {
  return Cells * (Split ? K : 1);
}

// The gather's sums are fp32; a membrane of type T is widened on load and
// every add is rounded to T (a no-op for fp32).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float a);
template <>
__device__ __forceinline__ float narrow<float>(float a) { return a; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}
template <typename T>
__device__ __forceinline__ float add_rounded(float acc, float w) {
  return widen(narrow<T>(acc + w));
}
// one add into a sum: fp32 rounded to T, or exact int32 (IntAcc)
template <typename T>
__device__ __forceinline__ float accumulate(float acc, float w) {
  return add_rounded<T>(acc, w);
}
template <typename T>
__device__ __forceinline__ int32_t accumulate(int32_t acc, int32_t w) {
  return acc + w;
}
__device__ __forceinline__ float to_float(float a) { return a; }
__device__ __forceinline__ float to_float(int32_t a) {
  return __int2float_rn(a);
}

// For pixel i of a cell and phase k: the offset d = (k - i + pad) mod K,
// and the neighbouring cell ro in {-1, 0, 1} that holds the one position
// of phase k in the pixel's window.
template <int K>
__host__ __device__ constexpr int offset_of(int i, int k) {
  return ((k - i + K / 2) % K + K) % K;
}
template <int K>
__host__ __device__ constexpr int cell_of(int i, int k) {
  return i - K / 2 + offset_of<K>(i, k) < 0
             ? -1
             : (i - K / 2 + offset_of<K>(i, k) >= K ? 1 : 0);
}
// does any pixel of a cell reach phase k through neighbour ro?
template <int K>
__host__ __device__ constexpr bool reaches(int k, int ro) {
  bool any = false;
  for (int i = 0; i < K; ++i) any = any || cell_of<K>(i, k) == ro;
  return any;
}

// Adds one input channel's kept events to the sums acc[0, K) of pixel row
// I of a window cell, phase ascending per pixel (the order of adds): m
// holds the channel's 3x3 neighbourhood bits, wr its K*K weights.
template <int K, int I, typename T, typename A, typename WT>
__device__ __forceinline__ void add_row(A* acc, const unsigned* m,
                                        const WT* wr) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int ph = 0; ph < K * K; ++ph) {
      const int ky = ph / K, kx = ph % K;
      const int bit = (ph % 3) * 9 + (cell_of<K>(I, ky) + 1) * 3
                      + (cell_of<K>(j, kx) + 1);
      if ((m[ph / 3] >> bit) & 1u)
        acc[j] = accumulate<T>(
            acc[j], wr[offset_of<K>(I, ky) * K + offset_of<K>(j, kx)]);
    }
  }
}

// The pixel rows a warp holds: all K (acc[K*K]), or with Split row i0 only
// (acc[K]), picked by a warp-uniform branch, so that every bit position,
// weight index and sum stays a compile-time constant.
template <int K, typename T, bool Split, int I = 0, typename A,
          typename WT>
__device__ __forceinline__ void add_rows(A* acc, const unsigned* m,
                                         const WT* wr, int i0) {
  if constexpr (I < K) {
    if (!Split)
      add_row<K, I, T>(acc + I * K, m, wr);
    else if (i0 == I)
      add_row<K, I, T>(acc, m, wr);
    add_rows<K, T, Split, I + 1>(acc, m, wr, i0);
  }
}

// B4's path for a channel whose queues repeat a position: the same adds in
// the same order as add_rows, each position's weight added as many times as
// live words name it (mq: the channel's multiplicities, K*K*n_win^2, 0
// where no live word names a position), back to back. The phase loop stays
// rolled and each phase's K loads go out together, so this rare path costs
// little code and few registers (the common path's speed rests on them):
// weights come from the staged chunk (wc: the lane's output channel of the
// channel's K*K weights, CC * kTile apart), and only the pixel index of a
// sum is a compile-time constant.
template <int K, typename T, bool Split, int I = 0>
__device__ __forceinline__ void add_rows_repeated(float* acc,
                                                  const int32_t* mq,
                                                  const float* wc, int i0,
                                                  int a, int b, int n_win) {
  if constexpr (I < K) {
    if (!Split || i0 == I) {
      float* row = Split ? acc : acc + I * K;
#pragma unroll 1
      for (int ph = 0; ph < K * K; ++ph) {
        const int ky = ph / K, kx = ph % K;
        const int wy = a + cell_of<K>(I, ky);
        if (wy < 0 || wy >= n_win) continue;
        int times[K];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int wx = b + cell_of<K>(j, kx);
          times[j] = wx < 0 || wx >= n_win
                         ? 0 : mq[(ph * n_win + wy) * n_win + wx];
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float wv = wc[(offset_of<K>(I, ky) * K + offset_of<K>(j, kx))
                              * chunk_channels<K>() * kTile];
          for (int r = 0; r < times[j]; ++r)
            row[j] = add_rounded<T>(row[j], wv);
        }
      }
    }
    add_rows_repeated<K, T, Split, I + 1>(acc, mq, wc, i0, a, b, n_win);
  }
}

// One staged chunk's adds into a warp's sums: the channels c < live in
// order, each broadcast from lane c's neighbourhood bits nb, its K*K
// weights read from the chunk wb ([K*K][CC][kTile]). WithRepeats (B4, a
// chunk holding a channel whose queues repeat a position): the channels
// set in `repeats` take add_rows_repeated with their multiplicities (mq:
// the chunk's first channel's, K*K*n_win^2 apart); the others, and every
// chunk without such a channel, run the same adds as B1 and B3.
template <int K, typename T, bool Split, bool WithRepeats, typename A,
          typename WT>
__device__ __forceinline__ void add_chunk(A* acc, const unsigned* nb,
                                          const WT* wb, int live, int i0,
                                          unsigned repeats = 0u,
                                          const int32_t* mq = nullptr,
                                          int a = 0, int b = 0,
                                          int n_win = 0) {
  constexpr int K2 = K * K, CC = chunk_channels<K>();
  constexpr int NB = (K2 + 2) / 3;
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < live; ++c) {
    unsigned m[NB];
    unsigned mc = 0u;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      m[q] = __shfl_sync(0xffffffffu, nb[q], c);
      mc |= m[q];
    }
    if (mc == 0u) continue;  // warp-uniform
    if constexpr (WithRepeats) {
      if ((repeats >> c) & 1u) {  // warp-uniform
        add_rows_repeated<K, T, Split>(acc, mq + c * K2 * n_win * n_win,
                                       wb + c * kTile + lane, i0, a, b,
                                       n_win);
        continue;
      }
    }
    WT wr[K2];
#pragma unroll
    for (int kk = 0; kk < K2; ++kk)
      wr[kk] = wb[(kk * CC + c) * kTile + lane];
    add_rows<K, T, Split>(acc, m, wr, i0);
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The bodies below are wrapped by each library's own __global__ kernels
// (launched through launch_encode / launch_gather), so that B1's and B3's
// kernels carry their own names in a profiler trace.

// The per-sample queue statistics B1's encode pass adds up (encode<true>,
// then add_block_stats): out (samples, 3) int32, zeroed before the launch;
// a sample is cells_per_sample consecutive (n, c) cells (C_in * T). The
// stage's geometry gives each position's in-bounds span.
struct EncodeStats {
  int32_t* out;
  int cells_per_sample, K, n_win, H, W, C_out;
};

// In-bounds SAME-conv offsets d in [0, K) of an event at coordinate p on a
// map of `size` (repro.core.aeq.kernel_span).
__device__ __forceinline__ int kernel_span(int p, int K, int size) {
  const int pad = K / 2;
  return max(min(p + pad, K - 1) - max(p + pad - size + 1, 0) + 1, 0);
}

// Pass 1. One warp per (n, c) cell; cell_tot / row_act may be null (B1).
// Stats (B1) also reads the positions past `depth`, and
// leaves the cell's counts in counts[3] of every lane: events kept, fired
// positions past `depth`, and the sum over kept positions of span(y) *
// span(x), y = wy * K + ky, x = wx * K + kx (0 past the map) —
// repro.core.aeq's segment_keep and span_map. A cell past n_cells leaves
// them as they were.
template <bool Stats = false>
__device__ __forceinline__ void encode(
    const int32_t* __restrict__ occ, uint32_t* __restrict__ bits,
    int32_t* __restrict__ cell_tot, int32_t* __restrict__ row_act,
    int n_cells, int C_in, int K2, int P, int depth, EncodeStats st = {},
    unsigned* counts = nullptr) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= n_cells) return;  // warp-uniform
  const int NW = (P + 31) >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int32_t* src = occ + (size_t)cell * K2 * P;
  uint32_t* dst = bits + (size_t)cell * K2 * NW;
  int tot = 0;
  if constexpr (Stats) {
    // Every word is read, so the loads do not wait on the ranks: the warp
    // walks the cell's K2 * NW words in chunks of U, each chunk's loads
    // issued together, then ranked one word after another (a walk of
    // dependent loads, one a word, is what bounds the encode otherwise).
    // (wy, wx) of this lane's position and (ky, kx) of the phase advance
    // with the walk, so the spans take no division. (U = 4 timed best of
    // 1, 4 and 8 at a 32x32 map on an H100.)
    constexpr int U = 4;
    const int J = K2 * NW, dy = 32 / st.n_win, dx = 32 % st.n_win;
    const int wy0 = lane / st.n_win, wx0 = lane % st.n_win;
    int over = 0;        // fired positions past depth (warp-uniform)
    unsigned span = 0u;  // this lane's kept positions' spans
    int count = 0, wi = 0, ky = 0, kx = 0, wy = wy0, wx = wx0;
    int lph = 0, lwi = 0;  // the next word to load
    for (int j0 = 0; j0 < J; j0 += U) {
      int v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = lwi * 32 + lane;
        v[u] = j0 + u < J && p < P ? src[lph * P + p] : 0;
        if (++lwi == NW) {
          lwi = 0;
          ++lph;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u >= J) break;  // warp-uniform
        const bool fired = v[u] > 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, fired);
        const bool kept = fired && count + __popc(ballot & below) < depth;
        const unsigned kb = __ballot_sync(0xffffffffu, kept);
        if (lane == 0) dst[j0 + u] = kb;
        count += __popc(ballot);
        tot += __popc(kb);
        if (kept) {
          const int y = wy * st.K + ky, x = wx * st.K + kx;
          if (y < st.H && x < st.W)
            span += kernel_span(y, st.K, st.H) * kernel_span(x, st.K, st.W);
        }
        wy += dy;
        wx += dx;
        if (wx >= st.n_win) {
          wx -= st.n_win;
          ++wy;
        }
        if (++wi == NW) {  // the next phase
          over += max(count - depth, 0);
          count = 0;
          wi = 0;
          wy = wy0;
          wx = wx0;
          if (++kx == st.K) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    counts[0] = (unsigned)tot;
    counts[1] = (unsigned)over;
    counts[2] = __reduce_add_sync(0xffffffffu, span);
  } else {
    for (int ph = 0; ph < K2; ++ph) {
      int count = 0;  // warp-uniform: fired positions so far in this queue
      for (int wi = 0; wi < NW; ++wi) {
        const int p = wi * 32 + lane;
        const bool fired = count < depth && p < P && src[ph * P + p] > 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, fired);
        const bool kept = fired && count + __popc(ballot & below) < depth;
        const unsigned kb = __ballot_sync(0xffffffffu, kept);
        if (lane == 0) dst[ph * NW + wi] = kb;
        count += __popc(ballot);
        tot += __popc(kb);
      }
    }
  }
  if (cell_tot != nullptr && lane == 0) {
    cell_tot[cell] = tot;
    if (tot > 0) row_act[cell / C_in] = 1;
  }
}

// B1's statistics encode where a queue fits in a word (P <= 32), in place
// of encode<true>: the (n, c, phase) queues are P contiguous occupancy
// entries each, so lane l of a word takes entry l % P of queue l / P, G =
// 32 / P whole queues a word, and a queue's rank needs no carry. At P = 1
// (the 3x3 maps) all 32 lanes rank, where encode has one lane of 32 at
// work. Block b takes kWarps * WPW consecutive words of the queues of
// sample b / blocks_per_sample, WPW a warp, their loads issued together.
// Leaves the same counts as encode<true> in counts[3] of every lane, summed
// over the warp's queues, and writes the same kept bits (one word a
// queue).
template <int WPW>
__device__ __forceinline__ void encode_packed(
    const int32_t* __restrict__ occ, uint32_t* __restrict__ bits, int K2,
    int P, int depth, int blocks_per_sample, const EncodeStats& st,
    unsigned* counts) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x / blocks_per_sample;
  const int Q = st.cells_per_sample * K2;  // queues of a sample
  const int G = 32 / P, g = lane / P, p = lane - g * P;
  const unsigned mask = P == 32 ? 0xffffffffu : (1u << P) - 1u;
  const unsigned below = (1u << p) - 1u;
  const int wy = p / st.n_win, wx = p - wy * st.n_win;
  const int w0 = ((blockIdx.x - s * blocks_per_sample) * kWarps
                  + (threadIdx.x >> 5)) * WPW;  // the warp's first word
  // the phase of this lane's queue, advanced by G % K2 a word
  const int ph = (w0 * G + g) % K2, gk = G % K2;
  const int gy = gk / st.K, gx = gk - gy * st.K;
  int ky = ph / st.K, kx = ph - ky * st.K;
  const size_t q0 = (size_t)s * Q;  // the sample's first queue
  int v[WPW];
#pragma unroll
  for (int u = 0; u < WPW; ++u) {
    const int q = (w0 + u) * G + g;
    v[u] = g < G && q < Q ? occ[(q0 + q) * P + p] : 0;
  }
  unsigned tot = 0u, over = 0u, span = 0u;
#pragma unroll
  for (int u = 0; u < WPW; ++u) {
    const int q = (w0 + u) * G + g;
    const bool fired = v[u] > 0;
    const unsigned seg =
        (__ballot_sync(0xffffffffu, fired) >> (g * P)) & mask;
    const bool kept = fired && __popc(seg & below) < depth;
    const unsigned kb = __ballot_sync(0xffffffffu, kept);
    if (p == 0 && g < G && q < Q) {  // the queue's first lane
      bits[q0 + q] = (kb >> (g * P)) & mask;
      over += (unsigned)max(__popc(seg) - depth, 0);
    }
    if (kept) {
      ++tot;
      const int y = wy * st.K + ky, x = wx * st.K + kx;
      if (y < st.H && x < st.W)
        span += kernel_span(y, st.K, st.H) * kernel_span(x, st.K, st.W);
    }
    kx += gx;
    ky += gy;
    if (kx >= st.K) {
      kx -= st.K;
      ++ky;
    }
    if (ky >= st.K) ky -= st.K;
  }
  counts[0] = __reduce_add_sync(0xffffffffu, tot);
  counts[1] = __reduce_add_sync(0xffffffffu, over);
  counts[2] = __reduce_add_sync(0xffffffffu, span);
}

// After encode<true> or encode_packed, every thread of the block: adds the
// block's warps' counts (counts[3] and sample, warp-uniform) into their
// samples' rows of st.out, the adds x C_out. The warps' counts are first
// summed per sample in shared memory, so a block makes three atomics for
// each sample its warps belong to (one, but where a block straddles two),
// not three a warp: same-address atomics from every warp would queue at the
// few cache lines of st.out. They are int32 adds, so they wrap as the
// engine's int64 sums cast to int32 do, and give the same sums in any
// order.
__device__ __forceinline__ void add_block_stats(const EncodeStats& st,
                                                const unsigned* counts,
                                                int sample) {
  __shared__ unsigned part[kWarps][3];
  __shared__ int samples[kWarps];
  if ((threadIdx.x & 31) == 0) {
    for (int q = 0; q < 3; ++q) part[threadIdx.x >> 5][q] = counts[q];
    samples[threadIdx.x >> 5] = sample;
  }
  __syncthreads();
  if (threadIdx.x >= 3) return;
  const int q = threadIdx.x;  // the count this thread adds
  const unsigned scale = q == 2 ? (unsigned)st.C_out : 1u;
  unsigned* out = reinterpret_cast<unsigned*>(st.out);
  int s = samples[0];
  unsigned acc = 0u;
  for (int w = 0; w < kWarps; ++w) {
    if (samples[w] != s) {
      if (acc != 0u) atomicAdd(out + (size_t)s * 3 + q, acc * scale);
      s = samples[w];
      acc = 0u;
    }
    acc += part[w][q];
  }
  if (acc != 0u) atomicAdd(out + (size_t)s * 3 + q, acc * scale);
}

// Pass 2. Grid (ceil(n_tasks / Cells), ceil(C_out / 32)), gather_warps()
// warps a block; task t is window cell t % cells of row order[t / cells]
// (row t / cells when order is null), cells = ceil(H / K) * ceil(W / K).
// cell_tot, when given, skips a lane's empty cells. Scaled multiplies each
// sum by w_scale[0]. Init starts each sum from v_in (same layout as out);
// every add is rounded to T, the type of v_in and out. Mult (B4): a (row,
// channel) cell whose flags entry is set takes its kept positions'
// multiplicities from mult (rows, C_in, K*K, n_win^2); other cells add
// each kept position once and read no multiplicity. IntAcc (B3 past 2^24):
// w holds int32 weights and the sums are int32.
template <int K, bool Scaled, bool Init = false, typename T = float,
          int Cells = kWarps, bool Split = false, bool Mult = false,
          bool IntAcc = false>
__device__ __forceinline__ void gather(
    const uint32_t* __restrict__ bits, const float* __restrict__ w,
    const float* __restrict__ w_scale, const int32_t* __restrict__ cell_tot,
    const int32_t* __restrict__ order, T* __restrict__ out, int n_tasks,
    int C_in, int n_win, int H, int W, int C_out,
    const T* __restrict__ v_in = nullptr,
    const int32_t* __restrict__ mult = nullptr,
    const int32_t* __restrict__ flags = nullptr) {
  using A = typename std::conditional<IntAcc, int32_t, float>::type;
  constexpr int K2 = K * K, CC = chunk_channels<K>();
  constexpr int NB = (K2 + 2) / 3;  // neighbourhood words, 3 phases each
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = (n_win * n_win + 31) >> 5;
  const int cells_x = (W + K - 1) / K, cells = ((H + K - 1) / K) * cells_x;
  const int SW = staged_words(Cells, n_win, cells_x, (H + K - 1) / K);
  const int CW = cell_words(K2, SW);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * Cells;
  const int r_first = t0 / cells;
  const int span = (min(t0 + Cells, n_tasks) - 1) / cells - r_first + 1;
  // the first staged word of every queue of the first row (its cells start
  // at window row (t0 % cells) / cells_x); later rows start at cell 0
  const int w_first = first_word((t0 - r_first * cells) / cells_x, n_win);
  const int co0 = blockIdx.y * kTile;
  const int wbuf = K2 * CC * kTile;                        // per buffer
  const int bbuf = rows_spanned(Cells, cells) * CC * CW;   // per buffer
  float* w_s = reinterpret_cast<float*>(smem);             // [2][K2][CC][32]
  uint32_t* b_s = reinterpret_cast<uint32_t*>(w_s + 2 * wbuf);
  const bool vec =
      C_out % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  auto row_of = [&](int r) { return order != nullptr ? order[r] : r; };
  // channels [c0, c0 + CC) of [0, C_in) into buffer s & 1; the words for
  // channels past C_in, outputs past C_out or past a queue's NW words are
  // never staged, and never reach a written result
  auto stage = [&](int s) {
    const int c0 = s * CC, live = min(CC, C_in - c0);
    float* wd = w_s + (s & 1) * wbuf;
    for (int i = threadIdx.x; i < K2 * CC * (kTile / 4); i += blockDim.x) {
      const int q = i % (kTile / 4), cl = (i / (kTile / 4)) % CC;
      const int kk = i / ((kTile / 4) * CC), o = co0 + 4 * q;
      if (cl >= live) continue;
      const float* src = w + ((size_t)kk * C_in + c0 + cl) * C_out + o;
      float* dst = wd + (kk * CC + cl) * kTile + 4 * q;
      if (vec && o + 4 <= C_out) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 4 && o + e < C_out; ++e)
          cp_async4(dst + e, src + e);
      }
    }
    // one thread a (row, channel, phase) queue: its words [w0, w0 + SW)
    uint32_t* bd = b_s + (s & 1) * bbuf;
    const int per_row = live * K2;
    for (int i = threadIdx.x; i < span * per_row; i += blockDim.x) {
      const int rr = i / per_row, cq = i - rr * per_row;  // cl * K2 + ph
      const int cl = cq / K2;
      const int w0 = rr == 0 ? w_first : 0, n = min(SW, NW - w0);
      const uint32_t* src =
          bits + ((size_t)row_of(r_first + rr) * C_in + c0) * K2 * NW
          + (size_t)cq * NW + w0;
      uint32_t* dst = bd + (rr * CC + cl) * CW + (cq - cl * K2) * SW;
      for (int q = 0; q < n; ++q) cp_async4(dst + q, src + q);
    }
    cp_async_commit();
  };

  constexpr int R = Split ? 1 : K;  // pixel rows this warp sums
  const int t = t0 + (Split ? warp / K : warp);
  const int i0 = Split ? warp % K : 0;  // its first pixel row
  const bool task = t < n_tasks;  // warp-uniform
  const int r = task ? t / cells : r_first;
  const int cell = task ? t - r * cells : 0;
  const int a = cell / cells_x, b = cell - (cell / cells_x) * cells_x;
  const int row = task ? row_of(r) : 0;
  const int w_lo = r == r_first ? w_first : 0;  // this row's first word

  const int oc = co0 + lane;  // this lane's output channel
  A acc[R * K];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ty = a * K + i0 + i, tx = b * K + j;
      acc[i * K + j] = 0;
      if constexpr (Init) {
        if (task && oc < C_out && ty < H && tx < W)
          acc[i * K + j] =
              widen(v_in[(((size_t)row * H + ty) * W + tx) * C_out + oc]);
      }
    }
  }

  const int n_chunks = (C_in + CC - 1) / CC;
  stage(0);
  for (int s = 0; s < n_chunks; ++s) {
    // this lane's channel's repeat flag, loaded before the chunk's wait
    const bool flagged = Mult && task && s * CC + lane < C_in
                         && flags[(size_t)row * C_in + s * CC + lane] != 0;
    if (s + 1 < n_chunks) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk s is in shared memory for every thread
    const int c0 = s * CC, live = min(CC, C_in - c0);
    const float* wb = w_s + (s & 1) * wbuf;
    // this lane's channel c0 + lane: the 3x3 neighbourhood of cell (a, b)
    // in each phase queue, bit (ro + 1) * 3 + (co + 1) of 9 per phase
    unsigned nb[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) nb[q] = 0u;
    bool on = task && lane < live;
    if (on && cell_tot != nullptr)
      on = cell_tot[(size_t)row * C_in + c0 + lane] != 0;
    if (on) {
      const uint32_t* cb =
          b_s + (s & 1) * bbuf + ((r - r_first) * CC + lane) * CW;
#pragma unroll
      for (int ph = 0; ph < K2; ++ph) {
#pragma unroll
        for (int ro = -1; ro <= 1; ++ro) {
          const int wy = a + ro;
          if (!reaches<K>(ph / K, ro) || wy < 0 || wy >= n_win) continue;
#pragma unroll
          for (int co = -1; co <= 1; ++co) {
            const int wx = b + co;
            if (!reaches<K>(ph % K, co) || wx < 0 || wx >= n_win) continue;
            const int p = wy * n_win + wx;
            const uint32_t word = cb[ph * SW + (p >> 5) - w_lo];
            nb[ph / 3] |= ((word >> (p & 31)) & 1u)
                          << ((ph % 3) * 9 + (ro + 1) * 3 + (co + 1));
          }
        }
      }
    }
    unsigned any = 0u;
#pragma unroll
    for (int q = 0; q < NB; ++q) any |= nb[q];
    unsigned repeats = 0u;
    if constexpr (Mult) repeats = __ballot_sync(0xffffffffu, flagged);
    if (__any_sync(0xffffffffu, any != 0u)) {
      if constexpr (IntAcc) {
        add_chunk<K, T, Split, false>(
            acc, nb, reinterpret_cast<const int32_t*>(wb), live, i0);
      } else {
        if (Mult && repeats != 0u)  // warp-uniform: a channel here repeats
          add_chunk<K, T, Split, Mult>(
              acc, nb, wb, live, i0, repeats,
              mult + ((size_t)row * C_in + c0) * K2 * n_win * n_win, a, b,
              n_win);
        else
          add_chunk<K, T, Split, false>(acc, nb, wb, live, i0);
      }
    }
    __syncthreads();  // the next stage overwrites this chunk's buffer
  }

  if (!task || oc >= C_out) return;
  const float scale = Scaled ? w_scale[0] : 1.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ty = a * K + i0 + i, tx = b * K + j;
      if (ty >= H || tx >= W) continue;
      const float v = to_float(acc[i * K + j]);
      out[(((size_t)row * H + ty) * W + tx) * C_out + oc] =
          narrow<T>(Scaled ? __fmul_rn(v, scale) : v);
    }
  }
}

// The gather for any odd K (see the header): grid (ceil(n_rows * H * W /
// kWarps), ceil(C_out / 32)), kWarps warps a block, no shared memory and
// no barrier; warp t takes output pixel t % (H * W) of row order[t / (H *
// W)] (row t / (H * W) when order is null), lane l output channel
// blockIdx.y * 32 + l. Per channel c (ascending; skipped where cell_tot
// says the cell is empty) lane l looks up phase q0 + l of each 32 (the one
// position of that phase in the pixel's window, its offset (dy, dx), and
// its kept bit, or with Mult on a flagged cell its multiplicity); a ballot
// then walks the phases that add, lowest first, each weight added as many
// times as its multiplicity, back to back. The arguments mean what they
// mean for gather.
template <bool Scaled, bool Init = false, typename T = float,
          bool Mult = false, bool IntAcc = false>
__device__ __forceinline__ void gather_rt(
    const uint32_t* __restrict__ bits, const float* __restrict__ w,
    const float* __restrict__ w_scale, const int32_t* __restrict__ cell_tot,
    const int32_t* __restrict__ order, T* __restrict__ out, long long n_pix,
    int C_in, int K, int n_win, int H, int W, int C_out,
    const T* __restrict__ v_in = nullptr,
    const int32_t* __restrict__ mult = nullptr,
    const int32_t* __restrict__ flags = nullptr) {
  using A = typename std::conditional<IntAcc, int32_t, float>::type;
  const int lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= n_pix) return;  // warp-uniform
  const int r = (int)(t / ((long long)H * W));
  const int pix = (int)(t - (long long)r * H * W);
  const int ty = pix / W, tx = pix - (pix / W) * W;
  const int row = order != nullptr ? order[r] : r;
  const int oc = blockIdx.y * kTile + lane;
  const bool has_oc = oc < C_out;
  const int K2 = K * K, pad = K / 2, side = n_win * K;
  const int P = n_win * n_win, NW = (P + 31) >> 5;
  const size_t o = (((size_t)row * H + ty) * W + tx) * C_out + oc;
  A acc = 0;
  if constexpr (Init) {
    if (has_oc) acc = widen(v_in[o]);
  }
  const A* wa = reinterpret_cast<const A*>(w);
  for (int c = 0; c < C_in; ++c) {
    const size_t cell = (size_t)row * C_in + c;
    if (cell_tot != nullptr && cell_tot[cell] == 0) continue;  // uniform
    const bool flagged = Mult && flags[cell] != 0;             // uniform
    const uint32_t* cb = bits + cell * K2 * NW;
    for (int q0 = 0; q0 < K2; q0 += 32) {
      const int ph = q0 + lane;
      int times = 0, kk = 0;
      if (ph < K2) {
        const int ky = ph / K, kx = ph - (ph / K) * K;
        const int dy = ((ky - ty + pad) % K + K) % K;
        const int dx = ((kx - tx + pad) % K + K) % K;
        const int y = ty - pad + dy, x = tx - pad + dx;
        if (y >= 0 && y < side && x >= 0 && x < side) {
          const int p = (y / K) * n_win + x / K;
          times = flagged ? mult[(cell * K2 + ph) * P + p]
                          : (int)((cb[ph * NW + (p >> 5)] >> (p & 31)) & 1u);
          kk = dy * K + dx;
        }
      }
      unsigned hit = __ballot_sync(0xffffffffu, times > 0);
      while (hit != 0u) {  // warp-uniform
        const int l = __ffs(hit) - 1;
        hit &= hit - 1u;
        const int k = __shfl_sync(0xffffffffu, kk, l);
        const int n = __shfl_sync(0xffffffffu, times, l);
        if (has_oc) {
          const A wv = wa[((size_t)k * C_in + c) * C_out + oc];
          for (int e = 0; e < n; ++e) acc = accumulate<T>(acc, wv);
        }
      }
    }
  }
  if (!has_oc) return;
  const float v = to_float(acc);
  out[o] = narrow<T>(Scaled ? __fmul_rn(v, w_scale[0]) : v);
}

using EncodeKernel = void (*)(const int32_t*, uint32_t*, int32_t*, int32_t*,
                              int, int, int, int, int);
using GatherKernel = void (*)(const uint32_t*, const float*, const float*,
                              const int32_t*, const int32_t*, float*, int,
                              int, int, int, int, int);

inline int launch_encode(EncodeKernel kernel, const void* occ,
                         uint32_t* bits, int32_t* cell_tot, int32_t* row_act,
                         int N, int C_in, int K2, int P, int depth,
                         cudaStream_t stream) {
  const int n_cells = N * C_in;
  if (n_cells == 0) return 0;
  kernel<<<(n_cells + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(occ), bits, cell_tot, row_act, n_cells,
      C_in, K2, P, depth);
  return (int)cudaGetLastError();
}

// One instantiation, and so one set of opt-in flags (one a device), per
// kernel: the gather's dynamic shared memory may exceed the 48 KiB default.
template <auto kernel>
int opt_in_smem() {
  static bool opted_in[per_device::kMaxDevices] = {};
  return per_device::once(opted_in, [] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    return err;
  });
}

template <int K, GatherKernel kernel>
int launch_gather(const uint32_t* bits,
                  const void* w, const void* w_scale,
                  const int32_t* cell_tot, const int32_t* order, void* out,
                  int n_rows, int C_in, int n_win, int H, int W, int C_out,
                  cudaStream_t stream) {
  const long long n_tasks =
      (long long)n_rows * ((H + K - 1) / K) * ((W + K - 1) / K);
  if (n_tasks == 0 || C_out == 0 || C_in == 0) return 0;
  const size_t smem = gather_smem<K>(n_win, H, W);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int err = opt_in_smem<kernel>();
  if (err != 0) return err;
  dim3 grid((unsigned)((n_tasks + kWarps - 1) / kWarps),
            (C_out + kTile - 1) / kTile);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      bits, static_cast<const float*>(w), static_cast<const float*>(w_scale),
      cell_tot, order, static_cast<float*>(out), (int)n_tasks, C_in, n_win,
      H, W, C_out);
  return (int)cudaGetLastError();
}

using GatherRtKernel = void (*)(const uint32_t*, const float*, const float*,
                                const int32_t*, const int32_t*, float*,
                                long long, int, int, int, int, int, int);

inline int launch_gather_rt(GatherRtKernel kernel, const uint32_t* bits,
                            const void* w, const void* w_scale,
                            const int32_t* cell_tot, const int32_t* order,
                            void* out, int n_rows, int C_in, int K, int n_win,
                            int H, int W, int C_out, cudaStream_t stream) {
  const long long n_pix = (long long)n_rows * H * W;
  if (n_pix == 0 || C_out == 0 || C_in == 0) return 0;
  dim3 grid((unsigned)((n_pix + kWarps - 1) / kWarps),
            (C_out + kTile - 1) / kTile);
  kernel<<<grid, kWarps * 32, 0, stream>>>(
      bits, static_cast<const float*>(w), static_cast<const float*>(w_scale),
      cell_tot, order, static_cast<float*>(out), n_pix, C_in, K, n_win, H, W,
      C_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace spike_accum
