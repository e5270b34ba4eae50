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
//    the rows that hold any event (B3's occupancy gate).
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
// (K*K, CC, 32) and the kept bits of the block's rows (rows, CC, K*K*NW)
// are staged in shared memory with cp.async, double-buffered: the next
// chunk loads while this one is added. The only barriers are between
// chunks. Within a chunk lane l first gathers, for channel c0 + l, the 3x3
// window neighbourhood of cell (a, b) in each phase queue (9 bits a phase,
// three phases a word); the warp then walks the chunk's channels,
// broadcasting each channel's words with shuffles. The branches are
// warp-uniform. A pixel's window is the window grid [0, n_win*K), not
// [0, H): the scatter form decodes events over the whole grid.
//
// B3's int path (Scaled) adds the quantized integer weights, which the
// wrapper passes as fp32: every partial sum is an integer of magnitude at
// most K*K * C_in * 127 < 2^24 (the wrapper checks it), so each fp32 add is
// exact, in any order, and the sum equals the int32 one bit for bit, at the
// fp32 rate, twice the int32 rate of an H100 SM. One __fmul_rn(acc, scale)
// per output element dequantizes, as __fmul_rn(__int2float_rn(sum), scale).
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

namespace spike_accum {
// Internal linkage: every library that includes this header keeps its own
// kernels and its own opt-in flags (a function-local static of an inline
// function would otherwise be one object across all loaded libraries).
namespace {

constexpr int kWarps = 8;         // warps per block, one window cell each
constexpr int kTile = 32;         // output channels per block, one per lane
constexpr int kSmemMax = 232448;  // shared memory one Hopper block may use

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

template <int K, int Cells = kWarps>
inline size_t gather_smem(int n_win, int H, int W) {
  constexpr int K2 = K * K, CC = chunk_channels<K>();
  const int NW = (n_win * n_win + 31) / 32;
  const int cells = ((H + K - 1) / K) * ((W + K - 1) / K);
  return 4 * (2 * (size_t)K2 * CC * kTile
              + 2 * (size_t)rows_spanned(Cells, cells) * CC
                    * cell_words(K2, NW));
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
template <int K, int I, typename T>
__device__ __forceinline__ void add_row(float* acc, const unsigned* m,
                                        const float* wr) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int ph = 0; ph < K * K; ++ph) {
      const int ky = ph / K, kx = ph % K;
      const int bit = (ph % 3) * 9 + (cell_of<K>(I, ky) + 1) * 3
                      + (cell_of<K>(j, kx) + 1);
      if ((m[ph / 3] >> bit) & 1u)
        acc[j] = add_rounded<T>(
            acc[j], wr[offset_of<K>(I, ky) * K + offset_of<K>(j, kx)]);
    }
  }
}

// The pixel rows a warp holds: all K (acc[K*K]), or with Split row i0 only
// (acc[K]), picked by a warp-uniform branch, so that every bit position,
// weight index and sum stays a compile-time constant.
template <int K, typename T, bool Split, int I = 0>
__device__ __forceinline__ void add_rows(float* acc, const unsigned* m,
                                         const float* wr, int i0) {
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
template <int K, typename T, bool Split, bool WithRepeats>
__device__ __forceinline__ void add_chunk(float* acc, const unsigned* nb,
                                          const float* wb, int live, int i0,
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
    float wr[K2];
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

// Pass 1. One warp per (n, c) cell; cell_tot / row_act may be null (B1).
__device__ __forceinline__ void encode(
    const int32_t* __restrict__ occ, uint32_t* __restrict__ bits,
    int32_t* __restrict__ cell_tot, int32_t* __restrict__ row_act,
    int n_cells, int C_in, int K2, int P, int depth) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= n_cells) return;  // warp-uniform
  const int NW = (P + 31) >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int32_t* src = occ + (size_t)cell * K2 * P;
  uint32_t* dst = bits + (size_t)cell * K2 * NW;
  int tot = 0;
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
  if (cell_tot != nullptr && lane == 0) {
    cell_tot[cell] = tot;
    if (tot > 0) row_act[cell / C_in] = 1;
  }
}

// Pass 2. Grid (ceil(n_tasks / Cells), ceil(C_out / 32)), gather_warps()
// warps a block; task t is window cell t % cells of row order[t / cells]
// (row t / cells when order is null), cells = ceil(H / K) * ceil(W / K).
// cell_tot, when given, skips a lane's empty cells. Scaled multiplies each
// sum by w_scale[0]. Init starts each sum from v_in (same layout as out);
// every add is rounded to T, the type of v_in and out. Mult (B4): a (row,
// channel) cell whose flags entry is set takes its kept positions'
// multiplicities from mult (rows, C_in, K*K, n_win^2); other cells add
// each kept position once and read no multiplicity.
template <int K, bool Scaled, bool Init = false, typename T = float,
          int Cells = kWarps, bool Split = false, bool Mult = false>
__device__ __forceinline__ void gather(
    const uint32_t* __restrict__ bits, const float* __restrict__ w,
    const float* __restrict__ w_scale, const int32_t* __restrict__ cell_tot,
    const int32_t* __restrict__ order, T* __restrict__ out, int n_tasks,
    int C_in, int n_win, int H, int W, int C_out,
    const T* __restrict__ v_in = nullptr,
    const int32_t* __restrict__ mult = nullptr,
    const int32_t* __restrict__ flags = nullptr) {
  constexpr int K2 = K * K, CC = chunk_channels<K>();
  constexpr int NB = (K2 + 2) / 3;  // neighbourhood words, 3 phases each
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = (n_win * n_win + 31) >> 5, CW = cell_words(K2, NW);
  const int cells_x = (W + K - 1) / K, cells = ((H + K - 1) / K) * cells_x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * Cells;
  const int r_first = t0 / cells;
  const int span = (min(t0 + Cells, n_tasks) - 1) / cells - r_first + 1;
  const int co0 = blockIdx.y * kTile;
  const int wbuf = K2 * CC * kTile;                        // per buffer
  const int bbuf = rows_spanned(Cells, cells) * CC * CW;   // per buffer
  float* w_s = reinterpret_cast<float*>(smem);             // [2][K2][CC][32]
  uint32_t* b_s = reinterpret_cast<uint32_t*>(w_s + 2 * wbuf);
  const bool vec =
      C_out % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  auto row_of = [&](int r) { return order != nullptr ? order[r] : r; };
  // channels [c0, c0 + CC) of [0, C_in) into buffer s & 1; the words for
  // channels past C_in or outputs past C_out are never staged, and never
  // reach a written result
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
    uint32_t* bd = b_s + (s & 1) * bbuf;
    const int q_row = K2 * NW, per_row = live * q_row;
    for (int i = threadIdx.x; i < span * per_row; i += blockDim.x) {
      const int rr = i / per_row, cl = (i % per_row) / q_row, q = i % q_row;
      cp_async4(bd + (rr * CC + cl) * CW + q,
                bits + ((size_t)row_of(r_first + rr) * C_in + c0 + cl) * q_row
                    + q);
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

  const int oc = co0 + lane;  // this lane's output channel
  float acc[R * K];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int ty = a * K + i0 + i, tx = b * K + j;
      acc[i * K + j] =
          Init && task && oc < C_out && ty < H && tx < W
              ? widen(v_in[(((size_t)row * H + ty) * W + tx) * C_out + oc])
              : 0.f;
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
            nb[ph / 3] |= ((cb[ph * NW + (p >> 5)] >> (p & 31)) & 1u)
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
      if (Mult && repeats != 0u)  // warp-uniform: a channel here repeats
        add_chunk<K, T, Split, Mult>(
            acc, nb, wb, live, i0, repeats,
            mult + ((size_t)row * C_in + c0) * K2 * n_win * n_win, a, b,
            n_win);
      else
        add_chunk<K, T, Split, false>(acc, nb, wb, live, i0);
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
      out[(((size_t)row * H + ty) * W + tx) * C_out + oc] = narrow<T>(
          Scaled ? __fmul_rn(acc[i * K + j], scale) : acc[i * K + j]);
    }
  }
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

// One instantiation, and so one opt-in flag, per kernel: the gather's
// dynamic shared memory may exceed the 48 KiB default.
template <auto kernel>
int opt_in_smem() {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  return 0;
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

}  // namespace
}  // namespace spike_accum
