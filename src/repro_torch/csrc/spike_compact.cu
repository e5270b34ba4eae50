// The queue encoder (Thresholding Unit) for Hopper (sm_90a): B5.
//
// Replaces the Pallas TPU kernel repro/kernels/spike_compact.py::
// spike_compact (body `_kernel`). Each occupancy row (one (channel, phase)
// queue: R = C*K*K rows of P = n_win*n_win window positions) becomes packed
// AE words (wy << bits) | wx appended in position order, `depth` slots per
// row with `invalid` in the empty ones, plus the row's uncapped event count
// (the caller derives the overflow as max(count - depth, 0)). The TPU
// kernel walks a row position by position with a scalar write pointer.
//
// What bounds it on an H100: device-memory bytes. It reads each occupancy
// int once and writes each word and count once, with a few integer ops per
// position, so the floor is (R*P + R*depth + R) * 4 B / 3.35 TB/s; the
// words dominate (a P = 1 row of a 3x3 stage writes `depth` words for at
// most one event).
//
// Design: a group of G = min(32, next power of two >= P) lanes takes one
// row, so a warp takes 32 / G rows (32 rows of P = 1, two of P = 16, one of
// P = 121). The group walks its row G positions at a time (a whole warp
// loads four such chunks before it ranks them); a warp ballot masked to the
// group, plus the popcount of the group's lanes below, gives each fired
// position its slot (the write pointer's prefix sum). The walk never stops
// early: the count is uncapped. A block's rows are contiguous
// in `words`, so the block stages them as one tile in shared memory: it
// fills the tile with `invalid` (16-byte stores), the groups write their
// events into it, and after a barrier the block streams the tile out with
// coalesced 16-byte stores, plus scalar stores before the first 16-byte
// boundary and after the last. The tile sits in shared memory at the same
// offset mod 16 bytes as its destination, so both sides of each vector
// copy are aligned. A row too deep for one block's shared memory (depth
// past 58,103 words) takes the same kernel without the tile (Staged =
// false): the block fills its rows with `invalid` in device memory, and
// after a barrier the groups write their events there directly. The result
// is integer work and bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kThreads = 256;      // most threads a block
constexpr int kTileWords = 8192;   // words a block stages (32 KiB)
#ifndef REPRO_SMEM_MAX
#error "build with -DREPRO_SMEM_MAX=<bytes> (kernels/_cuda.py passes it)"
#endif
constexpr int kSmemMax = REPRO_SMEM_MAX;  // shared memory one block may use

template <int G, bool Staged>
__global__ void __launch_bounds__(kThreads)
spike_compact_kernel(const int32_t* __restrict__ occ,
                     int32_t* __restrict__ words,
                     int32_t* __restrict__ counts, int R, int P, int n_win,
                     int bits, int depth, int invalid, int rows_per_block) {
  extern __shared__ __align__(16) int32_t tile[];
  const int row0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, R - row0);
  const long long n = (long long)nrows * depth;  // the block's words
  int32_t* dst = words + (size_t)row0 * depth;
  const int mis = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);

  if constexpr (Staged) {
    const int4 inv = make_int4(invalid, invalid, invalid, invalid);
    for (int i = threadIdx.x; i < (mis + n + 3) / 4; i += blockDim.x)
      reinterpret_cast<int4*>(tile)[i] = inv;
  } else {
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = invalid;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = threadIdx.x / G;
  const int gl = lane % G, base = lane - gl;  // lane in group, group's first
  const unsigned group = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  const unsigned below = (1u << gl) - 1u;
  const bool has_row = g < nrows;  // the group holds a row (block-tail)
  const int32_t* in = occ + (size_t)(row0 + g) * P;
  int32_t* t = Staged ? tile + mis + (size_t)g * depth
                     : dst + (size_t)g * depth;
  constexpr int U = G == 32 ? 4 : 1;  // loads in flight per lane
  int count = 0;  // group-uniform write pointer
  for (int p0 = 0; p0 < P; p0 += U * G) {  // the same rounds in every group
    bool fired[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G + gl;
      fired[u] = has_row && p < P && in[p] > 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * G + gl;
      const unsigned ballot =
          (__ballot_sync(0xffffffffu, fired[u]) >> base) & group;
      const int slot = count + __popc(ballot & below);
      if (fired[u] && slot < depth)
        t[slot] = ((p / n_win) << bits) | (p % n_win);
      count += __popc(ballot);
    }
  }
  if (has_row && gl == 0) counts[row0 + g] = count;
  if constexpr (!Staged) return;  // the events are already in place
  __syncthreads();

  const int head = (int)min((long long)((4 - mis) & 3), n);  // before a
  const int nv = (int)((n - head) / 4);                      // 16-B boundary
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = tile[mis + i];
  const int4* src4 = reinterpret_cast<const int4*>(tile + mis + head);
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) dst4[i] = src4[i];
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = tile[mis + i];
}

// rows a block of G lanes a row holds, and the bytes their words take in
// shared memory (whole 16-byte stores, plus one for the alignment shift)
inline int tile_rows(int G, int depth) {
  return max(1, min(kThreads / G, kTileWords / depth));
}
inline size_t tile_smem(int rows, int depth) {
  return 4 * (((size_t)rows * depth + 3) / 4 * 4 + 4);
}

// lanes a row for P positions: the next power of two, at most a warp
inline int row_lanes(int P) {
  int g = 1;
  while (g < P && g < 32) g <<= 1;
  return g;
}

template <int G>
int launch(const void* occ, void* words, void* counts, int R, int P,
           int n_win, int bits, int depth, int invalid, cudaStream_t s) {
  const int rows = tile_rows(G, depth);
  const int threads = (rows * G + 31) / 32 * 32;
  const size_t smem = tile_smem(rows, depth);
  const int blocks = (R + rows - 1) / rows;
  auto args = [&](auto kernel, size_t bytes) {
    kernel<<<blocks, threads, bytes, s>>>(
        static_cast<const int32_t*>(occ), static_cast<int32_t*>(words),
        static_cast<int32_t*>(counts), R, P, n_win, bits, depth, invalid,
        rows);
    return (int)cudaGetLastError();
  };
  if (smem > (size_t)kSmemMax)  // one row's words do not fit: no tile
    return args(spike_compact_kernel<G, false>, 0);
  // one set of flags per G, i.e. per kernel, one flag a device
  static bool opted_in[per_device::kMaxDevices] = {};
  if (smem > 48 * 1024) {
    const int err = per_device::once(opted_in, [] {
      return cudaFuncSetAttribute(
          spike_compact_kernel<G, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    });
    if (err) return err;
  }
  return args(spike_compact_kernel<G, true>, smem);
}

}  // namespace

extern "C" {

// occ (R, P) int32 -> words (R, depth) int32, counts (R,) int32 (uncapped);
// R, P, depth >= 1. Returns cudaGetLastError() after the launch.
int spike_compact(const void* occ, void* words, void* counts, int R, int P,
                  int n_win, int bits, int depth, int invalid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 1) return launch<1>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
  if (P <= 2) return launch<2>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
  if (P <= 4) return launch<4>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
  if (P <= 8) return launch<8>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
  if (P <= 16) return launch<16>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
  return launch<32>(occ, words, counts, R, P, n_win, bits, depth, invalid, s);
}

// The dynamic shared memory spike_compact requests per block for rows of
// P positions at this depth (0 where a tile does not fit and rows are
// written in place): kernels/spike_compact.py's smem_blocks adds up the
// same number.
long long spike_compact_smem(int P, int depth) {
  if (P < 1 || depth < 1) return -1;
  const size_t smem = tile_smem(tile_rows(row_lanes(P), depth), depth);
  return smem > (size_t)kSmemMax ? 0 : (long long)smem;
}

}  // extern "C"
