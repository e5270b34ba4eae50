// The queue encoder (Thresholding Unit) for Hopper (sm_90a).
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
// position, so the floor is (R*P + R*depth + R) * 4 B / 3.35 TB/s.
//
// Design: one warp per row. The warp walks P in chunks of 32 positions; a
// __ballot_sync of the fired lanes plus __popc of the lanes below gives each
// fired position its slot (the write pointer's prefix sum), and the lane
// writes its word where slot < depth. The walk never stops early: the count
// is uncapped. The lanes then fill the slots past min(count, depth) with
// `invalid`. Consecutive lanes read consecutive ints, so the loads coalesce;
// the result is integer work and bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(kWarps * 32)
spike_compact_kernel(const int32_t* __restrict__ occ,
                     int32_t* __restrict__ words,
                     int32_t* __restrict__ counts, int R, int P, int n_win,
                     int bits, int depth, int invalid) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform
  const unsigned lanes_below = (1u << lane) - 1u;
  const int32_t* in = occ + (size_t)row * P;
  int32_t* out = words + (size_t)row * depth;
  int count = 0;  // warp-uniform write pointer
  for (int p0 = 0; p0 < P; p0 += 32) {
    const int p = p0 + lane;
    const bool fired = p < P && in[p] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, fired);
    const int slot = count + __popc(ballot & lanes_below);
    if (fired && slot < depth) out[slot] = ((p / n_win) << bits) | (p % n_win);
    count += __popc(ballot);
  }
  for (int s = min(count, depth) + lane; s < depth; s += 32) out[s] = invalid;
  if (lane == 0) counts[row] = count;
}

}  // namespace

extern "C" {

// occ (R, P) int32 -> words (R, depth) int32, counts (R,) int32 (uncapped).
// Returns cudaGetLastError() after the launch.
int spike_compact(const void* occ, void* words, void* counts, int R, int P,
                  int n_win, int bits, int depth, int invalid, void* stream) {
  const int blocks = (R + kWarps - 1) / kWarps;
  spike_compact_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(occ), static_cast<int32_t*>(words),
      static_cast<int32_t*>(counts), R, P, n_win, bits, depth, invalid);
  return (int)cudaGetLastError();
}

}  // extern "C"
