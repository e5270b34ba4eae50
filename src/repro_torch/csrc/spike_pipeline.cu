// Fused spike compaction + event accumulation for Hopper (sm_90a): B1.
//
// Replaces the Pallas TPU kernel repro/kernels/spike_pipeline.py::
// fused_spike_accum_pallas (body `_kernel`). For every row n (= sample*step)
// and input channel c, events past `depth` per (c, phase) queue of the
// occupancy (N, C_in, K*K, P) are dropped in window-row-major order
// (exactly repro.core.aeq.segment_keep), and each surviving event adds its
// K x K SAME-conv fan-out w[dy, dx, c, :] into the (H, W, C_out) charge.
//
// Two launches, both from spike_accum.cuh: the encode pass turns the
// occupancy into packed kept bits (read once, coalesced; it also adds up
// each sample's kept events, dropped events and adds, the statistics the
// engine's queue_pallas stage reports, into a buffer it zeroes first), and
// the barrier-free gather adds, per output element, the kept events' weights in
// (c, phase) order — the order of the scatter form this kernel had before,
// so its fp32 result is unchanged bit for bit, and a row's result depends
// only on that row's inputs. The header says why that order is possible
// without a shared charge map, and what bounds the kernel.
#include "spike_accum.cuh"

namespace {

using spike_accum::kWarps;

// the encode pass, which also adds up each sample's queue statistics: a
// warp a cell where a queue spans words (P > 32), packed queues otherwise
__global__ void __launch_bounds__(kWarps * 32)
fused_spike_accum_encode(const int32_t* __restrict__ occ,
                               uint32_t* __restrict__ bits, int n_cells,
                               int C_in, int K2, int P, int depth,
                               spike_accum::EncodeStats st) {
  unsigned counts[3] = {0u, 0u, 0u};
  spike_accum::encode<true>(occ, bits, nullptr, nullptr, n_cells, C_in, K2,
                            P, depth, st, counts);
  spike_accum::add_block_stats(
      st, counts, (blockIdx.x * kWarps + (threadIdx.x >> 5))
                      / st.cells_per_sample);
}

// words a warp of the packed encode takes (8 timed best of 2, 4 and 8 at
// CIFAR-10's 10x10 and 3x3 stages on an H100)
constexpr int kPackedWords = 8;

__global__ void __launch_bounds__(kWarps * 32)
fused_spike_accum_encode_packed(const int32_t* __restrict__ occ,
                                      uint32_t* __restrict__ bits, int K2,
                                      int P, int depth,
                                      int blocks_per_sample,
                                      spike_accum::EncodeStats st) {
  unsigned counts[3];
  spike_accum::encode_packed<kPackedWords>(occ, bits, K2, P, depth,
                                           blocks_per_sample, st, counts);
  spike_accum::add_block_stats(st, counts,
                               blockIdx.x / blocks_per_sample);
}

template <int K>
__global__ void
__launch_bounds__(kWarps * 32, spike_accum::min_blocks<K>())
fused_spike_accum_gather(const uint32_t* __restrict__ bits,
                         const float* __restrict__ w,
                         const float* __restrict__ w_scale,
                         const int32_t* __restrict__ cell_tot,
                         const int32_t* __restrict__ order,
                         float* __restrict__ out, int n_tasks, int C_in,
                         int n_win, int H, int W, int C_out) {
  spike_accum::gather<K, false>(bits, w, w_scale, cell_tot, order, out,
                                n_tasks, C_in, n_win, H, W, C_out);
}

// any other odd K: the rolled gather, one warp per output pixel
__global__ void __launch_bounds__(kWarps * 32)
fused_spike_accum_gather_rt(const uint32_t* __restrict__ bits,
                            const float* __restrict__ w,
                            const float* __restrict__ w_scale,
                            const int32_t* __restrict__ cell_tot,
                            const int32_t* __restrict__ order,
                            float* __restrict__ out, long long n_pix,
                            int C_in, int K, int n_win, int H, int W,
                            int C_out) {
  spike_accum::gather_rt<false>(bits, w, w_scale, cell_tot, order, out,
                                n_pix, C_in, K, n_win, H, W, C_out);
}

template <int K>
int gather(const uint32_t* bits, const void* w, void* out, int N, int C_in,
           int n_win, int H, int W, int C_out, cudaStream_t s) {
  return spike_accum::launch_gather<K, fused_spike_accum_gather<K>>(
      bits, w, nullptr, nullptr, nullptr, out, N, C_in, n_win, H, W, C_out,
      s);
}

// Encode (adding up each sample's statistics into stats, zeroed here on
// the same stream), then gather.
int run(const void* occ, const void* w, void* scratch, void* out,
        int32_t* stats, int N, int C_in, int K, int n_win, int depth, int H,
        int W, int C_out, int steps, cudaStream_t s) {
  if (K < 1 || K % 2 == 0) return (int)cudaErrorInvalidValue;
  if (steps < 1 || N % steps != 0) return (int)cudaErrorInvalidValue;
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  int err = (int)cudaMemsetAsync(stats, 0,
                                 sizeof(int32_t) * 3 * (N / steps), s);
  const int n_cells = N * C_in;
  if (err != 0 || n_cells == 0) return err;
  const spike_accum::EncodeStats st{stats, C_in * steps, K, n_win, H, W,
                                    C_out};
  const int P = n_win * n_win;
  const int32_t* o = static_cast<const int32_t*>(occ);
  if (P > 32) {
    fused_spike_accum_encode<<<(n_cells + kWarps - 1) / kWarps, kWarps * 32,
                               0, s>>>(o, bits, n_cells, C_in, K * K, P,
                                       depth, st);
  } else {
    const long long words = ((long long)C_in * steps * K * K + 32 / P - 1)
                            / (32 / P);  // a sample's
    const int bps = (int)((words + kWarps * kPackedWords - 1)
                          / (kWarps * kPackedWords));
    fused_spike_accum_encode_packed<<<(N / steps) * bps, kWarps * 32, 0,
                                      s>>>(o, bits, K * K, P, depth, bps,
                                           st);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch (K) {
    case 1: return gather<1>(bits, w, out, N, C_in, n_win, H, W, C_out, s);
    case 3: return gather<3>(bits, w, out, N, C_in, n_win, H, W, C_out, s);
    case 5: return gather<5>(bits, w, out, N, C_in, n_win, H, W, C_out, s);
    case 7: return gather<7>(bits, w, out, N, C_in, n_win, H, W, C_out, s);
    default:
      return spike_accum::launch_gather_rt(
          fused_spike_accum_gather_rt, bits, w, nullptr, nullptr, nullptr,
          out, N, C_in, K, n_win, H, W, C_out, s);
  }
}

}  // namespace

extern "C" {

// occ (N, C_in, K*K, n_win*n_win) int32, w (K, K, C_in, C_out) fp32,
// scratch N*C_in*K*K*ceil(n_win^2 / 32) uint32 (the kept bits), out (N, H,
// W, C_out) fp32, stats (N / steps, 3) int32: per sample (`steps`
// consecutive rows) its kept events, its fired positions past depth, and
// C_out x the in-bounds spans of its kept events. K odd (1, 3, 5, 7
// unrolled, any other rolled). Returns the first non-zero
// cudaGetLastError() of its launches (cudaErrorInvalidValue for an even K,
// unless steps divides N, or for a map whose staged bits do not fit a
// block's shared memory).
int fused_spike_accum(const void* occ, const void* w, void* scratch,
                      void* out, void* stats, int N, int C_in, int K,
                      int n_win, int depth, int H, int W, int C_out,
                      int steps, void* stream) {
  return run(occ, w, scratch, out, static_cast<int32_t*>(stats), N, C_in, K,
             n_win, depth, H, W, C_out, steps,
             static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory fused_spike_accum requests per gather block at
// this geometry (spike_accum.cuh's gather_smem_k).
long long fused_spike_accum_smem(int K, int n_win, int H, int W) {
  return spike_accum::gather_smem_k(K, n_win, H, W);
}

}  // extern "C"
