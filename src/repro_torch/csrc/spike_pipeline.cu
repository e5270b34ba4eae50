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
// occupancy into packed kept bits (read once, coalesced), and the
// barrier-free gather adds, per output element, the kept events' weights in
// (c, phase) order — the order of the scatter form this kernel had before,
// so its fp32 result is unchanged bit for bit, and a row's result depends
// only on that row's inputs. The header says why that order is possible
// without a shared charge map, and what bounds the kernel.
#include "spike_accum.cuh"

namespace {

using spike_accum::kWarps;

__global__ void __launch_bounds__(kWarps * 32)
fused_spike_accum_encode(const int32_t* __restrict__ occ,
                         uint32_t* __restrict__ bits,
                         int32_t* __restrict__ cell_tot,
                         int32_t* __restrict__ row_act, int n_cells,
                         int C_in, int K2, int P, int depth) {
  spike_accum::encode(occ, bits, cell_tot, row_act, n_cells, C_in, K2, P,
                      depth);
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

}  // namespace

extern "C" {

// occ (N, C_in, K*K, n_win*n_win) int32, w (K, K, C_in, C_out) fp32,
// scratch N*C_in*K*K*ceil(n_win^2 / 32) uint32 (the kept bits), out (N, H,
// W, C_out) fp32; K odd (1, 3, 5, 7 unrolled, any other rolled). Returns
// the first non-zero cudaGetLastError() of its launches
// (cudaErrorInvalidValue for an even K, or for a map whose staged bits do
// not fit a block's shared memory).
int fused_spike_accum(const void* occ, const void* w, void* scratch,
                      void* out, int N, int C_in, int K, int n_win,
                      int depth, int H, int W, int C_out, void* stream) {
  if (K < 1 || K % 2 == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  const int err = spike_accum::launch_encode(
      fused_spike_accum_encode, occ, bits, nullptr, nullptr, N, C_in, K * K,
      n_win * n_win, depth, s);
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

// The dynamic shared memory fused_spike_accum requests per gather block at
// this geometry (spike_accum.cuh's gather_smem_k).
long long fused_spike_accum_smem(int K, int n_win, int H, int W) {
  return spike_accum::gather_smem_k(K, n_win, H, W);
}

}  // extern "C"
