// Occupancy-gated sparse spike compaction + accumulation for Hopper
// (sm_90a): B3.
//
// Replaces the Pallas TPU kernel repro/kernels/spike_sparse.py::
// fused_spike_accum_sparse_pallas (body `_sparse_kernel`). It computes what
// the fused pipeline B1 (spike_pipeline.cu) computes — per row n (= sample
// * step) and input channel c, events past `depth` per (c, phase) queue of
// the occupancy (N, C_in, K*K, P) are dropped in window-row-major order,
// and each surviving event adds its K x K SAME-conv fan-out w[dy, dx, c, :]
// into the (H, W, C_out) charge — with the work gated by occupancy, and
// optionally an int-quantized accumulate. Three launches:
//
// - the encode pass of spike_accum.cuh is the gate pass: it reads the
//   occupancy once and writes the packed kept bits, per (n, c) cell its
//   kept-event total, and per row whether it holds any event;
// - a one-block pass orders the rows active-first (a stable prefix sum, as
//   the reference's ragged dispatch does), so the gather covers only the
//   first `n_rows` rows; the wrapper zero-fills the output, and rows that
//   are never gathered stay exact zeros;
// - the gather of spike_accum.cuh over those rows' output pixels, each lane
//   skipping its empty cells. The grid runs over pixels as well as rows, so
//   a few active rows still fill the card.
// - quant != 0: the weights arrive as the symmetric-quantized integers, in
//   fp32 while every sum stays below 2^24 (quant 1) and in int32 past it
//   (quant 2, summed in int32); the accumulate is exact either way
//   (spike_accum.cuh says why), and one fp32 multiply by the scale
//   dequantizes each output: bit-exact in any order.
//
// The gather adds in B1's (c, phase) order, so the fp32 result equals B1's
// bit for bit, and a row's result does not depend on the other rows of the
// batch. The scatter oracle adds offset by offset (all events' (dy, dx) =
// (0, 0) first), another order, so fp32 agrees with it and with the plain
// version to rounding only; the int path is exact in any order.
#include "spike_accum.cuh"

namespace {

using spike_accum::kWarps;
constexpr int kRowThreads = 1024;

__global__ void __launch_bounds__(kWarps * 32)
sparse_encode_kernel(const int32_t* __restrict__ occ,
                     uint32_t* __restrict__ bits,
                     int32_t* __restrict__ cell_tot,
                     int32_t* __restrict__ row_act, int n_cells, int C_in,
                     int K2, int P, int depth) {
  spike_accum::encode(occ, bits, cell_tot, row_act, n_cells, C_in, K2, P,
                      depth);
}

template <int K, bool Scaled, bool IntAcc>
__global__ void
__launch_bounds__(kWarps * 32, spike_accum::min_blocks<K>())
sparse_gather_kernel(const uint32_t* __restrict__ bits,
                     const float* __restrict__ w,
                     const float* __restrict__ w_scale,
                     const int32_t* __restrict__ cell_tot,
                     const int32_t* __restrict__ order,
                     float* __restrict__ out, int n_tasks, int C_in,
                     int n_win, int H, int W, int C_out) {
  spike_accum::gather<K, Scaled, false, float, kWarps, false, false, IntAcc>(
      bits, w, w_scale, cell_tot, order, out, n_tasks, C_in, n_win, H, W,
      C_out);
}

// any other odd K: the rolled gather, one warp per output pixel
template <bool Scaled, bool IntAcc>
__global__ void __launch_bounds__(kWarps * 32)
sparse_gather_kernel_rt(const uint32_t* __restrict__ bits,
                        const float* __restrict__ w,
                        const float* __restrict__ w_scale,
                        const int32_t* __restrict__ cell_tot,
                        const int32_t* __restrict__ order,
                        float* __restrict__ out, long long n_pix, int C_in,
                        int K, int n_win, int H, int W, int C_out) {
  spike_accum::gather_rt<Scaled, false, float, false, IntAcc>(
      bits, w, w_scale, cell_tot, order, out, n_pix, C_in, K, n_win, H, W,
      C_out);
}

template <bool Scaled, bool IntAcc>
int gather(int K, const uint32_t* bits, const void* w, const void* w_scale,
           const int32_t* cell_tot, const int32_t* order, void* out,
           int n_rows, int C_in, int n_win, int H, int W, int C_out,
           cudaStream_t s) {
  using spike_accum::launch_gather;
  switch (K) {
    case 1: return launch_gather<1, sparse_gather_kernel<1, Scaled, IntAcc>>(bits, w, w_scale, cell_tot, order, out, n_rows, C_in, n_win, H, W, C_out, s);
    case 3: return launch_gather<3, sparse_gather_kernel<3, Scaled, IntAcc>>(bits, w, w_scale, cell_tot, order, out, n_rows, C_in, n_win, H, W, C_out, s);
    case 5: return launch_gather<5, sparse_gather_kernel<5, Scaled, IntAcc>>(bits, w, w_scale, cell_tot, order, out, n_rows, C_in, n_win, H, W, C_out, s);
    case 7: return launch_gather<7, sparse_gather_kernel<7, Scaled, IntAcc>>(bits, w, w_scale, cell_tot, order, out, n_rows, C_in, n_win, H, W, C_out, s);
    default:
      return spike_accum::launch_gather_rt(
          sparse_gather_kernel_rt<Scaled, IntAcc>, bits, w, w_scale,
          cell_tot, order, out, n_rows, C_in, K, n_win, H, W, C_out, s);
  }
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

}  // namespace

extern "C" {

// occ (N, C_in, K*K, n_win*n_win) int32; w (K, K, C_in, C_out): fp32
// with quant 0; the quantized integers as fp32 with quant 1 (every |sum|
// below 2^24, summed in fp32) or as int32 with quant 2 (summed in int32),
// and then w_scale a 0-d fp32 on the device (else unused); scratch
// N*C_in*K*K*ceil(n_win^2 / 32) + N*C_in + 2*N int32 (kept bits, cell
// totals, row activity, row order); out (N, H, W, C_out) fp32, zeros in
// every row past the first n_rows active-first rows (the caller zero-fills
// it when n_rows < N). K odd (1, 3, 5, 7 unrolled, any other rolled).
// Returns the first non-zero error of its launches (cudaErrorInvalidValue
// for an even K, or for a map whose staged bits do not fit a block's
// shared memory).
int fused_spike_accum_sparse(const void* occ, const void* w,
                             const void* w_scale, void* scratch, void* out,
                             int N, int n_rows, int C_in, int K, int n_win,
                             int depth, int H, int W, int C_out, int quant,
                             void* stream) {
  if (K < 1 || K % 2 == 0 || quant < 0 || quant > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K2 = K * K, P = n_win * n_win;
  uint32_t* bits = static_cast<uint32_t*>(scratch);
  int32_t* cell_tot = reinterpret_cast<int32_t*>(
      bits + (size_t)N * C_in * K2 * ((P + 31) / 32));
  int32_t* row_act = cell_tot + (size_t)N * C_in;
  int32_t* order = row_act + N;

  int err = (int)cudaMemsetAsync(row_act, 0, sizeof(int32_t) * N, s);
  if (err != 0) return err;
  err = spike_accum::launch_encode(sparse_encode_kernel, occ, bits, cell_tot,
                                   row_act, N, C_in, K2, P, depth, s);
  if (err != 0) return err;
  sparse_rows_kernel<<<1, kRowThreads, 0, s>>>(row_act, order, N);
  err = (int)cudaGetLastError();
  if (err != 0 || n_rows == 0) return err;

  if (quant == 2)
    return gather<true, true>(K, bits, w, w_scale, cell_tot, order, out,
                              n_rows, C_in, n_win, H, W, C_out, s);
  if (quant == 1)
    return gather<true, false>(K, bits, w, w_scale, cell_tot, order, out,
                               n_rows, C_in, n_win, H, W, C_out, s);
  return gather<false, false>(K, bits, w, w_scale, cell_tot, order, out,
                              n_rows, C_in, n_win, H, W, C_out, s);
}

}  // extern "C"
