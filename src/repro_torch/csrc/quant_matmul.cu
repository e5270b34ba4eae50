// int8 x int8 -> int32 matmul with an fp32 dequant, for Hopper (sm_90a): B2.
//
// Replaces the Pallas TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (body `_kernel`). The Pallas body accumulates in fp32; this kernel follows
// the reference oracle (repro/kernels/ref.py::quant_matmul_ref) instead: an
// exact int32 accumulate, then out = float(acc) * (a_scale * b_scale), the
// scale product formed once in fp32, so it is bit-exact against the oracle
// (integer sums are exact in any order).
//
// What bounds it on an H100: on the serving path it is the SNN output head,
// M = bucket (1..64) rows of spike counts by K = 1152 by N = 10 classes,
// about 1.5 MOP on 12-85 KB. Its bytes take 0.03 us and its int8
// tensor-core ops less, so what is left is latency: how many dependent
// device-memory round trips a block makes, and on how few SMs. At a square
// (256, 256, 256) the int8 tensor-core rate and the bytes are both within a
// few microseconds, so there it is launch and latency too.
//
// Design: split K across the blocks of a thread-block cluster, so that every
// load of a call is issued at once, on many SMs.
// - Grid (m_tiles * S, n_tiles), clusters of S in {1, 2, 4, 8} blocks along
//   x: the S blocks of a cluster share one 16-row M tile and one BN-column
//   N tile (BN = 8 * NT, NT in {1, 2, 4} from N) and split the K/32 steps
//   evenly, S the smallest power of two that leaves each block at most four
//   steps (at most 8). The head's M = 64 runs 32 blocks on 32 SMs, M = 1
//   runs 8; each block walks 4 or 5 k32 steps, one or two a warp.
// - Staging: a block copies its A rows (k_len-byte spans of each row) and
//   its B rows (one contiguous k_len * N-byte span when the tile holds all
//   of N, the head's case) into shared memory with 16-byte cp.async, every
//   copy issued before the one wait; spans or bases that are not 16-byte
//   aligned (ragged K or N) copy bytes with plain loads. Zero fill pads the
//   last k32 step and the rows past M; columns past N read as zero.
// - Product: mma.sync m16n8k32 s8 x s8 -> s32 on fragments read from shared
//   memory (A row-major, 4-byte words; B bytes packed per column), the four
//   warps taking the block's k32 steps in turn.
// - Reduction: the warps' int32 partials are summed in shared memory; then
//   each block writes its 16 x BN partial into slot `rank` of the cluster
//   leader's shared memory (distributed shared memory), one cluster barrier,
//   and the leader sums the S slots and writes the dequantized fp32 tile.
//   No global workspace, no atomics, no memset, one launch; the result is
//   the same whatever the split, since integer sums are exact.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;          // warps a block
constexpr int kBM = 16;            // M rows a cluster tile
constexpr int kChunk = 256;        // K bytes staged a round (8 k32 steps)
constexpr int kLdA = kChunk + 16;  // A row stride in shared memory: 16-byte
                                   // aligned, rows 4 banks apart
constexpr int kMaxCluster = 8;
constexpr int kStepsPerBlock = 4;  // k32 steps a block aims at

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

// rows x width bytes from src (row stride src_ld) to shared dst (row stride
// dst_ld): 16-byte cp.async where the bases and strides allow it (one row
// needs no stride), the rest of each row as bytes.
__device__ __forceinline__ void stage_rows(int8_t* dst, int dst_ld,
                                           const int8_t* src, long long src_ld,
                                           int rows, int width) {
  const bool v16 =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0
      && (rows == 1 || ((src_ld | dst_ld) & 15) == 0);
  const int cpr = v16 ? width / 16 : 0;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * 16;
    cp_async16(dst + r * dst_ld + c, src + r * src_ld + c);
  }
  const int done = cpr * 16, rest = width - done;
  for (int i = threadIdx.x; i < rows * rest; i += blockDim.x) {
    const int r = i / rest, c = done + i - r * rest;
    dst[r * dst_ld + c] = src[r * src_ld + c];
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four bytes of column n at rows k..k+3 of B (row stride ld), packed
__device__ __forceinline__ uint32_t b_word(const int8_t* bs, int ld, int k,
                                           int n) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(bs) + k * ld + n;
  return p[0] | (p[ld] << 8) | (p[2 * ld] << 16) | ((uint32_t)p[3 * ld] << 24);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_cluster_kernel(const int8_t* __restrict__ a,
                            const int8_t* __restrict__ b,
                            const float* __restrict__ a_scale,
                            const float* __restrict__ b_scale,
                            float* __restrict__ out, int M, int K, int N) {
  constexpr int BN = 8 * NT;
  __shared__ __align__(16) int8_t as[kBM * kLdA];
  __shared__ __align__(16) int8_t bs[kChunk * BN];
  __shared__ int part[kWarps][kBM * BN];
  __shared__ int slots[kMaxCluster][kBM * BN];  // used in the leader only

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // every block of the cluster has started before any writes the leader's
  // shared memory: arrive now, wait just before those writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int m0 = (blockIdx.x / S) * kBM, n0 = blockIdx.y * BN;
  const int rows = min(kBM, M - m0);
  const int nw = min(BN, N - n0);   // valid columns of the tile
  const int ldb = nw == N ? N : BN;  // B's row stride in shared memory
  const int steps = (K + 31) / 32;
  const int s_beg = rank * steps / S, s_end = (rank + 1) * steps / S;

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int s0 = s_beg; s0 < s_end; s0 += kChunk / 32) {
    const int n_steps = min(kChunk / 32, s_end - s0);
    const int k0 = s0 * 32, k_len = min(n_steps * 32, K - k0);
    const int k_pad = n_steps * 32;
    stage_rows(as, kLdA, a + (size_t)m0 * K + k0, K, rows, k_len);
    if (nw == N)  // the tile holds all of N: one contiguous span
      stage_rows(bs, 0, b + (size_t)k0 * N, 0, 1, k_len * N);
    else
      stage_rows(bs, BN, b + (size_t)k0 * N + n0, N, k_len, nw);
    // zeros where no copy lands: A past k_len and past M, B past k_len
    for (int i = threadIdx.x; i < kBM * k_pad; i += blockDim.x) {
      const int r = i / k_pad, k = i - r * k_pad;
      if (r >= rows || k >= k_len) as[r * kLdA + k] = 0;
    }
    for (int i = k_len * ldb + threadIdx.x; i < k_pad * ldb; i += blockDim.x)
      bs[i] = 0;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int st = warp; st < n_steps; st += kWarps) {
      const int kb = st * 32 + t * 4;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(as + g * kLdA + kb);
      af[1] = *reinterpret_cast<const uint32_t*>(as + (g + 8) * kLdA + kb);
      af[2] = *reinterpret_cast<const uint32_t*>(as + g * kLdA + kb + 16);
      af[3] = *reinterpret_cast<const uint32_t*>(as + (g + 8) * kLdA + kb + 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + g;
        uint32_t bf[2] = {0u, 0u};
        if (n < nw) {
          bf[0] = b_word(bs, ldb, kb, n);
          bf[1] = b_word(bs, ldb, kb + 16, n);
        }
        mma_s8(acc[j], af, bf);
      }
    }
    __syncthreads();  // the next round overwrites the staged tiles
  }

  // the warps' partials: C fragment (row g or g + 8, column t*2 + e % 2)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[warp][(g + (e >> 1) * 8) * BN + j * 8 + t * 2 + (e & 1)] =
          acc[j][e];
  __syncthreads();
  int* leader_slot = cluster.map_shared_rank(&slots[rank][0], 0);
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
  for (int i = threadIdx.x; i < kBM * BN; i += blockDim.x) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += part[w][i];
    leader_slot[i] = sum;
  }
  // release the slot writes to the leader, which acquires them
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::);
  if (rank != 0) return;
  const float scale = __fmul_rn(a_scale[0], b_scale[0]);
  for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
    const int r = i / nw, c = i - r * nw;
    int sum = 0;
    for (int q = 0; q < S; ++q) sum += slots[q][r * BN + c];
    out[(size_t)(m0 + r) * N + n0 + c] =
        __fmul_rn(__int2float_rn(sum), scale);
  }
}

template <int NT>
int launch(const int8_t* a, const int8_t* b, const float* a_scale,
           const float* b_scale, float* out, int M, int K, int N,
           cudaStream_t stream) {
  const int steps = (K + 31) / 32;
  int S = 1;
  while (S < kMaxCluster && S * kStepsPerBlock < steps) S *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((M + kBM - 1) / kBM) * S),
                     (unsigned)((N + 8 * NT - 1) / (8 * NT)), 1);
  cfg.blockDim = dim3(kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, quant_matmul_cluster_kernel<NT>, a, b, a_scale, b_scale, out, M,
      K, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) int8, b (K, N) int8, a_scale/b_scale 0-d fp32 on the device,
// out (M, N) fp32; M, K, N >= 1. Returns the launch's error, else
// cudaGetLastError() after it.
int quant_matmul(const void* a, const void* b, const void* a_scale,
                 const void* b_scale, void* out, int M, int K, int N,
                 void* stream) {
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sa = static_cast<const float*>(a_scale);
  const float* sb = static_cast<const float*>(b_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 8) return launch<1>(ap, bp, sa, sb, o, M, K, N, s);
  if (N <= 16) return launch<2>(ap, bp, sa, sb, o, M, K, N, s);
  return launch<4>(ap, bp, sa, sb, o, M, K, N, s);
}

}  // extern "C"
