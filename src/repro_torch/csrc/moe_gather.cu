// MoE dispatch row gather for Hopper (sm_90a): B6.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gather.py::moe_gather
// (body `_kernel`): capacity slot s receives row indices[s] of the token
// activations x (T, d), or zeros where the index is negative; an index past
// the last row is clamped to it (the reference oracle's clip). The TPU
// kernel prefetches the indices as scalars and copies block_rows rows per
// grid step.
//
// What bounds it on an H100: device-memory bytes, the gathered rows read
// once and the S rows written once; there is no arithmetic. At small sizes
// (kernel_bench's 512 rows of 512 B) it is two dependent latencies, the
// index and then the row, plus the launch.
//
// Design. A row longer than one 16-byte unit a lane (512 B), with its size
// and both bases 16-byte aligned, goes through the Tensor Memory
// Accelerator: a persistent grid of up to two blocks an SM, each owning a
// contiguous range of slots, loads its range's indices into shared memory
// (coalesced, before any row moves) and writes its zero rows with 16-byte
// stores; then one thread drives bulk copies through a ring of kStages
// shared-memory stages. A stage holds a unit (up to kStageBytes: several
// whole rows, or one piece of a longer row), filled by one cp.async.bulk
// global -> shared per row that completes on the stage's mbarrier, and
// emptied by cp.async.bulk shared -> global stores, a run of consecutive
// valid rows in one store. Loads of the next kStages - 1 units stay in
// flight while a unit is stored, and a stage is refilled as soon as its
// stores have read it, so many rows are in flight an SM without a register
// of theirs. The loads ask L2 to keep x (evict_last: a row that several
// slots take is read from DRAM once) and the stores to let the output go
// first (evict_first), so the streamed output does not push x out. Other
// rows take a warp copy (one warp a slot, consecutive lanes on consecutive
// units of the widest size, 16 to 1 bytes, that the row size and both
// bases allow): a row that fits one unit a lane moves in one load and one
// store a lane, and staging it through shared memory would only add the
// bulk copy's latency. Every copy is exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kStageBytes = 16384;
constexpr int kMaxSlots = 2048;  // slots a block owns at most
constexpr int kWarps = 8;        // slots a block of the warp copy

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one unit: rows [s, s + n) of the block's slots, bytes [off, off + len) of
// each (whole rows, off = 0; or one piece of one row)
struct Unit {
  int s, n, off, len;
};

__device__ __forceinline__ Unit unit_of(int u, int n_slots, int rows_per,
                                        int pieces, int row_bytes) {
  if (pieces == 1) {
    const int s = u * rows_per;
    return {s, min(rows_per, n_slots - s), 0, row_bytes};
  }
  const int off = (u % pieces) * kStageBytes;
  return {u / pieces, 1, off, min(kStageBytes, row_bytes - off)};
}

// Grid: the persistent blocks, slot range of block b [b * S / G, (b + 1) * S
// / G). Dynamic shared memory: kStages stages of stage_bytes, then the
// indices.
__global__ void __launch_bounds__(kThreads)
moe_gather_bulk_kernel(const char* __restrict__ x,
                       const int32_t* __restrict__ idx,
                       char* __restrict__ out, int T, int S, int row_bytes,
                       int rows_per, int pieces, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  int32_t* tok = reinterpret_cast<int32_t*>(smem + kStages * stage_bytes);
  const int s_lo = (int)((long long)blockIdx.x * S / gridDim.x);
  const int s_hi = (int)((long long)(blockIdx.x + 1) * S / gridDim.x);
  const int n_slots = s_hi - s_lo;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[i])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  bool neg = false;
  for (int i = threadIdx.x; i < n_slots; i += kThreads) {
    const int v = idx[s_lo + i];
    tok[i] = v < 0 ? -1 : min(v, T - 1);
    neg |= v < 0;
  }
  if (__syncthreads_or(neg)) {  // zero rows: 16-byte stores, every thread
    const int units = row_bytes / 16;
    for (int i = 0; i < n_slots; ++i) {
      if (tok[i] >= 0) continue;
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)(s_lo + i)
                                            * row_bytes);
      for (int k = threadIdx.x; k < units; k += kThreads)
        dst[k] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (threadIdx.x != 0) return;

  uint64_t keep, stream;  // L2 policies: keep x, stream the output
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(keep));
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(stream));
  const int n_units = pieces == 1 ? (n_slots + rows_per - 1) / rows_per
                                  : n_slots * pieces;
  auto load = [&](int u) {
    const Unit un = unit_of(u, n_slots, rows_per, pieces, row_bytes);
    unsigned char* st = smem + (u % kStages) * stage_bytes;
    const unsigned bar = smem_addr(&full[u % kStages]);
    int bytes = 0;
    for (int j = 0; j < un.n; ++j) bytes += tok[un.s + j] >= 0 ? un.len : 0;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(bar), "r"(bytes) : "memory");
    for (int j = 0; j < un.n; ++j) {
      const int r = tok[un.s + j];
      if (r < 0) continue;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
          :: "r"(smem_addr(st + j * un.len)),
             "l"(x + (size_t)r * row_bytes + un.off), "r"(un.len), "r"(bar),
             "l"(keep)
          : "memory");
    }
  };
  for (int u = 0; u < min(kStages, n_units); ++u) load(u);
  for (int u = 0; u < n_units; ++u) {
    mbar_wait(&full[u % kStages], (u / kStages) & 1);
    const Unit un = unit_of(u, n_slots, rows_per, pieces, row_bytes);
    const unsigned char* st = smem + (u % kStages) * stage_bytes;
    for (int j = 0; j < un.n;) {
      if (tok[un.s + j] < 0) {  // written above
        ++j;
        continue;
      }
      int run = 1;  // consecutive valid rows: consecutive in the stage too
      while (j + run < un.n && tok[un.s + j + run] >= 0) ++run;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
          " [%0], [%1], %2, %3;\n"
          :: "l"(out + (size_t)(s_lo + un.s + j) * row_bytes + un.off),
             "r"(smem_addr(st + j * un.len)), "r"(run * un.len),
             "l"(stream)
          : "memory");
      j += run;
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage of unit u - 1 once its stores have read it
    if (u >= 1 && u - 1 + kStages < n_units) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(u - 1 + kStages);
    }
  }
  // the stores must have read shared memory before the block exits; their
  // writes complete by the end of the grid
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
moe_gather_warp_kernel(const char* __restrict__ x,
                       const int32_t* __restrict__ idx,
                       char* __restrict__ out, int T, int S, int row_bytes) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= S) return;  // warp-uniform
  const int n = row_bytes / (int)sizeof(V);
  V* dst = reinterpret_cast<V*>(out + (size_t)s * row_bytes);
  const int tok = idx[s];
  if (tok < 0) {
    const V zero{};
    for (int i = lane; i < n; i += 32) dst[i] = zero;
    return;
  }
  const V* src = reinterpret_cast<const V*>(
      x + (size_t)min(tok, T - 1) * row_bytes);
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

template <typename V>
int launch_warp(const void* x, const void* idx, void* out, int T, int S,
                int row_bytes, cudaStream_t stream) {
  moe_gather_warp_kernel<V>
      <<<(S + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          static_cast<const char*>(x), static_cast<const int32_t*>(idx),
          static_cast<char*>(out), T, S, row_bytes);
  return (int)cudaGetLastError();
}

int launch_bulk(const void* x, const void* idx, void* out, int T, int S,
                int row_bytes, cudaStream_t stream) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = 2LL * sms;
  if (grid > S) grid = S;
  if (grid < (S + kMaxSlots - 1) / kMaxSlots)
    grid = (S + kMaxSlots - 1) / kMaxSlots;
  const int per_block = (int)((S + grid - 1) / grid);
  int rows_per = 1, pieces = 1, stage_bytes = kStageBytes;
  if (row_bytes <= kStageBytes) {
    rows_per = min(kStageBytes / row_bytes, per_block);
    stage_bytes = rows_per * row_bytes;
  } else {
    pieces = (row_bytes + kStageBytes - 1) / kStageBytes;
  }
  const size_t smem =
      (size_t)kStages * stage_bytes + sizeof(int32_t) * per_block;
  static bool opted_in[per_device::kMaxDevices] = {};
  const int err = per_device::once(opted_in, [] {
    return cudaFuncSetAttribute(
        moe_gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStages * kStageBytes + (int)sizeof(int32_t) * kMaxSlots);
  });
  if (err) return err;
  moe_gather_bulk_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const char*>(x), static_cast<const int32_t*>(idx),
      static_cast<char*>(out), T, S, row_bytes, rows_per, pieces,
      stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (T, row_bytes bytes), idx (S,) int32 -> out (S, row_bytes bytes); T,
// S, row_bytes >= 1; vec in {16, 8, 4, 2, 1} divides row_bytes and both
// pointers; rows of 16-byte units longer than 32 of them take the bulk
// copies. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for another vec).
int moe_gather(const void* x, const void* idx, void* out, int T, int S,
               int row_bytes, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16:
      if (row_bytes > 16 * 32)
        return launch_bulk(x, idx, out, T, S, row_bytes, st);
      return launch_warp<uint4>(x, idx, out, T, S, row_bytes, st);
    case 8: return launch_warp<uint2>(x, idx, out, T, S, row_bytes, st);
    case 4: return launch_warp<uint32_t>(x, idx, out, T, S, row_bytes, st);
    case 2: return launch_warp<uint16_t>(x, idx, out, T, S, row_bytes, st);
    case 1: return launch_warp<uint8_t>(x, idx, out, T, S, row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
