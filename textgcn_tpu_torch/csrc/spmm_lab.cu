// L1 on Hopper: the SpMM lab's kernel in its five modes, over the TPU's
// tiled layout.
//
// Replaces the TPU kernel of the JAX lab, tools/kernel_lab.py::make_variant
// (its pallas_call at :129). The layout is textgcn_tpu_torch/tools/
// lab_layout.py::tile_layout: destination block b owns the groups
// group_ptr[b]..group_ptr[b+1], a group holds `group` chunks of 128 slots,
// chunk q reads source block chunk_sb[q], and slot s holds
// packed = dst_local << 16 | src_local and a weight w. Each mode computes
//
//     out[row_out] += f(x[row_in] * w)        over every slot of block b
//
//   mode (int)          row_in                   row_out            f
//   0 full, merged      sb*512 + src_local       b*512 + dst_local  identity
//   1 no_gather         sb*512 + slot-in-chunk   b*512 + dst_local  identity
//   2 no_scatter        sb*512 + src_local       b*512 + slot       identity
//   3 scat_bf16         as full                  as full            to bf16
//
// with the product in f32 (a bf16 x is widened exactly first) and the sum
// in f32; "to bf16" rounds to nearest even (__float2bfloat16_rn, as
// torch's .to(torch.bfloat16) and JAX's astype do). On the TPU,
// `merged_scatter` differs from `full` only in how its one-hot matmuls
// are cut (one scatter matmul per group instead of one per chunk); with
// no one-hot matmul here the two are one function and one kernel.
//
// What bounds it: memory traffic. At the lab's shape (845,824 slots,
// x (25,088, 64), out (60,416, 64) f32) it must read the slots' packed ids
// and weights (6.8 MB) and x (3.2 MB in bf16) and write out (15.5 MB):
// ~8.6 us at 3.35 TB/s, against 0.1 GFLOP (~1.6 us at 67 TFLOP/s f32).
// Past that bound sit the gathers: each of the 600,000 real slots reads a
// 256-byte (f32) or 128-byte (bf16) row slice of x, 154 MB or 77 MB that
// x's 6.4 MB feed from the L2 cache (a source row is read by ~24 slots of
// ~24 destination blocks, so no SM sees a row twice), and every add is
// into a row that some other slot of the block may hit too.
//
// The first port (a 1,024-thread block per destination block, its 133 KB
// tile summed into with shared float atomics, every slot gathered, padding
// included) took 0.0576 ms in `full` at f32 on an H100 80GB HBM3 at 700 W.
// There atomics, not gathers, set the time (`no_gather` took as long as
// `full`). Redesigns that kept them, or that had every warp read every
// slot of a stage to find the rows it owned, were slower still. This
// design sorts instead, and adds in registers:
//   * a thread-block cluster of kCluster CTAs per (destination block,
//     64-column slice). CTA `rank` owns the block's rows with dst_local %
//     kCluster == rank (interleaved, so that no_scatter's 128 rows spread
//     over the cluster too). Two CTAs fit an SM: the 236 CTAs of the lab
//     run in one wave;
//   * the block's ids and weights stream through a ring of kStages stages
//     of kStageSlots slots in every CTA's shared memory. Each CTA's
//     producer warp arms its stage (expect_tx on its full barrier) once its
//     consumers have released it, and tells the cluster's leader (rank 0);
//     once every CTA has, the leader fetches the stage with one bulk
//     asynchronous copy per array, multicast to the whole cluster: the ids
//     leave L2 once per cluster, and no consumer waits on a global load of
//     packed or w;
//   * collect: a consumer warp takes kShare slots of each stage (all in one
//     chunk, so one source block), keeps those of its CTA's rows whose w is
//     not 0, appends them (compacted by __ballot_sync) to the epoch's list
//     in shared memory and counts them by tile row;
//   * sort: the counts' prefix sums place every kept slot by tile row
//     (a counting sort, one shared atomic a slot);
//   * walk: each half-warp takes a run of rows holding an equal share of
//     the sorted slots, gathers four columns a lane with 16-byte (f32) or
//     8-byte (bf16) loads, two batches of kRounds in flight, sums each row
//     in registers and writes it out once with 16-byte stores: no tile, no
//     atomic on the data, rows without a slot written as zeros;
//   * an epoch holds kCap kept slots; a block with more (none in the lab)
//     ends one early, and a later epoch adds its sums to the rows it
//     touches;
//   * padding slots (w = 0; 29% of the lab's slots) are neither gathered
//     nor added, in every mode: for finite x their product is +-0, and
//     adding +-0 to a sum that starts at +0 changes no bit. Their ids are
//     still read, so the bound (kernel_lab.spmm_lab_bound, which counts
//     every slot) is unchanged;
//   * every wait on an mbarrier gives up after ~2 s with __trap(): a fault
//     in the pipeline ends the launch with an error instead of hanging.
// Measured in one call on that card (tools/timing.time_ms at the lab's
// shape; f32 / bf16 `full`, ms), with kCluster and the host's constants
// edited to match: kCluster = 1 (no cluster, one 512-row block a CTA, 16
// consumer warps, kCap 8192) 0.0433 / 0.0415; kCluster = 2 0.0444 /
// 0.0421; kCluster = 4 (4 consumer warps, kCap 2048, 4 stages) 0.0487 /
// 0.0461. The cluster of two is kept: within 3% of the fastest, and the
// multicast reads a block's ids from L2 once. Half of the f32 time is the
// walk; the collection before it is not overlapped with it.
// The host mirrors these constants (kernel_lab.CLUSTER and the rest) and
// checks them against spmm_lab_config() when it loads the library.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockRows = 512;  // rows of a source or destination block
constexpr int kChunk = 128;      // slots of a chunk
constexpr int kSlice = 64;       // columns of a block's output slice
constexpr int kCluster = 2;      // CTAs of a destination block
constexpr int kTileRows = kBlockRows / kCluster;   // rows a CTA owns
constexpr int kRowBits = 8;      // log2(kTileRows)
constexpr int kConsumerWarps = 8;
constexpr int kCap = 4096;       // kept slots an epoch holds
constexpr int kStageSlots = 512;
constexpr int kShare = kStageSlots / kConsumerWarps;  // a warp's slots
constexpr int kStages = 8;
// gathers of a batch, two batches in flight: 128 bytes a lane either way
template <typename T> constexpr int kRounds = sizeof(T) == 4 ? 4 : 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr int kMinBlocks = 2;    // CTAs an SM holds: 236 in one wave
constexpr unsigned kFullMask = 0xffffffffu;
constexpr long long kWaitCycles = 4LL << 30;  // ~2 s at 1.98 GHz

static_assert(kStageSlots % kChunk == 0, "stages start on a chunk");
static_assert(kChunk % kShare == 0 && kShare % 32 == 0,
              "a warp's share lies in one chunk");
static_assert(kTileRows == 1 << kRowBits, "row bits");
static_assert(kCap >= kStageSlots, "a stage fits an empty epoch");

enum Mode { kFull = 0, kNoGather = 1, kNoScatter = 2, kScatBf16 = 3 };

struct Smem {
  int32_t packed[kStages][kStageSlots];
  float w[kStages][kStageSlots];
  // an epoch's kept slots in the order they were found, (row_in <<
  // kRowBits | tile row, w), then sorted by tile row, (row_in * d / 4, w)
  int2 found[kCap];
  int2 sorted[kCap];
  int row_start[kTileRows + 1];   // the sorted slots of each tile row
  int cursor[kTileRows];          // counts, then placement cursors
  int n_found;
  uint64_t full[kStages];    // the stage's bytes have landed
  uint64_t empty[kStages];   // this CTA's consumers released the stage
  uint64_t ready[kStages];   // (leader) every CTA armed the stage
};

// Four consecutive columns of x, widened to f32: 16 bytes of f32, 8 of bf16
template <typename T> struct Vec;

template <> struct Vec<float> {
  using Raw = float4;
  __device__ static float4 widen(const Raw& r) { return r; }
};

template <> struct Vec<__nv_bfloat16> {
  using Raw = uint2;
  // a bf16 is the high half of the f32 of the same value: exact widening
  __device__ static float4 widen(const Raw& r) {
    return make_float4(__uint_as_float(r.x << 16),
                       __uint_as_float(r.x & 0xffff0000u),
                       __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
};

// x * w rounded to f32 (no fused add), then to bf16 for scat_bf16
template <int kMode>
__device__ __forceinline__ float scaled(float v, float w) {
  const float p = __fmul_rn(v, w);
  if (kMode == kScatBf16) return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// arrive on the barrier at the same offset in CTA `rank` of the cluster
__device__ __forceinline__ void bar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n\t"
      "}"
      :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

template <bool kClusterScope>
__device__ __forceinline__ bool bar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  if (kClusterScope) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } else {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
  return done != 0;
}

// wait for the phase of `parity` to complete; kClusterScope: for arrivals
// released by other CTAs of the cluster
template <bool kClusterScope = false>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  if (bar_try<kClusterScope>(bar, parity)) return;
  const long long t0 = clock64();
  while (!bar_try<kClusterScope>(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// `bytes` from global `src` to `dst` in every CTA of `mask`, each CTA's
// barrier at the offset of `bar` counting them
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               uint32_t bytes, uint64_t* bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
         "h"(mask)
      : "memory");
}

// the consumer warps' own barrier (the producer warp never waits on it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumerWarps * 32) : "memory");
}

template <typename T, int kMode>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kThreads, kMinBlocks)
spmm_lab_kernel(const int32_t* __restrict__ group_ptr,
                const int32_t* __restrict__ chunk_sb,
                const int32_t* __restrict__ packed,
                const float* __restrict__ w,
                const T* __restrict__ x,
                float* __restrict__ out,
                int group, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int col0 = blockIdx.y * kSlice;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s0 =
      static_cast<long long>(group_ptr[b]) * group * kChunk;
  const int n_slots = static_cast<int>(
      static_cast<long long>(group_ptr[b + 1]) * group * kChunk - s0);
  const int n_stages = (n_slots + kStageSlots - 1) / kStageSlots;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);
      bar_init(&sm.empty[s], kConsumerWarps);
      bar_init(&sm.ready[s], kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm.n_found = 0;
  }
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) sm.cursor[i] = 0;
  // every CTA's barriers are set before any CTA arrives on them remotely
  // or the leader copies into them
  cluster.sync();

  if (warp == kConsumerWarps) {
    // the producer: arm each stage, and (leader) fetch it for the cluster
    if (lane == 0) {
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % kStages;
        const uint32_t use = n / kStages;
        const uint32_t bytes =
            4u * min(kStageSlots, n_slots - n * kStageSlots);
        if (use > 0) bar_wait(&sm.empty[s], (use - 1) & 1);
        bar_expect(&sm.full[s], 2 * bytes);
        bar_arrive_at(&sm.ready[s], 0);
        if (rank == 0) {
          bar_wait<true>(&sm.ready[s], use & 1);
          const long long off = s0 + static_cast<long long>(n) * kStageSlots;
          const uint16_t all = (1u << kCluster) - 1;
          bulk_multicast(sm.packed[s], packed + off, bytes, &sm.full[s], all);
          bulk_multicast(sm.w[s], w + off, bytes, &sm.full[s], all);
        }
      }
    }
    __syncwarp();
  } else {
    const unsigned lower = (1u << lane) - 1u;
    const int h = lane >> 4;           // half-warp: one task of the walk
    const int c4 = (lane & 15) * 4;    // columns c4 .. c4 + 3 of the slice
    using Raw = typename Vec<T>::Raw;
    const Raw* xv = reinterpret_cast<const Raw*>(x + col0 + c4);
    float* out_c = out + static_cast<long long>(b) * kBlockRows * d + col0 +
                   c4;
    int epoch = 0;

    // The kept slots found so far, counting-sorted by tile row, then
    // walked row by row: each half-warp takes a run of rows holding about
    // 1 / (2 kConsumerWarps) of the slots, sums each row in registers (two
    // batches of kRounds<T> gathers in flight) and writes it out. The first
    // epoch writes every row (zeros where no slot adds); a later one
    // adds its sums to the rows it touches.
    auto flush = [&]() {
      consumers_sync();
      const int n_found = sm.n_found;
      if (warp == 0) {
        // exclusive sums of the row counts: each lane a run of rows
        constexpr int kPer = kTileRows / 32;
        int c[kPer], run = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          c[k] = sm.cursor[lane * kPer + k];
          run += c[k];
        }
        int incl = run;
#pragma unroll
        for (int k = 1; k < 32; k <<= 1) {
          const int up = __shfl_up_sync(kFullMask, incl, k);
          if (lane >= k) incl += up;
        }
        int at = incl - run;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          sm.row_start[lane * kPer + k] = at;
          sm.cursor[lane * kPer + k] = at;
          at += c[k];
        }
        if (lane == 31) sm.row_start[kTileRows] = incl;
      }
      consumers_sync();
      const int quarter_d = d / 4;
      for (int i = threadIdx.x; i < n_found; i += kConsumerWarps * 32) {
        const int2 e = sm.found[i];
        const int pos = atomicAdd(&sm.cursor[e.x & (kTileRows - 1)], 1);
        sm.sorted[pos] = make_int2((e.x >> kRowBits) * quarter_d, e.y);
      }
      consumers_sync();

      // this half-warp's rows: from the first row whose slots start at or
      // after its share of the slots
      constexpr int kTasks = 2 * kConsumerWarps;
      auto first_row = [&](int k) {
        const int target = static_cast<int>(
            static_cast<long long>(n_found) * k / kTasks);
        int lo = 0, hi = kTileRows;   // the first row with start >= target
#pragma unroll
        for (int step = 0; step <= kRowBits; ++step) {
          if (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sm.row_start[mid] < target) lo = mid + 1; else hi = mid;
          }
        }
        return k == kTasks ? kTileRows : lo;
      };
      const int task = 2 * warp + h;
      const int r_end = first_row(task + 1);
      int cur = first_row(task);
      const int j_end = sm.row_start[r_end];
      int j = sm.row_start[cur];
      // both halves run the longer walk's batches
      int n_batches = (j_end - j + kRounds<T> - 1) / kRounds<T>;
      n_batches = max(n_batches, __shfl_xor_sync(kFullMask, n_batches, 16));
      int next = cur < r_end ? sm.row_start[cur + 1] : INT_MAX;

      Raw v[2][kRounds<T>];
      float wt[2][kRounds<T>];
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bool touched = false;
      auto write_row = [&]() {
        float4* o = reinterpret_cast<float4*>(
            out_c + static_cast<long long>(cur * kCluster + rank) * d);
        if (epoch == 0) {
          *o = acc;
        } else if (touched) {
          const float4 old = *o;
          *o = make_float4(old.x + acc.x, old.y + acc.y, old.z + acc.z,
                           old.w + acc.w);
        }
        acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        touched = false;
        ++cur;
        next = cur < r_end ? sm.row_start[cur + 1] : INT_MAX;
      };
      // start the gathers of sorted slots j0 .. j0 + kRounds<T> - 1 into set q
      auto issue = [&](int q, int j0) {
#pragma unroll
        for (int r = 0; r < kRounds<T>; ++r) {
          const bool valid = j0 + r < j_end;
          const int2 e = sm.sorted[valid ? j0 + r : 0];
          wt[q][r] = __int_as_float(e.y);
          v[q][r] = __ldg(xv + (valid ? e.x : 0));
        }
      };
      auto consume = [&](int q, int j0) {
#pragma unroll
        for (int r = 0; r < kRounds<T>; ++r) {
          if (j0 + r < j_end) {
            while (j0 + r >= next) write_row();
            const float4 f = Vec<T>::widen(v[q][r]);
            acc.x += scaled<kMode>(f.x, wt[q][r]);
            acc.y += scaled<kMode>(f.y, wt[q][r]);
            acc.z += scaled<kMode>(f.z, wt[q][r]);
            acc.w += scaled<kMode>(f.w, wt[q][r]);
            touched = true;
          }
        }
      };
      if (n_batches > 0) issue(0, j);
      for (int k = 0; k < n_batches; k += 2) {
        if (k + 1 < n_batches) issue(1, j + kRounds<T>);
        consume(0, j);
        if (k + 1 >= n_batches) break;
        if (k + 2 < n_batches) issue(0, j + 2 * kRounds<T>);
        consume(1, j + kRounds<T>);
        j += 2 * kRounds<T>;
      }
      while (cur < r_end) write_row();

      // the next epoch starts empty
      consumers_sync();
      for (int i = threadIdx.x; i < kTileRows; i += kConsumerWarps * 32) {
        sm.cursor[i] = 0;
      }
      if (threadIdx.x == 0) sm.n_found = 0;
      ++epoch;
      consumers_sync();
    };

    // stages that surely fit the epoch before its count must be read
    int unchecked = kCap / kStageSlots;
    for (int n = 0; n < n_stages; ++n) {
      const int s = n % kStages;
      const int first = warp * kShare;   // this warp's share of the stage
      const bool mine = first < n_slots - n * kStageSlots;
      const int sb = mine ? __ldg(chunk_sb + (s0 + static_cast<long long>(n) *
                                              kStageSlots + first) / kChunk)
                          : 0;
      bar_wait(&sm.full[s], (n / kStages) & 1);
      if (mine) {
#pragma unroll
        for (int u = 0; u < kShare / 32; ++u) {
          const int i = first + u * 32 + lane;
          const int p = sm.packed[s][i];
          const int in_chunk = i % kChunk;   // stages start on a chunk
          const int src = kMode == kNoGather ? in_chunk : (p & 0xFFFF);
          const int dst = kMode == kNoScatter ? in_chunk : (p >> 16);
          const bool owned = kCluster == 1 || dst % kCluster == rank;
          const float ws = owned ? sm.w[s][i] : 0.0f;
          const bool keep = ws != 0.0f;   // padding slots have w = 0
          const unsigned m = __ballot_sync(kFullMask, keep);
          if (m) {
            int base = 0;
            if (lane == 0) base = atomicAdd(&sm.n_found, __popc(m));
            base = __shfl_sync(kFullMask, base, 0);
            if (keep) {
              const int lr = dst / kCluster;
              sm.found[base + __popc(m & lower)] = make_int2(
                  (sb * kBlockRows + src) << kRowBits | lr,
                  __float_as_int(ws));
              atomicAdd(&sm.cursor[lr], 1);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&sm.empty[s]);
      // an epoch ends before a stage could overflow it; every warp reads
      // the count before any adds to it again
      if (--unchecked == 0 && n + 1 < n_stages) {
        consumers_sync();
        const int n_found = sm.n_found;
        consumers_sync();
        if (n_found + kStageSlots > kCap) {
          flush();
          unchecked = kCap / kStageSlots;
        } else {
          unchecked = (kCap - n_found) / kStageSlots;
        }
      }
    }
    flush();
  }
  // no CTA leaves while a copy into its cluster may be in flight
  cluster.sync();
}

template <typename T, int kMode>
cudaError_t launch(const int32_t* group_ptr, const int32_t* chunk_sb,
                   const int32_t* packed, const float* w, const void* x,
                   float* out, int n_dst_blocks, int group, int d,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      spmm_lab_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_dst_blocks * kCluster, d / kSlice);
  spmm_lab_kernel<T, kMode><<<grid, kThreads, smem, stream>>>(
      group_ptr, chunk_sb, packed, w, static_cast<const T*>(x), out, group,
      d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_mode(int mode, const int32_t* group_ptr,
                    const int32_t* chunk_sb, const int32_t* packed,
                    const float* w, const void* x, float* out,
                    int n_dst_blocks, int group, int d,
                    cudaStream_t stream) {
  switch (mode) {
    case kFull:
      return launch<T, kFull>(group_ptr, chunk_sb, packed, w, x, out,
                              n_dst_blocks, group, d, stream);
    case kNoGather:
      return launch<T, kNoGather>(group_ptr, chunk_sb, packed, w, x, out,
                                  n_dst_blocks, group, d, stream);
    case kNoScatter:
      return launch<T, kNoScatter>(group_ptr, chunk_sb, packed, w, x, out,
                                   n_dst_blocks, group, d, stream);
    case kScatBf16:
      return launch<T, kScatBf16>(group_ptr, chunk_sb, packed, w, x, out,
                                  n_dst_blocks, group, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The compiled constants, for the host's check (kernel_lab.CONFIG):
// cluster size, consumer warps, slots of a stage, stages, kept slots of an
// epoch, gathers of a batch at f32 and at bf16 x, shared bytes a CTA.
extern "C" int spmm_lab_config(int* out, int n) {
  const int v[] = {kCluster, kConsumerWarps, kStageSlots, kStages, kCap,
                   kRounds<float>, kRounds<__nv_bfloat16>,
                   static_cast<int>(sizeof(Smem))};
  const int m = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n && i < m; ++i) out[i] = v[i];
  return m;
}

// Launches one mode on `stream` (a cudaStream_t) of `device` and returns
// the CUDA error as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the layout and
// the shapes: group_ptr (n_dst_blocks + 1), chunk_sb (n_groups * group),
// packed and w (n_groups * group * 128), x (n_src_padded, d) float32
// (x_bf16 = 0) or bfloat16 (x_bf16 = 1), out (n_dst_blocks * 512, d), all
// contiguous on `device`, x and out 16-byte aligned; 64 divides d.
extern "C" int spmm_lab(const int32_t* group_ptr, const int32_t* chunk_sb,
                        const int32_t* packed, const float* w, const void* x,
                        float* out, int n_dst_blocks, int group, int d,
                        int x_bf16, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? by_mode<__nv_bfloat16>(mode, group_ptr, chunk_sb, packed, w,
                                        x, out, n_dst_blocks, group, d, s)
               : by_mode<float>(mode, group_ptr, chunk_sb, packed, w, x, out,
                                n_dst_blocks, group, d, s);
  return static_cast<int>(err);
}
