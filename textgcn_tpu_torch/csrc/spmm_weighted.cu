// K2 on Hopper: one direction of the bipartite SpMM with per-edge weights
// that the caller passes on every call.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_spmm.py::_make_kernel
// (launcher pallas_spmm). Over a destination-sorted CSR (rowptr, col) and a
// weight per edge in CSR order it computes
//
//     out[r] = sum_{e in row r} w_e * x[col_e]
//
// with zeros for rows that have no edge. The mesh path
// (parallel/sharded_spmm.py) runs it on one rank's source-row shard: `col`
// holds local source rows, `x` the rank's slice of the source table, and
// the CSR spans the full padded destination range, so that the partial
// output can be reduce-scattered over the ranks. The caller has already
// multiplied the hash dropout mask into `w`, as pallas_sharded.py:236-237
// does outside the TPU kernel, so at dropout 0.4 about 40% of the weights
// are exactly 0.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k users,
// 25k items, ~545k edges, d = 64, f32) on one rank moves ~27 MB (x table,
// CSR ids and weights, output) for ~70 MFLOP, so its least time is the
// bytes over the H100's 3.35 TB/s (~8 us). A shard of W ranks reads 1/W of
// the edges and of x but still writes the whole (n_dst, d) partial, so the
// output dominates its bytes as W grows.
//
// What the first design (one warp per row, one float2 per lane, every
// edge's row gathered one at a time, zero weights included) measured on an
// H100 80GB HBM3 at a 700 W power limit (PERF.md, section 6), a layer (both
// directions) on S1: 0.0547 ms at keep 1 and 0.0549 ms with the keep-0.6
// mask in the weights at W = 1, 0.0283 / 0.0282 ms per shard at W = 4.
// There an empty kernel over the same grid took 0.0126 ms and a kernel that
// only writes the zeros 0.0152 ms per shard, and reading 256 cached rows in
// place of the edges' rows took 23% off at keep 1. This design is K1's
// (spmm_dropout.cu) without the hash, with its rows walked grid-stride and
// each group's next row loaded while the current one runs: 0.0388 ms at
// keep 0.6 and 0.0524 at keep 1 at W = 1, 0.0222 / 0.0254 ms per shard at
// W = 4. K1's walk as it is ran 2% slower at W = 1 and 6% at W = 4;
// two float4 a lane on 8 lanes, a quarter-warp a row and four gathers in
// flight gained nothing over it:
//   * a group of kLanes lanes per destination row, one kVec-float vector a
//     lane: at d = 64 a half-warp reads a whole 256-byte row with 16-byte
//     float4 loads, and a warp works on two rows;
//   * the rows are walked grid-stride over as many blocks as the card holds
//     at once; a group loads its next row's rowptr pair when it starts a
//     row and that row's first strip of (col, w) during the current row's
//     last strip, so the chain rowptr -> col -> x of a short row overlaps
//     the work of the one before;
//   * each lane loads one edge of a kLanes-edge strip (col, w), coalesced; a
//     ballot gives the strip's edges whose weight is not 0, and the group
//     walks only those, kUnroll at a time: the kUnroll gathers are issued
//     before their FMAs; the next strip's (col, w) are loaded before this
//     strip's gathers;
//   * an edge whose weight is 0 (dropped by the mask) is skipped, its row
//     never read. It would add 0 * x = +-0 to a sum that is never -0, which
//     changes no bit for finite x;
//   * each output element is acc = fmaf(w_e, x[col_e][c], acc) over the
//     row's edges in CSR order, as K1 adds w_e / keep: with the mask
//     multiplied into the weights the two give the same bits at any keep.
//     No row's edges are split;
//   * the sums stay in registers and each output row is written once: no
//     atomics, zeros for rows without edges;
//   * any even d: float4 when d % 4 == 0 and x and out are 16-byte aligned,
//     else float2 (the wrapper picks with K1's rule, ops/spmm.k1_layout);
//     a d wider than kLanes * kVec is cut into column strips of that width,
//     one a grid row (blockIdx.y), each walking the row's edges: a column
//     loop inside the kernel cost 8% at d = 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 2;   // gathers a group issues at once
constexpr int kMinBlocks = 4;   // with it every instance needs no spill

template <int kVec> struct Vec;
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T fma(float w, T v, T acc) {
    return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T fma(float w, T v, T acc) {
    return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y),
                       fmaf(w, v.z, acc.z), fmaf(w, v.w, acc.w));
  }
};

template <int kVec, int kLanes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
spmm_weighted_kernel(const int32_t* __restrict__ rowptr,
                     const int32_t* __restrict__ col,
                     const float* __restrict__ w,
                     const float* __restrict__ x,
                     float* __restrict__ out,
                     int n_dst, int d) {
  using V = typename Vec<kVec>::T;
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const int shift = lane - sub;   // the group's first lane
  const unsigned group_mask =
      kLanes == 32 ? 0xffffffffu : ((1u << kLanes) - 1u) << shift;
  // blockIdx.y picks the strip of kLanes * kVec columns
  const int c = blockIdx.y * (kLanes * kVec) + kVec * sub;
  const bool active = c < d;
  const int row_step = gridDim.x * kWarpsPerBlock * kGroups;
  int row = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kGroups +
            shift / kLanes;
  if (row >= n_dst) return;  // the whole group leaves together

  // the group's next row: its edge range and its first strip of (col, w)
  int next_begin = rowptr[row];
  int next_end = rowptr[row + 1];
  int next_src = 0;
  float next_w = 0.0f;
  if (next_begin + sub < next_end) {
    next_src = col[next_begin + sub];
    next_w = w[next_begin + sub];
  }
  for (; row < n_dst; row += row_step) {  // group-uniform
    const int begin = next_begin;
    const int end = next_end;
    next_begin = next_end = 0;
    if (row + row_step < n_dst) {
      next_begin = rowptr[row + row_step];
      next_end = rowptr[row + row_step + 1];
    }
    if (begin == end && next_begin + sub < next_end) {
      next_src = col[next_begin + sub];
      next_w = w[next_begin + sub];
    }
    V acc = Vec<kVec>::zero();
    for (int base = begin; base < end; base += kLanes) {  // group-uniform
      const int src = next_src;
      const float we = next_w;
      const bool kept = base + sub < end && we != 0.0f;
      // the (col, w) the group reads after these, early: the row's next
      // strip of edges, or the next row's first
      if (base + kLanes < end) {
        if (base + kLanes + sub < end) {
          next_src = col[base + kLanes + sub];
          next_w = w[base + kLanes + sub];
        }
      } else if (next_begin + sub < next_end) {
        next_src = col[next_begin + sub];
        next_w = w[next_begin + sub];
      }
      // the group's bits only: the ballot may report other active lanes
      unsigned todo = (__ballot_sync(group_mask, kept) & group_mask) >> shift;
      while (todo) {  // the strip's edges of nonzero weight, in CSR order
        const int n = __popc(todo);  // of which this round takes kUnroll
        int sj[kUnroll];
        float wj[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = (__ffs(todo) - 1) & (kLanes - 1);
          todo &= todo - 1;
          sj[u] = __shfl_sync(group_mask, src, k, kLanes);
          wj[u] = __shfl_sync(group_mask, we, k, kLanes);
        }
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = Vec<kVec>::zero();
          if (u < n && active) {
            v[u] = *reinterpret_cast<const V*>(
                x + static_cast<size_t>(sj[u]) * d + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < n) acc = Vec<kVec>::fma(wj[u], v[u], acc);
        }
      }
    }
    if (active) {
      *reinterpret_cast<V*>(out + static_cast<size_t>(row) * d + c) = acc;
    }
  }
}

template <int kVec, int kLanes>
cudaError_t launch(const int32_t* rowptr, const int32_t* col, const float* w,
                   const float* x, float* out, int n_dst, int d, int device,
                   cudaStream_t stream) {
  // the blocks the card holds at once, found once per device and instance
  static int resident[64] = {0};
  int& max_blocks = resident[device & 63];
  if (max_blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spmm_weighted_kernel<kVec, kLanes>, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int kRowsPerBlock = kWarpsPerBlock * (32 / kLanes);
  const int strips = (d + kLanes * kVec - 1) / (kLanes * kVec);
  const int needed = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  const int resident_rows = max_blocks / strips > 0 ? max_blocks / strips : 1;
  const dim3 grid(needed < resident_rows ? needed : resident_rows, strips);
  spmm_weighted_kernel<kVec, kLanes><<<grid, kWarpsPerBlock * 32, 0,
                                       stream>>>(rowptr, col, w, x, out,
                                                 n_dst, d);
  return cudaGetLastError();
}

}  // namespace

// Launches K2 on `stream` (a cudaStream_t) of `device` and returns the first
// CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, lanes) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: rowptr (n_dst + 1), col and w (rowptr[n_dst]), x (n_src, d) and
// out (n_dst, d), all contiguous on `device`, d even and > 0, n_dst > 0;
// and picked vec in {2, 4} (4: d % 4 == 0, x and out 16-byte aligned) and
// lanes in {8, 16, 32}, the lanes that share a row.
extern "C" int spmm_weighted_f32(const int32_t* rowptr, const int32_t* col,
                                 const float* w, const float* x, float* out,
                                 int n_dst, int d, int vec, int lanes,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_LAUNCH(V, L) \
  launch<V, L>(rowptr, col, w, x, out, n_dst, d, device, s)
  switch (vec * 100 + lanes) {
    case 208: err = K2_LAUNCH(2, 8); break;
    case 216: err = K2_LAUNCH(2, 16); break;
    case 232: err = K2_LAUNCH(2, 32); break;
    case 408: err = K2_LAUNCH(4, 8); break;
    case 416: err = K2_LAUNCH(4, 16); break;
    case 432: err = K2_LAUNCH(4, 32); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K2_LAUNCH
  return static_cast<int>(err);
}
