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
// does outside the TPU kernel.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k users,
// 25k items, ~545k edges, d = 64, f32) on one rank moves ~27 MB (x table,
// CSR ids and weights, output) for ~70 MFLOP, so its least time is the
// bytes over the H100's 3.35 TB/s (~8 us). A shard of W ranks reads 1/W of
// the edges and of x but still writes the whole (n_dst, d) partial, so the
// output dominates its bytes as W grows. The design is K1's without the
// hash, kept simple for a first port:
//   * one warp per destination row; an empty row writes its zeros and
//     leaves;
//   * each lane loads one edge's (col, w), coalesced, and the warp then
//     broadcasts the 32 edges by shuffle;
//   * every lane gathers a float2 of the source row per edge: 32 lanes x 8
//     bytes is one 256-byte row at d = 64, one coalesced transaction;
//   * the sums stay in registers and each output row is written once: no
//     atomics, a deterministic result. With the same weights and edge
//     order it adds in K1's order, so at keep = 1 it gives K1's bits;
//   * wider d loops over 64-column strips (d must be even).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_weighted_kernel(const int32_t* __restrict__ rowptr,
                     const int32_t* __restrict__ col,
                     const float* __restrict__ w,
                     const float* __restrict__ x,
                     float* __restrict__ out,
                     int n_dst, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];

  for (int strip = 0; strip < d; strip += 64) {
    const int c = strip + 2 * lane;
    const bool active = c < d;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int base = begin; base < end; base += 32) {
      const int e = base + lane;
      int src = 0;
      float we = 0.0f;
      if (e < end) {
        src = col[e];
        we = w[e];
      }
      const int n = min(32, end - base);
      for (int j = 0; j < n; ++j) {
        const int sj = __shfl_sync(kFullMask, src, j);
        const float wj = __shfl_sync(kFullMask, we, j);
        if (active) {
          const float2 v = *reinterpret_cast<const float2*>(
              x + static_cast<size_t>(sj) * d + c);
          acc.x += wj * v.x;
          acc.y += wj * v.y;
        }
      }
    }
    if (active) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * d + c) =
          acc;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the shapes:
// rowptr (n_dst + 1), col and w (rowptr[n_dst]), x (n_src, d) and out
// (n_dst, d), all contiguous on `device`, d even and > 0, n_dst > 0.
extern "C" int spmm_weighted_f32(const int32_t* rowptr, const int32_t* col,
                                 const float* w, const float* x, float* out,
                                 int n_dst, int d, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_weighted_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, w, x, out, n_dst, d);
  return static_cast<int>(cudaGetLastError());
}
