// K1 on Hopper: one direction of the bipartite SpMM with the hash edge
// dropout fused in.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_spmm.py::_make_dropout_kernel
// (launcher pallas_spmm_dropout). Over a destination-sorted CSR
// (rowptr, col, w) it computes
//
//     out[r] = sum_{e in row r} w_e * s_e * x[col_e]
//     s_e    = 1/keep  if keep >= 1 or hash(user_e, item_e, salt) < keep
//              0       otherwise
//
// The hash is the murmur-style finalizer of edge_dropout_scale
// (pallas_spmm.py:498-521), bit for bit, on the global (user, item) pair:
// for the to-user direction user = row and item = col, for the to-item
// direction the other way round, so a direction and its transpose drop the
// same physical edges.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k users,
// 25k items, ~600k edges, d = 64, f32) moves ~27 MB (x table, CSR ids and
// weights, output) for ~77 MFLOP, so its least time is the bytes over the
// H100's 3.35 TB/s (~8 us). The design, kept simple for a first port:
//   * one warp per destination row;
//   * each lane loads one edge's (col, w) and computes that edge's hash, and
//     the warp then broadcasts the 32 edges by shuffle, so the CSR is read
//     once and coalesced;
//   * every lane gathers a float2 of the source row per edge: 32 lanes x 8
//     bytes is one 256-byte row at d = 64, one coalesced transaction;
//   * the sums stay in registers and each output row is written once: no
//     atomics, a deterministic result, zeros for rows without edges;
//   * wider d loops over 64-column strips (d must be even).
// Shared-memory staging, async copies and several rows per warp for short
// rows are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: 1.0f / keep must round as IEEE division does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool hash_keeps(uint32_t user, uint32_t item,
                                           uint32_t salt, float keep) {
  uint32_t h = (user * 2654435761u) ^ (item * 2246822519u) ^ salt;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  // top 23 bits -> an exact f32 uniform in [0, 1)
  const float u = static_cast<float>(static_cast<int32_t>(h >> 9)) *
                  (1.0f / 8388608.0f);
  return u < keep;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_dropout_kernel(const int32_t* __restrict__ rowptr,
                    const int32_t* __restrict__ col,
                    const float* __restrict__ w,
                    const float* __restrict__ x,
                    float* __restrict__ out,
                    int n_dst, int d, uint32_t salt, float keep,
                    int dst_is_user) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];
  const bool drop = keep < 1.0f;
  const float inv_keep = 1.0f / keep;
  const uint32_t r = static_cast<uint32_t>(row);

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
        const uint32_t s = static_cast<uint32_t>(src);
        const bool kept =
            !drop || (dst_is_user ? hash_keeps(r, s, salt, keep)
                                  : hash_keeps(s, r, salt, keep));
        we = kept ? w[e] * inv_keep : 0.0f;
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
extern "C" int spmm_dropout_f32(const int32_t* rowptr, const int32_t* col,
                                const float* w, const float* x, float* out,
                                int n_dst, int d, uint32_t salt, float keep,
                                int dst_is_user, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_dropout_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, w, x, out, n_dst, d, salt, keep, dst_is_user);
  return static_cast<int>(cudaGetLastError());
}
