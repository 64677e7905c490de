// K4 on Hopper: the backward of one GAT attention direction (K3), with the
// hash edge dropout fused in.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_gat.py::_make_bwd_src_kernel
// (launcher gat_bwd_src, called from _gas_bwd). With the shift m held
// constant (softmax shift invariance) the gradient of K3's (num, den) is
//
//     e_ij  = mask ? exp(leaky(s_i + d_j) - m_j) : 0       (recomputed)
//     dz_ij = e_ij * (g_num_j . h_i + g_den_j) * leaky'(s_i + d_j)
//     dh_i  = sum_j e_ij g_num_j      ds_i = sum_j dz_ij      dd_j = sum_i dz_ij
//
// with leaky'(z) = 1 for z >= 0 (jax.nn.leaky_relu's convention) and 0.2
// below, and m_j the forward's saved edge max. It runs over the TRANSPOSE
// CSR of the forward direction: row i is a forward source, its columns
// are the forward destinations j. The mask is K1's hash, bit for bit, on
// the global (user, item) pair; the transpose flips which of row and
// column is the user, so both passes drop the same edges.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k
// users, 25k items, ~600k edges, d = 64, f32) reads g_num and h (6.4 and
// 15.4 MB), the transpose CSR (~2.6 MB) and five scalar vectors (< 0.7
// MB), and writes dh (6.4 or 15.4 MB) plus ds and dd: ~32 MB against
// ~4*E*d = 154 MFLOP, so its least time is the bytes over the H100's
// 3.35 TB/s (~10 us). The design, kept simple for a first port:
//   * one warp per row i holds h_i in registers (one float2 per lane per
//     64 columns) and walks the row's edges in 32-edge strips: each lane
//     hashes one edge and gathers its d_j, m_j and g_den_j and computes
//     e_ij; the warp then takes the strip's edges one by one (broadcast by
//     shuffle), every lane gathering one float2 of g_num_j (a 256-byte
//     row at d = 64, one coalesced transaction) into dh_i and into its part
//     of the dot g_num_j . h_i, which a butterfly of shuffles completes;
//   * dh_i and ds_i stay in registers and are written once;
//   * dd_j sums over the other axis: lane 0 adds each edge's dz_ij with one
//     float atomicAdd into a zeroed dd (600k atomics spread over 25k or
//     60k addresses per direction at S1). That is one launch and no second
//     pass over the forward CSR, but dd's summation order changes from run
//     to run: dd agrees with the plain version to f32 rounding of sums of
//     up to ~100 terms, not bit for bit;
//   * a dropped edge (e = 0) is skipped, warp-uniformly;
//   * d is even and at most 256 (up to four float2 per lane).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: expf stays the accurate one (not __expf).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPairs = 4;             // float2 per lane: d <= 256
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kSlope = 0.2f;

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

__device__ __forceinline__ float leaky(float z) {
  return z >= 0.0f ? z : kSlope * z;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_kernel(const int32_t* __restrict__ rowptr,
               const int32_t* __restrict__ col,
               const float* __restrict__ h,
               const float* __restrict__ s,
               const float* __restrict__ d_dst,
               const float* __restrict__ m_dst,
               const float* __restrict__ g_num,
               const float* __restrict__ g_den,
               float* __restrict__ dh,
               float* __restrict__ ds,
               float* __restrict__ dd,
               int n_rows, int d, uint32_t salt, float keep,
               int row_is_user) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];
  const bool drop = keep < 1.0f;
  const uint32_t r = static_cast<uint32_t>(row);
  const float s_row = s[row];

  const float* hrow = h + static_cast<size_t>(row) * d;
  float2 hv[kMaxPairs];
  float2 acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    hv[p] = c < d ? *reinterpret_cast<const float2*>(hrow + c)
                  : make_float2(0.0f, 0.0f);
    acc[p] = make_float2(0.0f, 0.0f);
  }
  float ds_row = 0.0f;

  for (int base = begin; base < end; base += 32) {
    const int e = base + lane;
    int j = 0;
    float w = 0.0f, slope = 0.0f, gden = 0.0f;
    if (e < end) {
      j = col[e];
      const uint32_t cj = static_cast<uint32_t>(j);
      const bool kept =
          !drop || (row_is_user ? hash_keeps(r, cj, salt, keep)
                                : hash_keeps(cj, r, salt, keep));
      if (kept) {
        const float z = s_row + d_dst[j];
        w = expf(leaky(z) - m_dst[j]);
        slope = z >= 0.0f ? 1.0f : kSlope;
        gden = g_den[j];
      }
    }
    const int n = min(32, end - base);
    for (int k = 0; k < n; ++k) {
      const float wk = __shfl_sync(kFullMask, w, k);
      const int jk = __shfl_sync(kFullMask, j, k);
      const float slope_k = __shfl_sync(kFullMask, slope, k);
      const float gden_k = __shfl_sync(kFullMask, gden, k);
      if (wk == 0.0f) continue;  // warp-uniform: a dropped edge adds 0
      const float* grow = g_num + static_cast<size_t>(jk) * d;
      float dot = 0.0f;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        const int c = 64 * p + 2 * lane;
        if (c < d) {
          const float2 g = *reinterpret_cast<const float2*>(grow + c);
          acc[p].x += wk * g.x;
          acc[p].y += wk * g.y;
          dot += g.x * hv[p].x + g.y * hv[p].y;
        }
      }
      // butterfly: every lane ends with the same sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(kFullMask, dot, off);
      }
      const float dz = wk * (dot + gden_k) * slope_k;
      ds_row += dz;
      if (lane == 0) atomicAdd(dd + jk, dz);
    }
  }

  float* out = dh + static_cast<size_t>(row) * d;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    if (c < d) *reinterpret_cast<float2*>(out + c) = acc[p];
  }
  if (lane == 0) ds[row] = ds_row;
}

}  // namespace

// Launches K4 on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the shapes:
// over the transpose CSR rowptr (n_rows + 1) and col (rowptr[n_rows]),
// h (n_rows, d), s (n_rows), d_dst, m_dst, g_den and dd (n_cols),
// g_num (n_cols, d), dh (n_rows, d), ds (n_rows), all contiguous on
// `device`, dd zeroed, d even in (0, 256], n_rows > 0.
extern "C" int gat_bwd_f32(const int32_t* rowptr, const int32_t* col,
                           const float* h, const float* s,
                           const float* d_dst, const float* m_dst,
                           const float* g_num, const float* g_den,
                           float* dh, float* ds, float* dd, int n_rows,
                           int d, uint32_t salt, float keep,
                           int row_is_user, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gat_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, h, s, d_dst, m_dst, g_num, g_den, dh, ds, dd, n_rows, d,
      salt, keep, row_is_user);
  return static_cast<int>(cudaGetLastError());
}
