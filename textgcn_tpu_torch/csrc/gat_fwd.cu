// K3 on Hopper: the forward of one GAT attention direction, with the hash
// edge dropout fused in.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_gat.py::_make_agg_online_kernel
// (launcher gat_agg_online). Over a destination-sorted CSR (rowptr, col;
// the attention's edge weight is 1, so no weights are read) it computes,
// for each destination row j and its sources i,
//
//     z_ij   = leaky(s_i + d_j, 0.2)
//     mask   = keep >= 1 or hash(user, item, salt) < keep     (in {0, 1})
//     m_j    = max of z_ij over the kept edges, NEG = -2^100 if none
//     e_ij   = mask ? exp(z_ij - m_j) : 0
//     num_j  = sum_i e_ij h_i      den_j = sum_i e_ij
//
// The hash is K1's (spmm_dropout.cu, pallas_spmm.py:498-521) bit for bit,
// on the global (user, item) pair: user = row for the to-user direction,
// user = col for the to-item one. Unlike K1, a kept edge is not scaled by
// 1/keep: the mask only removes edges from the softmax.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k
// users, 25k items, ~600k edges, d = 64, f32) reads the h table (6.4 or
// 15.4 MB), the CSR (~2.6 MB), s and d (< 0.4 MB), and writes num (15.4 or
// 6.4 MB) plus den and m: ~25 MB against ~2*E*d = 77 MFLOP, so its least
// time is the bytes over the H100's 3.35 TB/s (~7.5 us). The design, kept
// simple for a first port, follows K1:
//   * one warp per destination row, so the TPU's split carry of the
//     accumulators (pallas_gat.py:218-228, 489-517) disappears: the warp
//     owns the whole row;
//   * two passes over the row's edges instead of the online rescale: pass
//     one settles m_j (each lane hashes one edge of a 32-edge strip and
//     gathers its s_i; a warp max), pass two computes each edge's e_ij in
//     its lane and broadcasts (col, e) by shuffle; every lane gathers one
//     float2 of h_i per edge (a 256-byte row at d = 64, one coalesced
//     transaction) and skips the gather of a dropped edge;
//   * the sums stay in registers and each output row is written once: no
//     atomics, a deterministic result; a row with no kept edge gives
//     num = 0, den = 0, m = NEG, so no masked edge ever adds exp(0) = 1;
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
constexpr float kNeg = -0x1p100f;   // -2^100, exact in f32
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
gat_fwd_kernel(const int32_t* __restrict__ rowptr,
               const int32_t* __restrict__ col,
               const float* __restrict__ h,
               const float* __restrict__ s,
               const float* __restrict__ d_dst,
               float* __restrict__ num,
               float* __restrict__ den,
               float* __restrict__ m_out,
               int n_dst, int d, uint32_t salt, float keep,
               int dst_is_user) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_dst) return;  // the whole warp leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];
  const bool drop = keep < 1.0f;
  const uint32_t r = static_cast<uint32_t>(row);
  const float d_row = d_dst[row];

  // pass 1: the row's max logit over its kept edges
  float m = kNeg;
  for (int e = begin + lane; e < end; e += 32) {
    const int src = col[e];
    const uint32_t sr = static_cast<uint32_t>(src);
    const bool kept = !drop || (dst_is_user ? hash_keeps(r, sr, salt, keep)
                                            : hash_keeps(sr, r, salt, keep));
    if (kept) m = fmaxf(m, leaky(s[src] + d_row));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  }

  // pass 2: e against the settled max, then the weighted gather
  float2 acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) acc[p] = make_float2(0.0f, 0.0f);
  float den_lane = 0.0f;
  for (int base = begin; base < end; base += 32) {
    const int e = base + lane;
    int src = 0;
    float w = 0.0f;
    if (e < end) {
      src = col[e];
      const uint32_t sr = static_cast<uint32_t>(src);
      const bool kept =
          !drop || (dst_is_user ? hash_keeps(r, sr, salt, keep)
                                : hash_keeps(sr, r, salt, keep));
      if (kept) w = expf(leaky(s[src] + d_row) - m);
    }
    den_lane += w;
    const int n = min(32, end - base);
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(kFullMask, w, j);
      const int sj = __shfl_sync(kFullMask, src, j);
      if (wj == 0.0f) continue;  // warp-uniform: a dropped edge adds 0
      const float* hrow = h + static_cast<size_t>(sj) * d;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        const int c = 64 * p + 2 * lane;
        if (c < d) {
          const float2 v = *reinterpret_cast<const float2*>(hrow + c);
          acc[p].x += wj * v.x;
          acc[p].y += wj * v.y;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    den_lane += __shfl_xor_sync(kFullMask, den_lane, off);
  }

  float* out = num + static_cast<size_t>(row) * d;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    if (c < d) *reinterpret_cast<float2*>(out + c) = acc[p];
  }
  if (lane == 0) {
    den[row] = den_lane;
    m_out[row] = m;
  }
}

}  // namespace

// Launches K3 on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the shapes:
// rowptr (n_dst + 1), col (rowptr[n_dst]), h (n_src, d), s (n_src),
// d_dst (n_dst), num (n_dst, d), den and m (n_dst), all contiguous on
// `device`, d even in (0, 256], n_dst > 0.
extern "C" int gat_fwd_f32(const int32_t* rowptr, const int32_t* col,
                           const float* h, const float* s,
                           const float* d_dst, float* num, float* den,
                           float* m, int n_dst, int d, uint32_t salt,
                           float keep, int dst_is_user, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gat_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, h, s, d_dst, num, den, m, n_dst, d, salt, keep,
      dst_is_user);
  return static_cast<int>(cudaGetLastError());
}
