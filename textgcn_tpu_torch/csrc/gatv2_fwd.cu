// K5 on Hopper: the forward of one GATv2 attention direction, with the
// hash edge dropout fused in.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_gat.py::_make_agg2_online_kernel
// (launcher gatv2_agg_online). Over a destination-sorted CSR (rowptr, col;
// only the structure is read) it computes, for each destination row j and
// its sources i,
//
//     u_ij   = hs_i + hd_j                               (d-vectors)
//     z_ij   = a . leaky(u_ij, 0.2)
//     mask   = keep >= 1 or hash(user, item, salt) < keep     (in {0, 1})
//     m_j    = max of z_ij over the kept edges, NEG = -2^100 if none
//     e_ij   = mask ? exp(z_ij - m_j) : 0
//     num_j  = sum_i e_ij hs_i      den_j = sum_i e_ij
//
// The hash is K1's (spmm_dropout.cu, pallas_spmm.py:498-521) bit for bit,
// on the global (user, item) pair: user = row for the to-user direction,
// user = col for the to-item one. A kept edge is not scaled by 1/keep.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k
// users, 25k items, ~545k edges, d = 64, f32) reads hs (6.4 or 15.4 MB),
// hd (15.4 or 6.4 MB), the CSR (~2.4 MB) and writes num (15.4 or 6.4 MB)
// plus den and m: ~30-40 MB against ~6 d flops per kept edge (~0.1 GFLOP),
// so its least time is the bytes over the H100's 3.35 TB/s (~10 us). The
// design, kept simple for a first port:
//   * one warp per destination row, as K3 (gat_fwd.cu): the TPU's split
//     carry, one-hot gathers and 512x512 tiles disappear, the warp owns the
//     row. hd_j and a stay in registers (one float2 per lane per 64
//     columns);
//   * ONE pass with an online softmax, not K3's max pass then sum pass.
//     Unlike K3's scalar logit, z_ij needs the whole hs_i row (a gather and
//     a warp reduction), and the message is that same row, so a second pass
//     would gather every row twice. Each kept edge gathers hs_i once (a
//     float2 per lane: one coalesced 256-byte row at d = 64), forms
//     a . leaky(u) as a butterfly of shuffles (every lane ends with the
//     same z, so the branches below are warp-uniform), and when z beats the
//     running max rescales num and den by exp(m_old - z) first;
//   * each lane hashes one edge of a 32-edge strip; a ballot gives the
//     strip's kept edges, and the warp walks only those: a dropped edge
//     costs no gather;
//   * the sums stay in registers and each output row is written once: no
//     atomics, a deterministic result; a row with no kept edge keeps
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
gatv2_fwd_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ col,
                 const float* __restrict__ hs,
                 const float* __restrict__ hd,
                 const float* __restrict__ a,
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

  const float* hdrow = hd + static_cast<size_t>(row) * d;
  float2 hd_v[kMaxPairs];
  float2 a_v[kMaxPairs];
  float2 acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    const bool in = c < d;
    hd_v[p] = in ? *reinterpret_cast<const float2*>(hdrow + c)
                 : make_float2(0.0f, 0.0f);
    a_v[p] = in ? *reinterpret_cast<const float2*>(a + c)
                : make_float2(0.0f, 0.0f);
    acc[p] = make_float2(0.0f, 0.0f);
  }
  float m = kNeg;
  float den_row = 0.0f;  // the same in every lane

  for (int base = begin; base < end; base += 32) {
    const int e = base + lane;
    int src = 0;
    bool kept = false;
    if (e < end) {
      src = col[e];
      const uint32_t sr = static_cast<uint32_t>(src);
      kept = !drop || (dst_is_user ? hash_keeps(r, sr, salt, keep)
                                   : hash_keeps(sr, r, salt, keep));
    }
    unsigned todo = __ballot_sync(kFullMask, kept);
    while (todo) {  // the strip's kept edges, in CSR order
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const int sk = __shfl_sync(kFullMask, src, k);
      const float* hsrow = hs + static_cast<size_t>(sk) * d;
      float2 hv[kMaxPairs];
      float z = 0.0f;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        const int c = 64 * p + 2 * lane;
        if (c < d) {
          hv[p] = *reinterpret_cast<const float2*>(hsrow + c);
          z += a_v[p].x * leaky(hv[p].x + hd_v[p].x) +
               a_v[p].y * leaky(hv[p].y + hd_v[p].y);
        } else {
          hv[p] = make_float2(0.0f, 0.0f);
        }
      }
      // butterfly: every lane ends with the same sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        z += __shfl_xor_sync(kFullMask, z, off);
      }
      if (z > m) {  // a new row max: rescale what was summed so far
        const float scale = expf(m - z);  // 0 for the first kept edge
#pragma unroll
        for (int p = 0; p < kMaxPairs; ++p) {
          acc[p].x *= scale;
          acc[p].y *= scale;
        }
        den_row *= scale;
        m = z;
      }
      const float w = expf(z - m);
      den_row += w;
#pragma unroll
      for (int p = 0; p < kMaxPairs; ++p) {
        acc[p].x += w * hv[p].x;
        acc[p].y += w * hv[p].y;
      }
    }
  }

  float* out = num + static_cast<size_t>(row) * d;
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    if (c < d) *reinterpret_cast<float2*>(out + c) = acc[p];
  }
  if (lane == 0) {
    den[row] = den_row;
    m_out[row] = m;
  }
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t) of `device` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the shapes:
// rowptr (n_dst + 1), col (rowptr[n_dst]), hs (n_src, d), hd (n_dst, d),
// a (d), num (n_dst, d), den and m (n_dst), all contiguous on `device`,
// d even in (0, 256], n_dst > 0.
extern "C" int gatv2_fwd_f32(const int32_t* rowptr, const int32_t* col,
                             const float* hs, const float* hd,
                             const float* a, float* num, float* den,
                             float* m, int n_dst, int d, uint32_t salt,
                             float keep, int dst_is_user, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gatv2_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, hs, hd, a, num, den, m, n_dst, d, salt, keep,
      dst_is_user);
  return static_cast<int>(cudaGetLastError());
}
