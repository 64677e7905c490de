// K6 on Hopper: the backward of one GATv2 attention direction (K5), with
// the hash edge dropout fused in.
//
// Replaces the TPU kernel textgcn_tpu/ops/pallas_gat.py::_make_bwd2_src_kernel
// (launcher gatv2_bwd_src, called from _g2s_bwd). With the shift m held
// constant (softmax shift invariance) the gradient of K5's (num, den) is
//
//     u_ij   = hs_i + hd_j,    lk_ij = leaky(u_ij),    z_ij = a . lk_ij
//     e_ij   = mask ? exp(z_ij - m_j) : 0                    (recomputed)
//     dz_ij  = e_ij * (g_num_j . hs_i + g_den_j)
//     lam_ij = leaky'(u_ij) * a                             (a d-vector)
//     dhs_i  = sum_j (e_ij g_num_j + dz_ij lam_ij)
//     dhd_j  = sum_i dz_ij lam_ij
//     da     = sum_ij dz_ij lk_ij
//
// with leaky'(u) = 1 for u >= 0 (jax.nn.leaky_relu's convention) and 0.2
// below, and m_j the forward's saved edge max. It runs over the TRANSPOSE
// CSR of the forward direction: row i is a forward source, its columns
// are the forward destinations j. The mask is K1's hash, bit for bit, on
// the global (user, item) pair; the transpose flips which of row and
// column is the user, so both passes drop the same edges.
//
// What bounds it: memory traffic. One direction of the S1 graph (60k
// users, 25k items, ~545k edges, d = 64, f32) reads hs (6.4 or 15.4 MB),
// hd and g_num (15.4 or 6.4 MB each), the transpose CSR (~2.4 MB) and two
// scalar vectors, and writes dhs and dhd: ~50-60 MB against ~15 d flops
// per kept edge (~0.3 GFLOP), so its least time is the bytes over the
// H100's 3.35 TB/s (~17 us). The design, kept simple for a first port:
//   * one warp per forward source row i, as K4 (gat_bwd.cu), holding hs_i
//     and a in registers (a float2 per lane per 64 columns); the warps walk
//     the rows grid-stride, with as many blocks as the card holds at once;
//   * each lane hashes one edge of a 32-edge strip and fetches its m_j and
//     g_den_j; a ballot gives the strip's kept edges and the warp walks
//     only those: per edge every lane gathers one float2 of hd_j and of
//     g_num_j (256-byte rows at d = 64, coalesced), and two butterflies of
//     shuffles complete z_ij and g_num_j . hs_i in every lane;
//   * dhs_i sums in registers and is written once;
//   * dhd_j sums over the other axis. Of the two designs, d float
//     atomicAdds per kept edge into a zeroed dhd (as K4's dd), or a second
//     launch over the forward CSR (one warp per j, deterministic), this
//     kernel takes the atomics: the second launch would repeat the gathers
//     of hs_i, hd_j and g_num_j and the two reductions of every edge, about
//     doubling K6's traffic, to save 64 atomics per edge that a warp issues
//     to one contiguous 256-byte row. dhd's summation order then changes
//     from run to run: it agrees with the plain version to f32 rounding of
//     sums of up to ~100 terms, not bit for bit;
//   * da sums per lane in registers over all the warp's edges, then over
//     the block's warps in shared memory, then one float atomicAdd per
//     column per block into a zeroed da: the grid-stride loop keeps the
//     blocks, and so the atomics on those d addresses, few;
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
gatv2_bwd_kernel(const int32_t* __restrict__ rowptr,
                 const int32_t* __restrict__ col,
                 const float* __restrict__ hs,
                 const float* __restrict__ hd,
                 const float* __restrict__ a,
                 const float* __restrict__ m_dst,
                 const float* __restrict__ g_num,
                 const float* __restrict__ g_den,
                 float* __restrict__ dhs,
                 float* __restrict__ dhd,
                 float* __restrict__ da,
                 int n_rows, int d, uint32_t salt, float keep,
                 int row_is_user) {
  __shared__ float2 da_part[kWarpsPerBlock][kMaxPairs * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool drop = keep < 1.0f;

  float2 a_v[kMaxPairs];
  float2 da_acc[kMaxPairs];
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    const int c = 64 * p + 2 * lane;
    a_v[p] = c < d ? *reinterpret_cast<const float2*>(a + c)
                   : make_float2(0.0f, 0.0f);
    da_acc[p] = make_float2(0.0f, 0.0f);
  }

  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n_rows;
       row += gridDim.x * kWarpsPerBlock) {  // warp-uniform
    const int begin = rowptr[row];
    const int end = rowptr[row + 1];
    const uint32_t r = static_cast<uint32_t>(row);
    const float* hsrow = hs + static_cast<size_t>(row) * d;
    float2 hs_v[kMaxPairs];
    float2 acc[kMaxPairs];
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int c = 64 * p + 2 * lane;
      hs_v[p] = c < d ? *reinterpret_cast<const float2*>(hsrow + c)
                      : make_float2(0.0f, 0.0f);
      acc[p] = make_float2(0.0f, 0.0f);
    }

    for (int base = begin; base < end; base += 32) {
      const int e = base + lane;
      int j = 0;
      bool kept = false;
      float m_j = 0.0f, gden_j = 0.0f;
      if (e < end) {
        j = col[e];
        const uint32_t cj = static_cast<uint32_t>(j);
        kept = !drop || (row_is_user ? hash_keeps(r, cj, salt, keep)
                                     : hash_keeps(cj, r, salt, keep));
        if (kept) {
          m_j = m_dst[j];
          gden_j = g_den[j];
        }
      }
      unsigned todo = __ballot_sync(kFullMask, kept);
      while (todo) {  // the strip's kept edges
        const int k = __ffs(todo) - 1;
        todo &= todo - 1;
        const int jk = __shfl_sync(kFullMask, j, k);
        const float mk = __shfl_sync(kFullMask, m_j, k);
        const float gdk = __shfl_sync(kFullMask, gden_j, k);
        const float* hdrow = hd + static_cast<size_t>(jk) * d;
        const float* grow = g_num + static_cast<size_t>(jk) * d;
        float2 lk[kMaxPairs], slope[kMaxPairs], g[kMaxPairs];
        float z = 0.0f, dot = 0.0f;
#pragma unroll
        for (int p = 0; p < kMaxPairs; ++p) {
          const int c = 64 * p + 2 * lane;
          if (c < d) {
            const float2 h = *reinterpret_cast<const float2*>(hdrow + c);
            g[p] = *reinterpret_cast<const float2*>(grow + c);
            const float ux = hs_v[p].x + h.x;
            const float uy = hs_v[p].y + h.y;
            lk[p] = make_float2(leaky(ux), leaky(uy));
            slope[p] = make_float2(ux >= 0.0f ? 1.0f : kSlope,
                                   uy >= 0.0f ? 1.0f : kSlope);
            z += a_v[p].x * lk[p].x + a_v[p].y * lk[p].y;
            dot += g[p].x * hs_v[p].x + g[p].y * hs_v[p].y;
          } else {
            lk[p] = slope[p] = g[p] = make_float2(0.0f, 0.0f);
          }
        }
        // butterflies: every lane ends with the same sums
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          z += __shfl_xor_sync(kFullMask, z, off);
          dot += __shfl_xor_sync(kFullMask, dot, off);
        }
        const float w = expf(z - mk);
        const float dz = w * (dot + gdk);
        float* dhdrow = dhd + static_cast<size_t>(jk) * d;
#pragma unroll
        for (int p = 0; p < kMaxPairs; ++p) {
          const int c = 64 * p + 2 * lane;
          if (c < d) {
            const float lx = slope[p].x * a_v[p].x * dz;
            const float ly = slope[p].y * a_v[p].y * dz;
            acc[p].x += w * g[p].x + lx;
            acc[p].y += w * g[p].y + ly;
            atomicAdd(dhdrow + c, lx);
            atomicAdd(dhdrow + c + 1, ly);
            da_acc[p].x += dz * lk[p].x;
            da_acc[p].y += dz * lk[p].y;
          }
        }
      }
    }

    float* out = dhs + static_cast<size_t>(row) * d;
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int c = 64 * p + 2 * lane;
      if (c < d) *reinterpret_cast<float2*>(out + c) = acc[p];
    }
  }

  // da: the block's warps in shared memory, then one atomic per column
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) da_part[warp][p * 32 + lane] = da_acc[p];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      const int c = 64 * p + 2 * lane;
      if (c < d) {
        float2 s = make_float2(0.0f, 0.0f);
        for (int w = 0; w < kWarpsPerBlock; ++w) {
          s.x += da_part[w][p * 32 + lane].x;
          s.y += da_part[w][p * 32 + lane].y;
        }
        atomicAdd(da + c, s.x);
        atomicAdd(da + c + 1, s.y);
      }
    }
  }
}

}  // namespace

// Launches K6 on `stream` (a cudaStream_t) of `device` and returns the
// first CUDA error as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the shapes:
// over the transpose CSR rowptr (n_rows + 1) and col (rowptr[n_rows]),
// hs and dhs (n_rows, d), hd, g_num and dhd (n_cols, d), a and da (d),
// m_dst and g_den (n_cols), all contiguous on `device`, dhd and da
// zeroed, d even in (0, 256], n_rows > 0.
extern "C" int gatv2_bwd_f32(const int32_t* rowptr, const int32_t* col,
                             const float* hs, const float* hd,
                             const float* a, const float* m_dst,
                             const float* g_num, const float* g_den,
                             float* dhs, float* dhd, float* da, int n_rows,
                             int d, uint32_t salt, float keep,
                             int row_is_user, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks the card holds at once, found once per device
  static int resident[64] = {0};
  int& max_blocks = resident[device & 63];
  if (max_blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gatv2_bwd_kernel, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < max_blocks ? needed : max_blocks;
  gatv2_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rowptr, col, hs, hd, a, m_dst, g_num, g_den, dhs, dhd, da, n_rows, d,
      salt, keep, row_is_user);
  return static_cast<int>(cudaGetLastError());
}
