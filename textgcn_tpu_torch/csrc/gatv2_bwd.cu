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
// H100's 3.35 TB/s (~17 us). Each kept edge also gathers two rows (hd_j,
// g_num_j) and adds one row into dhd_j, all in the 50 MB L2.
//
// The first design (a whole warp on one kept edge at a time, four float2 a
// lane for any d, 80 registers, 2 scalar float atomics a lane per edge) ran
// at ~12% of the bound. On the H100 (PERF.md, section 6) the atomics
// held it: this design with scalar atomics in place of vector ones ran
// 2.1-2.9x slower, behind even the first design, and giving each half-warp
// two edges at once instead of one changed nothing beyond 4%. In this
// design, the to-user pass (hd, g_num and dhd of 15.4 MB each: ~59 MB with
// hs and dhs, past the L2) loses 25-30% to the atomics and 32-33% to the
// gathers; the to-item pass (6.4 MB tables) under 15% to both. The design:
//   * one warp per forward source row i, walking the rows grid-stride with
//     as many blocks as the card holds at once; each half-warp holds hs_i
//     and a in registers, kPer vectors of kVec floats a lane (templated: at
//     d = 64 one float4, and no dead columns in registers);
//   * each lane hashes one edge of a 32-edge strip and fetches its m_j and
//     g_den_j; a ballot gives the strip's kept edges, and the warp walks
//     them two at a time, one per half-warp: the two edges' gathers of hd_j
//     and g_num_j (256-byte rows at d = 64) are in flight together, and
//     each half completes z_ij and g_num_j . hs_i with a 4-step butterfly
//     over its 16 lanes;
//   * dhs_i sums in registers per half; the halves are added with one
//     shuffle when the row ends and the row is written once;
//   * dhd_j sums over the other axis with vector atomics (CUDA 12's
//     float4/float2 atomicAdd for global memory on compute capability 9.x):
//     one atomic instruction per lane and vector, 16 per kept edge at
//     d = 64 where the first design issued 64 (declared in the toolkit's
//     crt/sm_90_rt.h). dhd's summation order changes from run to run: it
//     agrees with the plain version to f32 rounding, not bit for bit.
//     (A second launch over the forward CSR
//     would be deterministic but would repeat every edge's gathers and
//     reductions, about doubling the traffic.)
//   * da sums per lane in registers over all the warp's edges, then over
//     the two halves and the block's warps, then one float atomicAdd per
//     column per block into a zeroed da;
//   * any even d up to 256: float4 when d % 4 == 0 and every table is
//     16-byte aligned, else float2 (the wrapper picks; ops/gat.k6_layout).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: expf stays the accurate one (not __expf).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
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

// kVec consecutive floats at p (16- or 8-byte aligned) into registers
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// one vector atomic add into global memory (sm_90: atomicAdd on float4 and
// float2)
template <int kVec>
__device__ __forceinline__ void atomic_add_vec(float* p,
                                               const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
}

template <int kVec, int kPer>
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
  constexpr int kStride = 16 * kVec;   // columns of one vector per half
  __shared__ float da_part[kWarpsPerBlock][kPer * kStride];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int sub = lane & 15;
  const bool drop = keep < 1.0f;

  float a_v[kPer][kVec], da_acc[kPer][kVec];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = p * kStride + kVec * sub;
#pragma unroll
    for (int q = 0; q < kVec; ++q) a_v[p][q] = da_acc[p][q] = 0.0f;
    if (c < d) load_vec<kVec>(a + c, a_v[p]);
  }

  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n_rows;
       row += gridDim.x * kWarpsPerBlock) {  // warp-uniform
    const int begin = rowptr[row];
    const int end = rowptr[row + 1];
    const uint32_t r = static_cast<uint32_t>(row);
    const float* hsrow = hs + static_cast<size_t>(row) * d;
    float hs_v[kPer][kVec], acc[kPer][kVec];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = p * kStride + kVec * sub;
#pragma unroll
      for (int q = 0; q < kVec; ++q) hs_v[p][q] = acc[p][q] = 0.0f;
      if (c < d) load_vec<kVec>(hsrow + c, hs_v[p]);
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
      while (todo) {  // the strip's kept edges, one per half-warp
        const int k0 = __ffs(todo) - 1;
        todo &= todo - 1;
        const int k1 = __ffs(todo) - 1;   // -1: half 1 has no edge
        todo &= todo - 1;
        const int k = half ? k1 : k0;
        const bool valid = k >= 0;
        const int jk = __shfl_sync(kFullMask, j, k & 31);
        const float mk = __shfl_sync(kFullMask, m_j, k & 31);
        const float gdk = __shfl_sync(kFullMask, gden_j, k & 31);
        const float* hdrow = hd + static_cast<size_t>(jk) * d;
        const float* grow = g_num + static_cast<size_t>(jk) * d;
        float u[kPer][kVec], g[kPer][kVec];
        float z = 0.0f, dot = 0.0f;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int c = p * kStride + kVec * sub;
#pragma unroll
          for (int q = 0; q < kVec; ++q) u[p][q] = g[p][q] = 0.0f;
          if (valid && c < d) {
            load_vec<kVec>(hdrow + c, u[p]);
            load_vec<kVec>(grow + c, g[p]);
          }
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            u[p][q] += hs_v[p][q];
            z += a_v[p][q] * leaky(u[p][q]);
            dot += g[p][q] * hs_v[p][q];
          }
        }
        // butterflies over each half: all 16 lanes end with the sums
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          z += __shfl_xor_sync(kFullMask, z, off);
          dot += __shfl_xor_sync(kFullMask, dot, off);
        }
        if (valid) {
          const float w = expf(z - mk);
          const float dz = w * (dot + gdk);
          float* dhdrow = dhd + static_cast<size_t>(jk) * d;
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int c = p * kStride + kVec * sub;
            if (c < d) {
              float lam[kVec];
#pragma unroll
              for (int q = 0; q < kVec; ++q) {
                const float uq = u[p][q];
                lam[q] = (uq >= 0.0f ? 1.0f : kSlope) * a_v[p][q] * dz;
                acc[p][q] += w * g[p][q] + lam[q];
                da_acc[p][q] += dz * leaky(uq);
              }
              atomic_add_vec<kVec>(dhdrow + c, lam);
            }
          }
        }
      }
    }

    // the two halves' sums, then one write of the row
    float* out = dhs + static_cast<size_t>(row) * d;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = p * kStride + kVec * sub;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        acc[p][q] += __shfl_xor_sync(kFullMask, acc[p][q], 16);
      }
      if (half == 0 && c < d) store_vec<kVec>(out + c, acc[p]);
    }
  }

  // da: the two halves, the block's warps in shared memory, then one
  // atomic per column
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      da_acc[p][q] += __shfl_xor_sync(kFullMask, da_acc[p][q], 16);
      if (half == 0) da_part[warp][p * kStride + kVec * sub + q] = da_acc[p][q];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d && c < kPer * kStride;
       c += kWarpsPerBlock * 32) {
    float s = 0.0f;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += da_part[w][c];
    atomicAdd(da + c, s);
  }
}

template <int kVec, int kPer>
cudaError_t launch(const int32_t* rowptr, const int32_t* col,
                   const float* hs, const float* hd, const float* a,
                   const float* m_dst, const float* g_num, const float* g_den,
                   float* dhs, float* dhd, float* da, int n_rows, int d,
                   uint32_t salt, float keep, int row_is_user, int device,
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
        &per_sm, gatv2_bwd_kernel<kVec, kPer>, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < max_blocks ? needed : max_blocks;
  gatv2_bwd_kernel<kVec, kPer><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, col, hs, hd, a, m_dst, g_num, g_den, dhs, dhd, da, n_rows, d,
      salt, keep, row_is_user);
  return cudaGetLastError();
}

}  // namespace

// Launches K6 on `stream` (a cudaStream_t) of `device` and returns the
// first CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, per) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: over the transpose CSR rowptr (n_rows + 1) and col
// (rowptr[n_rows]), hs and dhs (n_rows, d), hd, g_num and dhd (n_cols, d),
// a and da (d), m_dst and g_den (n_cols), all contiguous on `device`, dhd
// and da zeroed, d even in (0, 256], n_rows > 0; and picked vec in {2, 4}
// (4: d % 4 == 0 and the tables 16-byte aligned) and per, the vectors a
// lane holds, with 16 * vec * per >= d.
extern "C" int gatv2_bwd_f32(const int32_t* rowptr, const int32_t* col,
                             const float* hs, const float* hd,
                             const float* a, const float* m_dst,
                             const float* g_num, const float* g_den,
                             float* dhs, float* dhd, float* da, int n_rows,
                             int d, uint32_t salt, float keep,
                             int row_is_user, int vec, int per, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K6_LAUNCH(V, P)                                                     \
  launch<V, P>(rowptr, col, hs, hd, a, m_dst, g_num, g_den, dhs, dhd, da, \
               n_rows, d, salt, keep, row_is_user, device, s)
  switch (vec * 100 + per) {
    case 201: err = K6_LAUNCH(2, 1); break;
    case 202: err = K6_LAUNCH(2, 2); break;
    case 204: err = K6_LAUNCH(2, 4); break;
    case 208: err = K6_LAUNCH(2, 8); break;
    case 401: err = K6_LAUNCH(4, 1); break;
    case 402: err = K6_LAUNCH(4, 2); break;
    case 404: err = K6_LAUNCH(4, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K6_LAUNCH
  return static_cast<int>(err);
}
