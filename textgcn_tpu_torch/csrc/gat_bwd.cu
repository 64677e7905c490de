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
// users, 25k items, ~545k edges, d = 64, f32) reads g_num and h (6.4 and
// 15.4 MB), the transpose CSR (~2.4 MB) and four scalar vectors (< 0.7
// MB), and writes dh (6.4 or 15.4 MB) plus ds and dd: ~32 MB against
// ~4*E*d = 140 MFLOP, so its least time is the bytes over the H100's
// 3.35 TB/s (~10 us).
//
// The first design (a whole warp per row walking every edge of a strip,
// four float2 a lane for any d, a 5-step butterfly per kept edge) ran at
// ~17% of the bound. On the H100 (PERF.md, section 6) its dd atomic cost
// 2-5% of its time, its L2 gathers 13-14%, and its walk over dropped
// edges nothing: taking only the kept edges by ballot ran 1.01x at keep
// 0.6 and 1.27-1.31x slower at keep 1. The chain of dependent steps a
// warp runs per kept edge held it. This design halves that chain's lanes
// and steps and runs two kept edges a warp at once: about 0.58x the first
// design's time. In it the gathers take 14-17% and the atomic 2-4%; a
// half-warp per row with two kept edges in flight ran within 5% of it.
// The design, K6's (gatv2_bwd.cu) shape:
//   * one warp per row i, walking the rows grid-stride with as many blocks
//     as the card holds at once (13-14% off the pass over 60k rows of ~9
//     edges, against a block per 8 rows); each half-warp holds h_i in
//     registers, kPer vectors of kVec floats a lane (templated: at d = 64
//     one float4, and no dead columns in registers);
//   * each lane hashes one edge of a 32-edge strip and, for a kept one,
//     gathers its d_j, m_j and g_den_j and computes e_ij and the slope; a
//     ballot gives the strip's kept edges, and the warp walks only those,
//     two at a time, one per half-warp: the two gathers of g_num_j
//     (256-byte rows at d = 64) are in flight together, and each half
//     completes g_num_j . h_i with a 4-step butterfly over its 16 lanes;
//   * dh_i and ds_i sum in registers per half; the halves are added with
//     one shuffle when the row ends and the row is written once;
//   * dd_j sums over the other axis: one lane of each half adds its edge's
//     dz_ij with one float atomicAdd into a zeroed dd (one atomic a kept
//     edge, spread over 25k or 60k addresses a direction at S1). That is
//     one launch and no second pass over the forward CSR, but dd's
//     summation order changes from run to run: dd agrees with the plain
//     version to f32 rounding of sums of up to ~100 terms, not bit for
//     bit;
//   * any even d up to 256: float4 when d % 4 == 0 and every table is
//     16-byte aligned, else float2 (the wrapper picks; ops/gat.att_layout,
//     the rule K5 and K6 share).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: expf stays the accurate one (not __expf).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kSlope = 0.2f;

// the blocks an SM must hold, by the floats each array holds a lane: the
// cap it puts on registers (65536 / (256 * blocks)) leaves no spill
template <int kFloats>
constexpr int min_blocks() {
  return kFloats <= 4 ? 4 : (kFloats <= 8 ? 2 : 1);
}

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

template <int kVec, int kPer>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  min_blocks<kVec * kPer>())
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
  constexpr int kStride = 16 * kVec;   // columns of one vector per half
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int sub = lane & 15;
  const bool drop = keep < 1.0f;

  for (int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n_rows; row += gridDim.x * kWarpsPerBlock) {  // warp-uniform
    const int begin = rowptr[row];
    const int end = rowptr[row + 1];
    const uint32_t r = static_cast<uint32_t>(row);
    const float s_row = s[row];

    const float* hrow = h + static_cast<size_t>(row) * d;
    float hv[kPer][kVec], acc[kPer][kVec];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = p * kStride + kVec * sub;
#pragma unroll
      for (int q = 0; q < kVec; ++q) hv[p][q] = acc[p][q] = 0.0f;
      if (c < d) load_vec<kVec>(hrow + c, hv[p]);
    }
    float ds_row = 0.0f;  // the same in every lane of a half

    for (int base = begin; base < end; base += 32) {
      const int e = base + lane;
      int j = 0;
      bool kept = false;
      float w = 0.0f, slope = 0.0f, gden = 0.0f;
      if (e < end) {
        j = col[e];
        const uint32_t cj = static_cast<uint32_t>(j);
        kept = !drop || (row_is_user ? hash_keeps(r, cj, salt, keep)
                                     : hash_keeps(cj, r, salt, keep));
        if (kept) {
          const float z = s_row + d_dst[j];
          w = expf(leaky(z) - m_dst[j]);
          slope = z >= 0.0f ? 1.0f : kSlope;
          gden = g_den[j];
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
        const float wk = __shfl_sync(kFullMask, w, k & 31);
        const float slope_k = __shfl_sync(kFullMask, slope, k & 31);
        const float gden_k = __shfl_sync(kFullMask, gden, k & 31);
        const float* grow = g_num + static_cast<size_t>(jk) * d;
        float g[kPer][kVec];
        float dot = 0.0f;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int c = p * kStride + kVec * sub;
#pragma unroll
          for (int q = 0; q < kVec; ++q) g[p][q] = 0.0f;
          if (valid && c < d) load_vec<kVec>(grow + c, g[p]);
#pragma unroll
          for (int q = 0; q < kVec; ++q) dot += g[p][q] * hv[p][q];
        }
        // butterflies over each half: all 16 lanes end with the dot
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(kFullMask, dot, off);
        }
        if (valid) {
          const float dz = wk * (dot + gden_k) * slope_k;
          ds_row += dz;
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
#pragma unroll
            for (int q = 0; q < kVec; ++q) acc[p][q] += wk * g[p][q];
          }
          if (sub == 0) atomicAdd(dd + jk, dz);
        }
      }
    }

    // the two halves' sums, then one write of the row
    float* out = dh + static_cast<size_t>(row) * d;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = p * kStride + kVec * sub;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        acc[p][q] += __shfl_xor_sync(kFullMask, acc[p][q], 16);
      }
      if (half == 0 && c < d) store_vec<kVec>(out + c, acc[p]);
    }
    ds_row += __shfl_xor_sync(kFullMask, ds_row, 16);
    if (lane == 0) ds[row] = ds_row;
  }
}

template <int kVec, int kPer>
cudaError_t launch(const int32_t* rowptr, const int32_t* col, const float* h,
                   const float* s, const float* d_dst, const float* m_dst,
                   const float* g_num, const float* g_den, float* dh,
                   float* ds, float* dd, int n_rows, int d, uint32_t salt,
                   float keep, int row_is_user, int device,
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
        &per_sm, gat_bwd_kernel<kVec, kPer>, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = needed < max_blocks ? needed : max_blocks;
  gat_bwd_kernel<kVec, kPer><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, col, h, s, d_dst, m_dst, g_num, g_den, dh, ds, dd, n_rows, d,
      salt, keep, row_is_user);
  return cudaGetLastError();
}

}  // namespace

// Launches K4 on `stream` (a cudaStream_t) of `device` and returns the
// first CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, per) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: over the transpose CSR rowptr (n_rows + 1) and col
// (rowptr[n_rows]), h (n_rows, d), s (n_rows), d_dst, m_dst, g_den and dd
// (n_cols), g_num (n_cols, d), dh (n_rows, d), ds (n_rows), all contiguous
// on `device`, dd zeroed, d even in (0, 256], n_rows > 0; and picked vec
// in {2, 4} (4: d % 4 == 0 and the tables 16-byte aligned) and per, the
// vectors a lane holds, with 16 * vec * per >= d.
extern "C" int gat_bwd_f32(const int32_t* rowptr, const int32_t* col,
                           const float* h, const float* s,
                           const float* d_dst, const float* m_dst,
                           const float* g_num, const float* g_den,
                           float* dh, float* ds, float* dd, int n_rows,
                           int d, uint32_t salt, float keep,
                           int row_is_user, int vec, int per, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_LAUNCH(V, P)                                                      \
  launch<V, P>(rowptr, col, h, s, d_dst, m_dst, g_num, g_den, dh, ds, dd,   \
               n_rows, d, salt, keep, row_is_user, device, st)
  switch (vec * 100 + per) {
    case 201: err = K4_LAUNCH(2, 1); break;
    case 202: err = K4_LAUNCH(2, 2); break;
    case 204: err = K4_LAUNCH(2, 4); break;
    case 208: err = K4_LAUNCH(2, 8); break;
    case 401: err = K4_LAUNCH(4, 1); break;
    case 402: err = K4_LAUNCH(4, 2); break;
    case 404: err = K4_LAUNCH(4, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K4_LAUNCH
  return static_cast<int>(err);
}
