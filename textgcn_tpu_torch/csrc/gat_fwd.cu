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
// users, 25k items, ~545k edges, d = 64, f32) reads the h table (6.4 or
// 15.4 MB), the CSR (~2.4 MB), s and d (< 0.4 MB), and writes num (15.4 or
// 6.4 MB) plus den and m: ~25 MB against ~2*E*d = 70 MFLOP, so its least
// time is the bytes over the H100's 3.35 TB/s (~7.5 us).
//
// What the first design (one warp per row, two passes over the row's
// edges, every lane gathering a float2 of each kept edge's row one edge at
// a time) measured on an H100 80GB HBM3 at a 700 W power limit (PERF.md,
// section 6), a layer (both directions) on S1: 0.0802 ms at keep 0.6 and
// 0.0932 at keep 1. This design takes K5's shape (gatv2_fwd.cu) and runs
// at 0.0463 / 0.0584 ms. Two passes, pass one reading only s[col], ran
// 5-7% slower; folding the softmax edge by edge, as K5 must, 2-3% slower;
// rows in blocks of 16 instead of grid-stride 8-10% slower (reading 256
// cached rows in place of the edges' rows took 15-22% off that version);
// four gathers in flight and 8 lanes a row with two float4 a lane gained
// nothing, and loading the next row's ids early cost 8%. The design:
//   * a half-warp per destination row, two rows a warp, the rows walked
//     grid-stride over as many blocks as the card holds at once; each of
//     the 16 lanes holds kPer vectors of kVec floats of the row's sums
//     (templated: at d = 64 one float4);
//   * each lane hashes one edge of a 16-edge strip and, for a kept one,
//     gathers s_i and computes its logit; the next strip's ids are loaded
//     before this strip's gathers;
//   * ONE pass with an online softmax folded a strip at a time: the
//     strip's logits are all known before any row of h is read, so a
//     4-step butterfly gives the strip's max, and when it beats the row's
//     max m, the sums so far are rescaled once by exp(m_old - m_new); then
//     each lane computes its own edge's e = exp(z - m) at once. m ends as
//     exactly the max over the kept logits, which K4 (gat_bwd.cu) reads;
//   * a ballot, masked to the half's lanes, gives the strip's kept edges,
//     and the half walks only those, kUnroll at a time: their gathers of
//     h_i (256-byte rows at d = 64, one float4 a lane) are issued together,
//     then folded in CSR order, num += e * h_i. No row is split into
//     partial softmaxes, so the result is deterministic;
//   * a dropped edge costs no gather; the sums stay in registers and each
//     output row is written once: no atomics; a row with no kept edge
//     keeps num = 0, den = 0, m = NEG, so no masked edge ever adds
//     exp(0) = 1;
//   * any even d up to 256: float4 when d % 4 == 0 and h and num are
//     16-byte aligned, else float2 (the wrapper picks; ops/gat.att_layout,
//     the rule K4, K5 and K6 share).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: expf stays the accurate one (not __expf).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLanes = 16;    // lanes a destination row: a half-warp
constexpr int kUnroll = 2;    // kept edges whose gathers a half issues at once
constexpr float kNeg = -0x1p100f;   // -2^100, exact in f32
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
  constexpr int kStride = kLanes * kVec;   // columns of one vector per row
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const int shift = lane - sub;            // the half's first lane
  const unsigned half_mask = ((1u << kLanes) - 1u) << shift;
  const bool drop = keep < 1.0f;

  for (int row = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 2 +
                 shift / kLanes;
       row < n_dst; row += gridDim.x * kWarpsPerBlock * 2) {  // half-uniform
    const int begin = rowptr[row];
    const int end = rowptr[row + 1];
    const uint32_t r = static_cast<uint32_t>(row);
    const float d_row = d_dst[row];

    float acc[kPer][kVec];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int q = 0; q < kVec; ++q) acc[p][q] = 0.0f;
    }
    float m = kNeg;          // the same in every lane of the half
    float den_lane = 0.0f;   // this lane's edges, relative to m

    int next_src = begin + sub < end ? col[begin + sub] : 0;
    for (int base = begin; base < end; base += kLanes) {  // half-uniform
      const int src = next_src;
      const bool has = base + sub < end;
      if (base + kLanes + sub < end) next_src = col[base + kLanes + sub];
      const uint32_t sr = static_cast<uint32_t>(src);
      const bool kept =
          has && (!drop || (dst_is_user ? hash_keeps(r, sr, salt, keep)
                                        : hash_keeps(sr, r, salt, keep)));
      const float z = kept ? leaky(s[src] + d_row) : kNeg;
      // the half's bits only: the ballot may report the other half's lanes
      unsigned todo = (__ballot_sync(half_mask, kept) & half_mask) >> shift;
      if (!todo) continue;
      // the strip's max; a new row max rescales what was summed so far
      float z_max = z;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        z_max = fmaxf(z_max, __shfl_xor_sync(half_mask, z_max, off));
      }
      if (z_max > m) {
        const float scale = expf(m - z_max);   // 0 for the first kept strip
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
#pragma unroll
          for (int q = 0; q < kVec; ++q) acc[p][q] *= scale;
        }
        den_lane *= scale;
        m = z_max;
      }
      const float e = kept ? expf(z - m) : 0.0f;
      den_lane += e;
      while (todo) {  // the strip's kept edges, in CSR order
        const int n = __popc(todo);  // of which this round takes kUnroll
        int sk[kUnroll];
        float ek[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = (__ffs(todo) - 1) & (kLanes - 1);
          todo &= todo - 1;
          sk[u] = __shfl_sync(half_mask, src, k, kLanes);
          ek[u] = __shfl_sync(half_mask, e, k, kLanes);
        }
        float hv[kUnroll][kPer][kVec];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float* hrow = h + static_cast<size_t>(sk[u]) * d;
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const int c = p * kStride + kVec * sub;
#pragma unroll
            for (int q = 0; q < kVec; ++q) hv[u][p][q] = 0.0f;
            if (u < n && c < d) load_vec<kVec>(hrow + c, hv[u][p]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < n) {
#pragma unroll
            for (int p = 0; p < kPer; ++p) {
#pragma unroll
              for (int q = 0; q < kVec; ++q) {
                acc[p][q] = fmaf(ek[u], hv[u][p][q], acc[p][q]);
              }
            }
          }
        }
      }
    }
    // butterflies over the half: every lane ends with the row's den
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      den_lane += __shfl_xor_sync(half_mask, den_lane, off);
    }

    float* out = num + static_cast<size_t>(row) * d;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int c = p * kStride + kVec * sub;
      if (c < d) store_vec<kVec>(out + c, acc[p]);
    }
    if (sub == 0) {
      den[row] = den_lane;
      m_out[row] = m;
    }
  }
}

template <int kVec, int kPer>
cudaError_t launch(const int32_t* rowptr, const int32_t* col, const float* h,
                   const float* s, const float* d_dst, float* num,
                   float* den, float* m, int n_dst, int d, uint32_t salt,
                   float keep, int dst_is_user, int device,
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
        &per_sm, gat_fwd_kernel<kVec, kPer>, kWarpsPerBlock * 32, 0);
    if (err != cudaSuccess) return err;
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int kRowsPerBlock = kWarpsPerBlock * 32 / kLanes;
  const int needed = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  const int blocks = needed < max_blocks ? needed : max_blocks;
  gat_fwd_kernel<kVec, kPer><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, col, h, s, d_dst, num, den, m, n_dst, d, salt, keep,
      dst_is_user);
  return cudaGetLastError();
}

}  // namespace

// Launches K3 on `stream` (a cudaStream_t) of `device` and returns the
// first CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, per) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: rowptr (n_dst + 1), col (rowptr[n_dst]), h (n_src, d), s (n_src),
// d_dst (n_dst), num (n_dst, d), den and m (n_dst), all contiguous on
// `device`, d even in (0, 256], n_dst > 0; and picked vec in {2, 4} (4:
// d % 4 == 0 and h and num 16-byte aligned) and per, the vectors a lane
// holds, with 16 * vec * per >= d.
extern "C" int gat_fwd_f32(const int32_t* rowptr, const int32_t* col,
                           const float* h, const float* s,
                           const float* d_dst, float* num, float* den,
                           float* m, int n_dst, int d, uint32_t salt,
                           float keep, int dst_is_user, int vec, int per,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(V, P)                                                     \
  launch<V, P>(rowptr, col, h, s, d_dst, num, den, m, n_dst, d, salt, keep, \
               dst_is_user, device, st)
  switch (vec * 100 + per) {
    case 201: err = K3_LAUNCH(2, 1); break;
    case 202: err = K3_LAUNCH(2, 2); break;
    case 204: err = K3_LAUNCH(2, 4); break;
    case 208: err = K3_LAUNCH(2, 8); break;
    case 401: err = K3_LAUNCH(4, 1); break;
    case 402: err = K3_LAUNCH(4, 2); break;
    case 404: err = K3_LAUNCH(4, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K3_LAUNCH
  return static_cast<int>(err);
}
