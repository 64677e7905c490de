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
// so its least time is the bytes over the H100's 3.35 TB/s (~10 us).
//
// The first design (a whole warp per row, four float2 a lane for any d,
// one kept edge at a time through a 5-step butterfly) ran at ~16% of the
// bound. On the H100 (PERF.md, section 6) reading its rows from 256
// cached rows took only 8-12% off, and issuing two kept edges' gathers
// together 10-17%: the chain of dependent steps a warp runs per edge, not
// the L2 gathers, held it. This design gives each row half the lanes,
// float4 columns and 4-step butterflies, and two rows a warp; it runs at
// about half the first design's time. In it cached rows take 6-10% off,
// and four kept edges in flight gain nothing over two. The design:
//   * a half-warp per destination row, two rows a warp: each of its 16
//     lanes holds kPer vectors of kVec floats of hd_j, a and the row's
//     sums (templated: at d = 64 one float4, and no dead columns in
//     registers);
//   * ONE pass with an online softmax: z_ij needs the whole hs_i row (a
//     gather and a reduction), and the message is that same row, so a
//     second pass would gather every row twice;
//   * each lane hashes one edge of a 16-edge strip; a ballot, masked to
//     the half's lanes, gives the strip's kept edges, and the half walks
//     only those, kUnroll at a time: their gathers of hs_i (256-byte rows
//     at d = 64, one float4 a lane) are issued together, then their logits
//     complete with 4-step butterflies over the half's 16 lanes (every
//     lane ends with the same z, so the branches below are uniform in the
//     half), then they are folded into (m, den, num) one after the other,
//     in CSR order: when z beats the running max, num and den are rescaled
//     by exp(m_old - z) first. No row is split into partial softmaxes, so
//     the result is deterministic;
//   * the next strip's ids are loaded before this strip's gathers;
//   * a dropped edge costs no gather; the sums stay in registers and each
//     output row is written once: no atomics; a row with no kept edge keeps
//     num = 0, den = 0, m = NEG, so no masked edge ever adds exp(0) = 1;
//   * any even d up to 256: float4 when d % 4 == 0 and every table is
//     16-byte aligned, else float2 (the wrapper picks; ops/gat.att_layout,
//     the rule K4 and K6 share).
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
  constexpr int kStride = kLanes * kVec;   // columns of one vector per row
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const int shift = lane - sub;            // the half's first lane
  const unsigned half_mask = ((1u << kLanes) - 1u) << shift;
  const int row =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / kLanes) +
      shift / kLanes;
  if (row >= n_dst) return;  // the whole half leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];
  const bool drop = keep < 1.0f;
  const uint32_t r = static_cast<uint32_t>(row);

  const float* hdrow = hd + static_cast<size_t>(row) * d;
  float hd_v[kPer][kVec], a_v[kPer][kVec], acc[kPer][kVec];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = p * kStride + kVec * sub;
#pragma unroll
    for (int q = 0; q < kVec; ++q) hd_v[p][q] = a_v[p][q] = acc[p][q] = 0.0f;
    if (c < d) {
      load_vec<kVec>(hdrow + c, hd_v[p]);
      load_vec<kVec>(a + c, a_v[p]);
    }
  }
  float m = kNeg;
  float den_row = 0.0f;  // the same in every lane of the half

  int next_src = begin + sub < end ? col[begin + sub] : 0;
  for (int base = begin; base < end; base += kLanes) {  // uniform in the half
    const int src = next_src;
    const bool has = base + sub < end;
    if (base + kLanes + sub < end) next_src = col[base + kLanes + sub];
    const uint32_t s = static_cast<uint32_t>(src);
    const bool kept =
        has && (!drop || (dst_is_user ? hash_keeps(r, s, salt, keep)
                                      : hash_keeps(s, r, salt, keep)));
    // the half's bits only: the ballot may report the other half's lanes
    unsigned todo = (__ballot_sync(half_mask, kept) & half_mask) >> shift;
    while (todo) {  // the strip's kept edges, in CSR order
      const int n = __popc(todo);  // of which this round takes kUnroll
      int sk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = (__ffs(todo) - 1) & (kLanes - 1);
        todo &= todo - 1;
        sk[u] = __shfl_sync(half_mask, src, k, kLanes);
      }
      float hv[kUnroll][kPer][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* hsrow = hs + static_cast<size_t>(sk[u]) * d;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
          const int c = p * kStride + kVec * sub;
#pragma unroll
          for (int q = 0; q < kVec; ++q) hv[u][p][q] = 0.0f;
          if (u < n && c < d) load_vec<kVec>(hsrow + c, hv[u][p]);
        }
      }
      float z[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        z[u] = 0.0f;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            z[u] += a_v[p][q] * leaky(hv[u][p][q] + hd_v[p][q]);
          }
        }
      }
      // butterflies over the half: all 16 lanes end with the same sums
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          z[u] += __shfl_xor_sync(half_mask, z[u], off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
          if (z[u] > m) {  // a new row max: rescale what was summed so far
            const float scale = expf(m - z[u]);  // 0 for the first kept edge
#pragma unroll
            for (int p = 0; p < kPer; ++p) {
#pragma unroll
              for (int q = 0; q < kVec; ++q) acc[p][q] *= scale;
            }
            den_row *= scale;
            m = z[u];
          }
          const float w = expf(z[u] - m);
          den_row += w;
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
#pragma unroll
            for (int q = 0; q < kVec; ++q) acc[p][q] += w * hv[u][p][q];
          }
        }
      }
    }
  }

  float* out = num + static_cast<size_t>(row) * d;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int c = p * kStride + kVec * sub;
    if (c < d) store_vec<kVec>(out + c, acc[p]);
  }
  if (sub == 0) {
    den[row] = den_row;
    m_out[row] = m;
  }
}

template <int kVec, int kPer>
cudaError_t launch(const int32_t* rowptr, const int32_t* col,
                   const float* hs, const float* hd, const float* a,
                   float* num, float* den, float* m, int n_dst, int d,
                   uint32_t salt, float keep, int dst_is_user,
                   cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * 32 / kLanes;
  const int blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  gatv2_fwd_kernel<kVec, kPer><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, col, hs, hd, a, num, den, m, n_dst, d, salt, keep,
      dst_is_user);
  return cudaGetLastError();
}

}  // namespace

// Launches K5 on `stream` (a cudaStream_t) of `device` and returns the
// first CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, per) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: rowptr (n_dst + 1), col (rowptr[n_dst]), hs (n_src, d), hd
// (n_dst, d), a (d), num (n_dst, d), den and m (n_dst), all contiguous on
// `device`, d even in (0, 256], n_dst > 0; and picked vec in {2, 4} (4:
// d % 4 == 0 and the tables 16-byte aligned) and per, the vectors a lane
// holds, with 16 * vec * per >= d.
extern "C" int gatv2_fwd_f32(const int32_t* rowptr, const int32_t* col,
                             const float* hs, const float* hd,
                             const float* a, float* num, float* den,
                             float* m, int n_dst, int d, uint32_t salt,
                             float keep, int dst_is_user, int vec, int per,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_LAUNCH(V, P)                                                   \
  launch<V, P>(rowptr, col, hs, hd, a, num, den, m, n_dst, d, salt, keep, \
               dst_is_user, s)
  switch (vec * 100 + per) {
    case 201: err = K5_LAUNCH(2, 1); break;
    case 202: err = K5_LAUNCH(2, 2); break;
    case 204: err = K5_LAUNCH(2, 4); break;
    case 208: err = K5_LAUNCH(2, 8); break;
    case 401: err = K5_LAUNCH(4, 1); break;
    case 402: err = K5_LAUNCH(4, 2); break;
    case 404: err = K5_LAUNCH(4, 4); break;
    default: err = cudaErrorInvalidValue;
  }
#undef K5_LAUNCH
  return static_cast<int>(err);
}
