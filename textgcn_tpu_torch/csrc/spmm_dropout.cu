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
// 25k items, ~545k edges, d = 64, f32) moves ~27 MB from device memory (x
// table, CSR ids and weights, output) for ~70 MFLOP: ~8 us at the H100's
// 3.35 TB/s. But every kept edge gathers a whole source row, ~140 MB a
// direction at keep 1, from the 50 MB L2 where the tables stay between
// launches.
//
// What the first design (one warp per row, one float2 per lane, the warp
// walking every edge one gather at a time) measured on the H100 (PERF.md,
// section 6): reading cached rows instead of the edges' rows took 25%
// off its time, consecutive rows 12%, dropping the store 2-3%, and
// unrolling its edge loop by 4 nothing; at keep 0.6 it ran 3-7% slower
// than at keep 1, hashing every edge and still gathering the rows of the
// dropped ones. The design here reads no dropped row and spends fewer
// lanes and instructions on each edge. In it, cached rows take 8-17% off
// and no store 1-3%: the rest goes per edge and per launch, and staging
// each strip's kept ids in shared memory in place of the shuffles gave
// 0-8%, not taken:
//   * a group of kLanes lanes per destination row, one kVec-float vector a
//     lane: at d = 64 a half-warp reads a whole 256-byte row with 16-byte
//     float4 loads, and a warp works on two rows;
//   * each lane loads one edge of a kLanes-edge strip (col, w), coalesced,
//     and hashes it; a ballot gives the strip's kept edges, and the group
//     walks only those, kUnroll at a time: the kUnroll gathers are issued
//     before their FMAs;
//   * the next strip's (col, w) are loaded before this strip's gathers;
//   * a dropped edge is skipped, its row never read. It would add
//     w * 0 * x = +-0 to a sum that is never -0, which changes no bit for
//     finite x;
//   * each output element is acc = fmaf(w_e / keep, x[col_e][c], acc) over
//     the row's kept edges in CSR order, as K2 (spmm_weighted.cu) adds: at
//     keep = 1 (and with the mask multiplied into K2's weights at any keep)
//     the two give the same bits. No row's edges are split;
//   * the sums stay in registers and each output row is written once: no
//     atomics, zeros for rows without edges;
//   * any even d: float4 when d % 4 == 0 and x is 16-byte aligned, else
//     float2 (the wrapper picks; ops/spmm.k1_layout), and a d wider than
//     kLanes * kVec loops over column strips.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared, without
// --use_fast_math: 1.0f / keep must round as IEEE division does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 2;   // kept edges whose gathers a group issues at once
// at least this many blocks an SM: with the hint ptxas gives every instance
// 36-44 registers and no spill (without it, up to 24 spilled bytes)
constexpr int kMinBlocks = 4;

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

template <int kVec> struct Vec;
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T fma(float w, T v, T acc) {
    return make_float2(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y));
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T fma(float w, T v, T acc) {
    return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y),
                       fmaf(w, v.z, acc.z), fmaf(w, v.w, acc.w));
  }
};

template <int kVec, int kLanes>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
spmm_dropout_kernel(const int32_t* __restrict__ rowptr,
                    const int32_t* __restrict__ col,
                    const float* __restrict__ w,
                    const float* __restrict__ x,
                    float* __restrict__ out,
                    int n_dst, int d, uint32_t salt, float keep,
                    int dst_is_user) {
  using V = typename Vec<kVec>::T;
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const int shift = lane - sub;   // the group's first lane
  const unsigned group_mask =
      kLanes == 32 ? 0xffffffffu : ((1u << kLanes) - 1u) << shift;
  const int row =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kGroups +
      shift / kLanes;
  if (row >= n_dst) return;  // the whole group leaves together
  const int begin = rowptr[row];
  const int end = rowptr[row + 1];
  const bool drop = keep < 1.0f;
  const float inv_keep = 1.0f / keep;
  const uint32_t r = static_cast<uint32_t>(row);

  for (int strip = 0; strip < d; strip += kLanes * kVec) {
    const int c = strip + kVec * sub;
    const bool active = c < d;
    V acc = Vec<kVec>::zero();
    int next_src = 0;
    float next_w = 0.0f;
    if (begin + sub < end) {
      next_src = col[begin + sub];
      next_w = w[begin + sub];
    }
    for (int base = begin; base < end; base += kLanes) {  // group-uniform
      const int src = next_src;
      const float we = next_w * inv_keep;
      const bool has = base + sub < end;
      if (base + kLanes + sub < end) {  // the next strip's ids, early
        next_src = col[base + kLanes + sub];
        next_w = w[base + kLanes + sub];
      }
      const uint32_t s = static_cast<uint32_t>(src);
      const bool kept =
          has && (!drop || (dst_is_user ? hash_keeps(r, s, salt, keep)
                                        : hash_keeps(s, r, salt, keep)));
      // the group's bits only: the ballot may report other active lanes
      unsigned todo = (__ballot_sync(group_mask, kept) & group_mask) >> shift;
      while (todo) {  // the strip's kept edges, in CSR order
        const int n = __popc(todo);  // of which this round takes kUnroll
        int sj[kUnroll];
        float wj[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = (__ffs(todo) - 1) & (kLanes - 1);
          todo &= todo - 1;
          sj[u] = __shfl_sync(group_mask, src, k, kLanes);
          wj[u] = __shfl_sync(group_mask, we, k, kLanes);
        }
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = Vec<kVec>::zero();
          if (u < n && active) {
            v[u] = *reinterpret_cast<const V*>(
                x + static_cast<size_t>(sj[u]) * d + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (u < n) acc = Vec<kVec>::fma(wj[u], v[u], acc);
        }
      }
    }
    if (active) {
      *reinterpret_cast<V*>(out + static_cast<size_t>(row) * d + c) = acc;
    }
  }
}

template <int kVec, int kLanes>
cudaError_t launch(const int32_t* rowptr, const int32_t* col, const float* w,
                   const float* x, float* out, int n_dst, int d,
                   uint32_t salt, float keep, int dst_is_user,
                   cudaStream_t stream) {
  constexpr int kRowsPerBlock = kWarpsPerBlock * (32 / kLanes);
  const int blocks = (n_dst + kRowsPerBlock - 1) / kRowsPerBlock;
  spmm_dropout_kernel<kVec, kLanes><<<blocks, kWarpsPerBlock * 32, 0,
                                      stream>>>(
      rowptr, col, w, x, out, n_dst, d, salt, keep, dst_is_user);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` (a cudaStream_t) of `device` and returns
// the first CUDA error as an int: 0 when the launch was accepted, 1
// (cudaErrorInvalidValue) for a (vec, lanes) pair it has no instance of.
// Allocates nothing and does not synchronise. The caller has checked the
// shapes: rowptr (n_dst + 1), col and w (rowptr[n_dst]), x (n_src, d) and
// out (n_dst, d), all contiguous on `device`, d even and > 0, n_dst > 0;
// and picked vec in {2, 4} (4: d % 4 == 0, x and out 16-byte aligned) and
// lanes in {8, 16, 32}, the lanes that share a row.
extern "C" int spmm_dropout_f32(const int32_t* rowptr, const int32_t* col,
                                const float* w, const float* x, float* out,
                                int n_dst, int d, uint32_t salt, float keep,
                                int dst_is_user, int vec, int lanes,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = vec * 100 + lanes;
  switch (key) {
    case 208: err = launch<2, 8>(rowptr, col, w, x, out, n_dst, d, salt,
                                 keep, dst_is_user, s); break;
    case 216: err = launch<2, 16>(rowptr, col, w, x, out, n_dst, d, salt,
                                  keep, dst_is_user, s); break;
    case 232: err = launch<2, 32>(rowptr, col, w, x, out, n_dst, d, salt,
                                  keep, dst_is_user, s); break;
    case 408: err = launch<4, 8>(rowptr, col, w, x, out, n_dst, d, salt,
                                 keep, dst_is_user, s); break;
    case 416: err = launch<4, 16>(rowptr, col, w, x, out, n_dst, d, salt,
                                  keep, dst_is_user, s); break;
    case 432: err = launch<4, 32>(rowptr, col, w, x, out, n_dst, d, salt,
                                  keep, dst_is_user, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
