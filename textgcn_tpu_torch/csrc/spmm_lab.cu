// L1 on Hopper: the SpMM lab's kernel in its five modes, over the TPU's
// tiled layout.
//
// Replaces the TPU kernel of the JAX lab, tools/kernel_lab.py::make_variant
// (its pallas_call at :129). The layout is textgcn_tpu_torch/tools/
// lab_layout.py::tile_layout: destination block b owns the groups
// group_ptr[b]..group_ptr[b+1], a group holds `group` chunks of 128 slots,
// chunk q reads source block chunk_sb[q], and slot s holds
// packed = dst_local << 16 | src_local and a weight w. Each mode computes
//
//     out[row_out] += f(x[row_in] * w)        over every slot of block b
//
//   mode (int)          row_in                   row_out            f
//   0 full, merged      sb*512 + src_local       b*512 + dst_local  identity
//   1 no_gather         sb*512 + slot-in-chunk   b*512 + dst_local  identity
//   2 no_scatter        sb*512 + src_local       b*512 + slot       identity
//   3 scat_bf16         as full                  as full            to bf16
//
// with the product in f32 (a bf16 x is widened exactly first) and the sum
// in f32; "to bf16" rounds to nearest even (__float2bfloat16_rn, as
// torch's .to(torch.bfloat16) and JAX's astype do). On the TPU,
// `merged_scatter` differs from `full` only in how its one-hot matmuls
// are cut (one scatter matmul per group instead of one per chunk); with
// no one-hot matmul here the two are one function and one kernel.
//
// What bounds it: memory traffic. At the lab's shape (845,824 slots,
// x (25,088, 64), out (60,416, 64) f32) it must read the slots' packed ids
// and weights (6.8 MB) and x (3.2 MB in bf16) and write out (15.5 MB):
// ~7.6 us at 3.35 TB/s, against 0.1 GFLOP (~1.6 us at 67 TFLOP/s f32).
// The design, kept simple for a first port:
//   * one thread block per (destination block, 64-column slice): its
//     output tile of 512 rows x 64 columns lives in dynamic shared memory
//     (133 KB: above the 48 KB default, so the launcher opts in first), is
//     zeroed, summed into with shared-memory float atomics (warps walk
//     different chunks and may hit one row), and written out once;
//   * a warp takes 32 slots at a time (a quarter chunk): each lane loads
//     one slot's packed id and weight, coalesced, and the warp broadcasts
//     them by shuffle; the 32 lanes cover one slot's 64 columns, two each,
//     so one 8-byte (f32) or 4-byte (bf16) load per lane gathers the row's
//     slice, eight slots' gathers are in flight before their adds;
//   * a lane's two columns c, c + 1 sit at tile columns c / 2 and c / 2 +
//     32 in rows of 65 floats, so each atomic instruction of a warp hits 32
//     distinct banks;
//   * every slot is processed, padding included (w = 0), as on the TPU.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 512;  // rows of a source or destination block
constexpr int kChunk = 128;      // slots of a chunk
constexpr int kUnit = 32;        // slots a warp takes at a time
constexpr int kUnitsPerChunk = kChunk / kUnit;
constexpr int kBatch = 8;        // gathers in flight per lane
constexpr int kSlice = 64;       // columns of a block's output tile
constexpr int kStride = kSlice + 1;  // floats per tile row
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode { kFull = 0, kNoGather = 1, kNoScatter = 2, kScatBf16 = 3 };

// Two neighbouring columns of x, widened to f32.
__device__ __forceinline__ float2 load_pair(const float* x, size_t off) {
  return __ldg(reinterpret_cast<const float2*>(x + off));
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* x,
                                            size_t off) {
  // a bf16 is the high half of the f32 of the same value: exact widening
  const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(x + off));
  return make_float2(__uint_as_float(raw << 16),
                     __uint_as_float(raw & 0xffff0000u));
}

template <int kMode>
__device__ __forceinline__ float finish(float v) {
  if (kMode == kScatBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
spmm_lab_kernel(const int32_t* __restrict__ group_ptr,
                const int32_t* __restrict__ chunk_sb,
                const int32_t* __restrict__ packed,
                const float* __restrict__ w,
                const T* __restrict__ x,
                float* __restrict__ out,
                int group, int d) {
  extern __shared__ float tile[];  // (kBlockRows, kStride)

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * kSlice;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;  // owns columns col0 + 2 lane, + 1

  for (int i = threadIdx.x; i < kBlockRows * kStride; i += kThreads) {
    tile[i] = 0.0f;
  }
  __syncthreads();

  const int unit_end = group_ptr[b + 1] * group * kUnitsPerChunk;
  for (int u = group_ptr[b] * group * kUnitsPerChunk + warp; u < unit_end;
       u += kWarps) {
    const int s = u * kUnit + lane;
    const int p = packed[s];
    const float ws = w[s];
    const int slot = (u % kUnitsPerChunk) * kUnit + lane;
    const int row_in = chunk_sb[u / kUnitsPerChunk] * kBlockRows +
                       (kMode == kNoGather ? slot : (p & 0xFFFF));
    const int row_out = kMode == kNoScatter ? slot : (p >> 16);

#pragma unroll
    for (int k0 = 0; k0 < kUnit; k0 += kBatch) {
      float2 v[kBatch];
      float wj[kBatch];
      int rj[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int from = k0 + j;
        const int r = __shfl_sync(kFullMask, row_in, from);
        wj[j] = __shfl_sync(kFullMask, ws, from);
        rj[j] = __shfl_sync(kFullMask, row_out, from);
        v[j] = load_pair(x, static_cast<size_t>(r) * d + col0 + 2 * lane);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        float* row = tile + rj[j] * kStride;
        atomicAdd(row + lane, finish<kMode>(v[j].x * wj[j]));
        atomicAdd(row + lane + kSlice / 2, finish<kMode>(v[j].y * wj[j]));
      }
    }
  }
  __syncthreads();

  float* out_b = out + static_cast<size_t>(b) * kBlockRows * d + col0;
  for (int i = threadIdx.x; i < kBlockRows * kSlice; i += kThreads) {
    const int r = i / kSlice;
    const int c = i % kSlice;
    out_b[static_cast<size_t>(r) * d + c] =
        tile[r * kStride + (c >> 1) + (c & 1) * (kSlice / 2)];
  }
}

template <typename T, int kMode>
cudaError_t launch(const int32_t* group_ptr, const int32_t* chunk_sb,
                   const int32_t* packed, const float* w, const void* x,
                   float* out, int n_dst_blocks, int group, int d,
                   cudaStream_t stream) {
  const int smem = kBlockRows * kStride * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      spmm_lab_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_dst_blocks, d / kSlice);
  spmm_lab_kernel<T, kMode><<<grid, kThreads, smem, stream>>>(
      group_ptr, chunk_sb, packed, w, static_cast<const T*>(x), out, group,
      d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_mode(int mode, const int32_t* group_ptr,
                    const int32_t* chunk_sb, const int32_t* packed,
                    const float* w, const void* x, float* out,
                    int n_dst_blocks, int group, int d,
                    cudaStream_t stream) {
  switch (mode) {
    case kFull:
      return launch<T, kFull>(group_ptr, chunk_sb, packed, w, x, out,
                              n_dst_blocks, group, d, stream);
    case kNoGather:
      return launch<T, kNoGather>(group_ptr, chunk_sb, packed, w, x, out,
                                  n_dst_blocks, group, d, stream);
    case kNoScatter:
      return launch<T, kNoScatter>(group_ptr, chunk_sb, packed, w, x, out,
                                   n_dst_blocks, group, d, stream);
    case kScatBf16:
      return launch<T, kScatBf16>(group_ptr, chunk_sb, packed, w, x, out,
                                  n_dst_blocks, group, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one mode on `stream` (a cudaStream_t) of `device` and returns
// the CUDA error as an int: 0 when the launch was accepted. Allocates
// nothing and does not synchronise. The caller has checked the layout and
// the shapes: group_ptr (n_dst_blocks + 1), chunk_sb (n_groups * group),
// packed and w (n_groups * group * 128), x (n_src_padded, d) float32
// (x_bf16 = 0) or bfloat16 (x_bf16 = 1), out (n_dst_blocks * 512, d), all
// contiguous on `device`; 64 divides d.
extern "C" int spmm_lab(const int32_t* group_ptr, const int32_t* chunk_sb,
                        const int32_t* packed, const float* w, const void* x,
                        float* out, int n_dst_blocks, int group, int d,
                        int x_bf16, int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = x_bf16 ? by_mode<__nv_bfloat16>(mode, group_ptr, chunk_sb, packed, w,
                                        x, out, n_dst_blocks, group, d, s)
               : by_mode<float>(mode, group_ptr, chunk_sb, packed, w, x, out,
                                n_dst_blocks, group, d, s);
  return static_cast<int>(err);
}
