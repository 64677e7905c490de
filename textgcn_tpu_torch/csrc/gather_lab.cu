// L2 and L3 on Hopper: the gather lab's two kernels, out[i] = x[ids[i]].
//
// Replaces the TPU kernels of the JAX lab tools/gather_lab.py:
//   * L2, make_onehot (pallas_call at :85): on the TPU a (128, 512)
//     one-hot matmul selects each chunk's rows from a VMEM-resident source
//     block. Here it is a plain row gather (gather_rows_f32): one thread
//     per 16-byte vector of the output, so 16 neighbouring lanes move one
//     d = 64 row, the id read once per lane from L1, the stores coalesced.
//     No one-hot and no source block are carried over.
//   * L3, make_dma (pallas_call at :150): on the TPU one asynchronous copy
//     per row, 128 in flight per grid step, into VMEM, then one write of
//     the (128, d) tile. Here (gather_rows_bulk_f32) a thread block takes
//     128 ids; lanes of its first warp start one
//     cp.async.bulk.shared::cluster.global (the TMA engine's 1-D bulk copy)
//     of d * 4 bytes per row into a shared tile, all completing on one
//     mbarrier whose transaction count is the tile's bytes; every thread
//     waits on the barrier's phase and the tile is stored with coalesced
//     16-byte stores.
//
// What bounds both: memory traffic. The output (600,064 x 64 f32, 154 MB,
// for L2; 131,072 x 128 f32, 67 MB, for L3) is written once, the ids and
// the table read once: ~48 us and ~24 us at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGatherThreads = 256;
constexpr int kBulkRows = 128;     // rows a block gathers, as the TPU's C
constexpr int kBulkThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const float4* __restrict__ x,
                   const int32_t* __restrict__ ids,
                   float4* __restrict__ out, int64_t n_vec,
                   int vec_per_row) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kGatherThreads +
                    threadIdx.x;
  if (i >= n_vec) return;
  const int64_t row = i / vec_per_row;
  const int v = static_cast<int>(i - row * vec_per_row);
  out[i] = __ldg(x + static_cast<int64_t>(__ldg(ids + row)) * vec_per_row +
                 v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kBulkThreads)
gather_rows_bulk_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, int n, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);  // (kBulkRows, d)
  // the barrier sits after the tile: kBulkRows * d * 4 is a multiple of 16
  const uint32_t bar = smem_addr(smem + kBulkRows * d * sizeof(float));
  const int base = blockIdx.x * kBulkRows;
  const int rows = min(kBulkRows, n - base);
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(float);

  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      // the one arrival, with the bytes the copies will complete
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(rows * row_bytes)
          : "memory");
    }
    __syncwarp();
    for (int i = threadIdx.x; i < rows; i += 32) {
      const float* src = x + static_cast<int64_t>(ids[base + i]) * d;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(tile + i * d)),
          "l"(src), "r"(row_bytes), "r"(bar)
          : "memory");
    }
  }

  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(0)
        : "memory");
  } while (!done);

  const float4* t4 = reinterpret_cast<const float4*>(tile);
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<int64_t>(base) * d);
  for (int i = threadIdx.x; i < rows * d / 4; i += kBulkThreads) {
    o4[i] = t4[i];
  }
}

}  // namespace

// L2. Launches on `stream` (a cudaStream_t) of `device` and returns the CUDA
// error as an int: 0 when the launch was accepted. Allocates nothing and
// does not synchronise. The caller has checked: x (n_src, d) and out
// (n, d) float32, ids (n,) int32 in [0, n_src), all contiguous on `device`,
// d a multiple of 4, x and out 16-byte aligned, n > 0.
extern "C" int gather_rows_f32(const float* x, const int32_t* ids, float* out,
                               int64_t n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_vec = n * (d / 4);
  const int64_t blocks = (n_vec + kGatherThreads - 1) / kGatherThreads;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), ids, reinterpret_cast<float4*>(out),
      n_vec, d / 4);
  return static_cast<int>(cudaGetLastError());
}

// L3. As gather_rows_f32, with n < 2^31 and the (128, d) float32 tile plus
// an 8-byte barrier within the 227 KB a block may opt in to (d <= 448).
extern "C" int gather_rows_bulk_f32(const float* x, const int32_t* ids,
                                    float* out, int n, int d, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = kBulkRows * d * static_cast<int>(sizeof(float)) + 8;
  err = cudaFuncSetAttribute(gather_rows_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBulkRows - 1) / kBulkRows;
  gather_rows_bulk_kernel<<<blocks, kBulkThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(x, ids, out,
                                                                 n, d);
  return static_cast<int>(cudaGetLastError());
}
