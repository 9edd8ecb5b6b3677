// Fused gather + dense first layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel socceraction_tpu/ops/gather_matmul.py:117
// (_kernel, launched from _forward :215 via fused_first_layer_quant :302).
// Computes, for N packed rows,
//
//     out[n, :] = bias + sum_{i<k} tables[i][ids[n, i], :] + x[n, :] @ W
//
// where an id outside [0, R) adds nothing. tables (k, R, H) and W (D, H) are
// f32 or bf16 (bf16 is widened with __bfloat162float); bias (H,), x (N, D)
// and out (N, H) are f32; ids (N, k) int32. Accumulation is f32, in the
// order bias, the k gathered rows, then a sequential FMA over D.
//
// Bound at the serving shape (N = 851,968 rows, k = 3, R = 552, H = 256,
// D = 55) on one H100 SXM:
//   bytes  ~1.07 GB (x 187 MB + ids 10 MB + out 872 MB + tables 1.7 MB)
//          -> 0.32 ms at 3.35 TB/s;
//   flops  ~24.6 GFLOP of f32 (2*N*D*H = 24.0 for the dense product, plus
//          one add per valid gathered element) -> 0.37 ms at 67 TFLOP/s.
// So the kernel is bound by f32 compute at about 0.37 ms. TF32 and the
// tensor cores are ruled out: the port holds the first layer to 1e-5 of
// the f32 reference.
//
// Design (simple first; fast is later work). On the TPU each gather was
// recast as a one-hot MXU contraction; on Hopper a direct row gather is the
// natural form:
//   - persistent blocks stride over tiles of ROWS rows, so W is staged in
//     shared memory (widened to f32) once per block, not once per tile;
//     at f32 it is 55*256*4 = 56 KB, over the 48 KB static limit, so the
//     launch raises cudaFuncAttributeMaxDynamicSharedMemorySize;
//   - a tile's x rows are staged with a row stride padded to a multiple of
//     4 floats (the pad is zero, and so are W's padded rows) and read as
//     float4 broadcasts; its ids are staged beside them;
//   - each thread owns output columns and keeps the ROWS accumulators of
//     its column in registers; every W value it loads from shared memory
//     feeds ROWS FMAs;
//   - table rows are read straight from global memory (the 1.7 MB of
//     tables stay in the 50 MB L2), coalesced across the columns of a warp;
//     out is written the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int ROWS = 32;         // rows per tile (accumulators per thread)
constexpr int MAX_THREADS = 256;  // threads per block (one column each)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
gather_matmul_kernel(const T* __restrict__ tables, const T* __restrict__ w,
                     const float* __restrict__ bias, const int32_t* __restrict__ ids,
                     const float* __restrict__ x, float* __restrict__ out,
                     int n, int k, int r, int h, int d, int dp) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                 // (dp, h)
  float* x_s = w_s + (size_t)dp * h;                 // (ROWS, dp)
  int32_t* id_s = reinterpret_cast<int32_t*>(x_s + ROWS * dp);  // (ROWS, k)

  for (int i = threadIdx.x; i < dp * h; i += blockDim.x) {
    w_s[i] = (i / h) < d ? widen(w[i]) : 0.0f;
  }

  const int n_tiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    const int rows = min(ROWS, n - row0);
    __syncthreads();  // W staged / the previous tile's readers are done
    for (int i = threadIdx.x; i < ROWS * dp; i += blockDim.x) {
      const int rr = i / dp, dd = i - rr * dp;
      x_s[i] = (rr < rows && dd < d) ? x[(size_t)(row0 + rr) * d + dd] : 0.0f;
    }
    for (int i = threadIdx.x; i < ROWS * k; i += blockDim.x) {
      id_s[i] = (i / k) < rows ? ids[(size_t)row0 * k + i] : -1;
    }
    __syncthreads();

    for (int col = threadIdx.x; col < h; col += blockDim.x) {
      float acc[ROWS];
      const float b = bias[col];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) acc[rr] = b;
      for (int i = 0; i < k; ++i) {
        const T* t = tables + (size_t)i * r * h + col;
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int id = id_s[rr * k + i];
          if (id >= 0 && id < r) acc[rr] += widen(t[(size_t)id * h]);
        }
      }
      for (int dd = 0; dd < dp; dd += 4) {
        const float w0 = w_s[(dd + 0) * h + col];
        const float w1 = w_s[(dd + 1) * h + col];
        const float w2 = w_s[(dd + 2) * h + col];
        const float w3 = w_s[(dd + 3) * h + col];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const float4 xv = *reinterpret_cast<const float4*>(&x_s[rr * dp + dd]);
          acc[rr] = fmaf(xv.x, w0, acc[rr]);
          acc[rr] = fmaf(xv.y, w1, acc[rr]);
          acc[rr] = fmaf(xv.z, w2, acc[rr]);
          acc[rr] = fmaf(xv.w, w3, acc[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        if (rr < rows) out[(size_t)(row0 + rr) * h + col] = acc[rr];
      }
    }
  }
}

size_t smem_bytes(int k, int h, int dp) {
  return ((size_t)dp * h + (size_t)ROWS * dp) * sizeof(float) + (size_t)ROWS * k * sizeof(int32_t);
}

template <typename T>
int launch(const T* tables, const T* w, const float* bias, const int32_t* ids,
           const float* x, float* out, int n, int k, int r, int h, int d, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  const int dp = (d + 3) / 4 * 4;
  const size_t smem = smem_bytes(k, h, dp);
  const int threads = std::min(MAX_THREADS, (h + 31) / 32 * 32);
  cudaError_t err = cudaFuncSetAttribute(gather_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_matmul_kernel<T>,
                                                           threads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n + ROWS - 1) / ROWS;
  const int grid = std::min(n_tiles, sms * per_sm);
  gather_matmul_kernel<T><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      tables, w, bias, ids, x, out, n, k, r, h, d, dp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, for the wrapper's size check.
size_t gather_matmul_smem_bytes(int k, int h, int d) { return smem_bytes(k, h, (d + 3) / 4 * 4); }

// Each returns the cudaError_t of the launch (0 on success); the launch is
// asynchronous on `stream` and allocates nothing.
int gather_matmul_f32(const void* tables, const void* w, const void* bias, const void* ids,
                      const void* x, void* out, int n, int k, int r, int h, int d, void* stream) {
  return launch(static_cast<const float*>(tables), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<const int32_t*>(ids),
                static_cast<const float*>(x), static_cast<float*>(out), n, k, r, h, d, stream);
}

int gather_matmul_bf16(const void* tables, const void* w, const void* bias, const void* ids,
                       const void* x, void* out, int n, int k, int r, int h, int d, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(tables), static_cast<const __nv_bfloat16*>(w),
                static_cast<const float*>(bias), static_cast<const int32_t*>(ids),
                static_cast<const float*>(x), static_cast<float*>(out), n, k, r, h, d, stream);
}

}  // extern "C"
