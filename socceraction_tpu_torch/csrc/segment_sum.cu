// Segment sum (scatter-add) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel socceraction_tpu/ops/segment.py:94
// (_kernel, launched by segment_sum_pallas :117 via segment_sum :178 and
// segment_sum_2d :211). Computes, for a stream of N (value, id) pairs,
//
//     out[s] = sum_{c : ids[c] == s} vals[c]        for 0 <= s < S
//
// where an id outside [0, S), negatives included, adds nothing. vals are
// f32, ids int32, out (S,) f32; accumulation is f32. The kernel zeroes
// `out` itself (cudaMemsetAsync on the same stream) before it adds.
//
// Bound, counted for the xT slice's stream (N = 5,111,808 actions) on one
// H100 SXM: every input read once (N * 8 bytes = 40.9 MB) and the output
// written once (S * 4 bytes), about 12 us at 3.35 TB/s. There are no
// multiplications at all, so the kernel is bound by bytes; what it does
// beyond that bound is atomic traffic.
//
// Design (simple first; fast is later work). On the TPU the scatter was
// recast as a blocked one-hot MXU contraction (cost N x S MACs), because
// the TPU serializes conflicting scatter updates. Hopper has native f32
// atomics in shared and global memory, so the natural form is an atomic
// scatter, in two regimes chosen by S:
//   - S * 4 bytes fits in one block's shared memory (the opt-in dynamic
//     limit, 232,448 bytes: S <= 58,112): each block zeroes a private
//     histogram in shared memory, grid-strides over the stream with shared
//     atomicAdd, and flushes its nonzero bins into `out` with global
//     atomicAdd. A small S (192 cells) would otherwise put every SM's
//     atomics on a few hundred global addresses. The grid is at least one
//     block per SM and at most what fits at once, and shrinks towards one
//     block per SM when a block would see fewer than MIN_ITEMS_PER_BIN
//     stream items per histogram bin (the flush would then cost as much
//     as the stream).
//   - a larger S (the grouped fleets): one global atomicAdd per item.
// Both regimes skip items whose value is exactly zero (adding +0.0 or
// -0.0 to a sum that starts at +0.0 never changes it): in the xT stream
// most items are masked out to zero. An unsigned compare drops ids
// outside [0, S) in one test. Counts (integer-valued f32 below 2^24) come
// out exact in any order; real values differ from a sequential sum by
// reordering only.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 512;
constexpr int MIN_ITEMS_PER_BIN = 4;

__global__ void __launch_bounds__(THREADS)
segment_sum_shared_kernel(const float* __restrict__ vals, const int32_t* __restrict__ ids,
                          float* __restrict__ out, long long n, int s) {
  extern __shared__ float hist[];
  for (int i = threadIdx.x; i < s; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = vals[i];
    const unsigned id = (unsigned)ids[i];
    if (v != 0.0f && id < (unsigned)s) atomicAdd(&hist[id], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const float h = hist[i];
    if (h != 0.0f) atomicAdd(&out[i], h);
  }
}

__global__ void __launch_bounds__(THREADS)
segment_sum_global_kernel(const float* __restrict__ vals, const int32_t* __restrict__ ids,
                          float* __restrict__ out, long long n, int s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float v = vals[i];
    const unsigned id = (unsigned)ids[i];
    if (v != 0.0f && id < (unsigned)s) atomicAdd(&out[id], v);
  }
}

// Blocks of one kernel resident on an SM at `smem` bytes of dynamic shared
// memory, and the SM count; 0 on success.
template <typename K>
cudaError_t residency(K kernel, size_t smem, int* per_sm, int* sms) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem);
}

bool fits_shared(int s, int max_smem) { return (size_t)s * sizeof(float) <= (size_t)max_smem; }

// Grid of one launch (0 when the launch is refused), and its regime.
cudaError_t plan(long long n, int s, int max_smem, int* grid, int* shared, int* per_sm) {
  int sms = 0;
  cudaError_t err;
  *shared = fits_shared(s, max_smem);
  const long long work = (n + THREADS - 1) / THREADS;
  if (*shared) {
    const size_t smem = (size_t)s * sizeof(float);
    if ((err = residency(segment_sum_shared_kernel, smem, per_sm, &sms)) != cudaSuccess) return err;
    if (*per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long by_bins = n / ((long long)MIN_ITEMS_PER_BIN * std::max(s, 1));
    long long g = std::max((long long)sms, by_bins);
    g = std::min(g, (long long)sms * *per_sm);
    *grid = (int)std::max(1LL, std::min(g, work));
  } else {
    if ((err = residency(segment_sum_global_kernel, 0, per_sm, &sms)) != cudaSuccess) return err;
    if (*per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = (int)std::max(1LL, std::min((long long)sms * *per_sm, work));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch plan for the wrapper's record: writes the grid, the regime
// (1 shared, 0 global) and the blocks an SM holds at once. Returns the
// cudaError_t (0 on success).
int segment_sum_plan(long long n, int s, int max_smem, int* grid, int* shared, int* per_sm) {
  return (int)plan(n, s, max_smem, grid, shared, per_sm);
}

// out[s] = sum of vals[c] over ids[c] == s, for the S = `s` segments of
// `out`. Returns the cudaError_t of the launch (0 on success); the memset
// and the launch are asynchronous on `stream` and allocate nothing.
int segment_sum_f32(const void* vals, const void* ids, void* out, long long n, int s,
                    int max_smem, void* stream) {
  if (s <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)s * sizeof(float), st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  int grid = 0, shared = 0, per_sm = 0;
  if ((err = plan(n, s, max_smem, &grid, &shared, &per_sm)) != cudaSuccess) return (int)err;
  const float* v = static_cast<const float*>(vals);
  const int32_t* i = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  if (shared) {
    segment_sum_shared_kernel<<<grid, THREADS, (size_t)s * sizeof(float), st>>>(v, i, o, n, s);
  } else {
    segment_sum_global_kernel<<<grid, THREADS, 0, st>>>(v, i, o, n, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
