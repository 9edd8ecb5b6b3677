// Fused gather + dense first layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel socceraction_tpu/ops/gather_matmul.py:117
// (_kernel, launched from _forward :215 via fused_first_layer_quant :302).
// Computes, for N packed rows,
//
//     out[n, :] = bias + sum_{i<k} tables[i][ids[n, i], :] + x[n, :] @ W
//
// where an id outside [0, R) adds nothing. tables (k, R, H) and W (D, H) are
// f32 or bf16 (bf16 is widened exactly); bias (H,), x (N, D) and out (N, H)
// are f32; ids (N, k) int32. Accumulation is f32, in the order bias, the k
// gathered rows, then the dense product.
//
// Bound at the serving shape (N = 851,968 rows, k = 3, R = 552, H = 256,
// D = 55) on one H100 SXM:
//   bytes  ~1.07 GB (x 187 MB + ids 10 MB + out 872 MB + tables 1.7 MB)
//          -> 0.32 ms at 3.35 TB/s: the bound;
//   operations: the dense product as three TF32 products on the tensor
//          cores (two for a bf16 W), ~72 GFLOP -> 0.15 ms at 495 TFLOP/s,
//          and the gathers' adds, ~0.6 GFLOP of f32;
//   gathers from L2: N * k * H * 4 bytes ~2.6 GB (1.3 GB at bf16); the
//          tables stay in L2, so no design avoids this traffic.
//
// Design: warp-specialized persistent blocks, one per SM. A block owns a
// window of 128 output columns (H > 128 takes several windows, spread over
// the grid so that the windows of one row tile run side by side and share
// its x in L2) and two row groups; each group walks its own tiles of 64 rows
// with one consumer warpgroup, four producer warps, its own buffers and
// mbarriers:
//   - The producer warps (16 rows each) gather: bias + tables[0][id0] +
//     tables[1][id1] + ... in f32 with 16-byte loads (8 for a bf16 table),
//     eight rows of loads in flight per thread, into a shared tile of sums
//     (16-byte chunks XOR-swizzled by row parity: the producers' row writes
//     and the consumers' fragment reads are both free of bank conflicts).
//   - The consumer warpgroup loads the sums into its accumulators, releases
//     them to the producers (who start on the next tile), and adds the dense
//     product with wgmma on top, then stores. So the gathers' L2 latency
//     overlaps the products and stores of the tile before.
//   - Dense product at f32 accuracy: wgmma m64n128k8 in TF32 with the
//     3xTF32 split (v = hi + lo, each part rounded to TF32 to nearest, ties
//     away, as cvt.rna.tf32 does; accumulate a_lo*w_hi + a_hi*w_lo +
//     a_hi*w_hi per k-step, small terms first, and drop a_lo*w_lo). A bf16
//     W is exact in TF32, so there w_lo = 0 and two products suffice. D = 55
//     is 7 k-steps. x comes in as A fragments in registers, split once per
//     tile; W's window is split once per block (per pass, below) into hi and
//     lo tiles in shared memory (K-major, no swizzle: core matrices of 8 columns x 4
//     k-values), read by the tensor cores through descriptors.
//   - Output columns are permuted in B: inside each 16-column block the
//     accumulator element a thread holds for n8 tile j, quad lane t, element
//     e is column 4t + 2(j mod 2) + e. So the four values a thread holds for
//     tiles 2q and 2q + 1 are four adjacent columns: a 16-byte shared load
//     fills them and a 16-byte streaming store writes them, a quad covering
//     64 contiguous bytes of a row.
//   - A tile's x rows (64 * D * 4 bytes) and ids (64 * k * 4 bytes) are two
//     contiguous spans, 16-byte multiples: each is one 1-D cp.async.bulk
//     (TMA without a tensor map; x's 220-byte row stride rules out a 2-D
//     map) completing on an mbarrier. x has one buffer per group: the
//     consumers hold x as TF32 fragments in registers, four k-steps at a
//     time, and ask for the next tile's x as soon as the last of them are
//     loaded, before their products. ids are double-buffered by the
//     producers. The ragged last tile, and every tile when a base pointer is
//     not 16-byte aligned (a view with a storage offset), take plain loads.
// Columns past H and rows past N are masked; an H that is not a multiple of
// 4 (or a table not aligned for vector loads) takes scalar loads and stores.
//
// Shared memory does not grow with D or k. Where W's split window and the x
// tiles of all of D do not fit, the dense product runs in passes over
// column ranges of x (rows of W) that do: the first pass stores bias + the
// gathers + its part of the product, and each later pass re-splits W for
// its range and has the producers load the stored partial sums (instead of
// gathering) into the accumulators, adds its part and stores again; a
// tile's x comes as one bulk copy per row of its range. The partial sums
// round-trip through f32 exactly, so the passes add in the same order as
// one pass would. Several passes are a kernel instantiation of their own,
// so one pass pays nothing for them. Past IDS_STAGED_MAX_K tables the
// producers read ids straight from global memory instead of staging them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int GROUPS = 2;                            // row groups per block
constexpr int PRODUCERS = 4;                         // producer warps per group
constexpr int CONSUMER_THREADS = 128;                // one warpgroup per group
constexpr int PRODUCER_THREADS = 32 * PRODUCERS;
constexpr int THREADS = GROUPS * (CONSUMER_THREADS + PRODUCER_THREADS);
constexpr int TILE_M = 64;                           // rows of a group's tile
constexpr int BLOCK_N = 128;                         // a block's column window
constexpr int NT = BLOCK_N / 8;                      // n8 tiles of the accumulator
constexpr int CHUNKS = BLOCK_N / 4;                  // 16-byte chunks of a window row
constexpr int PRODUCER_ROWS = TILE_M / PRODUCERS;    // rows per producer warp
constexpr int ROW_BATCH = 8;                         // rows of loads in flight
constexpr int KSTEPS = 4;                            // k-steps of x held in registers at once
constexpr int IDS_STAGED_MAX_K = 16;                 // most tables whose ids are staged
constexpr size_t MAX_SMEM = 232448;                  // a block's opt-in shared memory on Hopper
// per group: x of the current tile landed, ids of stage s landed (two
// stages), sums written, sums read into the accumulators
enum { FULL_X = 0, FULL_IDS = 1, READY = 3, TAKEN = 4, BARRIERS = 5 };
constexpr int BARRIER_BYTES = 128;
static_assert(GROUPS * BARRIERS * 8 <= BARRIER_BYTES, "barriers overflow their space");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Columns c .. c + 3 of one row (c a multiple of 4) where `ok`, zero past h
// and where not. VEC: h is a multiple of 4 and every row is aligned for one
// vector access, so `ok` already implies c < h; the loads are predicated,
// not branched around.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int c, int h, bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (ok) v = __ldg(reinterpret_cast<const float4*>(p + c));
  } else {
    if (ok && c < h) v.x = __ldg(p + c);
    if (ok && c + 1 < h) v.y = __ldg(p + c + 1);
    if (ok && c + 2 < h) v.z = __ldg(p + c + 2);
    if (ok && c + 3 < h) v.w = __ldg(p + c + 3);
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int c, int h, bool ok) {
  if (VEC) {
    uint2 u = make_uint2(0u, 0u);
    if (ok) u = __ldg(reinterpret_cast<const uint2*>(p + c));
    // a bf16 is the high half of the f32 with the same value
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && c < h) v.x = widen(p[c]);
  if (ok && c + 1 < h) v.y = widen(p[c + 1]);
  if (ok && c + 2 < h) v.z = widen(p[c + 2]);
  if (ok && c + 3 < h) v.w = widen(p[c + 3]);
  return v;
}

// As load4, but through L2 only: partial sums this kernel stored in an
// earlier pass.
template <bool VEC>
__device__ __forceinline__ float4 load4_stored(const float* p, int c, int h, bool ok) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) {
    if (ok) v = __ldcg(reinterpret_cast<const float4*>(p + c));
  } else {
    if (ok && c < h) v.x = __ldcg(p + c);
    if (ok && c + 1 < h) v.y = __ldcg(p + c + 1);
    if (ok && c + 2 < h) v.z = __ldcg(p + c + 2);
    if (ok && c + 3 < h) v.w = __ldcg(p + c + 3);
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int c, int h, float4 v) {
  if (VEC) {
    if (c < h) __stcs(reinterpret_cast<float4*>(p + c), v);
  } else {
    if (c < h) __stcs(p + c, v.x);
    if (c + 1 < h) __stcs(p + c + 1, v.y);
    if (c + 2 < h) __stcs(p + c + 2, v.z);
    if (c + 3 < h) __stcs(p + c + 3, v.w);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// v's TF32 operand bits, rounded to nearest, ties away from zero (as
// cvt.rna.tf32.f32 rounds a finite v). The tensor core ignores the low 13
// bits of a TF32 operand, so they are left as they are.
__device__ __forceinline__ uint32_t tf32_bits(float v) { return __float_as_uint(v) + 0x1000u; }

// v = hi + lo + O(2^-22 |v|): hi is v rounded to TF32, lo the remainder
// rounded to TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi & 0xffffe000u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += A * B for one k-step of 8: A is this warp's 16 rows of the
// warpgroup's 64 (TF32 fragments in registers, laid out as mma.m16n8k8's A),
// B the 8 x 128 slab of W that `desc` points at.
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(1), "l"(desc));
}

// Orders the compiler's use of the accumulators against the asynchronous
// products: nothing reads or writes them across this point.
__device__ __forceinline__ void fence_accumulators(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Descriptor of a K-major, unswizzled B operand in shared memory: core
// matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo` bytes
// apart along N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barriers of one group's consumer or producer threads (id 0 is
// __syncthreads).
__device__ __forceinline__ void consumer_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(CONSUMER_THREADS) : "memory");
}
__device__ __forceinline__ void producer_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + GROUPS + grp), "n"(PRODUCER_THREADS) : "memory");
}

__host__ __device__ __forceinline__ int pad8(int v) { return (v + 7) & ~7; }

// The column of the window that accumulator column v holds: inside each
// 16-column block, v = 8j + 2t + e (n8 tile j, quad lane t, element e)
// holds column 4t + 2j + e.
__device__ __forceinline__ int fragment_column(int v) {
  return (v & ~15) | (((v >> 1) & 3) << 2) | (((v >> 3) & 1) << 1) | (v & 1);
}

// Float index of (accumulator column v, k) in a K-major B tile: core
// matrices of 8 columns x 4 k-values (128 bytes), NT apart along K.
__device__ __forceinline__ int b_index(int v, int kk) {
  return (((kk >> 2) * NT + (v >> 3)) * 8 + (v & 7)) * 4 + (kk & 3);
}

// Index of 16-byte chunk `chunk` of row `row` in a tile of gathered sums.
__device__ __forceinline__ int sum_index(int row, int chunk) {
  return row * CHUNKS + (chunk ^ ((row & 1) << 2));
}

bool ids_staged(int k) { return k <= IDS_STAGED_MAX_K; }

// Dynamic shared memory of a launch with k tables and `kc` columns of x
// per pass.
size_t smem_bytes(int k, int kc) {
  return BARRIER_BYTES + (size_t)2 * pad8(kc) * BLOCK_N * sizeof(float) +
         (size_t)GROUPS * TILE_M * BLOCK_N * sizeof(float) +
         (size_t)GROUPS * TILE_M * kc * sizeof(float) +
         (ids_staged(k) ? (size_t)GROUPS * 2 * TILE_M * k * sizeof(int32_t) : 0);
}

// Columns of x (rows of W) per pass: all of d where they fit, else the
// fewest passes of equal width, a multiple of 8, that do.
int pass_width(int k, int d) {
  if (smem_bytes(k, d) <= MAX_SMEM) return d;
  int most = 8;
  while (smem_bytes(k, most + 8) <= MAX_SMEM) most += 8;
  const int passes = (d + most - 1) / most;
  return pad8((d + passes - 1) / passes);
}

// What one row group shares between its producer and consumer warps.
struct Group {
  uint64_t* bars;  // [BARRIERS]
  float4* sums;    // (TILE_M, CHUNKS), swizzled
  float* x_s;      // (TILE_M, width of the pass)
  int32_t* id_s;   // [2] stages of (TILE_M, k)
  int col0, first, step, n_tiles;
};

// Producer warps. GATHER (the first pass): bias + the k gathered rows of
// every row of each tile, in f32, into the group's tile of sums; STAGED, they
// also stage the ids in shared memory, else they read them from global
// memory. A later pass: the partial sums the pass before stored in `out`.
// `it` counts the group's tiles over all passes (the mbarriers' phases).
// Each case is its own instantiation: no branch on them in the loops.
template <typename T, bool VEC, bool GATHER, bool STAGED>
__device__ __forceinline__ void produce(const Group& gr, const T* __restrict__ tables,
                                        const float* __restrict__ bias,
                                        const int32_t* __restrict__ ids, const float* out, int n,
                                        int k, int r, int h, int ids_bulk, int it, int grp, int pw,
                                        int lane) {
  const int pt = pw * 32 + lane;
  const uint32_t id_bytes = TILE_M * k * sizeof(int32_t);

  // ids of `tile` into stage st: one bulk copy when the tile is whole and
  // the base aligned, else plain loads by the group's producers; nothing
  // but the arrival where ids are read from global memory
  auto stage_ids = [&](int tile, int st) {
    int32_t* is = gr.id_s + st * TILE_M * k;
    uint64_t* bar = &gr.bars[FULL_IDS + st];
    const int row0 = tile * TILE_M;
    if (!STAGED) {
      if (pt == 0) mbar_arrive(bar);
    } else if (ids_bulk && row0 + TILE_M <= n) {
      if (pt == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, id_bytes);
        if (id_bytes) bulk_load(is, ids + (size_t)row0 * k, id_bytes, bar);
      }
    } else {
      const int rows = min(TILE_M, n - row0);
      for (int i = pt; i < TILE_M * k; i += PRODUCER_THREADS)
        is[i] = i < rows * k ? ids[(size_t)row0 * k + i] : -1;
      producer_sync(grp);
      if (pt == 0) mbar_arrive(bar);
    }
  };
  if (GATHER && gr.first < gr.n_tiles) stage_ids(gr.first, 0);
  if (GATHER && gr.first + gr.step < gr.n_tiles) stage_ids(gr.first + gr.step, 1);

  const int c = gr.col0 + 4 * lane;  // this thread's four columns
  const float4 bv = GATHER ? load4<VEC>(bias, c, h, c < h) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int tile = gr.first; tile < gr.n_tiles; tile += gr.step, ++it) {
    const int row0 = tile * TILE_M;
    const int st = it & 1;
    if (GATHER) mbar_wait(&gr.bars[FULL_IDS + st], (it >> 1) & 1);  // this tile's ids landed
    if (it > 0) mbar_wait(&gr.bars[TAKEN], (it - 1) & 1);  // the last tile's sums were read
    const int32_t* is = gr.id_s + st * TILE_M * k;
#pragma unroll 1
    for (int r0 = pw * PRODUCER_ROWS; r0 < (pw + 1) * PRODUCER_ROWS; r0 += ROW_BATCH) {
      float4 s[ROW_BATCH];
      if (GATHER) {
#pragma unroll
        for (int rr = 0; rr < ROW_BATCH; ++rr) s[rr] = bv;
        for (int i = 0; i < k; ++i) {
          float4 v[ROW_BATCH];
#pragma unroll
          for (int rr = 0; rr < ROW_BATCH; ++rr) {
            const int row = row0 + r0 + rr;
            const int id = STAGED ? is[(r0 + rr) * k + i]
                           : row < n ? __ldg(ids + (size_t)row * k + i)
                                     : -1;
            const bool ok = (unsigned)id < (unsigned)r;
            const T* trow = tables + ((size_t)i * r + (ok ? id : 0)) * h;
            v[rr] = load4<VEC>(trow, c, h, ok && c < h);
          }
#pragma unroll
          for (int rr = 0; rr < ROW_BATCH; ++rr) add4(s[rr], v[rr]);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < ROW_BATCH; ++rr) {
          const int row = row0 + r0 + rr;
          s[rr] = load4_stored<VEC>(out + (size_t)row * h, c, h, row < n && c < h);
        }
      }
#pragma unroll
      for (int rr = 0; rr < ROW_BATCH; ++rr) gr.sums[sum_index(r0 + rr, lane)] = s[rr];
    }
    producer_sync(grp);  // every producer is done with stage st's ids
    if (GATHER && tile + 2 * gr.step < gr.n_tiles) stage_ids(tile + 2 * gr.step, st);
    mbar_arrive(&gr.bars[READY]);
  }
}

// The consumer warpgroup: the sums into the accumulators, this pass's
// columns of x into TF32 fragments, the dense product with wgmma on top,
// the result to `out`. It also stages x. `it` as for the producers.
template <typename T, bool VEC, bool MULTI>
__device__ __forceinline__ void consume(const Group& gr, const float* __restrict__ b_hi,
                                        const float* __restrict__ b_lo,
                                        const float* __restrict__ x_all, float* __restrict__ out,
                                        int n, int h, int d, int kc, int x_bulk, int pass, int it,
                                        int grp, int ct) {
  const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
  const int width = min(kc, d - pass * kc);  // this pass's columns of x
  const float* x = x_all + pass * kc;
  const int dp = pad8(width);
  const uint32_t x_bytes = TILE_M * width * sizeof(float);
  // B tiles: core matrices 128 bytes apart along N, NT * 128 along K; one
  // k-step (two core matrices along K) further on is 2 * NT * 128 bytes
  constexpr uint32_t LBO = NT * 128, SBO = 128, KSTEP_BYTES = 2 * NT * 128;

  // x of `tile`: bulk copies when the tile is whole and x_bulk allows them
  // (one copy of the tile in one pass, one per row in several), else plain
  // loads by the group's consumers
  auto stage_x = [&](int tile) {
    const int row0 = tile * TILE_M;
    if (x_bulk && row0 + TILE_M <= n) {
      if (ct == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&gr.bars[FULL_X], x_bytes);
        if (MULTI) {
          for (int rr = 0; rr < TILE_M; ++rr)
            bulk_load(gr.x_s + rr * width, x + (size_t)(row0 + rr) * d, width * sizeof(float),
                      &gr.bars[FULL_X]);
        } else if (x_bytes) {
          bulk_load(gr.x_s, x + (size_t)row0 * d, x_bytes, &gr.bars[FULL_X]);
        }
      }
    } else {
      const int rows = min(TILE_M, n - row0);
      for (int i = ct; i < TILE_M * width; i += CONSUMER_THREADS) {
        const int rr = i / width, cc = i - rr * width;
        gr.x_s[i] = rr < rows ? x[(size_t)(row0 + rr) * d + cc] : 0.0f;
      }
      consumer_sync(grp);
      if (ct == 0) mbar_arrive(&gr.bars[FULL_X]);
    }
  };
  if (gr.first < gr.n_tiles) stage_x(gr.first);

  for (int tile = gr.first; tile < gr.n_tiles; tile += gr.step, ++it) {
    const int row0 = tile * TILE_M;
    const int rows = min(TILE_M, n - row0);
    // acc[j]: rows 16 warp + g (elements 0, 1) and + 8 (elements 2, 3); the
    // four window columns 16 q + 4 t + {0, 1, 2, 3} are acc[2q][0, 1] and
    // acc[2q + 1][0, 1] (elements 2, 3 for the second row)
    float acc[NT][4];
    mbar_wait(&gr.bars[READY], it & 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const float4 v = gr.sums[sum_index(row, 4 * q + t)];
        acc[2 * q][2 * half] = v.x;
        acc[2 * q][2 * half + 1] = v.y;
        acc[2 * q + 1][2 * half] = v.z;
        acc[2 * q + 1][2 * half + 1] = v.w;
      }
    }
    mbar_arrive(&gr.bars[TAKEN]);
    mbar_wait(&gr.bars[FULL_X], it & 1);
    const float* xa = gr.x_s + (16 * warp + g) * width;  // rows g and g + 8 of this warp
    for (int k0 = 0; k0 < dp; k0 += 8 * KSTEPS) {
      uint32_t a_hi[KSTEPS][4], a_lo[KSTEPS][4];
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int c0 = k0 + 8 * s + t, c1 = c0 + 4;
        split_tf32(c0 < width ? xa[c0] : 0.0f, a_hi[s][0], a_lo[s][0]);
        split_tf32(c0 < width ? xa[8 * width + c0] : 0.0f, a_hi[s][1], a_lo[s][1]);
        split_tf32(c1 < width ? xa[c1] : 0.0f, a_hi[s][2], a_lo[s][2]);
        split_tf32(c1 < width ? xa[8 * width + c1] : 0.0f, a_hi[s][3], a_lo[s][3]);
      }
      if (k0 + 8 * KSTEPS >= dp) {
        // x is in registers: the next tile's may land while this one computes
        consumer_sync(grp);
        if (tile + gr.step < gr.n_tiles) stage_x(tile + gr.step);
      }
      fence_accumulators(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        if (k0 + 8 * s < dp) {
          const uint32_t off = (uint32_t)((k0 / 8 + s) * KSTEP_BYTES);
          const uint64_t hi = smem_desc(reinterpret_cast<const char*>(b_hi) + off, LBO, SBO);
          wgmma_tf32(acc, a_lo[s], hi);
          if constexpr (sizeof(T) == sizeof(float)) {
            wgmma_tf32(acc, a_hi[s],
                       smem_desc(reinterpret_cast<const char*>(b_lo) + off, LBO, SBO));
          }
          wgmma_tf32(acc, a_hi[s], hi);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_accumulators(acc);
    }
    if (dp == 0) {
      consumer_sync(grp);
      if (tile + gr.step < gr.n_tiles) stage_x(tile + gr.step);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;
      if (row < rows) {
        float* o = out + (size_t)(row0 + row) * h;
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
          store4<VEC>(o, gr.col0 + 16 * q + 4 * t, h,
                      make_float4(acc[2 * q][2 * half], acc[2 * q][2 * half + 1],
                                  acc[2 * q + 1][2 * half], acc[2 * q + 1][2 * half + 1]));
        }
      }
    }
  }
}

// VEC: h is a multiple of 4 and tables, bias and out are aligned for
// 16-byte (8 for a bf16 table) accesses. MULTI: several passes over D (a
// separate instantiation, so that one pass pays nothing for the loop).
// kc: columns of x per pass (d: one pass); x_bulk: x's whole tiles by bulk
// copy (base 16-byte aligned, and with MULTI rows of whole 16-byte
// multiples); ids_staged: ids staged in shared memory (k <=
// IDS_STAGED_MAX_K); ids_bulk: staged ids' whole tiles by bulk copy (base
// 16-byte aligned).
template <typename T, bool VEC, bool MULTI>
__global__ void __launch_bounds__(THREADS, 1)
gather_matmul_kernel(const T* __restrict__ tables, const T* __restrict__ w,
                     const float* __restrict__ bias, const int32_t* __restrict__ ids,
                     const float* __restrict__ x, float* __restrict__ out, int n, int k, int r,
                     int h, int d, int kc, int x_bulk, int ids_staged, int ids_bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kcp = pad8(kc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int windows = (h + BLOCK_N - 1) / BLOCK_N;
  const int col0 = (int)(blockIdx.x % windows) * BLOCK_N;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* b_hi = reinterpret_cast<float*>(smem + BARRIER_BYTES);  // (kcp, BLOCK_N), K-major
  float* b_lo = b_hi + kcp * BLOCK_N;
  float4* sums = reinterpret_cast<float4*>(b_lo + kcp * BLOCK_N);
  float* x_s = reinterpret_cast<float*>(sums + GROUPS * TILE_M * CHUNKS);
  int32_t* id_s = reinterpret_cast<int32_t*>(x_s + GROUPS * TILE_M * kc);

  // warps [0, 4 GROUPS): one consumer warpgroup per group; the rest produce
  const bool consumer = warp < 4 * GROUPS;
  const int grp = consumer ? warp / 4 : (warp - 4 * GROUPS) / PRODUCERS;
  Group gr;
  gr.bars = bars + grp * BARRIERS;
  gr.sums = sums + grp * TILE_M * CHUNKS;
  gr.x_s = x_s + grp * TILE_M * kc;
  gr.id_s = id_s + grp * 2 * TILE_M * k;
  gr.col0 = col0;
  gr.n_tiles = (n + TILE_M - 1) / TILE_M;
  gr.first = (int)(blockIdx.x / windows) * GROUPS + grp;
  gr.step = (int)(gridDim.x / windows) * GROUPS;
  // the group's tiles in one pass: the same in every pass
  const int per_pass = gr.first < gr.n_tiles ? (gr.n_tiles - gr.first + gr.step - 1) / gr.step : 0;
  const int passes = MULTI ? (d + kc - 1) / kc : 1;

  for (int pass = 0; pass < passes; ++pass) {
    // the pass before is done with W's tiles and has stored its partial
    // sums, which this pass's producers read
    if (pass > 0) __syncthreads();
    // this pass's rows of W's window split into TF32 hi and lo tiles, zero
    // past them and past h
    const int k0 = pass * kc, width = min(kc, d - k0);
    for (int i = threadIdx.x; i < kcp * BLOCK_N; i += THREADS) {
      const int kk = i / BLOCK_N, v = i - kk * BLOCK_N;
      const int c = col0 + fragment_column(v);
      const float wv = (kk < width && c < h) ? widen(w[(size_t)(k0 + kk) * h + c]) : 0.0f;
      uint32_t hi, lo;
      split_tf32(wv, hi, lo);
      b_hi[b_index(v, kk)] = __uint_as_float(hi);
      b_lo[b_index(v, kk)] = __uint_as_float(lo);
    }
    if (pass == 0 && threadIdx.x == 0) {
      for (int b = 0; b < GROUPS * BARRIERS; b += BARRIERS) {
        mbar_init(&bars[b + FULL_X], 1);
        mbar_init(&bars[b + FULL_IDS], 1);
        mbar_init(&bars[b + FULL_IDS + 1], 1);
        mbar_init(&bars[b + READY], PRODUCER_THREADS);
        mbar_init(&bars[b + TAKEN], CONSUMER_THREADS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the tensor cores read the B tiles through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (consumer) {
      consume<T, VEC, MULTI>(gr, b_hi, b_lo, x, out, n, h, d, kc, x_bulk, pass, pass * per_pass, grp,
                      threadIdx.x - grp * CONSUMER_THREADS);
    } else {
      const int pw = (warp - 4 * GROUPS) % PRODUCERS, it = pass * per_pass;
      if (MULTI && pass > 0) {
        produce<T, VEC, false, false>(gr, tables, bias, ids, out, n, k, r, h, ids_bulk, it, grp,
                                      pw, lane);
      } else if (ids_staged) {
        produce<T, VEC, true, true>(gr, tables, bias, ids, out, n, k, r, h, ids_bulk, it, grp, pw,
                                    lane);
      } else {
        produce<T, VEC, true, false>(gr, tables, bias, ids, out, n, k, r, h, ids_bulk, it, grp,
                                     pw, lane);
      }
    }
  }
}

// Resident blocks on the card for one kernel at one shared-memory size,
// computed once per (device, type, size): a call is then one launch.
struct Plan {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename T, bool VEC, bool MULTI>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static Plan plan;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (plan.device != device || plan.smem != smem) {
    // the most any launch asks for, so no later plan can leave a lower
    // limit behind for an earlier one
    if ((err = cudaFuncSetAttribute(gather_matmul_kernel<T, VEC, MULTI>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)MAX_SMEM)) != cudaSuccess)
      return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gather_matmul_kernel<T, VEC, MULTI>, THREADS, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    plan = {device, smem, sms * per_sm};
  }
  *blocks = plan.blocks;
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, bool VEC, bool MULTI>
cudaError_t launch_as(const T* tables, const T* w, const float* bias, const int32_t* ids,
                      const float* x, float* out, int n, int k, int r, int h, int d, int kc,
                      bool x_bulk, cudaStream_t stream) {
  const size_t smem = smem_bytes(k, kc);
  int cap = 0;
  cudaError_t err = resident_blocks<T, VEC, MULTI>(smem, &cap);
  if (err != cudaSuccess) return err;
  // every window gets the same number of blocks; consecutive blocks take
  // the windows of the same row tiles
  const int windows = (h + BLOCK_N - 1) / BLOCK_N;
  const int pairs = (n + GROUPS * TILE_M - 1) / (GROUPS * TILE_M);
  const int per_window = std::max(1, std::min(cap / windows, pairs));
  gather_matmul_kernel<T, VEC, MULTI><<<windows * per_window, THREADS, smem, stream>>>(
      tables, w, bias, ids, x, out, n, k, r, h, d, kc, x_bulk, ids_staged(k), aligned(ids, 16));
  return cudaGetLastError();
}

template <typename T>
int launch(const T* tables, const T* w, const float* bias, const int32_t* ids, const float* x,
           float* out, int n, int k, int r, int h, int d, void* stream, int* plan) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kc = pass_width(k, d);
  const bool multi = kc < d;
  const bool vec = h % 4 == 0 && aligned(tables, 4 * sizeof(T)) && aligned(bias, 16) &&
                   aligned(out, 16);
  // several passes copy x row by row: each row's part a 16-byte multiple
  // (kc is a multiple of 8 there)
  const bool x_bulk = aligned(x, 16) && (!multi || d % 4 == 0);
  if (plan != nullptr) *plan = (vec ? 1 : 0) | (multi ? 2 : 0) | (x_bulk ? 4 : 0);
  cudaError_t err;
  if (multi) {
    err = vec ? launch_as<T, true, true>(tables, w, bias, ids, x, out, n, k, r, h, d, kc, x_bulk, st)
              : launch_as<T, false, true>(tables, w, bias, ids, x, out, n, k, r, h, d, kc, x_bulk, st);
  } else {
    err = vec ? launch_as<T, true, false>(tables, w, bias, ids, x, out, n, k, r, h, d, kc, x_bulk, st)
              : launch_as<T, false, false>(tables, w, bias, ids, x, out, n, k, r, h, d, kc, x_bulk, st);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, for the wrapper's size check (it
// does not depend on H: a block holds one 128-column window; nor does it
// grow with D or k, which take passes or ids read from global memory).
size_t gather_matmul_smem_bytes(int k, int h, int d) {
  (void)h;
  return smem_bytes(k, pass_width(k, d));
}

// Each returns the cudaError_t of the launch (0 on success); the launch is
// asynchronous on `stream` and allocates nothing. Unless `plan` is null it
// receives the instantiation launched: bit 0 vector table and output
// access, bit 1 several passes over D, bit 2 x streamed by bulk copies.
int gather_matmul_f32(const void* tables, const void* w, const void* bias, const void* ids,
                      const void* x, void* out, int n, int k, int r, int h, int d, void* stream,
                      int* plan) {
  return launch(static_cast<const float*>(tables), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<const int32_t*>(ids),
                static_cast<const float*>(x), static_cast<float*>(out), n, k, r, h, d, stream,
                plan);
}

int gather_matmul_bf16(const void* tables, const void* w, const void* bias, const void* ids,
                       const void* x, void* out, int n, int k, int r, int h, int d, void* stream,
                       int* plan) {
  return launch(static_cast<const __nv_bfloat16*>(tables), static_cast<const __nv_bfloat16*>(w),
                static_cast<const float*>(bias), static_cast<const int32_t*>(ids),
                static_cast<const float*>(x), static_cast<float*>(out), n, k, r, h, d, stream,
                plan);
}

}  // extern "C"
