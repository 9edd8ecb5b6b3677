// GRU sequence head for Hopper (sm_90a): one head's logits in one launch.
//
// Replaces no TPU kernel. On the TPU, XLA fuses socceraction_tpu/seq/model.py's
// _gru_pass and readout by itself. The port's eager version (seq/model.py:
// table_lookup, _gru_pass, _readout, the plain version this kernel is held to)
// runs some 55 kernels a head: at each of the k steps six float32 products
// and about a dozen elementwise passes over (N, H) tensors, the embedding's
// (N, k, E) gather and the readout's (N, H + D) concatenation, each written
// to device memory and read back. This kernel computes what that version
// returns,
//
//     logits (N,) f32 = relu([h, (x_dense - mean) / std]·w1 + b1)·w2 + b2
//
// where h is the GRU's last hidden state over the k tokens of each row, oldest
// (token k-1) to newest (token 0), with the JAX cell's equations: one bias a
// gate, the reset gate applied to h before its product with uh, and
// h = (1 - z)·h + z·hh. It reads x_dense (N, D), the ids (N, k) and the head's
// parameters, and writes only the logits.
//
// Bound, at the season cells' 1024 x 1664 chunk (N = 1,703,936) and the
// default widths (E 32, H 64, R 64, D 55, k 3) on one H100 SXM: the reads
// and the write are 0.40 GB, 0.12 ms at 3.35 TB/s, while a head's products
// are 62,976 multiply-adds a row (3 steps x 3 gates x (E + H) x H, then
// (H + D) x R + R), 4.3e11 FLOPs for two heads, 6.4 ms at the card's
// float32 FFMA rate (132 SMs x 128 lanes x 2 x 1.98 GHz). So the kernel is
// bound by its products, and its design is to run them on the tensor cores
// at float32 accuracy and keep everything else on the SM:
//
//   - Products on the tensor cores in TF32 with the 3xTF32 split, as B1
//     (csrc/gather_matmul.cu): v = hi + lo, each rounded to TF32, and
//     a_lo·w_hi + a_hi·w_lo + a_hi·w_hi accumulated in float32, small terms
//     first, which keeps float32's accuracy (never a single TF32 pass: the
//     cell's control, with TF32 products, reads 1.2e-5 against its 1e-6
//     limit). mma.sync m16n8k8: a pair of warps owns a tile of 32 rows, each
//     warp half of every gate's columns, so the recurrence needs no barrier
//     but the pair's own (a named barrier of 64 threads), and each split of
//     a weight feeds two 16-row MMA tiles.
//   - Nothing leaves the SM but the logits. A block (4 pairs, fewer where a
//     wider head's weights need the room; one block an SM) keeps the head's
//     weights in shared memory (wz|wr|wh, uz|ur|uh and
//     w1, zero-padded to whole 8-column MMA tiles; 113 KB at the default
//     widths), split into TF32 halves as they are read. Each pair keeps its
//     tile's token embedding, h (then r·h in its place) and standardized
//     dense columns in shared memory as MMA A operands (21 KB a pair), and
//     the gates and h in registers. Row strides are padded so that every
//     fragment load is free of bank conflicts.
//   - The first token's products with h are skipped: h is 0 there, so they
//     add exact zeros, and so is its reset gate, which only multiplies h.
//   - The input side e·w* + b* is computed in the kernel, once a row (design
//     (a)), not projected through w* once a call into a 552 x 192 table and
//     gathered 768 bytes a token (design (b)): on the CUDA cores, a variant
//     with no input-side products at all ran 3.69 ms a head against 4.76
//     (PERF.md), so (b) could gain at most that, and its gathers need room
//     the block does not have. The table rows are gathered with cp.async
//     while the previous token's r·h product runs, and the next tile's ids
//     and dense columns arrive the same way, so no load waits in the loop
//     but each pair's first.
//   - Every row is computed, padding included; rows past N read id 0 and
//     zeros and are not stored. An id outside the table reads NaN, so the
//     row's logit is NaN (the eager gather would fault); a NaN or infinite
//     activation makes its row's logit NaN, a weight that is not finite
//     every row's.
//   - The logits are not the eager head's bits: against the eager head in
//     float64 they read 7.6e-7 at the cell's shape, the eager float32 head
//     3.7e-7 (the tensor cores' float32 sums round coarser than FFMAs).
//   - A head this design cannot hold, h above 64 or weights beyond a block
//     even at one pair, runs seq_head_wide instead: the same head as float32
//     FFMAs, a thread a column, the weights read through the caches (below).
//
// Measured on one H100 (PERF.md §6): 3.72 ms a head at the cell's shape,
// against the eager head's 30 ms; the three MMAs a product take about 2.4 ms
// of it, splitting the weights and the gates' nonlinearities most of the
// rest. Slower variants: the products as FFMAs on the CUDA cores (4.71 ms at
// best), a warp a 16-row tile (3.93), the widths at run time instead of the
// default widths' own instantiation (3.85), unrolling the k-steps by 1 or 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;                // rows a pair of warps' tile: two m16 MMA tiles
constexpr int WARPS = 8;                // warps a block, at most (4 pairs)
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_NT = 8;               // 8-column MMA tiles of h: H up to 64
constexpr long long MAX_SMEM = 232448;  // what a Hopper block can opt into

// The head's parameters, as seq/model.py's SeqModule holds them.
struct Params {
  const float* embed;  // (combo, e)
  const float* w[3];   // wz, wr, wh: (e, h)
  const float* u[3];   // uz, ur, uh: (h, h)
  const float* b[3];   // bz, br, bh: (h,)
  const float* w1;     // (h + d, r)
  const float* b1;     // (r,)
  const float* w2;     // (r,)
  const float* b2;     // ()
};

struct Dims {
  long long n;               // rows
  int k, combo, e, h, d, r;  // tokens, table rows, widths
  int ep, hp, dp, rp;        // e, d padded to 8; h to 8 x its MMA tiles; r to a multiple of hp
  int vec;                   // 1: the table's rows are gathered 16 bytes at a time
  int pairs;                 // pairs of warps a block: 4, or fewer where the weights need room
};

__host__ __device__ constexpr long long align4(long long n) { return (n + 3) & ~3LL; }
// Row stride of an A operand of width n (a multiple of 8): 4 mod 8 floats,
// so a fragment's 32 loads hit 32 banks.
__host__ __device__ constexpr int a_stride(int n) { return n + 4; }
// Row stride of a B operand of width n (a multiple of 8): 8 or 24 mod 32.
__host__ __device__ constexpr int b_stride(int n) { return n % 16 == 0 ? n + 8 : n; }

// The block's shared memory, offsets in floats, in the order the kernel
// carves it.
struct Layout {
  int ws, w1s, es, hs, ds;                              // row strides
  long long wx, ux, w1, bx, b1, w2, mean, stdev, warp;  // offsets
  long long per_pair, total;                            // a pair's region, the whole
};

__host__ __device__ inline Layout layout(const Dims& m) {
  Layout l;
  l.ws = b_stride(3 * m.hp);
  l.w1s = b_stride(m.rp);
  l.es = a_stride(m.ep);
  l.hs = a_stride(m.hp);
  l.ds = a_stride(m.dp);
  long long o = 0;
  l.wx = o; o += (long long)m.ep * l.ws;            // [ep][ws]: wz|wr|wh
  l.ux = o; o += (long long)m.hp * l.ws;            // [hp][ws]: uz|ur|uh
  l.w1 = o; o += (long long)(m.hp + m.dp) * l.w1s;  // [hp + dp][w1s]: rows of h, then of dn
  l.bx = o; o += align4(3LL * m.hp);
  l.b1 = o; o += align4(m.rp);
  l.w2 = o; o += align4(m.rp);
  l.mean = o; o += align4(m.dp);
  l.stdev = o; o += align4(m.dp);
  l.warp = o;
  // a pair's: the token's embedding, h (or r·h), the dense columns, two tiles'
  // ids, one half's partial logits
  l.per_pair = align4((long long)TILE * (l.es + l.hs + l.ds + 1) + 2LL * TILE * m.k);
  l.total = o + m.pairs * l.per_pair;
  return l;
}

// Asynchronous copies from device to shared memory, in commit groups.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of the newest groups are still in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v's TF32 operand bits, rounded to nearest, ties away (cvt.rna.tf32.f32 of
// a finite v); the tensor core ignores the low 13 bits.
__device__ __forceinline__ uint32_t tf32_bits(float v) { return __float_as_uint(v) + 0x1000u; }
// v = hi + lo + O(2^-22 |v|), each part rounded to TF32, for a finite v: the
// weights (the kernel checks them once a block).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi & 0xffffe000u));
}
// The same for an activation, which may be NaN or infinite: those keep their
// bits (the rounding's carry would turn the card's NaN, 0x7fffffff, into -0),
// so they reach the logit as NaN.
__device__ __forceinline__ void split_tf32_any(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  hi = (u & 0x7f800000u) == 0x7f800000u ? u : u + 0x1000u;
  const float rest = v - __uint_as_float(hi & 0xffffe000u);
  const uint32_t ur = __float_as_uint(rest);
  lo = (ur & 0x7f800000u) == 0x7f800000u ? ur : ur + 0x1000u;
}

// d += A·B for one 16 x 8 x 8 step, A and B as TF32 fragments.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][g][j] += A_m·W_g over `depth` (a multiple of 8) for each gate g in
// the mask GATES and the pair's two 16-row MMA tiles m: A at `a`, rows `as`
// floats apart; W_g's rows `ws` floats apart, this warp's MMA tile j of 8
// columns at w + g·gs + 8j. Each split of W feeds both row tiles. The
// accumulator element q of tile (m, j) is row 16m + (lane / 4) + 8(q / 2),
// column 8j + 2(lane % 4) + q % 2.
template <int NT, unsigned GATES>
__device__ __forceinline__ void products(const float* a, int as, const float* w, int ws, int gs,
                                         int depth, int lane, float (&acc)[2][3][NT][4]) {
  const float* ar = a + (lane >> 2) * as + (lane & 3);
  const float* wr = w + (lane & 3) * ws + (lane >> 2);
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 8) {
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* am = ar + 16 * m * as + k0;
      split_tf32_any(am[0], ahi[m][0], alo[m][0]);
      split_tf32_any(am[8 * as], ahi[m][1], alo[m][1]);
      split_tf32_any(am[4], ahi[m][2], alo[m][2]);
      split_tf32_any(am[8 * as + 4], ahi[m][3], alo[m][3]);
    }
    const float* wk = wr + k0 * ws;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      if (!(GATES >> g & 1u)) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t hi0, lo0, hi1, lo1;
        split_tf32(wk[g * gs + 8 * j], hi0, lo0);
        split_tf32(wk[4 * ws + g * gs + 8 * j], hi1, lo1);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_tf32(acc[m][g][j], alo[m], hi0, hi1);
          mma_tf32(acc[m][g][j], ahi[m], lo0, lo1);
          mma_tf32(acc[m][g][j], ahi[m], hi0, hi1);
        }
      }
    }
  }
}

constexpr unsigned Z = 1u, R = 2u, H = 4u;  // the gates' bits

// f(i, row, col) for i = first, first + step, .. < n over a row-major index
// space of width w, with one division, not one a step.
template <class F>
__device__ __forceinline__ void for_each(int first, int step, int n, int w, F f) {
  if (w <= 0) return;
  int row = first / w, col = first - row * w;
  const int drow = step / w, dcol = step - drow * w;
  for (int i = first; i < n; i += step) {
    f(i, row, col);
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

// The gates' nonlinearities from the fast exponential and division
// (__expf, __fdividef): measured on the card, their error at the cell's
// widths is that of the accurate expf, tanhf and division (3.5e-7 against
// 3.4e-7 on the logits, float64 eager head as reference; the eager float32
// head 3.7e-7).
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// NT: 8-column MMA tiles of each warp's half of h. DEFAULT: the default
// widths (e 32, hp 64, rp 64) as constants, so that the products' loops and
// strides are known to the compiler.
template <int NT, bool DEFAULT>
__global__ void __launch_bounds__(THREADS, 1)
seq_head_kernel(const Params p, const float* __restrict__ x, const int32_t* __restrict__ ids,
                const float* __restrict__ mean, const float* __restrict__ stdev,
                float* __restrict__ out, const Dims m, const long long tiles) {
  static_assert(!DEFAULT || NT == 4, "the default widths are 4 MMA tiles of each half of h");
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  Dims mm = m;
  if (DEFAULT) {
    mm.ep = 32;
    mm.hp = 64;
    mm.rp = 64;
  }
  const Layout l = layout(mm);
  const int ep = mm.ep, hp = mm.hp, rp = mm.rp, dp = m.dp;
  const int e = m.e, h = m.h, d = m.d, r = m.r, k = m.k;
  const int ws = l.ws, w1s = l.w1s, es_ = l.es, hs_ = l.hs, ds_ = l.ds;
  float* const wx = sm + l.wx;
  float* const ux = sm + l.ux;
  float* const w1 = sm + l.w1;
  float* const bx = sm + l.bx;
  float* const b1 = sm + l.b1;
  float* const w2 = sm + l.w2;
  float* const mu = sm + l.mean;
  float* const sd = sm + l.stdev;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  // the weights, once a block, zero in the padded rows and columns; one that
  // is not finite makes every logit NaN (the eager head's are not finite)
  bool nonfinite = false;
  auto keep = [&](float v) {
    nonfinite |= !isfinite(v);
    return v;
  };
  for_each(tid, nthreads, ep * ws, ws, [&](int i, int kk, int c) {
    const int g = c / hp, cc = c - g * hp;
    wx[i] = kk < e && g < 3 && cc < h ? keep(p.w[g][kk * h + cc]) : 0.f;
  });
  for_each(tid, nthreads, hp * ws, ws, [&](int i, int kk, int c) {
    const int g = c / hp, cc = c - g * hp;
    ux[i] = kk < h && g < 3 && cc < h ? keep(p.u[g][kk * h + cc]) : 0.f;
  });
  for_each(tid, nthreads, (hp + dp) * w1s, w1s, [&](int i, int kk, int c) {
    const int src = kk < hp ? (kk < h ? kk : -1) : (kk - hp < d ? h + kk - hp : -1);
    w1[i] = src >= 0 && c < r ? keep(p.w1[(long long)src * r + c]) : 0.f;
  });
  for (int i = tid; i < 3 * hp; i += nthreads) {
    const int g = i / hp, c = i - g * hp;
    bx[i] = c < h ? p.b[g][c] : 0.f;
  }
  for (int i = tid; i < rp; i += nthreads) {
    b1[i] = i < r ? p.b1[i] : 0.f;
    w2[i] = i < r ? p.w2[i] : 0.f;
  }
  for (int i = tid; i < dp; i += nthreads) {
    mu[i] = i < d ? mean[i] : 0.f;
    sd[i] = i < d ? stdev[i] : 1.f;
  }
  // every warp's region zero: the padded columns stay so
  for (long long i = tid; i < m.pairs * l.per_pair; i += nthreads) sm[l.warp + i] = 0.f;
  const float b2 = __syncthreads_or(nonfinite) ? nanf("") : *p.b2;
  // the weights are in; from here each warp walks its tiles alone

  const int warp = tid / 32, lane = tid % 32;
  const int pair = warp / 2, half = warp % 2, plane = tid % 64;  // a lane of the pair
  float* const es = sm + l.warp + pair * l.per_pair;  // [32][es_]: the token's embedding
  float* const hs = es + TILE * es_;                  // [32][hs_]: h, or r·h
  float* const dn = hs + TILE * hs_;                  // [32][ds_]: the dense columns
  float* const other = dn + TILE * ds_;               // [32]: the second half's partial logits
  int32_t* const idb = reinterpret_cast<int32_t*>(other + TILE);  // two tiles' [32][k]
  // this warp's half of every gate's columns: MMA tiles half·NT ..
  const int cb = 8 * NT * half;
  const int gr = lane >> 2, gc = cb + 2 * (lane & 3);  // an accumulator's first row and column
  auto pair_sync = [&] { asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory"); };

  // tile t's ids into dst (rows past n read id 0)
  auto fetch_ids = [&](long long t, int32_t* dst) {
    const long long row0 = t * TILE;
    const long long valid = (m.n - row0 < TILE ? m.n - row0 : TILE) * k;
    for (int i = plane; i < TILE * k; i += 64) {
      if (i < valid) copy_async4(dst + i, ids + row0 * k + i);
      else dst[i] = 0;
    }
  };
  // token s of the tile whose ids are `tok` into es; an id outside the table reads NaN
  auto gather = [&](const int32_t* tok, int s) {
    if (m.vec) {
      const int q = e / 4;
      for_each(plane, 64, TILE * q, q, [&](int, int row, int c) {
        const int id = tok[row * k + s];
        float* dst = es + row * es_ + 4 * c;
        if (id >= 0 && id < m.combo) {
          copy_async16(dst, p.embed + (long long)id * e + 4 * c);
        } else {
          dst[0] = dst[1] = dst[2] = dst[3] = __uint_as_float(0x7fc00000u);
        }
      });
    } else {
      for_each(plane, 64, TILE * e, e, [&](int, int row, int j) {
        const int id = tok[row * k + s];
        float* dst = es + row * es_ + j;
        if (id >= 0 && id < m.combo) copy_async4(dst, p.embed + (long long)id * e + j);
        else *dst = __uint_as_float(0x7fc00000u);
      });
    }
  };

  const long long step = (long long)gridDim.x * m.pairs;
  long long tile = (long long)blockIdx.x * m.pairs + pair;
  if (tile < tiles) {
    fetch_ids(tile, idb);
    commit_copies();
    wait_copies<0>();
    pair_sync();
    gather(idb, k - 1);
    commit_copies();
  }
  for (int it = 0; tile < tiles; tile += step, ++it) {
    const int32_t* tok = idb + (it & 1) * TILE * k;
    int32_t* next_tok = idb + ((it + 1) & 1) * TILE * k;
    const long long next = tile + step;
    const long long row0 = tile * TILE;
    const int rows = (int)(m.n - row0 < TILE ? m.n - row0 : TILE);
    if (next < tiles) fetch_ids(next, next_tok);
    for_each(plane, 64, rows * d, d, [&](int i, int row, int c) {
      copy_async4(dn + row * ds_ + c, x + row0 * d + i);
    });
    commit_copies();

    float hv[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[mt][j][q] = 0.f;

    for (int s = k - 1; s >= 0; --s) {
      const bool first = s == k - 1;
      // token s's embedding (in flight since the last step) and the last h;
      // the next tile's ids too by the last step, which gathers from them
      if (first && s > 0) wait_copies<1>();
      else wait_copies<0>();
      pair_sync();
      float acc[2][3][NT][4] = {};  // z, r, hh before their biases
      if (first) {
        products<NT, Z | H>(es, es_, wx + cb, ws, hp, ep, lane, acc);
      } else {
        products<NT, Z | R | H>(es, es_, wx + cb, ws, hp, ep, lane, acc);
        products<NT, Z | R>(hs, hs_, ux + cb, ws, hp, hp, lane, acc);
      }
      pair_sync();  // es and h read by both warps
      if (s > 0) gather(tok, s - 1);
      else if (next < tiles) gather(next_tok, k - 1);
      commit_copies();
      if (!first) {
        // r·h in place of h (this warp's columns), then its product with uh
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int c = 8 * j + gc;
            const float r0 = sigmoid(acc[mt][1][j][0] + bx[hp + c]);
            const float r1 = sigmoid(acc[mt][1][j][1] + bx[hp + c + 1]);
            const float r2 = sigmoid(acc[mt][1][j][2] + bx[hp + c]);
            const float r3 = sigmoid(acc[mt][1][j][3] + bx[hp + c + 1]);
            float* row = hs + (16 * mt + gr) * hs_ + c;
            *reinterpret_cast<float2*>(row) = make_float2(r0 * hv[mt][j][0], r1 * hv[mt][j][1]);
            *reinterpret_cast<float2*>(row + 8 * hs_) =
                make_float2(r2 * hv[mt][j][2], r3 * hv[mt][j][3]);
          }
        pair_sync();
        products<NT, H>(hs, hs_, ux + cb, ws, hp, hp, lane, acc);
      }
      // at the first token h is 0, so its products with h are skipped: they add exact zeros
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 8 * j + gc + (q & 1);
            const float z = sigmoid(acc[mt][0][j][q] + bx[c]);
            const float hh = tanh_fast(acc[mt][2][j][q] + bx[2 * hp + c]);
            hv[mt][j][q] = (1.f - z) * hv[mt][j][q] + z * hh;
          }
      pair_sync();  // r·h read by both warps
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float* row = hs + (16 * mt + gr) * hs_ + 8 * j + gc;
          *reinterpret_cast<float2*>(row) = make_float2(hv[mt][j][0], hv[mt][j][1]);
          *reinterpret_cast<float2*>(row + 8 * hs_) = make_float2(hv[mt][j][2], hv[mt][j][3]);
        }
    }

    // the readout: the dense columns (this lane's own copies) standardized
    wait_copies<1>();
    for_each(plane, 64, TILE * d, d, [&](int, int row, int c) {
      float* v = dn + row * ds_ + c;
      *v = row < rows ? (*v - mu[c]) / sd[c] : 0.f;
    });
    pair_sync();  // h and the dense columns of every row
    float part[2][2] = {};  // rows 16mt + gr and 16mt + gr + 8
    for (int c0 = 0; c0 < rp; c0 += hp) {
      float acc[2][3][NT][4] = {};  // gate 0 alone: the readout's columns c0 + cb ..
      products<NT, Z>(hs, hs_, w1 + c0 + cb, w1s, 0, hp, lane, acc);
      products<NT, Z>(dn, ds_, w1 + (long long)hp * w1s + c0 + cb, w1s, 0, dp, lane, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + 8 * j + gc + (q & 1);
            const float v = acc[mt][0][j][q] + b1[c];
            part[mt][q >> 1] = fmaf(v < 0.f ? 0.f : v, w2[c], part[mt][q >> 1]);  // relu keeps NaN
          }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[mt][i] += __shfl_xor_sync(0xffffffffu, part[mt][i], 1);
        part[mt][i] += __shfl_xor_sync(0xffffffffu, part[mt][i], 2);
      }
    if (half == 1 && (lane & 3) == 0)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        other[16 * mt + gr] = part[mt][0];
        other[16 * mt + gr + 8] = part[mt][1];
      }
    pair_sync();  // the second half's partial logits
    if (half == 0 && (lane & 3) == 0)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = 16 * mt + gr + 8 * i;
          if (row < rows) out[row0 + row] = part[mt][i] + other[row] + b2;
        }
    pair_sync();  // the tile's buffers read by both warps
  }
}

// The general path, for a head the tensor-core kernel cannot hold: h above
// 64, or weights and tiles beyond a block's shared memory. A block walks
// tiles of RW rows, a thread a column of each gate (and of the readout), all
// products as float32 FFMAs on the CUDA cores, the weights read through the
// caches. The tile's token embedding, h, r·h, the next h, the standardized
// dense columns and the ids stay in shared memory, rows padded to 4 floats
// with zeros, so every width fits whose single row does: 4-float-rounded
// e + 3h + d, then k + 8 floats (ops/seq_head.py refuses the rest before the
// device). The same equations, ids and padding as seq_head_kernel, with no
// rounding to TF32; a weight that is not finite reaches the logits of the
// rows that use it, as in the eager head.

// acc[q] += a[q][0:n]·w[0:n] for the RW rows of a, `as` floats apart (a
// multiple of 4, zero past n), and the column w, `ws` floats a step: the
// activations are read 4 at a time, one 16-byte load for 4 FFMAs.
template <int RW>
__device__ __forceinline__ void dot_rows(const float* a, int as, const float* w, long long ws,
                                         int n, float (&acc)[RW]) {
  for (int j = 0; j < n; j += 4) {
    float wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wv[u] = j + u < n ? w[(j + u) * ws] : 0.f;
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(a + q * as + j);
      acc[q] = fmaf(v.x, wv[0], acc[q]);
      acc[q] = fmaf(v.y, wv[1], acc[q]);
      acc[q] = fmaf(v.z, wv[2], acc[q]);
      acc[q] = fmaf(v.w, wv[3], acc[q]);
    }
  }
}

template <int RW>
__global__ void __launch_bounds__(THREADS)
seq_head_wide(const Params p, const float* __restrict__ x, const int32_t* __restrict__ ids,
              const float* __restrict__ mean, const float* __restrict__ stdev,
              float* __restrict__ out, const Dims m, const long long tiles) {
  extern __shared__ float4 smem4[];
  const int e = m.e, h = m.h, d = m.d, r = m.r, k = m.k, tid = threadIdx.x;
  const int e4 = (int)align4(e), h4 = (int)align4(h), d4 = (int)align4(d);
  float* const es = reinterpret_cast<float*>(smem4);  // [RW][e4]: the token's embedding
  float* const hb = es + RW * e4;                      // [3][RW][h4]: h, the next h, r·h
  float* hs = hb;                                      // h
  float* hn = hb + RW * h4;                            // the next h
  float* const rh = hb + 2 * RW * h4;                  // r·h
  float* const dn = hb + 3 * RW * h4;                  // [RW][d4]: the dense columns
  float* const red = dn + RW * d4;                     // [WARPS][RW]: the warps' partial logits
  int32_t* const tok = reinterpret_cast<int32_t*>(red + WARPS * RW);  // [RW][k]
  const float qnan = __uint_as_float(0x7fc00000u);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * RW;
    const int rows = (int)(m.n - row0 < RW ? m.n - row0 : RW);
    for (int i = tid; i < RW * k; i += THREADS) tok[i] = i < rows * k ? ids[row0 * k + i] : 0;
    for (int i = tid; i < RW * d4; i += THREADS) {
      const int row = i / d4, c = i - row * d4;
      dn[i] = row < rows && c < d ? (x[(row0 + row) * d + c] - mean[c]) / stdev[c] : 0.f;
    }
    for (int i = tid; i < 3 * RW * h4; i += THREADS) hb[i] = 0.f;
    for (int s = k - 1; s >= 0; --s) {
      __syncthreads();  // the ids; the last step's embedding read
      for (int i = tid; i < RW * e4; i += THREADS) {
        const int row = i / e4, j = i - row * e4, id = tok[row * k + s];
        es[i] = j >= e ? 0.f : id >= 0 && id < m.combo ? p.embed[(long long)id * e + j] : qnan;
      }
      __syncthreads();
      for (int c = tid; c < h; c += THREADS) {  // r·h
        float a[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) a[q] = p.b[1][c];
        dot_rows<RW>(es, e4, p.w[1] + c, h, e, a);
        dot_rows<RW>(hs, h4, p.u[1] + c, h, h, a);
#pragma unroll
        for (int q = 0; q < RW; ++q) rh[q * h4 + c] = sigmoid(a[q]) * hs[q * h4 + c];
      }
      __syncthreads();
      for (int c = tid; c < h; c += THREADS) {  // z, hh and the next h
        float az[RW], ah[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          az[q] = p.b[0][c];
          ah[q] = p.b[2][c];
        }
        dot_rows<RW>(es, e4, p.w[0] + c, h, e, az);
        dot_rows<RW>(hs, h4, p.u[0] + c, h, h, az);
        dot_rows<RW>(es, e4, p.w[2] + c, h, e, ah);
        dot_rows<RW>(rh, h4, p.u[2] + c, h, h, ah);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const float z = sigmoid(az[q]);
          hn[q * h4 + c] = (1.f - z) * hs[q * h4 + c] + z * tanh_fast(ah[q]);
        }
      }
      __syncthreads();
      float* const t = hs;
      hs = hn;
      hn = t;
    }
    // the readout: relu([h, dn]·w1 + b1)·w2, a column a thread, then summed
    float part[RW];
#pragma unroll
    for (int q = 0; q < RW; ++q) part[q] = 0.f;
    for (int c = tid; c < r; c += THREADS) {
      float a[RW];
#pragma unroll
      for (int q = 0; q < RW; ++q) a[q] = p.b1[c];
      dot_rows<RW>(hs, h4, p.w1 + c, r, h, a);
      dot_rows<RW>(dn, d4, p.w1 + (long long)h * r + c, r, d, a);
      const float w2 = p.w2[c];
#pragma unroll
      for (int q = 0; q < RW; ++q) part[q] = fmaf(a[q] < 0.f ? 0.f : a[q], w2, part[q]);  // relu keeps NaN
    }
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      float v = part[q];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * RW + q] = v;
    }
    __syncthreads();
    if (tid < rows) {
      float v = *p.b2;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w * RW + tid];
      out[row0 + tid] = v;
    }
  }
}

// A wide tile's shared memory in bytes: RW rows of e + 3h + d floats, each
// rounded up to 4, and k ids, and the warps' partial logits.
long long wide_smem(const Dims& m, int rw) {
  return 4LL * rw * (align4(m.e) + 3 * align4(m.h) + align4(m.d) + m.k + WARPS);
}

template <int RW>
int launch_wide(const Params& p, const float* x, const int32_t* ids, const float* mean,
                const float* stdev, float* out, const Dims& m, cudaStream_t stream) {
  const long long smem = wide_smem(m, RW);
  cudaError_t err = cudaFuncSetAttribute(seq_head_wide<RW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seq_head_wide<RW>, THREADS,
                                                           (size_t)smem)) != cudaSuccess)
    return (int)err;
  const long long tiles = (m.n + RW - 1) / RW;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(tiles < most ? tiles : most);
  seq_head_wide<RW><<<blocks, THREADS, (size_t)smem, stream>>>(p, x, ids, mean, stdev, out, m, tiles);
  return (int)cudaGetLastError();
}

template <int NT, bool DEFAULT>
int launch(const Params& p, const float* x, const int32_t* ids, const float* mean,
           const float* stdev, float* out, const Dims& m, cudaStream_t stream) {
  const long long smem = layout(m).total * 4;
  cudaError_t err = cudaFuncSetAttribute(seq_head_kernel<NT, DEFAULT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long tiles = (m.n + TILE - 1) / TILE;
  const long long want = (tiles + m.pairs - 1) / m.pairs;
  const int blocks = (int)(want < sms ? want : sms);
  seq_head_kernel<NT, DEFAULT><<<blocks, 64 * m.pairs, (size_t)smem, stream>>>(
      p, x, ids, mean, stdev, out, m, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`: writes the logits out (n,) of one head from
// x_dense (n, d), ids (n, k) and the dense (mean, std) (d,). `params` is a
// host array of 14 device pointers: embed, wz, wr, wh, uz, ur, uh, bz, br,
// bh, w1, b1, w2, b2. Returns the cudaError_t (0 on success). A head of h up
// to 64 whose weights and a pair's tiles fit a block runs the tensor-core
// kernel, with as many pairs of warps (4 at most) as fit; any other the
// general kernel, at the most rows a tile (16, 4 or 1) that fit.
// cudaErrorInvalidValue for k, e, r below 1 and for a head whose single row
// does not fit the general kernel's block.
int seq_head_f32(const float* const* params, const float* x, const int32_t* ids, const float* mean,
                 const float* stdev, float* out, long long n, int k, int combo, int e, int h, int d,
                 int r, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || combo < 1 || e < 1 || h < 1 || d < 0 || r < 1) return (int)cudaErrorInvalidValue;
  const Params p{params[0],
                 {params[1], params[2], params[3]},
                 {params[4], params[5], params[6]},
                 {params[7], params[8], params[9]},
                 params[10], params[11], params[12], params[13]};
  const cudaStream_t s = (cudaStream_t)stream;
  const int nt = h <= 16 ? 2 : h <= 32 ? 4 : 8;  // MMA tiles of h; a warp computes half
  const int hp = 8 * nt;
  const int vec = e % 4 == 0 && reinterpret_cast<uintptr_t>(params[0]) % 16 == 0;
  Dims m{n, k, combo, e, h, d, r, (e + 7) / 8 * 8, hp, (d + 7) / 8 * 8,
         (r + hp - 1) / hp * hp, vec, 4};
  while (m.pairs > 0 && layout(m).total * 4 > MAX_SMEM) --m.pairs;
  if (h <= 8 * MAX_NT && m.pairs > 0) {
    if (m.ep == 32 && hp == 64 && m.rp == 64) return launch<4, true>(p, x, ids, mean, stdev, out, m, s);
    switch (nt) {
      case 2: return launch<1, false>(p, x, ids, mean, stdev, out, m, s);
      case 4: return launch<2, false>(p, x, ids, mean, stdev, out, m, s);
      default: return launch<4, false>(p, x, ids, mean, stdev, out, m, s);
    }
  }
  if (wide_smem(m, 16) <= MAX_SMEM) return launch_wide<16>(p, x, ids, mean, stdev, out, m, s);
  if (wide_smem(m, 4) <= MAX_SMEM) return launch_wide<4>(p, x, ids, mean, stdev, out, m, s);
  if (wide_smem(m, 1) <= MAX_SMEM) return launch_wide<1>(p, x, ids, mean, stdev, out, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
