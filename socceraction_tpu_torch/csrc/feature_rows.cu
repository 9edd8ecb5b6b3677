// Feature rows for Hopper (sm_90a): the dense feature block and the combined
// ids of a packed batch, in one launch.
//
// Replaces no TPU kernel. On the TPU, XLA fuses the feature transformers of
// socceraction_tpu/ops/features.py and ops/atomic.py into a few loops. The
// port's eager version (ops/fused.py:packed_rows_reference) launches some 150
// kernels a call: a shift gather per column and state, an elementwise kernel
// per operation, a stack per transformer and one concatenation that
// interleaves the blocks with a stride of D floats. This kernel writes what
// that version returns, from the batch's raw (G, A) columns:
//
//     x_dense (G*A, D) f32   the dense transformers' columns in layout order
//     ids     (G*A, k) i32   the combined one-hot id of each state
//
// Bound, counted at a 1024 x 1664 chunk on one H100 SXM: the raw columns read
// once (10 columns, 37 bytes a row, standard; 33 atomic) and both outputs
// written once (55 + 3 columns of 4 bytes, standard; 46 + 3 atomic), about
// 0.46 GB standard and 0.39 GB atomic, 0.137 and 0.116 ms at 3.35 TB/s. The
// arithmetic (a few angles a row) is far below the card's rate, so the kernel
// is bound by bytes, most of them x_dense's stores.
//
// Design.
//   - The column program. The wrapper (ops/feature_rows.py) compiles (family,
//     transformer names, k) once into an int32 table: a header, then one code
//     per output column, (op | state << 8), then the family's type -> one-hot
//     group table. One kernel serves both families, any subset and order of
//     their dense transformers and any k.
//   - One block per tile of ROWS actions of one game, two threads a row, each
//     computing every other column, so that a warp runs one op at a time over
//     32 rows. The block stages the tile's raw columns in shared memory with
//     a halo of the k - 1 earlier actions, clamped at the game's action 0 (the
//     eager version's edge backfill): state i of row j reads row max(j - i, 0).
//   - goalscore needs the goals before the tile: each block counts them over
//     the game's earlier actions (L2-resident, a few KB, 16 bytes a load, its
//     first loads sent beside the tile's), then scans its own tile. Counts
//     are integers, so the order of the sums changes no bit.
//   - The rows' D values and k ids go to shared memory; the block then stores
//     the tile's ROWS*D floats and ROWS*k ids, each one contiguous run of the
//     outputs, with 16-byte stores. Padding rows are computed like the others.
//     Measured variants (PERF.md): four threads a row, several rows a thread,
//     64- or 256-row tiles and blocks that walk a run of tiles carrying the
//     goal counts were no faster.
//   - The same bits as the eager CUDA version: every rounding as PyTorch's
//     elementwise kernels round, one operation at a time (__fmul_rn,
//     __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no contracted FMA), and
//     atanf and atan2f from libdevice, which PyTorch's atan and atan2 call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;   // actions a block (a tile)
constexpr int SPLIT = 2;    // threads a row: each computes every other column
constexpr int THREADS = ROWS * SPLIT;
constexpr int WARPS = THREADS / 32;
static_assert(ROWS % 4 == 0, "a tile starts on a quad of actions");
constexpr int MAX_SMEM = 232448;  // what a Hopper block can opt into
constexpr int DEFAULT_SMEM = 48 * 1024;

// The program's header (ints ahead of the column codes); ops/feature_rows.py
// writes it in this order.
enum Header {
  H_FAMILY,     // 0 standard SPADL, 1 Atomic-SPADL
  H_RESULTS,    // results in the standard combined id
  H_BODYPARTS,  // bodyparts in the combined id
  H_GOAL_A,     // standard: the shot types; atomic: the goal and owngoal types
  H_GOAL_B,
  H_GOAL_C,
  H_SUCCESS,    // standard: the results of a goal and of an own goal
  H_OWNGOAL,
  H_GROUPS,     // length of the type -> group table (atomic; 0 standard)
  H_GOALSCORE,  // 1 when a column reads goalscore
  HEADER = 16,
};

enum Family { STANDARD = 0, ATOMIC = 1 };

// Column ops (code & 0xff); ops/feature_rows.py's OPS lists the same names
// in the same order. "x0, y0" are the standard start location and the atomic
// location, mirrored about the pitch; "x1, y1" the standard end location,
// mirrored; "disp" the atomic displacement (dx, dy), negated by the mirror.
enum Op {
  OP_TYPE = 1,
  OP_RESULT,
  OP_BODYPART,
  OP_PERIOD,
  OP_TIME,
  OP_TIME_OVERALL,
  OP_X0,
  OP_Y0,
  OP_X1,
  OP_Y1,
  OP_DIST0,
  OP_ANGLE0,
  OP_DIST1,
  OP_ANGLE1,
  OP_MOVE_X,
  OP_MOVE_Y,
  OP_MOVE_DIST,
  OP_TEAM,
  OP_TIME_DELTA,
  OP_SPACE_X,
  OP_SPACE_Y,
  OP_SPACE_DIST,
  OP_GOAL_TEAM,
  OP_GOAL_OPP,
  OP_GOAL_DIFF,
  OP_DISP_DIST,
  OP_DISP_ANGLE,
  OP_DIR_X,
  OP_DIR_Y,
};

// Raw columns staged per tile: four int32 ids and is_home, and five floats.
enum IntSlot { I_TYPE, I_RESULT, I_BODYPART, I_PERIOD, I_HOME, N_INT };
enum FloatSlot { F_TIME, F_X0, F_Y0, F_X1, F_Y1, N_FLOAT };

struct Raw {
  const int32_t* type_id;
  const int32_t* result_id;  // null for Atomic-SPADL
  const int32_t* bodypart_id;
  const int32_t* period_id;
  const uint8_t* is_home;    // torch.bool: one byte, 0 or 1
  const float* time_seconds;
  const float* x0;           // start_x / x
  const float* y0;           // start_y / y
  const float* x1;           // end_x / dx
  const float* y1;           // end_y / dy
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The block's shared memory, in the order the kernel carves it.
__host__ __device__ inline size_t smem_bytes(int d, int k) {
  const size_t span = ROWS + (size_t)(k - 1);
  return align16((size_t)d * 4) + align16((size_t)ROWS * d * 4) + align16((size_t)ROWS * k * 4) +
         align16(N_INT * span * 4) + align16(N_FLOAT * span * 4) + align16(2 * ROWS * 4) +
         align16(4 * WARPS * 4);
}

template <typename T>
__device__ __forceinline__ T* carve(unsigned char*& p, size_t n) {
  T* out = reinterpret_cast<T*>(p);
  p += align16(n * sizeof(T));
  return out;
}

__device__ __forceinline__ float norm(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// torch.nan_to_num with its defaults
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? 3.402823466e+38f : -3.402823466e+38f;
  return v;
}

// the left-to-right mirror by the current action's home flag: about the pitch,
// or a negated displacement
__device__ __forceinline__ float flip(float v, bool home, float extent) {
  return home ? v : __fsub_rn(extent, v);
}

__device__ __forceinline__ float negate(float v, bool home) { return home ? v : -v; }

// polar's distance to the goal (gx, gy) and nan_to_num(atan(dy / dx))
__device__ __forceinline__ float goal_dist(float x, float y, float gx, float gy) {
  return norm(fabsf(__fsub_rn(gx, x)), fabsf(__fsub_rn(gy, y)));
}

__device__ __forceinline__ float goal_angle(float x, float y, float gx, float gy) {
  return nan_to_num(atanf(__fdiv_rn(fabsf(__fsub_rn(gy, y)), fabsf(__fsub_rn(gx, x)))));
}

__device__ __forceinline__ float disp_angle(float dx, float dy) {
  return dy == 0.0f ? 0.0f : atan2f(dy, dx);
}

// direction: the displacement over its length, or as it is when it is 0
__device__ __forceinline__ float direction(float dx, float dy, float along) {
  const float total = norm(dx, dy);
  return total > 0.0f ? __fdiv_rn(along, total) : along;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy n 32-bit words from shared to global memory, 16 bytes a store where
// the destination allows; every thread of the block takes part.
__device__ void store_run(uint32_t* dst, const uint32_t* src, int n) {
  const int tid = threadIdx.x;
  const int head = min(n, (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2));
  for (int e = tid; e < head; e += THREADS) dst[e] = src[e];
  const int body = (n - head) >> 2;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint32_t* s = src + head;
  if (((uintptr_t)s & 15) == 0) {
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (int q = tid; q < body; q += THREADS) dv[q] = sv[q];
  } else {
    for (int q = tid; q < body; q += THREADS)
      dv[q] = make_uint4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
  }
  for (int e = head + 4 * body + tid; e < n; e += THREADS) dst[e] = src[e];
}

struct GoalRule {
  int family, goal_a, goal_b, goal_c, success, owngoal;

  // goal and own goal of one action (labels.py's and atomic.py's _goal_masks)
  __device__ __forceinline__ void flags(int type, int result, bool& goal, bool& own) const {
    if (family == STANDARD) {
      const bool shot = type == goal_a || type == goal_b || type == goal_c;
      goal = shot && result == success;
      own = shot && result == owngoal;
    } else {
      goal = type == goal_a;
      own = type == goal_b;
    }
  }

  // (a, b): whether the action is a goal for team A (the team of the game's
  // action 0) and for team B
  __device__ __forceinline__ int2 goals(int type, int result, bool home, bool home0) const {
    bool goal, own;
    flags(type, result, goal, own);
    const bool team_a = home == home0;
    return make_int2((goal && team_a) || (own && !team_a), (goal && !team_a) || (own && team_a));
  }
};

// goals of team A and B in four consecutive actions
__device__ __forceinline__ int2 quad_goals(const GoalRule& rule, int4 t, int4 r, unsigned h,
                                           bool home0) {
  const int2 g0 = rule.goals(t.x, r.x, (h & 0xffu) != 0, home0);
  const int2 g1 = rule.goals(t.y, r.y, (h & 0xff00u) != 0, home0);
  const int2 g2 = rule.goals(t.z, r.z, (h & 0xff0000u) != 0, home0);
  const int2 g3 = rule.goals(t.w, r.w, (h & 0xff000000u) != 0, home0);
  return make_int2(g0.x + g1.x + g2.x + g3.x, g0.y + g1.y + g2.y + g3.y);
}

#define RAW_I(slot, idx) ri[(slot) * span + (idx)]
#define RAW_F(slot, idx) rf[(slot) * span + (idx)]
#define X0(idx) flip(RAW_F(F_X0, idx), home, length)
#define Y0(idx) flip(RAW_F(F_Y0, idx), home, width)
#define X1(idx) flip(RAW_F(F_X1, idx), home, length)
#define Y1(idx) flip(RAW_F(F_Y1, idx), home, width)
#define DX(idx) negate(RAW_F(F_X1, idx), home)
#define DY(idx) negate(RAW_F(F_Y1, idx), home)

__global__ void __launch_bounds__(THREADS)
    feature_rows_kernel(const int32_t* __restrict__ prog, Raw raw, float* __restrict__ x_dense,
                        int32_t* __restrict__ ids, int a, int tiles, int d, int k, float length,
                        float width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = k - 1;
  const int span = ROWS + halo;
  unsigned char* cursor = smem;
  int* ops = carve<int>(cursor, d);
  float* stage = carve<float>(cursor, (size_t)ROWS * d);
  int* id_stage = carve<int>(cursor, (size_t)ROWS * k);
  int* ri = carve<int>(cursor, (size_t)N_INT * span);
  float* rf = carve<float>(cursor, (size_t)N_FLOAT * span);
  int* score = carve<int>(cursor, 2 * ROWS);
  int* scratch = carve<int>(cursor, 4 * WARPS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long g = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * ROWS;
  const int rows = min(ROWS, a - t0);
  const long long game = g * a;

  const GoalRule rule{__ldg(prog + H_FAMILY), __ldg(prog + H_GOAL_A), __ldg(prog + H_GOAL_B),
                      __ldg(prog + H_GOAL_C), __ldg(prog + H_SUCCESS), __ldg(prog + H_OWNGOAL)};
  const int n_results = __ldg(prog + H_RESULTS), n_bodyparts = __ldg(prog + H_BODYPARTS);
  const int n_groups = __ldg(prog + H_GROUPS);
  const int32_t* groups = prog + HEADER + d;
  const bool goalscore = __ldg(prog + H_GOALSCORE) != 0;

  for (int c = tid; c < d; c += THREADS) ops[c] = __ldg(prog + HEADER + c);
  // goalscore counts the goals of the game's actions [0, t0) (L2-resident):
  // 16 bytes of each int column at a time where they are aligned to it, and
  // a thread's first quad asked for before the tile's loads, so that both
  // wait together
  const bool home0 = __ldg(raw.is_home + game) != 0;  // the team of the game's action 0 is "A"
  const int32_t* tp = raw.type_id + game;
  const int32_t* rp = raw.result_id ? raw.result_id + game : nullptr;
  const uint8_t* hp = raw.is_home + game;
  const bool quads_ok =
      ((uintptr_t)tp & 15) == 0 && ((uintptr_t)rp & 15) == 0 && ((uintptr_t)hp & 3) == 0;
  const int quads = goalscore && quads_ok ? t0 >> 2 : 0;
  int4 qt = make_int4(0, 0, 0, 0), qr = make_int4(0, 0, 0, 0);
  unsigned qh = 0;
  if (tid < quads) {
    qt = __ldg(reinterpret_cast<const int4*>(tp) + tid);
    if (rp) qr = __ldg(reinterpret_cast<const int4*>(rp) + tid);
    qh = __ldg(reinterpret_cast<const unsigned*>(hp) + tid);
  }
  // the tile and its halo: span slot s holds action max(t0 - halo + s, 0);
  // a thread reads every column of its actions, all loads before any store
  for (int s = tid; s < span; s += THREADS) {
    const int at_row = t0 - halo + s;
    if (at_row >= a) continue;  // past the game's last slot: no thread reads it
    const long long at = game + max(at_row, 0);
    const int type = __ldg(raw.type_id + at);
    const int result = raw.result_id ? __ldg(raw.result_id + at) : 0;
    const int bodypart = __ldg(raw.bodypart_id + at), period = __ldg(raw.period_id + at);
    const int home = __ldg(raw.is_home + at) != 0;
    const float time = __ldg(raw.time_seconds + at), x0 = __ldg(raw.x0 + at);
    const float y0 = __ldg(raw.y0 + at), x1 = __ldg(raw.x1 + at), y1 = __ldg(raw.y1 + at);
    RAW_I(I_TYPE, s) = type;
    RAW_I(I_RESULT, s) = result;
    RAW_I(I_BODYPART, s) = bodypart;
    RAW_I(I_PERIOD, s) = period;
    RAW_I(I_HOME, s) = home;
    RAW_F(F_TIME, s) = time;
    RAW_F(F_X0, s) = x0;
    RAW_F(F_Y0, s) = y0;
    RAW_F(F_X1, s) = x1;
    RAW_F(F_Y1, s) = y1;
  }
  if (goalscore) {
    int2 sum = tid < quads ? quad_goals(rule, qt, qr, qh, home0) : make_int2(0, 0);
    for (int q = tid + THREADS; q < quads; q += THREADS) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(tp) + q);
      const int4 r = rp ? __ldg(reinterpret_cast<const int4*>(rp) + q) : make_int4(0, 0, 0, 0);
      const int2 g = quad_goals(rule, t, r, __ldg(reinterpret_cast<const unsigned*>(hp) + q), home0);
      sum.x += g.x;
      sum.y += g.y;
    }
    for (int p = (quads << 2) + tid; p < t0; p += THREADS) {
      const int2 g = rule.goals(__ldg(tp + p), rp ? __ldg(rp + p) : 0, __ldg(hp + p) != 0, home0);
      sum.x += g.x;
      sum.y += g.y;
    }
    sum.x = warp_sum(sum.x);
    sum.y = warp_sum(sum.y);
    if (lane == 0) {
      scratch[warp] = sum.x;
      scratch[WARPS + warp] = sum.y;
    }
  }
  __syncthreads();  // the staged tile, and the goals before it

  const int row = tid % ROWS, part = tid / ROWS;  // this thread's row, and its half of the columns
  const int cur = row + halo;                     // the row's state 0 in the span
  const bool home = RAW_I(I_HOME, cur) != 0;
  float team_score = 0.0f, opp_score = 0.0f;
  if (goalscore) {
    // an exclusive scan of the tile's goals, one row a thread of the first
    // part; rows past the game's end read whatever the span holds and are
    // never stored. Integers: the order of the sums changes no bit.
    int2 before = make_int2(0, 0);
    for (int w = 0; w < WARPS; ++w) {
      before.x += scratch[w];
      before.y += scratch[WARPS + w];
    }
    const int2 mine = part == 0 ? rule.goals(RAW_I(I_TYPE, cur), RAW_I(I_RESULT, cur), home, home0)
                                : make_int2(0, 0);
    int2 incl = mine;
    for (int off = 1; off < 32; off <<= 1) {
      const int vx = __shfl_up_sync(0xffffffffu, incl.x, off);
      const int vy = __shfl_up_sync(0xffffffffu, incl.y, off);
      if (lane >= off) {
        incl.x += vx;
        incl.y += vy;
      }
    }
    if (lane == 31) {
      scratch[2 * WARPS + warp] = incl.x;
      scratch[3 * WARPS + warp] = incl.y;
    }
    __syncthreads();
    if (part == 0) {
      int2 run = make_int2(before.x + incl.x - mine.x, before.y + incl.y - mine.y);
      for (int w = 0; w < warp; ++w) {
        run.x += scratch[2 * WARPS + w];
        run.y += scratch[3 * WARPS + w];
      }
      score[row] = run.x;
      score[ROWS + row] = run.y;
    }
    __syncthreads();
    const bool is_a = home == home0;
    team_score = (float)score[is_a ? row : ROWS + row];
    opp_score = (float)score[is_a ? ROWS + row : row];
  }

  // the columns: a warp runs one op at a time, over 32 rows
  const float gy = __fmul_rn(width, 0.5f);
  float* out = stage + (size_t)row * d;
  for (int c = part; c < d; c += SPLIT) {
    const int code = ops[c];
    const int at = cur - (code >> 8);  // state i reads row j - i
    float v;
    switch (code & 0xff) {
      case OP_TYPE: v = (float)RAW_I(I_TYPE, at); break;
      case OP_RESULT: v = (float)RAW_I(I_RESULT, at); break;
      case OP_BODYPART: v = (float)RAW_I(I_BODYPART, at); break;
      case OP_PERIOD: v = (float)RAW_I(I_PERIOD, at); break;
      case OP_TIME: v = RAW_F(F_TIME, at); break;
      case OP_TIME_OVERALL:
        v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn((float)RAW_I(I_PERIOD, at), 1.0f), 45.0f), 60.0f),
                      RAW_F(F_TIME, at));
        break;
      case OP_X0: v = X0(at); break;
      case OP_Y0: v = Y0(at); break;
      case OP_X1: v = X1(at); break;
      case OP_Y1: v = Y1(at); break;
      case OP_DIST0: v = goal_dist(X0(at), Y0(at), length, gy); break;
      case OP_ANGLE0: v = goal_angle(X0(at), Y0(at), length, gy); break;
      case OP_DIST1: v = goal_dist(X1(at), Y1(at), length, gy); break;
      case OP_ANGLE1: v = goal_angle(X1(at), Y1(at), length, gy); break;
      case OP_MOVE_X: v = __fsub_rn(X1(at), X0(at)); break;
      case OP_MOVE_Y: v = __fsub_rn(Y1(at), Y0(at)); break;
      case OP_MOVE_DIST: v = norm(__fsub_rn(X1(at), X0(at)), __fsub_rn(Y1(at), Y0(at))); break;
      case OP_TEAM: v = (RAW_I(I_HOME, at) != 0) == home ? 1.0f : 0.0f; break;
      case OP_TIME_DELTA: v = __fsub_rn(RAW_F(F_TIME, cur), RAW_F(F_TIME, at)); break;
      case OP_SPACE_X: v = __fsub_rn(X1(at), X0(cur)); break;
      case OP_SPACE_Y: v = __fsub_rn(Y1(at), Y0(cur)); break;
      case OP_SPACE_DIST: v = norm(__fsub_rn(X1(at), X0(cur)), __fsub_rn(Y1(at), Y0(cur))); break;
      case OP_GOAL_TEAM: v = team_score; break;
      case OP_GOAL_OPP: v = opp_score; break;
      case OP_GOAL_DIFF: v = __fsub_rn(team_score, opp_score); break;
      case OP_DISP_DIST: v = norm(DX(at), DY(at)); break;
      case OP_DISP_ANGLE: v = disp_angle(DX(at), DY(at)); break;
      case OP_DIR_X: v = direction(DX(at), DY(at), DX(at)); break;
      case OP_DIR_Y: v = direction(DX(at), DY(at), DY(at)); break;
      default: v = __int_as_float(0x7fffffff);  // an unknown op: NaN, never a silent 0
    }
    out[c] = v;
  }
  // the combined one-hot id of each state (FusedRegistry.combo_ids), in the
  // eager version's int32 arithmetic (wrapping, as PyTorch's does)
  for (int i = part; i < k; i += SPLIT) {
    const int at = cur - i;
    const uint32_t type = (uint32_t)RAW_I(I_TYPE, at), body = (uint32_t)RAW_I(I_BODYPART, at);
    int id;
    if (rule.family == STANDARD) {
      const uint32_t result = (uint32_t)RAW_I(I_RESULT, at);
      id = (int)((type * (uint32_t)n_results + result) * (uint32_t)n_bodyparts + body);
    } else {
      int t = (int)type;
      if (t < 0) t += n_groups;  // a negative index counts from the end, as torch indexing does
      id = t >= 0 && t < n_groups ? (int)((uint32_t)__ldg(groups + t) * (uint32_t)n_bodyparts + body)
                                  : -1;  // out of the table: an id B1 adds nothing for
    }
    id_stage[row * k + i] = id;
  }
  __syncthreads();

  const long long first = game + t0;
  store_run(reinterpret_cast<uint32_t*>(x_dense + first * d), reinterpret_cast<const uint32_t*>(stage),
            rows * d);
  store_run(reinterpret_cast<uint32_t*>(ids + first * k), reinterpret_cast<const uint32_t*>(id_stage),
            rows * k);
}

}  // namespace

extern "C" {

// One launch over g games of a slots each on `stream`: writes x_dense
// (g*a, d) and ids (g*a, k). `prog` is the column program on the device.
// Returns the cudaError_t (0 on success); cudaErrorInvalidValue for k < 1,
// for a block that would need more shared memory than the card gives one and
// for 2**31 blocks or more.
int feature_rows_f32(const int32_t* prog, const int32_t* type_id, const int32_t* result_id,
                     const int32_t* bodypart_id, const int32_t* period_id, const uint8_t* is_home,
                     const float* time_seconds, const float* x0, const float* y0, const float* x1,
                     const float* y1, float* x_dense, int32_t* ids, int g, int a, int d, int k,
                     float length, float width, void* stream) {
  if (g <= 0 || a <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, k);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  // one limit per kernel: set the largest, so that no launch lowers it under
  // another's that runs at the same time
  if (smem > (size_t)DEFAULT_SMEM &&
      (err = cudaFuncSetAttribute(feature_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MAX_SMEM)) != cudaSuccess)
    return (int)err;
  const int tiles = (a + ROWS - 1) / ROWS;
  const long long blocks = (long long)g * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Raw raw{type_id, result_id, bodypart_id, period_id, is_home, time_seconds, x0, y0, x1, y1};
  feature_rows_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      prog, raw, x_dense, ids, a, tiles, d, k, length, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
