// Fused top-k threshold with error feedback, for NVIDIA Hopper (sm_90a),
// over every leaf of a round in one launch.
//
// Replaces the TPU kernel fedtpu/ops/pallas_kernels.py::threshold_with_feedback
// (:108; body _threshold_kernel :93; pallas_call :124). For each leaf, y
// [rows, cols] f32 (a client's delta + residual per row) and one magnitude
// threshold per row:
//   keep  = |y| >= thresh[row]
//   out   = keep ? y : 0        (a select, so -0.0, NaN and ties at the
//                                threshold behave exactly as jnp.where)
//   new_e = y - out             (__fsub_rn: never contracted into an FMA)
// The source must not be built with --use_fast_math.
//
// Bound: HBM bandwidth. Each element is read once and written twice, 12 bytes
// and three flops, far below the card's 295 flops per byte; the per-row
// thresholds add 4 bytes per row. A densenet_cifar topk round (64 rows, 362
// leaves, P = 1,000,618 columns in all, half of its leaves BatchNorm vectors
// and narrow convolutions of a few hundred columns) moves 768.6 MB, about
// 0.23 ms at the H100 SXM's 3.35 TB/s: one launch per leaf costs more than
// that in launches alone (1.19 ms, PERF.md).
//
// Design, K2's (quantdequant_int8.cu): one launch over a table of leaves. The
// table (four pointers, sizes, each leaf's first tile and head) travels in the
// kernel's parameters as a __grid_constant__ struct kept inside the classic
// 4 KB, so the launch needs no device-side table and no copy; longer lists are
// split into several launches by the plan in Python (kernels._group_plan, at
// most THRESHOLD_GROUP_CAPACITY leaves a launch), which this entry point
// checks. A densenet_cifar round takes 5 launches instead of 362, MobileNet's
// 2 instead of 83, ResNet-18's 1 instead of 62. A block is one tile of
// 4096 elements of one leaf's flattened rows * cols (found by a binary search
// over the tiles' prefix sums), so a narrow leaf fills whole tiles and no row
// sits on a grid axis: rows are not limited. Each thread loads four 16-byte
// vectors of y (ld.global.nc) before it uses any, 64 bytes in flight per
// thread, and writes out and new_e as streaming 16-byte stores. An element's
// row is (flat index) / cols, computed once per vector and stepped, since
// cols need not be a multiple of 4; the row's threshold is read (__ldg) when
// the row changes. A leaf whose y starts off 16-byte alignment (out and new_e
// then start at the same offset: the wrapper allocates them so) does its
// first `head` (< 4) elements one by one, and a leaf whose body is not a
// multiple of 4 elements does its ragged tail one by one. No ring of bulk
// copies: K2 tried one and it ran slower than these loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                          // 16-byte vectors per thread
constexpr int64_t kTile = kThreads * kVecs * 4;   // 4096 elements
constexpr int kMaxLeaves = 77;                    // kernels.THRESHOLD_GROUP_CAPACITY

struct Group {
  const float* y[kMaxLeaves];
  const float* thresh[kMaxLeaves];
  float* out[kMaxLeaves];
  float* new_e[kMaxLeaves];
  int64_t numel[kMaxLeaves];
  int64_t cols[kMaxLeaves];
  int32_t tile_start[kMaxLeaves + 1];  // leaf i's tiles: [tile_start[i], tile_start[i+1])
  int32_t leaves;
  int8_t head[kMaxLeaves];             // elements before y, out and new_e are 16-byte aligned
};
static_assert(sizeof(Group) <= 4096, "the leaf table must fit 4 KB of kernel parameters");

// The kept value: a select, as jnp.where.
__device__ __forceinline__ float keep(float v, float t) {
  return fabsf(v) >= t ? v : 0.0f;
}

// One tile of one leaf: the leaf's operands and the tile's first element.
struct Tile {
  const float* __restrict__ y;
  const float* __restrict__ thresh;
  float* __restrict__ out;
  float* __restrict__ new_e;
  int64_t n, cols;
  int64_t start;  // the tile's first vector element (head + tile * kTile)
  int head;       // > 0 only on a leaf's tile 0: elements before `start`
  bool narrow;    // n < 2^32: rows by 32-bit division
};

// Tile t of a launch: the last leaf whose first tile is <= t.
__device__ __forceinline__ Tile find_tile(const Group& g, int32_t t) {
  int lo = 0, hi = g.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.tile_start[mid] <= t) lo = mid; else hi = mid - 1;
  }
  const int64_t tile = t - g.tile_start[lo];
  Tile T;
  T.y = g.y[lo];
  T.thresh = g.thresh[lo];
  T.out = g.out[lo];
  T.new_e = g.new_e[lo];
  T.n = g.numel[lo];
  T.cols = g.cols[lo];
  T.start = g.head[lo] + tile * kTile;
  T.head = tile == 0 ? g.head[lo] : 0;
  T.narrow = T.n <= 0xffffffffLL;
  return T;
}

// e / cols, in 32 bits where the leaf allows (block-uniform branch).
__device__ __forceinline__ int64_t row_of(const Tile& T, int64_t e) {
  return T.narrow ? static_cast<int64_t>(static_cast<uint32_t>(e) / static_cast<uint32_t>(T.cols))
                  : e / T.cols;
}

__device__ __forceinline__ void scalar_element(const Tile& T, int64_t e) {
  const float v = __ldg(T.y + e);
  const float o = keep(v, __ldg(T.thresh + row_of(T, e)));
  T.out[e] = o;
  T.new_e[e] = __fsub_rn(v, o);
}

// The row of a vector's first element, its column and its threshold.
struct VecRow {
  int64_t row, col;
  float t;
};

__device__ __forceinline__ VecRow vec_row(const Tile& T, int64_t e) {
  VecRow r;
  r.row = e < T.n ? row_of(T, e) : 0;
  r.col = e - r.row * T.cols;
  r.t = e < T.n ? __ldg(T.thresh + r.row) : 0.0f;
  return r;
}

// The 4 elements from e (e + 4 <= n), split and stored with two streaming
// 16-byte stores; the row steps where the vector crosses into the next one.
__device__ __forceinline__ void store_vector(const Tile& T, int64_t e, float4 v, VecRow r) {
  const float in[4] = {v.x, v.y, v.z, v.w};
  float o[4], d[4];
  float t = r.t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && ++r.col == T.cols) {
      r.col = 0;
      t = __ldg(T.thresh + ++r.row);
    }
    o[j] = keep(in[j], t);
    d[j] = __fsub_rn(in[j], o[j]);
  }
  __stcs(reinterpret_cast<float4*>(T.out + e), make_float4(o[0], o[1], o[2], o[3]));
  __stcs(reinterpret_cast<float4*>(T.new_e + e), make_float4(d[0], d[1], d[2], d[3]));
}

// Each block one tile, each thread four 16-byte loads in flight
// (ld.global.nc) before it uses any.
__global__ void __launch_bounds__(kThreads)
threshold_feedback_kernel(const __grid_constant__ Group g) {
  const Tile T = find_tile(g, static_cast<int32_t>(blockIdx.x));
  if (static_cast<int>(threadIdx.x) < T.head) scalar_element(T, threadIdx.x);
  const int64_t base = T.start + 4 * static_cast<int64_t>(threadIdx.x);
  float4 v[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t e = base + k * 4 * kThreads;
    if (e + 4 <= T.n) v[k] = __ldg(reinterpret_cast<const float4*>(T.y + e));
  }
  VecRow r[kVecs];  // computed while the loads are in flight
#pragma unroll
  for (int k = 0; k < kVecs; ++k) r[k] = vec_row(T, base + k * 4 * kThreads);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t e = base + k * 4 * kThreads;
    if (e + 4 <= T.n) {
      store_vector(T, e, v[k], r[k]);
    } else {
      for (int64_t i = e; i < T.n; ++i) scalar_element(T, i);
    }
  }
}

}  // namespace

// `table` is `leaves` rows of 8 int64 in host memory, one per leaf, as
// kernels._group_plan lays them out: y, thresh, out and new_e pointers, rows,
// cols, head (elements before y, out and new_e are 16-byte aligned) and
// tiles. The entry point refuses a table that does not fit the kernel or
// whose tiles or alignment disagree with it.
// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int fedtpu_threshold_feedback(const int64_t* table, int64_t leaves,
                                         cudaStream_t stream) {
  if (leaves <= 0 || leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  int64_t tiles = 0;
  for (int64_t i = 0; i < leaves; ++i) {
    const int64_t* r = table + 8 * i;
    const uintptr_t y = static_cast<uintptr_t>(r[0]);
    const uintptr_t out = static_cast<uintptr_t>(r[2]);
    const uintptr_t new_e = static_cast<uintptr_t>(r[3]);
    const int64_t rows = r[4], cols = r[5], head = r[6], leaf_tiles = r[7];
    if (rows <= 0 || cols <= 0 || rows > INT64_MAX / cols || (y | out | new_e) % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t n = rows * cols;
    const bool body = head < n;  // elements left for the vectors
    if (head < 0 || head > 3 || head > n ||
        (body && ((y + 4 * head) % 16 != 0 || (out + 4 * head) % 16 != 0 ||
                  (new_e + 4 * head) % 16 != 0)) ||
        leaf_tiles != (body ? (n - head + kTile - 1) / kTile : 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.y[i] = reinterpret_cast<const float*>(y);
    g.thresh[i] = reinterpret_cast<const float*>(static_cast<uintptr_t>(r[1]));
    g.out[i] = reinterpret_cast<float*>(out);
    g.new_e[i] = reinterpret_cast<float*>(new_e);
    g.numel[i] = n;
    g.cols[i] = cols;
    g.head[i] = static_cast<int8_t>(head);
    g.tile_start[i] = static_cast<int32_t>(tiles);
    tiles += leaf_tiles;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.tile_start[leaves] = static_cast<int32_t>(tiles);
  g.leaves = static_cast<int32_t>(leaves);
  threshold_feedback_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedtpu_threshold_feedback_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
