// Simulated symmetric int8 quantize-dequantize, for NVIDIA Hopper (sm_90a),
// over every leaf of a round in one launch.
//
// Replaces the TPU kernel fedtpu/ops/pallas_kernels.py::quantdequant_int8
// (:233; body _quantdequant_kernel :223; pallas_call :251). For each leaf,
// x [rows, cols] f32 and one scale per row (max|x| / 127 of that row):
//   s'  = s > 0 ? s : 1              (an all-zero row keeps scale 0: no 0/0)
//   out = clip(rint(x / s'), -127, 127) * s'
// rint is IEEE round-half-to-even (jnp.round), the division is correctly
// rounded (__fdiv_rn, never a multiply by the reciprocal), and the clip is
// written with comparisons so a NaN passes through as jnp.clip lets it. The
// source must not be built with --use_fast_math, which would relax both.
//
// Bound: HBM bandwidth. Each element is read once and written once, 8 bytes
// and five flops, far below the card's 295 flops per byte; the per-row scales
// add 4 bytes per row. A MobileNet int8 round (64 rows, 83 leaves, P =
// 3,217,226 columns in all) moves 1.65 GB, about 0.49 ms at the H100 SXM's
// 3.35 TB/s; 73 of its leaves are small (BatchNorm vectors, depthwise
// kernels) and carry 3% of those bytes.
//
// Design: one launch over a table of leaves. The table (pointers, sizes and
// each leaf's first tile) travels in the kernel's parameters as a
// __grid_constant__ struct kept inside the classic 4 KB, so the launch needs
// no device-side table and no copy; longer lists are split into several
// launches by the plan in Python (kernels._int8_group_plan), which this entry
// point checks. A block is one tile of 4096 elements of one leaf's flattened
// rows * cols (found by a binary search over the tiles' prefix sums), so a
// narrow leaf fills whole tiles and rows are not limited by a grid axis. Each
// thread loads four 16-byte vectors (ld.global.nc) before it uses any, 64
// bytes in flight per thread, and stores them as streaming 16-byte stores.
// An element's row is (flat index) / cols, computed once per vector and
// stepped, since cols need not be a multiple of 4. A leaf whose x starts off
// 16-byte alignment (out then starts at the same offset: the wrapper
// allocates it so) does its first `head` (< 4) elements one by one, and a
// leaf whose body is not a multiple of 4 elements does its ragged tail one
// by one. These loads run as fast as a device copy of the same bytes; a form
// that fed persistent blocks through a ring of 1-D bulk copies (cp.async.bulk
// into shared memory) ran slower and was not kept (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                          // 16-byte vectors per thread
constexpr int64_t kTile = kThreads * kVecs * 4;   // 4096 elements
constexpr int kMaxLeaves = 90;                    // kernels.INT8_GROUP_CAPACITY

struct Group {
  const float* x[kMaxLeaves];
  const float* scale[kMaxLeaves];
  float* out[kMaxLeaves];
  int64_t numel[kMaxLeaves];
  int64_t cols[kMaxLeaves];
  int32_t tile_start[kMaxLeaves + 1];  // leaf i's tiles: [tile_start[i], tile_start[i+1])
  int32_t leaves;
  int8_t head[kMaxLeaves];             // elements before x and out are 16-byte aligned
};
static_assert(sizeof(Group) <= 4096, "the leaf table must fit 4 KB of kernel parameters");

__device__ __forceinline__ float safe_scale(const float* scale, int64_t row) {
  const float s = __ldg(scale + row);
  return s > 0.0f ? s : 1.0f;
}

__device__ __forceinline__ float quantdequant(float v, float safe) {
  const float q = rintf(__fdiv_rn(v, safe));
  const float clipped = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
  return __fmul_rn(clipped, safe);
}

// One tile of one leaf: the leaf's operands and the tile's first element.
struct Tile {
  const float* __restrict__ x;
  const float* __restrict__ scale;
  float* __restrict__ out;
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
  T.x = g.x[lo];
  T.scale = g.scale[lo];
  T.out = g.out[lo];
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
  T.out[e] = quantdequant(__ldg(T.x + e), safe_scale(T.scale, row_of(T, e)));
}

// The row of a vector's first element, its column and its safe scale.
struct VecRow {
  int64_t row, col;
  float safe;
};

__device__ __forceinline__ VecRow vec_row(const Tile& T, int64_t e) {
  VecRow r;
  r.row = e < T.n ? row_of(T, e) : 0;
  r.col = e - r.row * T.cols;
  r.safe = e < T.n ? safe_scale(T.scale, r.row) : 1.0f;
  return r;
}

// The 4 elements from e (e + 4 <= n), quantized and stored with a streaming
// 16-byte store; the row steps where the vector crosses into the next one.
__device__ __forceinline__ void store_vector(const Tile& T, int64_t e, float4 v, VecRow r) {
  float q[4] = {v.x, v.y, v.z, v.w};
  float s = r.safe;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j > 0 && ++r.col == T.cols) {
      r.col = 0;
      s = safe_scale(T.scale, ++r.row);
    }
    q[j] = quantdequant(q[j], s);
  }
  __stcs(reinterpret_cast<float4*>(T.out + e), make_float4(q[0], q[1], q[2], q[3]));
}

// Each block one tile, each thread four 16-byte loads in flight
// (ld.global.nc) before it uses any.
__global__ void __launch_bounds__(kThreads)
quantdequant_int8_kernel(const __grid_constant__ Group g) {
  const Tile T = find_tile(g, static_cast<int32_t>(blockIdx.x));
  if (static_cast<int>(threadIdx.x) < T.head) scalar_element(T, threadIdx.x);
  const int64_t base = T.start + 4 * static_cast<int64_t>(threadIdx.x);
  float4 v[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t e = base + k * 4 * kThreads;
    if (e + 4 <= T.n) v[k] = __ldg(reinterpret_cast<const float4*>(T.x + e));
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

// `table` is `leaves` rows of 7 int64 in host memory, one per leaf, as
// kernels._int8_group_plan lays them out: x, scale and out pointers, rows,
// cols, head (elements before x and out are 16-byte aligned) and tiles. The
// entry point refuses a table that does not fit the kernel or whose tiles or
// alignment disagree with it.
// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int fedtpu_quantdequant_int8(const int64_t* table, int64_t leaves,
                                        cudaStream_t stream) {
  if (leaves <= 0 || leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  int64_t tiles = 0;
  for (int64_t i = 0; i < leaves; ++i) {
    const int64_t* r = table + 7 * i;
    const uintptr_t x = static_cast<uintptr_t>(r[0]);
    const uintptr_t out = static_cast<uintptr_t>(r[2]);
    const int64_t rows = r[3], cols = r[4], head = r[5], leaf_tiles = r[6];
    if (rows <= 0 || cols <= 0 || rows > INT64_MAX / cols || (x | out) % 4 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t n = rows * cols;
    const bool body = head < n;  // elements left for the vectors
    if (head < 0 || head > 3 || head > n ||
        (body && ((x + 4 * head) % 16 != 0 || (out + 4 * head) % 16 != 0)) ||
        leaf_tiles != (body ? (n - head + kTile - 1) / kTile : 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.x[i] = reinterpret_cast<const float*>(x);
    g.scale[i] = reinterpret_cast<const float*>(static_cast<uintptr_t>(r[1]));
    g.out[i] = reinterpret_cast<float*>(out);
    g.numel[i] = n;
    g.cols[i] = cols;
    g.head[i] = static_cast<int8_t>(head);
    g.tile_start[i] = static_cast<int32_t>(tiles);
    tiles += leaf_tiles;
    if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.tile_start[leaves] = static_cast<int32_t>(tiles);
  g.leaves = static_cast<int32_t>(leaves);
  quantdequant_int8_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedtpu_quantdequant_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
