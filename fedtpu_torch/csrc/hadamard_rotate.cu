// Seeded Hadamard rotation of full rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fedtpu/ops/pallas_kernels.py::hadamard_rotate
// (:179; body _hadamard_kernel :165 over _fwht_body :143; pallas_call :210).
// For y [rows, h] f32 with h = 2^m and signs [h] (+-1):
//   forward:  out = fwht(y * signs) * norm
//   inverse:  out = fwht(y) * norm * signs
// with norm = f32(1 / sqrt(h)) and fwht the unnormalised fast Walsh-Hadamard
// transform as a stride-doubling butterfly: at stage s every pair
// (i, i + 2^s) with bit s of i clear becomes (a + b, a - b).
//
// Bit-equality with the plain version (and with fedtpu): the butterfly is a
// fixed graph of f32 adds and subtracts, so any kernel that runs the stages
// in ascending order gives the same bits, wherever its phases split them.
// Every add, subtract and multiply is written with an _rn intrinsic, so
// nothing is contracted into an FMA, and the file is never built with
// --use_fast_math (which would also flush subnormals to zero).
//
// Bound: HBM bandwidth. The transform reads each element once and writes it
// once, 8 bytes for m add/subtracts; on the rotq round of smallcnn
// ([64, 2^20]) that is 536.9 MB per call plus 4.2 MB of signs, 0.1615 ms at
// the H100 SXM's 3.35 TB/s, while its 1.48 G adds and multiplies take
// 0.022 ms at 67 TFLOP/s.
//
// Design: one launch per call, reading y once and writing out once. A
// 2^20-column row is 4 MiB, far beyond a block's shared memory (and beyond
// a 16-block cluster's 3.55 MiB), so the stages are split into phases, as
// the plan computed in Python says (kernels.py::_hadamard_plan):
//
//   phase 0  stages 0 .. min(m, 13) - 1 on contiguous chunks of 2^13
//            elements, reading y (times the signs on the forward) and
//            writing the intermediate to out;
//   phase p  up to 9 further stages on tiles of 2^k segments, 2^lo apart,
//            2^(13 - k) contiguous columns wide, reading out and writing it
//            in place.
//
// Widths up to 2^13 need phase 0 only; a tile then holds 2^(13 - m) rows.
// Between the phases the intermediate is meant to stay in the H100's 50 MB
// L2: a grid of persistent blocks (as many as fit on the card) takes work
// items from a global ticket, in an order that runs phase p of a row `lag`
// rows after phase p-1 of it, the lag chosen in Python so that the rows
// between two phases take about 16 MiB. An item of phase p waits (acquire
// load on a counter) until every tile of phase p-1 of its row has been
// released (barrier, fence, atomic add, as CUTLASS's GenericBarrier does).
// Every item it waits on has a lower ticket and so was taken by a block
// that is already running, which keeps the grid free of deadlock with no
// grid-wide barrier. A block takes its next ticket and, when nothing that
// item waits on is pending, starts its loads (cp.async, through L2 only:
// later phases read what other SMs wrote) into a staging buffer in shared
// memory before it runs the current item's stages; else it loads the item
// once the current one is released.
//
// Inside a block, 512 threads hold 16 elements each. A thread's registers
// hold four local bits of the tile: a window of four neighbouring bits, or
// bits 0, 1, 11 and 12 (the vector layout). The staged tile is read
// straight into the layout whose bits hold the tile's first stages; each
// round trip through shared memory puts the next window in registers, and
// the stages whose bits lie in registers run there, in ascending order. The
// last stages end in a layout with local bits 0 and 1 in registers (after
// one more round trip if need be), so that every thread stores 16-byte
// vectors, with norm and, on the inverse, the signs applied on the way. The
// window sequence is worked out at compile time for each tile shape (a
// template per stage count), so every shared-memory address is a register
// plus a constant. The tile in shared memory is padded, and the staging
// buffer swizzled, so that these layouts meet no bank conflicts but on
// phase 0's first round trip.
//
// The counters (a 64-bit ticket, then one count per row and phase that
// another phase waits on) are zeroed by the caller for every call.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The tile: 2^13 elements, 512 threads of 16 each (kernels.py's
// HADAMARD_TILE_LOG; the entry point refuses a plan made for another).
constexpr int kTileLog = 13;
constexpr int kTile = 1 << kTileLog;
constexpr int kLogPerThread = 4;
constexpr int kPerThread = 1 << kLogPerThread;  // elements a thread holds
constexpr int kThreads = kTile / kPerThread;
constexpr int kVectors = kPerThread / 4;        // 16-byte vectors a thread moves
// Three resident blocks an SM (40 registers a thread): on the card, three
// blocks of 512 threads beat one or two with more registers each.
constexpr int kMinBlocks = 3;
constexpr int kMaxPhases = 4;
constexpr int kPlanHead = 5;             // tile_log, phases, lag, units, unit_len
constexpr int kPlanPerPhase = 5;         // stage_lo, stages, col_log, seg_log, tiles

// Where local index i of a tile lies in shared memory: local bits 5 .. 8
// add 1, 2, 8 and 16 words and every 512 elements 32 more, so that the 32
// threads of a warp reach 32 banks in every layout a round trip uses. Each
// bit adds its own weight, so padded(a + b) = padded(a) + padded(b) for a
// and b on disjoint bits.
__host__ __device__ constexpr int padded(int i) {
  return i + ((i >> 5) & 1) + 2 * ((i >> 6) & 1) + 8 * ((i >> 7) & 1) + 16 * ((i >> 8) & 1) +
         32 * (i >> 9);
}
constexpr int kTileWords = (padded(kTile - 1) + 4) & ~3;  // keeps the staging buffer 16-byte aligned

// The staging buffer holds chunk c (local indices 4c .. 4c+3) at chunk
// swizzle(c), so that the first layout of every tile shape reads it, and
// the 16-byte loads fill it, with no bank conflicts. Both are linear over
// XOR: for b and s on disjoint bits, s a multiple of 4, staged(b + s) =
// staged(b) ^ staged(s), a register and a constant.
__host__ __device__ constexpr int swizzle(int c) {
  return c ^ ((c >> 3) & 3) ^ (((c >> 6) & 1) << 2);
}
__host__ __device__ constexpr int staged(int l) { return 4 * swizzle(l >> 2) + (l & 3); }

struct Plan {
  int phases;
  int lag;
  int64_t units;     // rows, or 1 when one phase covers the matrix
  int64_t unit_len;  // elements of a unit
  int64_t h;
  int col_log[kMaxPhases];  // a phase's first stage is local bit col_log
  int stages[kMaxPhases];
  int seg_log[kMaxPhases];
  int64_t tiles[kMaxPhases];
  int64_t first[kMaxPhases];  // tickets of a step before phase p
  int64_t per_step;           // tickets of a step
  uint64_t total;             // tickets in all
};

// a[i] for a phase index known only at run time, without local memory.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxPhases], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxPhases; ++k) {
    if (k == i) v = a[k];
  }
  return v;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A work item: a tile of a phase of a unit, or none (phase < 0).
struct Item {
  int64_t unit;
  int64_t tile;
  int phase;
};

// Takes tickets until one names an item (or none are left).
__device__ Item take_item(unsigned long long* ticket, const Plan& plan) {
  for (;;) {
    const unsigned long long tk = atomicAdd(ticket, 1ull);
    if (tk >= plan.total) return Item{0, 0, -1};
    const int64_t step = static_cast<int64_t>(tk) / plan.per_step;
    const int64_t within = static_cast<int64_t>(tk) % plan.per_step;
    int p = 0;
    int64_t before = 0;
#pragma unroll
    for (int k = 1; k < kMaxPhases; ++k) {
      if (k < plan.phases && within >= plan.first[k]) {
        p = k;
        before = plan.first[k];
      }
    }
    const int64_t u = step - static_cast<int64_t>(p) * plan.lag;
    if (u >= 0 && u < plan.units) return Item{u, within - before, p};
    // else a step at either end of the order: no item
  }
}

// Where an item's tile lies: local index l at base + within(l) in the unit,
// where within(l) = ((l >> C) << seg) + (l mod 2^C) fits in 32 bits.
struct TileMap {
  int64_t row0;   // the unit's first element
  int64_t base;   // the tile's local index 0, in the unit
  int64_t limit;  // elements of the unit from base on (a tile may overhang)
  int seg, col0;
  __device__ TileMap(const Plan& plan, const Item& it) {
    const int c = pick(plan.col_log, it.phase);
    seg = pick(plan.seg_log, it.phase);
    const int group_log = seg - c;  // tiles side by side within 2^seg columns
    base = ((it.tile & ((int64_t{1} << group_log) - 1)) << c) +
           ((it.tile >> group_log) << (seg + kTileLog - c));
    row0 = it.unit * plan.unit_len;
    limit = plan.unit_len - base;
    col0 = static_cast<int>(base & (plan.h - 1));
  }
};

template <int C>
__device__ __forceinline__ int within(int l, int seg) {
  return ((l >> C) << seg) + (l & ((1 << C) - 1));
}

// Register layouts. In the vector layout (w < 0) register j of thread t
// holds local index 4 (t + kThreads (j >> 2)) + (j & 3); in window w, local
// bits w .. w+3 come from j and the others from t. Either way the index is
// layout_base(t, w) + layout_step(w, j) with the two on disjoint bits, so
// padded() and within() of the sum are the sums of theirs: every address is
// one register plus a constant. Layouts w <= 0 hold local bits 0 and 1 in
// register bits 0 and 1: four neighbouring registers are one 16-byte vector.
__device__ __forceinline__ int layout_base(int t, int w) {
  return w < 0 ? 4 * t : (t & ((1 << w) - 1)) | ((t >> w) << (w + kLogPerThread));
}
__host__ __device__ constexpr int layout_step(int w, int j) {
  return w < 0 ? 4 * kThreads * (j >> 2) + (j & 3) : j << w;
}
// The register bit that holds local bit b in layout w, or -1.
__host__ __device__ constexpr int register_bit(int w, int b) {
  return w < 0 ? (b < 2 ? b
                       : b >= kTileLog - (kLogPerThread - 2) ? b - (kTileLog - kLogPerThread)
                                                            : -1)
               : (b >= w && b < w + kLogPerThread ? b - w : -1);
}
// The layout that holds stage `done` and as many after it as fit: the
// vector layout for the last two stages of a tile, else a window.
__host__ __device__ constexpr int next_layout(int done, int end) {
  return done >= kTileLog - 2 ? -1
         : end - kLogPerThread < done ? (end - kLogPerThread < 0 ? 0 : end - kLogPerThread)
                                      : done;
}
// The layout the registers are stored from once stages done .. end-1 have
// run from layout w (run_stages ends in one with 16-byte vectors).
__host__ __device__ constexpr int store_layout(int w, int done, int end) {
  return done >= end ? (w > 0 ? -1 : w)
         : register_bit(w, done) >= 0 ? store_layout(w, done + 1, end)
                                      : store_layout(next_layout(done, end), done, end);
}

// One butterfly stage across register bit Q.
template <int Q>
__device__ __forceinline__ void stage_in_registers(float (&r)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!(j & (1 << Q))) {
      const float x0 = r[j];
      const float x1 = r[j | (1 << Q)];
      r[j] = __fadd_rn(x0, x1);
      r[j | (1 << Q)] = __fsub_rn(x0, x1);
    }
  }
}

// A round trip through shared memory from layout W into layout NW.
template <int W, int NW>
__device__ __forceinline__ void exchange(float (&r)[kPerThread], float* tile, int t) {
  // No barrier before the write: it goes to the places this thread read.
  float* wp = tile + padded(layout_base(t, W));
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) wp[padded(layout_step(W, j))] = r[j];
  __syncthreads();
  const float* rp = tile + padded(layout_base(t, NW));
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) r[j] = rp[padded(layout_step(NW, j))];
}

// Stages Done .. End-1 (local bits), in ascending order, from layout W: in
// registers while the next stage's bit lies there, else through a round
// trip of shared memory into the next layout; at the end, a round trip
// into the vector layout if W is a window past bit 0.
template <int W, int Done, int End>
__device__ __forceinline__ void run_stages(float (&r)[kPerThread], float* tile, int t) {
  if constexpr (Done < End) {
    constexpr int q = register_bit(W, Done);
    if constexpr (q >= 0) {
      stage_in_registers<q>(r);
      run_stages<W, Done + 1, End>(r, tile, t);
    } else {
      constexpr int NW = next_layout(Done, End);
      exchange<W, NW>(r, tile, t);
      run_stages<NW, Done, End>(r, tile, t);
    }
  } else if constexpr (W > 0) {
    exchange<W, -1>(r, tile, t);
  }
}

// Whether every item that `it` waits on has been released.
__device__ __forceinline__ bool ready(const unsigned* released, const Plan& plan,
                                      const Item& it) {
  if (it.phase <= 0) return true;
  const unsigned* c = released + it.unit * (plan.phases - 1) + it.phase - 1;
  return load_acquire(c) >= static_cast<unsigned>(pick(plan.tiles, it.phase - 1));
}

// A contiguous tile may overhang the end of a one-phase unit; a strided one
// never does.
template <int C>
__device__ __forceinline__ bool is_full(const TileMap& map) {
  return C != 0 || map.limit >= kTile;
}

// Issues a tile's loads into the staging buffer, asynchronously (cp.async,
// through L2 only: later phases read what other SMs wrote): kVectors
// 16-byte vectors a thread, chunk c = t + kThreads q of the tile at chunk
// swizzle(c) (four neighbouring local indices are neighbours in memory:
// C >= 2, or a contiguous tile). Past the end of a unit the vectors are
// zero-filled.
template <int C>
__device__ __forceinline__ void load_tile(const float* y, const float* out, const TileMap& map,
                                          bool first, int t, float* stage) {
  const float* src = (first ? y : out) + map.row0 + map.base;
  const int o0 = within<C>(4 * t, map.seg);
  const unsigned dst0 = static_cast<unsigned>(__cvta_generic_to_shared(stage)) +
                        4 * staged(4 * t);
#pragma unroll
  for (int q = 0; q < kVectors; ++q) {
    const int o = o0 + within<C>(4 * kThreads * q, map.seg);
    const int bytes = is_full<C>(map) || o < map.limit ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     dst0 + 4 * staged(4 * kThreads * q)),
                 "l"(src + (bytes ? o : 0)), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// a * b for each of four lanes, rounded to nearest.
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// The staged tile into registers, in the layout that holds the tile's first
// stage: 16-byte vectors for a layout that has them, times the signs on the
// forward's phase 0 (C = 0, whose first layout is window 0).
template <int C, int K>
__device__ __forceinline__ void unpack(const float* stage, float (&r)[kPerThread],
                                       const float* signs, const TileMap& map, bool signs_in,
                                       int t, int hmask) {
  constexpr int F = next_layout(C, C + K);
  const int b = layout_base(t, F);
  const int sb = staged(b);
  if constexpr (F <= 0) {
#pragma unroll
    for (int q = 0; q < kVectors; ++q) {
      const int l = b + layout_step(F, 4 * q);
      const float* src = stage + (sb ^ staged(layout_step(F, 4 * q)));
      float4 v = *reinterpret_cast<const float4*>(src);
      if constexpr (C == 0) {
        if (signs_in) {
          v = mul4(v, __ldg(reinterpret_cast<const float4*>(signs + ((map.col0 + l) & hmask))));
        }
      }
      r[4 * q + 0] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
    static_assert(C > 0, "phase 0 starts in window 0");
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) r[j] = stage[sb ^ staged(layout_step(F, j))];
  }
}

// Stages local bits C .. C+K-1, then the store from registers as 16-byte
// vectors, with norm and, on the inverse, the signs on the last phase.
template <int C, int K>
__device__ __forceinline__ void compute_store(float (&r)[kPerThread], float* out,
                                              const float* signs, float* tile,
                                              const TileMap& map, int t, bool last, int inverse,
                                              float norm, int hmask) {
  constexpr int F = next_layout(C, C + K);
  run_stages<F, C, C + K>(r, tile, t);
  constexpr int S = store_layout(F, C, C + K);
  static_assert(S <= 0, "the store moves 16-byte vectors");
  float* dst = out + map.row0 + map.base;
  const int o0 = within<C>(layout_base(t, S), map.seg);
#pragma unroll
  for (int q = 0; q < kVectors; ++q) {
    const int o = o0 + within<C>(layout_step(S, 4 * q), map.seg);
    if (is_full<C>(map) || o < map.limit) {
      float4 v = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
      float4* p = reinterpret_cast<float4*>(dst + o);
      if (last) {
        v = mul4(v, make_float4(norm, norm, norm, norm));
        if (inverse) {
          v = mul4(v, __ldg(reinterpret_cast<const float4*>(signs + ((map.col0 + o) & hmask))));
        }
        __stcs(p, v);
      } else {
        __stcg(p, v);
      }
    }
  }
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// Calls f(Int<C>, Int<K>) for the tile shape (c, k) known at run time:
// phase 0 (c = 0) runs 7 .. kTileLog stages, later phases
// (c = kTileLog - k) 1 .. kTileLog - 4.
template <int K, typename F>
__device__ __forceinline__ void dispatch(int c, int k, F&& f) {
  if constexpr (K >= 1) {
    if (k == K) {
      if constexpr (K >= 7) {
        if (c == 0) {
          f(Int<0>{}, Int<K>{});
          return;
        }
      }
      if constexpr (K <= kTileLog - 4) f(Int<kTileLog - K>{}, Int<K>{});
      return;
    }
    dispatch<K - 1>(c, k, f);
  }
}

// Dynamic shared memory: the padded tile, then the staging buffer.
constexpr size_t kSmemBytes = sizeof(float) * (kTileWords + kTile);

// A grid of persistent blocks, each taking items by ticket until none are
// left. While one item's stages run, the next item's loads are in flight
// into the staging buffer.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hadamard_rotate_kernel(const float* __restrict__ y, const float* __restrict__ signs,
                       float* out, unsigned* counters, const Plan plan,
                       int inverse, float norm) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* stage = tile + kTileWords;
  __shared__ Item s_item;
  __shared__ int s_ready;
  auto* ticket = reinterpret_cast<unsigned long long*>(counters);
  unsigned* released = counters + 2;
  const int t = threadIdx.x;
  const int hmask = static_cast<int>(plan.h - 1);

  if (t == 0) s_item = take_item(ticket, plan);
  __syncthreads();
  Item cur = s_item;
  bool loaded = false;

  while (cur.phase >= 0) {
    if (!loaded) {  // every item this block took before is released
      if (t == 0) {
        while (!ready(released, plan, cur)) __nanosleep(32);
      }
      __syncthreads();
      const TileMap map(plan, cur);
      dispatch<kTileLog>(pick(plan.col_log, cur.phase), pick(plan.stages, cur.phase),
                         [&](auto c, auto) {
                           load_tile<decltype(c)::value>(y, out, map, cur.phase == 0, t,
                                                         stage);
                         });
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the current tile is in stage[]
    const TileMap map(plan, cur);
    const int c = pick(plan.col_log, cur.phase);
    const int k = pick(plan.stages, cur.phase);
    const bool last = cur.phase == plan.phases - 1;
    float r[kPerThread];
    dispatch<kTileLog>(c, k, [&](auto cc, auto kk) {
      unpack<decltype(cc)::value, decltype(kk)::value>(stage, r, signs, map,
                                                       cur.phase == 0 && !inverse, t, hmask);
    });

    // The next item: its loads go out now if nothing it waits on is
    // pending (it may wait on this very item), else after this one.
    if (t == 0) {
      const Item next = take_item(ticket, plan);
      s_ready = next.phase >= 0 && ready(released, plan, next);
      s_item = next;
    }
    __syncthreads();  // every read of stage[], and of the previous tile[], is done
    const Item next = s_item;
    loaded = s_ready;
    if (loaded) {
      const TileMap nmap(plan, next);
      dispatch<kTileLog>(pick(plan.col_log, next.phase), pick(plan.stages, next.phase),
                         [&](auto nc, auto) {
                           load_tile<decltype(nc)::value>(y, out, nmap, next.phase == 0, t,
                                                          stage);
                         });
    }

    dispatch<kTileLog>(c, k, [&](auto cc, auto kk) {
      compute_store<decltype(cc)::value, decltype(kk)::value>(r, out, signs, tile, map, t, last,
                                                             inverse, norm, hmask);
    });

    // Release: every thread's stores, then the count (as CUTLASS's
    // GenericBarrier does). The barrier also keeps s_item until all read it.
    __syncthreads();
    if (t == 0 && !last) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      atomicAdd(released + cur.unit * (plan.phases - 1) + cur.phase, 1u);
    }
    cur = next;
  }
}

int g_grid[64];  // persistent blocks per device, found at first use

cudaError_t persistent_grid(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && g_grid[dev] > 0) {
    *blocks = g_grid[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hadamard_rotate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hadamard_rotate_kernel,
                                                      kThreads, kSmemBytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < 64) g_grid[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// Launches the rotation of y's rows on `stream` as one kernel; returns the
// CUDA error as an int (0 = launched). `plan` holds plan_len int64s: the
// tile's log2 (which must be this build's), the phase count, the lag, the
// units and their length, then per phase its first stage, stage count,
// column and segment logs and tile count. `counters` is zeroed device
// memory of 2 + units * (phases - 1) 32-bit words.
extern "C" int fedtpu_hadamard_rotate(const float* y, const float* signs,
                                      float* out, unsigned* counters, int64_t h,
                                      int inverse, float norm,
                                      const int64_t* plan_in, int plan_len,
                                      cudaStream_t stream) {
  if (plan_len < kPlanHead + kPlanPerPhase || plan_in[0] != kTileLog) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan = {};
  plan.phases = static_cast<int>(plan_in[1]);
  if (plan.phases < 1 || plan.phases > kMaxPhases ||
      plan_len != kPlanHead + kPlanPerPhase * plan.phases || h < 128 ||
      h > (int64_t{1} << 30) || (h & (h - 1)) != 0) {  // offsets in a tile: 32 bits
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan.lag = static_cast<int>(plan_in[2]);
  plan.units = plan_in[3];
  plan.unit_len = plan_in[4];
  plan.h = h;
  for (int p = 0; p < plan.phases; ++p) {
    const int64_t* ph = plan_in + kPlanHead + kPlanPerPhase * p;
    plan.col_log[p] = static_cast<int>(ph[2]);
    plan.stages[p] = static_cast<int>(ph[1]);
    plan.seg_log[p] = static_cast<int>(ph[3]);
    plan.tiles[p] = ph[4];
    plan.first[p] = plan.per_step;
    plan.per_step += ph[4];
    if (plan.col_log[p] + plan.stages[p] > kTileLog || plan.tiles[p] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (plan.units < 1 || plan.unit_len < 1 || (plan.phases > 1 && plan.lag < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t steps = plan.units + static_cast<int64_t>(plan.lag) * (plan.phases - 1);
  plan.total = static_cast<uint64_t>(steps * plan.per_step);
  int blocks = 0;
  const cudaError_t err = persistent_grid(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = plan.units * plan.per_step;
  if (items < blocks) blocks = static_cast<int>(items);
  hadamard_rotate_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(y, signs, out, counters,
                                                                   plan, inverse, norm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedtpu_hadamard_rotate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
