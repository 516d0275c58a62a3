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
// in ascending order gives the same bits, wherever its passes split them.
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
// Design. A row of 2^20 f32 is 4 MiB, far beyond a block's shared memory (the
// TPU kernel held a whole row block in VMEM and stops near 2^18 columns), so
// the stages are split into passes over global memory:
//
//   pass 1   each block loads one contiguous chunk of 2^min(m,12) columns of
//            one row (multiplying by the signs on the forward), runs stages
//            0 .. 11 on it and writes it back;
//   pass 2+  each block runs up to 10 further stages lo .. lo+k-1 on a tile of
//            2^k segments, 2^lo apart in the row, each 2^c contiguous columns
//            wide (so loads stay coalesced), in place.
//
// The last pass multiplies by norm, and on the inverse by the signs. Inside
// a block every thread holds 16 elements in registers: a tile is staged in
// shared memory (padded by one word in 16 against bank conflicts), and each
// round trip through it maps 4 stage bits onto a thread's registers, so four
// stages run in registers per __syncthreads(). [64, 2^20] takes two passes
// (twice the bytes of the bound), [*, 2^22] two as well, h <= 4096 one.
//
// Rows go on blockIdx.y (at most 65,535); indices are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogPerThread = 4;
constexpr int kPerThread = 1 << kLogPerThread;  // elements a thread holds
constexpr int kChunkLog = 12;                   // pass 1: 4096 columns
constexpr int kMaxStagesPerPass = 10;
constexpr int kMaxTileLog = 14;                 // 16,384 elements, 1,024 threads

__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// One pass. The block's tile has 2^tile_log elements; local index L splits
// into a column col = L mod 2^col_log and a segment seg = L >> col_log, and
// lies at row offset tile_base + seg * 2^seg_log + col. Local bits
// stage_lo .. stage_lo+stages-1 are butterflied, in ascending order.
__global__ void fwht_pass_kernel(const float* in, float* out,
                                 const float* __restrict__ signs, float norm,
                                 int64_t h, int tile_log, int col_log,
                                 int seg_log, int stage_lo, int stages,
                                 int signs_in, int finish, int signs_out) {
  extern __shared__ float tile[];
  const int t = threadIdx.x;
  const int threads = blockDim.x;  // 2^(tile_log - 4)
  const int64_t groups = (int64_t{1} << seg_log) >> col_log;
  const int64_t group = blockIdx.x % groups;
  const int64_t high = blockIdx.x / groups;
  const int64_t tile_base =
      (group << col_log) + (high << (seg_log + tile_log - col_log));
  const int64_t row_base = static_cast<int64_t>(blockIdx.y) * h;
  const int col_mask = (1 << col_log) - 1;

  // Coalesced load: element L = t + j * threads.
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * threads;
    const int64_t off =
        tile_base + (static_cast<int64_t>(l >> col_log) << seg_log) + (l & col_mask);
    float v = in[row_base + off];
    if (signs_in) v = __fmul_rn(v, signs[off]);
    tile[padded(l)] = v;
  }
  __syncthreads();

  // Stage bits [stage_lo, end), four per round trip: the window of local bits
  // [w, w + 4) goes onto the register index, the thread index fills the rest.
  // The last window is moved down so it stays inside the tile; stages below
  // `done` in it were run already and are skipped.
  const int end = stage_lo + stages;
  for (int done = stage_lo; done < end;) {
    int w = end - kLogPerThread < done ? end - kLogPerThread : done;
    if (w < 0) w = 0;
    const int low_mask = (1 << w) - 1;
    const int base = (t & low_mask) | ((t >> w) << (w + kLogPerThread));
    float r[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) r[j] = tile[padded(base | (j << w))];
#pragma unroll
    for (int q = 0; q < kLogPerThread; ++q) {
      const int bit = w + q;
      if (bit >= done && bit < end) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          if (!(j & (1 << q))) {
            const float a = r[j];
            const float b = r[j | (1 << q)];
            r[j] = __fadd_rn(a, b);
            r[j | (1 << q)] = __fsub_rn(a, b);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) tile[padded(base | (j << w))] = r[j];
    __syncthreads();
    done = w + kLogPerThread;
  }

#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int l = t + j * threads;
    const int64_t off =
        tile_base + (static_cast<int64_t>(l >> col_log) << seg_log) + (l & col_mask);
    float v = tile[padded(l)];
    if (finish) v = __fmul_rn(v, norm);
    if (signs_out) v = __fmul_rn(v, signs[off]);
    out[row_base + off] = v;
  }
}

cudaError_t launch_pass(const float* in, float* out, const float* signs,
                        float norm, int64_t rows, int64_t h, int tile_log,
                        int col_log, int seg_log, int stage_lo, int stages,
                        int signs_in, int finish, int signs_out,
                        cudaStream_t stream) {
  const int threads = 1 << (tile_log - kLogPerThread);
  const size_t smem = sizeof(float) * static_cast<size_t>(padded(1 << tile_log));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(h >> tile_log), static_cast<unsigned>(rows));
  fwht_pass_kernel<<<grid, threads, smem, stream>>>(
      in, out, signs, norm, h, tile_log, col_log, seg_log, stage_lo, stages,
      signs_in, finish, signs_out);
  return cudaGetLastError();
}

}  // namespace

// Launches every pass on `stream`; returns the first CUDA error as an int
// (0 = launched). h must be a power of two >= 128, 1 <= rows <= 65535.
extern "C" int fedtpu_hadamard_rotate(const float* y, const float* signs,
                                      float* out, int64_t rows, int64_t h,
                                      int inverse, float norm,
                                      cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || h < 128 || (h & (h - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int m = 0;
  while ((int64_t{1} << m) < h) ++m;
  const int b = m < kChunkLog ? m : kChunkLog;
  cudaError_t err = launch_pass(y, out, signs, norm, rows, h, b, b, b, 0, b,
                                !inverse, b == m, inverse && b == m, stream);
  for (int lo = b; err == cudaSuccess && lo < m;) {
    const int k = m - lo < kMaxStagesPerPass ? m - lo : kMaxStagesPerPass;
    // Segment width 2^c: as wide as keeps the tile at 2^13 elements (2^14
    // when k = 10), never below 16 columns.
    int c = kMaxTileLog - 1 - k;
    if (c < kLogPerThread) c = kLogPerThread;
    const bool last = lo + k == m;
    err = launch_pass(out, out, signs, norm, rows, h, c + k, c, lo, c, k, 0,
                      last, inverse && last, stream);
    lo += k;
  }
  return static_cast<int>(err);
}

extern "C" const char* fedtpu_hadamard_rotate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
