// Fused top-k threshold with error feedback, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fedtpu/ops/pallas_kernels.py::threshold_with_feedback
// (:108; body _threshold_kernel :93; pallas_call :124). For y [rows, cols] f32
// (a client's delta + residual per row) and one magnitude threshold per row:
//   keep  = |y| >= thresh[row]
//   out   = keep ? y : 0        (a select, so -0.0, NaN and ties at the
//                                threshold behave exactly as jnp.where)
//   new_e = y - out
//
// Bound: HBM bandwidth. Each element is read once and written twice, 12 bytes
// and three flops, far below the card's 295 flops per byte; the per-row
// thresholds add 4 bytes per row. On the compressed smallcnn round (64 rows,
// eight leaves, P = 545,098 columns in all) that is 418.6 MB per round, about
// 0.125 ms at the H100 SXM's 3.35 TB/s.
//
// Design: a 2-D grid. blockIdx.y is the row, so the row's threshold is read
// once per block and no thread divides an index by the row length;
// blockIdx.x strides the columns, neighbouring threads on neighbouring
// addresses, so every load and store is coalesced. The x extent is capped and
// each thread loops, which keeps the grid small on the 524,288-column leaf
// and one block per row on the 10-column leaf. Nothing is staged in shared
// memory: each byte is touched once, so there is nothing to reuse.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1024;

__global__ void threshold_feedback_kernel(const float* __restrict__ y,
                                          const float* __restrict__ thresh,
                                          float* __restrict__ out,
                                          float* __restrict__ new_e,
                                          int64_t cols) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * cols;
  const float t = thresh[blockIdx.y];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < cols; c += stride) {
    const float v = y[base + c];
    const float o = fabsf(v) >= t ? v : 0.0f;
    out[base + c] = o;
    new_e[base + c] = __fsub_rn(v, o);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int fedtpu_threshold_feedback(const float* y, const float* thresh,
                                         float* out, float* new_e, int64_t rows,
                                         int64_t cols, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks_x = (cols + kThreads - 1) / kThreads;
  if (blocks_x > kMaxBlocksX) blocks_x = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(rows));
  threshold_feedback_kernel<<<grid, kThreads, 0, stream>>>(y, thresh, out, new_e,
                                                            cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedtpu_threshold_feedback_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
