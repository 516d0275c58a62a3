// Simulated symmetric int8 quantize-dequantize, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fedtpu/ops/pallas_kernels.py::quantdequant_int8
// (:233; body _quantdequant_kernel :223; pallas_call :251). For x [rows, cols]
// f32 and one scale per row (max|x| / 127 of that row):
//   s'  = s > 0 ? s : 1              (an all-zero row keeps scale 0: no 0/0)
//   out = clip(rint(x / s'), -127, 127) * s'
// rint is IEEE round-half-to-even (jnp.round), the division is correctly
// rounded (__fdiv_rn, never a multiply by the reciprocal), and the clip is
// written with comparisons so a NaN passes through as jnp.clip lets it. The
// source must not be built with --use_fast_math, which would relax both.
//
// Bound: HBM bandwidth. Each element is read once and written once, 8 bytes
// and five flops, far below the card's 295 flops per byte; the per-row scales
// add 4 bytes per row. On the compressed smallcnn round (64 rows, eight leaves,
// P = 545,098 columns in all) that is 279.1 MB per round, about 0.083 ms at the
// H100 SXM's 3.35 TB/s.
//
// Design: the same 2-D grid as threshold_feedback.cu. blockIdx.y is the row,
// so each block reads its scale and derives the safe scale once; blockIdx.x
// strides the columns with coalesced loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1024;

__global__ void quantdequant_int8_kernel(const float* __restrict__ x,
                                         const float* __restrict__ scale,
                                         float* __restrict__ out, int64_t cols) {
  const int64_t base = static_cast<int64_t>(blockIdx.y) * cols;
  const float s = scale[blockIdx.y];
  const float safe = s > 0.0f ? s : 1.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < cols; c += stride) {
    const float q = rintf(__fdiv_rn(x[base + c], safe));
    const float clipped = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
    out[base + c] = __fmul_rn(clipped, safe);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int fedtpu_quantdequant_int8(const float* x, const float* scale,
                                        float* out, int64_t rows, int64_t cols,
                                        cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks_x = (cols + kThreads - 1) / kThreads;
  if (blocks_x > kMaxBlocksX) blocks_x = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(rows));
  quantdequant_int8_kernel<<<grid, kThreads, 0, stream>>>(x, scale, out, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fedtpu_quantdequant_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
