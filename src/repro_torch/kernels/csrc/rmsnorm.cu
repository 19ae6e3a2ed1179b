// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel _rmsnorm_kernel (src/repro/kernels/rmsnorm.py:19,
// launched by rmsnorm_pallas): y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in f32 and stored in x's dtype.  Note the scale is (1 + w).
//
// Bound on the H100: memory.  Per element it does ~4 flops against 8 bytes
// (f32 read + write), far below the card's ~20 flop/byte f32 balance, so the
// least time is one read and one write of x over the 3.35 TB/s of HBM.
//
// Design: one block of 128 threads per row.  The TPU kernel kept a block of
// rows resident in VMEM; here a row (D <= a few thousand) is spread over
// the block's threads, each thread strides over it accumulating its sum of
// squares in f32, and warp shuffles plus a 4-entry shared array reduce it.
// The second pass re-reads the row, which the first pass just brought into
// L1, so HBM sees x once.  Any row count and any D work (no divisor clamp).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int64_t D, int64_t x_row_stride,
               int64_t y_row_stride, float eps) {
  const T* xr = x + (int64_t)blockIdx.x * x_row_stride;
  T* yr = y + (int64_t)blockIdx.x * y_row_stride;

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += part[i];
  const float r = rsqrtf(total / (float)D + eps);

  for (int64_t i = threadIdx.x; i < D; i += kThreads)
    yr[i] = from_f<T>(to_f(xr[i]) * r * (1.f + w[i]));
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int64_t D, int64_t xs, int64_t ys, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), D, xs, ys, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: rows of D elements (row strides xs, ys; unit stride inside a row);
// w: D floats.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm(const void* x, const void* w, void* y, int64_t rows,
                       int64_t D, int64_t xs, int64_t ys, float eps,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(x, w, y, rows, D, xs, ys, eps, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(x, w, y, rows, D, xs, ys, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
