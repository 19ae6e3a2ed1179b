// RMSNorm backward for Hopper (sm_90a).
//
// Replaces: the gradient of the Pallas kernel _rmsnorm_kernel
// (src/repro/kernels/rmsnorm.py:19), which has no backward of its own: JAX
// differentiates the plain layer (src/repro/models/layers.py:28 rms_norm).
// For y = x r (1 + w), r = rsqrt(mean(x^2) + eps), and output gradient dy:
//   dx = r (1 + w) dy - x r^3 / D sum_row(dy (1 + w) x)
//   dw = sum_rows dy x r
// in f32, stored in x's and w's dtypes.
//
// Bound on the H100: ~10 flops per element against reading x and dy and
// writing dx (12 bytes in f32), far below the card's f32 balance, so the
// least time is those bytes over HBM bandwidth.  At the tuning loop's
// shapes (64 rows of 576) it is a few hundred nanoseconds and the time is
// the launches.
//
// Design: three kernels behind one C entry, no atomics, so the same inputs
// give the same bits on every call.
//   1. dx: a warp per row (grid-stride over rows), element loads along the
//      row (neighbouring lanes on neighbouring columns, any D, alignment or
//      row stride).  One pass sums x^2 and dy (1 + w) x together (two
//      shuffle butterflies), a second pass writes dx; it also writes r per
//      row for step 2.
//   2. dw partials: a thread per column and a block row per chunk of rows
//      (the plan picks the chunks so the grid fills the card); each thread
//      sums dy x r down its column's chunk in row order into an f32 partial.
//   3. dw: a thread per column sums the chunks' partials in chunk order.
// A simple first version: it reads x and dy twice (steps 1 and 2).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ rstd, int64_t rows, int64_t D,
                      int64_t xs, int64_t dys, float inv_d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       row < rows; row += warps) {
    const T* xr = x + row * xs;
    const T* gr = dy + row * dys;
    float ss = 0.f, s = 0.f;
    for (int64_t c = lane; c < D; c += 32) {
      const float xv = to_f(xr[c]);
      ss = fmaf(xv, xv, ss);
      s = fmaf(to_f(gr[c]) * (1.f + to_f(w[c])), xv, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float k = r * r * r * inv_d * s;
    T* out = dx + row * D;
    for (int64_t c = lane; c < D; c += 32)
      out[c] = from_f<T>(r * (1.f + to_f(w[c])) * to_f(gr[c]) -
                         to_f(xr[c]) * k);
    if (lane == 0) rstd[row] = r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              const float* __restrict__ rstd,
                              float* __restrict__ part, int64_t rows,
                              int64_t D, int64_t xs, int64_t dys,
                              int64_t chunk) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float acc = 0.f;
  for (int64_t row = r0; row < r1; ++row)
    acc = fmaf(to_f(dy[row * dys + c]) * to_f(x[row * xs + c]), rstd[row],
               acc);
  part[(int64_t)blockIdx.y * D + c] = acc;
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw_final_kernel(const float* __restrict__ part,
                            W* __restrict__ dw, int64_t D, int nchunks) {
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int i = 0; i < nchunks; ++i) acc += part[(int64_t)i * D + c];
  dw[c] = from_f<W>(acc);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, float* rstd, float* part, int64_t rows,
                   int64_t D, int64_t xs, int64_t dys, int64_t nchunks,
                   int64_t chunk, int64_t grid_dx, float eps,
                   cudaStream_t s) {
  const int64_t col_blocks = (D + kThreads - 1) / kThreads;
  rmsnorm_bwd_dx_kernel<T, W><<<(unsigned)grid_dx, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), rstd, rows, D, xs, dys,
      1.f / (float)D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_partial_kernel<T>
      <<<dim3((unsigned)col_blocks, (unsigned)nchunks), kThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), rstd, part,
          rows, D, xs, dys, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_final_kernel<W><<<(unsigned)col_blocks, kThreads, 0, s>>>(
      part, static_cast<W*>(dw), D, (int)nchunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w,
                       const void* dy, void* dx, void* dw, float* rstd,
                       float* part, int64_t rows, int64_t D, int64_t xs,
                       int64_t dys, int64_t nchunks, int64_t chunk,
                       int64_t grid_dx, float eps, cudaStream_t s) {
  switch (w_dtype) {
    case kFloat32:
      return launch<T, float>(x, w, dy, dx, dw, rstd, part, rows, D, xs, dys,
                              nchunks, chunk, grid_dx, eps, s);
    case kBFloat16:
      return launch<T, __nv_bfloat16>(x, w, dy, dx, dw, rstd, part, rows, D,
                                      xs, dys, nchunks, chunk, grid_dx, eps,
                                      s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy: (rows, D) with row strides xs, dys and unit stride along D, one
// dtype; w: (D,) contiguous in its own dtype; dx: (rows, D) contiguous in
// x's dtype; dw: (D,) in w's dtype.  Scratch from the wrapper: rstd (rows
// f32) and part (nchunks * D f32).  The plan (kernels/rmsnorm.py
// plan_rmsnorm_bwd): nchunks chunks of `chunk` rows for dw, grid_dx blocks
// of 8 warps for dx.  Returns cudaGetLastError() after the launches.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* rstd, void* part,
                           int64_t rows, int64_t D, int64_t xs, int64_t dys,
                           int64_t nchunks, int64_t chunk, int64_t grid_dx,
                           int dtype, int w_dtype, float eps, void* stream) {
  if (rows < 1 || D < 1 || nchunks < 1 || chunk < 1 ||
      nchunks * chunk < rows || (nchunks - 1) * chunk >= rows ||
      nchunks >= 65536 || grid_dx < 1 || grid_dx >= (1LL << 31) ||
      (D + kThreads - 1) / kThreads >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  float* p = static_cast<float*>(part);
  switch (dtype) {
    case kFloat32:
      return dispatch_w<float>(w_dtype, x, w, dy, dx, dw, r, p, rows, D, xs,
                               dys, nchunks, chunk, grid_dx, eps, s);
    case kBFloat16:
      return dispatch_w<__nv_bfloat16>(w_dtype, x, w, dy, dx, dw, r, p, rows,
                                       D, xs, dys, nchunks, chunk, grid_dx,
                                       eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
