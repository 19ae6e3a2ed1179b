// RMSNorm forward for Hopper (sm_90a): register-resident rows, 16-byte
// loads, one read of x.
//
// Replaces: the Pallas kernel _rmsnorm_kernel (src/repro/kernels/rmsnorm.py:19,
// launched by rmsnorm_pallas): y = x * rsqrt(mean(x^2) + eps) * (1 + w),
// computed in f32 and stored in x's dtype.  Note the scale is (1 + w).
//
// Bound on the H100.  Per element it does ~4 flops against 8 bytes (f32
// read + write), far below the card's ~20 flop/byte f32 balance, so the
// least time is one read of x and w and one write of y over the 3.35 TB/s
// of HBM.  That bound binds only at many rows: a long prompt, or the wide
// configurations (d_model 3072-7168).  At the serving shapes (4-31 rows of
// 576) the bound is tens of nanoseconds, and what costs is the launch and
// the latency of each dependent trip to memory.
//
// Design: the row stays in registers between the sum of squares and the
// scaled store, so HBM sees x once and y once, and a row costs one
// dependent round trip (all loads of x and w issued at once, then the
// reduction, then the stores).  w is the same for every row: each thread
// loads its slice of w once, in w's own dtype, and keeps it across the rows
// it walks.  Three variants, chosen by the wrapper's plan
// (kernels/rmsnorm.py plan_rmsnorm):
//   - warp:   a warp per row (D <= 1024 f32 / 2048 bf16).  Lane l holds the
//             16-byte vectors l, l+32, ... (NV of them, a template
//             parameter, so the arrays stay in registers; a ragged last
//             vector is masked, not padded).  A 5-step __shfl_xor_sync
//             butterfly reduces the row: no shared memory, no barrier.  A
//             block of 4-8 warps carries 4-8 rows, so decode's 4 rows are
//             one block and a long prompt's rows fill the 132 SMs.
//   - block:  a block of 128-512 threads per row (wider rows, up to 16384
//             f32 / 32768 bf16), NV vectors a thread: one butterfly per
//             warp, then one shared-memory exchange of the warps' partial
//             sums (double-buffered, so one barrier a row).
//   - scalar: element loads, for pointers, row strides or D that are not
//             16-byte aligned, and for D beyond the block variant's
//             registers: a block strides over the row twice (the second
//             pass finds x in L1/L2).
// Every variant walks rows with a grid-stride loop, so the plan's grid can
// stop at what the SMs hold.  Sums run in a fixed order: the same inputs
// give the same bits on every call.  The launch bounds name one block per
// SM as the least, so that ptxas does not trade spills for occupancy (with
// the thread count alone it squeezed a block variant to 64 registers and
// spilled), and the kernels divide by nothing (1/D comes from the host: the
// slow path of a float division is a call, which spilled registers too).

#include "rowpack.cuh"

namespace {

constexpr int kMaxNV = 8;         // 16-byte vectors of x a thread holds
constexpr int kMaxThreads = 512;  // block and scalar variants
constexpr int kMaxRowsPerBlock = 8;
enum Variant : int { kWarp = 0, kBlock = 1, kScalar = 2 };

struct RowShape {
  int64_t rows, D, xs, ys;  // rows of D elements; row strides of x and y
  float inv_d, eps;
};

__device__ __forceinline__ float inv_rms(float ss, const RowShape& s) {
  return rsqrtf(ss * s.inv_d + s.eps);
}

template <typename T, int V, int NV>
__device__ __forceinline__ float sum_squares(const Pack<T, V> (&xv)[NV],
                                             int first, int stride,
                                             int nvec) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (first + stride * i < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = elem(xv[i], k);
        ss = fmaf(v, v, ss);
      }
    }
  }
  return ss;
}

template <typename T, typename W, int V, int NV>
__device__ __forceinline__ void scale_store(T* yr,
                                            const Pack<T, V> (&xv)[NV],
                                            const Pack<W, V> (&wv)[NV],
                                            float r, int first, int stride,
                                            int nvec) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = first + stride * i;
    if (j < nvec) {
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = elem(xv[i], k) * r * (1.f + elem(wv[i], k));
      store16(yr + (int64_t)j * V, o);
    }
  }
}

// -- variant warp: one warp per row ------------------------------------------

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(32 * kMaxRowsPerBlock, 1)
rmsnorm_warp_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ y, RowShape s) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int nvec = (int)(s.D / V);
  Pack<W, V> wv[NV];
  load_slice(wv, w, lane, 32, nvec);
  const int64_t warps = blockDim.x >> 5;
  for (int64_t row = blockIdx.x * warps + (threadIdx.x >> 5); row < s.rows;
       row += gridDim.x * warps) {
    Pack<T, V> xv[NV];
    load_slice(xv, x + row * s.xs, lane, 32, nvec);
    const float ss = warp_sum(sum_squares(xv, lane, 32, nvec));
    const float r = inv_rms(ss, s);
    scale_store(y + row * s.ys, xv, wv, r, lane, 32, nvec);
  }
}

// -- variant block: one block of 128-512 threads per row ---------------------

// Sum of v over the block; part holds two slots of 16 partial sums, used in
// turn (buf), so one barrier a row suffices.
__device__ __forceinline__ float block_sum(float v, float (*part)[16],
                                           int buf) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) total += part[buf][i];
  return total;
}

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_block_kernel(const T* __restrict__ x, const W* __restrict__ w,
                     T* __restrict__ y, RowShape s) {
  constexpr int V = Vec<T>::N;
  __shared__ float part[2][16];
  const int t = threadIdx.x, nt = blockDim.x;
  const int nvec = (int)(s.D / V);
  Pack<W, V> wv[NV];
  load_slice(wv, w, t, nt, nvec);
  int buf = 0;
  for (int64_t row = blockIdx.x; row < s.rows; row += gridDim.x) {
    Pack<T, V> xv[NV];
    load_slice(xv, x + row * s.xs, t, nt, nvec);
    const float ss = block_sum(sum_squares(xv, t, nt, nvec), part, buf);
    buf ^= 1;
    const float r = inv_rms(ss, s);
    scale_store(y + row * s.ys, xv, wv, r, t, nt, nvec);
  }
}

// -- variant scalar: element loads, two passes over the row ------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      T* __restrict__ y, RowShape s) {
  __shared__ float part[2][16];
  int buf = 0;
  for (int64_t row = blockIdx.x; row < s.rows; row += gridDim.x) {
    const T* xr = x + row * s.xs;
    float ss = 0.f;
    for (int64_t i = threadIdx.x; i < s.D; i += blockDim.x) {
      const float v = to_f(xr[i]);
      ss = fmaf(v, v, ss);
    }
    ss = block_sum(ss, part, buf);
    buf ^= 1;
    const float r = inv_rms(ss, s);
    T* yr = y + row * s.ys;
    for (int64_t i = threadIdx.x; i < s.D; i += blockDim.x)
      yr[i] = from_f<T>(to_f(xr[i]) * r * (1.f + to_f(w[i])));
  }
}

// -- the launch ----------------------------------------------------------------

template <typename T, typename W>
using KernelFn = void (*)(const T*, const W*, T*, RowShape);

template <typename T, typename W, int NV = 1>
KernelFn<T, W> pick(int variant, int nv) {
  if constexpr (NV > kMaxNV) {
    return nullptr;
  } else {
    if (nv != NV) return pick<T, W, NV + 1>(variant, nv);
    if (variant == kWarp) return rmsnorm_warp_kernel<T, W, NV>;
    return rmsnorm_block_kernel<T, W, NV>;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The plan's variant and geometry, checked against what the kernels derive
// from the shape; nullptr where they differ.
template <typename T, typename W>
KernelFn<T, W> checked(const void* x, const void* w, const void* y,
                       const RowShape& s, int variant, int64_t nv,
                       int64_t threads, int64_t rows_per_block,
                       int64_t blocks) {
  constexpr int V = Vec<T>::N;
  if (s.rows < 1 || s.D < 1 || blocks < 1 || blocks >= (int64_t{1} << 31) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return nullptr;
  if (variant == kScalar) {
    if (nv != 0 || rows_per_block != 1) return nullptr;
    return rmsnorm_scalar_kernel<T, W>;
  }
  if (variant != kWarp && variant != kBlock) return nullptr;
  const bool vec_ok = s.D % V == 0 && s.xs % V == 0 && s.ys % V == 0 &&
                      aligned16(x) && aligned16(w) && aligned16(y);
  const int64_t per_row = variant == kWarp ? 32 : threads;
  const int64_t rpb = variant == kWarp ? threads / 32 : 1;
  if (!vec_ok || rows_per_block != rpb || rpb > kMaxRowsPerBlock ||
      nv != cdiv(s.D / V, per_row) || nv < 1 || nv > kMaxNV)
    return nullptr;
  return pick<T, W>(variant, (int)nv);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, const int64_t* p,
                   float eps, cudaStream_t stream) {
  const RowShape s{p[0], p[1], p[2], p[3], 1.f / (float)p[1], eps};
  KernelFn<T, W> fn = checked<T, W>(x, w, y, s, (int)p[6], p[7], p[8],
                                    p[9], p[10]);
  if (fn == nullptr) return cudaErrorInvalidValue;
  fn<<<(unsigned)p[10], (unsigned)p[8], 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w, void* y, const int64_t* p,
                     float eps, cudaStream_t stream) {
  switch ((int)p[5]) {
    case kFloat32: return launch<T, float>(x, w, y, p, eps, stream);
    case kBFloat16: return launch<T, __nv_bfloat16>(x, w, y, p, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: rows of D elements (row stride p[2], unit stride inside a row); w: D
// elements in its own dtype; y: rows of D in x's dtype (row stride p[3]).
// p holds the wrapper's plan, fixed per shape and cached there, so that a
// call passes 6 arguments:
//   p[0..3]  rows, D, x row stride, y row stride
//   p[4..5]  dtype of x and y, dtype of w (DType)
//   p[6]     variant: 0 warp, 1 block, 2 scalar
//   p[7]     16-byte vectors of x a thread holds (0 for scalar)
//   p[8]     threads per block
//   p[9]     rows per block (warps per block for the warp variant, else 1)
//   p[10]    blocks (each walks rows with a grid-stride loop)
// A plan whose variant cannot take these pointers, strides or D, or whose
// vectors a thread differ from what the kernel derives, fails with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm(const void* x, const void* w, void* y,
                       const int64_t* p, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((int)p[4]) {
    case kFloat32: return launch_w<float>(x, w, y, p, eps, s);
    case kBFloat16: return launch_w<__nv_bfloat16>(x, w, y, p, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
