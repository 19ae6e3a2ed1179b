// RMSNorm backward for Hopper (sm_90a): one launch, x and dy read once, dw
// partials taken from the dx pass.
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
// the launch and the dependent trips to memory.
//
// Design: one kernel does the whole function.  A block walks its rows
// grid-stride, holds each row of x and dy in registers (16-byte loads, the
// variants and thresholds of the forward kernel in rmsnorm.cu), sums x^2
// and dy (1 + w) x in one pass and one pair of reductions, writes dx from
// the registers, and adds dy x r into the dw columns it owns.  Those column
// partials stay in registers across the rows, so dw costs no second read of
// x or dy.  Each block writes its f32 dw partial to its row of a workspace;
// the partials are then summed in a fixed order inside the same launch:
//   - the blocks are cut into groups of `group` consecutive blocks; each
//     takes a ticket on its group's counter (__threadfence, then atomicAdd
//     on an int), and the last block of a group to arrive sums the group's
//     rows in block order into the group's first row;
//   - those blocks take a ticket on one more counter, and the last sums the
//     groups' rows in group order into dw (with one group, the group's last
//     block writes dw directly).
// Every counter is set back to zero by the block that drew its last ticket,
// so the wrapper zeroes them once.  No float atomics: the same inputs give
// the same bits on every call.  Two levels keep the sum short at both ends:
// at 64 rows the grid is a few blocks and one level; at 8192 rows of 4096
// the last blocks read ~16 rows each instead of one block reading hundreds.
// The partials are read with __ldcg (L2, not L1): other SMs wrote them.
// Three variants, chosen by the wrapper's plan (kernels/rmsnorm.py
// plan_rmsnorm_bwd), as for the forward:
//   - warp:   a warp per row (D <= 1024 f32 / 2048 bf16), lane l holding
//             the 16-byte vectors l, l+32, ... of x, dy and w; the block's
//             warps sum their column partials through shared memory in
//             warp order before the block writes its workspace row;
//   - block:  128-512 threads per row, NV vectors a thread; each thread's
//             columns are fixed, so its partial goes straight to the
//             workspace;
//   - scalar: element loads, for pointers, row strides or D that are not
//             16-byte aligned: two passes over the row (the second finds x
//             and dy in L1/L2), the block's partial kept in its workspace
//             row.

#include "rowpack.cuh"

namespace {

constexpr int kMaxNV = 8;          // 16-byte vectors a thread holds
constexpr int kMaxThreads = 512;   // block and scalar variants
constexpr int kMaxRowsPerBlock = 8;
constexpr int kWarpRedFloats = 8192;  // warp variant: rows a block x D
enum Variant : int { kWarp = 0, kBlock = 1, kScalar = 2 };

struct BwdShape {
  int64_t rows, D, xs, dys, dxs;  // rows of D; row strides of x, dy, dx
  float inv_d, eps;
};

// -- summing the partials -----------------------------------------------------

// True in the block that takes the last of `arrivals` tickets on *counter;
// that block returns the counter to zero.  Writes before the call are
// visible to the last block after it.
__device__ __forceinline__ bool last_arrival(int* counter, int arrivals) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == arrivals - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  const bool mine = last;
  if (mine) __threadfence();
  return mine;
}

// out[c] = sum over i < n, in order, of row first + i * step of ws (rows of
// D floats), for every column c.  out may be row `first` itself: each thread
// reads its columns before it writes them.
template <typename Out>
__device__ void sum_rows(const float* ws, int64_t D, int64_t first,
                         int64_t step, int n, Out* out) {
  if (D % 4 == 0) {
    const int64_t d4 = D / 4;
    const float4* base = reinterpret_cast<const float4*>(ws);
    for (int64_t q = threadIdx.x; q < d4; q += blockDim.x) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8  // independent loads in flight; the sum keeps row order
      for (int i = 0; i < n; ++i) {
        const float4 v = __ldcg(base + (first + i * step) * d4 + q);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      out[4 * q] = from_f<Out>(s.x);
      out[4 * q + 1] = from_f<Out>(s.y);
      out[4 * q + 2] = from_f<Out>(s.z);
      out[4 * q + 3] = from_f<Out>(s.w);
    }
  } else {
    for (int64_t c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
#pragma unroll 8
      for (int i = 0; i < n; ++i) s += __ldcg(ws + (first + i * step) * D + c);
      out[c] = from_f<Out>(s);
    }
  }
}

// Every block calls this after writing its partial to workspace row
// blockIdx.x; the last arrivals sum the rows into dw (see the header).
template <typename W>
__device__ __forceinline__ void finish(float* ws, int* cnt, W* dw,
                                       int64_t D, int group) {
  const int nb = gridDim.x, groups = (nb + group - 1) / group;
  const int g = blockIdx.x / group, first = g * group;
  const int n = min(group, nb - first);
  if (!last_arrival(cnt + g, n)) return;
  if (groups == 1) {
    sum_rows(ws, D, 0, 1, n, dw);
    return;
  }
  sum_rows(ws, D, first, 1, n, ws + (int64_t)first * D);
  if (!last_arrival(cnt + groups, groups)) return;
  sum_rows(ws, D, 0, group, groups, dw);
}

// -- one row in registers -------------------------------------------------------

// This thread's share of the row's two sums: x^2 and dy (1 + w) x.
template <typename T, typename W, int V, int NV>
__device__ __forceinline__ float2 row_sums(const Pack<T, V> (&xv)[NV],
                                           const Pack<T, V> (&gv)[NV],
                                           const Pack<W, V> (&wv)[NV],
                                           int first, int stride, int nvec) {
  float ss = 0.f, sg = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (first + stride * i < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xf = elem(xv[i], k);
        ss = fmaf(xf, xf, ss);
        sg = fmaf(elem(gv[i], k) * (1.f + elem(wv[i], k)), xf, sg);
      }
    }
  }
  return make_float2(ss, sg);
}

// dx of the row from the registers, and acc += dy x r on this thread's
// columns.  sums: the row's (x^2, dy (1 + w) x).
template <typename T, typename W, int V, int NV>
__device__ __forceinline__ void row_grads(T* dxr, const Pack<T, V> (&xv)[NV],
                                          const Pack<T, V> (&gv)[NV],
                                          const Pack<W, V> (&wv)[NV],
                                          float2 sums, const BwdShape& s,
                                          float (&acc)[NV][V], int first,
                                          int stride, int nvec) {
  const float r = rsqrtf(sums.x * s.inv_d + s.eps);
  const float c = r * r * r * s.inv_d * sums.y;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = first + stride * i;
    if (j < nvec) {
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xf = elem(xv[i], k), g = elem(gv[i], k);
        o[k] = r * (1.f + elem(wv[i], k)) * g - xf * c;
        acc[i][k] = fmaf(g * xf, r, acc[i][k]);
      }
      store16(dxr + (int64_t)j * V, o);
    }
  }
}

// V floats (V a multiple of 4) to p, 16-byte aligned.
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// Sum of (a, b) over the block; part holds a slot per warp, one of two
// buffers used in turn, so one barrier a row suffices.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* part) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  const int warps = blockDim.x >> 5;
  for (int i = 0; i < warps; ++i) {
    t.x += part[i].x;
    t.y += part[i].y;
  }
  return t;
}

// -- variant warp: one warp per row ------------------------------------------

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(32 * kMaxRowsPerBlock, 1)
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const W* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        W* __restrict__ dw, float* __restrict__ ws,
                        int* __restrict__ cnt, BwdShape s, int group) {
  constexpr int V = Vec<T>::N;
  __shared__ __align__(16) float red[kWarpRedFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nvec = (int)(s.D / V);
  Pack<W, V> wv[NV];
  load_slice(wv, w, lane, 32, nvec);
  float acc[NV][V] = {};
  for (int64_t row = (int64_t)blockIdx.x * warps + warp; row < s.rows;
       row += (int64_t)gridDim.x * warps) {
    Pack<T, V> xv[NV], gv[NV];
    load_slice(xv, x + row * s.xs, lane, 32, nvec);
    load_slice(gv, dy + row * s.dys, lane, 32, nvec);
    float2 sums = row_sums(xv, gv, wv, lane, 32, nvec);
    sums.x = warp_sum(sums.x);
    sums.y = warp_sum(sums.y);
    row_grads(dx + row * s.dxs, xv, gv, wv, sums, s, acc, lane, 32, nvec);
  }
  // the warps' column partials, summed in warp order
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) store_f32(red + warp * s.D + (int64_t)j * V, acc[i]);
  }
  __syncthreads();
  const float4* r4 = reinterpret_cast<const float4*>(red);
  float4* part = reinterpret_cast<float4*>(ws + blockIdx.x * s.D);
  const int d4 = (int)(s.D / 4);
  for (int q = threadIdx.x; q < d4; q += blockDim.x) {
    float4 t = r4[q];
    for (int k = 1; k < warps; ++k) {
      const float4 u = r4[k * d4 + q];
      t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
    }
    part[q] = t;
  }
  finish(ws, cnt, dw, s.D, group);
}

// -- variant block: one block of 128-512 threads per row ---------------------

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         W* __restrict__ dw, float* __restrict__ ws,
                         int* __restrict__ cnt, BwdShape s, int group) {
  constexpr int V = Vec<T>::N;
  __shared__ float2 part[2][kMaxThreads / 32];
  const int t = threadIdx.x, nt = blockDim.x;
  const int nvec = (int)(s.D / V);
  Pack<W, V> wv[NV];
  load_slice(wv, w, t, nt, nvec);
  float acc[NV][V] = {};
  int buf = 0;
  for (int64_t row = blockIdx.x; row < s.rows; row += gridDim.x) {
    Pack<T, V> xv[NV], gv[NV];
    load_slice(xv, x + row * s.xs, t, nt, nvec);
    load_slice(gv, dy + row * s.dys, t, nt, nvec);
    const float2 sums = block_sum2(row_sums(xv, gv, wv, t, nt, nvec),
                                   part[buf]);
    buf ^= 1;
    row_grads(dx + row * s.dxs, xv, gv, wv, sums, s, acc, t, nt, nvec);
  }
  float* mine = ws + blockIdx.x * s.D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + nt * i;
    if (j < nvec) store_f32(mine + (int64_t)j * V, acc[i]);
  }
  finish(ws, cnt, dw, s.D, group);
}

// -- variant scalar: element loads, two passes over the row ------------------

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          W* __restrict__ dw, float* __restrict__ ws,
                          int* __restrict__ cnt, BwdShape s, int group) {
  __shared__ float2 part[2][kMaxThreads / 32];
  float* mine = ws + blockIdx.x * s.D;   // this block's columns, in place
  for (int64_t c = threadIdx.x; c < s.D; c += blockDim.x) mine[c] = 0.f;
  int buf = 0;
  for (int64_t row = blockIdx.x; row < s.rows; row += gridDim.x) {
    const T* xr = x + row * s.xs;
    const T* gr = dy + row * s.dys;
    float2 sums = make_float2(0.f, 0.f);
    for (int64_t c = threadIdx.x; c < s.D; c += blockDim.x) {
      const float xf = to_f(xr[c]);
      sums.x = fmaf(xf, xf, sums.x);
      sums.y = fmaf(to_f(gr[c]) * (1.f + to_f(w[c])), xf, sums.y);
    }
    sums = block_sum2(sums, part[buf]);
    buf ^= 1;
    const float r = rsqrtf(sums.x * s.inv_d + s.eps);
    const float k = r * r * r * s.inv_d * sums.y;
    T* out = dx + row * s.dxs;
    for (int64_t c = threadIdx.x; c < s.D; c += blockDim.x) {
      const float xf = to_f(xr[c]), g = to_f(gr[c]);
      out[c] = from_f<T>(r * (1.f + to_f(w[c])) * g - xf * k);
      mine[c] = fmaf(g * xf, r, mine[c]);
    }
  }
  finish(ws, cnt, dw, s.D, group);
}

// -- the launch ----------------------------------------------------------------

template <typename T, typename W>
using KernelFn = void (*)(const T*, const W*, const T*, T*, W*, float*, int*,
                          BwdShape, int);

template <typename T, typename W, int NV = 1>
KernelFn<T, W> pick(int variant, int nv) {
  if constexpr (NV > kMaxNV) {
    return nullptr;
  } else {
    if (nv != NV) return pick<T, W, NV + 1>(variant, nv);
    if (variant == kWarp) return rmsnorm_bwd_warp_kernel<T, W, NV>;
    return rmsnorm_bwd_block_kernel<T, W, NV>;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The plan's variant and geometry, checked against what the kernels derive
// from the shape; nullptr where they differ.
template <typename T, typename W>
KernelFn<T, W> checked(const void* x, const void* w, const void* dy,
                       const void* dx, const BwdShape& s, const int64_t* p) {
  constexpr int V = Vec<T>::N;
  const int variant = (int)p[7];
  const int64_t nv = p[8], threads = p[9], rows_per_block = p[10],
                blocks = p[11], group = p[12];
  if (s.rows < 1 || s.D < 1 || blocks < 1 || blocks >= (int64_t{1} << 31) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      group < 1 || group > blocks)
    return nullptr;
  if (variant == kScalar) {
    if (nv != 0 || rows_per_block != 1) return nullptr;
    return rmsnorm_bwd_scalar_kernel<T, W>;
  }
  if (variant != kWarp && variant != kBlock) return nullptr;
  const bool vec_ok = s.D % V == 0 && s.xs % V == 0 && s.dys % V == 0 &&
                      s.dxs % V == 0 && aligned16(x) && aligned16(w) &&
                      aligned16(dy) && aligned16(dx);
  const int64_t per_row = variant == kWarp ? 32 : threads;
  const int64_t rpb = variant == kWarp ? threads / 32 : 1;
  if (!vec_ok || rows_per_block != rpb || rpb > kMaxRowsPerBlock ||
      (variant == kWarp && rpb * s.D > kWarpRedFloats) ||
      nv != cdiv(s.D / V, per_row) || nv < 1 || nv > kMaxNV)
    return nullptr;
  return pick<T, W>(variant, (int)nv);
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const void* dy, void* dx,
                   void* dw, float* ws, int* cnt, const int64_t* p, float eps,
                   cudaStream_t stream) {
  const BwdShape s{p[0], p[1], p[2], p[3], p[4], 1.f / (float)p[1], eps};
  KernelFn<T, W> fn = checked<T, W>(x, w, dy, dx, s, p);
  if (fn == nullptr) return cudaErrorInvalidValue;
  fn<<<(unsigned)p[11], (unsigned)p[9], 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<W*>(dw),
      ws, cnt, s, (int)p[12]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_w(const void* x, const void* w, const void* dy, void* dx,
                     void* dw, float* ws, int* cnt, const int64_t* p,
                     float eps, cudaStream_t stream) {
  switch ((int)p[6]) {
    case kFloat32:
      return launch<T, float>(x, w, dy, dx, dw, ws, cnt, p, eps, stream);
    case kBFloat16:
      return launch<T, __nv_bfloat16>(x, w, dy, dx, dw, ws, cnt, p, eps,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy: rows of D elements (row strides p[2], p[3], unit stride inside a
// row), one dtype; w: D elements in its own dtype; dx: rows of D in x's
// dtype (row stride p[4]); dw: D elements in w's dtype.  ws: the wrapper's
// f32 workspace, p[11] rows of D; cnt: a zeroed int per group of p[12]
// blocks, and one more where there are two or more groups (the kernel
// leaves them zero).  p holds the wrapper's plan, fixed per
// shape and cached there:
//   p[0..4]  rows, D, x, dy and dx row strides
//   p[5..6]  dtype of x, dy and dx; dtype of w and dw (DType)
//   p[7]     variant: 0 warp, 1 block, 2 scalar
//   p[8]     16-byte vectors of x a thread holds (0 for scalar)
//   p[9]     threads per block
//   p[10]    rows per block (warps per block for the warp variant, else 1)
//   p[11]    blocks (each walks rows with a grid-stride loop)
//   p[12]    blocks per group of the two-level sum of the partials
// A plan whose variant cannot take these pointers, strides or D, or whose
// geometry differs from what the kernel derives, fails with
// cudaErrorInvalidValue before anything is launched.  Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* dw, void* ws, void* cnt,
                           const int64_t* p, float eps, void* stream) {
  if (ws == nullptr || cnt == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* c = static_cast<int*>(cnt);
  switch ((int)p[5]) {
    case kFloat32:
      return launch_w<float>(x, w, dy, dx, dw, wsf, c, p, eps, s);
    case kBFloat16:
      return launch_w<__nv_bfloat16>(x, w, dy, dx, dw, wsf, c, p, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
