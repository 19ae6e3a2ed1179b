// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:29, launched by
// flash_attention_pallas): online softmax (m, l, acc in f32) over KV tiles,
// causal mask aligned to the end of the KV sequence (query i sits at
// absolute position (Skv - Sq) + i), masked scores -1e30, scale 1/sqrt(d),
// output acc / max(l, 1e-30) in q's dtype.  KV head of query head h is
// h / (H / KVH).
//
// Bound on the H100: at the serving path's prefill (one prompt of <= 32
// tokens, head_dim 64) it is a few hundred kilobytes of q/k/v/o and well
// under a megaflop per head, so the least time is the bytes over HBM
// bandwidth and the kernel is bound by launch and latency; at long
// prompts it turns compute-bound (4*d flops per (query, key) pair).
//
// Design: one block per (b, h, 64-query tile), one thread per query row.
// The TPU walked the KV tiles as a sequential grid axis carrying m, l and
// acc in VMEM scratch; here a loop inside the block walks them, and each
// thread keeps its row's q, acc (d floats each), m and l in registers.
// Each KV tile is staged in shared memory as f32 by the whole block (loads
// coalesced along d), then every thread reads the same key -> shared-memory
// broadcast.  A tile's scores go to a per-thread row of shared memory so
// the max and the rescale happen once per tile, not once per key.  Tiles
// wholly above the causal diagonal of the block are never loaded; inside a
// tile each row stops at its own diagonal (exp(-1e30 - m) is exactly 0 in
// f32, so this equals masking).  Ragged Sq/Skv edges are masked, so any
// length works.  head_dim is a template parameter (8, 16, 32, 64, 128).
// Using tensor cores (mma/wgmma on Q.K^T and P.V) is later work.

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block = threads per block

template <int D>
struct KvTile {
  // K and V tiles (f32) plus the score rows must fit the 48 KB of static
  // shared memory: 2*BK*D*4 + BQ*(BK+1)*4 bytes.
  static constexpr int BK = D >= 64 ? 32 : 64;
};

template <typename T, int D>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int G,
                 int64_t Sq, int64_t Skv, int64_t qsb, int64_t qss,
                 int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                 int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
                 int64_t oss, int64_t osh, float scale, int causal) {
  constexpr int BK = KvTile<D>::BK;
  __shared__ float Ks[BK][D];
  __shared__ float Vs[BK][D];
  __shared__ float Ss[BQ][BK + 1];

  const int b = blockIdx.z, h = blockIdx.y, kvh = h / G;
  const int64_t q0 = (int64_t)blockIdx.x * BQ;
  const int64_t i = q0 + threadIdx.x;  // this thread's query row
  const bool active = i < Sq;
  const int64_t qpos = (Skv - Sq) + i;

  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f(q[b * qsb + i * qss + h * qsh + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  // keys past the last query row's diagonal are never needed by this block
  int64_t kv_end = Skv;
  if (causal) {
    const int64_t last = (Skv - Sq) + (q0 + BQ < Sq ? q0 + BQ : Sq);
    kv_end = last < Skv ? last : Skv;
  }

  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    const int n = (int)(kv_end - k0 < BK ? kv_end - k0 : BK);
    for (int idx = threadIdx.x; idx < n * D; idx += BQ) {
      const int j = idx / D, d = idx % D;
      Ks[j][d] = to_f(kb[(k0 + j) * kss + d]);
      Vs[j][d] = to_f(vb[(k0 + j) * vss + d]);
    }
    __syncthreads();
    if (active) {
      int64_t jn = n;
      if (causal && qpos - k0 + 1 < jn) jn = qpos - k0 + 1;
      float tile_m = -1e30f;
      for (int j = 0; j < jn; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], Ks[j][d], s);
        s *= scale;
        Ss[threadIdx.x][j] = s;
        tile_m = fmaxf(tile_m, s);
      }
      if (jn > 0) {
        const float m_new = fmaxf(m, tile_m);
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        for (int j = 0; j < jn; ++j) {
          const float p = expf(Ss[threadIdx.x][j] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * osb + i * oss + h * osh;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = from_f<T>(acc[d] * inv);
  }
}

struct Strides {  // (b, s, h) strides of q, k, v and o, in elements
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
};

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Skv,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, D><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)H, (int)(H / KVH),
      Sq, Skv, st.qsb, st.qss, st.qsh, st.ksb, st.kss, st.ksh, st.vsb,
      st.vss, st.vsh, st.osb, st.oss, st.osh, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int64_t B, int64_t H, int64_t KVH, int64_t Sq,
                       int64_t Skv, int64_t D, const Strides& st, float scale,
                       int causal, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, H, KVH, Sq, Skv, st, scale, causal, s);
    case 16: return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Skv, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Skv, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Skv, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/o: (B, Sq, H, D), k/v: (B, Skv, KVH, D), each with its own (b, s, h)
// strides and unit stride along D; o in q's dtype.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t H, int64_t KVH, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, float scale, int causal, int dtype, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(q, k, v, o, B, H, KVH, Sq, Skv, D, st, scale,
                               causal, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Skv, D, st,
                                       scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
