// Causal GQA flash attention backward for Hopper (sm_90a), f32.
//
// Replaces: the gradient of the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:29), which has no backward of its
// own: JAX differentiates the plain layer (src/repro/models/layers.py:63
// chunked_attention).  Inputs: q (B, Sq, H, d), k/v (B, Skv, KVH, d), the
// forward's output o and its per-row log-sum-exp lse (B, H, Sq; written by
// csrc/flash_attention.cu), and the output gradient dO.  With
// S = q k^T / sqrt(d) masked causally (query i at absolute position
// Skv - Sq + i), P = exp(S - lse), Dl = rowsum(dO o):
//   dV = P^T dO,  dS = P (dO V^T - Dl),  dQ = dS K / sqrt(d),
//   dK = dS^T Q / sqrt(d),
// with dK and dV summed over the G = H / KVH query heads of each KV head.
//
// Bound on the H100: 5 products of 2 d flops per visible (query, key)
// pair (S recomputed, dP, dV, dK, dQ), against reading q, k, v, o, dO and
// lse once and writing dq, dk, dv once.  At the tuning loop's shapes (S 32)
// the bound is well under a microsecond and the time is the launch and the
// blocks' dependent trips; at long prompts it is compute-bound (f32 on
// FMA, 67 TFLOP/s).
//
// Design (FlashAttention-2's recompute, simple first version on FMA), one
// launch whose grid holds two kinds of block:
//   - dK/dV: one block per (batch, KV head, tile of BK keys), BK the
//     forward's KV tile (the tuning loop's kv_chunk).  The block keeps its
//     K and V tile in shared memory and its dK/dV accumulators in
//     registers, and walks the rows that see its keys: all G query heads
//     of the group, 64 (position, head) rows at a time, so GQA's sum over
//     heads stays inside the block.  Each chunk recomputes S and dP
//     (thread tile 4 rows x BK/16 keys), forms P and dS in shared memory,
//     then adds P^T dO and dS^T Q.
//   - dQ: one block per 64 (position, head) rows of a KV head's group,
//     walking the KV tiles up to its last row's causal limit, recomputing
//     dS the same way and adding dS K.
// Each block loads its rows a warp per row and sums Dl = rowsum(dO o) as
// it loads them (no pass, launch or scratch of its own).  No atomics: each
// output element is summed by one thread in a fixed order, so two runs
// give the same bits.  Element loads along d (any stride, any alignment);
// rows past Sq or Skv are zero-filled and masked.  Scores and sums in f32,
// exp with expf.

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = 8;
constexpr int kRows = 64;  // (position, head) rows per chunk

struct BwdParams {
  const float *q, *k, *v, *o, *dO, *lse;
  float *dq, *dk, *dv;
  int64_t H, G, Sq, Skv;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb,
      gss, gsh;
  float scale;
  int causal;
};

// keys [0, limit) are visible to the query at position i
__device__ __forceinline__ int64_t key_limit(const BwdParams& p, int64_t i) {
  if (!p.causal) return p.Skv;
  const int64_t e = p.Skv - p.Sq + i + 1;
  return e < p.Skv ? e : p.Skv;
}

template <int D, int BK>
struct Smem {
  static constexpr int LD = D + 1;    // odd pitch: column reads spread banks
  static constexpr int LP = BK + 1;
  // Ks, Vs [BK][LD]; Qs, Gs [kRows][LD]; Ps, Ss [kRows][LP]; row data
  static constexpr int kFloats =
      2 * BK * LD + 2 * kRows * LD + 2 * kRows * LP + 2 * kRows;
  static constexpr int kBytes = kFloats * 4 + kRows * 4;
};

// Lanes of a warp over one output row of D values: LPK lanes a row, KSW
// rows a warp, DPL values a lane.
template <int D>
struct RowMap {
  static constexpr int LPK = D < 32 ? D : 32;
  static constexpr int KSW = 32 / LPK;
  static constexpr int DPL = D / LPK;
};

// Load rows [n0, n0 + kRows) of a KV head's (position, head) rows into Qs
// and Gs (q and dO), with their lse, causal key limit and Dl = rowsum(dO o):
// a warp per row, lanes along d.
template <int D>
__device__ void load_rows(const BwdParams& p, int64_t b, int64_t kvh,
                          int64_t n0, int64_t n_end, float* Qs, float* Gs,
                          float* lse_s, float* dl_s, int* lim_s) {
  constexpr int LD = D + 1;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < kRows; r += kWarps) {
    const int64_t n = n0 + r;
    const bool valid = n < n_end;
    const int64_t i = valid ? n / p.G : 0, h = kvh * p.G + n % p.G;
    float dl = 0.f;
    for (int c = lane; c < D; c += 32) {
      float qv = 0.f, gv = 0.f;
      if (valid) {
        qv = p.q[b * p.qsb + i * p.qss + h * p.qsh + c];
        gv = p.dO[b * p.gsb + i * p.gss + h * p.gsh + c];
        dl = fmaf(gv, p.o[b * p.osb + i * p.oss + h * p.osh + c], dl);
      }
      Qs[r * LD + c] = qv;
      Gs[r * LD + c] = gv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
    if (lane == 0) {
      lse_s[r] = valid ? p.lse[(b * p.H + h) * p.Sq + i] : 0.f;
      dl_s[r] = dl;
      lim_s[r] = valid ? (int)key_limit(p, i) : 0;
    }
  }
}

// Load keys [k0, k0 + BK) of K and V (zero past Skv).
template <int D, int BK>
__device__ void load_keys(const BwdParams& p, int64_t b, int64_t kvh,
                          int64_t k0, float* Ks, float* Vs) {
  constexpr int LD = D + 1;
  for (int t = threadIdx.x; t < BK * D; t += kThreads) {
    const int j = t / D, c = t % D;
    const int64_t key = k0 + j;
    float kv = 0.f, vv = 0.f;
    if (key < p.Skv) {
      kv = p.k[b * p.ksb + key * p.kss + kvh * p.ksh + c];
      vv = p.v[b * p.vsb + key * p.vss + kvh * p.vsh + c];
    }
    Ks[j * LD + c] = kv;
    Vs[j * LD + c] = vv;
  }
}

// P and dS of the kRows x BK block: S = Q K^T and dP = dO V^T with a
// thread tile of 4 rows (tr + 16a) x JB keys (tj + 16b).
template <int D, int BK>
__device__ void probs(const BwdParams& p, int64_t k0, const float* Qs,
                      const float* Gs, const float* Ks, const float* Vs,
                      const float* lse_s, const float* dl_s,
                      const int* lim_s, float* Ps, float* Ss) {
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int JB = (BK + 15) / 16;
  const int tj = threadIdx.x % 16, tr = threadIdx.x / 16;
  float s[4][JB], dp[4][JB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < JB; ++c) s[a][c] = dp[a][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[JB], vv[JB];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = Qs[(tr + 16 * a) * LD + d];
      gv[a] = Gs[(tr + 16 * a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < JB; ++c) {
      const int j = tj + 16 * c < BK ? tj + 16 * c : BK - 1;
      kv[c] = Ks[j * LD + d];
      vv[c] = Vs[j * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < JB; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = tr + 16 * a;
#pragma unroll
    for (int c = 0; c < JB; ++c) {
      const int j = tj + 16 * c;
      if (j >= BK) continue;
      const float pr = k0 + j < lim_s[r]
                           ? expf(s[a][c] * p.scale - lse_s[r]) : 0.f;
      Ps[r * LP + j] = pr;
      Ss[r * LP + j] = pr * (dp[a][c] - dl_s[r]);
    }
  }
}

template <int D, int BK>
__device__ __forceinline__ void carve(unsigned char* raw, float*& Ks,
                                      float*& Vs, float*& Qs, float*& Gs,
                                      float*& Ps, float*& Ss, float*& lse_s,
                                      float*& dl_s, int*& lim_s) {
  using S = Smem<D, BK>;
  Ks = reinterpret_cast<float*>(raw);
  Vs = Ks + BK * S::LD;
  Qs = Vs + BK * S::LD;
  Gs = Qs + kRows * S::LD;
  Ps = Gs + kRows * S::LD;
  Ss = Ps + kRows * S::LP;
  lse_s = Ss + kRows * S::LP;
  dl_s = lse_s + kRows;
  lim_s = reinterpret_cast<int*>(dl_s + kRows);
}

// dK/dV of keys [k0, k0 + BK) of KV head kvh.
template <int D, int BK>
__device__ void dkdv_block(const BwdParams& p, int64_t b, int64_t kvh,
                           int64_t k0, unsigned char* smem_raw) {
  using M = RowMap<D>;
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int KB = (BK + kWarps * M::KSW - 1) / (kWarps * M::KSW);
  float *Ks, *Vs, *Qs, *Gs, *Ps, *Ss, *lse_s, *dl_s;
  int* lim_s;
  carve<D, BK>(smem_raw, Ks, Vs, Qs, Gs, Ps, Ss, lse_s, dl_s, lim_s);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int jl = warp * M::KSW + lane / M::LPK, dl0 = lane % M::LPK;

  load_keys<D, BK>(p, b, kvh, k0, Ks, Vs);
  // the first position that sees key k0
  int64_t i0 = 0;
  if (p.causal) {
    i0 = k0 - (p.Skv - p.Sq);
    i0 = i0 < 0 ? 0 : i0;
  }
  const int64_t n_end = p.Sq * p.G;
  float dk[KB][M::DPL], dv[KB][M::DPL];
#pragma unroll
  for (int c = 0; c < KB; ++c)
#pragma unroll
    for (int e = 0; e < M::DPL; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int64_t n0 = i0 * p.G; n0 < n_end; n0 += kRows) {
    __syncthreads();  // the previous chunk's readers are done
    load_rows<D>(p, b, kvh, n0, n_end, Qs, Gs, lse_s, dl_s, lim_s);
    __syncthreads();
    probs<D, BK>(p, k0, Qs, Gs, Ks, Vs, lse_s, dl_s, lim_s, Ps, Ss);
    __syncthreads();
    const int64_t left = n_end - n0;
    const int nr = left < kRows ? (int)left : kRows;
    for (int r = 0; r < nr; ++r) {
      float gv[M::DPL], qv[M::DPL];
#pragma unroll
      for (int e = 0; e < M::DPL; ++e) {
        gv[e] = Gs[r * LD + dl0 + M::LPK * e];
        qv[e] = Qs[r * LD + dl0 + M::LPK * e];
      }
#pragma unroll
      for (int c = 0; c < KB; ++c) {
        const int j = jl + kWarps * M::KSW * c;
        if (j >= BK) continue;
        const float pj = Ps[r * LP + j], sj = Ss[r * LP + j];
#pragma unroll
        for (int e = 0; e < M::DPL; ++e) {
          dv[c][e] = fmaf(pj, gv[e], dv[c][e]);
          dk[c][e] = fmaf(sj, qv[e], dk[c][e]);
        }
      }
    }
  }
  // dk/dv: (B, Skv, KVH, D) contiguous
  const int64_t KVH = p.H / p.G;
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const int j = jl + kWarps * M::KSW * c;
    const int64_t key = k0 + j;
    if (j >= BK || key >= p.Skv) continue;
    const int64_t at = ((b * p.Skv + key) * KVH + kvh) * D;
#pragma unroll
    for (int e = 0; e < M::DPL; ++e) {
      p.dk[at + dl0 + M::LPK * e] = dk[c][e] * p.scale;
      p.dv[at + dl0 + M::LPK * e] = dv[c][e];
    }
  }
}

// dQ of (position, head) rows [n0, n0 + kRows) of KV head kvh's group.
template <int D, int BK>
__device__ void dq_block(const BwdParams& p, int64_t b, int64_t kvh,
                         int64_t n0, unsigned char* smem_raw) {
  using M = RowMap<D>;
  constexpr int LD = D + 1, LP = BK + 1;
  constexpr int RA = (kRows + kWarps * M::KSW - 1) / (kWarps * M::KSW);
  float *Ks, *Vs, *Qs, *Gs, *Ps, *Ss, *lse_s, *dl_s;
  int* lim_s;
  carve<D, BK>(smem_raw, Ks, Vs, Qs, Gs, Ps, Ss, lse_s, dl_s, lim_s);
  const int64_t n_end = p.Sq * p.G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rl = warp * M::KSW + lane / M::LPK, dl0 = lane % M::LPK;

  load_rows<D>(p, b, kvh, n0, n_end, Qs, Gs, lse_s, dl_s, lim_s);
  // keys up to the last row's causal limit
  const int64_t n_last = (n0 + kRows < n_end ? n0 + kRows : n_end) - 1;
  const int64_t kv_end = key_limit(p, n_last / p.G);
  float dq[RA][M::DPL];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int e = 0; e < M::DPL; ++e) dq[a][e] = 0.f;

  for (int64_t k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_keys<D, BK>(p, b, kvh, k0, Ks, Vs);
    __syncthreads();
    probs<D, BK>(p, k0, Qs, Gs, Ks, Vs, lse_s, dl_s, lim_s, Ps, Ss);
    __syncthreads();
    const int64_t left = kv_end - k0;
    const int nk = left < BK ? (int)left : BK;
    for (int j = 0; j < nk; ++j) {
      float kv[M::DPL];
#pragma unroll
      for (int e = 0; e < M::DPL; ++e) kv[e] = Ks[j * LD + dl0 + M::LPK * e];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = rl + kWarps * M::KSW * a;
        if (r >= kRows) continue;
        const float sj = Ss[r * LP + j];
#pragma unroll
        for (int e = 0; e < M::DPL; ++e) dq[a][e] = fmaf(sj, kv[e], dq[a][e]);
      }
    }
  }
  // dq: (B, Sq, H, D) contiguous
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = rl + kWarps * M::KSW * a;
    const int64_t n = n0 + r;
    if (r >= kRows || n >= n_end) continue;
    const int64_t i = n / p.G, h = kvh * p.G + n % p.G;
    const int64_t at = ((b * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int e = 0; e < M::DPL; ++e)
      p.dq[at + dl0 + M::LPK * e] = dq[a][e] * p.scale;
  }
}

// Blocks [0, ktiles) of grid.x take dK/dV of a key tile, the rest dQ of
// 64 rows; grid.y is the KV head, grid.z the batch.
template <int D, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(BwdParams p, int ktiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t b = blockIdx.z, kvh = blockIdx.y;
  if ((int)blockIdx.x < ktiles)
    dkdv_block<D, BK>(p, b, kvh, (int64_t)blockIdx.x * BK, smem_raw);
  else
    dq_block<D, BK>(p, b, kvh, (int64_t)(blockIdx.x - ktiles) * kRows,
                    smem_raw);
}

template <int D, int BK>
cudaError_t launch(const BwdParams& p, int64_t B, int64_t KVH,
                   cudaStream_t s) {
  constexpr int bytes = Smem<D, BK>::kBytes;
  const auto kernel = flash_bwd_kernel<D, BK>;
  // above 48 KB of dynamic shared memory only with the attribute
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t ktiles = (p.Skv + BK - 1) / BK;
  const int64_t qblocks = (p.Sq * p.G + kRows - 1) / kRows;
  kernel<<<dim3((unsigned)(ktiles + qblocks), (unsigned)KVH, (unsigned)B),
           kThreads, bytes, s>>>(p, (int)ktiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_bk(const BwdParams& p, int64_t B, int64_t KVH, int bk,
                        cudaStream_t s) {
  switch (bk) {
    case 16: return launch<D, 16>(p, B, KVH, s);
    case 32: return launch<D, 32>(p, B, KVH, s);
    case 64: return launch<D, 64>(p, B, KVH, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Skv, KVH, D), o and dO: (B, Sq, H, D), each
// with its own (b, s, h) strides and unit stride along D; lse: (B, H, Sq)
// f32 contiguous from the forward.  Writes dq (B, Sq, H, D), dk and dv
// (B, Skv, KVH, D), contiguous f32.  bk: the KV tile (16, 32 or 64).  f32
// only.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    int64_t B, int64_t H, int64_t KVH, int64_t Sq, int64_t Skv, int64_t D,
    int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
    int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, int64_t gsb, int64_t gss, int64_t gsh,
    float scale, int causal, int bk, int dtype, void* stream) {
  if (dtype != kFloat32 || KVH < 1 || H % KVH || (causal && Sq > Skv) ||
      Sq < 1 || Skv < 1 || Skv >= (1LL << 31) || KVH >= 65536 ||
      B >= 65536 ||
      (Skv + 15) / 16 + (Sq * (H / KVH) + kRows - 1) / kRows >= (1LL << 31))
    return cudaErrorInvalidValue;
  const BwdParams p{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(o),
                    static_cast<const float*>(dO),
                    static_cast<const float*>(lse),
                    static_cast<float*>(dq),
                    static_cast<float*>(dk),
                    static_cast<float*>(dv),
                    H, H / KVH, Sq, Skv,
                    qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss,
                    osh, gsb, gss, gsh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return dispatch_bk<8>(p, B, KVH, bk, s);
    case 16: return dispatch_bk<16>(p, B, KVH, bk, s);
    case 32: return dispatch_bk<32>(p, B, KVH, bk, s);
    case 64: return dispatch_bk<64>(p, B, KVH, bk, s);
    case 128: return dispatch_bk<128>(p, B, KVH, bk, s);
    default: return cudaErrorInvalidValue;
  }
}
