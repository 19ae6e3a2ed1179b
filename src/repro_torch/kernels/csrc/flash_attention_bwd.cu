// Causal GQA flash attention backward for Hopper (sm_90a), f32 and bf16.
//
// Replaces: the gradient of the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:29), which has no backward of its
// own: JAX differentiates the plain layer (src/repro/models/layers.py:63
// chunked_attention).  Inputs: q (B, Sq, H, d), k/v (B, Skv, KVH, d), the
// forward's output o and its per-row log-sum-exp lse (B, H, Sq; f32, written
// by csrc/flash_attention.cu), and the output gradient dO.  With
// S = q k^T / sqrt(d) masked causally (query i at absolute position
// Skv - Sq + i), P = exp(S - lse), Dl = rowsum(dO o):
//   dV = P^T dO,  dS = P (dO V^T - Dl),  dQ = dS K / sqrt(d),
//   dK = dS^T Q / sqrt(d),
// with dK and dV summed over the G = H / KVH query heads of each KV head.
// dq, dk and dv come out in q's dtype.
//
// Bound on the H100: 5 products of 2 d flops per visible (query, key) pair
// (S recomputed, dP, dV, dK, dQ) against reading q, k, v, o, dO and lse once
// and writing dq, dk, dv once.  At the tuning loop's shapes (S 32) the bound
// is well under a microsecond and the time is the launch and the blocks'
// chains of dependent trips; at long prompts it is compute-bound (f32 on
// FMA at 67 TFLOP/s, bf16 on the tensor cores at 989).  The kernel does 7
// products, not 5: the dQ blocks recompute S and dP (FlashAttention-2's
// price for summing dQ without atomics).
//
// Design.  One launch; its grid holds two kinds of block, interleaved in
// proportion along grid.x so that the heaviest of both start first (the
// wrapper's plan, kernels/flash_attention.py plan_flash_bwd, sets the
// counts; the C entry checks it before anything launches):
//   - dK/dV: a tile of BK keys of one (batch, KV head), BK the forward's KV
//     tile (the tuning loop's kv_chunk), walking the (position, head) rows
//     that see its keys in chunks of RC rows: all G query heads of the
//     group, so GQA's sum over heads stays in the block.  Early keys first.
//     Where one key tile's rows are many (long prompts), the plan cuts them
//     into `splits` blocks; each writes its f32 partial to a workspace and
//     the last to arrive (an int ticket) sums them in split order.
//   - dQ: RC rows, walking the key tiles up to its last row's causal limit.
//     Late rows first.
// Tiles are staged in shared memory: the block's fixed operand once, the
// streamed one (row chunks, or key tiles) double-buffered with 16-byte
// cp.async so the next loads while this one computes (element loads where
// a row is not 16-byte aligned).  lse comes in by 4-byte cp.async with its
// chunk; Dl = rowsum(dO o) is taken once per chunk from the staged dO and
// o tiles (o is staged beside them), 16-byte shared reads.
//   - bf16: 4 warps, mma.sync m16n8k16 with ldmatrix fragments and f32
//     accumulators.  dK/dV: a warp owns 16 keys and a share of the chunk's
//     rows (4 / (BK / 16) warps split the rows), computes S^T = K Q^T and
//     dP^T = V dO^T, keeps P^T and dS^T in registers and repacks them as the
//     A operand of dV += P^T dO and dK += dS^T Q (dO and Q by
//     ldmatrix.trans); the warps' partials are summed in warp order at the
//     end.  dQ: a warp owns 16 rows, holds its Q and dO A fragments, and for
//     each 16 keys computes S = Q K^T, dP = dO V^T, then dQ += dS K.  P and
//     dS are rounded to bf16 before their products (FlashAttention-2); lse,
//     Dl and every sum stay f32.  d = 8 is padded to the mma's depth of 16.
//   - f32: FMA, no TF32 (the tuning loop holds gradients to 1e-4).  S and
//     dP as 4 keys x 4 rows register tiles a thread (BK RC / 16 threads;
//     4 x 2 at d 128), dK/dV and dQ as outer-product register tiles (4 x
//     d/16 and wider), every shared read 16 bytes.  P and dS pass through
//     shared memory between the products.
// No float atomics: every output element is summed in a fixed order (rows
// in order in a thread or warp, warps in order, splits in order), so two
// runs give the same bits.  Ragged Sq/Skv edges are zero-filled and masked.

#include "common.cuh"

namespace {

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ constexpr int cmin(int a, int b) {
  return a < b ? a : b;
}

struct Params {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  void *dq, *dk, *dv;
  float* ws;      // splits > 1: f32 dK/dV partials, 2 BK d floats a block
  int* counters;  // splits > 1: one a key tile, zero between calls
  int64_t H, Sq, Skv;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb,
      gss, gsh;
  float scale;
  int G, nrows;  // query heads a KV head; Sq * G rows of a KV head
  int causal, splits, ktiles, kv_blocks, q_blocks;
  int vec;  // every q/k/v/o/dO row 16-byte aligned: cp.async
};

// Geometry of an instantiation, shared by the kernel and the C entry's
// check of the plan.
template <typename T, int D, int BK>
struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int DP = (kBf16 && D < 16) ? 16 : D;  // staged width
  // row pitch: 16 bytes of padding, so rows stay 16-byte aligned and
  // ldmatrix and float4 reads of neighbouring rows hit distinct banks
  static constexpr int LD = DP + 16 / (int)sizeof(T);
  static constexpr int RC = (!kBf16 && D > 64) ? 32 : 64;  // rows a chunk
  // f32: S and dP as 4 keys x SR rows a thread; SR 4, and 2 at d 128 so
  // its dK/dV and dQ tiles (16 d / BK and 32 d / RC a thread) fit the
  // registers
  static constexpr int SR = D > 64 ? 2 : 4;
  static constexpr int kThreads = kBf16 ? 128 : BK * RC / (4 * SR);
  // bf16 at d <= 64: 3 blocks an SM (registers capped at 170; shared memory
  // allows it); else what shared memory and registers give
  static constexpr int kMinBlocks = (kBf16 && D <= 64) ? 3 : 1;
  // f32 score tiles: dK/dV block P and dS [RC][LPK], dQ block dS^T [BK][LPR]
  static constexpr int LPK = BK + 4, LPR = RC + 4;
  static constexpr int kScore = kBf16 ? 0 : cmax(2 * RC * LPK, BK * LPR);
  static constexpr int kKV = BK * LD, kRows = RC * LD;
  // dK/dV block: K, V once, then 2 x (Q, dO, O); dQ block: Q, dO, O once,
  // then 2 x (K, V)
  static constexpr int kTiles = cmax(2 * kKV + 6 * kRows, 3 * kRows + 4 * kKV);
  static constexpr int kBytes =
      kTiles * (int)sizeof(T) + kScore * 4 + 2 * RC * 12;  // + lse, Dl, limit
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// keys [0, limit) are visible to the query at position i
__device__ __forceinline__ int key_limit(const Params& p, int64_t i) {
  if (!p.causal) return (int)p.Skv;
  const int64_t e = p.Skv - p.Sq + i + 1;
  return (int)(e < p.Skv ? e : p.Skv);
}

// Rows [n0, n0 + RC) of KV head kvh (those < n_end; the rest zero): q, dO
// and o into Qs, Gs, Os, and lse into lse_s.  Row n is position n / G, head
// kvh G + n % G.  vec: lanes along a row's 16-byte pieces (cp.async; a zero
// fill names the tensor and reads nothing), NT / CH rows a sweep, the
// (position, head) of a thread's next row stepped on without a division;
// else element loads.
template <typename T, int D, int BK>
__device__ __forceinline__ void stage_rows(const Params& p, int64_t b,
                                           int64_t kvh, int n0, int n_end,
                                           T* Qs, T* Gs, T* Os,
                                           float* lse_s) {
  using Gm = Geo<T, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, NT = Gm::kThreads;
  const T* q = static_cast<const T*>(p.q) + b * p.qsb;
  const T* g = static_cast<const T*>(p.dO) + b * p.gsb;
  const T* o = static_cast<const T*>(p.o) + b * p.osb;
  if (p.vec) {
    constexpr int V = Vec<T>::N, CH = D / V, RS = NT / CH;
    const int c = (threadIdx.x % CH) * V;
    int r = threadIdx.x / CH, n = n0 + r;
    int i = n / p.G, hg = n - i * p.G;
    const int di = RS / p.G, dg = RS - di * p.G;
#pragma unroll 2
    for (; r < RC; r += RS) {
      if (n < n_end) {
        const int64_t h = kvh * p.G + hg;
        cp_async16(Qs + r * LD + c, q + i * p.qss + h * p.qsh + c, 16);
        cp_async16(Gs + r * LD + c, g + i * p.gss + h * p.gsh + c, 16);
        cp_async16(Os + r * LD + c, o + i * p.oss + h * p.osh + c, 16);
      } else {
        cp_async16(Qs + r * LD + c, q, 0);
        cp_async16(Gs + r * LD + c, g, 0);
        cp_async16(Os + r * LD + c, o, 0);
      }
      n += RS;
      i += di;
      hg += dg;
      if (hg >= p.G) {
        hg -= p.G;
        ++i;
      }
    }
  } else {
    constexpr int W = D < NT ? D : NT;  // lanes along a row
    for (int r = threadIdx.x / W; r < RC; r += NT / W) {
      const int n = n0 + r, i = n / p.G;
      const int64_t h = kvh * p.G + (n - i * p.G);
      for (int c = threadIdx.x % W; c < D; c += W) {
        const bool in = n < n_end;
        Qs[r * LD + c] = in ? q[i * p.qss + h * p.qsh + c] : from_f<T>(0.f);
        Gs[r * LD + c] = in ? g[i * p.gss + h * p.gsh + c] : from_f<T>(0.f);
        Os[r * LD + c] = in ? o[i * p.oss + h * p.osh + c] : from_f<T>(0.f);
      }
    }
  }
  for (int r = threadIdx.x; r < RC; r += NT) {
    const int n = n0 + r, i = n / p.G;
    const int64_t h = kvh * p.G + (n - i * p.G);
    cp_async4(lse_s + r, n < n_end ? p.lse + (b * p.H + h) * p.Sq + i : p.lse,
              n < n_end ? 4 : 0);
  }
}

// Keys [k0, k0 + BK) of K and V (zero past Skv), as stage_rows lays rows.
template <typename T, int D, int BK>
__device__ __forceinline__ void stage_keys(const Params& p, int64_t b,
                                           int64_t kvh, int64_t k0, T* Ks,
                                           T* Vs) {
  using Gm = Geo<T, D, BK>;
  constexpr int LD = Gm::LD, NT = Gm::kThreads;
  const T* k = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
  const T* v = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
  if (p.vec) {
    constexpr int V = Vec<T>::N, CH = D / V, RS = NT / CH;
    const int c = (threadIdx.x % CH) * V;
#pragma unroll 2
    for (int j = threadIdx.x / CH; j < BK; j += RS) {
      const int64_t key = k0 + j;
      const bool in = key < p.Skv;
      cp_async16(Ks + j * LD + c, in ? k + key * p.kss + c : k, in ? 16 : 0);
      cp_async16(Vs + j * LD + c, in ? v + key * p.vss + c : v, in ? 16 : 0);
    }
  } else {
    constexpr int W = D < NT ? D : NT;
    for (int j = threadIdx.x / W; j < BK; j += NT / W) {
      const int64_t key = k0 + j;
      for (int c = threadIdx.x % W; c < D; c += W) {
        const bool in = key < p.Skv;
        Ks[j * LD + c] = in ? k[key * p.kss + c] : from_f<T>(0.f);
        Vs[j * LD + c] = in ? v[key * p.vss + c] : from_f<T>(0.f);
      }
    }
  }
}

// Dl = rowsum(dO o) and the causal key limit (0 past n_end) of the chunk's
// RC rows, from the staged tiles: NT / RC adjacent lanes a row, 16-byte
// shared reads, a shuffle sum in a fixed order.
template <typename T, int D, int BK>
__device__ __forceinline__ void row_stats(const Params& p, int n0, int n_end,
                                          const T* Gs, const T* Os,
                                          float* dl_s, int* lim_s) {
  using Gm = Geo<T, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, TPR = Gm::kThreads / RC;
  constexpr int V = Vec<T>::N, CH = D / V;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  float dl = 0.f;
#pragma unroll
  for (int c = part; c < CH; c += TPR) {
    float g[V], o[V];
    unpack16(*reinterpret_cast<const uint4*>(Gs + r * LD + c * V), g, T());
    unpack16(*reinterpret_cast<const uint4*>(Os + r * LD + c * V), o, T());
#pragma unroll
    for (int e = 0; e < V; ++e) dl = fmaf(g[e], o[e], dl);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    dl += __shfl_xor_sync(0xffffffffu, dl, off);
  if (part == 0) {
    dl_s[r] = dl;
    lim_s[r] = n0 + r < n_end ? key_limit(p, (n0 + r) / p.G) : 0;
  }
}

// Rows [nb, ne) of a dK/dV block: the rows that see key tile kt (from the
// first position that sees its first key), cut into p.splits shares of
// whole chunks.
__device__ __forceinline__ void split_rows(const Params& p, int kt, int bk,
                                           int split, int rc, int& nb,
                                           int& ne) {
  int64_t i0 = 0;
  if (p.causal) {
    i0 = (int64_t)kt * bk - (p.Skv - p.Sq);
    i0 = i0 < 0 ? 0 : i0;
  }
  const int64_t first = i0 * p.G, total = p.nrows - first;
  const int64_t per = ((total + p.splits - 1) / p.splits + rc - 1) / rc * rc;
  const int64_t b0 = first + split * per, e0 = b0 + per;
  nb = (int)(b0 < p.nrows ? b0 : p.nrows);
  ne = (int)(e0 < p.nrows ? e0 : p.nrows);
}

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

// Four consecutive outputs from f32 (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The end of a dK/dV block.  red: the block's partial as `slots` f32
// [2][BK][D] arrays (dK unscaled, then dV), summed in slot order.  One split:
// written to dk/dv.  Several: written to the workspace; the last split to
// arrive sums the splits' partials in split order into dk/dv.  Four
// consecutive dims a thread at a time (D is a multiple of 4).
template <typename T, int D, int BK>
__device__ void dkdv_out(const Params& p, int64_t b, int64_t kvh, int kt,
                         int split, const float* red, int slots) {
  constexpr int NT = Geo<T, D, BK>::kThreads, N = 2 * BK * D, N4 = N / 4;
  const int64_t KVH = p.H / p.G, k0 = (int64_t)kt * BK;
  const int64_t tile = (b * KVH + kvh) * p.ktiles + kt;
  const float4* red4 = reinterpret_cast<const float4*>(red);
  T* __restrict__ dk = static_cast<T*>(p.dk);
  T* __restrict__ dv = static_cast<T*>(p.dv);
  auto emit = [&](int i4, float4 x) {
    const int i = 4 * i4, w = i / (BK * D), j = (i / D) % BK, d = i % D;
    if (k0 + j >= p.Skv) return;
    const int64_t at = ((b * p.Skv + k0 + j) * KVH + kvh) * D + d;
    if (w == 0)
      store4(dk + at, make_float4(x.x * p.scale, x.y * p.scale,
                                  x.z * p.scale, x.w * p.scale));
    else
      store4(dv + at, x);
  };
  auto block_sum = [&](int i4) {
    float4 x = red4[i4];
    for (int s = 1; s < slots; ++s) x = add4(x, red4[s * N4 + i4]);
    return x;
  };
  if (p.splits == 1) {
    for (int i4 = threadIdx.x; i4 < N4; i4 += NT) emit(i4, block_sum(i4));
    return;
  }
  float4* __restrict__ ws = reinterpret_cast<float4*>(p.ws) +
                            tile * p.splits * N4;
  for (int i4 = threadIdx.x; i4 < N4; i4 += NT)
    ws[split * N4 + i4] = block_sum(i4);
  if (!last_arrival(p.counters + tile, p.splits)) return;
  // U outputs a thread at a time, every split's loads of them issued before
  // any store, so they are in flight together
  constexpr int U = N4 / NT < 4 ? (N4 / NT > 0 ? N4 / NT : 1) : 4;
  for (int i0 = threadIdx.x; i0 < N4; i0 += U * NT) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * NT < N4) x[u] = __ldcg(ws + i0 + u * NT);
    for (int s = 1; s < p.splits; ++s)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u * NT < N4)
          x[u] = add4(x[u], __ldcg(ws + s * N4 + i0 + u * NT));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * NT < N4) emit(i0 + u * NT, x[u]);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA register tiles
// ---------------------------------------------------------------------------

// N consecutive floats from shared memory (N = 1, 2 or a multiple of 4).
template <int N>
__device__ __forceinline__ void lds(float* out, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

// Column of the e-th of the TD dims of dim group g (of DG groups): runs of
// 4 dims, 4 DG apart, where TD is a multiple of 4, so a warp's reads are
// 16 bytes a lane on neighbouring addresses; else TD consecutive dims.
template <int TD, int DG>
__device__ __forceinline__ int dim_col(int g, int e) {
  if constexpr (TD % 4 == 0) return 4 * g + 4 * DG * (e / 4) + e % 4;
  return TD * g + e;
}

template <int TD, int DG>
__device__ __forceinline__ void ld_dims(float* out, const float* row,
                                        int g) {
  if constexpr (TD % 4 == 0) {
#pragma unroll
    for (int e = 0; e < TD; e += 4)
      lds<4>(out + e, row + dim_col<TD, DG>(g, e));
  } else {
    lds<TD>(out, row + TD * g);
  }
}

// S = K Q^T and dP = V dO^T of this thread's 4 keys (kl + BK/4 a) x SR
// rows (rl + RC/SR c), dot products over d from shared memory, 16 bytes a
// read.
template <int D, int BK>
__device__ __forceinline__ void score_f32(
    const float* Ks, const float* Vs, const float* Qs, const float* Gs,
    int kl, int rl, float (&s)[4][Geo<float, D, BK>::SR],
    float (&dp)[4][Geo<float, D, BK>::SR]) {
  using Gm = Geo<float, D, BK>;
  constexpr int LD = Gm::LD, RC = Gm::RC, SR = Gm::SR;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < SR; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll(SR == 4 ? 4 : 2)
  for (int d = 0; d < D; d += 4) {
    float4 qv[SR], gv[SR];
#pragma unroll
    for (int c = 0; c < SR; ++c) {
      const int at = (rl + RC / SR * c) * LD + d;
      qv[c] = *reinterpret_cast<const float4*>(Qs + at);
      gv[c] = *reinterpret_cast<const float4*>(Gs + at);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 kv =
          *reinterpret_cast<const float4*>(Ks + (kl + BK / 4 * a) * LD + d);
      const float4 vv =
          *reinterpret_cast<const float4*>(Vs + (kl + BK / 4 * a) * LD + d);
#pragma unroll
      for (int c = 0; c < SR; ++c) {
        s[a][c] = fmaf(kv.x, qv[c].x, fmaf(kv.y, qv[c].y,
                  fmaf(kv.z, qv[c].z, fmaf(kv.w, qv[c].w, s[a][c]))));
        dp[a][c] = fmaf(vv.x, gv[c].x, fmaf(vv.y, gv[c].y,
                   fmaf(vv.z, gv[c].z, fmaf(vv.w, gv[c].w, dp[a][c]))));
      }
    }
  }
}

template <int D, int BK>
__device__ void dkdv_f32(const Params& p, int64_t b, int64_t kvh, int kt,
                         int split, unsigned char* smem) {
  using Gm = Geo<float, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, NT = Gm::kThreads, LPK = Gm::LPK;
  constexpr int SR = Gm::SR;
  // dK/dV register tile: TK keys (4; 2 at d 8) x TD dims a thread
  constexpr int DG = cmin(4 * NT / BK, D), TD = D / DG, KG = NT / DG,
                TK = BK / KG;
  float* tiles = reinterpret_cast<float*>(smem);
  const float* Ks = tiles;
  const float* Vs = tiles + Gm::kKV;
  float* Ps = tiles + Gm::kTiles;
  float* Ss = Ps + RC * LPK;
  float* lse_s = Ps + Gm::kScore;
  float* dl_s = lse_s + 2 * RC;
  int* lim_s = reinterpret_cast<int*>(dl_s + 2 * RC);
  auto chunk = [&](int buf) {
    return tiles + 2 * Gm::kKV + buf * 3 * Gm::kRows;
  };

  const int64_t k0 = (int64_t)kt * BK;
  int nb, ne;
  split_rows(p, kt, BK, split, RC, nb, ne);
  const int nchunks = (ne - nb + RC - 1) / RC;
  stage_keys<float, D, BK>(p, b, kvh, k0, tiles, tiles + Gm::kKV);
  if (nchunks > 0)
    stage_rows<float, D, BK>(p, b, kvh, nb, ne, chunk(0),
                             chunk(0) + Gm::kRows, chunk(0) + 2 * Gm::kRows,
                             lse_s);
  cp_async_commit();

  const int t = threadIdx.x;
  const int kl = t % (BK / 4), rl = t / (BK / 4);  // score tile
  const int dg = t % DG, kg = t / DG;              // dK/dV tile
  float dk[TK][TD], dv[TK][TD];
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int e = 0; e < TD; ++e) dk[a][e] = dv[a][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    const int buf = c & 1, n0 = nb + c * RC;
    const float* Qs = chunk(buf);
    const float* Gs = Qs + Gm::kRows;
    const float* Os = Gs + Gm::kRows;
    if (c + 1 < nchunks) {
      float* nq = chunk(buf ^ 1);
      stage_rows<float, D, BK>(p, b, kvh, n0 + RC, ne, nq, nq + Gm::kRows,
                               nq + 2 * Gm::kRows, lse_s + (buf ^ 1) * RC);
      cp_async_commit();
    }
    const float* lse = lse_s + buf * RC;
    float* dl = dl_s + buf * RC;
    int* lim = lim_s + buf * RC;
    row_stats<float, D, BK>(p, n0, ne, Gs, Os, dl, lim);
    __syncthreads();
    {
      float s[4][SR], dp[4][SR];
      score_f32<D, BK>(Ks, Vs, Qs, Gs, kl, rl, s, dp);
#pragma unroll
      for (int cc = 0; cc < SR; ++cc) {
        const int r = rl + RC / SR * cc;
        const float lr = lse[r], dr = dl[r];
        const int64_t lr_lim = lim[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = kl + BK / 4 * a;
          const float pr =
              k0 + j < lr_lim ? expf(s[a][cc] * p.scale - lr) : 0.f;
          Ps[r * LPK + j] = pr;
          Ss[r * LPK + j] = pr * (dp[a][cc] - dr);
        }
      }
    }
    __syncthreads();
    const int nr = ne - n0 < RC ? ne - n0 : RC;
#pragma unroll 2
    for (int r = 0; r < nr; ++r) {
      float pk[TK], sk[TK], gd[TD], qd[TD];
      lds<TK>(pk, Ps + r * LPK + TK * kg);
      lds<TK>(sk, Ss + r * LPK + TK * kg);
      ld_dims<TD, DG>(gd, Gs + r * LD, dg);
      ld_dims<TD, DG>(qd, Qs + r * LD, dg);
#pragma unroll
      for (int a = 0; a < TK; ++a)
#pragma unroll
        for (int e = 0; e < TD; ++e) {
          dv[a][e] = fmaf(pk[a], gd[e], dv[a][e]);
          dk[a][e] = fmaf(sk[a], qd[e], dk[a][e]);
        }
    }
  }
  __syncthreads();  // every thread is done with the chunks: red reuses them
  float* red = chunk(0);
#pragma unroll
  for (int a = 0; a < TK; ++a)
#pragma unroll
    for (int e = 0; e < TD; ++e) {
      const int j = TK * kg + a, d = dim_col<TD, DG>(dg, e);
      red[j * D + d] = dk[a][e];
      red[(BK + j) * D + d] = dv[a][e];
    }
  __syncthreads();
  dkdv_out<float, D, BK>(p, b, kvh, kt, split, red, 1);
}

template <int D, int BK>
__device__ void dq_f32(const Params& p, int64_t b, int64_t kvh, int qb,
                       unsigned char* smem) {
  using Gm = Geo<float, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, NT = Gm::kThreads, LPR = Gm::LPR;
  constexpr int SR = Gm::SR;
  // dQ register tile: TR rows (4; 2 at d 8) x TD dims a thread
  constexpr int DG = cmin(4 * NT / RC, D), TD = D / DG, RG = NT / DG,
                TR = RC / RG;
  float* tiles = reinterpret_cast<float*>(smem);
  const float* Qs = tiles;
  const float* Gs = tiles + Gm::kRows;
  const float* Os = tiles + 2 * Gm::kRows;
  float* St = tiles + Gm::kTiles;  // dS^T [BK][LPR]
  float* lse = St + Gm::kScore;
  float* dl = lse + 2 * RC;
  int* lim = reinterpret_cast<int*>(dl + 2 * RC);
  auto keys = [&](int buf) {
    return tiles + 3 * Gm::kRows + buf * 2 * Gm::kKV;
  };

  const int n0 = qb * RC;
  const int n_end = n0 + RC < p.nrows ? n0 + RC : p.nrows;
  const int kv_end = key_limit(p, (n_end - 1) / p.G);
  const int ntiles = (kv_end + BK - 1) / BK;
  stage_rows<float, D, BK>(p, b, kvh, n0, n_end, tiles, tiles + Gm::kRows,
                           tiles + 2 * Gm::kRows, lse);
  stage_keys<float, D, BK>(p, b, kvh, 0, keys(0), keys(0) + Gm::kKV);
  cp_async_commit();

  const int t = threadIdx.x;
  const int kl = t % (BK / 4), rl = t / (BK / 4);  // score tile
  const int dg = t % DG, rg = t / DG;              // dQ tile
  float dq[TR][TD];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int e = 0; e < TD; ++e) dq[a][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every thread is done with kt - 1
    const int buf = kt & 1;
    const float* Ks = keys(buf);
    const float* Vs = Ks + Gm::kKV;
    if (kt + 1 < ntiles) {
      stage_keys<float, D, BK>(p, b, kvh, (int64_t)(kt + 1) * BK,
                               keys(buf ^ 1), keys(buf ^ 1) + Gm::kKV);
      cp_async_commit();
    }
    if (kt == 0) {
      row_stats<float, D, BK>(p, n0, n_end, Gs, Os, dl, lim);
      __syncthreads();
    }
    const int64_t k0 = (int64_t)kt * BK;
    {
      float s[4][SR], dp[4][SR];
      score_f32<D, BK>(Ks, Vs, Qs, Gs, kl, rl, s, dp);
#pragma unroll
      for (int cc = 0; cc < SR; ++cc) {
        const int r = rl + RC / SR * cc;
        const float lr = lse[r], dr = dl[r];
        const int64_t lr_lim = lim[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = kl + BK / 4 * a;
          const float pr =
              k0 + j < lr_lim ? expf(s[a][cc] * p.scale - lr) : 0.f;
          St[j * LPR + r] = pr * (dp[a][cc] - dr);
        }
      }
    }
    __syncthreads();
    const int nk = kv_end - k0 < BK ? (int)(kv_end - k0) : BK;
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float sr[TR], kd[TD];
      lds<TR>(sr, St + j * LPR + TR * rg);
      ld_dims<TD, DG>(kd, Ks + j * LD, dg);
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int e = 0; e < TD; ++e) dq[a][e] = fmaf(sr[a], kd[e], dq[a][e]);
    }
  }
  // dq: (B, Sq, H, D) contiguous
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int n = n0 + TR * rg + a;
    if (n >= n_end) continue;
    const int i = n / p.G;
    const int64_t h = kvh * p.G + (n - i * p.G);
    float* out = static_cast<float*>(p.dq) + ((b * p.Sq + i) * p.H + h) * D;
    if constexpr (TD % 4 == 0) {
#pragma unroll
      for (int e = 0; e < TD; e += 4)
        store4(out + dim_col<TD, DG>(dg, e),
               make_float4(dq[a][e] * p.scale, dq[a][e + 1] * p.scale,
                           dq[a][e + 2] * p.scale, dq[a][e + 3] * p.scale));
    } else {
#pragma unroll
      for (int e = 0; e < TD; ++e)
        out[dim_col<TD, DG>(dg, e)] = dq[a][e] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// The padding columns [D, DP) of every staged row are zero (cp.async and
// the element loads write only [0, D)).
template <int D, int BK>
__device__ __forceinline__ void zero_padding(bf16* tiles) {
  using Gm = Geo<bf16, D, BK>;
  if constexpr (Gm::DP > D) {
    constexpr int rows = Gm::kTiles / Gm::LD, W = Gm::DP - D;
    for (int i = threadIdx.x; i < rows * W; i += Gm::kThreads)
      tiles[(i / W) * Gm::LD + D + i % W] = __float2bfloat16(0.f);
  }
}

// Four accumulators of two n8 tiles as the m16k16 A operand (bf16).
__device__ __forceinline__ void pack_a(uint32_t* a, const float (&x)[2][4]) {
  a[0] = pack_bf16x2(x[0][0], x[0][1]);
  a[1] = pack_bf16x2(x[0][2], x[0][3]);
  a[2] = pack_bf16x2(x[1][0], x[1][1]);
  a[3] = pack_bf16x2(x[1][2], x[1][3]);
}

template <int D, int BK>
__device__ void dkdv_bf16(const Params& p, int64_t b, int64_t kvh, int kt,
                          int split, unsigned char* smem) {
  using Gm = Geo<bf16, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, DP = Gm::DP, KD = DP / 16;
  // KW warps along the keys (16 each), RW along the chunk's rows, STEPS
  // 16-row steps a warp a chunk
  constexpr int KW = BK / 16, RW = 4 / KW, STEPS = RC / 16 / RW;
  constexpr bool kHold = D <= 64;  // K/V A fragments in registers
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  const bf16* Ks = tiles;
  const bf16* Vs = tiles + Gm::kKV;
  float* lse_s = reinterpret_cast<float*>(tiles + Gm::kTiles);
  float* dl_s = lse_s + 2 * RC;
  int* lim_s = reinterpret_cast<int*>(dl_s + 2 * RC);
  auto chunk = [&](int buf) {
    return tiles + 2 * Gm::kKV + buf * 3 * Gm::kRows;
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int kw = warp % KW, rw = warp / KW;

  const int64_t k0 = (int64_t)kt * BK, kw0 = k0 + kw * 16;
  int nb, ne;
  split_rows(p, kt, BK, split, RC, nb, ne);
  const int nchunks = (ne - nb + RC - 1) / RC;
  zero_padding<D, BK>(tiles);
  stage_keys<bf16, D, BK>(p, b, kvh, k0, tiles, tiles + Gm::kKV);
  if (nchunks > 0)
    stage_rows<bf16, D, BK>(p, b, kvh, nb, ne, chunk(0),
                            chunk(0) + Gm::kRows, chunk(0) + 2 * Gm::kRows,
                            lse_s);
  cp_async_commit();

  uint32_t ka[kHold ? KD : 1][4], va[kHold ? KD : 1][4];
  float dk[2 * KD][4], dv[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // A fragment (16 keys x 16 dims at kd) of K or V
  auto a_frag = [&](uint32_t* r, const bf16* X, int kd) {
    ldmatrix_x4(r, X + (kw * 16 + (lane & 15)) * LD + kd * 16 +
                       (lane >> 4) * 8);
  };

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    const int buf = c & 1, n0 = nb + c * RC;
    const bf16* Qs = chunk(buf);
    const bf16* Gs = Qs + Gm::kRows;
    const bf16* Os = Gs + Gm::kRows;
    if (c + 1 < nchunks) {
      bf16* nq = chunk(buf ^ 1);
      stage_rows<bf16, D, BK>(p, b, kvh, n0 + RC, ne, nq, nq + Gm::kRows,
                              nq + 2 * Gm::kRows, lse_s + (buf ^ 1) * RC);
      cp_async_commit();
    }
    const float* lse = lse_s + buf * RC;
    float* dl = dl_s + buf * RC;
    int* lim = lim_s + buf * RC;
    row_stats<bf16, D, BK>(p, n0, ne, Gs, Os, dl, lim);
    __syncthreads();
    if constexpr (kHold) {
      if (c == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          a_frag(ka[kd], Ks, kd);
          a_frag(va[kd], Vs, kd);
        }
      }
    }
    const int nr = ne - n0 < RC ? ne - n0 : RC;
    // the steps are independent but for the dK/dV sums: unrolled, so one
    // step's products overlap the next one's
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int rs = (rw * STEPS + st) * 16;
      // rows' limits rise with the row: skip a step none of whose rows sees
      // this warp's keys
      if (rs >= nr || lim[rs + 15 < nr ? rs + 15 : nr - 1] <= kw0) continue;
      float sT[2][4], pT[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = pT[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kfr[4], vfr[4], qb[4], gb[4];
        if constexpr (kHold) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kfr[e] = ka[kd][e];
            vfr[e] = va[kd][e];
          }
        } else {
          a_frag(kfr, Ks, kd);
          a_frag(vfr, Vs, kd);
        }
        const int at = (rs + (lane & 7) + ((lane >> 4) << 3)) * LD + kd * 16 +
                       ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qb, Qs + at);
        ldmatrix_x4(gb, Gs + at);
        mma_bf16_16816(sT[0], kfr, qb[0], qb[1]);
        mma_bf16_16816(sT[1], kfr, qb[2], qb[3]);
        mma_bf16_16816(pT[0], vfr, gb[0], gb[1]);
        mma_bf16_16816(pT[1], vfr, gb[2], gb[3]);
      }
      // P^T and dS^T: element e of n-tile n is key kw0 + lane/4 + 8(e/2),
      // row rs + 8n + 2(lane%4) + e%2
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rs + 8 * n + 2 * (lane % 4) + (e & 1);
          const int64_t key = kw0 + lane / 4 + 8 * (e >> 1);
          const float pr =
              key < lim[r] ? __expf(sT[n][e] * p.scale - lse[r]) : 0.f;
          sT[n][e] = pr;
          pT[n][e] = pr * (pT[n][e] - dl[r]);
        }
      uint32_t pa[4], sa[4];
      pack_a(pa, sT);
      pack_a(sa, pT);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t gb[4], qb[4];
        const int at = (rs + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(gb, Gs + at);
        ldmatrix_x4_trans(qb, Qs + at);
        mma_bf16_16816(dv[2 * dp], pa, gb[0], gb[1]);
        mma_bf16_16816(dv[2 * dp + 1], pa, gb[2], gb[3]);
        mma_bf16_16816(dk[2 * dp], sa, qb[0], qb[1]);
        mma_bf16_16816(dk[2 * dp + 1], sa, qb[2], qb[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with the chunks: red reuses them
  // red: [RW][2][BK][D] f32, one slot per row share
  float* red = reinterpret_cast<float*>(chunk(0));
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = kw * 16 + lane / 4 + 8 * (e >> 1);
      const int d = 8 * n + 2 * (lane % 4) + (e & 1);
      if (d < D) {
        red[((rw * 2) * BK + j) * D + d] = dk[n][e];
        red[((rw * 2 + 1) * BK + j) * D + d] = dv[n][e];
      }
    }
  __syncthreads();
  dkdv_out<bf16, D, BK>(p, b, kvh, kt, split, red, RW);
}

template <int D, int BK>
__device__ void dq_bf16(const Params& p, int64_t b, int64_t kvh, int qb,
                        unsigned char* smem) {
  using Gm = Geo<bf16, D, BK>;
  constexpr int RC = Gm::RC, LD = Gm::LD, DP = Gm::DP, KD = DP / 16;
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  const bf16* Qs = tiles;
  const bf16* Gs = tiles + Gm::kRows;
  const bf16* Os = tiles + 2 * Gm::kRows;
  float* lse_s = reinterpret_cast<float*>(tiles + Gm::kTiles);
  float* dl_s = lse_s + 2 * RC;
  int* lim_s = reinterpret_cast<int*>(dl_s + 2 * RC);
  auto keys = [&](int buf) {
    return tiles + 3 * Gm::kRows + buf * 2 * Gm::kKV;
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * 16;  // this warp's rows; a thread's: +lane/4, +8

  const int n0 = qb * RC;
  const int n_end = n0 + RC < p.nrows ? n0 + RC : p.nrows;
  const int kv_end = key_limit(p, (n_end - 1) / p.G);
  const int ntiles = (kv_end + BK - 1) / BK;
  zero_padding<D, BK>(tiles);
  stage_rows<bf16, D, BK>(p, b, kvh, n0, n_end, tiles, tiles + Gm::kRows,
                          tiles + 2 * Gm::kRows, lse_s);
  stage_keys<bf16, D, BK>(p, b, kvh, 0, keys(0), keys(0) + Gm::kKV);
  cp_async_commit();

  uint32_t qa[KD][4], ga[KD][4];
  float lse[2], dl[2];
  int lim[2], warp_lim = 0;
  float dq[2 * KD][4];
#pragma unroll
  for (int n = 0; n < 2 * KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with kt - 1
    const int buf = kt & 1;
    const bf16* Kt = keys(buf);
    const bf16* Vt = Kt + Gm::kKV;
    if (kt + 1 < ntiles) {
      stage_keys<bf16, D, BK>(p, b, kvh, (int64_t)(kt + 1) * BK,
                              keys(buf ^ 1), keys(buf ^ 1) + Gm::kKV);
      cp_async_commit();
    }
    if (kt == 0) {
      row_stats<bf16, D, BK>(p, n0, n_end, Gs, Os, dl_s, lim_s);
      __syncthreads();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int at = (r0 + (lane & 15)) * LD + kd * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qa[kd], Qs + at);
        ldmatrix_x4(ga[kd], Gs + at);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + lane / 4 + 8 * h;
        lse[h] = lse_s[r];
        dl[h] = dl_s[r];
        lim[h] = lim_s[r];
      }
      const int nr = n_end - n0;
      warp_lim = r0 < nr ? lim_s[r0 + 15 < nr ? r0 + 15 : nr - 1] : 0;
    }
    const int64_t k0 = (int64_t)kt * BK;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int64_t kb = k0 + ks * 16;
      if (kb >= warp_lim) continue;
      float s[2][4], dpv[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dpv[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t kb4[4], vb4[4];
        const int at = (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kd * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kb4, Kt + at);
        ldmatrix_x4(vb4, Vt + at);
        mma_bf16_16816(s[0], qa[kd], kb4[0], kb4[1]);
        mma_bf16_16816(s[1], qa[kd], kb4[2], kb4[3]);
        mma_bf16_16816(dpv[0], ga[kd], vb4[0], vb4[1]);
        mma_bf16_16816(dpv[1], ga[kd], vb4[2], vb4[3]);
      }
      // dS: element e of n-tile n is row lane/4 + 8(e/2), key kb + 8n +
      // 2(lane%4) + e%2
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int64_t key = kb + 8 * n + 2 * (lane % 4) + (e & 1);
          const float pr =
              key < lim[h] ? __expf(s[n][e] * p.scale - lse[h]) : 0.f;
          s[n][e] = pr * (dpv[n][e] - dl[h]);
        }
      uint32_t sa[4];
      pack_a(sa, s);
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t kb4[4];
        ldmatrix_x4_trans(kb4, Kt + (ks * 16 + (lane & 15)) * LD + dp * 16 +
                                   (lane >> 4) * 8);
        mma_bf16_16816(dq[2 * dp], sa, kb4[0], kb4[1]);
        mma_bf16_16816(dq[2 * dp + 1], sa, kb4[2], kb4[3]);
      }
    }
  }
  // dq: (B, Sq, H, D) contiguous
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r0 + lane / 4 + 8 * h;
    if (n >= n_end) continue;
    const int i = n / p.G;
    const int64_t head = kvh * p.G + (n - i * p.G);
    bf16* out = static_cast<bf16*>(p.dq) + ((b * p.Sq + i) * p.H + head) * D;
#pragma unroll
    for (int nt = 0; nt < 2 * KD; ++nt) {
      const int d = 8 * nt + 2 * (lane % 4);
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            dq[nt][2 * h] * p.scale, dq[nt][2 * h + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------

// Block x of grid.x: of the first x blocks, ceil(x kv_blocks / N) are
// dK/dV blocks (key tile idx / splits, split idx % splits, early keys
// first) and the rest dQ blocks (last rows first), so the two kinds are
// interleaved in proportion.  grid.y is the KV head, grid.z the batch.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(Geo<T, D, BK>::kThreads,
                                  Geo<T, D, BK>::kMinBlocks)
flash_bwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t b = blockIdx.z, kvh = blockIdx.y, x = blockIdx.x;
  const int64_t N = (int64_t)p.kv_blocks + p.q_blocks;
  const int64_t before = (x * p.kv_blocks + N - 1) / N;
  const int64_t upto = ((x + 1) * p.kv_blocks + N - 1) / N;
  if (upto > before) {
    const int idx = (int)before;
    if constexpr (sizeof(T) == 2)
      dkdv_bf16<D, BK>(p, b, kvh, idx / p.splits, idx % p.splits,
                            smem_raw);
    else
      dkdv_f32<D, BK>(p, b, kvh, idx / p.splits, idx % p.splits,
                           smem_raw);
  } else {
    const int qb = p.q_blocks - 1 - (int)(x - before);
    if constexpr (sizeof(T) == 2)
      dq_bf16<D, BK>(p, b, kvh, qb, smem_raw);
    else
      dq_f32<D, BK>(p, b, kvh, qb, smem_raw);
  }
}

// 16-byte rows: the pointer and every stride of a dimension longer than 1
// are multiples of 16 bytes.
template <typename T>
bool rows16(const void* ptr, int64_t sb, int64_t ss, int64_t sh, int64_t B,
            int64_t S, int64_t Hn) {
  constexpr int64_t V = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (B == 1 || sb % V == 0) && (S == 1 || ss % V == 0) &&
         (Hn == 1 || sh % V == 0);
}

// Check the wrapper's plan against this instantiation, then launch.
template <typename T, int D, int BK>
cudaError_t launch(const Params& p, int64_t B, int64_t KVH, int warps,
                   int rows, cudaStream_t s) {
  using Gm = Geo<T, D, BK>;
  if (warps * 32 != Gm::kThreads || rows != Gm::RC ||
      p.kv_blocks != p.ktiles * p.splits ||
      p.q_blocks != (p.nrows + Gm::RC - 1) / Gm::RC)
    return cudaErrorInvalidValue;
  if (p.vec && !(rows16<T>(p.q, p.qsb, p.qss, p.qsh, B, p.Sq, p.H) &&
               rows16<T>(p.k, p.ksb, p.kss, p.ksh, B, p.Skv, KVH) &&
               rows16<T>(p.v, p.vsb, p.vss, p.vsh, B, p.Skv, KVH) &&
               rows16<T>(p.o, p.osb, p.oss, p.osh, B, p.Sq, p.H) &&
               rows16<T>(p.dO, p.gsb, p.gss, p.gsh, B, p.Sq, p.H)))
    return cudaErrorInvalidValue;
  const auto kernel = flash_bwd_kernel<T, D, BK>;
  // above 48 KB of dynamic shared memory only with the attribute
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)(p.kv_blocks + p.q_blocks), (unsigned)KVH,
                (unsigned)B),
           Gm::kThreads, Gm::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_bk(const Params& p, int64_t B, int64_t KVH, int bk,
                        int warps, int rows, cudaStream_t s) {
  switch (bk) {
    case 16: return launch<T, D, 16>(p, B, KVH, warps, rows, s);
    case 32: return launch<T, D, 32>(p, B, KVH, warps, rows, s);
    case 64: return launch<T, D, 64>(p, B, KVH, warps, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int64_t B, int64_t KVH, int64_t D,
                       int bk, int warps, int rows, cudaStream_t s) {
  switch (D) {
    case 8: return dispatch_bk<T, 8>(p, B, KVH, bk, warps, rows, s);
    case 16: return dispatch_bk<T, 16>(p, B, KVH, bk, warps, rows, s);
    case 32: return dispatch_bk<T, 32>(p, B, KVH, bk, warps, rows, s);
    case 64: return dispatch_bk<T, 64>(p, B, KVH, bk, warps, rows, s);
    case 128: return dispatch_bk<T, 128>(p, B, KVH, bk, warps, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Skv, KVH, D), o and dO: (B, Sq, H, D), one
// dtype (f32 or bf16), each with its own (b, s, h) strides and unit stride
// along D; lse: (B, H, Sq) f32 contiguous from the forward.  Writes dq
// (B, Sq, H, D), dk and dv (B, Skv, KVH, D), contiguous, in q's dtype.  The
// wrapper's plan: bk keys a KV tile (16, 32 or 64), the block's warps, its
// rows a chunk, the dK/dV splits a key tile, vec when every q/k/v/o/dO row
// is 16-byte aligned (cp.async), and the grid's dK/dV and dQ block counts;
// with splits > 1, an f32 workspace of B KVH ktiles splits 2 bk D floats and
// B KVH ktiles zeroed int counters (returned to zero).  Returns
// cudaErrorInvalidValue, launching nothing, where the plan is not this
// instantiation's; else cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv, void* ws,
    void* counters, int64_t B, int64_t H, int64_t KVH, int64_t Sq,
    int64_t Skv, int64_t D, int64_t qsb, int64_t qss, int64_t qsh,
    int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
    int64_t vsh, int64_t osb, int64_t oss, int64_t osh, int64_t gsb,
    int64_t gss, int64_t gsh, float scale, int causal, int bk, int dtype,
    int warps, int rows, int splits, int vec, int kv_blocks, int q_blocks,
    void* stream) {
  if (KVH < 1 || H % KVH || (causal && Sq > Skv) || Sq < 1 || Skv < 1 ||
      bk < 1 || Sq * (H / KVH) >= (1LL << 31) || Skv >= (1LL << 31) ||
      KVH >= 65536 || B >= 65536 || splits < 1 || splits > 64 ||
      kv_blocks < 1 || q_blocks < 1 ||
      (int64_t)kv_blocks + q_blocks >= (1LL << 31) ||
      (splits > 1 && (!ws || !counters)))
    return cudaErrorInvalidValue;
  const int64_t G = H / KVH;
  const Params p{q, k, v, o, dO, static_cast<const float*>(lse), dq, dk, dv,
                 static_cast<float*>(ws), static_cast<int*>(counters),
                 H, Sq, Skv,
                 qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh,
                 gsb, gss, gsh, scale, (int)G, (int)(Sq * G), causal, splits,
                 (int)((Skv + bk - 1) / bk), kv_blocks, q_blocks, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_d<float>(p, B, KVH, D, bk, warps, rows, s);
    case kBFloat16:
      return dispatch_d<__nv_bfloat16>(p, B, KVH, D, bk, warps, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}
