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
// tokens, head_dim 64) it is a few hundred kilobytes of q/k/v/o and under a
// megaflop per head, so the least time is the bytes over HBM bandwidth and
// the kernel is bound by launch and latency; at long prompts it turns
// compute-bound (4*d flops per (query, key) pair).
//
// Design.  One block per (batch, KV head, query tile) carries the query
// heads of the group together: its 64 rows are BQ positions x GH heads
// (row r = position r / GH, head r % GH; GH = G where G <= 64), so each K/V
// tile is read once per group, not once per query head.  The TPU walked the
// KV tiles as a sequential grid axis carrying m, l and acc in VMEM scratch;
// here a loop inside the block walks KV tiles (32 keys in f32, 64 in
// bf16), double-buffered in shared memory with cp.async so the next tile
// loads while this one computes.  Tiles wholly above the block's causal
// diagonal are never loaded, a warp skips the tiles above its own rows'
// diagonal, and the query tiles with the most keys are launched first.
//   - bf16: 4 warps of 16 rows.  S = Q K^T and O = P V run on the tensor
//     cores (mma.sync m16n8k16, ldmatrix fragments, f32 accumulators); P
//     stays in registers, the S accumulators repacked as the A operand of
//     P V (FlashAttention-2).  Row max and sum reduce over the 4 lanes that
//     share a row.
//   - f32: 8 warps of 8 rows, FMA.  For S a lane owns one key of the tile
//     and runs the dot products over d from shared memory; the row max is a
//     shuffle butterfly; P goes to shared memory, and for P V a lane owns
//     d / 32 output dims.  No TF32, so it keeps f32 accuracy.
// Ragged Sq/Skv edges and unused rows are zero-filled and masked, so any
// length works.  head_dim is a template parameter (8, 16, 32, 64, 128); bf16
// pads d = 8 to the mma's depth of 16 with zeros.

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // query rows (positions x heads) per block
constexpr float kNegInf = -1e30f;

struct Params {
  const void *q, *k, *v;
  void* o;
  int64_t H, G, Sq, Skv;
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
  int causal, gh, bq, gchunks;
};

// Per-dtype layout: DP is the staged head width (bf16 pads 8 to 16), LD the
// shared-memory row pitch (16 bytes of padding: conflict-free ldmatrix and
// float4 reads, rows 16-byte aligned for cp.async).
template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int DP = (kBf16 && D < 16) ? 16 : D;
  static constexpr int LD = DP + 16 / (int)sizeof(T);
  static constexpr int kWarps = kBf16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  // keys per KV tile: f32 gives each lane one key; bf16 takes 64 (four
  // k16 steps of P V) to halve the barriers per key
  static constexpr int BKV = kBf16 ? 64 : 32;
  // Qs[kRows][LD], Ks[2][BKV][LD], Vs[2][BKV][LD], f32: Ps[kRows][BKV]
  static constexpr int kTileElems = BKV * LD;
  static constexpr int kBytes =
      (kRows + 4 * BKV) * LD * (int)sizeof(T) +
      (kBf16 ? 0 : kRows * BKV * (int)sizeof(float));
};

// Copy `rows` rows of D elements (row r at src(r), nullptr = zero fill) into
// dst[r * LD + 0 .. D).  VEC: 16-byte aligned rows -> cp.async (a zero fill
// still names a global address, `base`, and reads nothing from it).
template <typename T, int D, int LD, int NT, bool VEC, typename Src>
__device__ __forceinline__ void load_rows(T* dst, int rows, const T* base,
                                          Src src) {
  constexpr int V = Vec<T>::N, CH = D / V;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < rows * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * V;
      const T* g = src(r);
      cp_async16(dst + r * LD + c, g ? g + c : base, g ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, c = i % D;
      const T* g = src(r);
      dst[r * LD + c] = g ? g[c] : from_f<T>(0.f);
    }
  }
}

// Block set-up shared by both kernels: which rows, which keys.
struct BlockRows {
  int64_t b, kvh, q0, g0, kv_end;
  int rows;  // rows in use (bq * gh)

  __device__ BlockRows(const Params& p) {
    b = blockIdx.z;
    kvh = blockIdx.y;
    // the last query tiles see the most keys: launch them first, so that
    // the longest blocks do not start in the grid's tail
    const int64_t qtiles = (p.Sq + p.bq - 1) / p.bq;
    q0 = (qtiles - 1 - (int64_t)(blockIdx.x / p.gchunks)) * p.bq;
    g0 = (int64_t)(blockIdx.x % p.gchunks) * p.gh;
    rows = p.bq * p.gh;
    const int64_t q_last = (q0 + p.bq < p.Sq ? q0 + p.bq : p.Sq) - 1;
    kv_end = p.Skv;
    if (p.causal) {
      const int64_t e = p.Skv - p.Sq + q_last + 1;
      kv_end = e < p.Skv ? e : p.Skv;
    }
  }
  // position (or -1 if the row is unused) and query head of row r
  __device__ int64_t pos(const Params& p, int r) const {
    const int64_t qi = q0 + r / p.gh, g = g0 + r % p.gh;
    return (r < rows && qi < p.Sq && g < p.G) ? qi : -1;
  }
  __device__ int64_t head(const Params& p, int r) const {
    return kvh * p.G + g0 + r % p.gh;
  }
  // keys [0, limit) are visible to a row at position qi (0 for unused rows)
  __device__ int64_t limit(const Params& p, int64_t qi) const {
    if (qi < 0) return 0;
    if (!p.causal) return p.Skv;
    const int64_t e = p.Skv - p.Sq + qi + 1;
    return e < p.Skv ? e : p.Skv;
  }
};

template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_q(const Params& p, const BlockRows& br,
                                       T* Qs) {
  using L = Layout<T, D>;
  const T* q = static_cast<const T*>(p.q);
  load_rows<T, D, L::LD, L::kThreads, VEC>(Qs, kRows, q, [&](int r) -> const T* {
    const int64_t qi = br.pos(p, r);
    return qi < 0 ? nullptr
                  : q + br.b * p.qsb + qi * p.qss + br.head(p, r) * p.qsh;
  });
}

template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_kv(const Params& p, const BlockRows& br,
                                        int64_t k0, T* Ks, T* Vs) {
  using L = Layout<T, D>;
  const T* k = static_cast<const T*>(p.k) + br.b * p.ksb + br.kvh * p.ksh;
  const T* v = static_cast<const T*>(p.v) + br.b * p.vsb + br.kvh * p.vsh;
  load_rows<T, D, L::LD, L::kThreads, VEC>(Ks, L::BKV, k, [&](int j) -> const T* {
    return k0 + j < br.kv_end ? k + (k0 + j) * p.kss : nullptr;
  });
  load_rows<T, D, L::LD, L::kThreads, VEC>(Vs, L::BKV, v, [&](int j) -> const T* {
    return k0 + j < br.kv_end ? v + (k0 + j) * p.vss : nullptr;
  });
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

// Minimum one block an SM: ptxas may then keep every row's state in
// registers instead of trading spills for a second resident block.
template <int D, bool VEC>
__global__ void __launch_bounds__(Layout<float, D>::kThreads, 1)
flash_fwd_f32_kernel(Params p) {
  using L = Layout<float, D>;
  constexpr int R = kRows / L::kWarps;           // rows per warp (8)
  constexpr int DPL = D >= 32 ? D / 32 : 1;      // output dims per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  static_assert(L::BKV == 32, "a lane owns one key of the tile");
  float* Ks = Qs + kRows * L::LD;                // [2][BKV][LD]
  float* Vs = Ks + 2 * L::kTileElems;
  float* Ps = Vs + 2 * L::kTileElems;            // [kRows][BKV]

  const BlockRows br(p);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * R;
  int lim[R], warp_lim = 0;  // keys visible to each row (Skv < 2^31)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lim[i] = (int)br.limit(p, br.pos(p, r0 + i));
    warp_lim = lim[i] > warp_lim ? lim[i] : warp_lim;
  }

  load_q<float, D, VEC>(p, br, Qs);
  load_kv<float, D, VEC>(p, br, 0, Ks, Vs);
  cp_async_commit();

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const int64_t ntiles = (br.kv_end + L::BKV - 1) / L::BKV;
  for (int64_t t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (int)((t + 1) & 1);
      load_kv<float, D, VEC>(p, br, (t + 1) * L::BKV, Ks + nb * L::kTileElems,
                             Vs + nb * L::kTileElems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t k0 = t * L::BKV;
    if (k0 < warp_lim) {
      const float* Kt = Ks + (t & 1) * L::kTileElems;
      const float* Vt = Vs + (t & 1) * L::kTileElems;
      // S: this lane's key against the warp's R rows
      float s[R];
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&Kt[lane * L::LD + d]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&Qs[(r0 + i) * L::LD + d]);
          s[i] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y,
                 fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[i]))));
        }
      }
      const int64_t key = k0 + lane;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float si = key < lim[i] ? s[i] * p.scale : kNegInf;
        float mx = si;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        const float pi = expf(si - m_new);
        m[i] = m_new;
        l[i] = l[i] * corr + pi;  // this lane's keys; summed at the end
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
        Ps[(r0 + i) * L::BKV + lane] = pi;
      }
      __syncwarp();
      // O += P V: lane owns dims lane, lane + 32, ...
      const int64_t kn64 = warp_lim - k0;
      const int kn = kn64 < L::BKV ? (int)kn64 : L::BKV;
      for (int j = 0; j < kn; j += 4) {
        float vv[4][DPL];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            vv[jj][e] = d < D ? Vt[(j + jj) * L::LD + d] : 0.f;
          }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 pv =
              *reinterpret_cast<const float4*>(&Ps[(r0 + i) * L::BKV + j]);
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            acc[i][e] = fmaf(pv.x, vv[0][e], fmaf(pv.y, vv[1][e],
                        fmaf(pv.z, vv[2][e], fmaf(pv.w, vv[3][e], acc[i][e]))));
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int64_t qi = br.pos(p, r0 + i);
    if (qi < 0) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    float* orow = o + br.b * p.osb + qi * p.oss + br.head(p, r0 + i) * p.osh;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) orow[d] = acc[i][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

template <int D, bool VEC>
__global__ void __launch_bounds__(Layout<__nv_bfloat16, D>::kThreads)
flash_fwd_bf16_kernel(Params p) {
  using T = __nv_bfloat16;
  using L = Layout<T, D>;
  constexpr int DP = L::DP, LD = L::LD, BKV = L::BKV;
  constexpr int KD = DP / 16;  // k16 steps of Q K^T; pairs of n8 tiles of O
  constexpr int NS = BKV / 8;  // n8 tiles of S (keys)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kRows * LD;
  T* Vs = Ks + 2 * L::kTileElems;

  const BlockRows br(p);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * 16;
  // this thread's two rows: r0 + lane / 4 and r0 + lane / 4 + 8
  int64_t pos[2];
  int lim[2];  // keys visible to each row (Skv < 2^31)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = br.pos(p, r0 + lane / 4 + 8 * h);
    lim[h] = (int)br.limit(p, pos[h]);
  }
  int64_t warp_lim = 0;
  for (int r = 0; r < 16; ++r) {
    const int64_t e = br.limit(p, br.pos(p, r0 + r));
    warp_lim = e > warp_lim ? e : warp_lim;
  }

  if (DP > D) {  // zero the padding columns once; cp.async never writes them
    for (int i = threadIdx.x; i < kRows + 4 * BKV; i += L::kThreads)
      for (int c = D; c < DP; ++c) Qs[i * LD + c] = __float2bfloat16(0.f);
  }
  load_q<T, D, VEC>(p, br, Qs);
  load_kv<T, D, VEC>(p, br, 0, Ks, Vs);
  cp_async_commit();

  uint32_t qa[KD][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int64_t ntiles = (br.kv_end + BKV - 1) / BKV;
  for (int64_t t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (int)((t + 1) & 1);
      load_kv<T, D, VEC>(p, br, (t + 1) * BKV, Ks + nb * L::kTileElems,
                         Vs + nb * L::kTileElems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qa[kd], Qs + (r0 + (lane & 15)) * LD + kd * 16 +
                                (lane >> 4) * 8);
    }
    const int64_t k0 = t * BKV;
    if (k0 < warp_lim) {
      const T* Kt = Ks + (t & 1) * L::kTileElems;
      const T* Vt = Vs + (t & 1) * L::kTileElems;
      // S = Q K^T: 16 rows x 64 keys = 8 n8 tiles
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int pr = 0; pr < NS / 2; ++pr) {
          uint32_t r[4];
          ldmatrix_x4(r, Kt + (pr * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                             kd * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * pr], qa[kd], r[0], r[1]);
          mma_bf16_16816(s[2 * pr + 1], qa[kd], r[2], r[3]);
        }
      // scale, mask, online softmax (rows h = 0, 1 of this thread)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t key = k0 + j * 8 + (lane % 4) * 2 + e;
            float& x = s[j][2 * h + e];
            x = key < lim[h] ? x * p.scale : kNegInf;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float corr = __expf(m[h] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * h + e];
            x = __expf(x - m_new);
            sum += x;
          }
        m[h] = m_new;
        l[h] = l[h] * corr + sum;  // this lane's keys; summed at the end
#pragma unroll
        for (int j = 0; j < 2 * KD; ++j) {
          acc[j][2 * h] *= corr;
          acc[j][2 * h + 1] *= corr;
        }
      }
      // O += P V: P (bf16) from the S accumulators, V by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Vt + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                   (lane >> 4) * 8);
          mma_bf16_16816(acc[2 * dp], a, r[0], r[1]);
          mma_bf16_16816(acc[2 * dp + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    if (pos[h] < 0) continue;
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    T* orow = o + br.b * p.osb + pos[h] * p.oss +
              br.head(p, r0 + lane / 4 + 8 * h) * p.osh;
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j) {
      const int d = j * 8 + (lane % 4) * 2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

template <int D, bool VEC>
auto flash_kernel(float*) { return flash_fwd_f32_kernel<D, VEC>; }
template <int D, bool VEC>
auto flash_kernel(__nv_bfloat16*) { return flash_fwd_bf16_kernel<D, VEC>; }

template <typename T, int D, bool VEC>
cudaError_t launch(const Params& p, int64_t B, int64_t KVH, int64_t qtiles,
                   cudaStream_t stream) {
  using L = Layout<T, D>;
  const auto kernel = flash_kernel<D, VEC>(static_cast<T*>(nullptr));
  // above 48 KB of dynamic shared memory only with the attribute (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)(qtiles * p.gchunks), (unsigned)KVH, (unsigned)B);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t dispatch_d(const Params& p, int64_t B, int64_t KVH, int64_t D,
                       int64_t qtiles, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8, VEC>(p, B, KVH, qtiles, s);
    case 16: return launch<T, 16, VEC>(p, B, KVH, qtiles, s);
    case 32: return launch<T, 32, VEC>(p, B, KVH, qtiles, s);
    case 64: return launch<T, 64, VEC>(p, B, KVH, qtiles, s);
    case 128: return launch<T, 128, VEC>(p, B, KVH, qtiles, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_vec(const Params& p, int64_t B, int64_t KVH, int64_t D,
                         int64_t qtiles, int vec, cudaStream_t s) {
  return vec ? dispatch_d<T, true>(p, B, KVH, D, qtiles, s)
             : dispatch_d<T, false>(p, B, KVH, D, qtiles, s);
}

}  // namespace

// q/o: (B, Sq, H, D), k/v: (B, Skv, KVH, D), each with its own (b, s, h)
// strides and unit stride along D; o in q's dtype.  The wrapper's plan: gh
// query heads of a group times bq positions per block (gh * bq <= 64), and
// vec when every q/k/v row is 16-byte aligned (cp.async).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t H, int64_t KVH, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, float scale, int causal, int gh, int bq, int vec, int dtype,
    void* stream) {
  const int64_t G = H / KVH;
  if (gh < 1 || bq < 1 || (int64_t)gh * bq > kRows || gh > G)
    return cudaErrorInvalidValue;
  const int gchunks = (int)((G + gh - 1) / gh);
  const int64_t qtiles = (Sq + bq - 1) / bq;
  if (qtiles * gchunks >= (1LL << 31) || KVH >= 65536 || B >= 65536)
    return cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   H,   G,   Sq,  Skv, qsb,   qss,    qsh,
                 ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, scale, causal,
                 gh,  bq,  gchunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_vec<float>(p, B, KVH, D, qtiles, vec, s);
    case kBFloat16:
      return dispatch_vec<__nv_bfloat16>(p, B, KVH, D, qtiles, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}
