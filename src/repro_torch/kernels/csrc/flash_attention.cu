// Causal GQA flash attention forward for Hopper (sm_90a).
//
// Replaces: the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention.py:29, launched by
// flash_attention_pallas): online softmax (m, l, acc in f32) over KV tiles,
// causal mask with the queries at the caller's offset (query i sits at key
// position q_off + i, the Pallas kernel's q_offset; the wrapper passes Skv -
// Sq unless it is given another, as a rank's shard of a sequence split over
// the ranks), masked scores -1e30, the caller's
// scale (1/sqrt(dk) unless it names another: MLA's 1/sqrt(d_nope + d_rope),
// the chunked reference's softmax_scale), output acc / max(l, 1e-30) in
// q's dtype.  KV head of query head h is
// h / (H / KVH).  For the backward pass (csrc/flash_attention_bwd.cu) it
// also writes each row's log-sum-exp m + log(l) of the scaled scores, f32
// (B, H, Sq), where the caller passes a pointer for it (serving passes
// none).
//
// Bound on the H100: at the serving path's prefill (one prompt of <= 32
// tokens, head_dim 64; deepseek-v2's 128 heads at (192, 128) read about
// 5 MB) it is kilobytes to megabytes of q/k/v/o and under a megaflop per
// head, so the least time is the bytes over HBM bandwidth and the kernel
// is bound by launch and latency; at long prompts it turns compute-bound
// (2 (dk + dv) flops per (query, key) pair).
//
// Design.  One block per (batch, KV head, query tile) carries the query
// heads of the group together: its 64 rows are BQ positions x GH heads
// (row r = position r / GH, head r % GH; GH = G where G <= 64), so each K/V
// tile is read once per group, not once per query head.  The TPU walked the
// KV tiles as a sequential grid axis carrying m, l and acc in VMEM scratch;
// here a loop inside the block walks KV tiles, double-buffered in shared
// memory with cp.async so the next tile loads while this one computes.  The
// tile's keys BK are a template parameter (16, 32 or 64), the Pallas
// kernel's bk: the tuning loop's kv_chunk picks it; serving takes 32 in
// f32 and 64 in bf16.  Tiles wholly above the block's causal
// diagonal are never loaded, a warp skips the tiles above its own rows'
// diagonal, and the query tiles with the most keys are launched first.
//   - bf16: 4 warps of 16 rows.  S = Q K^T and O = P V run on the tensor
//     cores (mma.sync m16n8k16, ldmatrix fragments, f32 accumulators); P
//     stays in registers, the S accumulators repacked as the A operand of
//     P V (FlashAttention-2).  Row max and sum reduce over the 4 lanes that
//     share a row.
//   - f32: 8 warps of 8 rows, FMA.  For S a lane owns BK / 32 keys of the
//     tile (one at BK 32; at BK 16 half the lanes idle) and runs the dot
//     products over d from shared memory; the row max is a shuffle
//     butterfly; P goes to shared memory, and for P V a lane owns dv / 32
//     output dims.  No TF32, so it keeps f32 accuracy.
// Ragged Sq/Skv edges and unused rows are zero-filled and masked, so any
// length works.  The head widths are two template parameters, DK for q and
// k (S = Q K^T) and DV for v and the output (O = P V), instantiated at the
// pairs (d, d) for d in 8, 16, 32, 64, 128, and MLA's (d_nope + d_rope,
// d_v): deepseek-v2's (192, 128) and its reduced configuration's (24, 16).
// bf16 pads each width to the mma's depth of 16 with zeros (8 -> 16,
// 24 -> 32); the padding adds zero terms to Q K^T and unused columns to O,
// so the scale stays the caller's.  A (DK, DV, BK) whose staged tiles
// exceed the 227 KB of shared memory a block may opt into (f32 at
// (192, 128) with BK 64) is not instantiated: its launch returns
// cudaErrorInvalidValue, and the wrapper's plan never asks for it.

#include "common.cuh"

namespace {

constexpr int kRows = 64;  // query rows (positions x heads) per block
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt into

struct Params {
  const void *q, *k, *v;
  void* o;
  float* lse;  // (B, H, Sq) or null
  int64_t H, G, Sq, Skv;
  int64_t q_off;  // key position of query 0 (causal)
  int64_t qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  float scale;
  int causal, gh, bq, gchunks;
};

// Per-dtype layout: DPK/DPV are the staged widths of q/k and v (bf16 pads
// each to a multiple of 16), LDK/LDV the shared-memory row pitches (16 bytes
// of padding: conflict-free ldmatrix and float4 reads, rows 16-byte aligned
// for cp.async).
template <typename T, int DK, int DV, int BK>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int DPK = kBf16 ? (DK + 15) / 16 * 16 : DK;
  static constexpr int DPV = kBf16 ? (DV + 15) / 16 * 16 : DV;
  static constexpr int LDK = DPK + 16 / (int)sizeof(T);
  static constexpr int LDV = DPV + 16 / (int)sizeof(T);
  static constexpr int kWarps = kBf16 ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BKV = BK;  // keys per KV tile
  // Qs[kRows][LDK], Ks[2][BKV][LDK], Vs[2][BKV][LDV], f32: Ps[kRows][BKV]
  static constexpr int kKTile = BKV * LDK;
  static constexpr int kVTile = BKV * LDV;
  static constexpr int kBytes =
      ((kRows + 2 * BKV) * LDK + 2 * BKV * LDV) * (int)sizeof(T) +
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
      const int64_t e = p.q_off + q_last + 1;
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
    const int64_t e = p.q_off + qi + 1;
    return e < p.Skv ? e : p.Skv;
  }
};

template <typename T, int DK, int DV, int BK, bool VEC>
__device__ __forceinline__ void load_q(const Params& p, const BlockRows& br,
                                       T* Qs) {
  using L = Layout<T, DK, DV, BK>;
  const T* q = static_cast<const T*>(p.q);
  load_rows<T, DK, L::LDK, L::kThreads, VEC>(Qs, kRows, q, [&](int r) -> const T* {
    const int64_t qi = br.pos(p, r);
    return qi < 0 ? nullptr
                  : q + br.b * p.qsb + qi * p.qss + br.head(p, r) * p.qsh;
  });
}

template <typename T, int DK, int DV, int BK, bool VEC>
__device__ __forceinline__ void load_kv(const Params& p, const BlockRows& br,
                                        int64_t k0, T* Ks, T* Vs) {
  using L = Layout<T, DK, DV, BK>;
  const T* k = static_cast<const T*>(p.k) + br.b * p.ksb + br.kvh * p.ksh;
  const T* v = static_cast<const T*>(p.v) + br.b * p.vsb + br.kvh * p.vsh;
  load_rows<T, DK, L::LDK, L::kThreads, VEC>(Ks, L::BKV, k, [&](int j) -> const T* {
    return k0 + j < br.kv_end ? k + (k0 + j) * p.kss : nullptr;
  });
  load_rows<T, DV, L::LDV, L::kThreads, VEC>(Vs, L::BKV, v, [&](int j) -> const T* {
    return k0 + j < br.kv_end ? v + (k0 + j) * p.vss : nullptr;
  });
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

// Minimum one block an SM: ptxas may then keep every row's state in
// registers instead of trading spills for a second resident block.
template <int DK, int DV, int BK, bool VEC>
__global__ void __launch_bounds__(Layout<float, DK, DV, BK>::kThreads, 1)
flash_fwd_f32_kernel(Params p) {
  using L = Layout<float, DK, DV, BK>;
  constexpr int R = kRows / L::kWarps;           // rows per warp (8)
  constexpr int DPL = DV >= 32 ? DV / 32 : 1;    // output dims per lane
  constexpr int KPL = BK >= 32 ? BK / 32 : 1;    // keys per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kRows * L::LDK;               // [2][BKV][LDK]
  float* Vs = Ks + 2 * L::kKTile;                // [2][BKV][LDV]
  float* Ps = Vs + 2 * L::kVTile;                // [kRows][BKV]

  const BlockRows br(p);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = warp * R;
  int lim[R], warp_lim = 0;  // keys visible to each row (Skv < 2^31)
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lim[i] = (int)br.limit(p, br.pos(p, r0 + i));
    warp_lim = lim[i] > warp_lim ? lim[i] : warp_lim;
  }

  load_q<float, DK, DV, BK, VEC>(p, br, Qs);
  load_kv<float, DK, DV, BK, VEC>(p, br, 0, Ks, Vs);
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
      load_kv<float, DK, DV, BK, VEC>(p, br, (t + 1) * L::BKV,
                                      Ks + nb * L::kKTile,
                                      Vs + nb * L::kVTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t k0 = t * L::BKV;
    if (k0 < warp_lim) {
      const float* Kt = Ks + (t & 1) * L::kKTile;
      const float* Vt = Vs + (t & 1) * L::kVTile;
      // S: this lane's keys (lane + 32c) against the warp's R rows; lanes
      // past the tile (BK 16) read its last row and are masked
      float s[KPL][R];
#pragma unroll
      for (int c = 0; c < KPL; ++c)
#pragma unroll
        for (int i = 0; i < R; ++i) s[c][i] = 0.f;
#pragma unroll
      for (int d = 0; d < DK; d += 4) {
        float4 kv[KPL];
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int j = lane + 32 * c < BK ? lane + 32 * c : BK - 1;
          kv[c] = *reinterpret_cast<const float4*>(&Kt[j * L::LDK + d]);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(&Qs[(r0 + i) * L::LDK + d]);
#pragma unroll
          for (int c = 0; c < KPL; ++c)
            s[c][i] = fmaf(qv.x, kv[c].x, fmaf(qv.y, kv[c].y,
                      fmaf(qv.z, kv[c].z, fmaf(qv.w, kv[c].w, s[c][i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float si[KPL], mx = kNegInf;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int j = lane + 32 * c;
          si[c] = (j < BK && k0 + j < lim[i]) ? s[c][i] * p.scale : kNegInf;
          mx = fmaxf(mx, si[c]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float corr = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int j = lane + 32 * c;
          const float pi = expf(si[c] - m_new);
          if (j < BK) {
            psum += pi;
            Ps[(r0 + i) * L::BKV + j] = pi;
          }
        }
        m[i] = m_new;
        l[i] = l[i] * corr + psum;  // this lane's keys; summed at the end
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] *= corr;
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
            vv[jj][e] = d < DV ? Vt[(j + jj) * L::LDV + d] : 0.f;
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
    const int64_t head = br.head(p, r0 + i);
    if (p.lse && lane == 0)
      p.lse[(br.b * p.H + head) * p.Sq + qi] = m[i] + logf(fmaxf(li, 1e-30f));
    float* orow = o + br.b * p.osb + qi * p.oss + head * p.osh;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = lane + 32 * e;
      if (d < DV) orow[d] = acc[i][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// Minimum one block an SM, as the f32 kernel (without it ptxas spilled the
// D 32, BK 32 instantiation).
template <int DK, int DV, int BK, bool VEC>
__global__ void __launch_bounds__(Layout<__nv_bfloat16, DK, DV, BK>::kThreads, 1)
flash_fwd_bf16_kernel(Params p) {
  using T = __nv_bfloat16;
  using L = Layout<T, DK, DV, BK>;
  constexpr int DPK = L::DPK, DPV = L::DPV, LDK = L::LDK, LDV = L::LDV;
  constexpr int BKV = L::BKV;
  constexpr int KD = DPK / 16;  // k16 steps of Q K^T
  constexpr int KV = DPV / 16;  // pairs of n8 tiles of O
  constexpr int NS = BKV / 8;   // n8 tiles of S (keys), an even number
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kRows * LDK;
  T* Vs = Ks + 2 * L::kKTile;

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

  // zero the padding columns once; cp.async never writes them
  if (DPK > DK) {  // Qs and both Ks tiles share the pitch LDK
    for (int i = threadIdx.x; i < kRows + 2 * BKV; i += L::kThreads)
      for (int c = DK; c < DPK; ++c) Qs[i * LDK + c] = __float2bfloat16(0.f);
  }
  if (DPV > DV) {
    for (int i = threadIdx.x; i < 2 * BKV; i += L::kThreads)
      for (int c = DV; c < DPV; ++c) Vs[i * LDV + c] = __float2bfloat16(0.f);
  }
  load_q<T, DK, DV, BK, VEC>(p, br, Qs);
  load_kv<T, DK, DV, BK, VEC>(p, br, 0, Ks, Vs);
  cp_async_commit();

  uint32_t qa[KD][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2 * KV][4];
#pragma unroll
  for (int j = 0; j < 2 * KV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int64_t ntiles = (br.kv_end + BKV - 1) / BKV;
  for (int64_t t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      const int nb = (int)((t + 1) & 1);
      load_kv<T, DK, DV, BK, VEC>(p, br, (t + 1) * BKV, Ks + nb * L::kKTile,
                                  Vs + nb * L::kVTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qa[kd], Qs + (r0 + (lane & 15)) * LDK + kd * 16 +
                                (lane >> 4) * 8);
    }
    const int64_t k0 = t * BKV;
    if (k0 < warp_lim) {
      const T* Kt = Ks + (t & 1) * L::kKTile;
      const T* Vt = Vs + (t & 1) * L::kVTile;
      // S = Q K^T: 16 rows x BK keys = BK / 8 n8 tiles
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
          ldmatrix_x4(r, Kt + (pr * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
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
        for (int j = 0; j < 2 * KV; ++j) {
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
        for (int dp = 0; dp < KV; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Vt + (kk * 16 + (lane & 15)) * LDV + dp * 16 +
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
    const int64_t head = br.head(p, r0 + lane / 4 + 8 * h);
    if (p.lse && lane % 4 == 0)
      p.lse[(br.b * p.H + head) * p.Sq + pos[h]] =
          m[h] + logf(fmaxf(lh, 1e-30f));
    T* orow = o + br.b * p.osb + pos[h] * p.oss + head * p.osh;
#pragma unroll
    for (int j = 0; j < 2 * KV; ++j) {
      const int d = j * 8 + (lane % 4) * 2;
      if (d < DV)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

template <int DK, int DV, int BK, bool VEC>
auto flash_kernel(float*) { return flash_fwd_f32_kernel<DK, DV, BK, VEC>; }
template <int DK, int DV, int BK, bool VEC>
auto flash_kernel(__nv_bfloat16*) {
  return flash_fwd_bf16_kernel<DK, DV, BK, VEC>;
}

template <typename T, int DK, int DV, int BK, bool VEC>
cudaError_t launch(const Params& p, int64_t B, int64_t KVH, int64_t qtiles,
                   cudaStream_t stream) {
  using L = Layout<T, DK, DV, BK>;
  if constexpr (L::kBytes > kMaxSmem) {
    return cudaErrorInvalidValue;  // not instantiated: tiles too large
  } else {
    const auto kernel =
        flash_kernel<DK, DV, BK, VEC>(static_cast<T*>(nullptr));
    // above 48 KB of dynamic shared memory only with the attribute (per
    // device)
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)(qtiles * p.gchunks), (unsigned)KVH,
                    (unsigned)B);
    kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
    return cudaGetLastError();
  }
}

// the instantiated (DK, DV) pairs (kernels/flash_attention.py HEAD_DIM_PAIRS)
template <typename T, int BK, bool VEC>
cudaError_t dispatch_d(const Params& p, int64_t B, int64_t KVH, int64_t DK,
                       int64_t DV, int64_t qtiles, cudaStream_t s) {
#define FLASH_PAIR(dk, dv) \
  if (DK == dk && DV == dv) return launch<T, dk, dv, BK, VEC>(p, B, KVH, qtiles, s)
  FLASH_PAIR(8, 8);
  FLASH_PAIR(16, 16);
  FLASH_PAIR(32, 32);
  FLASH_PAIR(64, 64);
  FLASH_PAIR(128, 128);
  FLASH_PAIR(192, 128);
  FLASH_PAIR(24, 16);
#undef FLASH_PAIR
  return cudaErrorInvalidValue;
}

template <typename T, bool VEC>
cudaError_t dispatch_bk(const Params& p, int64_t B, int64_t KVH, int64_t DK,
                        int64_t DV, int64_t qtiles, int bk, cudaStream_t s) {
  switch (bk) {
    case 16: return dispatch_d<T, 16, VEC>(p, B, KVH, DK, DV, qtiles, s);
    case 32: return dispatch_d<T, 32, VEC>(p, B, KVH, DK, DV, qtiles, s);
    case 64: return dispatch_d<T, 64, VEC>(p, B, KVH, DK, DV, qtiles, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_vec(const Params& p, int64_t B, int64_t KVH, int64_t DK,
                         int64_t DV, int64_t qtiles, int bk, int vec,
                         cudaStream_t s) {
  return vec ? dispatch_bk<T, true>(p, B, KVH, DK, DV, qtiles, bk, s)
             : dispatch_bk<T, false>(p, B, KVH, DK, DV, qtiles, bk, s);
}

}  // namespace

// q: (B, Sq, H, DK), k: (B, Skv, KVH, DK), v: (B, Skv, KVH, DV), o: (B, Sq,
// H, DV), each with its own (b, s, h) strides and unit stride along the
// head width; o in q's dtype; lse (B, H, Sq) f32 contiguous, or null.
// q_off: the key position of query 0 under causal (0 <= q_off, q_off + Sq
// <= Skv; Skv - Sq: the queries are the sequence's last).  The
// wrapper's plan: gh query heads of a group times bq positions per block
// (gh * bq <= 64), bk keys per KV tile (16, 32 or 64), and vec when every
// q/k/v row is 16-byte aligned (cp.async).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a pair or tile not instantiated).
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t B,
    int64_t H, int64_t KVH, int64_t Sq, int64_t Skv, int64_t DK, int64_t DV,
    int64_t q_off, int64_t qsb,
    int64_t qss, int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
    int64_t vsb, int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
    int64_t osh, float scale, int causal, int gh, int bq, int bk, int vec,
    int dtype, void* stream) {
  const int64_t G = H / KVH;
  if (gh < 1 || bq < 1 || (int64_t)gh * bq > kRows || gh > G ||
      (causal && (q_off < 0 || q_off + Sq > Skv)))
    return cudaErrorInvalidValue;
  const int gchunks = (int)((G + gh - 1) / gh);
  const int64_t qtiles = (Sq + bq - 1) / bq;
  if (qtiles * gchunks >= (1LL << 31) || KVH >= 65536 || B >= 65536)
    return cudaErrorInvalidValue;
  const Params p{q,   k,   v,   o,   static_cast<float*>(lse), H,   G,
                 Sq,  Skv, q_off, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                 vsh, osb, oss, osh, scale, causal, gh,  bq,  gchunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_vec<float>(p, B, KVH, DK, DV, qtiles, bk, vec, s);
    case kBFloat16:
      return dispatch_vec<__nv_bfloat16>(p, B, KVH, DK, DV, qtiles, bk, vec,
                                         s);
    default:
      return cudaErrorInvalidValue;
  }
}
