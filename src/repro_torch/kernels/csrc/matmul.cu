// Matrix product C = A * B for Hopper (sm_90a): a skinny-M streaming path
// and a pipelined tile path behind one C entry point.
//
// Replaces: the Pallas kernel _matmul_kernel (src/repro/kernels/matmul.py:24,
// launched by matmul_pallas): (M,K) x (K,N) -> (M,N) in A's dtype with an f32
// accumulator.
//
// Bound on the H100.  The serving path multiplies a few rows (decode M = 4,
// prefill M <= 31, the prefill head M = 1) by weights read from HBM: M rows
// give 2M flops per weight element, at most 16 flop/byte in f32, under the
// card's ~20 flop/byte f32 balance (67 TFLOP/s over 3.35 TB/s).  So there
// the least time is the weight bytes over HBM bandwidth, and the goal is to
// stream B once at near-peak bandwidth.  At large M (long prompts, training)
// the product turns compute-bound: f32 at the 67 TFLOP/s FMA rate, bf16 at
// the 989 TFLOP/s tensor-core rate.
//
// Path (a), skinny M (the wrapper sends M <= SKINNY_MAX_M here).  A block
// stages its MT rows of A (f32, zero-padded) in shared memory for its K
// range, then streams B with 16-byte loads, several in flight per thread,
// with FMA in f32:
//   - B with unit stride along N (the projections): a warp's lanes run along
//     N (16 bytes each), the block's 8 warps take interleaved rows of its K
//     range, and shared memory sums the 8 warps' partial rows;
//   - B with unit stride along K (the tied head's embed.T, read in place): a
//     warp owns 8 output columns (4 where MT > 4), its lanes run along K,
//     and a shuffle butterfly sums the lanes.
// Where N alone gives too few blocks for the 132 SMs, the wrapper splits K
// over blockIdx.y.  Each split writes its f32 partial tile to a scratch
// buffer; the last block to arrive for a tile (an atomic counter per tile)
// sums the partials in split order and writes C, then returns the counter
// to zero.  No float atomics: the result is the same bits on every call, and
// one call is one launch with no memset.
//
// Path (b), general M: 128x128 output tiles, a ring of shared-memory stages
// filled with cp.async (zero-filled at the edges) so the next K tiles load
// while this one computes.  bf16 runs on the tensor cores (mma.sync
// m16n8k16, ldmatrix fragments, f32 accumulators; 3 stages of 64-deep
// tiles, 107 KB).  f32 stays on FMA (8x8 outputs a thread, 3 stages of
// 16-deep tiles, 60 KB): no TF32, so it keeps f32 accuracy.  wgmma with a
// TMA producer warp is later work.
//
// The bf16 weight gradient dW = A^T dC reads A along M (A^T of a row-major
// activation: unit stride along M).  Where that is 16-byte aligned, A's tile
// is staged M-contiguous, [BK][BM + pad], by cp.async like a row-major B's,
// and its fragments read with ldmatrix.trans (ACOL).  Its K is the tokens
// (tens of thousands) and its output a few hundred squared, fewer tiles than
// the card holds blocks: the wrapper then splits K over blockIdx.z, each
// split writes its f32 128x128 partial tile to scratch, and the last block
// of a tile sums the partials in split order into C (as path (a) does).
//
// Both paths mask every edge, so any M, N and K works, and take A and B by
// strides.  The wrapper picks the path and geometry (kernels/matmul.py
// plan_matmul) and a scalar-load variant where a pointer or stride is not
// 16-byte aligned for the vector loads.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// path (a): skinny M
// ---------------------------------------------------------------------------

constexpr int kSkThreads = 256, kSkWarps = 8;
constexpr int kAStage = 8192;  // most floats of A a block stages (32 KB)
// K-contiguous B: output columns per warp (fewer at large MT, where the
// accumulators take the registers)
__host__ __device__ constexpr int cols_per_warp(int mt) {
  return mt <= 4 ? 8 : 4;
}

// V elements p[0], p[stride], ... as floats; elements at index >= lim are 0.
// With VEC (unit stride, 16-byte aligned) a full vector is one 16-byte load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_v(const T* p, int64_t stride, int lim,
                                       float* out) {
  constexpr int V = Vec<T>::N;
  if (VEC && lim >= V) {
    unpack16(__ldg(reinterpret_cast<const uint4*>(p)), out, T());
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = i < lim ? to_f(p[i * stride]) : 0.f;
}

// Stage A[m0 + m][k0 + kk] (m < MT, kk < kc) as f32 into As, zero outside
// (M, kn).  KMAJOR: As[kk * MT + m]; else As[m * kc + kk].
template <typename T, int MT, bool KMAJOR>
__device__ __forceinline__ void stage_a(float* As, const T* A, int64_t m0,
                                        int64_t M, int64_t k0, int kn,
                                        int kc, int64_t sam, int64_t sak) {
  for (int i = threadIdx.x; i < MT * kc; i += kSkThreads) {
    const int m = i / kc, kk = i % kc;
    const float x = (m0 + m < M && kk < kn)
                        ? to_f(A[(m0 + m) * sam + (k0 + kk) * sak]) : 0.f;
    As[KMAJOR ? kk * MT + m : i] = x;
  }
}

// Write one output value: to C, or to this split's partial tile.
template <typename T>
__device__ __forceinline__ void emit(T* C, float* part, int64_t M, int64_t N,
                                     int split, int splits, int64_t m,
                                     int64_t n, float v) {
  if (splits == 1)
    C[m * N + n] = from_f<T>(v);
  else
    part[((int64_t)split * M + m) * N + n] = v;
}

// Split-K: after this block wrote its partial tile, whether it is the last
// of the tile's splits to arrive (then the partials are all visible to it).
__device__ __forceinline__ bool last_split(int* counter, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Split-K epilogue: the last block of a tile's splits sums their partials in
// split order into C, then zeroes the tile's counter for the next call.
template <typename T, int MT>
__device__ __forceinline__ void finish_splits(
    T* C, const float* part, int* counter, int64_t M, int64_t N, int splits,
    int64_t m0, int64_t n0, int tile_n) {
  if (!last_split(counter, splits)) return;
  for (int i = threadIdx.x; i < MT * tile_n; i += kSkThreads) {
    const int64_t m = m0 + i / tile_n, n = n0 + i % tile_n;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll 8  // independent loads in flight; the sum keeps split order
    for (int sp = 0; sp < splits; ++sp)
      s += __ldcg(part + ((int64_t)sp * M + m) * N + n);
    C[m * N + n] = from_f<T>(s);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// MT rows of A from shared memory at k-row kk (As[kk * MT + m]).
template <int MT>
__device__ __forceinline__ void a_rows(const float* As, int kk, float* a) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int m = 0; m < MT; m += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&As[kk * MT + m]);
      a[m] = x.x; a[m + 1] = x.y; a[m + 2] = x.z; a[m + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) a[m] = As[kk * MT + m];
  }
}

// Both skinny kernels walk their output tiles with a stride of gridDim.x
// (the wrapper may launch fewer blocks than tiles), restaging A only when
// a tile needs other rows of it.

// B with unit stride along N (or any strides, VEC = false).
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(kSkThreads)
skinny_rowb_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, float* __restrict__ part,
                   int* __restrict__ counters, int64_t M, int64_t N,
                   int64_t K, int64_t sam, int64_t sak, int64_t sbk,
                   int64_t sbn, int kchunk, int splits, int mchunks,
                   int tiles) {
  // U rows of B in flight per warp; the scalar variant keeps fewer (its
  // element loads hold more registers)
  constexpr int V = Vec<T>::N, BN = 32 * V, U = !VEC ? 2 : MT <= 4 ? 8 : 4;
  extern __shared__ __align__(16) float As[];  // [kchunk][MT]
  __shared__ float red[kSkWarps][BN];

  const int split = blockIdx.y;
  const int64_t k0 = (int64_t)split * kchunk;
  const int kn = (int)(K - k0 < kchunk ? K - k0 : kchunk);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int staged = -1;  // the m chunk whose rows of A are in As

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mc = tile % mchunks;
    const int64_t m0 = (int64_t)mc * MT;
    const int64_t n0 = (int64_t)(tile / mchunks) * BN;
    if (mc != staged) {
      __syncthreads();  // every warp is done with the rows staged before
      stage_a<T, MT, true>(As, A, m0, M, k0, kn, kn, sam, sak);
      __syncthreads();
      staged = mc;
    }

    const int64_t n = n0 + lane * V;
    const int nlim = (int)(N - n < V ? (N - n < 0 ? 0 : N - n) : V);
    float acc[MT][V];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

    for (int kb = warp; kb < kn; kb += kSkWarps * U) {
      float bv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kb + u * kSkWarps;
        load_v<T, VEC>(B + (k0 + kk) * sbk + n * sbn, sbn,
                       kk < kn ? nlim : 0, bv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kb + u * kSkWarps;
        if (kk >= kn) break;
        float a[MT];
        a_rows<MT>(As, kk, a);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[m][v] = fmaf(a[m], bv[u][v], acc[m][v]);
      }
    }

    // sum the 8 warps' rows: thread t < BN owns column n0 + t
    float out[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int v = 0; v < V; ++v) red[warp][lane * V + v] = acc[m][v];
      __syncthreads();
      float s = 0.f;
      if (threadIdx.x < BN) {
#pragma unroll
        for (int w = 0; w < kSkWarps; ++w) s += red[w][threadIdx.x];
      }
      out[m] = s;
      __syncthreads();
    }
    const int64_t nc = n0 + threadIdx.x;
    if (threadIdx.x < BN && nc < N) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M)
          emit(C, part, M, N, split, splits, m0 + m, nc, out[m]);
    }
    if (splits > 1)
      finish_splits<T, MT>(C, part, counters + tile, M, N, splits, m0, n0,
                           BN);
  }
}

// B with unit stride along K (the tied head's embed.T).
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(kSkThreads)
skinny_colb_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, float* __restrict__ part,
                   int* __restrict__ counters, int64_t M, int64_t N,
                   int64_t K, int64_t sam, int64_t sak, int64_t sbk,
                   int64_t sbn, int kchunk, int splits, int mchunks,
                   int tiles) {
  constexpr int V = Vec<T>::N, CPW = cols_per_warp(MT), BN = kSkWarps * CPW;
  extern __shared__ __align__(16) float As[];  // [MT][kchunk]

  const int split = blockIdx.y;
  const int64_t k0 = (int64_t)split * kchunk;
  const int kn = (int)(K - k0 < kchunk ? K - k0 : kchunk);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int staged = -1;  // the m chunk whose rows of A are in As

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mc = tile % mchunks;
    const int64_t m0 = (int64_t)mc * MT;
    const int64_t n0 = (int64_t)(tile / mchunks) * BN;
    if (mc != staged) {
      __syncthreads();  // every warp is done with the rows staged before
      stage_a<T, MT, false>(As, A, m0, M, k0, kn, kchunk, sam, sak);
      __syncthreads();
      staged = mc;
    }

    const int64_t nw = n0 + warp * CPW;
    float acc[MT][CPW];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPW; ++c) acc[m][c] = 0.f;

    // columns loaded per batch: all CPW, or half in the scalar variant,
    // whose element loads would otherwise spill
    constexpr int CB = VEC ? CPW : CPW / 2;
#pragma unroll(VEC ? 2 : 1)
    for (int kk = lane * V; kk < kn; kk += 32 * V) {
      const int klim = kn - kk < V ? kn - kk : V;
#pragma unroll
      for (int c0 = 0; c0 < CPW; c0 += CB) {
        float bv[CB][V];
#pragma unroll
        for (int c = 0; c < CB; ++c)
          load_v<T, VEC>(B + (nw + c0 + c) * sbn + (k0 + kk) * sbk, sbk,
                         nw + c0 + c < N ? klim : 0, bv[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float a[V];
#pragma unroll
          for (int v = 0; v < V; v += 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                &As[m * kchunk + kk + v]);
            a[v] = x.x; a[v + 1] = x.y; a[v + 2] = x.z; a[v + 3] = x.w;
          }
#pragma unroll
          for (int c = 0; c < CB; ++c)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[m][c0 + c] = fmaf(a[v], bv[c][v], acc[m][c0 + c]);
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        float s = acc[m][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == (m * CPW + c) % 32 && m0 + m < M && nw + c < N)
          emit(C, part, M, N, split, splits, m0 + m, nw + c, s);
      }
    if (splits > 1)
      finish_splits<T, MT>(C, part, counters + tile, M, N, splits, m0, n0,
                           BN);
  }
}

template <typename T, int MT, bool COLB, bool VEC>
cudaError_t launch_skinny(const T* A, const T* B, T* C, float* part,
                          int* counters, int64_t M, int64_t N, int64_t K,
                          int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                          int kchunk, int splits, int blocks,
                          int64_t plan_tiles, int64_t plan_bn,
                          cudaStream_t s) {
  constexpr int BN = COLB ? kSkWarps * cols_per_warp(MT) : 32 * Vec<T>::N;
  const int64_t mchunks = (M + MT - 1) / MT, ntiles = (N + BN - 1) / BN;
  const int64_t tiles = mchunks * ntiles;
  // the wrapper sized the counters from its own tile count: it must be ours
  if (plan_tiles != tiles || plan_bn != BN) return cudaErrorInvalidValue;
  if ((int64_t)MT * kchunk > kAStage || kchunk % 32 || tiles >= (1LL << 31) ||
      blocks < 1 || blocks > tiles || splits < 1 || splits >= 65536 ||
      (int64_t)kchunk * splits < K)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)splits);
  // A's stage is sized to the block's K range (<= 32 KB), not the most it
  // could be, so that more blocks fit an SM
  const size_t smem = (size_t)MT * kchunk * sizeof(float);
  if (COLB)
    skinny_colb_kernel<T, MT, VEC><<<grid, kSkThreads, smem, s>>>(
        A, B, C, part, counters, M, N, K, sam, sak, sbk, sbn, kchunk, splits,
        (int)mchunks, (int)tiles);
  else
    skinny_rowb_kernel<T, MT, VEC><<<grid, kSkThreads, smem, s>>>(
        A, B, C, part, counters, M, N, K, sam, sak, sbk, sbn, kchunk, splits,
        (int)mchunks, (int)tiles);
  return cudaGetLastError();
}

template <typename T, bool COLB, bool VEC>
cudaError_t skinny_mt(int mt, const T* A, const T* B, T* C, float* part,
                      int* counters, int64_t M, int64_t N, int64_t K,
                      int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                      int kchunk, int splits, int blocks, int64_t tiles,
                      int64_t bn, cudaStream_t s) {
#define SKINNY(MT_)                                                        \
  case MT_:                                                                \
    return launch_skinny<T, MT_, COLB, VEC>(A, B, C, part, counters, M, N, \
                                            K, sam, sak, sbk, sbn, kchunk, \
                                            splits, blocks, tiles, bn, s);
  switch (mt) {
    SKINNY(1) SKINNY(2) SKINNY(4) SKINNY(8)
    case 16:  // f32 only: bf16 vectors hold 8 values, so 16 rows would need
              // 128 accumulators a thread
      if constexpr (sizeof(T) == 4)
        return launch_skinny<T, 16, COLB, VEC>(A, B, C, part, counters, M, N,
                                               K, sam, sak, sbk, sbn, kchunk,
                                               splits, blocks, tiles, bn, s);
      else
        return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
#undef SKINNY
}

// ---------------------------------------------------------------------------
// path (b): pipelined tiles
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256, kBM = 128, kBN = 128;

// Load an R x Cc tile (element (r, c) at g[r * sr + c * sc], valid where
// r < rlim and c < clim, zero elsewhere) into shared memory s[r * LD + c].
// VEC: sc == 1 and 16-byte aligned rows -> cp.async with zero fill;
// otherwise element by element through registers, neighbouring threads on
// neighbouring addresses: along r where r has unit stride (a transposed
// view, as the backward pass's A^T), else along c.
template <typename T, int R, int Cc, int LD, bool VEC>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t sr,
                                          int64_t sc, int64_t rlim,
                                          int64_t clim) {
  constexpr int V = Vec<T>::N;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < R * Cc / V; i += kTileThreads) {
      const int r = i / (Cc / V), c = (i % (Cc / V)) * V;
      const int64_t left = r < rlim ? clim - c : 0;
      const int bytes = left <= 0 ? 0 : (left >= V ? 16 : (int)left * (int)sizeof(T));
      cp_async16(s + r * LD + c, bytes ? g + r * sr + c : g, bytes);
    }
  } else if (sr == 1 && sc != 1) {
    for (int i = threadIdx.x; i < R * Cc; i += kTileThreads) {
      const int r = i % R, c = i / R;
      s[r * LD + c] = (r < rlim && c < clim) ? g[r + c * sc] : from_f<T>(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < R * Cc; i += kTileThreads) {
      const int r = i / Cc, c = i % Cc;
      s[r * LD + c] = (r < rlim && c < clim) ? g[r * sr + c * sc]
                                             : from_f<T>(0.f);
    }
  }
}

// Tile geometry per element type.  A is staged k-contiguous [BM][BK + pad]
// (ACOL: m-contiguous [BK][BM + pad]); B n-contiguous [BK][BN + pad] (ROWB)
// or k-contiguous [BN][BK + pad].
template <typename T>
struct TileCfg;
template <>
struct TileCfg<float> {
  static constexpr int BK = 16, STAGES = 3, PAD = 4;
};
template <>
struct TileCfg<__nv_bfloat16> {
  static constexpr int BK = 64, STAGES = 3, PAD = 8;
};

template <typename T, bool COLB, bool ACOL = false>
struct TileSmem {
  using C = TileCfg<T>;
  static constexpr int LDA = ACOL ? kBM + C::PAD : C::BK + C::PAD;
  static constexpr int LDB = COLB ? C::BK + C::PAD : kBN + C::PAD;
  static constexpr int A_ELEMS = ACOL ? C::BK * LDA : kBM * LDA;
  static constexpr int B_ELEMS = COLB ? kBN * LDB : C::BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int BYTES = C::STAGES * STAGE * (int)sizeof(T);
};

// Issue the loads of K tile kt into stage st.  VEC: B's vector loads (and
// A's along K); ACOL: A's tile by vectors along M (sam == 1).
template <typename T, bool COLB, bool VEC, bool ACOL = false>
__device__ __forceinline__ void load_stage(T* smem, int st, int64_t kt,
                                           const T* A, const T* B, int64_t M,
                                           int64_t N, int64_t K, int64_t m0,
                                           int64_t n0, int64_t sam,
                                           int64_t sak, int64_t sbk,
                                           int64_t sbn) {
  using S = TileSmem<T, COLB, ACOL>;
  constexpr int BK = TileCfg<T>::BK;
  T* As = smem + st * S::STAGE;
  T* Bs = As + S::A_ELEMS;
  const int64_t k0 = kt * BK;
  if constexpr (ACOL)
    load_tile<T, BK, kBM, S::LDA, true>(As, A + m0 * sam + k0 * sak, sak, sam,
                                        K - k0, M - m0);
  else
    load_tile<T, kBM, BK, S::LDA, VEC>(As, A + m0 * sam + k0 * sak, sam, sak,
                                       M - m0, K - k0);
  if constexpr (COLB)
    load_tile<T, kBN, BK, S::LDB, VEC>(Bs, B + n0 * sbn + k0 * sbk, sbn, sbk,
                                       N - n0, K - k0);
  else
    load_tile<T, BK, kBN, S::LDB, VEC>(Bs, B + k0 * sbk + n0 * sbn, sbk, sbn,
                                       K - k0, N - n0);
}

// f32: FMA, 8x8 outputs per thread: rows ty + 16i, columns tx*4 + 64j + c.
// Shared memory is read 16 bytes at a time: A along K (4 k-steps of a
// row), B along N (row-major B) or along K (embed.T).
template <bool COLB, bool VEC>
__global__ void __launch_bounds__(kTileThreads)
tiled_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int64_t M, int64_t N, int64_t K,
                 int64_t sam, int64_t sak, int64_t sbk, int64_t sbn) {
  using S = TileSmem<float, COLB>;
  constexpr int BK = TileCfg<float>::BK, STAGES = TileCfg<float>::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t nk = (K + BK - 1) / BK;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_stage<float, COLB, VEC>(smem, st, st, A, B, M, N, K, m0, n0, sam,
                                   sak, sbk, sbn);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int64_t kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int64_t nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<float, COLB, VEC>(smem, (int)(nxt % STAGES), nxt, A, B, M,
                                   N, K, m0, n0, sam, sak, sbk, sbn);
    cp_async_commit();
    const float* As = smem + (kt % STAGES) * S::STAGE;
    const float* Bs = As + S::A_ELEMS;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[8], b[8];  // a[i]: row i, k4..k4+3; b: see below
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &As[(ty + 16 * i) * S::LDA + k4]);
      if constexpr (COLB) {
        // b[j]: column tx*4 + 64(j/4) + j%4, k4..k4+3
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx * 4 + 64 * (j / 4) + j % 4) * S::LDB + k4]);
      } else {
        // b[2kk + h]: k4 + kk, columns tx*4 + 64h .. +3
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            b[2 * kk + h] = *reinterpret_cast<const float4*>(
                &Bs[(k4 + kk) * S::LDB + tx * 4 + 64 * h]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (COLB) {
            const float4& x = b[j];
            bk[j] = kk == 0 ? x.x : kk == 1 ? x.y : kk == 2 ? x.z : x.w;
          } else {
            const float4& x = b[2 * kk + j / 4];
            const int c = j % 4;
            bk[j] = c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ak = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ak, bk[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t n = n0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (n < N) C[m * N + n] = acc[i][j];
    }
  }
}

// Floats in one K split's partial tile (ACOL).
constexpr int kPartTile = kBM * kBN;

// Split-K epilogue of the bf16 tiles: the last split of tile `tile` sums the
// splits' dense partial tiles (part[(split * tiles + tile) * kPartTile]) in
// split order into C, then zeroes the tile's counter for the next call.
__device__ __forceinline__ void finish_tile_splits(
    __nv_bfloat16* C, const float* part, int* counter, int64_t M, int64_t N,
    int splits, int64_t tiles, int64_t tile, int64_t m0, int64_t n0) {
  if (!last_split(counter, splits)) return;
  const float4* p = reinterpret_cast<const float4*>(part + tile * kPartTile);
  const int64_t step = tiles * kPartTile / 4;  // float4s from split to split
  for (int i = threadIdx.x; i < kPartTile / 4; i += kTileThreads) {
    const int64_t m = m0 + i / (kBN / 4), n = n0 + (i % (kBN / 4)) * 4;
    if (m >= M) break;  // rows only grow with i
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8  // independent loads in flight; the sum keeps split order
    for (int sp = 0; sp < splits; ++sp) {
      const float4 x = __ldcg(p + sp * step + i);
      s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    }
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) C[m * N + n + e] = __float2bfloat16(v[e]);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// bf16: mma.sync m16n8k16 on the tensor cores.  8 warps as 2 (M) x 4 (N),
// each warp a 64x32 tile: 4 x 4 fragments of 16x8.  ACOL: A staged along M
// and K split over blockIdx.z, `ktiles` K tiles a split; with splits > 1
// the splits' partials are summed in the launch (part, counters).
template <bool COLB, bool VEC, bool ACOL>
__global__ void __launch_bounds__(kTileThreads)
tiled_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B,
                  __nv_bfloat16* __restrict__ C, float* __restrict__ part,
                  int* __restrict__ counters, int64_t M, int64_t N,
                  int64_t K, int64_t sam, int64_t sak, int64_t sbk,
                  int64_t sbn, int ktiles, int splits) {
  using T = __nv_bfloat16;
  using S = TileSmem<T, COLB, ACOL>;
  constexpr int BK = TileCfg<T>::BK, STAGES = TileCfg<T>::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  // this block's K tiles [kt0, kt1)
  int64_t kt0 = 0, kt1 = (K + BK - 1) / BK;
  if constexpr (ACOL) {
    kt0 = (int64_t)blockIdx.z * ktiles;
    kt1 = kt1 < kt0 + ktiles ? kt1 : kt0 + ktiles;
  }

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (kt0 + st < kt1)
      load_stage<T, COLB, VEC, ACOL>(smem, st, kt0 + st, A, B, M, N, K, m0,
                                     n0, sam, sak, sbk, sbn);
    cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int64_t nxt = kt + STAGES - 1;
    if (nxt < kt1)
      load_stage<T, COLB, VEC, ACOL>(smem, (int)((nxt - kt0) % STAGES), nxt,
                                     A, B, M, N, K, m0, n0, sam, sak, sbk,
                                     sbn);
    cp_async_commit();
    const T* As = smem + ((kt - kt0) % STAGES) * S::STAGE;
    const T* Bs = As + S::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // ACOL: lanes 8j..8j+7 address the k rows of the fragment's
        // 8x8 matrix j, at m + 8 (j & 1) and k + 8 (j >> 1)
        if constexpr (ACOL)
          ldmatrix_x4_trans(a[i], As + (ks + (lane & 7) + (lane >> 4) * 8) *
                                           S::LDA + wm + i * 16 +
                                           ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4(a[i], As + (wm + i * 16 + (lane & 15)) * S::LDA + ks +
                                (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        if constexpr (COLB)
          ldmatrix_x4(r, Bs + (wn + p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  S::LDB + ks + ((lane >> 3) & 1) * 8);
        else
          ldmatrix_x4_trans(r, Bs + (ks + (lane & 15)) * S::LDB + wn +
                                   p * 16 + (lane >> 4) * 8);
        b[2 * p][0] = r[0]; b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2]; b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  if constexpr (ACOL) {
    if (splits > 1) {
      // this split's dense partial tile, then the last split's sum
      const int64_t tiles = (int64_t)gridDim.x * gridDim.y;
      const int64_t tile = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
      float* p = part + ((int64_t)blockIdx.z * tiles + tile) * kPartTile;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(
                p + (wm + i * 16 + lane / 4 + h * 8) * kBN + wn + j * 8 +
                (lane % 4) * 2) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      finish_tile_splits(C, part, counters + tile, M, N, splits, tiles, tile,
                         m0, n0);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm + i * 16 + lane / 4 + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t n = n0 + wn + j * 8 + (lane % 4) * 2 + e;
          if (n < N) C[m * N + n] = __float2bfloat16(acc[i][j][2 * h + e]);
        }
    }
}

template <bool COLB, bool VEC, bool ACOL>
auto tiled_kernel(float*) {
  static_assert(!ACOL, "f32 stages A along K only");
  return tiled_f32_kernel<COLB, VEC>;
}
template <bool COLB, bool VEC, bool ACOL>
auto tiled_kernel(__nv_bfloat16*) {
  return tiled_bf16_kernel<COLB, VEC, ACOL>;
}

// ACOL: kchunk-deep K splits (a multiple of BK), `splits` of them over
// blockIdx.z; with splits > 1 part holds splits x tiles partial tiles and
// counters one zeroed int per output tile, where tiles (the wrapper's count,
// which sized them) must be the grid's.
template <typename T, bool COLB, bool VEC, bool ACOL = false>
cudaError_t launch_tiled(const T* A, const T* B, T* C, float* part,
                         int* counters, int64_t M, int64_t N, int64_t K,
                         int64_t sam, int64_t sak, int64_t sbk, int64_t sbn,
                         int kchunk, int splits, int64_t plan_tiles,
                         cudaStream_t s) {
  constexpr int bytes = TileSmem<T, COLB, ACOL>::BYTES;
  constexpr int BK = TileCfg<T>::BK;
  const auto kernel = tiled_kernel<COLB, VEC, ACOL>(static_cast<T*>(nullptr));
  // above 48 KB of dynamic shared memory only with the attribute (set on
  // every launch: it is per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const int64_t gx = (N + kBN - 1) / kBN, gy = (M + kBM - 1) / kBM;
  if (gx >= (1LL << 31) || gy >= 65536) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    kernel<<<dim3((unsigned)gx, (unsigned)gy), kTileThreads, bytes, s>>>(
        A, B, C, M, N, K, sam, sak, sbk, sbn);
  } else {
    if (ACOL) {
      // the splits cover K exactly, none empty, and the scratch fits them
      if (kchunk < BK || kchunk % BK || splits < 1 || splits >= 65536 ||
          (int64_t)kchunk * splits < K ||
          (splits > 1 && ((int64_t)kchunk * (splits - 1) >= K ||
                          plan_tiles != gx * gy || part == nullptr ||
                          counters == nullptr)))
        return cudaErrorInvalidValue;
    } else {
      splits = 1;
    }
    kernel<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)splits), kTileThreads,
             bytes, s>>>(A, B, C, part, counters, M, N, K, sam, sak, sbk, sbn,
                         kchunk / BK, splits);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* b, void* c, int64_t M,
                     int64_t N, int64_t K, int64_t sam, int64_t sak,
                     int64_t sbk, int64_t sbn, int path, int mt, int colb,
                     int vec, int kchunk, int splits, int blocks,
                     int64_t tiles, int64_t bn, void* part, void* counters,
                     cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  float* P = static_cast<float*>(part);
  int* cnt = static_cast<int*>(counters);
  const int variant = (colb ? 2 : 0) + (vec ? 1 : 0);
  if (path == 0) {
    if (splits > 1 && (P == nullptr || cnt == nullptr))
      return cudaErrorInvalidValue;
    switch (variant) {
      case 0: return skinny_mt<T, false, false>(mt, A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, blocks, tiles, bn, s);
      case 1: return skinny_mt<T, false, true>(mt, A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, blocks, tiles, bn, s);
      case 2: return skinny_mt<T, true, false>(mt, A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, blocks, tiles, bn, s);
      default: return skinny_mt<T, true, true>(mt, A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, blocks, tiles, bn, s);
    }
  }
  if (path == 1) {
    switch (variant) {
      case 0: return launch_tiled<T, false, false>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
      case 1: return launch_tiled<T, false, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
      case 2: return launch_tiled<T, true, false>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
      default: return launch_tiled<T, true, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
    }
  }
  if (path == 2) {  // bf16 only: A staged along M
    if constexpr (sizeof(T) == 2) {
      switch (variant) {
        case 0: return launch_tiled<T, false, false, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
        case 1: return launch_tiled<T, false, true, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
        case 2: return launch_tiled<T, true, false, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
        default: return launch_tiled<T, true, true, true>(A, B, C, P, cnt, M, N, K, sam, sak, sbk, sbn, kchunk, splits, tiles, s);
      }
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// A: (M,K) with strides (sam, sak); B: (K,N) with strides (sbk, sbn);
// C: (M,N) contiguous, same dtype as A and B.  p holds the wrapper's plan,
// fixed per shape and cached there, so that a call passes 7 arguments:
//   p[0..6]  M, N, K, sam, sak, sbk, sbn
//   p[7]     dtype (DType)
//   p[8]     path: 0 skinny, 1 tiled, 2 tiled with A staged along M
//            (bf16, sam == 1: the weight gradient A^T dC)
//   p[9..10] colb (B read along K, unit stride sbk), vec (16-byte vector
//            loads are aligned: B's, and on path 1 A's too)
//   p[11..14] skinny: mt rows of A per block, kchunk-deep K splits,
//            `splits` of them, `blocks` blocks per split walking the output
//            tiles; part holds splits*M*N floats and counters one zeroed
//            int per output tile when splits > 1.  Path 2: kchunk and
//            splits alike (blockIdx.z), part splits*tiles*128*128 floats.
//   p[15..16] skinny: the output tiles the wrapper counted (the size of
//            counters) and their width; path 2 the tiles; a launch whose
//            kernel derives other values fails with cudaErrorInvalidValue.
// Returns cudaGetLastError().
extern "C" int matmul(const void* a, const void* b, void* c, void* part,
                      void* counters, const int64_t* p, void* stream) {
  const int64_t M = p[0], N = p[1], K = p[2], sam = p[3], sak = p[4],
                sbk = p[5], sbn = p[6];
  const int path = (int)p[8], colb = (int)p[9], vec = (int)p[10],
            mt = (int)p[11], kchunk = (int)p[12], splits = (int)p[13],
            blocks = (int)p[14];
  const int64_t tiles = p[15], bn = p[16];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((int)p[7]) {
    case kFloat32:
      return dispatch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, path, mt,
                             colb, vec, kchunk, splits, blocks, tiles, bn,
                             part, counters, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn,
                                     path, mt, colb, vec, kchunk, splits,
                                     blocks, tiles, bn, part, counters, s);
    default:
      return cudaErrorInvalidValue;
  }
}
