// Tiled matrix product C = A * B for Hopper (sm_90a).
//
// Replaces: the Pallas kernel _matmul_kernel (src/repro/kernels/matmul.py:24,
// launched by matmul_pallas): (M,K) x (K,N) -> (M,N) in A's dtype with an f32
// accumulator.
//
// Bound on the H100: at the serving path's shapes, memory.  Decode has M = 4
// rows, so each weight element read from HBM feeds 4 FMAs: 8 flops per 4
// bytes (f32), against the ~20 flop/byte balance of the card's 67 TFLOP/s
// f32 (non-tensor) rate over 3.35 TB/s.  Prefill at M = 32 is near balance.
// The least time is the larger of (A + B + C bytes) / 3.35 TB/s and
// 2*M*N*K flops / 67 TFLOP/s (f32; bf16 at the tensor-core rate).
//
// Design: the simple shared-memory tiled GEMM.  One block of 256 threads
// owns a 64x64 tile of C and walks K in steps of 16; A and B tiles are
// staged in shared memory as f32 (bf16 converts through __bfloat162float at
// the load), and each thread accumulates a 4x4 sub-tile with fmaf -- plain
// f32 FMA, no TF32, no tensor cores.  Every edge is masked, so any M, N, K
// works (the TPU kernel clamped its tiles to divisors instead).  A and B
// come in through (row, column) strides, and the tile loads map consecutive
// threads along whichever stride is 1, so the tied head reads embed.T (a
// transposed view, no copy) as coalesced as a row-major B.  Making it fast
// (wgmma, TMA, a pipelined ring of tiles, split-K for the 4-row decode
// products) is later work.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int64_t M, int64_t N, int64_t K,
              int64_t sam, int64_t sak, int64_t sbk, int64_t sbn) {
  // k-major tiles: a thread's TM rows of A and TN columns of B are
  // contiguous in shared memory for each k.
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      int r, c;  // r: row of A within the tile, c: k within the tile
      if (sak == 1) { r = idx / BK; c = idx % BK; }
      else          { c = idx / BM; r = idx % BM; }
      const int64_t gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f(A[gm * sam + gk * sak]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      int r, c;  // r: k within the tile, c: column of B within the tile
      if (sbn == 1) { r = idx / BN; c = idx % BN; }
      else          { c = idx / BK; r = idx % BK; }
      const int64_t gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f(B[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx * TN + j;
      if (gn < N) C[gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int64_t M,
                   int64_t N, int64_t K, int64_t sam, int64_t sak,
                   int64_t sbk, int64_t sbn, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, sam, sak, sbk, sbn);
  return cudaGetLastError();
}

}  // namespace

// A: (M,K) with strides (sam, sak); B: (K,N) with strides (sbk, sbn);
// C: (M,N) contiguous, same dtype as A and B.  Returns cudaGetLastError().
extern "C" int matmul(const void* a, const void* b, void* c, int64_t M,
                      int64_t N, int64_t K, int64_t sam, int64_t sak,
                      int64_t sbk, int64_t sbn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
    case kBFloat16:
      return launch<__nv_bfloat16>(a, b, c, M, N, K, sam, sak, sbk, sbn, s);
    default:
      return cudaErrorInvalidValue;
  }
}
