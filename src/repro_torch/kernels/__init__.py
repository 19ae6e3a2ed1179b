"""kernels — hand-written CUDA kernels (Hopper, sm_90a) for the port.

Each kernel ships:
  csrc/<name>.cu   the CUDA C++ kernel behind a plain C entry point
  <name>.py        its ctypes wrapper (checks, launch, launch count)
  ref.py           the plain PyTorch version (CPU path, and the oracle)
  ops.py           dispatch by device: kernel on CUDA, plain on CPU

Kernels present (ports of the Pallas kernels in ``repro.kernels``):
  matmul          skinny-M streaming path (split-K summed in a fixed order
                  in the launch) and pipelined tiles (bf16 on mma.sync);
                  f32 accumulation, strided A and B
  flash_attention causal GQA flash attention, one block per KV-head group
                  (online softmax over cp.async double-buffered KV tiles)
  rmsnorm         fused RMS-norm, scale (1 + w): the row in registers (x
                  read once, 16-byte loads), a warp per row up to D 1024
                  f32 / 2048 bf16, 128-512 threads a row beyond, element
                  loads where unaligned; w read in its own dtype

Backward kernels (no Pallas counterpart: JAX differentiates the plain
layers), behind ``torch.autograd.Function``s in ``ops.py``:
  flash_attention_bwd  FlashAttention-2 recompute from the forward's
                  log-sum-exp, one launch (f32 and bf16): dK/dV blocks
                  per KV tile carrying the group's query heads (long key
                  tiles split, summed in split order), dQ blocks of 64
                  query rows; cp.async-staged tiles, bf16 on mma.sync,
                  f32 on 4 x 4 FMA register tiles
  rmsnorm_bwd     one launch: dx and dw from one read of x and dy held in
                  registers (the forward's warp/block/scalar variants);
                  each block's dw partial summed in a fixed order by the
                  last blocks to finish (tickets on int counters)
  (matmul's backward is the forward kernel on transposed views)

``_build.py`` compiles ``csrc/*.cu`` with nvcc at first use.
"""

from .ops import flash_attention, launches, matmul, plain_calls, rmsnorm

__all__ = ["matmul", "flash_attention", "rmsnorm", "launches",
           "plain_calls"]
