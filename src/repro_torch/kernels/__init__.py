"""kernels — hand-written CUDA kernels (Hopper, sm_90a) for the port.

Each kernel ships:
  csrc/<name>.cu   the CUDA C++ kernel behind a plain C entry point
  <name>.py        its ctypes wrapper (checks, launch, launch count)
  ref.py           the plain PyTorch version (CPU path, and the oracle)
  ops.py           dispatch by device: kernel on CUDA, plain on CPU

Kernels present (ports of the Pallas kernels in ``repro.kernels``):
  matmul          shared-memory tiled GEMM, f32 FMA accumulation, strided B
  flash_attention causal GQA flash attention (online softmax over KV tiles)
  rmsnorm         fused RMS-norm, scale (1 + w)

``_build.py`` compiles ``csrc/*.cu`` with nvcc at first use.
"""

from .ops import flash_attention, launches, matmul, rmsnorm

__all__ = ["matmul", "flash_attention", "rmsnorm", "launches"]
