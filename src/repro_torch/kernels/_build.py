"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load them with ctypes.

Each source is its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  The first kernel call builds every
source that has no library yet, one ``nvcc`` per source, all started
together.  A library's file name carries a hash of the sources and flags,
so an edit rebuilds it; it is written under a temporary name and renamed,
so processes that build at once never load a torn file.

Every C entry point takes pointers and strides as ``c_void_p``/``c_int64``
plus the stream of ``torch.cuda.current_stream()``, and returns
``cudaGetLastError()`` after its launch; ``check`` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel: each wrapper adds one where it launches its kernel.
launches: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0, "matmul": 0,
                            "rmsnorm_bwd": 0, "flash_attention_bwd": 0}

# element types the kernels take (csrc/common.cuh enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132               # the SM count plans use where none is given

_libs: Dict[str, ctypes.CDLL] = {}
# per (device, stream): f32 workspace and int counters for the kernels that
# sum partials across blocks in the launch (matmul's split-K, the RMSNorm
# backward's dw), which return the counters to zero after each call
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_entries: Dict[str, Callable[..., int]] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                           "CUDA kernels are built from source at first use")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Build every source whose library is missing, in parallel.  Returns
    ``{name: nvcc output}`` (with ``-Xptxas -v``: registers, shared memory
    and spills per kernel) for the sources it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, out, tmp, proc))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def entry(name: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``name`` of ``csrc/<name>.cu`` with its argument
    types set, loaded once per process."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(name), name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _entries[name] = fn
    return fn


def check_inputs(name: str, *tensors: torch.Tensor) -> int:
    """Raise unless every tensor is a CUDA tensor on the current device with
    one dtype the kernels take; returns that dtype's code."""
    dtype = tensors[0].dtype
    code = DTYPE_CODES.get(dtype)
    for t in tensors:
        if not t.is_cuda or t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: kernel needs tensors on the current "
                             f"CUDA device, got {t.device}")
        if t.dtype != dtype or code is None:
            raise TypeError(f"{name}: kernel takes one dtype of "
                            f"{list(DTYPE_CODES)}, got "
                            f"{[x.dtype for x in tensors]}")
    return code


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the plans size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(device, stream: int, n_floats: int, n_counters: int):
    """At least ``n_floats`` f32 of workspace and ``n_counters`` zeroed int32
    counters for kernels on ``stream``, cached and grown as needed (launches
    on one stream run in turn, so the kernels there share them)."""
    key = (device.index, stream)
    ws, cnt = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1 << 16), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros(max(n_counters, 1 << 12), dtype=torch.int32,
                          device=device)
    _scratch[key] = (ws, cnt)
    return ws, cnt


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
