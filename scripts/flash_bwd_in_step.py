"""The port's flash-attention backward kernel alone and as a tuning step
meets it, at the tuning loop's shape (mb2 S32, 9/3 heads of 64, f32).

Run from a checkout's root on a machine with a CUDA card:

    PYTHONPATH=src python3 scripts/flash_bwd_in_step.py

Another commit's kernel is read the same way from its own unpacked tree
(``git archive <commit> | tar -x -C compare/parent``, then
``PYTHONPATH=compare/parent/src``): the script uses only
``flash_attention_cuda``, ``flash_attention_bwd_cuda(..., bk=)`` and the
``ops.matmul``/``ops.rmsnorm`` wrappers, which the port has had since its
tuning loop.

For KV chunks 16 and 64 it prints the kernel's device ms a launch:
- ``back to back``: 20 launches enqueued behind a spin kernel that holds the
  stream, the least of 3 runs (``chip_smoke.py``'s ``time_ms``);
- ``after itself`` / ``after mix`` / ``after sweep``: CUDA events around
  each launch alone, the median of 20, where the launch follows another of
  itself, ten small kernels of a tuning step's kinds (the port's matmul and
  RMSNorm, PyTorch elementwise ops), or a 256 MiB copy that sweeps the L2;
  the stream held while all of it is enqueued;
- ``host-paced``: ``torch.profiler``'s device time of the kernel when each
  launch follows the mix and ends in ``torch.cuda.synchronize()`` (as a
  thunk of the tuning step does), median and least of 20.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)

REPS = 20


def hold(ms: float = 2.0) -> None:
    """Keep the stream busy (~2 GHz clock) while the host enqueues."""
    torch.cuda._sleep(int(ms * 1e-3 * 2e9))


def back_to_back(fn, trials: int = 3) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        hold()
        e0.record()
        for _ in range(REPS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / REPS)
    return best


def bracketed(fn, before) -> float:
    """Median device ms of ``fn`` alone, each launch after ``before()``."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda.synchronize()
    hold(8.0)
    for e0, e1 in ev:
        before()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sorted(e0.elapsed_time(e1) for e0, e1 in ev)[REPS // 2]


def host_paced(fn, before):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            before()
            fn()
            torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "flash_bwd" in e.name)
    return len(us), us[len(us) // 2] / 1e3, us[0] / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_in_step: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def mk(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)
    x, ln = mk(64, 576), mk(576, scale=0.1)
    w, w2 = mk(576, 576, scale=1 / 24), mk(576, 1536, scale=1 / 24)
    y, z = mk(64 * 576), mk(64, 512)
    big = torch.empty(64 << 20, device=dev)          # 256 MiB, twice the L2
    big_to = torch.empty_like(big)

    def mix():
        torch.mm(x, w)
        y.add_(1.0)
        torch.relu(y)
        y.mul_(0.5)
        torch.softmax(z, -1)
        ops.matmul(x, w2)
        ops.rmsnorm(x, ln)
        F.silu(z)
        torch.cat([z, z])
        z.sum()

    def sweep():
        big_to.copy_(big)

    B, S, H, KVH, d = 2, 32, 9, 3, 64
    for bk in (16, 64):
        q, do = mk(B, S, H, d), mk(B, S, H, d)
        k, v = mk(B, S, KVH, d), mk(B, S, KVH, d)
        o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True)

        def run():
            flash_attention_bwd_cuda(q, k, v, o, lse, do, bk=bk)
        for _ in range(3):
            run()
        n, med, least = host_paced(run, mix)
        print(f"[in_step] f32 mb2 S32 kv{bk}: back to back "
              f"{back_to_back(run):.4f} ms; after itself "
              f"{bracketed(run, lambda: None):.4f}; after mix "
              f"{bracketed(run, mix):.4f}; after sweep "
              f"{bracketed(run, sweep):.4f}; host-paced {n} launches median "
              f"{med:.4f} least {least:.4f}")


if __name__ == "__main__":
    main()
