"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase catches and goes on):

1. build   -- compile csrc/*.cu with nvcc (one process per source, all at
              once) and print the build time, each kernel's registers and
              spilled bytes (ptxas -v) and the card (nvidia-smi name, power
              limit);
2. kernels -- hold every CUDA kernel against its plain PyTorch version on
              the card at the serving path's full-width shapes (f32 and
              bf16) and at the JAX test sweep's awkward shapes; time the
              kernel, the plain version and one PyTorch library call at
              the main-path shapes (f32) and at long-prompt shapes (f32 and
              bf16; CUDA events), and compute each shape's bound (bytes over
              HBM bandwidth vs flops over peak), beside an empty kernel's
              time ("floor").  Each matmul row names the path the wrapper
              chose, each RMSNorm row its variant.  The decode matmuls are
              also timed with cold weights: a rotation of distinct copies
              of B totalling twice the L2, as the decode step reads 30
              layers' weights from HBM ("cold" beside the warm-in-L2
              time); then every RMSNorm variant forced at each shape it
              takes ("variants", f32 and bf16 x with either dtype of w),
              forward and backward (one launch: dx and dw, with the
              backward plan's grid and levels of its dw sum), and both
              matmul paths forced at M around the skinny
              threshold ("crossover", the reading that sets
              SKINNY_MAX_M), each held against the plain version;
3. serve   -- run `repro_torch.launch.serve` at full width (smollm-135m,
              30 layers, d_model 576, seeded random f32 weights; batch 4,
              s_max 256, 8 requests of 4-31 tokens, 16 new tokens each)
              with the launch counters zeroed just before and read just
              after: every kernel must have launched; then hold the card's
              prefill and teacher-forced decode logits against the port's
              CPU run on the same weights;
4. profile -- torch.profiler over 5 decode steps of a full batch: device
              busy time and idle share per step, device work by kernel;
5. grads   -- each backward kernel (flash attention's dQ/dK/dV, RMSNorm's
              dx/dw, and the matmul backward's products on transposed
              views) against its plain version at the tuning loop's
              full-width shapes (batch 2 and 1 of 32 tokens, KV chunk 16
              and 64), at a 2048-token prompt and at 8192x4096 (flash
              attention and RMSNorm in f32 and bf16), with two
              runs compared bit for bit, timed beside its bound, plain
              version and library call (SDPA's and F.rms_norm's backward
              by autograd, torch.matmul); then one full-width attn_fb,
              dense_fb and embed_loss_fb gradient of the study on the
              card against the port's CPU run;
6. tune    -- LMStudy("smollm-135m", reduced=False, batch=2, seq=32) on
              the card: a 12-point conditional session (tolerance 0.25,
              trials 3) and a race, with the launch counters zeroed just
              before and read just after (every kernel, forward and
              backward, must launch; no plain version may run); per
              configuration the predicted and full-reference step, the
              executed and skipped kernels; chosen vs true best; launches
              per thunk by kernel; one step of the chosen configuration
              broken down by thunk and under the profiler.

It prints the kernels as one JSON line, then the last line
``{"ok": true, "device": {...}}``.  ``--out PATH`` also writes the full
tables (every case, the serve and profile numbers) as JSON.  It exits
non-zero without a result where there is no CUDA device or no checkout of
the repository around it.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# (rtol, atol) of each kernel against its plain version, per dtype: the JAX
# test sweep's tolerances (tests/test_kernels.py)
TOL = {"matmul": {"float32": (1e-5, 8e-5), "bfloat16": (3e-2, 2.4e-1)},
       "rmsnorm": {"float32": (2e-5, 2e-5), "bfloat16": (3e-2, 3e-2)},
       "flash_attention": {"float32": (3e-4, 3e-4),
                           "bfloat16": (4e-2, 4e-2)}}
# the port's CUDA run against its CPU run, f32 logits: both do the same f32
# arithmetic in another order, so 1e-3/1e-4 (the ceiling is 2e-2/2e-3)
SERVE_TOL = (1e-3, 1e-4)

SERVE_ARGV = ["--arch", "smollm-135m", "--batch", "4", "--s-max", "256",
              "--requests", "8", "--max-new", "16", "--seed", "0"]
PROMPT_MAX = 31                 # the serve run's prompts have 4..31 tokens
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:24"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:19"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:29"),
    # the backward kernels: gradients of the TPU kernels above, which have
    # none of their own (JAX differentiates the plain layers)
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:29"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:19"),
}
FORWARD = ("matmul", "rmsnorm", "flash_attention")   # the serving path's


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


if not (ROOT / "src" / "repro_torch").is_dir():
    fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
         "checkout of the repository")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.matmul import (L2_BYTES, matmul_cuda,  # noqa: E402
                                        plan_for, skinny_max_m)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    BWD_BLOCKS_PER_SM, VARIANTS, bwd_plan_for, plan_for as rms_plan_for,
    plan_rmsnorm_bwd, rmsnorm_bwd_cuda, rmsnorm_cuda, variants_for)


# -- helpers -----------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3, trials: int = 3):
    """(device ms, host ms) per call.  Device: the stream is held by a spin
    kernel while the host enqueues ``reps`` calls, so the CUDA events
    bracket the calls' device work back to back, without the host's launch
    gaps; the least of ``trials`` such runs (host hiccups only add).  Host:
    the same events with nothing holding the stream, i.e. the larger of the
    host's issue time and the device time per call."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def run(hold_cycles: int) -> float:
        torch.cuda.synchronize()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    host = run(0)
    # hold the stream for 4x the host's issue time plus 1 ms (~2 GHz clock)
    hold = int((4 * reps * host + 1.0) * 1e-3 * 2e9)
    return min(run(hold) for _ in range(trials)), host


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, dtype, tol=None) -> float:
    """Max abs error of ``got`` against ``want``; raises beyond ``tol``
    (rtol, atol), by default the kernel's ``TOL``."""
    rtol, atol = tol or TOL[name][dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = bool((err > atol + rtol * w.abs()).any())
    if bad or not torch.isfinite(g).all():
        raise AssertionError(
            f"{name} {dtype} {tuple(got.shape)}: kernel disagrees with the "
            f"plain version (max abs err {float(err.max()):.3e}, rtol "
            f"{rtol}, atol {atol})")
    return float(err.max())


def randn(shape, dtype, std=1.0, gen=None):
    return (torch.randn(shape, generator=gen) * std).to("cuda", dtype)


def elem(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# -- phase 1: build -----------------------------------------------------------

def ptxas_table(logs):
    """{source: [(kernel, registers, spill bytes)]} from nvcc's -Xptxas -v
    output (entry names demangled with c++filt where it exists)."""
    import re
    import shutil
    table = {}
    for src, log in sorted(logs.items()):
        rows, name, spill = [], None, 0
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                rows.append([name, int(m.group(1)), spill])
                name, spill = None, 0
        if rows and shutil.which("c++filt"):
            out = subprocess.run(["c++filt"], input="\n".join(
                r[0] for r in rows), capture_output=True, text=True,
                timeout=60).stdout.splitlines()
            for r, d in zip(rows, out):
                r[0] = re.sub(r"\(anonymous namespace\)::|\(.*$", "", d)
        table[src] = rows
    return table


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.launches:       # every library exists and loads
        _build.load(name)
    dt = time.perf_counter() - t0
    print(f"[build] {len(logs)} sources built in {dt:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    table = ptxas_table(logs)
    for src, rows in table.items():
        for kname, regs, spill in rows:
            print(f"[build] {src}: {kname}: {regs} registers, {spill} bytes "
                  f"spilled")
    spills = [k for rows in table.values() for k, _, s in rows if s]
    print(f"[build] kernels with spills: {spills or 'none'}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    return card, table


# -- phase 2: kernels against their plain versions ----------------------------

def matmul_case(M, K, N, dtype, gen, strided_b=False):
    a = randn((M, K), dtype, 1.0, gen)
    if strided_b:       # the tied head: B = embed.T, a transposed view
        b = randn((N, K), dtype, 0.02, gen).T
    else:
        b = randn((K, N), dtype, 1.0 / math.sqrt(K), gen)
    return (a, b)


def rms_case(rows, D, dtype, gen):
    return (randn((rows, D), dtype, 1.0, gen), randn((D,), dtype, 0.1, gen))


def flash_case(B, Sq, Skv, H, KVH, d, dtype, gen):
    return tuple(randn(s, dtype, 1.0, gen) for s in
                 ((B, Sq, H, d), (B, Skv, KVH, d), (B, Skv, KVH, d)))


def causal_pairs(Sq, Skv) -> int:
    return sum(min(Skv, Skv - Sq + i + 1) for i in range(Sq))


def cost(name, args):
    """(bytes, flops) the function needs on these inputs."""
    es = elem(args[0].dtype)
    if name == "matmul":
        (M, K), N = args[0].shape, args[1].shape[1]
        return (M * K + K * N + M * N) * es, 2 * M * N * K
    if name == "rmsnorm":
        x, w = args
        return 2 * x.numel() * es + w.numel() * w.element_size(), \
            4 * x.numel()
    q, k, v = args
    B, Sq, H, d = q.shape
    return ((2 * q.numel() + k.numel() + v.numel()) * es,
            4 * d * B * H * causal_pairs(Sq, k.shape[1]))


def library_call(name, args):
    """One PyTorch call computing the same function (yardstick only)."""
    if name == "matmul":
        a, b = args
        return lambda: torch.matmul(a, b)
    if name == "rmsnorm":
        x, w = args
        w1 = 1.0 + w
        return lambda: F.rms_norm(x, (x.shape[-1],), weight=w1, eps=1e-5)
    q, k, v = args
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    assert q.shape[1] == k.shape[1]     # is_causal aligns top-left
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)


# the CUDA entry functions of each kernel, as the profiler names them
KERNEL_NAMES = {"rmsnorm": ("rmsnorm_warp_kernel", "rmsnorm_block_kernel",
                            "rmsnorm_scalar_kernel"),
                "matmul": ("skinny_rowb_kernel", "skinny_colb_kernel",
                           "tiled_f32_kernel", "tiled_bf16_kernel"),
                "flash_attention": ("flash_fwd_f32_kernel",
                                    "flash_fwd_bf16_kernel"),
                "flash_attention_bwd": ("flash_bwd_kernel",),
                "rmsnorm_bwd": ("rmsnorm_bwd_warp_kernel",
                                "rmsnorm_bwd_block_kernel",
                                "rmsnorm_bwd_scalar_kernel")}
KERNEL_FN = {"matmul": ops.matmul, "rmsnorm": ops.rmsnorm,
             "flash_attention": ops.flash_attention}
PLAIN_FN = {"matmul": ref.matmul_ref, "rmsnorm": ref.rmsnorm_ref,
            "flash_attention": ref.flash_attention_ref}


def main_path_cases(cfg):
    """(kernel, label, shape spec) at the serving path's full width."""
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    HD, KD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    S, B = PROMPT_MAX, 4
    cases = []
    for phase, M in (("prefill", S), ("decode", B)):
        for what, K, N in (("q/o", D, HD), ("k/v", D, KD), ("gate/up", D, F_),
                           ("down", F_, D)):
            cases.append(("matmul", f"{phase} {what} {M}x{K}x{N}",
                          (M, K, N, False)))
        Mh = 1 if phase == "prefill" else M     # prefill: last row only
        cases.append(("matmul", f"{phase} tied head {Mh}x{D}x{V} (B=embed.T)",
                      (Mh, D, V, True)))
        cases.append(("rmsnorm", f"{phase} {M}x{D}", (M, D)))
    cases.append(("flash_attention",
                  f"prefill B1 S{S} H{cfg.n_heads}/{cfg.n_kv_heads} "
                  f"d{cfg.head_dim}",
                  (1, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)))
    return cases


AWKWARD = [("matmul", (8, 8, 8, False)), ("matmul", (64, 96, 32, False)),
           ("matmul", (256, 512, 384, False)), ("matmul", (3, 5, 7, True)),
           ("matmul", (512, 128, 256, False)),
           ("rmsnorm", (4 * 64, 128)), ("rmsnorm", (3 * 37, 96)),
           ("rmsnorm", (1, 8)), ("rmsnorm", (2 * 200, 256)),
           ("rmsnorm", (37, 577)), ("rmsnorm", (3, 7168)),
           ("flash_attention", (2, 128, 128, 4, 2, 64)),
           ("flash_attention", (1, 64, 256, 8, 8, 32)),
           ("flash_attention", (2, 256, 256, 6, 2, 64)),
           ("flash_attention", (1, 96, 96, 3, 1, 16)),
           ("flash_attention", (1, 37, 37, 9, 3, 64)),
           ("flash_attention", (2, 33, 70, 4, 2, 8)),
           ("flash_attention", (1, 5, 5, 2, 1, 128))]


def make_args(name, spec, dtype, gen):
    if name == "matmul":
        return matmul_case(*spec[:3], dtype, gen, strided_b=spec[3])
    if name == "rmsnorm":
        return rms_case(*spec, dtype, gen)
    return flash_case(*spec, dtype, gen)


# timing rows beyond the serving path's shapes (not served): the tiled
# matmul path and RMSNorm at a 2048-token prompt, RMSNorm at 8192 rows of
# the 4096-wide configurations (granite-3-8b, phi-3.5-moe), where its HBM
# bound binds, and flash attention at long prompts, timed in f32 and bf16
LONG_CASES = [("matmul", "long prompt 2048x576x1536", (2048, 576, 1536, False)),
              ("matmul", "long prompt 2048x1536x576", (2048, 1536, 576, False)),
              ("rmsnorm", "long prompt 2048x576", (2048, 576)),
              ("rmsnorm", "wide 8192x4096", (8192, 4096)),
              ("flash_attention", "prefill B1 S256 H9/3 d64",
               (1, 256, 256, 9, 3, 64)),
              ("flash_attention", "prefill B1 S2048 H9/3 d64",
               (1, 2048, 2048, 9, 3, 64))]


def cold_weights(b, n_min: int = 30):
    """Distinct copies of B (same shape, strides and scale) totalling at
    least twice the L2, so that each call of a rotation finds its weights
    in HBM, as the decode step does (30 layers of distinct weights)."""
    nbytes = b.numel() * b.element_size()
    n = max(n_min, math.ceil(2 * L2_BYTES / nbytes))
    std = float(b.float().std())
    if b.stride(0) == 1 and b.stride(1) != 1:   # embed.T
        return [(torch.randn(b.shape[::-1], device=b.device) * std)
                .to(b.dtype).T for _ in range(n)]
    return [(torch.randn(b.shape, device=b.device) * std).to(b.dtype)
            for _ in range(n)]


def rotating(fn, a, bs):
    it = itertools.cycle(bs)
    return lambda: fn(a, next(it))


def matmul_path(a, b):
    plan = plan_for(a, b)
    return plan.path + (f" x{plan.splits} splits" if plan.splits > 1 else "")


def rms_path(plan):
    if plan.variant == "scalar":
        return f"scalar {plan.threads} threads"
    per = (f"{plan.rows_per_block} rows a block" if plan.variant == "warp"
           else f"{plan.threads} threads a row")
    return f"{plan.variant} nv{plan.nv} {per}"


def rms_bwd_path(plan):
    """The backward plan's variant and geometry, and the dw sum's levels."""
    groups = -(-plan.grid // plan.group)
    per = ("" if plan.variant == "scalar" else f"nv{plan.nv} ") + (
        f"{plan.rows_per_block} rows a block" if plan.variant == "warp"
        else f"{plan.threads} threads a row")
    return (f"{plan.variant} {per}, grid {plan.grid}, dw sum "
            + ("1 level" if groups == 1 else f"2 levels ({groups} groups)"))


def time_row(row, name, args, dn):
    nbytes, flops = cost(name, args)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dn)
    row["ms"], row["host_ms"] = time_ms(lambda: KERNEL_FN[name](*args))
    row["plain_ms"], row["plain_host_ms"] = time_ms(
        lambda: PLAIN_FN[name](*args))
    row["library_ms"], row["library_host_ms"] = time_ms(
        library_call(name, args))
    cold = ""
    if name == "matmul" and row["shape"].startswith("decode"):
        bs = cold_weights(args[1])
        row["cold_copies"] = len(bs)
        row["cold_ms"], row["cold_host_ms"] = time_ms(
            rotating(ops.matmul, args[0], bs))
        row["library_cold_ms"], row["library_cold_host_ms"] = time_ms(
            rotating(torch.matmul, args[0], bs))
        del bs
        cold = (f" cold {row['cold_ms']:.4f} (library "
                f"{row['library_cold_ms']:.4f})")
    path = f" [{row['path']}]" if "path" in row else ""
    print(f"[kernels] {name:15s} {row['shape']:42s} {dn} err "
          f"{row['max_abs_err']:.2e}{path}  device ms: kernel "
          f"{row['ms']:.4f}{cold} plain {row['plain_ms']:.4f} library "
          f"{row['library_ms']:.4f} bound {row['bound_ms']:.5f} "
          f"({row['bound_by']});  host ms: kernel {row['host_ms']:.4f} "
          f"plain {row['plain_host_ms']:.4f} library "
          f"{row['library_host_ms']:.4f}")


def phase_kernels(cfg):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    rows, worst = [], {}
    f32 = torch.float32
    floor = dict(zip(("ms", "host_ms"), time_ms(lambda: torch.cuda._sleep(0))))
    print(f"[kernels] floor: an empty kernel (torch.cuda._sleep(0), a "
          f"yardstick only) device ms {floor['ms']:.4f} host ms "
          f"{floor['host_ms']:.4f}")
    cases = ([(n, lab, sp, (f32,)) for n, lab, sp in main_path_cases(cfg)]
             + [(n, lab, sp, (f32, torch.bfloat16))
                for n, lab, sp in LONG_CASES]
             + [(n, f"awkward {sp}", sp, ()) for n, sp in AWKWARD])
    for dtype in (f32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for name, label, spec, timed in cases:
            args = make_args(name, spec, dtype, gen)
            got = KERNEL_FN[name](*args)
            want = PLAIN_FN[name](*args)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dn)
            worst[name] = max(worst.get(name, 0.0), err)
            row = {"kernel": name, "shape": label, "dtype": dn,
                   "max_abs_err": err}
            if name == "matmul":
                row["path"] = matmul_path(*args)
            if name == "rmsnorm":
                row["path"] = rms_path(rms_plan_for(*args))
            if dtype in timed:
                time_row(row, name, args, dn)
            rows.append(row)
            del args, got, want
    print(f"[kernels] {len(rows)} cases agree; max abs err per kernel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return rows, floor


# every RMSNorm variant forced at each shape it can take, with w in either
# dtype beside x in either, held against the plain version; the shapes in
# RMS_TIMED also timed per variant with w in x's dtype (the reading behind
# plan_rmsnorm's choice)
RMS_VARIANT_SHAPES = [(4, 576), (31, 576), (2048, 576), (8192, 4096),
                      (37, 577), (3, 7168), (1, 8), (5, 96)]
RMS_TIMED = {(4, 576), (31, 576), (2048, 576), (8192, 4096)}


def phase_rms_variants():
    gen = torch.Generator().manual_seed(4)
    rows, dts = [], (torch.float32, torch.bfloat16)
    for (n, D), xd, wd in itertools.product(RMS_VARIANT_SHAPES, dts, dts):
        dn, wn = (str(t).split(".")[1] for t in (xd, wd))
        x, w = randn((n, D), xd, 1.0, gen), randn((D,), wd, 0.1, gen)
        want = ref.rmsnorm_ref(x, w)
        timed = (n, D) in RMS_TIMED and xd == wd
        row = {"shape": f"{n}x{D}", "dtype": dn, "w_dtype": wn,
               "plan": rms_path(rms_plan_for(x, w))}
        for variant in variants_for(D, D, xd):
            plan = rms_plan_for(x, w, variant)
            got = rmsnorm_cuda(x, w, plan=plan)
            row[variant] = {"path": rms_path(plan),
                            "max_abs_err": check_close("rmsnorm", got, want,
                                                       dn)}
            if timed:
                row[variant]["ms"], row[variant]["host_ms"] = time_ms(
                    lambda: rmsnorm_cuda(x, w, plan=plan))
        rows.append(row)
        if timed:
            print(f"[variants] rmsnorm {dn} {row['shape']} (plan: "
                  f"{row['plan']}) device ms: " + ", ".join(
                      f"{v} {row[v]['ms']:.4f} [{row[v]['path']}]"
                      for v in VARIANTS if v in row))
        del x, w, want
    print(f"[variants] {len(rows)} RMSNorm cases agree in every variant "
          f"that takes them")
    return rows


def rms_bwd_tol(dn, wn, want_dw):
    """(dx tol, dw tol): GRAD_TOL in f32, the RMSNorm bf16 tolerance where x
    or w is bf16; dw sums a column over the rows, so its atol scales with
    its largest magnitude."""
    tol = GRAD_TOL if "bfloat16" not in (dn, wn) \
        else TOL["rmsnorm"]["bfloat16"]
    scale = max(1.0, float(want_dw.float().abs().max()))
    return tol, (tol[0], tol[1] * scale)


def phase_rms_bwd_variants():
    """Every RMSNorm backward variant forced at each shape of
    RMS_VARIANT_SHAPES it can take (x and w in f32 and bf16), held against
    ref.rmsnorm_bwd_ref, with the same bits on a second call; timed at
    RMS_TIMED with w in x's dtype, and at the timed shapes of 2048 rows or
    more also with the plan's grid at 1, 2 and 4 blocks an SM, and at 2
    with the partials summed by one block in one level (the readings
    behind BWD_BLOCKS_PER_SM and the two-level sum)."""
    gen = torch.Generator().manual_seed(6)
    rows, dts = [], (torch.float32, torch.bfloat16)
    for (n, D), xd, wd in itertools.product(RMS_VARIANT_SHAPES, dts, dts):
        dn, wn = (str(t).split(".")[1] for t in (xd, wd))
        x, w = randn((n, D), xd, 1.0, gen), randn((D,), wd, 0.1, gen)
        dy = randn((n, D), xd, 1.0, gen)
        want = ref.rmsnorm_bwd_ref(x, w, dy)
        tol_dx, tol_dw = rms_bwd_tol(dn, wn, want[1])
        timed = (n, D) in RMS_TIMED and xd == wd
        row = {"shape": f"{n}x{D}", "dtype": dn, "w_dtype": wn,
               "plan": rms_bwd_path(bwd_plan_for(x, w, dy))}
        for variant in variants_for(D, D, xd):
            plan = bwd_plan_for(x, w, dy, variant)
            got = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
            again = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"rmsnorm_bwd {variant} {row['shape']}"
                                     f" {dn}/{wn}: two runs differ")
            row[variant] = {"path": rms_bwd_path(plan), "max_abs_err": max(
                check_close("rmsnorm_bwd dx", got[0], want[0], dn, tol_dx),
                check_close("rmsnorm_bwd dw", got[1], want[1], wn, tol_dw))}
            if timed:
                row[variant]["ms"], row[variant]["host_ms"] = time_ms(
                    lambda: rmsnorm_bwd_cuda(x, w, dy, plan=plan))
        if timed and n >= 2048:
            sms = _build.sm_count(x.device.index)
            row["grid_sweep"] = {}
            plans = {f"{k} block{'s' * (k > 1)} an SM": plan_rmsnorm_bwd(
                n, D, D, xd, wd, sms=sms * k // BWD_BLOCKS_PER_SM)
                for k in (1, 2, 4)}
            one = plans["2 blocks an SM"]
            vals = list(one.params)
            vals[12] = one.grid          # one group: a one-level sum
            plans["2 blocks an SM, one level"] = replace(
                one, group=one.grid, counters=1,
                params=(ctypes.c_int64 * len(vals))(*vals))
            for key, plan in plans.items():
                got = rmsnorm_bwd_cuda(x, w, dy, plan=plan)
                check_close("rmsnorm_bwd dx", got[0], want[0], dn, tol_dx)
                check_close("rmsnorm_bwd dw", got[1], want[1], wn, tol_dw)
                row["grid_sweep"][key] = {
                    "path": rms_bwd_path(plan), "ms": time_ms(
                        lambda: rmsnorm_bwd_cuda(x, w, dy, plan=plan))[0]}
        rows.append(row)
        if timed:
            print(f"[variants] rmsnorm_bwd {dn} {row['shape']} (plan: "
                  f"{row['plan']}) device ms: " + ", ".join(
                      f"{v} {row[v]['ms']:.4f} [{row[v]['path']}]"
                      for v in VARIANTS if v in row))
        for key, r in row.get("grid_sweep", {}).items():
            print(f"[variants] rmsnorm_bwd {dn} {row['shape']} grid at "
                  f"{key}: {r['ms']:.4f} ms [{r['path']}]")
        del x, w, dy, want
    print(f"[variants] {len(rows)} RMSNorm backward cases agree in every "
          f"variant that takes them, each with the same bits on a repeat")
    return rows


# (K, N, B = embed.T, the M to time) per dtype: the MLP projections, whose
# weights sit in L2, the tied head, whose 49152-wide weight does not, and
# the tied head's backward dX = dC embed (row-major B beyond the L2)
CROSSOVER = {
    torch.float32: [(576, 1536, False, (16, 64, 256, 512, 768, 1024)),
                    (1536, 576, False, (16, 64, 256, 512, 768, 1024)),
                    (576, 49152, True, (4, 16, 32, 64)),
                    (49152, 576, False, (16, 32, 64, 128, 256, 512))],
    torch.bfloat16: [(576, 1536, False, (16, 32, 64, 128)),
                     (1536, 576, False, (16, 32, 64, 128)),
                     (576, 49152, True, (1, 4, 8, 16, 32)),
                     (49152, 576, False, (16, 32, 64, 128))]}


def phase_crossover():
    """Where the skinny path stops paying: both matmul paths forced at M
    around the skinny threshold (matmul.SKINNY_MAX_M), each held against
    the plain version."""
    gen = torch.Generator().manual_seed(3)
    rows = []
    for dtype, shapes in CROSSOVER.items():
        dn = str(dtype).split(".")[1]
        for K, N, colb, ms in shapes:
            for M in ms:
                a, b = matmul_case(M, K, N, dtype, gen, strided_b=colb)
                want = ref.matmul_ref(a, b)
                row = {"M": M, "K": K, "N": N, "embed_T": colb, "dtype": dn}
                for path, smax in (("skinny", 1 << 30), ("tiled", 0)):
                    plan = plan_for(a, b, skinny_max=smax)
                    check_close("matmul", matmul_cuda(a, b, plan), want, dn)
                    row[path + "_ms"], _ = time_ms(
                        lambda: matmul_cuda(a, b, plan))
                row["library_ms"], _ = time_ms(lambda: torch.matmul(a, b))
                print(f"[crossover] {dn} {M}x{K}x{N}"
                      f"{' (B=embed.T)' if colb else ''}: skinny "
                      f"{row['skinny_ms']:.4f} tiled {row['tiled_ms']:.4f} "
                      f"library {row['library_ms']:.4f} ms (threshold "
                      f"M <= {skinny_max_m(K, N, dtype, colb)})")
                rows.append(row)
                del a, b, want
    return rows


# -- phase 3: serve at full width ---------------------------------------------

def per_step_launches(cfg):
    """Kernel launches the model makes per prefill and per decode step."""
    L = cfg.n_layers
    return ({"rmsnorm": 2 * L + 1, "matmul": 7 * L + 1, "flash_attention": L},
            {"rmsnorm": 2 * L + 1, "matmul": 7 * L + 1, "flash_attention": 0})


def phase_serve(cfg):
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    for k in ops.launches:
        ops.launches[k] = 0
    t0 = time.perf_counter()
    eng = serve.main(SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    print(f"[serve] launches on the main path: {launches}")
    if any(launches[k] for k in launches if k not in FORWARD):
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{launches}")
    launches = {k: launches[k] for k in FORWARD}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    per_pre, per_dec = per_step_launches(cfg)
    expect = {k: len(pre) * per_pre[k] + len(dec) * per_dec[k]
              for k in launches}
    if launches != expect:
        raise AssertionError(f"launches {launches} != {len(pre)} prefills "
                             f"and {len(dec)} decode steps: {expect}")
    toks = [t for r in eng.results.values() for t in r.tokens]
    if len(eng.results) != 8 or any(len(r.tokens) != 16
                                    for r in eng.results.values()) \
            or not all(0 <= t < cfg.vocab for t in toks):
        raise AssertionError("serve results have the wrong count or range")
    engine_s = sum(pre) + sum(dec)
    serve_stats = {
        "requests": len(eng.results), "tokens": len(toks),
        "main_wall_s": wall, "engine_s": engine_s,
        "tokens_per_s": len(toks) / engine_s,
        "prefill_ms_mean": 1e3 * float(np.mean(pre)),
        "prefill_ms_median": 1e3 * float(np.median(pre)),
        "prefill_ms_first": 1e3 * pre[0],
        "decode_ms_mean": 1e3 * float(np.mean(dec)),
        "decode_ms_median": 1e3 * float(np.median(dec)),
        "decode_steps": len(dec), "launches": launches,
        "launches_per_prefill": per_pre, "launches_per_decode_step": per_dec,
    }
    print(f"[serve] {json.dumps(serve_stats)}")

    # the same weights through the port on the CPU: prefill logits of two
    # prompts, then 8 teacher-forced decode steps
    gpu = Model(cfg, device="cuda")
    cpu = Model(cfg, device="cpu")
    p_gpu = eng.params
    p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
             for g, sub in p_gpu.items()}
    rng = np.random.default_rng(1)
    worst = 0.0
    rtol, atol = SERVE_TOL
    for n in (13, 29):
        toks = rng.integers(0, cfg.vocab, size=(1, n + 8))
        outs = []
        for model, params in ((gpu, p_gpu), (cpu, p_cpu)):
            dev = model.device
            tt = torch.from_numpy(toks).to(dev)
            lg, cache, _ = model.prefill(params, {"tokens": tt[:, :n]}, 64)
            seq = [lg.float().cpu()]
            for i in range(8):
                lg, cache = model.decode_step(
                    params, cache, torch.tensor([n + i], device=dev),
                    {"tokens": tt[:, n + i:n + i + 1]})
                seq.append(lg.float().cpu())
            outs.append(torch.stack(seq))
        g, c = outs
        err = (g - c).abs()
        if not torch.isfinite(g).all() or \
                bool((err > atol + rtol * c.abs()).any()):
            raise AssertionError(f"CUDA vs CPU logits disagree for a "
                                 f"{n}-token prompt: max abs err "
                                 f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    print(f"[serve] CUDA vs CPU logits (prefill + 8 decode steps, 2 "
          f"prompts): max abs err {worst:.3e} (rtol {rtol}, atol {atol})")
    serve_stats["cpu_max_abs_err"] = worst
    return serve_stats, p_gpu


def phase_profile(cfg, params, steps: int = 5):
    """Where a decode step's time goes: torch.profiler (CUPTI) over
    ``steps`` engine steps of a full batch (4 slots, 16-token prompts)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    eng = Engine(Model(cfg, device="cuda"), params,
                 ServeConfig(batch_size=4, s_max=256, max_new_tokens=64))
    rng = np.random.default_rng(2)
    for uid in range(4):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab, size=(16,))))
    eng.step()                      # admit the 4 requests + one decode step
    eng.step()
    torch.cuda.synchronize()
    n_dec = len(eng.timings["decode_s"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dec_ms = 1e3 * float(np.mean(eng.timings["decode_s"][n_dec:]))
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("[profile] the profiler recorded no device events; device "
              "busy share not measured")
        return {"decode_ms_profiled": dec_ms, "device_events": 0}
    busy = sum(e.time_range.elapsed_us() for e in dev)
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    by_name = {}
    for e in dev:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    ours = {k: [(c, t) for n, (c, t) in by_name.items()
                if any(f in n for f in frags)]
            for k, frags in KERNEL_NAMES.items()}
    out = {
        "decode_ms_profiled": dec_ms,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_span_ms_per_step": span / steps / 1e3,
        "device_idle_share": 1.0 - busy / span,
        "device_events_per_step": len(dev) / steps,
        "port_kernels_per_step": {k: sum(c for c, _ in v) / steps
                                  for k, v in ours.items()},
        "port_kernel_ms_per_step": {k: sum(t for _, t in v) / steps / 1e3
                                    for k, v in ours.items()},
        "top_device_time_per_step": [
            {"name": n[:80], "count": c / steps, "us": t / steps}
            for n, (c, t) in top],
    }
    print(f"[profile] decode step under the profiler {dec_ms:.2f} ms; device "
          f"busy {out['device_busy_ms_per_step']:.3f} ms of a "
          f"{out['device_span_ms_per_step']:.3f} ms span (idle share "
          f"{out['device_idle_share']:.3f}); "
          f"{out['device_events_per_step']:.0f} device events per step, of "
          f"which ours "
          f"{out['port_kernels_per_step']} taking "
          f"{out['port_kernel_ms_per_step']} ms")
    for row in out["top_device_time_per_step"]:
        print(f"[profile]   {row['us']:9.1f} us  x{row['count']:5.1f}  "
              f"{row['name']}")
    return out


# -- phase 5: gradients (the backward kernels) --------------------------------

STUDY = dict(batch=2, seq=32)       # the tuning loop's traffic
GRAD_TOL = (1e-4, 1e-4)             # f32 backward kernel vs plain version
# a CUDA study's gradients against the port's CPU run: f32 sums in another
# order; atol scales with the tensor's largest magnitude (tests/
# test_torch_cuda.py test_study_thunk_grads_match_cpu_port)
STUDY_TOL = (1e-4, 1e-5)


def flash_bwd_cost(q, k):
    """(bytes, flops) of the attention backward on these inputs: q, k, v,
    o, dO and lse read once, dq, dk, dv written once; per visible (query,
    key) pair of each query head 5 products of 2 d flops (S recomputed, dP,
    dV, dK, dQ)."""
    B, Sq, H, d = q.shape
    es = elem(q.dtype)
    nbytes = (4 * q.numel() + 4 * k.numel()) * es + B * H * Sq * 4
    return nbytes, 10 * d * B * H * causal_pairs(Sq, k.shape[1])


def rms_bwd_cost(x, w):
    """x and dy read, dx written, w read and dw written once; ~8 flops an
    element."""
    es = elem(x.dtype)
    return 3 * x.numel() * es + 2 * w.numel() * w.element_size(), \
        8 * x.numel()


# bf16 flash backward against its plain version: the kernel rounds P and dS
# to bf16 before their products (the plain version keeps them f32), both
# round the outputs: rtol 2e-2 (a few ulps of the element) and atol 1e-2 x
# the tensor's largest magnitude (tests/test_torch_cuda.py BWD_TOL_BF16)
GRAD_TOL_BF16 = (2e-2, 1e-2)


def grad_case_flash(label, dims, bk, gen, timed=True, dtype=torch.float32):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_flash_bwd)
    B, Sq, Skv, H, KVH, d = dims
    dn = str(dtype).split(".")[1]
    q, k, v = flash_case(B, Sq, Skv, H, KVH, d, dtype, gen)
    do = randn((B, Sq, H, d), dtype, 1.0, gen)
    o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True)
    run = lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,  # noqa: E731
                                           bk=bk)
    got, again = run(), run()
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    plan = plan_flash_bwd(q, k, v, o, do, bk)

    def tol(w):
        if dtype == torch.float32:
            return GRAD_TOL
        rtol, arel = GRAD_TOL_BF16
        return rtol, arel * float(w.float().abs().max())
    row = {"kernel": "flash_attention_bwd", "shape": label, "dtype": dn,
           "tile": plan.tile, "bk": bk, "splits": plan.splits,
           "grid": plan.grid,
           "bit_identical": all(torch.equal(a, b) for a, b in zip(got, again)),
           "max_abs_err": max(check_close(label, g, w, dn, tol(w))
                              for g, w in zip(got, want))}
    if not row["bit_identical"]:
        raise AssertionError(f"flash_attention_bwd {label}: two runs differ")
    if timed:
        nbytes, flops = flash_bwd_cost(q, k)
        plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
            q, k, v, o, lse, do)
        # library: SDPA's backward alone (autograd of one forward), on the
        # heads expanded to H as SDPA takes them
        G = H // KVH
        lq = q.transpose(1, 2).contiguous().requires_grad_()
        lk = k.repeat_interleave(G, 2).transpose(1, 2).contiguous() \
            .requires_grad_()
        lv = v.repeat_interleave(G, 2).transpose(1, 2).contiguous() \
            .requires_grad_()
        assert Sq == Skv          # is_causal aligns top-left
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        ldo = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lo, (lq, lk, lv), ldo, retain_graph=True)
        grad_timing(row, run, plain, lib, nbytes, flops)
    return row


def grad_case_rms(label, rows_, D, dtype, gen, timed=True):
    x, w = rms_case(rows_, D, dtype, gen)
    dy = randn((rows_, D), dtype, 1.0, gen)
    run = lambda: rmsnorm_bwd_cuda(x, w, dy)  # noqa: E731
    got, again = run(), run()
    want = ref.rmsnorm_bwd_ref(x, w, dy)
    torch.cuda.synchronize()
    dn = str(dtype).split(".")[1]
    tol_dx, tol_dw = rms_bwd_tol(dn, dn, want[1])
    plan = bwd_plan_for(x, w, dy)
    row = {"kernel": "rmsnorm_bwd", "shape": label, "dtype": dn,
           "path": rms_bwd_path(plan),
           "plan": {k: getattr(plan, k) for k in (
               "variant", "nv", "threads", "rows_per_block", "grid", "group",
               "ws_rows", "counters")},
           "bit_identical": all(torch.equal(a, b) for a, b in zip(got, again)),
           "max_abs_err": max(check_close(label, got[0], want[0], dn, tol_dx),
                              check_close(label, got[1], want[1], dn,
                                          tol_dw))}
    if not row["bit_identical"]:
        raise AssertionError(f"rmsnorm_bwd {label}: two runs differ")
    if timed:
        nbytes, flops = rms_bwd_cost(x, w)
        lx = x.clone().requires_grad_()
        lw = (1.0 + w).detach().requires_grad_()
        ly = F.rms_norm(lx, (D,), weight=lw, eps=1e-5)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            ly, (lx, lw), dy, retain_graph=True)
        grad_timing(row, run, lambda: ref.rmsnorm_bwd_ref(x, w, dy), lib,
                    nbytes, flops)
    return row


def grad_case_matmul(label, a, b, timed=True):
    """One product of a matmul backward (dA = dC B^T or dB = A^T dC) on
    transposed views, through the forward kernel."""
    got = ops.matmul(a, b)
    again = ops.matmul(a, b)
    want = ref.matmul_ref(a, b)
    torch.cuda.synchronize()
    row = {"kernel": "matmul", "shape": label, "dtype": "float32",
           "path": matmul_path(a, b),
           "bit_identical": torch.equal(got, again),
           "max_abs_err": check_close("matmul", got, want, "float32")}
    if not row["bit_identical"]:
        raise AssertionError(f"matmul {label}: two runs differ")
    if timed:
        nbytes, flops = cost("matmul", (a, b))
        grad_timing(row, lambda: ops.matmul(a, b),
                    lambda: ref.matmul_ref(a, b),
                    lambda: torch.matmul(a, b), nbytes, flops)
    return row


def grad_timing(row, run, plain, lib, nbytes, flops):
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, row["dtype"])
    row["ms"], row["host_ms"] = time_ms(run)
    row["plain_ms"], _ = time_ms(plain, reps=5)
    row["library_ms"], row["library_host_ms"] = time_ms(lib)
    tile = f" [tile {row['tile']}, splits {row['splits']}]" \
        if "tile" in row else \
        (f" [{row['path']}]" if "path" in row else "")
    print(f"[grads] {row['kernel']:19s} {row['shape']:44s} {row['dtype']} "
          f"err {row['max_abs_err']:.2e}{tile} same bits on repeat: "
          f"{row['bit_identical']}  device ms: kernel {row['ms']:.4f} plain "
          f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
          f"{row['bound_ms']:.5f} ({row['bound_by']});  host ms: kernel "
          f"{row['host_ms']:.4f} library {row['library_host_ms']:.4f}")


def _random_norms(study, seed):
    gen = torch.Generator().manual_seed(seed)
    for sub in study.params.values():
        for nm, t in sub.items():
            if nm.endswith("ln"):
                t.copy_((torch.randn(t.shape, generator=gen) * 0.1)
                        .to(t.device))


def phase_grads(cfg):
    """Each backward kernel against its plain version at the tuning loop's
    full-width shapes (and long-prompt and wide rows), timed beside its
    bound, plain version and one PyTorch library call; then one
    full-width attn_fb, dense_fb and embed_loss_fb gradient of the study
    on the card against the port's CPU run."""
    from repro_torch.tune.lm_study import LMStudy, StepKnobs, _flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    H, KVH, d, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    F_, V = cfg.d_ff, cfg.vocab
    S = STUDY["seq"]
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for mb in (2, 1):
            for bk in (16, 64):
                rows.append(grad_case_flash(
                    f"study mb{mb} S{S} H{H}/{KVH} d{d} kv{bk}",
                    (mb, S, S, H, KVH, d), bk, gen, dtype=dt))
        rows.append(grad_case_flash(
            f"long prompt B1 S2048 H{H}/{KVH} d{d} kv64",
            (1, 2048, 2048, H, KVH, d), 64, gen, dtype=dt))
    for n in (2 * S, S):
        rows.append(grad_case_rms(f"study {n}x{D}", n, D, torch.float32, gen))
    for dt in (torch.float32, torch.bfloat16):
        rows.append(grad_case_rms("wide 8192x4096", 8192, 4096, dt, gen))
    # the matmul backward's products at mb 2 (M = 64 tokens): dA = dC W^T
    # and dW = A^T dC per projection, and the tied head's dX = dC embed and
    # d(embed^T) = X^T dC
    M = 2 * S
    for what, K, N in (("q/o", D, H * d), ("k/v", D, KVH * d),
                       ("gate/up", D, F_), ("down", F_, D)):
        w = randn((K, N), torch.float32, 1.0 / math.sqrt(K), gen)
        x = randn((M, K), torch.float32, 1.0, gen)
        dc = randn((M, N), torch.float32, 1.0, gen)
        rows.append(grad_case_matmul(f"{what} dA = dC W^T {M}x{N}x{K}",
                                     dc, w.T))
        rows.append(grad_case_matmul(f"{what} dW = A^T dC {K}x{M}x{N}",
                                     x.T, dc))
    emb = randn((V, D), torch.float32, 0.02, gen)
    x = randn((M, D), torch.float32, 1.0, gen)
    dc = randn((M, V), torch.float32, 1e-3, gen)
    rows.append(grad_case_matmul(f"tied head dX = dC embed {M}x{V}x{D}",
                                 dc, emb))
    rows.append(grad_case_matmul(f"tied head dE^T = X^T dC {D}x{M}x{V}",
                                 x.T, dc))
    del emb, x, dc
    print(f"[grads] {len(rows)} backward cases agree with their plain "
          f"versions, each with the same bits on a second run")

    # one full-width gradient of each kind, card against the port's CPU run
    studies = [LMStudy("smollm-135m", reduced=False, device=dv, **STUDY)
               for dv in ("cuda", "cpu")]
    for st in studies:
        _random_norms(st, 11)
    checks = []
    rtol, atol = STUDY_TOL
    for kind, mk in (
            ("attn_fb kv16 remat full", lambda st: st._mixer_kernel(
                "attn", 0, StepKnobs("k", remat="full", kv_chunk=16), 2)),
            ("dense_fb", lambda st: st._ffn_kernel(
                "dense", 0, StepKnobs("k"), 2)),
            ("embed_loss_fb", lambda st: st._embed_loss_kernel(
                StepKnobs("k"), 2))):
        out = []
        for st in studies:
            fn, args = mk(st)[1]()
            out.append(fn(*args))
        worst = 0.0
        for (path, g), (_, c) in zip(_flatten(out[0]), _flatten(out[1])):
            g = g.cpu()
            err = (g - c).abs()
            lim = atol * max(1.0, float(c.abs().max())) + rtol * c.abs()
            if not torch.isfinite(g).all() or bool((err > lim).any()):
                raise AssertionError(f"[grads] {kind} {'/'.join(path)}: card "
                                     f"vs CPU max abs err "
                                     f"{float(err.max()):.3e}")
            worst = max(worst, float((err / c.abs().max().clamp(min=1))
                                     .max()))
        checks.append({"kernel": kind, "max_err_over_scale": worst})
        print(f"[grads] full-width {kind}: card vs the port's CPU run, every "
              f"gradient within rtol {rtol} and atol {atol} x its largest "
              f"magnitude (max err / scale {worst:.2e})")
    del studies
    torch.cuda.empty_cache()
    return rows, checks


# -- phase 6: the wall-clock tuning loop --------------------------------------

def _zero_counts():
    for k in ops.launches:
        ops.launches[k] = 0
        ops.plain_calls[k] = 0


def phase_tune(cfg):
    """LMStudy at full width on the card: a 12-point conditional session
    (trials 3) and a race, with the launch counters zeroed just before and
    read just after; then launches per thunk and one step's breakdown."""
    from repro_torch.tune.lm_study import LMStudy, lm_config_space
    study = LMStudy("smollm-135m", reduced=False, **STUDY)
    _zero_counts()
    t0 = time.perf_counter()
    res = study.session(policy="conditional", tolerance=0.25,
                        trials=3).run()
    wall = time.perf_counter() - t0
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    print(f"[tune] session launches: {launches}; plain calls: {plain}")
    if any(plain.values()):
        raise AssertionError(f"the tuning loop called plain versions: {plain}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched by the tuning loop: "
                             f"{missing}")
    if len(res.records) != 12:
        raise AssertionError(f"{len(res.records)} configurations, not 12")
    for r in res.records:
        if not (math.isfinite(r.predicted) and r.predicted > 0
                and r.full_time > 0):
            raise AssertionError(f"[tune] {r.name}: bad times {r.to_json()}")
        print(f"[tune] {r.name:26s} predicted {1e3 * r.predicted:8.3f} ms "
              f"full reference {1e3 * r.full_time:8.3f} ms (rel err "
              f"{r.rel_error:+.3f}) executed {r.executed:5d} skipped "
              f"{r.skipped:5d} cost {1e3 * r.selective_cost:8.2f} ms")
    print(f"[tune] chosen {res.chosen.name} true best {res.true_best.name} "
          f"(optimum quality {res.optimum_quality:.4f}); speedup "
          f"{res.speedup:.3f}x (full {res.full_tuning_time:.3f} s, selective "
          f"{res.selective_tuning_time:.3f} s); session wall {wall:.1f} s")
    session = {"records": [r.to_json() for r in res.records],
               "chosen": res.chosen.name, "true_best": res.true_best.name,
               "speedup": res.speedup,
               "optimum_quality": res.optimum_quality,
               "full_tuning_time_s": res.full_tuning_time,
               "selective_tuning_time_s": res.selective_tuning_time,
               "wall_s": wall, "launches": launches}

    _zero_counts()
    t0 = time.perf_counter()
    race = study.race(policy="conditional", tolerance=0.25)
    race_wall = time.perf_counter() - t0
    race_launches, plain = dict(ops.launches), dict(ops.plain_calls)
    if any(plain.values()):
        raise AssertionError(f"the race called plain versions: {plain}")
    best = race.extra.get("best")
    print(f"[tune] race: winner {best} cost {race.selective_tuning_time:.3f} "
          f"s over {len(race.records)} configurations (wall "
          f"{race_wall:.1f} s); launches {race_launches}")

    # launches per thunk, by kernel name, and one step of the chosen config
    knobs = {k.name: k for k in lm_config_space(study.cfg)}
    per_thunk = {}
    for name in (res.chosen.name, "ga1-full-kv64-sort-ssm16"):
        for sig, thunk, freq in study.kernels_of(knobs[name]):
            if str(sig) in per_thunk:
                continue
            _zero_counts()
            thunk()
            per_thunk[str(sig)] = {k: v for k, v in ops.launches.items()
                                   if v}
    for sig, counts in per_thunk.items():
        print(f"[tune] launches per thunk {sig}: {counts}")
    step = tune_step_breakdown(study, knobs[res.chosen.name])
    return {"session": session, "race": {
        "winner": best, "cost_s": race.selective_tuning_time,
        "configs": len(race.records), "wall_s": race_wall,
        "launches": race_launches}, "launches_per_thunk": per_thunk,
        "step": step}


def tune_step_breakdown(study, knobs, reps: int = 3):
    """Where one full step of a configuration goes: each thunk's host-clock
    ms (each ends in a synchronize) times its occurrences, least of
    ``reps``; and torch.profiler over one step (device busy, idle share,
    device time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
    seq = study.kernels_of(knobs)
    by_sig = {}
    for sig, thunk, freq in seq:
        if str(sig) in by_sig:
            continue
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            thunk()
            ts.append(time.perf_counter() - t0)
        by_sig[str(sig)] = {"ms": 1e3 * min(ts), "freq": freq}
    step_ms = sum(v["ms"] for sig, thunk, freq in seq
                  for v in [by_sig[str(sig)]])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sig, thunk, freq in seq:
            thunk()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"config": knobs.name, "thunks": by_sig,
           "step_ms_sum_of_thunks": step_ms, "step_ms_profiled": prof_ms}
    for sig, v in by_sig.items():
        print(f"[tune] step {knobs.name}: {sig} {v['ms']:.3f} ms x "
              f"{v['freq']} = {v['ms'] * v['freq']:.2f} ms")
    if not dev:
        print("[tune] the profiler recorded no device events; device busy "
              "share not measured")
        return out
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3
    by_name = {}
    for e in dev:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    ours = {k: sum(t for n, (c, t) in by_name.items()
                   if any(f in n for f in frags))
            for k, frags in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out.update({"device_busy_ms": busy, "device_span_ms": span,
                "device_idle_share": 1.0 - busy / span,
                "device_events": len(dev), "port_kernel_ms": ours,
                "top_device_ms": [{"name": n[:80], "count": c, "ms": t}
                                  for n, (c, t) in top]})
    print(f"[tune] step {knobs.name}: sum of thunks {step_ms:.2f} ms; "
          f"profiled step {prof_ms:.2f} ms, device busy {busy:.3f} ms of a "
          f"{span:.3f} ms span (idle share {1.0 - busy / span:.3f}), "
          f"{len(dev)} device events; ours (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ours.items()))
    for row in out["top_device_ms"]:
        print(f"[tune]   {row['ms']:8.3f} ms  x{row['count']:5d}  "
              f"{row['name']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full tables here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    from repro_torch.configs import get_config
    cfg = get_config("smollm-135m")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    card, ptxas = phase_build()
    rows, floor = phase_kernels(cfg)
    variants = phase_rms_variants()
    bwd_variants = phase_rms_bwd_variants()
    crossover = phase_crossover()
    serve_stats, params = phase_serve(cfg)
    serve_stats["profile"] = phase_profile(cfg, params)
    del params
    torch.cuda.empty_cache()
    grad_rows, grad_checks = phase_grads(cfg)
    tune = phase_tune(cfg)

    # one entry per kernel: its largest main-path shape at f32 (forward:
    # the serving path's, launches counted there; backward: the tuning
    # loop's, launches counted over its session)
    rep = {"matmul": "decode tied head", "rmsnorm": "decode",
           "flash_attention": "prefill",
           "flash_attention_bwd": "study mb2 S32 H9/3 d64 kv16",
           "rmsnorm_bwd": "study 64x576"}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        table = rows if name in FORWARD else grad_rows
        row = next(r for r in table if r["kernel"] == name
                   and r["dtype"] == "float32"
                   and r["shape"].startswith(rep[name]))
        launches = (serve_stats["launches"][name] if name in FORWARD
                    else tune["session"]["launches"][name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_tune": tune["session"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in table
                               if r["kernel"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "status": "ported, agrees with its plain version"
            if name in FORWARD else
            "backward of the TPU kernel, agrees with its plain version"})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernels": kernels,
                                        "cases": rows, "floor": floor,
                                        "rms_variants": variants,
                                        "rms_bwd_variants": bwd_variants,
                                        "crossover": crossover,
                                        "ptxas": ptxas, "serve": serve_stats,
                                        "grads": grad_rows,
                                        "grad_checks": grad_checks,
                                        "tune": tune},
                                       indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
