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
              card against the port's CPU run; then "offsets": the flash
              forward and backward at query offsets, a causal sequence
              split into 4 shards of queries as cp on a model axis of 4
              splits it ([train]'s microbatch 4 x 128 in f32 and bf16, a
              2048-token prompt in bf16; (64, 64) over 9/3 heads, (192,
              128) over 128/128, (24, 16) over 4/4): each shard against
              its plain version at its offset and against the whole
              call's rows, the shards' dk and dv summed against the whole
              call's, dk and dv past a shard's last position exactly 0;
              each shard's and the whole call's device ms beside its bound
              (its own bytes and pairs), plain version and SDPA on the K/V
              prefix with a lower-right causal mask;
6. tune    -- LMStudy("smollm-135m", reduced=False, batch=2, seq=32) on
              the card: a 12-point conditional session (tolerance 0.25,
              trials 3) and a race, with the launch counters zeroed just
              before and read just after (every kernel, forward and
              backward, must launch; no plain version may run); per
              configuration the predicted and full-reference step, the
              executed and skipped kernels; chosen vs true best; launches
              per thunk by kernel; one step of the chosen configuration
              broken down by thunk and under the profiler;
7. daemon  -- the always-on tuning daemon (repro_torch.serve.tuner):
              first its thunks at the shapes no earlier phase runs (batch
              2 and 4 of 16 tokens: attn_fb at KV chunk 16 and 64, remat
              none and full, dense_fb, embed_loss_fb) on the card against
              the port's CPU run; "parity", the reduced demo synchronous
              on virtual clocks on
              the card and on the CPU, whose summaries (journal included)
              must be equal; "full width", the CLI's `--daemon` at full
              width in the background with the launch counters zeroed
              just before and read just after (every shape tuned, drift
              detected and every re-tune settled, no banked kernel re-run
              cold in steady state, every kernel launched, no plain
              version, no failed study in the journal); "wall clock", the
              daemon on its default clocks over the demo's three shapes
              (first tunes and steady serving): per shape the winner, the
              kernels a tuned step executes, skips and forces, the charged
              step against one full execution of the winner's kernels, and
              the host ms of a shadow serve step with another shape's
              study in flight and with none;
8. sim     -- the golden protocol of tests/golden_runner.py through the
              port's copy of the simulator, equal to
              tests/golden_reports.json bit for bit;
9. measured -- the paper's SLATE Cholesky (conditional and eager) and
              CANDMC QR (conditional) ci tuning studies through
              core/tuner.py's Autotuner with linalg/blas.py's MeasuredTimer
              on the card (gemm, syrk, trmm, ormqr, tpmqrt on the matmul
              kernel; trsm, trtri, potrf, geqrf, tpqrt on torch.linalg),
              the launch counters zeroed just before each study and read
              just after: per configuration full and predicted ms and the
              relative error, per study the speedup and the mean and max
              prediction error; every compute kind timed once and held
              against the port's CPU run; the matmul at the tile widths
              256/512/832 timed as a [kernels] row;
10. workers -- (B1) two `python -m repro_torch.api.worker` processes under
              a WorkerPool serve the golden space to a listening
              RemoteExecutor, one chaos-killed on its first task and
              restarted: the sweep equals the serial one bit for bit;
              (B2) one worker serving the full-width smollm-135m
              wall-clock study on the card (spec `lm_space`), killed when
              its second task arrives and restarted: both tasks finish,
              every point measured, every kernel launched in the worker,
              no plain call.  The workers import their specs
              (`golden_space`, `lm_space`) from this file;
11. moe    -- the MoE family, phi3.5-moe at its published widths (d_model
              4096, 32/8 heads of 128, 16 experts of 6400 with top-2
              routing, vocab 32064) with the depth cut to 2 of 32 layers
              (11.5 GB of f32 weights, drawn on the card from a seeded
              CUDA generator; a copy on the host): (e) first, every kernel at the MoE
              shapes against its plain version and timed as [kernels]
              rows (router N 16, experts at M = cap 1/5/10, the untied
              head N 32064, flash at d 128 over 32/8 heads, RMSNorm 4096
              wide); (a) serve 8 requests (launch/serve.py's draw, batch
              4, s_max 256, 16 new tokens) twice, the launch
              counters zeroed just before the first run and read just
              after (matmul, RMSNorm and flash launched, the expected
              count, no plain call, the same tokens every run; host ms
              least of 2), then prefill and 4 teacher-forced decode steps
              of 2 prompts against the port's CPU run, every layer's
              routing first, then the logits; (b) the decode step under
              torch.profiler, the expert products and the dispatch's
              plain ops split out; (c) one full-width layer's moe_fb
              gradients, sort and dense, remat none and full, at mb 2 x S
              32 against the CPU run, then each timed warm on the card
              beside its bound (the moe_dispatch knob's reading); (d) the
              reduced study's 24-point conditional session on the card, a
              protocol check with the counters zeroed around it: every
              kernel launched, no plain call, the sort and dense points
              sharing every attn_fb signature and no moe_fb;
12. mla    -- MLA, deepseek-v2 at its published widths (d_model 5120, 128
              heads, kv_lora 512, q_lora 1536, d_rope 64, d_nope 128, d_v
              128; 160 experts of 1536 with top-6 and 2 shared; vocab
              102400, untied head) with the depth cut to 1 of 60 layers
              (20.08 GB of f32 weights, drawn on the card from a seeded
              CUDA generator after phi3.5-moe's are freed; a copy on the
              host): (e) first, every
              kernel at its shapes against its plain version and timed as
              [kernels] rows (flash at (dk, dv) = (192, 128) over 128
              heads, f32 and bf16, and the reduced (24, 16); the absorbed
              per-head products on their strided views, wq_b, wo, the
              router N 160, the experts at M 1, the untied head N 102400;
              RMSNorm at q_ln's and kv_ln's widths); (a) serve as (a) of
              phase 11, the launches per prefill and decode step counted
              (2H absorbed products a layer at decode) and every flash
              launch's (dk, dv) recorded, then the CPU comparison, routing
              first; (b) three decode steps under torch.profiler (after
              one traced step left out of the reading), the absorbed
              per-head products and the expert products split out.  The
              study: in (e), the flash backward at MLA's pairs (the
              study's mb 2 x S 32 over 128/128 heads at (192, 128), a
              GQA suffix (2, 33, 70, 8/2) at the same pair, the reduced
              (24, 16) over 4/4 heads; MLA's scale; f32 and bf16, KV chunk
              16 and 64) against its plain version, two runs bit for bit,
              timed beside bound, plain and SDPA's backward; (c) layer 0's
              full-width mla_fb gradients at KV chunk 16 and 64, remat
              none and full, card against the CPU run, each timed warm
              beside its bound, one call under torch.profiler; (d) the
              reduced deepseek-v2 study's
              24-point conditional session as phase 11's (d), every
              flash backward launch at (24, 16);
13. ssm    -- the SSM families: (e) first, every kernel at xlstm-125m's and
              jamba's shapes against its plain version (f32 and bf16),
              f32 timed as [kernels] rows (xlstm's up, wq/wk/wv, wif N 8,
              down, sLSTM's w and its recurrent r[i] at M = B on a head's
              columns of h, the head N 50304; jamba's in_proj, x_proj N
              544, dt_w K 512 on x_proj's output columns, out_proj, q/k/v/o,
              the dense FFN, the router N 16, the experts at cap 1 and 5,
              the head N 65536; RMSNorm at 768 and 4096; flash at d 128
              over 32/8 heads); (a) xlstm-125m at full width (12 layers,
              0.65 GB f32) served through launch/serve.py as phase 3, the
              counters zeroed just before and read just after: matmul and
              RMSNorm at the counts derived from the configuration and the
              prompts (sLSTM: nh recurrent products a step), no flash
              launch (no attention), no plain call; then the CPU
              comparison; (b) jamba-v0.1-52b at its published widths
              (d_model 4096, 32/8 heads of 128, d_inner 8192, d_state 16,
              16 experts of 14336 with top-2, vocab 65536, untied head)
              with the depth cut to one period, 8 of 32 layers (53.3 GB of
              f32, drawn on the card from a seeded CUDA generator after
              deepseek-v2's are freed): served as phase 11's (a), every
              flash launch at (128, 128), then held against the CPU layer
              by layer (each layer's weights copied to the host once; the
              routing of every MoE layer, each layer's output, the
              logits); (c) three decode steps of each model under
              torch.profiler, the scans' plain ops, the causal conv, the
              sLSTM recurrent products and jamba's experts split out;
14. ssm-study -- the SSM families' study: (a) xlstm-125m's full-width
              mlstm_fb (layer 0) and slstm_fb (layer 1) and (b) one
              full-width jamba Mamba layer's mamba_fb (d_model 4096,
              d_inner 8192, d_state 16; 0.11 B parameters drawn on the
              card alone), each at mb 2 x S 32, ssm_chunk 8 and 32, remat
              none and full: one card call with the counters zeroed
              (matmul, RMSNorm and its backward launched, no other, no
              plain call; the matmul launches a call, where ssm 8's
              per-chunk recompute shows) against the port's CPU run, then
              timed warm (least of 5, host clock) beside its bound; (c)
              LMStudy("xlstm-125m", reduced=False), its depth cut to 3 of
              its 6 periods (6 of 12 layers), as a 24-point conditional
              session (tolerance 0.25, trials 1), the counters
              zeroed around it: per point predicted and full ms, the
              chosen point and its ssm_chunk, the true best, speedup and
              optimum quality; (d) the reduced jamba study's 48 points,
              its depth cut to one period (8 of 16 layers) and one
              selective run a point (trials 1), as phase 11's (d):
              every kernel launched (the flash backward at its attention
              position), no plain call, sort and dense sharing every
              mamba_fb and attn_fb and no moe_fb;
15. frontends -- (a) musicgen-large at its published widths, all 48
              layers (13.0 GB f32, 4 codebooks of 2048), served through
              launch/serve.py with 4-codebook prompts as phase 13's (a)
              (4 head launches a step), then held against the CPU; (b)
              internvl2-2b at its published widths, all 24 layers (7.6 GB
              f32), served with text prompts, then a prefill of 1024
              patches and a 16-token prompt through Model.prefill (the
              flash forward at d 128 over 1040 positions, 16/8 heads) and
              2 decode steps at P + t, held against the CPU; (c) each
              family's full-width embed_loss_fb (codebooks; 1024 patches
              in front of 32 tokens) card against CPU, timed warm beside
              its bound; (d) both reduced studies (12 points each) as
              protocol checks;
16. train  -- (a) smollm-135m at its published widths trained through
              launch/train.py (8 steps of 8 x 128 tokens in 2
              microbatches, remat full, a checkpoint every 4 steps;
              seeded random f32 weights, the synthetic stream), the launch
              counters zeroed just before and read just after: every
              kernel, forward and backward, at the count the
              configuration gives, no plain call; each step's host ms and
              loss; (b) the same command after the step-8 checkpoint is
              deleted resumes from step 4, and its losses for steps 5-8,
              its parameters and its AdamW state equal the straight run's
              bit for bit; (c) one microbatch's loss and gradients on the
              card against the port's CPU run on the same weights; (d)
              one step under torch.profiler beside its bound (operations
              at the f32 peak); (e) the peak memory and host ms of a
              microbatch's loss and gradient under remat none, full and
              dots, with the per-layer views unbound once (the model's)
              and taken a view at a time;
17. sharded -- (a) smollm-135m at its published widths through
              launch/train.py --model-axis 1 --variant cp under a world-1
              NCCL group (made and destroyed by the phase), 2 steps of 8 x
              128 tokens in 2 microbatches, remat full: the sharded train
              step on DTensors, each kernel under its placement rule; its
              losses, parameters and AdamW moments equal the one-device
              launcher's bit for bit, with the same launches per kernel and
              no plain call; the host ms a step with and without the group;
              (b) the reduced model under dp, tp and cp_fsdp, each equal to
              its one-device run bit for bit; (c) where the machine shows
              several cards, the full-width cp run on a (1, n) mesh over n
              = min(count, 4) of them, one process a card, its losses
              against (a)'s; (d) (in the moe phase, on its weights)
              full-width phi3.5-moe, 2 of 32 layers, at capacity factor
              E / top_k: one microbatch of 2 x 64 tokens through the
              sharded loss_and_grads under cp (all_to_all), tp (local
              experts, summed) and dp on a (1, 1) mesh of a world-1
              group, loss and gradients against one device's, the same
              launches, no plain call, host ms of each; (e) reduced
              phi3.5-moe and deepseek-v2 through launch/train.py
              --model-axis 1 under cp, tp and dp, their losses against
              the same commands on the CPU (world-1 gloo); (f) with
              several cards, the int8 ring and phi3.5-moe's cp
              all_to_all over a (1, n) mesh; otherwise a line saying (c)
              and (f) were not run; (g) the SSM scans in their manual
              regions: xlstm-125m at its published widths and reduced
              jamba through launch/train.py --model-axis 1 under cp, tp
              and dp (2 steps of 2 x 32 tokens), each
              equal to its one-device run bit for bit with the same
              launches and no plain call, host ms a step with and without
              DTensors; (h) the serving engine under cp rules on the (1,
              1) mesh, smollm-135m and xlstm-125m at their published
              widths (batch 4, s_max 256, 8 requests, 16 new tokens): the
              one-device engine's tokens, the same launches each decode
              step, no plain call, host ms a decode step with and without
              rules;
18. jaxdist -- the paper's distributed algorithms (repro_torch.jaxdist) on
              a (1, 1, 1) mesh of a world-1 NCCL group: matmul_3d at 4096
              cubed, tsqr at 65536 x 256 and cholesky_3d at n 4096, block
              512, each bit for bit with the same program on one device's
              plain tensors and against torch.linalg on the card; matmul
              launches, no plain call, host ms; where the machine shows 8
              or more cards, the same at c = 2 over 8 ranks;
19. pipeline -- the GPipe pipeline over 'pod' (parallel/pipeline.py):
              smollm-135m at its published widths on [train]'s 8 x 128
              tokens in 4 microbatches through pipeline_loss on a (1, 1,
              1) mesh of a world-1 NCCL group, its loss and gradients
              against Model.loss on the same microbatches on one device
              (the reference test's tolerances), the same launches of
              every kernel forward and backward, no plain call, host ms of
              each; where the machine shows 2 or more cards, pod 2 across
              two of them, one process a card;
20. dryrun -- the dry-run (launch/dryrun.py) in a subprocess of its own
              (its fake process group never meets the NCCL ones), started
              before the build and read at the end: smollm-135m x
              train_4k and x decode_32k on the single-pod 16x16 mesh and
              deepseek-v2 x train_4k (bf16 accumulation) on the 2x16x16
              mesh, traced on fake tensors: each cell's roofline terms
              against the H100's peaks, per-device peak bytes, whether it
              fits the card's memory, the trace's seconds; no kernel
              launched and no plain call in that process; then the
              dry-run's score of [train]'s own step on a (1, 1) mesh beside
              [train]'s measured device busy ms.

The kernels line gives each kernel's launches in every phase, the sharded
runs' as ``launches_sharded``, the pipeline's as ``launches_pipeline``,
and the two flash kernels once more "at q_offset": the offset rows
(``offset_rows``), the last shard of [train]'s microbatch at f32 (64, 64)
as the entry's numbers.  It prints the kernels as one JSON line, then
the last line
``{"ok": true, "device": {...}}``.  ``--out PATH`` also writes the full
tables (every case, the serve and profile numbers) as JSON.  It exits
non-zero without a result where there is no CUDA device or no checkout of
the repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent

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
# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit) and each
# kernel's bytes and operations, shared with the dry-run
from repro_torch.kernels.cost import (HBM_BYTES_PER_S,  # noqa: E402
                                      PEAK_FLOPS, causal_pairs, kernel_cost)
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


def absorbed_case(M, K, N, view, H, dtype, gen):
    """(a, b) for one of MLA's absorbed per-head products over H heads,
    head 0's views as ``layers.per_head_matmul`` takes them.  "q_lat":
    A is q_nope of q (rows H blocks of 3 K / 2 apart), B head 0's block of
    the 2-D wk_b transposed (K-contiguous, columns H K apart).  "o_lat":
    A is o_lat (rows H K apart), B head 0's block of wv_b (rows H N
    apart).  "a_rows" (the SSM blocks' products on column slices, sLSTM's
    h_i . r[i] and Mamba's dt_w): A's rows H elements apart, B
    contiguous."""
    if view == "q_lat":
        a = randn((M, H * (K + K // 2)), dtype, 1.0, gen)[:, :K]
        b = randn((N, H * K), dtype, 1.0 / math.sqrt(N), gen)[:, :K].T
    elif view == "a_rows":      # A's rows H elements apart, B contiguous
        a = randn((M, H), dtype, 1.0, gen)[:, :K]
        b = randn((K, N), dtype, 1.0 / math.sqrt(K), gen)
    else:
        a = randn((M, H * K), dtype, 1.0, gen)[:, :K]
        b = randn((K, H * N), dtype, 1.0 / math.sqrt(K), gen)[:, :N]
    return (a, b)


def rms_case(rows, D, dtype, gen):
    return (randn((rows, D), dtype, 1.0, gen), randn((D,), dtype, 0.1, gen))


def flash_case(B, Sq, Skv, H, KVH, d, dtype, gen, dv=None):
    """q, k, v at head widths (d, d), or (d, dv) (MLA: dk = d)."""
    return tuple(randn(s, dtype, 1.0, gen) for s in
                 ((B, Sq, H, d), (B, Skv, KVH, d), (B, Skv, KVH, dv or d)))


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
    scale = 1.0 / math.sqrt(q.shape[-1])
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  scale=scale)


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
    if name == "matmul" and isinstance(spec[3], str):
        return absorbed_case(*spec, dtype, gen)
    if name == "matmul":
        return matmul_case(*spec[:3], dtype, gen, strided_b=spec[3])
    if name == "rmsnorm":
        return rms_case(*spec, dtype, gen)
    return flash_case(*spec[:6], dtype, gen, *spec[6:])


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


# cold_weights' copies stop at this many bytes (a B larger than the L2 is
# cold after one other copy: deepseek-v2's 2.1 GB head takes 2, not 30)
COLD_BYTES = 4e9


def cold_weights(b, n_min: int = 30):
    """Distinct copies of B (same shape, strides and scale) totalling at
    least twice the L2, so that each call of a rotation finds its weights
    in HBM, as the decode step does (30 layers of distinct weights); at
    most ``COLD_BYTES`` beyond that."""
    nbytes = b.numel() * b.element_size()
    n = max(min(n_min, math.ceil(COLD_BYTES / nbytes)),
            math.ceil(2 * L2_BYTES / nbytes))
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
    return plan.path + (" A along M" if plan.acol else "") + (
        f" x{plan.splits} splits" if plan.splits > 1 else "")


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
    nbytes, flops = kernel_cost(name, args)
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
    check_cases(cases, gen, rows, worst)
    print(f"[kernels] {len(rows)} cases agree; max abs err per kernel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return rows, floor


def check_cases(cases, gen, rows, worst):
    """Each (kernel, label, shape spec, timed dtypes) case in f32 and bf16
    against the plain version, timed (``time_row``) in the dtypes named;
    appends the rows and keeps each kernel's worst error."""
    for dtype in (torch.float32, torch.bfloat16):
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
# (K, N, B = embed.T, M values): each straddles the shape's threshold
CROSSOVER = {
    torch.float32: [(576, 1536, False, (256, 512, 768)),
                    (1536, 576, False, (256, 512, 768)),
                    (576, 49152, True, (16, 32, 64)),
                    (49152, 576, False, (128, 256, 512))],
    torch.bfloat16: [(576, 1536, False, (16, 32, 64)),
                     (1536, 576, False, (16, 32, 64)),
                     (576, 49152, True, (1, 4, 8)),
                     (49152, 576, False, (32, 64, 128))]}


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
    p_gpu = eng.params
    p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
             for g, sub in p_gpu.items()}
    worst, _, _ = logits_vs_cpu(cfg, p_gpu, p_cpu, 8)
    rtol, atol = SERVE_TOL
    print(f"[serve] CUDA vs CPU logits (prefill + 8 decode steps, 2 "
          f"prompts): max abs err {worst:.3e} (rtol {rtol}, atol {atol})")
    serve_stats["cpu_max_abs_err"] = worst
    return serve_stats, p_gpu


@contextlib.contextmanager
def _recording_routing(routes):
    """While open, every ``moe.moe_ffn`` call appends its routing (experts
    and kept pairs per token) to ``routes`` (measurement only; restored on
    exit)."""
    from repro_torch.models import moe
    fn = moe.moe_ffn
    moe.moe_ffn = lambda *a, **kw: fn(*a, routing=routes, **kw)
    try:
        yield routes
    finally:
        moe.moe_ffn = fn


def _device_of(params):
    """The device that a parameter tree (or one layer's dict) lies on."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


def logits_vs_cpu(cfg, p_gpu, p_cpu, steps, prompts=(13, 29), patches=None,
                  timings=None):
    """Prefill logits of each prompt and ``steps`` teacher-forced decode
    steps through the port on the card (where ``p_gpu`` lies) against its
    CPU run on the same weights (``SERVE_TOL``), each MoE layer's routing
    compared first.  Prompts are ``(1, n, ncb)`` tokens with codebooks;
    ``patches`` (a ``(1, P, D)`` tensor) goes in front of every prompt,
    and decode then runs at positions P + n + i.  ``timings``: a dict that
    gets the card's (the first model's) host-clock prefill and decode-step
    seconds.  Returns (max abs err, token-expert pairs, pairs dropped)."""
    from repro_torch.models.model import Model
    rng = np.random.default_rng(1)
    worst, pairs, dropped = 0.0, 0, 0
    rtol, atol = SERVE_TOL
    models = ((Model(cfg, device=_device_of(p_gpu)), p_gpu),
              (Model(cfg, device="cpu"), p_cpu))
    trail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    P = 0 if patches is None else patches.shape[1]
    for n in prompts:
        toks = rng.integers(0, cfg.vocab, size=(1, n + steps) + trail)
        outs, routes = [], []
        for side, (model, params) in enumerate(models):
            dev = model.device
            tt = torch.from_numpy(toks).to(dev)
            batch = {"tokens": tt[:, :n]}
            if P:
                batch["patches"] = patches.to(dev)
            record = side == 0 and timings is not None
            with _recording_routing([]) as r:
                t0 = time.perf_counter()
                lg, cache, t = model.prefill(params, batch,
                                             max(64, P + n + steps))
                seq = [lg.float().cpu()]
                if record:
                    timings.setdefault("prefill_s", []).append(
                        time.perf_counter() - t0)
                if t != P + n:
                    raise AssertionError(f"prefill of {P} patches and {n} "
                                         f"tokens returned t = {t}")
                for i in range(steps):
                    t0 = time.perf_counter()
                    lg, cache = model.decode_step(
                        params, cache, torch.tensor([P + n + i], device=dev),
                        {"tokens": tt[:, n + i:n + i + 1]})
                    seq.append(lg.float().cpu())
                    if record:
                        timings.setdefault("decode_s", []).append(
                            time.perf_counter() - t0)
            outs.append(torch.stack(seq))
            routes.append([(i.cpu(), k.cpu()) for i, k in r])
        for j, ((gi, gk), (ci, ck)) in enumerate(zip(*routes)):
            if not (torch.equal(gi, ci) and torch.equal(gk, ck)):
                raise AssertionError(
                    f"routing differs from the CPU run for a {n}-token "
                    f"prompt at call {j // cfg.n_layers} layer "
                    f"{j % cfg.n_layers}: experts {gi.tolist()} vs "
                    f"{ci.tolist()}, kept {gk.tolist()} vs {ck.tolist()}")
            dropped += int((~ck).sum())
            pairs += ck.numel()
        g, c = outs
        err = (g - c).abs()
        if not torch.isfinite(g).all() or \
                bool((err > atol + rtol * c.abs()).any()):
            raise AssertionError(f"CUDA vs CPU logits disagree for a "
                                 f"{n}-token prompt: max abs err "
                                 f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    return worst, pairs, dropped


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


# bf16 flash backward against its plain version: the kernel rounds P and dS
# to bf16 before their products (the plain version keeps them f32), both
# round the outputs: rtol 2e-2 (a few ulps of the element) and atol 1e-2 x
# the tensor's largest magnitude (tests/test_torch_cuda.py BWD_TOL_BF16)
GRAD_TOL_BF16 = (2e-2, 1e-2)


def grad_case_flash(label, dims, bk, gen, timed=True, dtype=torch.float32,
                    scale=None, tag="grads"):
    """The flash backward at dims (B, Sq, Skv, H, KVH, dk[, dv]) and KV
    chunk bk, with the forward's ``scale`` (None: 1/sqrt(dk)), against its
    plain version, two runs bit for bit; ``timed``: beside its bound, plain
    version and SDPA's backward (with ``scale=``; a lower-right causal mask
    where Sq < Skv)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_flash_bwd)
    B, Sq, Skv, H, KVH, d = dims[:6]
    dv = dims[6] if len(dims) > 6 else d
    dn = str(dtype).split(".")[1]
    q, k, v = flash_case(B, Sq, Skv, H, KVH, d, dtype, gen, dv)
    do = randn((B, Sq, H, dv), dtype, 1.0, gen)
    o, lse = flash_attention_cuda(q, k, v, bk=bk, with_lse=True, scale=scale)
    run = lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,  # noqa: E731
                                           bk=bk, scale=scale)
    got, again = run(), run()
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale)
    torch.cuda.synchronize()
    plan = plan_flash_bwd(q, k, v, o, do, bk)

    def tol(w):
        if dtype == torch.float32:
            return GRAD_TOL
        rtol, arel = GRAD_TOL_BF16
        return rtol, arel * float(w.float().abs().max())
    row = {"kernel": "flash_attention_bwd", "shape": label, "dtype": dn,
           "pair": [d, dv], "tile": plan.tile, "bk": bk,
           "splits": plan.splits,
           "grid": plan.grid,
           "bit_identical": all(torch.equal(a, b) for a, b in zip(got, again)),
           "max_abs_err": max(check_close(label, g, w, dn, tol(w))
                              for g, w in zip(got, want))}
    if not row["bit_identical"]:
        raise AssertionError(f"flash_attention_bwd {label}: two runs differ")
    if timed:
        nbytes, flops = kernel_cost("flash_attention_bwd", (q, k, v))
        plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
            q, k, v, o, lse, do, scale=scale)
        # library: SDPA's backward alone (autograd of one forward), on the
        # heads expanded to H as SDPA takes them; is_causal aligns the
        # queries top-left, so a suffix takes an explicit mask
        G = H // KVH
        lq = q.transpose(1, 2).contiguous().requires_grad_()
        lk = k.repeat_interleave(G, 2).transpose(1, 2).contiguous() \
            .requires_grad_()
        lv = v.repeat_interleave(G, 2).transpose(1, 2).contiguous() \
            .requires_grad_()
        mask = None if Sq == Skv else torch.ones(
            Sq, Skv, dtype=torch.bool, device="cuda").tril(Skv - Sq)
        lo = F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask, is_causal=mask is None,
            scale=scale)
        ldo = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lo, (lq, lk, lv), ldo, retain_graph=True)
        grad_timing(row, run, plain, lib, nbytes, flops, tag)
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
        nbytes, flops = kernel_cost("rmsnorm_bwd", (x, w))
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
    dn = str(a.dtype).split(".")[1]
    got = ops.matmul(a, b)
    again = ops.matmul(a, b)
    want = ref.matmul_ref(a, b)
    torch.cuda.synchronize()
    row = {"kernel": "matmul", "shape": label, "dtype": dn,
           "path": matmul_path(a, b),
           "bit_identical": torch.equal(got, again),
           "max_abs_err": check_close("matmul", got, want, dn)}
    if not row["bit_identical"]:
        raise AssertionError(f"matmul {label}: two runs differ")
    if timed:
        nbytes, flops = kernel_cost("matmul", (a, b))
        grad_timing(row, lambda: ops.matmul(a, b),
                    lambda: ref.matmul_ref(a, b),
                    lambda: torch.matmul(a, b), nbytes, flops)
    return row


def grad_timing(row, run, plain, lib, nbytes, flops, tag="grads"):
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, row["dtype"])
    row["ms"], row["host_ms"] = time_ms(run)
    row["plain_ms"], _ = time_ms(plain, reps=5)
    row["library_ms"], row["library_host_ms"] = time_ms(lib)
    tile = f" [tile {row['tile']}, splits {row['splits']}]" \
        if "tile" in row else \
        (f" [{row['path']}]" if "path" in row else "")
    print(f"[{tag}] {row['kernel']:19s} {row['shape']:44s} {row['dtype']} "
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
    from repro_torch.tune.lm_study import StepKnobs
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
    # the bf16 weight gradient of training: gate/up at a microbatch of 16 x
    # 2048 tokens (K split over blocks: 60 output tiles on 132 SMs)
    T = 16 * 2048
    x = randn((T, D), torch.bfloat16, 1.0, gen)
    dc = randn((T, F_), torch.bfloat16, 1.0 / math.sqrt(T), gen)
    rows.append(grad_case_matmul(f"train gate/up dW = A^T dC {D}x{T}x{F_}",
                                 x.T, dc))
    del emb, x, dc
    print(f"[grads] {len(rows)} backward cases agree with their plain "
          f"versions, each with the same bits on a second run")

    # one full-width gradient of each kind, card against the port's CPU run
    checks = study_grads_vs_cpu("[grads]", STUDY["batch"], STUDY["seq"], (
        ("attn_fb kv16 remat full", lambda st: st._mixer_kernel(
            "attn", 0, StepKnobs("k", remat="full", kv_chunk=16), 2)),
        ("dense_fb", lambda st: st._ffn_kernel(
            "dense", 0, StepKnobs("k"), 2)),
        ("embed_loss_fb", lambda st: st._embed_loss_kernel(
            StepKnobs("k"), 2))))
    return rows, checks


# -- the query offset: shards of a split sequence -----------------------------

# (label, heads, KV heads, dk, dv, MLA's scale?): smollm-135m's attention,
# deepseek-v2's at its published widths and at its reduced configuration's
OFFSET_PAIRS = (("H9/3 d64", 9, 3, 64, 64, False),
                ("H128/128 (192, 128)", 128, 128, 192, 128, True),
                ("H4/4 (24, 16)", 4, 4, 24, 16, True))
# (label, B, S, shards, dtypes, timed dtypes): [train]'s microbatch (4 x
# 128) and the long prompt, each split into 4 shards of queries as cp on a
# model axis of 4 splits them; the bf16 microbatch is checked, not timed
# (the script's time)
OFFSET_SHAPES = (("train mb 4x128", 4, 128, 4,
                  (torch.float32, torch.bfloat16), (torch.float32,)),
                 ("long B1 S2048", 1, 2048, 4, (torch.bfloat16,),
                  (torch.bfloat16,)))


def sdpa_prefix(q, k, v, off, scale):
    """SDPA on the K/V prefix [0, off + Sq) with a lower-right causal mask
    (query i at key position off + i): the function of the flash kernels
    at q_offset off, as one PyTorch call (a yardstick only); q, k, v in
    SDPA's (B, heads, S, d) layout, the KV heads expanded."""
    from torch.nn.attention.bias import causal_lower_right
    end = off + q.shape[2]
    mask = causal_lower_right(q.shape[2], end)
    return F.scaled_dot_product_attention(q, k[:, :, :end], v[:, :, :end],
                                          attn_mask=mask, scale=scale)


def offset_case(label, pair, shape, dtype, gen, timed=True):
    """A causal sequence split into shards of queries, each run against all
    its keys at its offset r S / m, forward and backward, on the kernels:
    each against its plain version at the offset, its output, lse and dq
    against the same rows of the whole call's, the shards' dk and dv summed
    against the whole call's, dk and dv past the shard's last position
    exactly 0; with ``timed``, each shard's and the whole call's device ms
    beside its bound (the shard's own bytes and pairs), its plain version
    and SDPA on the K/V prefix with a lower-right causal mask (forward;
    its backward by autograd)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    _, H, KVH, dk, dv, mla = pair
    B, S, m = shape[1:4]
    dn = str(dtype).split(".")[1]
    scale = 1.0 / math.sqrt(dk) if mla else None
    q, k, v = flash_case(B, S, S, H, KVH, dk, dtype, gen, dv)
    do = randn((B, S, H, dv), dtype, 1.0, gen)
    o, lse = flash_attention_cuda(q, k, v, with_lse=True, scale=scale)
    dq, dkw, dvw = flash_attention_bwd_cuda(q, k, v, o, lse, do, scale=scale)
    G = H // KVH
    lay = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
    lq, ldo = lay(q), lay(do)
    lk = lay(k.repeat_interleave(G, 2))
    lv = lay(v.repeat_interleave(G, 2))
    ftol = TOL["flash_attention"][dn]

    def gtol(w):
        if dtype == torch.float32:
            return GRAD_TOL
        rtol, arel = GRAD_TOL_BF16
        return rtol, arel * float(w.float().abs().max())

    def ms(fn, reps=10):
        # 30 timed rows of 6 timings each: fewer repeats than [kernels]'
        return time_ms(fn, reps=reps, trials=2)[0]
    n = S // m
    sum_dk = torch.zeros(dkw.shape, dtype=torch.float32, device="cuda")
    sum_dv = torch.zeros(dvw.shape, dtype=torch.float32, device="cuda")
    rows = []
    for r in range(m + 1):
        whole = r == m
        off, sl = (0, slice(0, S)) if whole else (r * n, slice(r * n,
                                                              (r + 1) * n))
        qs, dos = q[:, sl], do[:, sl]
        # the whole call takes the default offset, a shard its own
        kw = {} if whole else {"q_offset": off}
        what = f"{label} whole" if whole else \
            f"{label} shard {r}/{m} (offset {off})"
        os_, ls = flash_attention_cuda(qs, k, v, with_lse=True, scale=scale,
                                       **kw)
        want_o, want_l = ref.flash_attention_ref(qs, k, v, return_lse=True,
                                                 scale=scale, **kw)
        err = check_close(what, os_, want_o, dn, ftol)
        check_close(what + " lse", ls, want_l, "float32", (1e-4, 1e-4))
        grads = flash_attention_bwd_cuda(qs, k, v, os_, ls, dos, scale=scale,
                                         **kw)
        want_g = ref.flash_attention_bwd_ref(qs, k, v, os_, ls, dos,
                                             scale=scale, **kw)
        gerr = max(check_close(what, g, w, dn, gtol(w))
                   for g, w in zip(grads, want_g))
        if not whole:
            # the same rows of the whole call's
            check_close(what + " vs whole", os_, o[:, sl], dn, ftol)
            check_close(what + " dq vs whole", grads[0], dq[:, sl], dn,
                        gtol(dq))
            if grads[1][:, off + n:].any() or grads[2][:, off + n:].any():
                raise AssertionError(f"{what}: dk/dv past the shard's last "
                                     f"position are not 0")
            sum_dk += grads[1].float()
            sum_dv += grads[2].float()
        args = (qs, k, v)
        fb, ff = kernel_cost("flash_attention", args, off if kw else None)
        bb, bf = kernel_cost("flash_attention_bwd", args,
                             off if kw else None)
        row = {"kernel": "flash_attention", "shape": what, "dtype": dn,
               "pair": [dk, dv], "heads": [H, KVH], "q_offset": off,
               "Sq": n if not whole else S, "Skv": S,
               "pairs": B * H * causal_pairs(qs.shape[1], S, off if kw
                                             else None),
               "max_abs_err": err, "bwd_max_abs_err": gerr}
        row["bound_ms"], row["bound_by"] = bound(fb, ff, dn)
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound(bb, bf, dn)
        rows.append(row)
        if not timed:
            for f in ("ms", "plain_ms", "library_ms"):
                row[f] = row["bwd_" + f] = None
            print(f"[offsets] {what:44s} {dn} err {err:.2e} / {gerr:.2e} "
                  f"(checked, not timed);  pairs {row['pairs']}")
            continue
        row["ms"] = ms(lambda: flash_attention_cuda(qs, k, v, scale=scale,
                                                    **kw))
        row["plain_ms"] = ms(lambda: ref.flash_attention_ref(
            qs, k, v, scale=scale, **kw), reps=5)
        lqs = lq[:, :, sl]
        row["library_ms"] = ms(lambda: sdpa_prefix(lqs, lk, lv, off, scale))
        row["bwd_ms"] = ms(lambda: flash_attention_bwd_cuda(
            qs, k, v, os_, ls, dos, scale=scale, **kw))
        row["bwd_plain_ms"] = ms(lambda: ref.flash_attention_bwd_ref(
            qs, k, v, os_, ls, dos, scale=scale, **kw), reps=5)
        aq, ak, av = (t.detach().clone().requires_grad_()
                      for t in (lqs, lk, lv))
        ao = sdpa_prefix(aq, ak, av, off, scale)
        ag = ldo[:, :, sl]
        row["bwd_library_ms"] = ms(lambda: torch.autograd.grad(
            ao, (aq, ak, av), ag, retain_graph=True))
        print(f"[offsets] {what:44s} {dn} err {err:.2e} / {gerr:.2e}  "
              f"device ms: forward {row['ms']:.4f} plain "
              f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']});  backward "
              f"{row['bwd_ms']:.4f} plain {row['bwd_plain_ms']:.4f} library "
              f"{row['bwd_library_ms']:.4f} bound {row['bwd_bound_ms']:.5f} "
              f"({row['bwd_bound_by']});  pairs {row['pairs']}")
        del aq, ak, av, ao
    check_close(f"{label} sum of the shards' dk", sum_dk, dkw, dn, gtol(dkw))
    check_close(f"{label} sum of the shards' dv", sum_dv, dvw, dn, gtol(dvw))
    return rows


def phase_offsets():
    """The flash kernels at the query offsets of a sequence split over a
    model axis of 4 (``offset_case``), at each of ``OFFSET_PAIRS`` and
    ``OFFSET_SHAPES``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    rows = []
    for shape in OFFSET_SHAPES:
        for pair in OFFSET_PAIRS:
            for dt in shape[4]:
                rows += offset_case(f"{shape[0]} {pair[0]}", pair, shape, dt,
                                    gen, timed=dt in shape[5])
                torch.cuda.empty_cache()
    for shape in OFFSET_SHAPES:
        last = [r for r in rows if r["shape"].startswith(shape[0])
                and "shard" in r["shape"]]
        m = shape[3]
        print(f"[offsets] {shape[0]}: the last shard sees "
              f"{last[m - 1]['pairs'] / sum(r['pairs'] for r in last[:m]):.4f}"
              f" of the pairs ((2m - 1) / m^2 = {(2 * m - 1) / m ** 2:.4f} "
              f"for m {m}), the first "
              f"{last[0]['pairs'] / sum(r['pairs'] for r in last[:m]):.4f}")
    print(f"[offsets] {len(rows)} rows agree: each shard with its plain "
          f"version and the whole call's rows, the shards' dk/dv sums with "
          f"the whole call's, dk/dv past each shard's last position 0")
    return rows


def study_grads_vs_cpu(tag, batch, seq, kinds):
    """Full-width ``LMStudy`` thunks (``kinds``: (name, study -> (sig,
    build))) on the card against the port's CPU run on the same weights
    (random norm weights) and inputs: every gradient within ``STUDY_TOL``
    of its largest magnitude."""
    from repro_torch.tune.lm_study import LMStudy
    studies = [LMStudy("smollm-135m", reduced=False, device=dv,
                       batch=batch, seq=seq) for dv in ("cuda", "cpu")]
    for st in studies:
        _random_norms(st, 11)
    checks = []
    rtol, atol = STUDY_TOL
    for kind, mk in kinds:
        out = []
        for st in studies:
            fn, args = mk(st)[1]()
            out.append(fn(*args))
        worst = grads_vs_cpu(f"{tag} {kind}", *out)
        checks.append({"kernel": kind, "batch": batch, "seq": seq,
                       "max_err_over_scale": worst})
        print(f"{tag} full-width {kind} at batch {batch} x seq {seq}: card "
              f"vs the port's CPU run, every gradient within rtol {rtol} "
              f"and atol {atol} x its largest magnitude (max err / scale "
              f"{worst:.2e})")
    del studies
    torch.cuda.empty_cache()
    return checks


def grads_vs_cpu(what, card, cpu, floor: float = 1.0):
    """Max err / scale of a gradient tree from the card against the port's
    CPU run on the same weights and inputs; raises where a gradient is not
    finite or beyond ``STUDY_TOL`` (the absolute part times the CPU
    tensor's largest magnitude, at least ``floor``)."""
    from repro_torch.tune.lm_study import _flatten
    rtol, atol = STUDY_TOL
    worst = 0.0
    for (path, g), (_, c) in zip(_flatten(card), _flatten(cpu)):
        g = g.cpu()
        err = (g - c).abs()
        scale = max(floor, float(c.abs().max()))
        if not torch.isfinite(g).all() or \
                bool((err > atol * scale + rtol * c.abs()).any()):
            raise AssertionError(f"{what} {'/'.join(path)}: card vs CPU max "
                                 f"abs err {float(err.max()):.3e}")
        worst = max(worst, float(err.max()) / scale)
    return worst


def warm_ms(fn, reps: int = 5):
    """Host-clock ms of ``reps`` warm calls of ``fn`` (each ends in a
    device sync, as the study times a thunk)."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append(1e3 * (time.perf_counter() - t0))
    return runs


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
    out = {"config": knobs.name, "thunks": by_sig,
           "step_ms_sum_of_thunks": step_ms, "step_ms_profiled": prof_ms}
    for sig, v in by_sig.items():
        print(f"[tune] step {knobs.name}: {sig} {v['ms']:.3f} ms x "
              f"{v['freq']} = {v['ms'] * v['freq']:.2f} ms")
    out.update(device_summary(
        "tune", f"step {knobs.name}: sum of thunks {step_ms:.2f} ms; "
        f"profiled step {prof_ms:.2f} ms", prof))
    return out


def device_summary(tag, what, prof, top: int = 12):
    """Device busy ms, span, idle share, the port's kernels' ms and the
    ``top`` kernels by device time of a profiler window (empty where the
    profiler recorded no device event: not measured)."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"[{tag}] {what}: the profiler recorded no device events; "
              f"device busy share not measured")
        return {}
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
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out = {"device_busy_ms": busy, "device_span_ms": span,
           "device_idle_share": 1.0 - busy / span,
           "device_events": len(dev), "port_kernel_ms": ours,
           "top_device_ms": [{"name": n[:80], "count": c, "ms": t}
                             for n, (c, t) in rows]}
    print(f"[{tag}] {what}, device busy {busy:.3f} ms of a {span:.3f} ms "
          f"span (idle share {1.0 - busy / span:.3f}), {len(dev)} device "
          f"events; ours (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ours.items()))
    for row in out["top_device_ms"]:
        print(f"[{tag}]   {row['ms']:8.3f} ms  x{row['count']:5d}  "
              f"{row['name']}")
    return out


# -- phase 7: the always-on tuning daemon -------------------------------------

DAEMON_KEYS = ("counters", "steady_state_counters", "ratios",
               "second_tuned_serves", "served_while_retuning",
               "drift_detected", "retunes", "events")
DAEMON_SHAPES = ((2, 16), (2, 24), (4, 16))     # run_daemon_demo's traffic
DAEMON_BUCKETS = (16, 32)


def _failure_events(events):
    return [e for e in events if e["event"] in ("study_failed", "scheduler")]


def phase_daemon_shapes():
    """The daemon's thunks at the shapes no earlier phase runs (S 16: the
    KV tile clamps to 16; mb 2 x 16 = 32 tokens: the tied head skinny; mb
    4 x 16 = 64: tiled), on the card against the port's CPU run."""
    from repro_torch.tune.lm_study import StepKnobs
    checks = []
    for batch, seq in ((2, 16), (4, 16)):
        checks += study_grads_vs_cpu("[daemon]", batch, seq, tuple(
            (f"attn_fb kv{kv} remat {rm}", lambda st, kv=kv, rm=rm, b=batch:
             st._mixer_kernel("attn", 0, StepKnobs("k", remat=rm,
                                                   kv_chunk=kv), b))
            for kv in (16, 64) for rm in ("none", "full")) + (
            ("dense_fb", lambda st, b=batch: st._ffn_kernel(
                "dense", 0, StepKnobs("k"), b)),
            ("embed_loss_fb", lambda st, b=batch: st._embed_loss_kernel(
                StepKnobs("k"), b))))
    return checks


def phase_daemon_parity(devices=("cuda", "cpu")):
    """The reduced daemon demo, synchronous on virtual clocks, on the card
    and on the CPU: the two summaries must be equal, journal included."""
    from repro_torch.serve.tuner import run_daemon_demo
    out = {}
    for dev in devices:
        _zero_counts()
        t0 = time.perf_counter()
        out[dev] = run_daemon_demo("smollm-135m", device=dev,
                                   synchronous=True)
        dt = time.perf_counter() - t0
        plain = {k: v for k, v in ops.plain_calls.items() if v}
        print(f"[daemon] parity {dev}: {dt:.1f} s, counters "
              f"{out[dev]['counters']}, {len(out[dev]['events'])} events, "
              f"launches {dict(ops.launches)}")
        if dev != "cpu" and plain:
            raise AssertionError(f"[daemon] parity on {dev} called plain "
                                 f"versions: {plain}")
        if _failure_events(out[dev]["events"]):
            raise AssertionError(f"[daemon] parity {dev}: "
                                 f"{_failure_events(out[dev]['events'])}")
    card, cpu = (out[d] for d in devices)
    differ = [k for k in DAEMON_KEYS if card[k] != cpu[k]]
    if differ:
        raise AssertionError(f"[daemon] parity: {devices[0]} and "
                             f"{devices[1]} differ in {differ}")
    print(f"[daemon] parity: {devices[0]} equals {devices[1]} in "
          f"{', '.join(DAEMON_KEYS)}")
    return {"events": len(card["events"]), "counters": card["counters"]}


def phase_daemon_full(argv=("--arch", "smollm-135m", "--daemon")):
    """The CLI's daemon demo at full width on the card, in the background
    (the CLI's default), launch counters zeroed just before and read just
    after."""
    from repro_torch.launch import serve
    _zero_counts()
    t0 = time.perf_counter()
    summary = serve.main(list(argv))
    dt = time.perf_counter() - t0
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    events = summary["events"]
    tuned = {e["shape"] for e in events if e["event"] == "tune_complete"}
    started = {e["shape"] for e in events if e["event"] == "tune_started"}
    retunes = [e for e in events if e["event"] == "retune_started"]
    settled = [e for e in events if e["event"] == "retune_complete"]
    print(f"[daemon] full width: {dt:.1f} s; shapes tuned {len(tuned)} of "
          f"{summary['shapes']}; drift detected {summary['drift_detected']}; "
          f"re-tunes {len(settled)} of {len(retunes)} settled; served while "
          f"re-tuning {summary['served_while_retuning']}; steady-state "
          f"cold_banked_exec "
          f"{summary['steady_state_counters']['cold_banked_exec']}")
    print(f"[daemon] full width launches {launches}; plain calls {plain}")
    if len(tuned) != summary["shapes"] or tuned != started:
        raise AssertionError(f"[daemon] full width: shapes tuned {tuned}")
    if not summary["drift_detected"] or len(settled) != len(retunes) \
            or summary["retunes"] != len(settled) or not settled:
        raise AssertionError("[daemon] full width: drift not detected or "
                             "re-tunes not settled")
    if summary["steady_state_counters"]["cold_banked_exec"]:
        raise AssertionError("[daemon] full width: banked kernels re-ran "
                             "cold in steady state")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing or any(plain.values()):
        raise AssertionError(f"[daemon] full width: kernels never launched "
                             f"{missing}; plain calls {plain}")
    if _failure_events(events):
        raise AssertionError(f"[daemon] full width: "
                             f"{_failure_events(events)}")
    return {"seconds": dt, "launches": launches,
            "counters": summary["counters"],
            "steady_state_counters": summary["steady_state_counters"],
            "served_while_retuning": summary["served_while_retuning"],
            "retunes": summary["retunes"], "events": len(events)}


def _timed_serve(tuner, b, s, rows):
    """Serve one step, appending to ``rows`` its host ms, its counts,
    whether a study (of any shape) was in flight when it started, and the
    banked kernels its serving timer did not hold confident then."""
    from repro_torch.api.daemon import TUNED
    daemon = tuner.daemon
    busy = any(v != TUNED for v in daemon.state.values())
    before = _unconfident_banked(daemon, tuner.shape_of(b, s)[0])
    t0 = time.perf_counter()
    info = tuner.serve_step(b, s)
    rows.append({**info, "ms": 1e3 * (time.perf_counter() - t0),
                 "busy": busy, "batch_seq": (b, s),
                 "unconfident_before": before})
    return info


def _step_stats(rows):
    """Median, least and most host ms of the shadow serve steps in
    ``rows`` (those that forced kernels), and how many there were."""
    ms = sorted(r["ms"] for r in rows if r["forced"])
    if not ms:
        return {"n": 0}
    return {"n": len(ms), "median_ms": ms[len(ms) // 2], "min_ms": ms[0],
            "max_ms": ms[-1]}


def _unconfident_banked(daemon, key):
    """The banked kernels (in the fleet store when ``key``'s serving timer
    was built) that the timer does not hold confident, so that a
    non-shadow step may execute them: each with its occurrences in the
    step and the timer's evidence for it (samples, mean, spread and most,
    ms; none where the timer has not met it yet).  None where ``key`` has
    no serving timer."""
    from repro_torch.core.signatures import structural_key
    srv = daemon._servers.get(key)
    if srv is None:
        return None
    occurrences = {}
    for sig, _, _ in srv.kernels:
        occurrences[sig] = occurrences.get(sig, 0) + 1
    rows = []
    for sig, occ in occurrences.items():
        if structural_key(sig, 1) not in srv.banked \
                or sig in srv.timer.global_off:
            continue
        st = srv.timer.kbar.get(sig)
        rows.append({"kernel": sig.name, "occurrences": occ,
                     "n": st.n if st else None,
                     "mean_ms": 1e3 * st.mean if st else None,
                     "std_ms": 1e3 * st.std if st else None,
                     "max_ms": 1e3 * st.max_t if st else None})
    return rows


def phase_daemon_wallclock(reduced=False, device=None, rounds=64,
                           steady_rounds=32):
    """The daemon on its default clocks (wall clock: time.time for the
    daemon, perf_counter for the studies), studies in the background, the
    demo's three shapes, phases 1-2 (the drift drill scales virtual clocks,
    so it runs only under them).  While each later shape's study is in
    flight the loop serves the shapes already tuned (up to ``rounds``
    rounds), then serves them as many rounds again; each step is timed and
    filed by whether any study was in flight when it started."""
    from repro_torch.api.daemon import TUNED
    from repro_torch.serve.tuner import (LMShapeProvider, ServingTuner,
                                         _pump_until)
    tuner = ServingTuner("smollm-135m", seq_buckets=DAEMON_BUCKETS,
                         provider=LMShapeProvider(reduced=reduced, trials=2,
                                                  max_configs=3,
                                                  device=device))
    daemon = tuner.daemon
    t0 = time.perf_counter()
    timed = []
    for i, (b, s) in enumerate(DAEMON_SHAPES):
        key = tuner.shape_of(b, s)[0]
        ts = time.perf_counter()
        tuner.serve_step(b, s)                  # the miss opens the study
        n = 0
        while i and daemon.state.get(key) != TUNED and n < rounds:
            for bb, ss in DAEMON_SHAPES[:i]:
                _timed_serve(tuner, bb, ss, timed)
            n += 1
        keys = [tuner.shape_of(bb, ss)[0] for bb, ss in DAEMON_SHAPES[:i + 1]]
        if not _pump_until(daemon, keys):
            raise AssertionError(f"[daemon] wall clock: studies for "
                                 f"{DAEMON_SHAPES[:i + 1]} did not land")
        print(f"[daemon] wall clock: shape {(b, s)} tuned in "
              f"{time.perf_counter() - ts:.2f} s while serving {n} rounds "
              f"of the {i} tuned shapes")
        for _ in range(n):
            for bb, ss in DAEMON_SHAPES[:i]:
                _timed_serve(tuner, bb, ss, timed)
    all_keys = [tuner.shape_of(b, s)[0] for b, s in DAEMON_SHAPES]
    if not _pump_until(daemon, all_keys):
        raise AssertionError("[daemon] wall clock: re-tunes did not land")
    tune_s = time.perf_counter() - t0
    drifts0 = daemon.counters["drifts"]
    seq0 = len(daemon.events)
    steady_rows = []
    for _ in range(steady_rounds):
        for b, s in DAEMON_SHAPES:
            _timed_serve(tuner, b, s, steady_rows)
    steady_drifts = [e for e in daemon.events[seq0:]
                     if e["event"] == "drift_detected"]
    timed += steady_rows
    if not _pump_until(daemon, all_keys):
        raise AssertionError("[daemon] wall clock: re-tunes did not land")
    out = {"tune_s": tune_s, "shapes": {},
           "drifts_while_tuning": drifts0,
           "drifts_steady": daemon.counters["drifts"] - drifts0}
    faults = []
    for (b, s) in DAEMON_SHAPES:
        key, meta = tuner.shape_of(b, s)
        rows = [r for r in steady_rows if r["shape"] == key]
        winner = daemon.winners[key]["name"]
        plain_steps = [r for r in rows if not r["forced"]
                       and r["state"] == TUNED]
        shadow = [r for r in rows if r["forced"]]
        # a banked kernel the timer holds confident is never executed on a
        # non-shadow step; one it does not may be (a steady-state reading)
        cold = [r["cold_banked"] for r in plain_steps]
        over = [(r["cold_banked"], r["unconfident_before"])
                for r in plain_steps if r["unconfident_before"] is not None
                and r["cold_banked"] > sum(u["occurrences"] for u in
                                           r["unconfident_before"])]
        if over:
            faults.append(f"{b}x{s}: {len(plain_steps)} tuned non-shadow "
                          f"steady steps; banked kernels held confident "
                          f"that re-ran {over}")
        first_cold = next((r["unconfident_before"] for r in plain_steps
                           if r["cold_banked"]), None)
        kernels = tuner.provider.kernels_for(key, meta, winner)
        full = []
        for _ in range(3):
            tf = time.perf_counter()
            for _, thunk, _ in kernels:
                thunk()
            full.append(1e3 * (time.perf_counter() - tf))
        charged = [1e3 * r["charged"] for r in plain_steps] or [math.nan]
        n_drift = sum(key in e["shapes"] for e in steady_drifts)
        mine = [r for r in timed if r["batch_seq"] == (b, s)]
        busy = _step_stats([r for r in mine if r["busy"]])
        idle = _step_stats([r for r in mine if not r["busy"]])
        row = {"winner": winner, "steps": len(rows),
               "shadow_ms_study_in_flight": busy,
               "shadow_ms_no_study": idle,
               "executed": [r["executed"] for r in plain_steps][:3],
               "skipped": [r["skipped"] for r in plain_steps][:3],
               "shadow_executed": [r["executed"] for r in shadow][:3],
               "shadow_forced": [r["forced"] for r in shadow][:3],
               "charged_ms": charged[-1], "full_ms": min(full),
               "full_ms_all": full, "drift_events": n_drift,
               "cold_banked": cold, "first_cold_unconfident": first_cold}
        out["shapes"][f"{b}x{s}"] = row
        print(f"[daemon] wall clock {b}x{s} ({meta['seq']} bucket): winner "
              f"{winner}; per tuned step executed {row['executed']} skipped "
              f"{row['skipped']}, shadow steps executed "
              f"{row['shadow_executed']} forced {row['shadow_forced']}; "
              f"charged {row['charged_ms']:.3f} ms against one full "
              f"execution {row['full_ms']:.3f} ms (least of 3: "
              + ", ".join(f"{x:.3f}" for x in full)
              + f"); drift events naming it {n_drift}")
        print(f"[daemon] wall clock {b}x{s}: shadow serve step host ms with "
              f"a study in flight {busy}, with none {idle}")
        print(f"[daemon] wall clock {b}x{s}: banked kernels re-run "
              f"{sum(cold)} times over {len(cold)} tuned non-shadow steady "
              f"steps (in {sum(1 for c in cold if c)} of them); before the "
              f"first such step the timer did not hold confident "
              f"{first_cold}")
    print(f"[daemon] wall clock: tuning {tune_s:.1f} s; drifts counted "
          f"while tuning {drifts0}, in steady state {out['drifts_steady']}; "
          f"counters {daemon.counters}")
    tuner.close(checkpoint=False)
    faults += [str(e) for e in _failure_events(daemon.events)]
    if faults:
        raise AssertionError(f"[daemon] wall clock: {faults}")
    return out


# -- phase 8: the simulator ---------------------------------------------------

def _port_golden_runner():
    """tests/golden_runner.py's own source, its ``repro.`` imports rewritten
    to ``repro_torch.`` (``port_imports`` of tests/test_torch_copies.py),
    as a module."""
    import types
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_copies import port_imports
    path = ROOT / "tests" / "golden_runner.py"
    runner = types.ModuleType("port_golden_runner")
    runner.__file__ = str(path)
    exec(compile(port_imports(path.read_text()), str(path), "exec"),
         runner.__dict__)
    return runner


def phase_sim():
    """The golden protocol (tests/golden_runner.py's own source, its
    ``repro.`` imports rewritten to ``repro_torch.``) through the port's
    copy of the simulator must equal tests/golden_reports.json bit for
    bit."""
    runner = _port_golden_runner()
    t0 = time.perf_counter()
    got = json.loads(json.dumps(runner.compute_goldens()))
    dt = time.perf_counter() - t0
    want = json.loads((ROOT / "tests" / "golden_reports.json").read_text())
    records = sum(len(v) for s in want.values() for v in s.values())
    if got != want:
        bad = [(s, p) for s in want for p in want[s]
               if got.get(s, {}).get(p) != want[s][p]]
        raise AssertionError(f"[sim] goldens differ in {bad}")
    print(f"[sim] golden protocol through repro_torch: {len(want)} studies "
          f"x {len(next(iter(want.values())))} policies, {records} records "
          f"equal tests/golden_reports.json bit for bit ({dt:.2f} s)")
    return {"records": records, "seconds": dt}


# -- phase 9: the measured mode (real BLAS/LAPACK kernels on the card) --------

# the paper's harness on two ci studies: (study, policies); the comm model
# is the simulator's Stampede2 model
MEASURED = (("slate-cholesky", ("conditional", "eager")),
            ("candmc-qr", ("conditional",)))
# one signature of each compute kind the four ci studies emit, at path
# (A)'s shapes: SLATE Cholesky's tiles, CANDMC QR's panels, SLATE QR's and
# Capital's
MEASURED_KINDS = [("gemm", (256, 256, 256)), ("gemm", (832, 832, 832)),
                  ("gemm", (8, 63, 512)), ("syrk", (256, 256)),
                  ("syrk", (832, 832)), ("syrk", (128, 128)),
                  ("trmm", (8, 63)), ("trmm", (128, 128)),
                  ("trsm", (256, 256)), ("trsm", (832, 832)),
                  ("potrf", (256,)), ("potrf", (832,)), ("trtri", (8,)),
                  ("trtri", (64,)), ("geqrf", (512, 8)), ("geqrf", (64, 32)),
                  ("tpqrt", (16, 8)), ("tpqrt", (64, 8)),
                  ("ormqr", (512, 8, 8)), ("tpmqrt", (64, 64, 8)),
                  ("blk2cyc", (2048,))]
MEASURED_MATMUL = {"gemm", "syrk", "trmm", "ormqr", "tpmqrt"}
# the card's result against the port's CPU run on the same operands:
# (rtol, atol as a fraction of the CPU result's largest magnitude), the CPU
# tests' tolerances against the JAX package (tests/test_torch_blas.py)
MEASURED_TOL = {"matmul": (1e-4, 1e-4), "solve": (1e-3, 1e-5)}
MEASURED_TILES = (256, 512, 832)        # SLATE Cholesky's tile widths


def measured_kinds(device="cuda"):
    """Every compute kind timed once on ``device`` by a ``MeasuredTimer``
    and its result held against the port's CPU run on the same operands
    (geqrf/tpqrt: R^T R, R being unique up to row signs)."""
    from repro_torch.core.signatures import Signature
    from repro_torch.linalg.blas import MeasuredTimer
    card = MeasuredTimer(seed=0, device=device)
    host = MeasuredTimer(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    rows = []
    for name, params in MEASURED_KINDS:
        sig = Signature("comp", name, params)
        before = ops.launches["matmul"]
        ms = 1e3 * card(sig, rng)
        fn, args = card._operands(sig)
        _, hargs = host._operands(sig)
        if not all(torch.equal(a.cpu(), h) for a, h in zip(args, hargs)):
            raise AssertionError(f"[measured] {sig}: operands differ")
        if fn == "copy":
            got, want = args[0].clone().cpu(), hargs[0].clone()
        else:
            got, want = fn(*args).cpu(), fn(*hargs)
        if name in ("geqrf", "tpqrt"):
            got, want = got.T @ got, want.T @ want
        rtol, arel = MEASURED_TOL["matmul" if name in MEASURED_MATMUL
                                  else "solve"]
        scale = float(want.abs().max())
        err = check_close(f"measured {sig}", got, want, "float32",
                          (rtol, arel * scale) if fn != "copy" else (0, 0))
        launched = ops.launches["matmul"] - before
        if device != "cpu" and (launched > 0) != (name in MEASURED_MATMUL):
            raise AssertionError(f"[measured] {sig}: {launched} matmul "
                                 f"launches")
        rows.append({"sig": str(sig), "ms": ms, "max_abs_err": err,
                     "scale": scale, "matmul_launches": launched})
    print("[measured] every kind on the card against the port's CPU run "
          "(ms of one timed call; max abs err / scale): " + "; ".join(
              f"{r['sig']} {r['ms']:.4f} ms {r['max_abs_err']:.1e}/"
              f"{r['scale']:.1e}" for r in rows))
    return rows


def phase_measured(device="cuda"):
    """The paper's Cholesky and QR tuning studies (``core/tuner.py``
    ``Autotuner``, trials 2, seed 0, every configuration of the ci scale)
    with every compute kernel run and timed on ``device`` by
    ``linalg/blas.py``'s ``MeasuredTimer`` and the communication drawn
    from the Stampede2 cost model; the launch counters zeroed just before
    each study and read just after."""
    from repro_torch.core.policies import policy
    from repro_torch.core.tuner import Autotuner
    from repro_torch.linalg.blas import MeasuredTimer
    from repro_torch.linalg.studies import STUDIES
    from repro_torch.simmpi.costmodel import KNL_STAMPEDE2, CostModel
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"studies": []}
    for name, policies in MEASURED:
        for pol in policies:
            study = STUDIES[name]("ci")
            timer = MeasuredTimer(comm_model=CostModel(
                KNL_STAMPEDE2, allocation=0, seed=0), seed=0, device=device)
            _zero_counts()
            t0 = time.perf_counter()
            rep = Autotuner(study, policy(pol, tolerance=0.25), trials=2,
                            seed=0, timer=timer).tune()
            wall = time.perf_counter() - t0
            launches, plain = dict(ops.launches), dict(ops.plain_calls)
            errs = [abs(r.rel_error) for r in rep.records]
            for r in rep.records:
                if not (math.isfinite(r.predicted) and r.predicted > 0
                        and r.full_time > 0):
                    raise AssertionError(f"[measured] {r.name}: bad times "
                                         f"{r.to_json()}")
                print(f"[measured] {study.name} {pol} {r.name:22s} full "
                      f"{1e3 * r.full_time:10.3f} ms predicted "
                      f"{1e3 * r.predicted:10.3f} ms rel err "
                      f"{r.rel_error:+.4f} executed {r.executed:6d} skipped "
                      f"{r.skipped:6d}")
            row = {"study": study.name, "policy": pol, "tolerance": 0.25,
                   "configs": len(rep.records),
                   "speedup": rep.speedup,
                   "full_tuning_time_s": rep.full_tuning_time,
                   "selective_tuning_time_s": rep.selective_tuning_time,
                   "mean_abs_rel_error": float(np.mean(errs)),
                   "max_abs_rel_error": float(np.max(errs)),
                   "chosen": rep.chosen.name, "true_best": rep.true_best.name,
                   "optimum_quality": rep.optimum_quality,
                   "calls": timer.calls, "launches": launches,
                   "plain_calls": plain, "wall_s": wall}
            out["studies"].append(row)
            print(f"[measured] {study.name} {pol} tol 0.25 on {device}: "
                  f"speedup {rep.speedup:.3f}x (full "
                  f"{rep.full_tuning_time:.4f} s, selective "
                  f"{rep.selective_tuning_time:.4f} s); "
                  f"prediction error mean {row['mean_abs_rel_error']:.4f} max "
                  f"{row['max_abs_rel_error']:.4f}; chosen {row['chosen']} "
                  f"true best {row['true_best']} (quality "
                  f"{rep.optimum_quality:.4f}); MeasuredTimer.calls "
                  f"{timer.calls}, matmul launches {launches['matmul']}, "
                  f"plain calls {sum(plain.values())}; wall {wall:.1f} s; "
                  f"no cut")
            if device != "cpu" and (any(plain.values())
                                    or launches["matmul"] <= 0):
                raise AssertionError(f"[measured] {study.name}: launches "
                                     f"{launches}, plain calls {plain}")
    out["kinds"] = measured_kinds(device)
    if device != "cpu":
        gen = torch.Generator().manual_seed(9)
        out["tiles"] = []
        for n in MEASURED_TILES:
            a, b = matmul_case(n, n, n, torch.float32, gen)
            row = {"kernel": "matmul", "shape": f"measured gemm {n}x{n}x{n}",
                   "dtype": "float32", "path": matmul_path(a, b),
                   "max_abs_err": check_close("matmul", ops.matmul(a, b),
                                              ref.matmul_ref(a, b),
                                              "float32")}
            time_row(row, "matmul", (a, b), "float32")
            out["tiles"].append(row)
    return out


# -- phase 10: the port's workers under the supervisor ------------------------

GOLDEN_SWEEP = dict(policies=["conditional", "eager"], tolerances=[0.25])


def golden_space(index: int = 1):
    """Worker spec (``python -m repro_torch.api.worker --spec
    chip_smoke:golden_space``): the session-API space of one golden study
    of the ported golden runner, as ``phase_sim`` builds it."""
    return _port_golden_runner().golden_space(index)


def lm_space(reduced: bool = False, device=None, counts=None):
    """Worker spec (``--spec chip_smoke:lm_space``): smollm-135m's
    ``LMStudy`` StepKnobs space at the tuning loop's traffic (``STUDY``)
    and the ``WallClockBackend`` that ``LMStudy.session`` builds over it;
    full width on the card by default.  Thunks are built on first use, so
    the dispatching process can build the same pair to check a worker's
    identity without launching a kernel.  ``counts``: a file that
    receives the process's ``ops.launches`` and ``ops.plain_calls``
    (JSON) when it exits."""
    from repro_torch.api import WallClockBackend
    from repro_torch.tune.lm_study import LMStudy
    study = LMStudy("smollm-135m", reduced=reduced, device=device, **STUDY)
    if counts is not None:
        import atexit
        atexit.register(_write_counts, counts)
    return study.search_space(), WallClockBackend(study.kernels_of)


def _write_counts(path) -> None:
    Path(path).write_text(json.dumps({"launches": dict(ops.launches),
                                      "plain_calls": dict(ops.plain_calls)}))


def _strip(result) -> dict:
    """A sweep result's JSON less what differs between a remote and a
    serial run by design (tests/test_faults.py ``_strip``)."""
    d = result.to_json()
    d.pop("wall_s", None)
    d.get("extra", {}).pop("recovery", None)
    d.get("extra", {}).pop("program_cache", None)
    return d


def _worker_env() -> dict:
    """PYTHONPATH for a port worker: the package and this script (its
    specs)."""
    import os
    paths = [str(ROOT / "src"), str(ROOT)] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return {"PYTHONPATH": os.pathsep.join(paths)}


def _ready_watch(log: Path, n: int, out: dict) -> None:
    """Set ``out["ready"]`` to the perf_counter at which ``log`` holds its
    ``n``-th WORKER_READY line (polled every 10 ms, up to 15 minutes)."""
    deadline = time.perf_counter() + 900
    while time.perf_counter() < deadline:
        if log.exists() and log.read_bytes().count(b"WORKER_READY") >= n:
            out["ready"] = time.perf_counter()
            return
        time.sleep(0.01)


def _wait_exit(pool, timeout: float) -> None:
    """Wait for every worker of ``pool`` to end service (exit 0 after the
    executor hangs up), so that their exit hooks have run."""
    deadline = time.perf_counter() + timeout
    while pool.alive and time.perf_counter() < deadline:
        time.sleep(0.05)
    if pool.alive:
        raise AssertionError(f"{pool.alive} workers still running "
                             f"{timeout} s after the sweep")


def _sweep_events(sess, pool) -> set:
    return ({e["event"] for e in sess.last_sweep_events}
            | {e["event"] for e in pool.events})


def phase_workers_protocol(log_dir: Path):
    """(B1) Two port workers under a ``WorkerPool``, dialing a listening
    ``RemoteExecutor``, serve the golden space; one is chaos-killed on its
    first task, restarted by the supervisor and rejoins; the sweep equals
    the serial sweep bit for bit."""
    from repro_torch.api import (AutotuneSession, RemoteExecutor,
                                 SimBackend, WorkerPool, WorkerSpec)
    space = golden_space(1)
    serial = [_strip(r) for r in AutotuneSession(
        space, backend=SimBackend(), trials=2).sweep(workers=1,
                                                     **GOLDEN_SWEEP)]
    ex = RemoteExecutor(listen="127.0.0.1:0", join_timeout=120,
                        task_timeout=300, expect={"space": space.name})
    marker = log_dir / "b1-kill.marker"
    spec = dict(spec="chip_smoke:golden_space", spec_args={"index": 1},
                connect=ex.listen_address, env=_worker_env())
    specs = [WorkerSpec(faults={"kill_after": 1, "marker": str(marker)},
                        **spec), WorkerSpec(**spec)]
    sess = AutotuneSession(space, backend=SimBackend(), trials=2)
    t0 = time.perf_counter()
    with WorkerPool(specs, restart_backoff=0.1, ready_timeout=300,
                    log_dir=str(log_dir / "b1")) as pool:
        got = sess.sweep(executor=ex, max_retries=3, **GOLDEN_SWEEP)
    dt = time.perf_counter() - t0
    events = _sweep_events(sess, pool)
    want = {"worker_restart", "worker_joined", "worker_lost", "task_retry"}
    if [_strip(r) for r in got] != serial:
        raise AssertionError("[workers] B1: the remote sweep differs from "
                             "the serial sweep")
    if not marker.exists() or not want <= events or pool.restarts() < 1:
        raise AssertionError(f"[workers] B1: kill fired {marker.exists()}, "
                             f"restarts {pool.restarts()}, events {events}")
    print(f"[workers] B1 protocol: 2 port workers serving "
          f"chip_smoke:golden_space(1) ({space.name}), one killed on its "
          f"first task and restarted ({pool.restarts()} restart): "
          f"{len(got)} results equal the serial sweep bit for bit; events "
          f"{sorted(events)}; {dt:.1f} s")
    return {"results": len(got), "restarts": pool.restarts(),
            "events": sorted(events), "seconds": dt}


def phase_workers_card(log_dir: Path, device="cuda", reduced=False):
    """(B2) One port worker serving ``lm_space`` (the full-width
    smollm-135m wall-clock study) on the card, killed when its second task
    arrives (after its first) and restarted by the supervisor; the sweep
    of seeds 0 and 1 (the 12 StepKnobs points each, conditional 0.25,
    trials 3) finishes after the retry.  Only one card worker at a time: two
    processes on one card time-slice it and would time each other's
    work."""
    from repro_torch.api import (AutotuneSession, RemoteExecutor,
                                 WorkerPool, WorkerSpec)
    counts = log_dir / "b2-counts.json"
    marker = log_dir / "b2-kill.marker"
    args = {"reduced": reduced, "device": device, "counts": str(counts)}
    space, backend = lm_space(reduced=reduced, device=device)
    ex = RemoteExecutor(listen="127.0.0.1:0", join_timeout=600,
                        task_timeout=900,
                        expect={"space": space.name, "n_points": len(space),
                                "backend": backend.fingerprint()})
    spec = WorkerSpec(spec="chip_smoke:lm_space", spec_args=args,
                      connect=ex.listen_address, env=_worker_env(),
                      faults={"kill_after": 2, "marker": str(marker)})
    sess = AutotuneSession(space, backend=backend, policy="conditional",
                           tolerance=0.25, trials=3)
    watch = {}

    def on_event(e):
        if e["event"] == "worker_restart":
            import threading
            watch["restart"] = time.perf_counter()
            threading.Thread(target=_ready_watch, daemon=True, args=(
                log_dir / "b2" / "worker-0.log", 2, watch)).start()
    t0 = time.perf_counter()
    with WorkerPool(spec, restart_backoff=0.1, ready_timeout=600,
                    on_event=on_event, log_dir=str(log_dir / "b2")) as pool:
        ready_s = time.perf_counter() - t0
        got = sess.sweep(seeds=(0, 1), executor=ex, max_retries=2)
        _wait_exit(pool, 120)
    dt = time.perf_counter() - t0
    events = _sweep_events(sess, pool)
    if not marker.exists() or pool.restarts() < 1 or \
            not {"worker_restart", "worker_lost", "task_retry"} <= events:
        raise AssertionError(f"[workers] B2: kill fired {marker.exists()}, "
                             f"restarts {pool.restarts()}, events {events}")
    if "ready" not in watch:
        raise AssertionError("[workers] B2: the restarted worker never "
                             "printed WORKER_READY")
    restart_s = watch["ready"] - watch["restart"]
    n_pts = len(space)
    for res in got:
        if len(res.records) != n_pts or not all(
                math.isfinite(r.predicted) and r.predicted > 0
                and r.full_time > 0 for r in res.records):
            raise AssertionError(f"[workers] B2 seed {res.seed}: "
                                 f"{len(res.records)} of {n_pts} points "
                                 f"measured")
        print(f"[workers] B2 seed {res.seed}: {n_pts} points measured; "
              f"chosen {res.chosen.name} true best {res.true_best.name} "
              f"(quality {res.optimum_quality:.4f}); speedup "
              f"{res.speedup:.3f}x; retries "
              f"{res.extra.get('recovery', {}).get('retries', 0)}")
    worker = json.loads(counts.read_text())
    launches, plain = worker["launches"], worker["plain_calls"]
    print(f"[workers] B2 card worker (restarted incarnation, exit hook): "
          f"launches {launches}; plain calls {plain}")
    if device != "cpu" and (any(plain.values())
                            or not all(launches.values())):
        raise AssertionError(f"[workers] B2: launches {launches}, plain "
                             f"calls {plain}")
    print(f"[workers] B2: 1 card worker, {len(got)} tasks (seeds 0 and 1) "
          f"finished after {pool.restarts()} restart; first "
          f"WORKER_READY {ready_s:.1f} s after launch, restart to "
          f"WORKER_READY {restart_s:.1f} s; events {sorted(events)}; "
          f"{dt:.1f} s")
    return {"tasks": len(got), "points": n_pts, "restarts": pool.restarts(),
            "first_ready_s": ready_s, "restart_to_ready_s": restart_s,
            "launches": launches, "plain_calls": plain,
            "chosen": [r.chosen.name for r in got],
            "true_best": [r.true_best.name for r in got],
            "speedup": [r.speedup for r in got],
            "events": sorted(events), "seconds": dt}


def phase_workers(device="cuda", reduced=False):
    """(B1) then (B2), worker logs under a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-workers-") as d:
        return {"protocol": phase_workers_protocol(Path(d)),
                "card": phase_workers_card(Path(d), device=device,
                                           reduced=reduced)}


# -- phase 11: the MoE family (phi3.5-moe at full width) ---------------------

def draw_on(device, cfg, seed: int = 0):
    """``cfg``'s seeded weights drawn on ``device`` from its own generator
    (on the card: a CPU draw takes ~7 s a GB of f32)."""
    from repro_torch.models.model import init_params
    p = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                    device)
    torch.cuda.synchronize()
    return p


# phi3.5-moe at its published widths with the depth cut to 2 of 32 layers:
# 11.5 GB of f32 weights (the 32 layers' 168 GB fit no card; 4 layers,
# 21.9 GB, until the training phase needed the script's time)
MOE_LAYERS = 2
MOE_SERVE = dict(batch_size=4, s_max=256, max_new_tokens=16, seed=0)
MOE_REQUESTS = 8                # launch/serve.py's draw: 4-31 tokens each
MOE_COMPARE = ((13, 29), 4)     # CPU comparison: prompt lengths, steps
MOE_GRAD = dict(batch=2, seq=32)     # the study's traffic


def moe_kernel_cases(cfg):
    """(kernel, label, shape spec) at phi3.5-moe's shapes: the router (N
    16), the experts at M = cap (1 at a 4-slot decode step, 5 at a
    31-token prompt, 10 at the study's mb 2 x S 32), the untied head (N
    32064, not a multiple of 128), flash at d 128 over 32/8 heads at the
    prompts' shortest and longest, and RMSNorm at d_model 4096."""
    D, V, E = cfg.d_model, cfg.vocab, cfg.moe.n_experts
    Fe, H, KVH, d = cfg.moe.d_ff_expert, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    cases = [("matmul", f"{ph} router {M}x{D}x{E}", (M, D, E, False))
             for ph, M in (("decode", 4), ("prefill", PROMPT_MAX))]
    for ph, cap in (("decode", 1), ("prefill", 5), ("study", 10)):
        cases += [("matmul", f"{ph} expert gate/up {cap}x{D}x{Fe}",
                   (cap, D, Fe, False)),
                  ("matmul", f"{ph} expert down {cap}x{Fe}x{D}",
                   (cap, Fe, D, False))]
    cases += [("matmul", f"{ph} head {M}x{D}x{V}", (M, D, V, False))
              for ph, M in (("decode", 4), ("prefill", 1))]
    cases += [("flash_attention", f"prefill B1 S{S} H{H}/{KVH} d{d}",
               (1, S, S, H, KVH, d)) for S in (4, PROMPT_MAX)]
    cases += [("rmsnorm", f"{ph} {M}x{D}", (M, D))
              for ph, M in (("decode", 4), ("prefill", PROMPT_MAX))]
    return cases


def moe_per_step_launches(cfg):
    """Kernel launches per prefill and per decode step: each layer's
    attention norm (the MoE FFN reads none), q/k/v/o, the router and three
    products per expert; the final norm and the head."""
    L, E = cfg.n_layers, cfg.moe.n_experts
    mm = (4 + 1 + 3 * E) * L + 1
    return ({"rmsnorm": L + 1, "matmul": mm, "flash_attention": L},
            {"rmsnorm": L + 1, "matmul": mm, "flash_attention": 0})


def phase_moe_kernels(cfg):
    """Phase (e), first: every kernel at the MoE shapes against its plain
    version (f32 and bf16), f32 timed beside bound, plain and library."""
    gen = torch.Generator().manual_seed(6)
    rows, worst = [], {}
    check_cases([(n, lab, sp, (torch.float32,))
                 for n, lab, sp in moe_kernel_cases(cfg)], gen, rows, worst)
    print(f"[moe] {len(rows)} kernel cases at the MoE shapes agree; max "
          f"abs err per kernel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    return rows


def _serve_engine(model, params):
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(model, params, ServeConfig(**MOE_SERVE))
    for req in synthetic_requests(MOE_REQUESTS, model.cfg.vocab, 0):
        eng.submit(req)
    return eng


def serve_family(tag, arch, depth, cfg, p_cpu, p_gpu, per_step,
                 flash_pairs=None):
    """``serve_runs``, then the card's prefill and teacher-forced decode
    logits against the port's CPU run on the same weights, routing
    compared first."""
    stats = serve_runs(tag, arch, depth, cfg, p_gpu, per_step, flash_pairs)
    # the same weights on the CPU: routing first, then the logits
    prompts, steps = MOE_COMPARE
    t0 = time.perf_counter()
    worst, pairs, dropped = logits_vs_cpu(cfg, p_gpu, p_cpu, steps, prompts)
    rtol, atol = SERVE_TOL
    stats.update({"cpu_max_abs_err": worst, "cpu_pairs": pairs,
                  "cpu_pairs_dropped": dropped,
                  "cpu_compare_s": time.perf_counter() - t0})
    print(f"[{tag}] CUDA vs CPU (prefill + {steps} teacher-forced decode "
          f"steps, prompts {prompts}): routing equal in every layer and "
          f"call, {dropped} of {pairs} token-expert pairs dropped by the "
          f"capacity; logits max abs err {worst:.3e} (rtol {rtol}, atol "
          f"{atol}); {stats['cpu_compare_s']:.1f} s")
    return stats


SERVE_RUNS = 2


def serve_runs(tag, arch, depth, cfg, p_gpu, per_step, flash_pairs=None):
    """Serve 8 requests on the card ``SERVE_RUNS`` times with the launch
    counters zeroed just before the first and read just after it: the
    forward kernels only, the expected count per prefill and decode step
    (``per_step``), no plain call, the same tokens every run; host-clock
    ms (least of the runs).  ``flash_pairs``: a list that records the
    (dk, dv) of every flash launch of the first run."""
    from repro_torch.models.model import Model
    model = Model(cfg, device=_device_of(p_gpu))
    runs = []
    for i in range(SERVE_RUNS):
        eng = _serve_engine(model, p_gpu)
        if i == 0:
            _zero_counts()
        with _recording_flash_pairs(flash_pairs if i == 0 else None):
            eng.run()
        torch.cuda.synchronize()
        if i == 0:
            launches, plain = dict(ops.launches), dict(ops.plain_calls)
        runs.append(eng)
    print(f"[{tag}] serve launches: {launches}; plain calls: {plain}")
    if any(plain.values()):
        raise AssertionError(f"the {arch} serve called plain versions: "
                             f"{plain}")
    if any(launches[k] for k in launches if k not in FORWARD):
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{launches}")
    launches = {k: launches[k] for k in FORWARD}
    eng = runs[0]
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    per_pre, per_dec = per_step
    expect = {k: len(pre) * per_pre[k] + len(dec) * per_dec[k]
              for k in launches}
    if launches != expect or not all(launches.values()):
        raise AssertionError(f"launches {launches} != {len(pre)} prefills "
                             f"and {len(dec)} decode steps: {expect}")
    toks = {u: r.tokens for u, r in eng.results.items()}
    if len(toks) != MOE_REQUESTS or any(
            len(t) != MOE_SERVE["max_new_tokens"] or not all(
                0 <= x < cfg.vocab for x in t) for t in toks.values()):
        raise AssertionError(f"the {arch} serve results have the wrong "
                             f"count or range")
    if any({u: r.tokens for u, r in e.results.items()} != toks
           for e in runs[1:]):
        raise AssertionError(f"the {arch} serve gave other tokens on a "
                             f"rerun")
    means = [(float(np.mean(e.timings["prefill_s"])),
              float(np.mean(e.timings["decode_s"]))) for e in runs]
    n_tok = sum(len(t) for t in toks.values())
    stats = {
        "layers": cfg.n_layers, "requests": len(toks), "tokens": n_tok,
        "prefill_ms": 1e3 * min(m[0] for m in means),
        "decode_ms": 1e3 * min(m[1] for m in means),
        "prefill_ms_runs": [1e3 * m[0] for m in means],
        "decode_ms_runs": [1e3 * m[1] for m in means],
        "decode_ms_median_first_run": 1e3 * float(np.median(dec)),
        "tokens_per_s": max(n_tok / (sum(e.timings["prefill_s"])
                                     + sum(e.timings["decode_s"]))
                            for e in runs),
        "decode_steps": len(dec), "prefills": len(pre), "launches": launches,
        "launches_per_prefill": per_pre, "launches_per_decode_step": per_dec}
    print(f"[{tag}] serve full-width {arch} ({cfg.n_layers} of {depth} "
          f"layers, f32): {len(toks)} requests, {n_tok} tokens, same tokens "
          f"in {SERVE_RUNS} runs; prefill {stats['prefill_ms']:.2f} ms a "
          f"request, decode {stats['decode_ms']:.2f} ms a step (host clock, "
          f"least of {SERVE_RUNS} runs: "
          f"{[round(m, 2) for m in stats['decode_ms_runs']]}); "
          f"launches a prefill {per_pre}, a decode step {per_dec}")
    return stats


@contextlib.contextmanager
def _recording_flash_pairs(pairs, entry="flash_attention_cuda",
                           heads=False):
    """While open, every launch of the flash forward on the card (``entry``
    "flash_attention_bwd_cuda": the backward) appends its (dk, dv) to
    ``pairs``, or with ``heads`` its (H, KVH, dk, dv) (measurement only;
    None: nothing wrapped)."""
    if pairs is None:
        yield
        return
    fn = getattr(ops, entry)

    def rec(q, k, v, *a, **kw):
        pairs.append((q.shape[2], k.shape[2]) * heads
                     + (q.shape[-1], v.shape[-1]))
        return fn(q, k, v, *a, **kw)
    setattr(ops, entry, rec)
    try:
        yield
    finally:
        setattr(ops, entry, fn)


def _labelled(module, names):
    """A context that wraps ``module``'s functions ``names`` in profiler
    ranges named after them (measurement only; restored on exit)."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    @contextlib.contextmanager
    def ctx():
        saved = {n: getattr(module, n) for n in names}
        for n, fn in saved.items():
            setattr(module, n, wrap(n, fn))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)
    return ctx()


def profile_decode(tag, cfg, params, steps, ranges):
    """torch.profiler over ``steps`` decode steps of a full batch (4 slots,
    16-token prompts): device busy ms, idle share, time by kernel, split
    by ``ranges``, innermost first: (module, function, name of its matmul
    launches, name of its other device work, matmul launches expected a
    step or None).  Each function runs inside a profiler range named
    after it, which the profiler also lays on the device's timeline, and
    a kernel belongs to the innermost range whose device span holds it
    (one stream, so no other kernel falls inside a span).  The tracer
    sees one step first that the reading leaves out (the profiler's first
    events can go missing); the kept steps run inside a range of their
    own, and only device events within its span count."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    eng = Engine(Model(cfg, device="cuda"), params,
                 ServeConfig(batch_size=4, s_max=256, max_new_tokens=64))
    rng = np.random.default_rng(2)
    for uid in range(4):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab, size=(16,))))
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    labels = [r[1] for r in ranges]
    window = "profiled steps"
    with contextlib.ExitStack() as stack:
        for module, name, *_ in ranges:
            stack.enter_context(_labelled(module, (name,)))
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        eng.step()                  # traced, left out of the reading
        torch.cuda.synchronize()
        n_dec = len(eng.timings["decode_s"])
        with record_function(window):
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
    dec_ms = 1e3 * float(np.mean(eng.timings["decode_s"][n_dec:]))
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kept = [(e.time_range.start, e.time_range.end) for e in on_dev
            if e.name == window]
    if len(kept) != 1:
        print(f"[{tag}] the profiler laid {len(kept)} device spans for the "
              f"kept steps, not 1; device busy share not measured")
        return {"decode_ms_profiled": dec_ms, "device_events": len(on_dev)}
    on_dev = [e for e in on_dev if kept[0][0] <= e.time_range.start
              and e.time_range.end <= kept[0][1] and e.name != window]
    spans = {n: [(e.time_range.start, e.time_range.end) for e in on_dev
                 if e.name == n] for n in labels}
    dev = [e for e in on_dev if e.name not in labels]
    if not dev:
        print(f"[{tag}] the profiler recorded no device events; device "
              f"busy share not measured")
        return {"decode_ms_profiled": dec_ms, "device_events": 0}

    def scope(e):
        return next((r for r in ranges if any(
            a <= e.time_range.start and e.time_range.end <= b
            for a, b in spans[r[1]])), None)

    def ours(name):
        return next((k for k, frags in KERNEL_NAMES.items()
                     if any(f in name for f in frags)), None)

    def part_of(e):
        k, r = ours(e.name), scope(e)
        if k == "matmul":
            return r[2] if r else "other products"
        return k or (r[3] if r else "other plain ops")

    parts = {}
    for e in dev:
        part = part_of(e)
        c, t = parts.get(part, (0, 0.0))
        parts[part] = (c + 1, t + e.time_range.elapsed_us())
    busy = sum(e.time_range.elapsed_us() for e in dev)
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    by_name = {}
    for e in dev:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    unlinked = {r[2]: (parts.get(r[2], (0, 0.0))[0] / steps, r[4])
                for r in ranges
                if r[4] is not None
                and parts.get(r[2], (0, 0.0))[0] / steps != r[4]}
    out = {
        "decode_ms_profiled": dec_ms,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_span_ms_per_step": span / steps / 1e3,
        "device_idle_share": 1.0 - busy / span,
        "device_events_per_step": len(dev) / steps,
        "split_linked": not unlinked,
        "parts_per_step": {k: {"count": c / steps, "ms": t / steps / 1e3,
                               "share_of_busy": t / busy}
                           for k, (c, t) in sorted(
                               parts.items(), key=lambda kv: -kv[1][1])},
        "top_device_time_per_step": [
            {"name": n[:80], "count": c / steps, "us": t / steps}
            for n, (c, t) in top]}
    print(f"[{tag}] decode step under the profiler {dec_ms:.2f} ms; device "
          f"busy {out['device_busy_ms_per_step']:.3f} ms of a "
          f"{out['device_span_ms_per_step']:.3f} ms span (idle share "
          f"{out['device_idle_share']:.3f}); "
          f"{out['device_events_per_step']:.0f} device events a step")
    for part, (got, want) in unlinked.items():
        print(f"[{tag}] the profiler's device spans held {got:.0f} of "
              f"{want} {part} a step: the split below is not measured")
    for k, v in out["parts_per_step"].items():
        print(f"[{tag}]   {v['ms']:8.3f} ms  ({100 * v['share_of_busy']:5.1f}%"
              f" of busy)  x{v['count']:6.1f}  {k}")
    for row in out["top_device_time_per_step"]:
        print(f"[{tag}]   {row['us']:9.1f} us  x{row['count']:5.1f}  "
              f"{row['name']}")
    return out


def moe_fb_bound(cfg, dispatch, remat, T, cap):
    """(bound ms, by) of one layer's ``moe_fb`` at f32: the weights read
    and their gradients written once; the products' operations (the
    router and 3 a expert, on E x cap rows under sort and E x T under
    dense; the backward twice the forward, and remat full one forward
    more)."""
    D, E, Fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert
    weights = D * E + 3 * E * D * Fe
    rows = E * (cap if dispatch == "sort" else T)
    fwd = 2 * T * D * E + 2 * rows * D * Fe * 3
    passes = 4 if remat == "full" else 3
    return bound(4 * (2 * weights + 2 * T * D), passes * fwd, "float32")


def phase_moe_grads(cfg, p_cpu, p_gpu, reps: int = 5):
    """(c) One full-width layer's ``moe_fb`` gradients (the study's
    closure on layer 0's weights), sort and dense, remat none and full,
    at mb 2 x S 32: the card against the port's CPU run, routing
    compared first; then the card's closure timed warm, the least of
    ``reps`` calls on the host clock (each call ends in a device sync, as
    the study times it), beside its bound: the ``moe_dispatch`` knob's
    reading at full width."""
    from repro_torch.models import moe
    from repro_torch.tune.lm_study import MOE_UNREAD, grad_closure, moe_loss
    rtol, atol = STUDY_TOL
    layer = [{k[4:]: v[0] for k, v in p["pos0"].items()
              if k.startswith("ffn_")} for p in (p_gpu, p_cpu)]
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((MOE_GRAD["batch"], MOE_GRAD["seq"], cfg.d_model),
                    generator=gen)
    xs = (x.to("cuda"), x)
    routes = []
    with torch.no_grad():
        for p, xx in zip(layer, xs):
            r = []
            moe.moe_ffn(p, xx, cfg, dispatch="sort", routing=r)
            routes.append([t.cpu() for t in r[0]])
    (gi, gk), (ci, ck) = routes
    if not (torch.equal(gi, ci) and torch.equal(gk, ck)):
        raise AssertionError("[moe] full-width gradient inputs route "
                             "differently on the card and the CPU")
    T = x.shape[0] * x.shape[1]
    cap = moe.sort_capacity(T * cfg.moe.top_k, cfg.moe.n_experts,
                            cfg.moe.capacity_factor)
    rows = []
    for dispatch in ("sort", "dense"):
        for remat in ("none", "full"):
            fns = [grad_closure(moe_loss(cfg, dispatch), remat, xx.device,
                                unread=MOE_UNREAD) for xx in xs]
            out = [fn(p, xx) for fn, p, xx in zip(fns, layer, xs)]
            worst = grads_vs_cpu(f"[moe] moe_fb {dispatch} remat {remat}",
                                 *out)
            del out
            runs = warm_ms(lambda: fns[0](layer[0], xs[0]), reps)
            b_ms, b_by = moe_fb_bound(cfg, dispatch, remat, T, cap)
            rows.append({"dispatch": dispatch, "remat": remat,
                         "max_err_over_scale": worst, "ms": min(runs),
                         "ms_runs": runs, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"[moe] full-width moe_fb {dispatch} remat {remat} at mb "
                  f"{MOE_GRAD['batch']} x S {MOE_GRAD['seq']} (cap {cap}): "
                  f"card vs CPU within rtol {rtol}, atol {atol} x scale "
                  f"(max err / scale {worst:.2e}); card {min(runs):.3f} ms "
                  f"a call (host clock with its sync, warm, least of "
                  f"{reps}: {[round(m, 3) for m in runs]}); bound "
                  f"{b_ms:.3f} ms ({b_by})")
    ms = {(r["dispatch"], r["remat"]): r["ms"] for r in rows}
    ratio = {rm: ms[("dense", rm)] / ms[("sort", rm)]
             for rm in ("none", "full")}
    print(f"[moe] moe_dispatch at full width: dense / sort "
          + ", ".join(f"{v:.3f}x at remat {k}" for k, v in ratio.items()))
    return {"cap": cap, "routed_pairs_dropped": int((~ck).sum()),
            "rows": rows, "dense_over_sort": ratio}


def study_session(tag, study, bwd_pairs=None, trials: int = 3):
    """A conditional session (tolerance 0.25, ``trials`` selective runs a
    point after its reference run) over the study's
    whole space (``lm_config_space``) on the card, the launch counters
    zeroed just before and read just after: every kernel of the
    configuration's path launched (the flash kernels where it has
    attention), no other, no plain call; every point measured.
    ``bwd_pairs``: a list that records the (dk, dv) of every flash
    backward launch.  Returns (result, launches, wall s)."""
    from repro_torch.tune.lm_study import lm_config_space
    name, n_points = study.cfg.name, len(lm_config_space(study.cfg))
    _zero_counts()
    t0 = time.perf_counter()
    with _recording_flash_pairs(bwd_pairs, "flash_attention_bwd_cuda"):
        res = study.session(policy="conditional", tolerance=0.25,
                            trials=trials).run()
    wall = time.perf_counter() - t0
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    print(f"[{tag}] study launches: {launches}; plain calls: {plain}")
    if any(plain.values()):
        raise AssertionError(f"the {name} study called plain versions: "
                             f"{plain}")
    attention = bool({"attn", "mla"} & set(study.cfg.pattern))
    path = {k for k in launches if attention or not k.startswith("flash")}
    launched = {k for k, n in launches.items() if n > 0}
    if launched != path:
        raise AssertionError(f"the {name} study launched {sorted(launched)}"
                             f", not {sorted(path)}")
    if len(res.records) != n_points:
        raise AssertionError(f"{len(res.records)} configurations, not "
                             f"{n_points}")
    for r in res.records:
        if not (math.isfinite(r.predicted) and r.predicted > 0
                and r.full_time > 0):
            raise AssertionError(f"[{tag}] {r.name}: bad times "
                                 f"{r.to_json()}")
    return res, launches, wall


def cut_periods(study, periods: int) -> None:
    """Cut a study's depth to ``periods`` periods of its layer pattern, its
    per-period weights to match."""
    study.cfg = replace(study.cfg, n_layers=periods * study.cfg.period)
    study.params = {g: {k: v[:periods] for k, v in sub.items()}
                    if g.startswith("pos") else sub
                    for g, sub in study.params.items()}


def phase_family_study(tag, arch, mixers, bwd_pairs=None, periods=None,
                       trials: int = 3):
    """(d) A reduced family's study on the card, a protocol check
    (``study_session``); with MoE layers, the sort and dense points share
    every kernel of ``mixers`` (names such as ``attn_fb``) and no
    ``moe_fb``.  At the reduced width (d_model 64, 4 experts of 64) the
    two dispatches differ by less than the run-to-run noise, so its
    chosen point and speedup say nothing of the knob: phase (c) times the
    knob at full width.  ``periods``: a depth cut to that many periods of
    the configuration's layer pattern (its weights cut to match);
    ``trials``: the selective runs a point (fewer rounds)."""
    from repro_torch.tune.lm_study import LMStudy, lm_config_space
    study = LMStudy(arch, **STUDY)
    depth = study.cfg.n_layers
    if periods is not None:
        cut_periods(study, periods)
    res, launches, wall = study_session(tag, study, bwd_pairs, trials)
    sigs = {"sort": set(), "dense": set()}
    for kn in lm_config_space(study.cfg):
        sigs[kn.moe_dispatch] |= {str(s) for s, _, _ in
                                  study.kernel_sequence(kn)}
    shared = sigs["sort"] & sigs["dense"]
    sharing = ""
    if study.cfg.moe:
        moe_shared = sorted(s for s in shared if "moe_fb" in s)
        mix = {d: {s for s in v if any(m in s for m in mixers)}
               for d, v in sigs.items()}
        if moe_shared or not mix["sort"] or mix["sort"] != mix["dense"]:
            raise AssertionError(f"[{tag}] sort and dense share moe_fb "
                                 f"{moe_shared} or not every {mixers}")
        sharing = (f"; sort and dense share {len(shared)} signatures: "
                   f"every {'/'.join(mixers)} ({len(mix['sort'])}), no "
                   f"moe_fb")
    print(f"[{tag}] study (reduced {arch}, {study.cfg.n_layers} of {depth} "
          f"layers, {len(res.records)} points, "
          f"conditional 0.25, trials {trials}; a protocol check, not a "
          f"reading of "
          f"the knob): chosen {res.chosen.name} true best "
          f"{res.true_best.name} (optimum quality "
          f"{res.optimum_quality:.4f}); speedup {res.speedup:.3f}x; wall "
          f"{wall:.1f} s{sharing}")
    return {"records": [r.to_json() for r in res.records],
            "chosen": res.chosen.name, "true_best": res.true_best.name,
            "speedup": res.speedup, "optimum_quality": res.optimum_quality,
            "full_tuning_time_s": res.full_tuning_time,
            "selective_tuning_time_s": res.selective_tuning_time,
            "wall_s": wall, "launches": launches,
            "shared_signatures": sorted(shared)}


def phase_moe():
    """(e) the kernels at the MoE shapes, then the full-width weights
    (drawn on the card from a seeded CUDA generator; a copy on the host):
    (a) serve, (b) profile, (c) gradients; then (d) the reduced study."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = replace(get_config("phi3.5-moe"), n_layers=MOE_LAYERS)
    kernel_rows = phase_moe_kernels(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p_gpu = draw_on("cuda", cfg)
    draw_s = time.perf_counter() - t0
    p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
             for g, sub in p_gpu.items()}
    n_params = sum(v.numel() for sub in p_cpu.values() for v in sub.values())
    print(f"[moe] phi3.5-moe at full width, {cfg.n_layers} of 32 layers: "
          f"{n_params} f32 parameters ({4 * n_params / 1e9:.1f} GB), drawn "
          f"on the card in {draw_s:.1f} s and copied to the host in "
          f"{time.perf_counter() - t0 - draw_s:.1f} s")
    serve_stats = serve_family("moe", "phi3.5-moe", 32, cfg, p_cpu, p_gpu,
                               moe_per_step_launches(cfg))
    # the expert products and the dispatch's plain ops split out
    serve_stats["profile"] = profile_decode("moe", cfg, p_gpu, 3, [
        (moe, "_expert_ffn", "expert products",
         "experts' plain ops (silu, mul, stack)",
         3 * cfg.moe.n_experts * cfg.n_layers),
        (moe, "moe_ffn", "router products", "dispatch's plain ops", None)])
    grads = phase_moe_grads(cfg, p_cpu, p_gpu)
    del p_cpu
    # [sharded] (d) on these weights: three 11.5 GB trees fit the card
    sharded = sharded_moe(cfg, p_gpu)
    del p_gpu
    torch.cuda.empty_cache()
    study = phase_family_study("moe", "phi3.5-moe", ("attn_fb",))
    return {"kernels": kernel_rows, "serve": serve_stats, "grads": grads,
            "study": study, "params": n_params, "sharded": sharded}


# -- phase 12: MLA (deepseek-v2 at full width) -------------------------------

# deepseek-v2 at its published widths with the depth cut to 1 of 60 layers:
# 20.08 GB of f32 weights (a layer is 15.89 GB: MLA 0.60, MoE 15.29; the
# embedding and the untied head 4.19; 2 layers, 35.97 GB, until the
# training phase needed the script's time)
MLA_LAYERS = 1


def mla_kernel_cases(cfg):
    """(kernel, label, shape spec, timed dtypes) at deepseek-v2's shapes:
    flash at (dk, dv) = (192, 128) over 128/128 heads at the prompts'
    shortest and longest (f32 and bf16 timed) and the reduced
    configuration's (24, 16); the absorbed decode's per-head products on
    their strided views (q_lat 4 x 128 x 512, o 4 x 512 x 128), wq_b and
    wo at a 4-slot decode step, the router (N 160), the experts at M = 1
    (cap 1), the untied head (N 102400); RMSNorm at q_ln's 1536 and
    kv_ln's 512."""
    f32, bf16 = torch.float32, torch.bfloat16
    m, H, D, V = cfg.mla, cfg.n_heads, cfg.d_model, cfg.vocab
    E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
    dk, dv, r = m.d_nope + m.d_rope, m.d_v, m.kv_lora
    cases = [("flash_attention", f"prefill B1 S{S} H{H}/{H} dk{dk} dv{dv}",
              (1, S, S, H, H, dk, dv), (f32, bf16))
             for S in (4, PROMPT_MAX)]
    cases.append(("flash_attention", "reduced B1 S31 H4/4 dk24 dv16",
                  (1, PROMPT_MAX, PROMPT_MAX, 4, 4, 24, 16), (f32, bf16)))
    mm = [(f"decode absorbed q_lat 4x{m.d_nope}x{r} (head block, strided)",
           (4, m.d_nope, r, "q_lat", H)),
          (f"decode absorbed o 4x{r}x{dv} (head block, strided)",
           (4, r, dv, "o_lat", H)),
          (f"decode wq_b 4x{m.q_lora}x{H * dk}", (4, m.q_lora, H * dk, False)),
          (f"decode wo 4x{H * dv}x{D}", (4, H * dv, D, False)),
          (f"decode router 4x{D}x{E}", (4, D, E, False)),
          (f"decode expert gate/up 1x{D}x{Fe}", (1, D, Fe, False)),
          (f"decode expert down 1x{Fe}x{D}", (1, Fe, D, False)),
          (f"decode head 4x{D}x{V}", (4, D, V, False))]
    cases += [("matmul", lab, sp, (f32,)) for lab, sp in mm]
    cases += [("rmsnorm", f"decode {lab} 4x{w}", (4, w), (f32,))
              for lab, w in (("q_ln", m.q_lora), ("kv_ln", r))]
    return cases


def mla_per_step_launches(cfg):
    """Kernel launches per prefill and per decode step: each layer's norms
    (ln, q_ln, kv_ln; the MoE FFN reads none), the MLA products (wq_a,
    wq_b, wkv_a and wo; in prefill the K/V expansions c_kv wk_b and c_kv
    wv_b, in decode 2H absorbed per-head products), the router, three
    products per expert and three for the shared experts; the final norm
    and the head."""
    L, H, E = cfg.n_layers, cfg.n_heads, cfg.moe.n_experts
    ffn = 1 + 3 * E + 3 * bool(cfg.moe.n_shared)
    norms = {"rmsnorm": 3 * L + 1}
    return ({**norms, "matmul": (6 + ffn) * L + 1, "flash_attention": L},
            {**norms, "matmul": (4 + 2 * H + ffn) * L + 1,
             "flash_attention": 0})


def mla_grad_cases(cfg):
    """(label, dims) of the flash backward at deepseek-v2's study shapes:
    mb 2 x S 32 over 128/128 heads at (dk, dv) = (192, 128), a GQA suffix
    with ragged tiles (Sq 33, Skv 70, 8/2 heads) at the same pair, and the
    reduced study's (24, 16) over 4/4 heads."""
    m, H = cfg.mla, cfg.n_heads
    dk, dv = m.d_nope + m.d_rope, m.d_v
    S = STUDY["seq"]
    return [(f"study mb2 S{S} H{H}/{H} dk{dk} dv{dv}",
             (2, S, S, H, H, dk, dv)),
            (f"GQA B2 Sq33 Skv70 H8/2 dk{dk} dv{dv}",
             (2, 33, 70, 8, 2, dk, dv)),
            (f"reduced study mb2 S{S} H4/4 dk24 dv16",
             (2, S, S, 4, 4, 24, 16))]


def phase_mla_bwd_kernels(cfg):
    """(e), the backward: the flash backward at MLA's pairs
    (``mla_grad_cases``) with MLA's scale 1/sqrt(dk), f32 and bf16, KV
    chunk 16 and 64, each against its plain version with two runs compared
    bit for bit, timed beside its bound, plain version and SDPA's
    backward."""
    gen = torch.Generator().manual_seed(8)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for label, dims in mla_grad_cases(cfg):
            for bk in (16, 64):
                rows.append(grad_case_flash(
                    f"{label} kv{bk}", dims, bk, gen, dtype=dt,
                    scale=1.0 / math.sqrt(dims[5]), tag="mla"))
    print(f"[mla] {len(rows)} flash backward cases at (dk, dv) "
          f"{sorted({tuple(r['pair']) for r in rows})} agree with the plain "
          f"version, each with the same bits on a second run")
    return rows


def mla_fb_bound(cfg, remat, B, S):
    """(bound ms, by) of one layer's ``mla_fb`` at f32: the mixer's weights
    read and their gradients written once, x read and its gradient
    written; the operations of its products (each projection 2 T flops a
    weight forward, twice that backward; the attention 2 (dk + dv) a
    visible pair forward, 6 dk + 4 dv backward), remat full one forward
    more."""
    m, H, D = cfg.mla, cfg.n_heads, cfg.d_model
    dk, dv = m.d_nope + m.d_rope, m.d_v
    mats = (D * m.q_lora + m.q_lora * H * dk + D * (m.kv_lora + m.d_rope)
            + m.kv_lora * H * m.d_nope + m.kv_lora * H * dv + H * dv * D)
    norms = D + m.q_lora + m.kv_lora
    T, pairs = B * S, B * H * causal_pairs(S, S)
    fwd = 2 * T * mats + 2 * (dk + dv) * pairs
    flops = fwd + 4 * T * mats + (6 * dk + 4 * dv) * pairs
    if remat == "full":
        flops += fwd
    return bound(4 * (2 * (mats + norms) + 2 * T * D), flops, "float32")


def phase_mla_grads(cfg, p_cpu, reps: int = 5):
    """(c) One full-width layer's ``mla_fb`` gradients (the study's closure
    on layer 0's MLA weights, its norm weights drawn), KV chunk 16 and 64,
    remat none and full, at mb 2 x S 32: the card against the port's CPU
    run (the card's flash backward launched at (dk, dv), no plain call);
    then the card's closure timed warm, the least of ``reps`` calls
    on the host clock (each ends in a device sync, as the study times
    it), beside its bound."""
    from repro_torch.tune.lm_study import StepKnobs, grad_closure, mla_loss
    rtol, atol = STUDY_TOL
    gen = torch.Generator().manual_seed(13)
    cpu = {k[4:]: (torch.randn(v.shape[1:], generator=gen) * 0.1
                   if k.endswith("ln") else v[0])
           for k, v in p_cpu["pos0"].items() if k.startswith("mix_")}
    layer = ({k: v.to("cuda") for k, v in cpu.items()}, cpu)
    B, S = STUDY["batch"], STUDY["seq"]
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    xs = (x.to("cuda"), x)
    pair = (cfg.mla.d_nope + cfg.mla.d_rope, cfg.mla.d_v)
    rows = []
    for kv in (16, 64):
        for remat in ("none", "full"):
            knobs = StepKnobs("k", remat=remat, kv_chunk=kv)
            fns = [grad_closure(mla_loss(cfg, knobs, torch.arange(
                S, device=xx.device)), remat, xx.device) for xx in xs]
            plain0, pairs = dict(ops.plain_calls), []
            with _recording_flash_pairs(pairs, "flash_attention_bwd_cuda"):
                out = [fns[0](layer[0], xs[0])]
            if ops.plain_calls != plain0 or set(pairs) != {pair}:
                raise AssertionError(
                    f"[mla] full-width mla_fb on the card: plain calls "
                    f"{ops.plain_calls} (before {plain0}), flash backward "
                    f"pairs {pairs}")
            out.append(fns[1](layer[1], xs[1]))
            worst = grads_vs_cpu(f"[mla] mla_fb kv{kv} remat {remat}", *out)
            del out
            runs = warm_ms(lambda: fns[0](layer[0], xs[0]), reps)
            b_ms, b_by = mla_fb_bound(cfg, remat, B, S)
            rows.append({"kv_chunk": kv, "remat": remat,
                         "max_err_over_scale": worst, "ms": min(runs),
                         "ms_runs": runs, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"[mla] full-width mla_fb kv{kv} remat {remat} at mb {B} "
                  f"x S {S}: card vs CPU within rtol {rtol}, atol {atol} x "
                  f"scale (max err / scale {worst:.2e}); card "
                  f"{min(runs):.3f} ms a call (host clock with its sync, "
                  f"warm, least of {reps}: {[round(m, 3) for m in runs]}); "
                  f"bound {b_ms:.3f} ms ({b_by})")
    # where one warm call goes (the last setting's closure)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fns[0](layer[0], xs[0])
        call_ms = 1e3 * (time.perf_counter() - t0)
    profiled = device_summary(
        "mla", f"full-width mla_fb kv{kv} remat {remat} under the profiler "
        f"{call_ms:.2f} ms", prof, top=8)
    return {"rows": rows, "profile": profiled}


def phase_mla():
    """(e) the kernels at deepseek-v2's shapes, forward and backward, then
    the full-width weights (drawn on the card; a copy on the host): (a)
    serve, with every flash launch's (dk, dv) recorded, and the
    CPU comparison; (b) three decode steps under the profiler, the
    absorbed per-head products and the expert products split out; (c)
    layer 0's full-width ``mla_fb`` gradients; then (d) the reduced
    study, every flash backward launch at (24, 16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, moe
    cfg = replace(get_config("deepseek-v2"), n_layers=MLA_LAYERS)
    gen = torch.Generator().manual_seed(7)
    rows, worst = [], {}
    check_cases(mla_kernel_cases(cfg), gen, rows, worst)
    print(f"[mla] {len(rows)} kernel cases at deepseek-v2's shapes agree; "
          f"max abs err per kernel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    bwd_rows = phase_mla_bwd_kernels(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p_gpu = draw_on("cuda", cfg)
    draw_s = time.perf_counter() - t0
    p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
             for g, sub in p_gpu.items()}
    n_params = sum(v.numel() for sub in p_cpu.values() for v in sub.values())
    # a decode step reads every block weight (each expert runs on its cap
    # rows, at least one), the final norm and the head; the embedding only
    # at its rows
    step_bytes = 4 * sum(v.numel() for g, sub in p_cpu.items() if g != "embed"
                         for v in sub.values())
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[mla] deepseek-v2 at full width, {cfg.n_layers} of 60 layers: "
          f"{n_params} f32 parameters ({4 * n_params / 1e9:.2f} GB), drawn "
          f"on the card in {draw_s:.1f} s and copied to the host in "
          f"{time.perf_counter() - t0 - draw_s:.1f} s; a decode step reads "
          f"{step_bytes / 1e9:.2f} GB of weights (bound {step_bound_ms:.2f} "
          f"ms at 3.35 TB/s)")
    pairs = []
    stats = serve_family("mla", "deepseek-v2", 60, cfg, p_cpu, p_gpu,
                         mla_per_step_launches(cfg), flash_pairs=pairs)
    if not pairs or set(pairs) != {(192, 128)}:
        raise AssertionError(f"[mla] flash launched at {sorted(set(pairs))}"
                             f", not only at (dk 192, dv 128)")
    print(f"[mla] the serve's {len(pairs)} flash launches were all at (dk "
          f"192, dv 128)")
    H, E, L = cfg.n_heads, cfg.moe.n_experts, cfg.n_layers
    stats["flash_pairs"] = sorted(set(pairs))
    stats["decode_step_weight_bytes"] = step_bytes
    stats["decode_step_bound_ms"] = step_bound_ms
    stats["profile"] = profile_decode("mla", cfg, p_gpu, 3, [
        (layers, "per_head_matmul", "absorbed per-head products",
         "absorbed plain ops (stack)", 2 * H * L),
        (moe, "_expert_ffn", "expert products",
         "experts' plain ops (silu, mul, stack)", 3 * E * L),
        (moe, "moe_ffn", "router and shared products",
         "dispatch's plain ops", None)])
    del p_gpu
    torch.cuda.empty_cache()
    grads = phase_mla_grads(cfg, p_cpu)
    del p_cpu
    torch.cuda.empty_cache()
    bwd_pairs = []
    study = phase_family_study("mla", "deepseek-v2", ("mla_fb",),
                               bwd_pairs)
    if not bwd_pairs or set(bwd_pairs) != {(24, 16)}:
        raise AssertionError(f"[mla] the study's flash backward launched at "
                             f"{sorted(set(bwd_pairs))}, not at (24, 16)")
    print(f"[mla] the study's {len(bwd_pairs)} flash backward launches were "
          f"all at (dk 24, dv 16)")
    return {"kernels": rows, "bwd_kernels": bwd_rows, "serve": stats,
            "grads": grads, "study": study, "params": n_params}


# -- phase 13: the SSM families (xlstm-125m, jamba at full width) -------------

# jamba-v0.1-52b at its published widths with the depth cut to one period,
# 8 of 32 layers (7 Mamba, attention at position 4; dense FFNs at even
# positions, MoE at odd ones): 12.79 B body and 0.54 B embedding and head
# parameters, 53.3 GB of f32; the largest layer, an MoE one, is 11.3 GB
JAMBA_LAYERS = 8
SSM_COMPARE = ((13, 29), 2)     # jamba's layer-by-layer comparison


def ssm_kernel_cases(xcfg, jcfg):
    """(kernel, label, shape spec, timed dtypes) at xlstm-125m's and
    jamba's shapes, f32 timed: each projection at a 4-slot decode step
    (M 4) and the widest at a 31-token prompt; sLSTM's h_i . r[i] (M = B,
    A on head i's columns of h) and Mamba's dt_w (A the dt rank's columns
    of x_proj's output) on their strided views; the router, the experts at
    cap 1 (decode) and 5 (31-token prompt), the untied heads; RMSNorm at
    768 and 4096; flash at d 128 over 32/8 heads."""
    f32 = (torch.float32,)
    D, di, nh, V = xcfg.d_model, xcfg.d_inner, xcfg.n_heads, xcfg.vocab
    dh = D // nh
    cases = []
    for ph, M in (("decode", 4), ("prefill", PROMPT_MAX)):
        cases += [("matmul", f"xlstm {ph} {lab} {M}x{K}x{N}",
                   (M, K, N, False), f32)
                  for lab, K, N in (("up / sLSTM w", D, 2 * di),
                                    ("wq/wk/wv", di, di),
                                    ("wif", di, 2 * nh),
                                    ("down", di, D))]
    cases += [("matmul", f"xlstm decode sLSTM r[i] 4x{dh}x{4 * dh} "
               f"(head block of h)", (4, dh, 4 * dh, "a_rows", D), f32),
              ("matmul", f"xlstm decode head 4x{D}x{V}", (4, D, V, False),
               f32)]
    D, di, N, V = jcfg.d_model, jcfg.d_inner, jcfg.d_state, jcfg.vocab
    dtr, E, Fe, F_ = di // 16, jcfg.moe.n_experts, jcfg.moe.d_ff_expert, \
        jcfg.d_ff
    HD, KD = jcfg.n_heads * jcfg.head_dim, jcfg.n_kv_heads * jcfg.head_dim
    for ph, M in (("decode", 4), ("prefill", PROMPT_MAX)):
        cases += [("matmul", f"jamba {ph} {lab} {M}x{K}x{N}",
                   (M, K, N, False), f32)
                  for lab, K, N in (("in_proj", D, 2 * di),
                                    ("x_proj", di, dtr + 2 * N),
                                    ("out_proj", di, D))]
        cases.append(("matmul", f"jamba {ph} dt_w {M}x{dtr}x{di} (rows of "
                      f"x_proj's output)", (M, dtr, di, "a_rows",
                                            dtr + 2 * N), f32))
    cases += [("matmul", f"jamba decode {lab} 4x{K}x{N}", (4, K, N, False),
               f32)
              for lab, K, N in (("q/o", D, HD), ("k/v", D, KD),
                                ("dense gate/up", D, F_),
                                ("dense down", F_, D), ("router", D, E))]
    for ph, cap in (("decode", 1), ("prefill", 5)):
        cases += [("matmul", f"jamba {ph} expert gate/up {cap}x{D}x{Fe}",
                   (cap, D, Fe, False), f32),
                  ("matmul", f"jamba {ph} expert down {cap}x{Fe}x{D}",
                   (cap, Fe, D, False), f32)]
    cases.append(("matmul", f"jamba decode head 4x{D}x{V}",
                  (4, D, V, False), f32))
    cases += [("rmsnorm", f"{arch} {ph} {M}x{w}", (M, w), f32)
              for arch, w in (("xlstm", xcfg.d_model),
                              ("jamba", jcfg.d_model))
              for ph, M in (("decode", 4), ("prefill", PROMPT_MAX))]
    H, KVH, d = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    cases += [("flash_attention", f"jamba prefill B1 S{S} H{H}/{KVH} d{d}",
               (1, S, S, H, KVH, d), f32) for S in (4, PROMPT_MAX)]
    return cases


def stack_launches(cfg, S: int):
    """Kernel launches of a prefill of an S-token prompt and of a decode
    step, from the configuration: per layer its mixer's norm and products
    (Mamba: in_proj, x_proj, dt_w, out_proj; mLSTM: up, wq, wk, wv, wif,
    down; sLSTM: w, up, down and nh recurrent products a step, so nh S a
    prefill; attention: q, k, v, o and one flash launch a prefill), its
    FFN's (dense: a norm and three products; MoE: the router and three
    products an expert, no norm); the final norm and the head (a launch a
    codebook)."""
    mm_mix = {"mamba": 4, "mlstm": 6, "slstm": 3, "attn": 4}
    pre = {"rmsnorm": 1, "matmul": max(cfg.n_codebooks, 1),
           "flash_attention": 0}
    dec = dict(pre)
    for kind, fk in zip(cfg.pattern * cfg.n_periods,
                        cfg.ffn_pattern * cfg.n_periods):
        if fk == "moe":
            ffn = 1 + 3 * cfg.moe.n_experts
        else:
            ffn = {"dense": 3, "none": 0}[fk]
        norms = 1 + (fk == "dense")
        rec = cfg.n_heads if kind == "slstm" else 0
        for out, steps in ((pre, S), (dec, 1)):
            out["rmsnorm"] += norms
            out["matmul"] += mm_mix[kind] + rec * steps + ffn
        pre["flash_attention"] += kind == "attn"
    return pre, dec


def serve_cli(tag, arch, reduced=False, device="cuda"):
    """``arch`` served through ``launch/serve.py`` as phase 3 serves
    smollm-135m (seeded weights drawn on the CPU and moved to ``device``),
    the launch counters zeroed just before and read just after: the
    forward kernels at the counts ``stack_launches`` gives for the prompts
    drawn, no plain call, every request's 16 tokens in range (lists of
    ``ncb`` with codebooks).  Returns (stats, the drained engine)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    argv = ["--arch", arch] + SERVE_ARGV[2:] + (
        ["--reduced"] if reduced else []) + ["--device", device]
    cfg = get_config(arch, reduced=reduced)
    _zero_counts()
    t0 = time.perf_counter()
    eng = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    print(f"[{tag}] {arch} serve launches: {launches}; plain calls: {plain}")
    if any(plain.values()):
        raise AssertionError(f"the {arch} serve called plain versions: "
                             f"{plain}")
    lens = [len(r.tokens) for r in serve.synthetic_requests(
        int(argv[argv.index("--requests") + 1]), cfg.vocab, 0,
        cfg.n_codebooks)]
    pre, dec = eng.timings["prefill_s"], eng.timings["decode_s"]
    per_dec = stack_launches(cfg, 1)[1]
    expect = {k: sum(stack_launches(cfg, n)[0][k] for n in lens)
              + len(dec) * per_dec[k] for k in per_dec}
    if any(launches[k] for k in launches if k not in FORWARD):
        raise AssertionError(f"serving launched a backward kernel: "
                             f"{launches}")
    got = {k: launches[k] for k in FORWARD}
    if got != expect:
        raise AssertionError(f"{arch} launches {launches} != {len(pre)} "
                             f"prefills of {lens} tokens and {len(dec)} "
                             f"decode steps: {expect}")
    toks = np.array([t for r in eng.results.values() for t in r.tokens])
    if len(eng.results) != len(lens) or any(
            len(r.tokens) != 16 for r in eng.results.values()) \
            or toks.shape[1:] != (() if not cfg.n_codebooks else
                                  (cfg.n_codebooks,)) \
            or not ((0 <= toks) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{arch} serve results have the wrong count, "
                             f"shape or range")
    n_params = sum(v.numel() for sub in eng.params.values()
                   for v in sub.values())
    stats = {"layers": cfg.n_layers, "params": n_params,
             "requests": len(eng.results), "tokens": len(toks),
             "main_wall_s": wall,
             "prefill_ms_mean": 1e3 * float(np.mean(pre)),
             "decode_ms_mean": 1e3 * float(np.mean(dec)),
             "decode_ms_median": 1e3 * float(np.median(dec)),
             "decode_steps": len(dec), "prefills": len(pre),
             "launches": got, "launches_per_decode_step": per_dec,
             "prompt_lengths": lens}
    print(f"[{tag}] serve full-width {arch} ({cfg.n_layers} layers, "
          f"{4 * n_params / 1e9:.2f} GB f32): {len(eng.results)} requests, "
          f"{len(toks)} tokens; prefill {stats['prefill_ms_mean']:.2f} ms a "
          f"request, decode {stats['decode_ms_mean']:.2f} ms a step (median "
          f"{stats['decode_ms_median']:.2f}; host clock); launches a decode "
          f"step {per_dec}")
    return stats, eng


def phase_ssm_xlstm(reduced=False, device="cuda"):
    """(a) xlstm-125m served through ``launch/serve.py`` (``serve_cli``:
    matmul and RMSNorm at the counts for the prompts drawn, no flash
    launch, no attention), then the card's prefill and 8 teacher-forced
    decode steps of two prompts against the port's CPU run."""
    stats, eng = serve_cli("ssm", "xlstm-125m", reduced, device)
    cfg = eng.model.cfg
    p_dev = eng.params
    p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
             for g, sub in p_dev.items()}
    worst, _, _ = logits_vs_cpu(cfg, p_dev, p_cpu, 8)
    stats["cpu_max_abs_err"] = worst
    print(f"[ssm] xlstm CUDA vs CPU logits (prefill + 8 decode steps, 2 "
          f"prompts): max abs err {worst:.3e} (rtol {SERVE_TOL[0]}, atol "
          f"{SERVE_TOL[1]})")
    return stats, p_dev


def layers_vs_cpu(tag, cfg, p_dev, prompts, steps):
    """The card's prefill and ``steps`` teacher-forced decode steps of each
    prompt, every layer's output kept, against the port's CPU run in
    layer-major order: each layer's weights are copied to the CPU once,
    and the CPU runs that layer for every prompt and step on its own
    previous layer's outputs, with its own CPU state; each MoE layer's
    routing is compared first, then the layer's output (``SERVE_TOL``, the
    absolute part times the activation's largest magnitude), then, after
    the final norm and the head, the logits (``SERVE_TOL``).  The host
    never holds more than one layer's weights.  Returns the stats."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model, map_cache
    device, s_max = _device_of(p_dev), 64
    dev_model, cpu = Model(cfg, device=device), Model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = {n: torch.from_numpy(rng.integers(0, cfg.vocab,
                                             size=(1, n + steps)))
            for n in prompts}
    kept = []
    blk, blk_dec = dev_model._block, dev_model._block_decode

    def keep_block(*a):
        x, c = blk(*a)
        kept.append(x.float().cpu())
        return x, c

    def keep_decode(*a):
        x = blk_dec(*a)
        kept.append(x.float().cpu())
        return x
    dev_model._block, dev_model._block_decode = keep_block, keep_decode
    card = {}
    t0 = time.perf_counter()
    with _recording_routing([]) as routes:
        for n in prompts:
            tt = toks[n].to(device)
            for s in range(steps + 1):
                kept.clear()
                routes.clear()
                if s == 0:
                    lg, cache, _ = dev_model.prefill(
                        p_dev, {"tokens": tt[:, :n]}, s_max)
                else:
                    lg, cache = dev_model.decode_step(
                        p_dev, cache, torch.tensor([n + s - 1],
                                                   device=device),
                        {"tokens": tt[:, n + s - 1:n + s]})
                card[n, s] = (list(kept), [(i.cpu(), k.cpu())
                                           for i, k in routes],
                              lg.float().cpu())
    card_s = time.perf_counter() - t0

    def to_cpu(d):
        return {k: v.cpu() for k, v in d.items()}
    small = {g: to_cpu(p_dev[g]) for g in ("embed", "final", "head")
             if g in p_dev}
    xs = {(n, s): cpu._embed(small, {"tokens": toks[n][:, :n] if s == 0
                                     else toks[n][:, n + s - 1:n + s]})
          for n in prompts for s in range(steps + 1)}
    caches = {n: cpu.init_cache(1, max(n, s_max)) for n in prompts}
    rtol, atol = SERVE_TOL
    worst_act, n_moe, pairs, copy_s, cpu_s = 0.0, 0, 0, 0.0, 0.0
    for layer, (j, i, pm, pf) in enumerate(dev_model._layers(p_dev)):
        t0 = time.perf_counter()
        pm, pf = to_cpu(pm), to_cpu(pf)
        copy_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        moe = cfg.ffn_pattern[i] == "moe"
        for n in prompts:
            kv_positions = torch.arange(max(n, s_max))
            for s in range(steps + 1):
                with _recording_routing([]) as r:
                    if s == 0:
                        x, c = cpu._block(i, pm, pf, xs[n, 0],
                                          torch.arange(n))
                        cpu._store(caches[n], j, i, c)
                    else:
                        x = cpu._block_decode(
                            i, pm, pf, xs[n, s],
                            map_cache(lambda a: a[j], caches[n][i]),
                            torch.tensor([n + s - 1]), kv_positions)
                xs[n, s] = x
                outs, routes, _ = card[n, s]
                if moe:
                    (gi, gk), (ci, ck) = routes[n_moe], r[0]
                    if not (torch.equal(gi, ci) and torch.equal(gk, ck)):
                        raise AssertionError(
                            f"[{tag}] routing differs from the CPU run at "
                            f"layer {layer} (period {j}, position {i}), "
                            f"prompt {n}, step {s}: experts {gi.tolist()} "
                            f"vs {ci.tolist()}")
                    pairs += ck.numel()
                g = outs[layer]
                err = (g - x).abs()
                scale = max(1.0, float(x.abs().max()))
                if not torch.isfinite(g).all() or bool(
                        (err > atol * scale + rtol * x.abs()).any()):
                    raise AssertionError(
                        f"[{tag}] layer {layer} (period {j}, position {i}, "
                        f"{cfg.pattern[i]}/{cfg.ffn_pattern[i]}) output "
                        f"differs from the CPU run for prompt {n} step {s}: "
                        f"max abs err {float(err.max()):.3e}, scale {scale}")
                worst_act = max(worst_act, float(err.max()) / scale)
        n_moe += moe
        cpu_s += time.perf_counter() - t0
        del pm, pf
    worst = 0.0
    for n in prompts:
        for s in range(steps + 1):
            x = xs[n, s][:, -1:] if s == 0 else xs[n, s]
            x = L.rms_norm(x, small["final"]["ln"], cfg.norm_eps)
            want = cpu._head(small, x)[:, 0].float()
            got = card[n, s][2]
            err = (got - want).abs()
            if not torch.isfinite(got).all() or bool(
                    (err > atol + rtol * want.abs()).any()):
                raise AssertionError(
                    f"[{tag}] CUDA vs CPU logits disagree for a {n}-token "
                    f"prompt at step {s}: max abs err {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
    stats = {"logits_max_abs_err": worst,
             "activation_max_err_over_scale": worst_act,
             "moe_layers": n_moe, "token_expert_pairs": pairs,
             "card_s": card_s, "copy_s": copy_s, "cpu_s": cpu_s}
    print(f"[{tag}] CUDA vs CPU layer by layer (prefill + {steps} "
          f"teacher-forced decode steps, prompts {prompts}): routing equal "
          f"in all {n_moe} MoE layers ({pairs} token-expert pairs), every "
          f"layer's output within rtol {rtol}, atol {atol} x scale (max err "
          f"/ scale {worst_act:.2e}), logits max abs err {worst:.3e}; card "
          f"{card_s:.1f} s, weight copies {copy_s:.1f} s, CPU {cpu_s:.1f} s")
    return stats


def phase_ssm_jamba(cfg, device="cuda"):
    """(b) jamba at its published widths cut to one period, drawn on the
    card from a seeded CUDA generator (the CPU draw of 13.3 G values would
    take minutes): served as phase 11's (a) (two runs, the counters
    zeroed around the first: the launches a prefill and a decode step from
    the configuration, every flash launch at (128, 128), no plain call),
    then held against the CPU layer by layer (``layers_vs_cpu``)."""
    t0 = time.perf_counter()
    p_dev = draw_on(device, cfg)
    draw_s = time.perf_counter() - t0
    n_params = sum(v.numel() for sub in p_dev.values() for v in sub.values())
    step_bytes = 4 * sum(v.numel() for g, sub in p_dev.items()
                         if g != "embed" for v in sub.values())
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[ssm] jamba-v0.1-52b at its published widths, {cfg.n_layers} of "
          f"32 layers: {n_params} f32 parameters ({4 * n_params / 1e9:.2f} "
          f"GB), drawn on the {device} in {draw_s:.1f} s; a decode step "
          f"reads {step_bytes / 1e9:.2f} GB of weights (bound "
          f"{step_bound_ms:.2f} ms at 3.35 TB/s)")
    launched = []
    with _recording_flash_pairs(launched, heads=True):
        stats = serve_runs("ssm", "jamba-v0.1-52b", 32, cfg, p_dev,
                           stack_launches(cfg, 1))
    want = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
    if len(launched) != SERVE_RUNS * stats["prefills"] * stats[
            "launches_per_prefill"]["flash_attention"] or \
            set(launched) != {want}:
        raise AssertionError(f"[ssm] jamba's {len(launched)} flash launches "
                             f"in {SERVE_RUNS} runs were at (H, KVH, dk, "
                             f"dv) {sorted(set(launched))}, not all at "
                             f"{want}")
    print(f"[ssm] jamba's {len(launched)} flash launches in {SERVE_RUNS} "
          f"runs were all at (H, KVH, dk, dv) {want}")
    prompts, steps = SSM_COMPARE
    stats.update({"params": n_params, "draw_s": draw_s,
                  "flash_launches_all_runs": len(launched),
                  "flash_shape": want,
                  "decode_step_weight_bytes": step_bytes,
                  "decode_step_bound_ms": step_bound_ms,
                  "cpu": layers_vs_cpu("ssm", cfg, p_dev, prompts, steps)})
    return stats, p_dev


def phase_ssm():
    """(e) the kernels at xlstm-125m's and jamba's shapes; (a) xlstm-125m
    served at full width and held against the CPU; (b) jamba at its
    published widths (8 of 32 layers) served and held against the CPU
    layer by layer; (c) three decode steps of each under the profiler, the
    scans' plain ops, the causal conv and (jamba) the experts split
    out."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, ssm
    xcfg = get_config("xlstm-125m")
    jcfg = replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS)
    gen = torch.Generator().manual_seed(9)
    rows, worst = [], {}
    check_cases(ssm_kernel_cases(xcfg, jcfg), gen, rows, worst)
    print(f"[ssm] {len(rows)} kernel cases at xlstm-125m's and jamba's "
          f"shapes agree; max abs err per kernel: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    torch.cuda.empty_cache()
    xlstm, p_x = phase_ssm_xlstm()
    n_slstm = xcfg.pattern.count("slstm") * xcfg.n_periods
    xlstm["profile"] = profile_decode("ssm", xcfg, p_x, 3, [
        (ssm, "chunked_scan", "sLSTM recurrent products (r)",
         "scans' plain ops", xcfg.n_heads * n_slstm),
        (ssm, "causal_conv", "conv products (none)", "causal conv plain ops",
         0)])
    del p_x
    torch.cuda.empty_cache()
    jamba, p_j = phase_ssm_jamba(jcfg)
    n_moe = jcfg.ffn_pattern.count("moe") * jcfg.n_periods
    jamba["profile"] = profile_decode("ssm", jcfg, p_j, 3, [
        (ssm, "chunked_scan", "scan products (none)", "scans' plain ops", 0),
        (ssm, "causal_conv", "conv products (none)", "causal conv plain ops",
         0),
        (moe, "_expert_ffn", "expert products",
         "experts' plain ops (silu, mul, stack)",
         3 * jcfg.moe.n_experts * n_moe),
        (moe, "moe_ffn", "router products", "dispatch's plain ops", None)])
    del p_j
    torch.cuda.empty_cache()
    return {"kernels": rows, "xlstm": xlstm, "jamba": jamba}


# -- phase 14: the SSM families' study (xlstm-125m, jamba) ---------------------

SSM_KNOBS = tuple((ssm, remat) for ssm in (8, 32) for remat in ("none", "full"))
SSM_STUDY_PERIODS = 3      # of xlstm-125m's 6 (mLSTM, sLSTM) periods
# the kernels an SSM mixer's gradient launches (no attention)
SSM_FB_PATH = ("matmul", "rmsnorm", "rmsnorm_bwd")


def ssm_fb_bound(cfg, kind, ssm, remat, B, S):
    """(bound ms, by) of one layer's ``{kind}_fb`` at f32: the mixer's
    weights read and their gradients written once, x read and the output
    written; the operations of its products (each weight 2 T flops
    forward; sLSTM's recurrent r counts as a weight of nh x dh x 4 dh) and
    of its scan (Mamba ~6 di N a token; mLSTM's chunkwise contractions at
    the intra-chunk length L; the causal conv 2 d_conv di a token), the
    backward twice the forward, remat full one forward more, and where a
    chunk is shorter than S (Mamba's and sLSTM's scans) the scan's forward
    once more."""
    D, di, nh, T, K = cfg.d_model, cfg.d_inner, cfg.n_heads, B * S, \
        cfg.d_conv
    conv = 2 * K * di * T
    if kind == "mamba":
        N, dtr = cfg.d_state, di // 16
        mats = D * 2 * di + di * (dtr + 2 * N) + dtr * di + di * D
        other = K * di + 2 * di + di * N + D
        scan = 6 * di * N * T
        fwd = 2 * T * mats + scan + conv
    elif kind == "mlstm":
        dh = di // nh
        mats = D * 2 * di + 3 * di * di + di * 2 * nh + di * D
        other = K * di + 2 * nh + D
        L = min(ssm, S)
        while S % L:
            L -= 1
        scan = 0                        # no chunk remat: nothing redone
        fwd = 2 * T * mats + conv + (S // L) * (
            6 * B * nh * L * L * dh + 4 * B * L * nh * dh * dh)
    else:
        dh = D // nh
        mats = D * 4 * D + D * 2 * di + di * D
        other = 5 * D + nh * dh * 4 * dh
        scan = 2 * T * nh * dh * 4 * dh     # the recurrent products
        fwd = 2 * T * mats + scan
    flops = 3 * fwd + (fwd if remat == "full" else 0) + \
        (scan if S > ssm else 0)
    return bound(4 * (2 * (mats + other) + 2 * T * D), flops, "float32")


def ssm_thunks(tag, cfg, layers, reps: int = 5):
    """One full-width layer's ``{kind}_fb`` gradients for each (kind, card
    params, CPU params) of ``layers`` at mb 2 x S 32, ``ssm_chunk`` 8 and
    32, remat none and full: one card call with the counters zeroed (the
    matmul, RMSNorm and RMSNorm-backward kernels launched, no other, no
    plain call; at ssm 8 the backward recomputes each chunk, which shows
    in sLSTM's matmul launches), against the port's CPU run
    (``STUDY_TOL``); then the card's closure timed warm, the least of
    ``reps`` calls on the host clock, beside its bound."""
    from repro_torch.tune.lm_study import MIXER_LOSSES, StepKnobs, \
        grad_closure
    B, S = STUDY["batch"], STUDY["seq"]
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(14))
    xs = (x.to(_device_of(layers[0][1])), x)
    rows = []
    for kind, p_gpu, p_cpu in layers:
        for ssm, remat in SSM_KNOBS:
            knobs = StepKnobs("k", remat=remat, ssm_chunk=ssm)
            fns = [grad_closure(MIXER_LOSSES[kind](cfg, knobs, None), remat,
                                xx.device) for xx in xs]
            _zero_counts()
            card = fns[0](p_gpu, xs[0])
            launches = {k: n for k, n in ops.launches.items() if n}
            if any(ops.plain_calls.values()) or \
                    set(launches) != set(SSM_FB_PATH):
                raise AssertionError(
                    f"[{tag}] {cfg.name} {kind}_fb ssm{ssm} remat {remat} on "
                    f"the card: launches {launches}, plain calls "
                    f"{ops.plain_calls}")
            what = f"[{tag}] {cfg.name} {kind}_fb ssm{ssm} remat {remat}"
            worst = grads_vs_cpu(what, card, fns[1](p_cpu, xs[1]))
            del card
            runs = warm_ms(lambda: fns[0](p_gpu, xs[0]), reps)
            b_ms, b_by = ssm_fb_bound(cfg, kind, ssm, remat, B, S)
            rows.append({"arch": cfg.name, "kind": kind, "ssm_chunk": ssm,
                         "remat": remat, "launches": launches,
                         "max_err_over_scale": worst, "ms": min(runs),
                         "ms_runs": runs, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"{what} at mb {B} x S {S}: card vs CPU within rtol "
                  f"{STUDY_TOL[0]}, atol {STUDY_TOL[1]} x scale (max err / "
                  f"scale {worst:.2e}); launches a call {launches}; card "
                  f"{min(runs):.3f} ms a call (host clock with its sync, "
                  f"warm, least of {reps}: {[round(m, 3) for m in runs]}); "
                  f"bound {b_ms:.5f} ms ({b_by})")
    return rows


def _mix(params, pos):
    """Position ``pos``'s mixer weights at period 0 (views)."""
    return {k[4:]: v[0] for k, v in params[f"pos{pos}"].items()
            if k.startswith("mix_")}


def phase_ssm_study(reduced=False, device="cuda"):
    """(a) xlstm-125m's full-width ``mlstm_fb`` (layer 0) and
    ``slstm_fb`` (layer 1) and (b) one full-width jamba Mamba layer's
    ``mamba_fb`` (``ssm_thunks``); (c) ``LMStudy("xlstm-125m",
    reduced=False)``, its depth cut to ``SSM_STUDY_PERIODS`` periods, as a
    24-point conditional session on the card, one selective run a point; (d)
    the reduced jamba study's 48 points as a protocol check, its depth
    cut to one period (8 of its 16 layers)."""
    from repro_torch.configs import get_config
    from repro_torch.tune.lm_study import LMStudy, lm_config_space
    study = LMStudy("xlstm-125m", reduced=reduced, device=device, **STUDY)
    _random_norms(study, 11)
    xcfg = study.cfg
    layers = [(k, _mix(study.params, i)) for i, k in enumerate(xcfg.pattern)]
    rows = ssm_thunks("ssm-study", xcfg, [
        (k, p, {n: t.cpu() for n, t in p.items()}) for k, p in layers])
    # one Mamba layer of jamba at its published widths, drawn on the card
    # alone (with its one-layer model's embedding and head, then dropped)
    jcfg = replace(get_config("jamba-v0.1-52b", reduced=reduced),
                   pattern=("mamba",), ffn_pattern=("none",), n_layers=1)
    p = _mix(draw_on(device, jcfg, seed=3), 0)
    p["ln"] = (torch.randn(p["ln"].shape, generator=torch.Generator()
                           .manual_seed(15)) * 0.1).to(device)
    n_mamba = sum(t.numel() for t in p.values())
    print(f"[ssm-study] jamba's Mamba layer at its published widths "
          f"(d_model {jcfg.d_model}, d_inner {jcfg.d_inner}, d_state "
          f"{jcfg.d_state}): {n_mamba} f32 parameters drawn on the "
          f"{device}")
    torch.cuda.empty_cache()
    rows += ssm_thunks("ssm-study", jcfg, [
        ("mamba", p, {n: t.cpu() for n, t in p.items()})])
    del p
    torch.cuda.empty_cache()
    # (c) the full-width xlstm-125m study, its depth cut to
    # SSM_STUDY_PERIODS of its 6 periods and one selective run a point
    # after its reference (the script's time)
    depth = study.cfg.n_layers
    cut_periods(study, min(SSM_STUDY_PERIODS, depth // study.cfg.period))
    res, launches, wall = study_session("ssm-study", study, trials=1)
    knobs = {k.name: k for k in lm_config_space(xcfg)}
    for r in res.records:
        print(f"[ssm-study] {r.name:26s} predicted {1e3 * r.predicted:9.3f} "
              f"ms full reference {1e3 * r.full_time:9.3f} ms (rel err "
              f"{r.rel_error:+.3f}) executed {r.executed:5d} skipped "
              f"{r.skipped:5d}")
    chunk = {w: knobs[getattr(res, w).name].ssm_chunk
             for w in ("chosen", "true_best")}
    print(f"[ssm-study] study (full-width xlstm-125m, "
          f"{study.cfg.n_layers} of {depth} layers, {len(res.records)} "
          f"points, conditional 0.25, trials 1): chosen {res.chosen.name} "
          f"(ssm_chunk {chunk['chosen']}) true best {res.true_best.name} "
          f"(ssm_chunk {chunk['true_best']}); optimum quality "
          f"{res.optimum_quality:.4f}; speedup {res.speedup:.3f}x (full "
          f"{res.full_tuning_time:.3f} s, selective "
          f"{res.selective_tuning_time:.3f} s); wall {wall:.1f} s")
    session = {"records": [r.to_json() for r in res.records],
               "chosen": res.chosen.name, "true_best": res.true_best.name,
               "chosen_ssm_chunk": chunk["chosen"],
               "true_best_ssm_chunk": chunk["true_best"],
               "speedup": res.speedup, "optimum_quality": res.optimum_quality,
               "full_tuning_time_s": res.full_tuning_time,
               "selective_tuning_time_s": res.selective_tuning_time,
               "wall_s": wall, "launches": launches}
    del study
    torch.cuda.empty_cache()
    # reduced jamba cut to one period (8 of its 16 layers): the same 48
    # points and signatures, half the thunks a step; one selective run a
    # point after its reference (the script's time: [sharded] (g), (h)
    # and [jaxdist] took the room)
    jamba = phase_family_study("ssm-study", "jamba-v0.1-52b",
                               ("mamba_fb", "attn_fb"), periods=1, trials=1)
    return {"thunks": rows, "session": session, "jamba_study": jamba}


# -- phase 15: the frontends (musicgen-large, internvl2-2b at full width) ------

FRONTEND_PATH = ("matmul", "rmsnorm", "rmsnorm_bwd")   # embed_loss_fb's


def embed_fb_bound(cfg, T):
    """(bound ms, by) of ``embed_loss_fb`` over T positions at f32: the
    embedding, final norm and head read and their gradients written once
    (the embedding's gradient in full), the positions' activations read
    and written; the head's products (2 T D V a codebook forward, twice
    that backward)."""
    D, V, ncb = cfg.d_model, cfg.vocab, max(cfg.n_codebooks, 1)
    params = 2 * ncb * V * D + D
    return bound(4 * (2 * params + 2 * T * D), 6 * T * D * V * ncb,
                 "float32")


def embed_fb_vs_cpu(tag, cfg, p_gpu, p_cpu, reps: int = 5):
    """The study's ``embed_loss_fb`` at full width (mb 2 x S 32 tokens,
    ``(2, 32, ncb)`` with codebooks, N(0, 1) patches in front with a
    patch prefix; the final norm's weight drawn): one card call with the
    counters zeroed (matmul, RMSNorm and its backward, no plain call)
    against the port's CPU run, then timed warm beside its bound."""
    from repro_torch.models.model import Model
    from repro_torch.tune.lm_study import embed_loss, grad_closure
    B, S = STUDY["batch"], STUDY["seq"]
    gen = torch.Generator().manual_seed(16)
    trail = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    data = {"tokens": torch.randint(0, cfg.vocab, (B, S) + trail,
                                    generator=gen)}
    if cfg.n_patches:
        data["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                      generator=gen)
    ln = torch.randn((cfg.d_model,), generator=gen) * 0.1
    fns, subs = [], []
    for dev, p in ((_device_of(p_gpu), p_gpu), ("cpu", p_cpu)):
        model = Model(cfg, device=dev)
        d = {k: v.to(dev) for k, v in data.items()}
        fns.append(grad_closure(embed_loss(model, d), "none", model.device))
        subs.append({"embed": p["embed"], "head": p["head"],
                     "final": {"ln": ln.to(dev)}})
    _zero_counts()
    card = fns[0](subs[0])
    launches = {k: n for k, n in ops.launches.items() if n}
    if any(ops.plain_calls.values()) or set(launches) != set(FRONTEND_PATH):
        raise AssertionError(f"[{tag}] {cfg.name} embed_loss_fb on the card: "
                             f"launches {launches}, plain calls "
                             f"{ops.plain_calls}")
    what = f"[{tag}] full-width {cfg.name} embed_loss_fb"
    worst = grads_vs_cpu(what, card, fns[1](subs[1]))
    del card
    runs = warm_ms(lambda: fns[0](subs[0]), reps)
    T = B * (S + cfg.n_patches)
    b_ms, b_by = embed_fb_bound(cfg, T)
    prefix = f" after {cfg.n_patches} patches" if cfg.n_patches else ""
    print(f"{what} at mb {B} x S {S}{prefix} ({T} positions): card vs CPU "
          f"within rtol {STUDY_TOL[0]}, atol "
          f"{STUDY_TOL[1]} x scale (max err / scale {worst:.2e}); launches "
          f"a call {launches}; card {min(runs):.3f} ms a call (host clock "
          f"with its sync, warm, least of {reps}: "
          f"{[round(m, 3) for m in runs]}); bound {b_ms:.5f} ms ({b_by})")
    return {"positions": T, "launches": launches,
            "max_err_over_scale": worst, "ms": min(runs), "ms_runs": runs,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_frontends(reduced=False, device="cuda"):
    """(a) musicgen-large (all 48 layers, 13 GB f32) served through
    ``launch/serve.py`` with 4-codebook prompts (``serve_cli``: 4 head
    launches a step), then held against the CPU; (b) internvl2-2b (all 24
    layers) served with text prompts, then a prefill of 1024 N(0, 1)
    patches and a 16-token prompt through ``Model.prefill`` (every flash
    launch at 16/8 heads of 128 over 1040 positions) and 2 decode steps
    at P + t, held against the CPU; (c) each family's full-width
    ``embed_loss_fb``; (d) both reduced studies (12 points each) as
    protocol checks."""
    out = {}
    for arch in ("musicgen-large", "internvl2-2b"):
        stats, eng = serve_cli("frontends", arch, reduced, device)
        cfg, p_gpu = eng.model.cfg, eng.params
        del eng
        p_cpu = {g: {k: v.cpu() for k, v in sub.items()}
                 for g, sub in p_gpu.items()}
        t0 = time.perf_counter()
        worst, _, _ = logits_vs_cpu(cfg, p_gpu, p_cpu, 4)
        stats["cpu_max_abs_err"] = worst
        per_dec = stats["launches_per_decode_step"]
        print(f"[frontends] {arch} CUDA vs CPU logits (prefill + 4 decode "
              f"steps, prompts (13, 29)): max abs err {worst:.3e} (rtol "
              f"{SERVE_TOL[0]}, atol {SERVE_TOL[1]}); "
              f"{time.perf_counter() - t0:.1f} s; a decode step launches "
              f"{per_dec}, "
              f"{max(cfg.n_codebooks, 1)} of its matmuls the head's")
        if cfg.n_patches:
            patches = torch.randn((1, cfg.n_patches, cfg.d_model),
                                  generator=torch.Generator().manual_seed(17))
            flash, timings = [], {}
            t0 = time.perf_counter()
            with _recording_flash_pairs(flash, heads=True):
                worst, _, _ = logits_vs_cpu(cfg, p_gpu, p_cpu, 2, (16,),
                                            patches, timings)
            want = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim)
            if len(flash) != cfg.n_layers or set(flash) != {want}:
                raise AssertionError(f"[frontends] the patch prefill's flash "
                                     f"launches {flash}, not {cfg.n_layers} "
                                     f"at {want}")
            stats["patch_prefill"] = {
                "positions": cfg.n_patches + 16, "cpu_max_abs_err": worst,
                "card_prefill_ms": 1e3 * timings["prefill_s"][0],
                "card_decode_ms": [1e3 * t for t in timings["decode_s"]],
                "flash_launches": len(flash)}
            print(f"[frontends] {arch} prefill of {cfg.n_patches} patches + "
                  f"16 tokens ({cfg.n_patches + 16} positions; {len(flash)} "
                  f"flash launches at (H, KVH, dk, dv) {want}) and 2 decode "
                  f"steps at P + t, CUDA vs CPU: max abs err {worst:.3e}; "
                  f"card prefill {1e3 * timings['prefill_s'][0]:.2f} ms, "
                  f"decode {[round(1e3 * t, 2) for t in timings['decode_s']]}"
                  f" ms (host clock); {time.perf_counter() - t0:.1f} s")
        stats["embed_loss_fb"] = embed_fb_vs_cpu("frontends", cfg, p_gpu,
                                                 p_cpu)
        del p_gpu, p_cpu
        torch.cuda.empty_cache()
        stats["study"] = phase_family_study("frontends", arch, ("attn_fb",))
        out[arch] = stats
    return out


# -- phase 16: training ---------------------------------------------------

# the training launcher's command (launch/train.py): smollm-135m at its
# published widths, 8 steps of 8 x 128 tokens in 2 microbatches of 4 x 128,
# a checkpoint every 4 steps; its ``--ckpt-dir`` and ``--device`` added
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", "8", "--batch", "8",
              "--seq", "128", "--grad-accum", "2", "--ckpt-every", "4",
              "--log-every", "1"]
TRAIN_REMATS = ("none", "full", "dots")


def train_launches(cfg, microbatches: int):
    """Kernel launches of ``microbatches`` loss-and-gradient passes of a
    dense attention stack under remat full (the launcher's default): per
    layer 7 projections (q, k, v, o, gate, up, down), each a launch forward,
    two backward (dA, dB) and one more in the period's recompute; the tied
    head's three; the two norms a layer forward and again in the
    recompute, the final norm once, and each norm's backward; attention
    forward twice (the recompute) and its backward once."""
    L = cfg.n_layers
    per = {"matmul": 3 * (7 * L + 1) + 7 * L,
           "rmsnorm": (2 * L + 1) + 2 * L, "rmsnorm_bwd": 2 * L + 1,
           "flash_attention": 2 * L, "flash_attention_bwd": L}
    return {k: microbatches * n for k, n in per.items()}


def train_bound(cfg, params, tokens: int, mb: int, seq: int):
    """(bound ms, by, flops, bytes) of one training step of ``tokens``
    tokens in microbatches of ``mb`` x ``seq`` under remat full, f32.
    Operations: each layer's projections 2 x tokens x weights forward, 4
    backward and 2 in the recompute; the tied head's 6; causal attention's
    two products over the causal pairs forward, again in the recompute,
    and 2.5x that backward (four products and the scores' recompute).
    Bytes: the parameters and both moments read and written once, the
    batch read once."""
    proj = sum(v.numel() // cfg.n_layers for g, sub in params.items()
               if g.startswith("pos") for k, v in sub.items()
               if v.dim() == 3)
    head = cfg.vocab * cfg.d_model
    attn = 4 * (tokens // seq) * cfg.n_heads * causal_pairs(seq, seq) \
        * cfg.head_dim                              # both products, forward
    flops = (8 * proj * cfg.n_layers + 6 * head) * tokens \
        + cfg.n_layers * attn * (2 + 2.5)
    n = sum(v.numel() for sub in params.values() for v in sub.values())
    nbytes = 6 * 4 * n + 2 * 4 * tokens
    ms, by = bound(nbytes, flops, "float32")
    return ms, by, flops, nbytes


def _layers_a_view_at_a_time(self, params, n_periods=None):
    """``Model._layers`` as the model took its per-layer views before it
    unbound each stack once: a view of each stack a layer at a time, whose
    backward fills a zero tensor the size of the whole stack for each
    layer (kept here to measure that against the unbound views)."""
    for j in range(n_periods or self.cfg.n_periods):
        for i in range(self.cfg.period):
            stack = params[f"pos{i}"]
            yield (j, i,
                   {k[4:]: v[j] for k, v in stack.items()
                    if k.startswith("mix_")},
                   {k[4:]: v[j] for k, v in stack.items()
                    if k.startswith("ffn_")})


def train_memory(model, params, mb, reps: int = 3):
    """Peak device memory above the resident tensors, and the least host
    ms, of one microbatch's loss and gradient under each remat, with the
    per-layer views unbound once (the model's) and taken a view at a
    time."""
    from repro_torch.models.model import Model
    from repro_torch.train.step import loss_and_grads
    out = {}
    for views in ("unbound", "a view at a time"):
        for remat in TRAIN_REMATS:
            m = Model(model.cfg, replace(model.knobs, remat=remat),
                      device=model.device)
            if views != "unbound":
                m._layers = _layers_a_view_at_a_time.__get__(m)
            peaks, times = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                loss_and_grads(m, params, mb)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
                peaks.append(torch.cuda.max_memory_allocated() - base)
            out[f"{views}, remat {remat}"] = {
                "peak_bytes": max(peaks), "host_ms": min(times)}
            print(f"[train] one microbatch's loss and gradient "
                  f"({views}, remat {remat}): peak {max(peaks) / 2**20:.1f} "
                  f"MiB above the resident tensors, {min(times):.2f} ms "
                  f"(host clock with its sync, least of {reps})")
    return out


def trees_equal(a, b) -> bool:
    """The same paths, and at each the same dtype and bits."""
    from repro_torch.train.checkpoint import _flatten    # sorted paths
    fa, fb = _flatten(a), _flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def phase_train(reduced=False, device="cuda"):
    """(a) smollm-135m at its published widths trained through
    ``launch/train.py`` (8 steps of 8 x 128 tokens, grad_accum 2, a
    checkpoint every 4 steps; seeded random f32 weights, the synthetic
    stream), the launch counters zeroed just before and read just after:
    every kernel, forward and backward, at the count ``train_launches``
    gives, no plain call; each step's host ms and loss; (b) the same
    command after the step-8 checkpoint is deleted: it resumes from step 4
    and its losses for steps 5-8, its parameters and its AdamW state equal
    the straight run's bit for bit; (c) one microbatch's loss and
    gradients (4 x 128, the launcher's weights and first batch) on the card
    against the port's CPU run; (d) one step under the profiler beside
    its bound; (e) the peak memory of a microbatch's loss and gradient
    under each remat, with the per-layer views unbound once and taken a
    layer at a time."""
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import Model
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.step import loss_and_grads
    argv = TRAIN_ARGV + ["--device", device] + (["--reduced"] if reduced
                                                else [])
    args = train_cli.parse(argv)
    cfg, shape, model, step_fn = train_cli.build(args)
    steps, n_mb = args.steps, args.grad_accum
    out = {"argv": argv}
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck")
        _zero_counts()
        t0 = time.perf_counter()
        straight = train_cli.main(argv + ["--ckpt-dir", ck])
        wall = time.perf_counter() - t0
        launches, plain = dict(ops.launches), dict(ops.plain_calls)
        want = train_launches(cfg, n_mb * steps)
        print(f"[train] {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, f32) through launch/train.py "
              f"{' '.join(argv)}: {steps} steps in {wall:.1f} s; launches "
              f"{launches} (expected {want}); plain calls {plain}")
        if any(plain.values()):
            raise AssertionError(f"training called plain versions: {plain}")
        if launches != want:
            raise AssertionError(f"training launched {launches}, not {want}")
        for h in straight["history"]:
            if not math.isfinite(h["loss"]):
                raise AssertionError(f"[train] step {h['step']}: loss "
                                     f"{h['loss']}")
            print(f"[train] step {h['step']}: loss {h['loss']!r} grad norm "
                  f"{h['grad_norm']:.4f} lr {h['lr']:.3e}; "
                  f"{h['host_ms']:.2f} ms (host clock, batch to loss)")
        resume_at = steps - args.ckpt_every     # the checkpoint left
        shutil.rmtree(Path(ck) / f"step_{steps:010d}")
        t0 = time.perf_counter()
        resumed = train_cli.main(argv + ["--ckpt-dir", ck])
        resume_wall = time.perf_counter() - t0
        tail = [h["loss"] for h in straight["history"][resume_at:]]
        got = [h["loss"] for h in resumed["history"]]
        same = (resumed["start"] == resume_at and got == tail
                and trees_equal(resumed["params"], straight["params"])
                and trees_equal(resumed["opt"], straight["opt"]))
        print(f"[train] resumed from step {resumed['start']} after the step-"
              f"{steps} checkpoint was deleted: losses of steps "
              f"{resume_at + 1}-"
              f"{steps} {got} against {tail}; parameters and AdamW state "
              f"{'equal' if same else 'NOT equal'} bit for bit; "
              f"{resume_wall:.1f} s")
        if not same:
            raise AssertionError("[train] the resumed run differs from the "
                                 "straight run")
    out.update(launches=launches, launches_per_step={
        k: n // steps for k, n in launches.items()}, wall_s=wall,
        resume_wall_s=resume_wall, history=straight["history"],
        resumed_history=resumed["history"])
    del straight, resumed

    # (c) one microbatch, card against CPU, on the launcher's step-0 weights
    params = model.init(torch.Generator().manual_seed(args.seed))
    host = synthetic_batch(cfg, shape, 0, DataConfig(seed=args.seed))
    mb = {k: torch.from_numpy(v[:args.batch // n_mb]) for k, v in
          host.items()}
    cpu = Model(cfg, model.knobs, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(args.seed))
    t0 = time.perf_counter()
    loss_c, g_c = loss_and_grads(cpu, p_cpu, mb)
    cpu_s = time.perf_counter() - t0
    mb_dev = {k: v.to(model.device) for k, v in mb.items()}
    loss_d, g_d = loss_and_grads(model, params, mb_dev)
    rtol, atol = STUDY_TOL
    loss_err = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    # the stated tolerance: atol x each tensor's own largest magnitude
    worst = grads_vs_cpu("[train]", g_d, g_c, floor=1e-30)
    print(f"[train] one microbatch ({args.batch // n_mb} x {args.seq}) on "
          f"the card vs the port's CPU run ({cpu_s:.1f} s): loss "
          f"{float(loss_d)!r} vs {float(loss_c)!r} (rel err "
          f"{loss_err:.2e}, rtol {rtol}); every gradient within rtol "
          f"{rtol} and atol {atol} x its largest magnitude (max err / scale "
          f"{worst:.2e})")
    if loss_err > rtol:
        raise AssertionError(f"[train] loss {float(loss_d)} vs CPU "
                             f"{float(loss_c)}")
    out["cpu"] = {"loss": float(loss_d), "cpu_loss": float(loss_c),
                  "loss_rel_err": loss_err, "grad_err_over_scale": worst}
    del cpu, p_cpu, g_c, g_d

    # (d) one step under the profiler, after one warm step
    tokens = args.batch * args.seq
    bound_ms, by, flops, nbytes = train_bound(cfg, params, tokens,
                                              args.batch // n_mb, args.seq)
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v).to(model.device)
             for k, v in host.items()}
    params, opt, _ = step_fn(params, opt, batch)
    out["bound"] = {"ms": bound_ms, "by": by, "flops": flops,
                    "bytes": nbytes}
    if device == "cuda":
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            float(m["loss"])
            prof_ms = 1e3 * (time.perf_counter() - t0)
        out["profile"] = device_summary(
            "train", f"one step ({tokens} tokens, 2 microbatches) under the "
            f"profiler {prof_ms:.2f} ms", prof)
        out["profile"]["step_ms_profiled"] = prof_ms
        print(f"[train] the step's bound {bound_ms:.3f} ms ({by}: "
              f"{flops / 1e12:.4f} TFLOP at 67 TFLOP/s, the H100 SXM's f32 "
              f"peak outside the tensor cores; {nbytes / 1e9:.3f} GB at "
              f"3.35 TB/s)")
        # (e) peak memory by remat and by how the views are taken
        out["memory"] = train_memory(model, params, {
            k: v.to(model.device) for k, v in mb.items()})
    return out


# -- phase 17: sharded training ----------------------------------------------

# the sharded phase's command: [train]'s widths and batch (8 x 128 tokens in
# 2 microbatches, remat full), 2 steps, no checkpoint
SHARDED_ARGV = ["--arch", "smollm-135m", "--steps", "2", "--batch", "8",
                "--seq", "128", "--grad-accum", "2", "--log-every", "1"]
# the variants held on the reduced model (cp at full width)
SHARDED_VARIANTS = ("dp", "tp", "cp_fsdp")
# the loss's tolerance across several cards: the CPU tests' (the sharded
# step against the JAX one, tests/test_torch_sharded.py)
SHARDED_LOSS_RTOL = 1e-5
# one rank of the several-card run: the launcher under torchrun's
# environment; rank 0 writes the loss history
_SHARDED_RANK = r"""
import json, os, sys
from repro_torch.launch import train as train_cli
run = train_cli.main(json.loads(sys.argv[1]))
if os.environ["RANK"] == "0":
    with open(sys.argv[2], "w") as f:
        json.dump(run["history"], f)
"""


def _launched(argv):
    """(the launcher's result, its launches, its plain calls, wall s), the
    counters zeroed just before."""
    from repro_torch.launch import train as train_cli
    _zero_counts()
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    return run, dict(ops.launches), dict(ops.plain_calls), \
        time.perf_counter() - t0


def _same_run(tag, got, want, launches, want_launches, plain, device):
    """Fail unless the sharded run's losses, parameters and AdamW state
    equal the one-device run's bit for bit and it launched what that run
    did, with no plain call on the card."""
    same = ([h["loss"] for h in got["history"]]
            == [h["loss"] for h in want["history"]]
            and trees_equal(got["params"], want["params"])
            and trees_equal(got["opt"], want["opt"]))
    print(f"[sharded] {tag}: losses {[h['loss'] for h in got['history']]} "
          f"against {[h['loss'] for h in want['history']]}; parameters and "
          f"AdamW state {'equal' if same else 'NOT equal'} bit for bit; "
          f"launches {launches} (one device: {want_launches}); plain calls "
          f"{plain}")
    if not same:
        raise AssertionError(f"[sharded] {tag} differs from one device")
    if launches != want_launches:
        raise AssertionError(f"[sharded] {tag} launched {launches}, one "
                             f"device {want_launches}")
    if any(plain.values()) and device == "cuda":
        raise AssertionError(f"[sharded] {tag} called plain versions: "
                             f"{plain}")


def several_cards(argv, want, cards: int, device="cuda"):
    """The full-width cp run on a (1, n) mesh over n = min(cards, 4)
    ranks, one card each (processes under torchrun's environment), its
    losses against the one-rank run's within SHARDED_LOSS_RTOL."""
    n = min(cards, 4)
    argv = argv + ["--model-axis", str(n), "--variant", "cp"]
    got = [h["loss"] for h in _run_ranks(_SHARDED_RANK, argv, n, "cp run")]
    ref_ = [h["loss"] for h in want["history"]]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref_))
    print(f"[sharded] (1, {n}) cp mesh over {n} {device} ranks: losses {got} "
          f"against one rank's {ref_} (max rel err {worst:.2e}, rtol "
          f"{SHARDED_LOSS_RTOL})")
    if worst > SHARDED_LOSS_RTOL:
        raise AssertionError(f"[sharded] the {n}-rank run's losses {got} "
                             f"against {ref_}")
    return {"ranks": n, "losses": got, "max_rel_err": worst}


# (d): one microbatch of full-width phi3.5-moe (the [moe] phase's weights)
# through the sharded loss_and_grads under each expert-parallel regime
SHARDED_MOE = dict(batch=2, seq=64)
SHARDED_REGIMES = ("cp", "tp", "dp")
# the sharded MoE's tolerance against one device: x scale for a gradient
SHARDED_MOE_TOL = 1e-5
# (e): the reduced MoE and MLA configurations through the launcher
SHARDED_EP_ARCHS = ("phi3.5-moe", "deepseek-v2")


def _no_drop(cfg):
    """``cfg`` at capacity factor E / top_k: every expert holds every token
    of a shard, so neither dispatch drops a pair."""
    m = cfg.moe
    return replace(cfg, moe=replace(m, capacity_factor=m.n_experts
                                    / m.top_k))


def _timed_grads(fn):
    """(loss, gradients, host ms, launches, plain calls) of ``fn()`` after
    one warm call, the counters zeroed just before the timed one."""
    fn()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    loss, g = fn()
    torch.cuda.synchronize()
    return (loss, g, 1e3 * (time.perf_counter() - t0), dict(ops.launches),
            dict(ops.plain_calls))


def sharded_moe(cfg, params):
    """[sharded] (d): full-width phi3.5-moe (``params``: the [moe] phase's
    weights on the card) at capacity factor E / top_k, one microbatch of
    SHARDED_MOE's tokens through ``loss_and_grads`` on one device, then
    under cp (all_to_all), tp (local experts, summed) and dp (experts
    local) on a (1, 1) mesh of a world-1 process group: the loss and every
    gradient within SHARDED_MOE_TOL x scale of one device's, the same
    launches, no plain call on the card; the host ms of each (warm)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import axis_rules, gather, make_rules
    from repro_torch.train.data import batch_axes, make_global_batch
    from repro_torch.train.step import (batch_shardings, loss_and_grads,
                                        shard_params)
    from repro_torch.tune.lm_study import _flatten
    cfg = _no_drop(cfg)
    device = _device_of(params)
    model = Model(cfg, device=device)
    gen = torch.Generator().manual_seed(17)
    shape = (SHARDED_MOE["batch"], SHARDED_MOE["seq"])
    mb = {k: torch.randint(cfg.vocab, shape, generator=gen,
                           dtype=torch.int32) for k in ("tokens", "labels")}
    loss1, g1, ms1, l1, _ = _timed_grads(lambda: loss_and_grads(
        model, params, {k: v.to(device) for k, v in mb.items()}))
    one = _flatten(g1)
    specs = {k: (tuple(t.shape), batch_axes(cfg)[k]) for k, t in mb.items()}
    tag = (f"[sharded] (d) phi3.5-moe ({cfg.n_layers} of 32 layers, "
           f"d_model {cfg.d_model}, capacity factor "
           f"{cfg.moe.capacity_factor:g}), {shape[0]} x {shape[1]} tokens")
    print(f"{tag}: one device: loss {float(loss1):.7f}, {ms1:.2f} host ms "
          f"(warm), matmul launches a microbatch {l1['matmul']}")
    out = {"one_device": {"loss": float(loss1), "host_ms": ms1,
                          "launches": l1}}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, device_type=device.type)
        for v in SHARDED_REGIMES:
            rules = make_rules(v).with_mesh(mesh)
            sp = shard_params(model, params, rules)

            def run():
                b = make_global_batch(mb, batch_shardings(rules, specs))
                with axis_rules(rules):
                    return loss_and_grads(model, sp, b)
            loss, g, ms, lv, pv = _timed_grads(run)
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            worst = 0.0
            for (path, a), (_, b) in zip(_flatten(gather(g)), one):
                scale = max(float(b.abs().max()), 1e-30)
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{tag} {v}: {'/'.join(path)} not "
                                         f"finite")
                worst = max(worst, float((a - b).abs().max()) / scale)
            del g, sp
            rel = abs(loss - float(loss1)) / abs(float(loss1))
            print(f"{tag} under {v} on a (1, 1) mesh, world-1 "
                  f"{dist.get_backend()} group: loss {loss:.7f} (rel err "
                  f"{rel:.2e}), gradients max err / scale {worst:.2e} (tol "
                  f"{SHARDED_MOE_TOL:g}); {ms:.2f} host ms (warm; one device "
                  f"{ms1:.2f}); matmul launches a microbatch {lv['matmul']}"
                  f" (one device {l1['matmul']}); plain calls {pv}")
            if rel > SHARDED_MOE_TOL or worst > SHARDED_MOE_TOL:
                raise AssertionError(f"{tag} {v} differs from one device")
            if lv != l1:
                raise AssertionError(f"{tag} {v} launched {lv}, one device "
                                     f"{l1}")
            if any(pv.values()) and device.type == "cuda":
                raise AssertionError(f"{tag} {v} called plain versions: "
                                     f"{pv}")
            out[v] = {"loss": loss, "loss_rel_err": rel,
                      "grad_max_err_over_scale": worst, "host_ms": ms,
                      "launches": lv, "plain_calls": pv}
    finally:
        dist.destroy_process_group()
    return out


def _family_argv(arch, device):
    """2 steps of the reduced ``arch`` at the CPU tests' 4 x 32 tokens in 2
    microbatches."""
    return ["--arch", arch, "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "32", "--grad-accum", "2", "--log-every", "1",
            "--device", device]


def sharded_family(device):
    """[sharded] (e), in the phase's process group: reduced phi3.5-moe and
    deepseek-v2 through the launcher's ``--model-axis 1`` under each
    expert-parallel regime on ``device``.  Returns {(arch, regime): (run,
    launches, plain calls)}."""
    runs = {}
    for arch in SHARDED_EP_ARCHS:
        for v in SHARDED_REGIMES:
            run, lv, pv, _ = _launched(_family_argv(arch, device) + [
                "--model-axis", "1", "--variant", v])
            if any(pv.values()) and device == "cuda":
                raise AssertionError(f"[sharded] (e) {arch} {v} called "
                                     f"plain versions: {pv}")
            runs[arch, v] = (run, lv, pv)
    return runs


def sharded_family_vs_cpu(runs):
    """[sharded] (e), after the phase's group is gone: each run again on
    the CPU under a world-1 gloo group (the launcher's own), its losses
    within SHARDED_LOSS_RTOL of the first's."""
    from repro_torch.launch import train as train_cli
    out = {}
    for (arch, v), (run, lv, pv) in runs.items():
        cpu = train_cli.main(_family_argv(arch, "cpu") + [
            "--model-axis", "1", "--variant", v])
        got = [h["loss"] for h in run["history"]]
        want = [h["loss"] for h in cpu["history"]]
        worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[sharded] (e) reduced {arch} --model-axis 1 --variant {v}: "
              f"losses {got} against the CPU's (world-1 gloo) {want} (max "
              f"rel err {worst:.2e}, rtol {SHARDED_LOSS_RTOL}); launches "
              f"{lv}; plain calls {pv}")
        if worst > SHARDED_LOSS_RTOL:
            raise AssertionError(f"[sharded] (e) {arch} {v}: {got} against "
                                 f"the CPU's {want}")
        out[f"{arch} {v}"] = {"losses": got, "cpu_losses": want,
                              "max_rel_err": worst, "launches": lv}
    return out


# one rank of the several-card expert-parallel run (f): the process group
# from torchrun's environment, a (1, n) mesh; rank 0 writes the errors
_EP_RANK = r"""
import json, os, sys
from dataclasses import replace
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.parallel.compression import ring_allreduce_int8
from repro_torch.parallel.sharding import (NamedSharding, P, axis_rules,
                                           distribute, make_rules)
from repro_torch.train.step import shard_params
args = json.loads(sys.argv[1])
device, n = args["device"], int(os.environ["WORLD_SIZE"])
if device == "cuda":
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
dist.init_process_group("nccl" if device == "cuda" else "gloo")
try:
    mesh = make_host_mesh(n, device_type=device)
    x = torch.randn((n, 777), generator=torch.Generator().manual_seed(0))
    ring = ring_allreduce_int8(distribute(x, NamedSharding(mesh, P("model"))),
                               mesh, "model").to_local()[0].cpu()
    want = x.sum(0)
    ring_err = float((ring - want).abs().max() / want.abs().max())
    cfg = get_config("phi3.5-moe", reduced=args["reduced"])
    m = cfg.moe
    cfg = replace(cfg, n_layers=1, moe=replace(
        m, capacity_factor=m.n_experts / m.top_k))
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    xs = torch.randn((2, 64, cfg.d_model), device=device,
                     generator=torch.Generator(device=device).manual_seed(1))
    ffn = {k[4:]: t[0] for k, t in params["pos0"].items()
           if k.startswith("ffn_")}
    want = moe.moe_ffn(ffn, xs, cfg, dispatch="sort")
    rules = make_rules("cp").with_mesh(mesh)
    sp = shard_params(model, params, rules)["pos0"]
    pd = {k[4:]: t.unbind(0)[0] for k, t in sp.items()
          if k.startswith("ffn_")}
    xd = distribute(xs, NamedSharding(mesh, rules.spec(
        "batch", "seq", "embed", dims=xs.shape)))
    with axis_rules(rules):
        got = moe.moe_ffn(pd, xd, cfg, dispatch="a2a").full_tensor()
    moe_err = float((got - want).abs().max() / want.abs().max())
    if os.environ["RANK"] == "0":
        with open(sys.argv[2], "w") as f:
            json.dump({"ring": ring_err, "moe": moe_err}, f)
finally:
    dist.destroy_process_group()
"""


def _torchrun_env(n):
    """Each of n ranks' environment as torchrun gives it, on a free port."""
    import os
    import socket
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    return [dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE=str(n)) for r in range(n)]


def _run_ranks(script, args, n, tag):
    """``script`` in n processes under torchrun's environment; rank 0's
    JSON result."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        res = Path(tmp) / "result.json"
        procs = [subprocess.Popen([sys.executable, "-c", script,
                                   json.dumps(args), str(res)], env=env)
                 for env in _torchrun_env(n)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            raise AssertionError(f"[sharded] the {n}-rank {tag} exited {rcs}")
        return json.loads(res.read_text())


def several_cards_ep(cards: int, device="cuda", reduced=False):
    """[sharded] (f): over n = min(cards, 4) ranks, one card each, a (1, n)
    mesh: ``ring_allreduce_int8`` of an (n, 777) input over the model axis
    within 5% of the sum's scale, and one phi3.5-moe MoE layer (capacity
    factor E / top_k) under cp, its all_to_all over the n ranks, within
    SHARDED_MOE_TOL x scale of ``sort`` on one rank."""
    n = min(cards, 4)
    got = _run_ranks(_EP_RANK, {"device": device, "reduced": reduced}, n,
                     "expert-parallel run")
    print(f"[sharded] (f) (1, {n}) mesh over {n} {device} ranks: int8 ring "
          f"max err / scale {got['ring']:.3e} (under 0.05); phi3.5-moe's cp "
          f"all_to_all MoE layer against sort on one rank, max err / scale "
          f"{got['moe']:.2e} (tol {SHARDED_MOE_TOL:g})")
    if got["ring"] >= 0.05 or got["moe"] > SHARDED_MOE_TOL:
        raise AssertionError(f"[sharded] (f) over {n} ranks: {got}")
    return dict(got, ranks=n)


# (g): the SSM families through the launcher, 2 steps of 2 x 32 tokens in
# one microbatch (the script's time: a step of the CPU tests' 4 x 32 in 2
# microbatches is twice the host work): xlstm-125m at its published widths
# (the phase's ``reduced`` says), jamba reduced
SHARDED_SSM_ARGV = ["--steps", "2", "--batch", "2", "--seq", "32",
                    "--grad-accum", "1", "--log-every", "1"]
SHARDED_SSM_ARCHS = ("xlstm-125m", "jamba-v0.1-52b")


def sharded_ssm(device, reduced=False):
    """[sharded] (g), in the phase's process group: each SSM configuration
    through the launcher on one device, then ``--model-axis 1`` under cp,
    tp and dp: losses, parameters and AdamW state bit for bit, the same
    launches, no plain call on the card; host ms a step of each."""
    out = {}
    for arch in SHARDED_SSM_ARCHS:
        red = reduced or arch != "xlstm-125m"
        argv = ["--arch", arch] + SHARDED_SSM_ARGV + ["--device", device] \
            + (["--reduced"] if red else [])
        one, l_one, p_one, _ = _launched(argv)
        if any(p_one.values()) and device == "cuda":
            raise AssertionError(f"[sharded] (g) {arch} one device called "
                                 f"plain versions: {p_one}")
        name = f"{'reduced ' if red else ''}{arch}"
        entry = {"one_device": {
            "host_ms": [h["host_ms"] for h in one["history"]],
            "launches_per_step": {k: n // 2 for k, n in l_one.items()}}}
        for v in SHARDED_REGIMES:
            run, lv, pv, _ = _launched(argv + ["--model-axis", "1",
                                               "--variant", v])
            _same_run(f"(g) {name} {v} on a (1, 1) mesh", run, one, lv,
                      l_one, pv, device)
            entry[v] = {"losses": [h["loss"] for h in run["history"]],
                        "host_ms": [h["host_ms"] for h in run["history"]],
                        "launches": lv}
        print(f"[sharded] (g) {name}: host ms a step (step 1, step 2) one "
              f"device {[round(t, 2) for t in entry['one_device']['host_ms']]}"
              + "".join(f", {v} {[round(t, 2) for t in entry[v]['host_ms']]}"
                        for v in SHARDED_REGIMES)
              + f"; launches a step {entry['one_device']['launches_per_step']}")
        out[name] = entry
    return out


# (h): the serving engine under rules, [serve]'s traffic
SHARDED_SERVE = dict(batch_size=4, s_max=256, max_new_tokens=16, seed=0)
SHARDED_SERVE_ARCHS = ("smollm-135m", "xlstm-125m")
SHARDED_SERVE_REQUESTS = 8


def _engine_run(model, params, rules):
    """(tokens per request, launches of each decode step, decode host ms,
    plain calls) of an engine over SHARDED_SERVE_REQUESTS of
    launch/serve.py's prompts."""
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.serve.engine import Engine, ServeConfig
    eng = Engine(model, params, ServeConfig(**SHARDED_SERVE), rules=rules)
    for req in synthetic_requests(SHARDED_SERVE_REQUESTS, model.cfg.vocab,
                                  0, model.cfg.n_codebooks):
        eng.submit(req)
    per_step = []
    inner = model.decode_step

    def counted(*a, **kw):
        before = dict(ops.launches)
        out = inner(*a, **kw)
        per_step.append({k: ops.launches[k] - before[k] for k in before})
        return out
    _zero_counts()
    model.decode_step = counted
    try:
        res = eng.run()
    finally:
        del model.decode_step
    return ({u: r.tokens for u, r in res.items()}, per_step,
            [1e3 * t for t in eng.timings["decode_s"]],
            dict(ops.plain_calls))


def sharded_serve(device, mesh, reduced=False):
    """[sharded] (h): each configuration's engine on one device, then
    under cp rules on ``mesh`` (a (1, 1) mesh of the phase's group): the
    same tokens, the same launches each decode step, no plain call on the
    card; host ms a decode step of each (median and least)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.parallel.sharding import make_rules
    rules = make_rules("cp").with_mesh(mesh)
    out = {}
    for arch in SHARDED_SERVE_ARCHS:
        cfg = get_config(arch, reduced=reduced)
        model = Model(cfg, device=device)
        params = draw_on(device, cfg, seed=0)
        runs = {"one": _engine_run(model, params, None)}
        runs["cp"] = _engine_run(model, params, rules)
        (t1, s1, ms1, p1), (t2, s2, ms2, p2) = runs["one"], runs["cp"]
        tag = (f"[sharded] (h) {arch} ({cfg.n_layers} layers, d_model "
               f"{cfg.d_model}) engine under cp on a (1, 1) mesh")
        stats = {k: {"median_ms": float(np.median(m)), "min_ms": min(m)}
                 for k, m in (("one_device", ms1), ("cp", ms2))}
        print(f"{tag}: tokens {'equal' if t1 == t2 else 'NOT equal'} to "
              f"the one-device engine's ({len(t1)} requests, "
              f"{sum(len(t) for t in t1.values())} tokens); {len(s2)} "
              f"decode steps, launches a step {s2[0]} (one device "
              f"{s1[0]}), every step equal: {s1 == s2}; plain calls {p2}; "
              f"host ms a decode step median {stats['cp']['median_ms']:.2f}"
              f" least {stats['cp']['min_ms']:.2f} (one device "
              f"{stats['one_device']['median_ms']:.2f} / "
              f"{stats['one_device']['min_ms']:.2f})")
        if t1 != t2:
            raise AssertionError(f"{tag}: tokens {t2} against {t1}")
        if s1 != s2:
            raise AssertionError(f"{tag}: decode launches {s2} against "
                                 f"{s1}")
        if device == "cuda" and (any(p1.values()) or any(p2.values())):
            raise AssertionError(f"{tag}: plain calls {p1} / {p2}")
        out[arch] = {"tokens_equal": True, "decode_steps": len(s2),
                     "launches_per_decode_step": s2[0],
                     "launches": {k: sum(st[k] for st in s2)
                                  for k in s2[0]},
                     "host_ms": stats}
        del params, model
        torch.cuda.empty_cache()
    return out


def phase_sharded(reduced=False, device="cuda", cards=None):
    """(a) smollm-135m at its published widths through ``launch/train.py
    --model-axis 1 --variant cp`` under a world-1 process group (NCCL on
    the card; made here, destroyed at the end), 2 steps of 8 x 128 tokens in
    2 microbatches: its losses, parameters and both AdamW moments equal the
    one-device launcher's bit for bit, with the same launches and no plain
    call; the host ms a step of each (the DTensor dispatch's cost); (b) the
    reduced model under dp, tp and cp_fsdp, each bit-equal to its
    one-device run; (c) where the machine shows several cards, the
    full-width cp run on a (1, n) mesh over n = min(cards, 4) of them
    against (a), and (f) the int8 ring and phi3.5-moe's cp all_to_all over
    them (``several_cards_ep``).  (d), full-width phi3.5-moe under the
    expert-parallel regimes, runs in the [moe] phase on its weights
    (``sharded_moe``); (e) here: reduced phi3.5-moe and deepseek-v2
    through ``--model-axis 1`` under cp, tp and dp, their losses against
    the same commands on the CPU (``sharded_family``)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    cfg = get_config("smollm-135m", reduced=reduced)
    argv = SHARDED_ARGV + ["--device", device] + (["--reduced"] if reduced
                                                  else [])
    rargv = SHARDED_ARGV + ["--device", device, "--reduced"]
    one, l_one, _, w_one = _launched(argv)
    want = train_launches(cfg, 2 * 2)
    if l_one != want and device == "cuda":
        raise AssertionError(f"[sharded] one device launched {l_one}, not "
                             f"{want}")
    r_one, rl_one, _, _ = _launched(rargv)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        sh, l_sh, p_sh, w_sh = _launched(
            argv + ["--model-axis", "1", "--variant", "cp"])
        _same_run(f"{cfg.name} ({cfg.n_layers} layers, d_model "
                  f"{cfg.d_model}) cp on a (1, 1) mesh, world-1 "
                  f"{dist.get_backend()} group", sh, one, l_sh, l_one, p_sh,
                  device)
        variants = {}
        for v in SHARDED_VARIANTS:
            run, lv, pv, _ = _launched(
                rargv + ["--model-axis", "1", "--variant", v])
            _same_run(f"reduced smollm-135m {v}", run, r_one, lv, rl_one, pv,
                      device)
            variants[v] = {"losses": [h["loss"] for h in run["history"]],
                           "launches": lv}
        family = sharded_family(device)
        ssm = sharded_ssm(device, reduced)
        from repro_torch.launch.mesh import make_host_mesh
        serve = sharded_serve(device, make_host_mesh(1, device_type=device),
                              reduced)
    finally:
        dist.destroy_process_group()
    family = sharded_family_vs_cpu(family)
    host = {"one_device": [h["host_ms"] for h in one["history"]],
            "sharded": [h["host_ms"] for h in sh["history"]]}
    print(f"[sharded] host ms a step (batch to loss; step 1, step 2): one "
          f"device {[round(t, 2) for t in host['one_device']]}, world-1 "
          f"group with DTensors {[round(t, 2) for t in host['sharded']]}; "
          f"runs {w_one:.1f} s and {w_sh:.1f} s")
    out = {"launches": l_sh, "launches_per_step": {
        k: n // 2 for k, n in l_sh.items()}, "plain_calls": p_sh,
        "losses": [h["loss"] for h in sh["history"]], "host_ms": host,
        "variants": variants, "family": family, "ssm": ssm, "serve": serve}
    cards = torch.cuda.device_count() if cards is None else cards
    if cards >= 2:
        out["several_cards"] = several_cards(argv, sh, cards, device)
        out["several_cards_ep"] = several_cards_ep(cards, device, reduced)
    else:
        print(f"[sharded] several cards ((c) and (f): the cp run, the int8 "
              f"ring, the MoE all_to_all): not run; this machine shows "
              f"{cards} CUDA device and NCCL puts no two ranks on one card "
              f"(at world 1 the ring returns its input)")
    return out


# -- phase 18: the distributed algorithms (jaxdist) ----------------------------

JAXDIST = dict(matmul=4096, tsqr=(65536, 256), cholesky=(4096, 512))
JAXDIST_TOL = {"matmul": 1e-4, "tsqr": 1e-4, "cholesky": 2e-3}
# one rank of the c = 2 run over 8 cards: the process group from
# torchrun's environment; rank 0 writes the errors
_JAXDIST_RANK = r"""
import json, os, sys
import torch
import torch.distributed as dist
from repro_torch.jaxdist import cholesky_3d, make_3d_mesh, matmul_3d, tsqr
args = json.loads(sys.argv[1])
torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
dist.init_process_group("nccl")
try:
    mesh = make_3d_mesh(2)
    g = torch.Generator(device="cuda").manual_seed(0)
    n = args["matmul"]
    a = torch.randn((n, n), device="cuda", generator=g)
    b = torch.randn((n, n), device="cuda", generator=g)
    c = matmul_3d(a, b, mesh).full_tensor()
    want = torch.matmul(a, b)
    err = {"matmul": float((c - want).abs().max() / want.abs().max())}
    m, k = args["tsqr"]
    x = torch.randn((m, k), device="cuda", generator=g)
    q, r = tsqr(x, mesh, "x")
    q, r = q.full_tensor(), r.full_tensor()
    err["tsqr"] = float((q @ r - x).abs().max() / x.abs().max())
    n, blk = args["cholesky"]
    y = torch.randn((n, n), device="cuda", generator=g)
    spd = y @ y.T + n * torch.eye(n, device="cuda")
    l, _ = cholesky_3d(spd, mesh, blk)
    l = l.full_tensor()
    ref = torch.linalg.cholesky(spd)
    err["cholesky"] = float((l - ref).abs().max() / ref.abs().max())
    if os.environ["RANK"] == "0":
        with open(sys.argv[2], "w") as f:
            json.dump(err, f)
finally:
    dist.destroy_process_group()
"""


def _tsqr_one(a):
    """TSQR's program on one device's plain tensors (p = 1)."""
    q1, r1 = torch.linalg.qr(a, mode="reduced")
    q2, r = torch.linalg.qr(r1, mode="reduced")
    return ops.matmul(q1, q2.contiguous()), r


def _cholesky_one(a, block):
    """Capital's recursion on one device's plain tensors, every product
    one ``ops.matmul`` on contiguous operands, as ``matmul_3d`` runs it on
    a (1, 1, 1) mesh."""
    n = a.shape[0]
    if n <= block:
        l = torch.linalg.cholesky(a)
        return l, torch.linalg.solve_triangular(
            l, torch.eye(n, dtype=a.dtype, device=a.device), upper=False)

    def mm(x, y):
        return ops.matmul(x.contiguous(), y.contiguous())
    h = n // 2
    l11, linv11 = _cholesky_one(a[:h, :h], block)
    l21 = mm(a[h:, :h], linv11.T)
    l22, linv22 = _cholesky_one(a[h:, h:] - mm(l21, l21.T), block)
    linv21 = -mm(linv22, mm(l21, linv11))
    zero = torch.zeros((h, h), dtype=a.dtype, device=a.device)
    return (torch.cat([torch.cat([l11, zero], 1), torch.cat([l21, l22], 1)]),
            torch.cat([torch.cat([linv11, zero], 1),
                       torch.cat([linv21, linv22], 1)]))


def _jaxdist_case(tag, run, one, check):
    """(result, launches, plain calls, host ms): ``run()`` once to warm
    (the solver's handles), then timed with the counters zeroed just
    before; its output against ``one()`` (one device's program) bit for
    bit, the launches equal; ``check(result)`` the error against
    torch.linalg."""
    run()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches, plain = dict(ops.launches), dict(ops.plain_calls)
    _zero_counts()
    t0 = time.perf_counter()
    want = one()
    torch.cuda.synchronize()
    ms_one = 1e3 * (time.perf_counter() - t0)
    l_one = dict(ops.launches)
    same = all(torch.equal(a.full_tensor(), b) for a, b in zip(got, want))
    err = check(got)
    print(f"[jaxdist] {tag}: {'equal' if same else 'NOT equal'} bit for "
          f"bit to one device's program; {err}; matmul launches "
          f"{launches['matmul']} (one device {l_one['matmul']}); plain "
          f"calls {plain}; {ms:.2f} host ms (warm; one device "
          f"{ms_one:.2f})")
    if not same or launches != l_one:
        raise AssertionError(f"[jaxdist] {tag}: bits equal {same}, "
                             f"launches {launches} against {l_one}")
    if any(plain.values()) and torch.cuda.is_available():
        raise AssertionError(f"[jaxdist] {tag}: plain calls {plain}")
    return {"launches": launches, "plain_calls": plain, "host_ms": ms,
            "one_device_host_ms": ms_one}


def phase_jaxdist(device="cuda", sizes=JAXDIST, cards=None):
    """matmul_3d, tsqr and cholesky_3d on a (1, 1, 1) mesh of a world-1
    group (NCCL on the card), each against one device's program bit for
    bit and against torch.linalg; at c = 2 over 8 ranks where the machine
    shows 8 or more cards."""
    import torch.distributed as dist
    from repro_torch.jaxdist import (cholesky_3d, make_3d_mesh, matmul_3d,
                                     tsqr)
    gen = torch.Generator(device=device).manual_seed(18)
    out = {}
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_3d_mesh(1, device)
        n = sizes["matmul"]
        a = torch.randn((n, n), device=device, generator=gen)
        b = torch.randn((n, n), device=device, generator=gen)

        def rel(x, y):
            return float((x - y).abs().max() / y.abs().max())

        def check_mm(got):
            e = rel(got[0].full_tensor(), torch.matmul(a, b))
            if e > JAXDIST_TOL["matmul"]:
                raise AssertionError(f"[jaxdist] matmul_3d: {e:.2e}")
            return (f"against torch.matmul max err / scale {e:.2e} (tol "
                    f"{JAXDIST_TOL['matmul']:g}); bound "
                    f"{bound(12 * n * n, 2 * n ** 3, 'float32')[0]:.3f} ms")
        out["matmul_3d"] = _jaxdist_case(
            f"matmul_3d {n}^3 f32 on a (1, 1, 1) mesh",
            lambda: (matmul_3d(a, b, mesh),), lambda: (ops.matmul(a, b),),
            check_mm)
        m, k = sizes["tsqr"]
        x = torch.randn((m, k), device=device, generator=gen)

        def check_qr(got):
            q, r = (t.full_tensor() for t in got)
            es = (rel(q @ r, x), float((q.T @ q - torch.eye(
                k, device=device)).abs().max()),
                rel(r.abs(), torch.linalg.qr(x)[1].abs()))
            if max(es) > JAXDIST_TOL["tsqr"]:
                raise AssertionError(f"[jaxdist] tsqr: {es}")
            return (f"Q R against A {es[0]:.2e}, Q^T Q against I "
                    f"{es[1]:.2e}, |R| against torch.linalg.qr's "
                    f"{es[2]:.2e} (tol {JAXDIST_TOL['tsqr']:g})")
        out["tsqr"] = _jaxdist_case(
            f"tsqr {m} x {k} on a (1, 1, 1) mesh",
            lambda: tsqr(x, mesh, "x"), lambda: _tsqr_one(x), check_qr)
        n, blk = sizes["cholesky"]
        y = torch.randn((n, n), device=device, generator=gen)
        spd = y @ y.T + n * torch.eye(n, device=device)

        def check_chol(got):
            l, linv = (t.full_tensor() for t in got)
            es = (rel(l, torch.linalg.cholesky(spd)), float(
                (l @ linv - torch.eye(n, device=device)).abs().max()))
            if max(es) > JAXDIST_TOL["cholesky"]:
                raise AssertionError(f"[jaxdist] cholesky_3d: {es}")
            return (f"L against torch.linalg.cholesky {es[0]:.2e}, L "
                    f"L^-1 against I {es[1]:.2e} (tol "
                    f"{JAXDIST_TOL['cholesky']:g})")
        out["cholesky_3d"] = _jaxdist_case(
            f"cholesky_3d n {n} block {blk} on a (1, 1, 1) mesh",
            lambda: cholesky_3d(spd, mesh, blk),
            lambda: _cholesky_one(spd, blk), check_chol)
    finally:
        dist.destroy_process_group()
    cards = torch.cuda.device_count() if cards is None else cards
    if cards >= 8:
        got = _run_ranks(_JAXDIST_RANK, sizes, 8, "jaxdist run")
        print(f"[jaxdist] (2, 2, 2) mesh over 8 cards: max err / scale "
              f"{got}")
        if got["matmul"] > JAXDIST_TOL["matmul"] or \
                got["tsqr"] > JAXDIST_TOL["tsqr"] or \
                got["cholesky"] > JAXDIST_TOL["cholesky"]:
            raise AssertionError(f"[jaxdist] over 8 cards: {got}")
        out["c2"] = got
    else:
        print(f"[jaxdist] c = 2 (8 ranks): not run; this machine shows "
              f"{cards} CUDA device(s)")
    return out


# -- phase 19: the pipeline over 'pod' ------------------------------------------

PIPELINE_MB = 4                 # microbatches of [train]'s 8 x 128 tokens
# the reference test's tolerances (tests/test_sharded.py
# test_pipeline_parallel_matches_reference)
PIPELINE_TOL = {"loss": 2e-3, "grad": (5e-3, 1e-4)}
# one rank of pod n over n cards: the process group from torchrun's
# environment; rank 0 writes the loss and the gradients' global norm
_PIPELINE_RANK = r"""
import json, os, sys
import torch
import torch.distributed as dist
args = json.loads(sys.argv[1])
dev = args["device"]
if dev == "cuda":
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
dist.init_process_group("nccl" if dev == "cuda" else "gloo")
try:
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import pipeline_loss, place_pipeline
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.data import DataConfig, synthetic_batch
    a = train_cli.parse(args["argv"])
    cfg, shape, model, _ = train_cli.build(a)
    params = model.init(torch.Generator().manual_seed(a.seed))
    host = synthetic_batch(cfg, shape, 0, DataConfig(seed=a.seed))
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    rules = make_rules("cp").with_mesh(make_host_mesh(
        1, pod=dist.get_world_size(), device_type=dev))
    placed = place_pipeline(model, params, rules)
    leaves = [v.detach().requires_grad_(True) for sub in placed.values()
              for v in sub.values()]
    it = iter(leaves)
    tree = {g: {k: next(it) for k in sub} for g, sub in placed.items()}
    loss = pipeline_loss(model, rules, tree, batch, n_mb=args["n_mb"])
    grads = [g.full_tensor() for g in torch.autograd.grad(loss, leaves)]
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    if dist.get_rank() == 0:
        with open(sys.argv[2], "w") as f:
            json.dump({"loss": float(loss), "grad_norm": norm}, f)
finally:
    dist.destroy_process_group()
"""


def phase_pipeline(reduced=False, device="cuda", cards=None):
    """smollm-135m at its published widths on [train]'s first batch (8 x
    128 tokens, the launcher's seeded weights) in 4 microbatches:
    ``Model.loss`` and its gradients on each microbatch on one device,
    averaged, then ``pipeline_loss`` on a (1, 1, 1) mesh of a world-1
    group (NCCL on the card; made and destroyed here), its gradients as
    whole tensors: the loss and every gradient within the reference test's
    tolerances, the same launches of every kernel, no plain call on the
    card; host ms of each, warm (a second call, synced).  With 2 or more
    cards, pod 2 across two of them, its loss and gradient norm against
    the one-rank run's."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import pipeline_loss, place_pipeline
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.data import DataConfig, synthetic_batch
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.step import _split, loss_and_grads
    argv = TRAIN_ARGV + ["--device", device] + (["--reduced"] if reduced
                                                else [])
    args = train_cli.parse(argv)
    cfg, shape, model, _ = train_cli.build(args)
    params = model.init(torch.Generator().manual_seed(args.seed))
    host = synthetic_batch(cfg, shape, 0, DataConfig(seed=args.seed))
    batch = {k: torch.from_numpy(v) for k, v in host.items()}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def one_device():
        loss, acc = 0.0, None
        for mb in _split(batch, PIPELINE_MB):
            l, g = loss_and_grads(model, params, {
                k: v.to(model.device) for k, v in mb.items()})
            loss = loss + l / PIPELINE_MB
            g = [t / PIPELINE_MB for t in tree_leaves(g)]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        sync()
        return float(loss), acc

    def timed_twice(fn):
        """(the first call's result, its launches and plain calls, the
        second call's host ms)."""
        _zero_counts()
        got = fn()
        launches, plain = dict(ops.launches), dict(ops.plain_calls)
        t0 = time.perf_counter()
        fn()
        return got, launches, plain, 1e3 * (time.perf_counter() - t0)

    (ref_loss, ref_g), l_ref, p_ref, ms_ref = timed_twice(one_device)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        rules = make_rules("cp").with_mesh(make_host_mesh(
            1, pod=1, device_type=device))
        placed = place_pipeline(model, params, rules)

        def pipe():
            leaves = [v.detach().requires_grad_(True) for v in
                      tree_leaves(placed)]
            it = iter(leaves)
            tree = {g: {k: next(it) for k in sub}
                    for g, sub in placed.items()}
            loss = pipeline_loss(model, rules, tree, batch,
                                 n_mb=PIPELINE_MB)
            grads = [g.full_tensor() for g in torch.autograd.grad(
                loss, leaves)]
            sync()
            return float(loss), grads
        (loss, grads), l_pipe, p_pipe, ms_pipe = timed_twice(pipe)
    finally:
        dist.destroy_process_group()
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    rtol, atol = PIPELINE_TOL["grad"]
    worst = max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
                for a, b in zip(grads, ref_g))
    print(f"[pipeline] {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, f32), {args.batch} x {args.seq} tokens in "
          f"{PIPELINE_MB} microbatches: pipeline_loss on a (1, 1, 1) mesh "
          f"of a world-1 {'NCCL' if device == 'cuda' else 'gloo'} group "
          f"{loss!r} against Model.loss on one device {ref_loss!r} (rel err "
          f"{loss_err:.2e}, rtol {PIPELINE_TOL['loss']}); every gradient "
          f"within rtol {rtol} / atol {atol} (worst |diff| / (atol + rtol "
          f"|want|) {worst:.2e})")
    print(f"[pipeline] launches {l_pipe} (one device: {l_ref}); plain calls "
          f"{p_pipe}; host ms, warm: pipeline {ms_pipe:.2f}, one device "
          f"{ms_ref:.2f}")
    if loss_err > PIPELINE_TOL["loss"] or worst > 1.0:
        raise AssertionError(f"[pipeline] loss {loss} vs {ref_loss}, "
                             f"gradients {worst:.2e} x the tolerance")
    if l_pipe != l_ref or not all(l_pipe[k] for k in ops.launches if
                                  device == "cuda"):
        raise AssertionError(f"[pipeline] launched {l_pipe}, one device "
                             f"{l_ref}")
    if device == "cuda" and (any(p_pipe.values()) or any(p_ref.values())):
        raise AssertionError(f"[pipeline] plain calls {p_pipe} / {p_ref}")
    out = {"loss": loss, "ref_loss": ref_loss, "loss_rel_err": loss_err,
           "grad_worst_over_tol": worst, "launches": l_pipe,
           "launches_one_device": l_ref, "plain_calls": p_pipe,
           "host_ms": ms_pipe, "host_ms_one_device": ms_ref}
    cards = torch.cuda.device_count() if cards is None else cards
    if cards >= 2:
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        got = _run_ranks(_PIPELINE_RANK, {"argv": argv, "n_mb": PIPELINE_MB,
                                          "device": device}, 2,
                         "pipeline run")
        err = abs(got["loss"] - loss) / abs(loss)
        nerr = abs(got["grad_norm"] - norm) / norm
        print(f"[pipeline] pod 2 over 2 {device} ranks: loss {got['loss']!r} "
              f"(rel err {err:.2e} against one rank's), gradient norm rel "
              f"err {nerr:.2e} (rtol {rtol})")
        if err > PIPELINE_TOL["loss"] or nerr > rtol:
            raise AssertionError(f"[pipeline] pod 2: {got}")
        out["pod2"] = dict(got, loss_rel_err=err, grad_norm_rel_err=nerr)
    else:
        print(f"[pipeline] pod 2: not run; this machine shows {cards} CUDA "
              f"device and NCCL puts no two ranks on one card")
    return out


# -- phase 20: the dry-run ----------------------------------------------------

DRYRUN_CELLS = (("smollm-135m", "train_4k", False),
                ("smollm-135m", "decode_32k", False),
                ("deepseek-v2", "train_4k", True))
# the dry-run's process: the cells on their production meshes, then
# [train]'s own step (full-width smollm-135m, 8 x 128 tokens in 2
# microbatches, remat full, f32) on a (1, 1) mesh of a fake world of one;
# it writes one JSON and asserts that it launched no kernel and took no
# plain version
_DRYRUN_CHILD = r"""
import json, os, sys, time
os.nice(10)          # it runs beside the card's phases, on the host
sys.path.insert(0, sys.argv[1])
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_cli
from repro_torch.launch.cells import Cell, build_cell
from repro_torch.launch.mesh import fake_world
cells = json.loads(sys.argv[2])
out = {"cells": [], "start_s": time.perf_counter()}
for arch, shape, multi in cells:
    out["cells"].append(dryrun.run_cell(arch, shape, multi_pod=multi))
a = train_cli.parse(json.loads(sys.argv[3]))
cfg, _, model, _ = train_cli.build(a)
from repro_torch.configs import SHAPES, Shape
SHAPES["chip_smoke_train"] = Shape("chip_smoke_train", a.seq, a.batch,
                                   "train")
import repro_torch.launch.cells as C
C.get_config = lambda name: cfg
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    t0 = time.perf_counter()
    cell = build_cell(a.arch, "chip_smoke_train", mesh, knobs=model.knobs,
                      tc=train_cli.train_config(a))
    build_s = time.perf_counter() - t0
    _, tr = cell.trace()
    out["train"] = dryrun.record(a.arch, "chip_smoke_train", "cp", [1, 1],
                                 ["data", "model"], 1, build_s, tr,
                                 cell.argument_bytes(), 0.0)
out["launches"], out["plain_calls"] = ops.launches, ops.plain_calls
out["wall_s"] = time.perf_counter() - out.pop("start_s")
with open(sys.argv[4], "w") as f:
    json.dump(out, f)
assert not any(ops.launches.values()), ops.launches
assert not any(ops.plain_calls.values()), ops.plain_calls
"""


def start_dryrun(tmp: Path, argv=None):
    """Start the dry-run's process (it needs no card); ``finish_dryrun``
    reads it.  It is killed when this script exits, whatever the exit."""
    import atexit
    import os
    argv = argv or TRAIN_ARGV + ["--device", "cpu"]
    res, log = tmp / "dryrun.json", tmp / "dryrun.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", _DRYRUN_CHILD, str(ROOT / "src"),
             json.dumps(DRYRUN_CELLS), json.dumps(argv), str(res)],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=tmp)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, res, log


def attention_charge(rec) -> str:
    """A cell record's flash charges: flops a device, forward and backward,
    and the collectives by kind.  A rank that holds a shard of the queries
    is charged the last shard's pairs (``ops.flash_attention`` on fake
    tensors): the heaviest rank of the model axis, which the step waits
    on."""
    k = rec["kernels"]
    fl = {n: k[n]["flops"] for n in ("flash_attention", "flash_attention_bwd")
          if n in k}
    coll = ", ".join(f"{kind} {b:.4e}" for kind, b in sorted(
        rec["collectives"]["by_kind"].items()))
    return (" + ".join(f"{n} {f:.4e}" for n, f in fl.items())
            + f" = {sum(fl.values()):.4e} flops a device, charged at the "
            f"heaviest rank's query offset (the last shard of the model "
            f"axis); collectives by kind (B): {coll}"
            if fl else f"none (no flash call); collectives by kind (B): "
            f"{coll}")


def finish_dryrun(started, train=None, limit_s: float = 1150):
    """Wait for the dry-run's process (until ``limit_s`` after the script's
    start) and print its cells, and its score of [train]'s step beside
    [train]'s measured device busy ms."""
    from repro_torch.kernels.cost import CARD_MEMORY_BYTES, CARD_NAME
    proc, res, log = started
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(10.0, limit_s - (t_wait - T_START)))
    finally:
        if proc.poll() is None:
            proc.kill()
    if rc != 0 or not res.exists():
        raise AssertionError(f"[dryrun] the dry-run's process exited {rc}:\n"
                             f"{log.read_text()[-4000:]}")
    got = json.loads(res.read_text())
    gb = 1 << 30
    total = torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else None
    print(f"[dryrun] its process ran {got['wall_s']:.1f} s beside the card's "
          f"phases (waited {time.perf_counter() - t_wait:.1f} s for it at "
          f"the end); launches {got['launches']}, plain calls "
          f"{got['plain_calls']} in it; fits against {CARD_MEMORY_BYTES} "
          f"B ({CARD_NAME}); this card reports {total} B")
    for rec in got["cells"]:
        r, m = rec["roofline"], rec["memory"]
        print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['variant']} "
              f"@ {'x'.join(map(str, rec['mesh']))}: compute "
              f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, "
              f"collective {r['collective_s']:.6f} s -> {r['bound']}-bound "
              f"(step {r['step_s']:.6f} s); per device {r['flops_per_dev']:.4e} "
              f"flops, {r['bytes_per_dev']:.4e} B, "
              f"{r['collective_bytes_per_dev']:.4e} B of collectives; peak "
              f"{m['peak_bytes'] / gb:.3f} GiB (args "
              f"{m['argument_bytes'] / gb:.3f}), fits: {m['fits']}; trace "
              f"{rec['trace_s']:.1f} s; useful-flops ratio "
              f"{rec['useful_flops_ratio']:.3f}; attention "
              + attention_charge(rec))
    tr = got["train"]
    r = tr["roofline"]
    f32_ms = 1e3 * r["flops_per_dev"] / PEAK_FLOPS["float32"]
    busy = ((train or {}).get("profile") or {}).get("device_busy_ms")
    print(f"[dryrun] [train]'s step traced on a (1, 1) mesh (8 x 128 "
          f"tokens, 2 microbatches, f32): {r['flops_per_dev']:.4e} flops, "
          f"{r['bytes_per_dev']:.4e} B; the dry-run's score {1e3 * r['step_s']:.3f}"
          f" ms ({r['bound']}-bound at the bf16 peak), compute at the f32 "
          f"peak {f32_ms:.3f} ms, memory {1e3 * r['memory_s']:.3f} ms; "
          f"[train] measured device busy "
          + (f"{busy:.3f} ms" if busy is not None else "not measured")
          + f"; trace {tr['trace_s']:.1f} s")
    if any(got["launches"].values()) or any(got["plain_calls"].values()):
        raise AssertionError(f"[dryrun] the dry-run launched "
                             f"{got['launches']} / called plain versions "
                             f"{got['plain_calls']}")
    return dict(got, train_busy_ms=busy, train_f32_compute_ms=f32_ms)


def offset_entries(kernels, offset_rows):
    """The kernels line's entries of the two flash kernels at a query
    offset (the [offsets] rows): one each, its numbers the last shard's of
    [train]'s microbatch at f32 (64, 64), its launches the kernel's own
    (one counter a kernel), every row beside."""
    rep = next(r for r in offset_rows if r["dtype"] == "float32"
               and r["pair"] == [64, 64] and "shard 3/4" in r["shape"])
    base = {k["name"]: k for k in kernels}
    out = []
    for name, pre in (("flash_attention", ""), ("flash_attention_bwd",
                                                "bwd_")):
        entry = {f: base[name][f] for f in (
            "route", "source", "launches", "launches_train",
            "launches_sharded")}
        entry.update({
            "name": f"{name} at q_offset",
            "replaces": "src/repro/kernels/flash_attention.py:47 (the "
                        "Pallas kernel's q_offset, :31)",
            "shape": rep["shape"],
            "max_abs_err": max(r[f"{pre}max_abs_err"] for r in offset_rows),
            "ms": rep[f"{pre}ms"], "plain_ms": rep[f"{pre}plain_ms"],
            "bound_ms": rep[f"{pre}bound_ms"],
            "bound_by": rep[f"{pre}bound_by"],
            "library_ms": rep[f"{pre}library_ms"],
            "status": "the query offset ported, each shard agrees with its "
                      "plain version and the whole call",
            "offset_rows": [{f: r[f] for f in (
                "shape", "dtype", "pair", "q_offset", f"{pre}max_abs_err",
                f"{pre}ms", f"{pre}plain_ms", f"{pre}library_ms",
                f"{pre}bound_ms", f"{pre}bound_by")} for r in offset_rows]})
        out.append(entry)
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
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.empty_cache()
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] {name}: {phase_s[name]:.1f} s")
        return out

    import tempfile
    dryrun_dir = tempfile.TemporaryDirectory()
    # the dry-run needs no card: its process runs beside the phases below
    dryrun_proc = start_dryrun(Path(dryrun_dir.name))
    card, ptxas = timed("build", phase_build)
    rows, floor = timed("kernels", phase_kernels, cfg)
    variants = timed("variants", phase_rms_variants)
    bwd_variants = timed("bwd variants", phase_rms_bwd_variants)
    crossover = timed("crossover", phase_crossover)
    serve_stats, params = timed("serve", phase_serve, cfg)
    serve_stats["profile"] = timed("profile", phase_profile, cfg, params)
    del params
    grad_rows, grad_checks = timed("grads", phase_grads, cfg)
    offset_rows = timed("offsets", phase_offsets)
    tune = timed("tune", phase_tune, cfg)
    daemon = {"shapes": timed("daemon shapes", phase_daemon_shapes),
              "parity": timed("daemon parity", phase_daemon_parity),
              "full_width": timed("daemon full width", phase_daemon_full),
              "wall_clock": timed("daemon wall clock",
                                  phase_daemon_wallclock)}
    sim = timed("sim", phase_sim)
    measured = timed("measured", phase_measured)
    workers = timed("workers", phase_workers)
    moe = timed("moe", phase_moe)
    mla = timed("mla", phase_mla)
    ssm = timed("ssm", phase_ssm)
    ssm_study = timed("ssm-study", phase_ssm_study)
    frontends = timed("frontends", phase_frontends)
    train = timed("train", phase_train)
    sharded = timed("sharded", phase_sharded)
    jaxdist = timed("jaxdist", phase_jaxdist)
    pipeline = timed("pipeline", phase_pipeline)
    dryrun = timed("dryrun", finish_dryrun, dryrun_proc, train)
    dryrun_dir.cleanup()

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
            "launches_daemon": daemon["full_width"]["launches"][name],
            "launches_measured": {
                f"{r['study']} {r['policy']}": r["launches"][name]
                for r in measured["studies"]},
            "launches_workers": workers["card"]["launches"][name],
            "launches_moe": {
                "serve": moe["serve"]["launches"].get(name, 0),
                "study": moe["study"]["launches"][name]},
            "launches_mla": {
                "serve": mla["serve"]["launches"].get(name, 0),
                "study": mla["study"]["launches"][name]},
            "launches_ssm": {
                "xlstm serve": ssm["xlstm"]["launches"].get(name, 0),
                "jamba serve": ssm["jamba"]["launches"].get(name, 0)},
            "launches_ssm_study": {
                "xlstm-125m session": ssm_study["session"]["launches"][name],
                "reduced jamba study":
                    ssm_study["jamba_study"]["launches"][name]},
            "launches_frontends": {
                f"{arch} {what}": n for arch, st in frontends.items()
                for what, n in (("serve", st["launches"].get(name, 0)),
                                ("study", st["study"]["launches"][name]))},
            "launches_train": train["launches"][name],
            "launches_sharded": {
                "smollm-135m cp": sharded["launches"][name],
                **{f"phi3.5-moe {v} (a microbatch)":
                   moe["sharded"][v]["launches"][name]
                   for v in SHARDED_REGIMES},
                **{f"reduced {k}": st["launches"][name]
                   for k, st in sharded["family"].items()},
                **{f"(g) {a} {v}": st[v]["launches"][name]
                   for a, st in sharded["ssm"].items()
                   for v in SHARDED_REGIMES},
                **{f"(h) {a} engine under cp (decode steps)":
                   st["launches"][name]
                   for a, st in sharded["serve"].items()}},
            "launches_jaxdist": {k: st["launches"][name]
                                 for k, st in jaxdist.items() if k != "c2"},
            "launches_pipeline": {
                "pipeline_loss (1, 1, 1), 4 microbatches":
                    pipeline["launches"][name],
                "Model.loss on the same microbatches":
                    pipeline["launches_one_device"][name]},
            "max_abs_err": max(r["max_abs_err"] for r in table
                               if r["kernel"] == name),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            "status": "ported, agrees with its plain version"
            if name in FORWARD else
            "backward of the TPU kernel, agrees with its plain version"})
    # the flash backward's (dk, dv) pairs as run, and its row at
    # deepseek-v2's study shape, (192, 128)
    mla_bwd = next(r for r in mla["bwd_kernels"]
                   if r["dtype"] == "float32" and r["bk"] == 16
                   and r["shape"].startswith("study mb2"))
    for k in kernels:
        if k["name"] == "flash_attention_bwd":
            k["pairs"] = sorted({tuple(r["pair"]) for r in grad_rows
                                 + mla["bwd_kernels"] if "pair" in r})
            k["mla"] = {f: mla_bwd[f] for f in (
                "shape", "pair", "tile", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
    kernels += offset_entries(kernels, offset_rows)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernels": kernels,
                                        "cases": rows, "floor": floor,
                                        "rms_variants": variants,
                                        "rms_bwd_variants": bwd_variants,
                                        "crossover": crossover,
                                        "ptxas": ptxas, "serve": serve_stats,
                                        "grads": grad_rows,
                                        "offsets": offset_rows,
                                        "grad_checks": grad_checks,
                                        "tune": tune, "daemon": daemon,
                                        "sim": sim, "measured": measured,
                                        "workers": workers, "moe": moe,
                                        "mla": mla, "ssm": ssm,
                                        "ssm_study": ssm_study,
                                        "frontends": frontends,
                                        "train": train,
                                        "sharded": sharded,
                                        "jaxdist": jaxdist,
                                        "pipeline": pipeline,
                                        "dryrun": dryrun,
                                        "phase_s": phase_s},
                                       indent=1))
    print(f"[time] chip_smoke.py took {time.perf_counter() - T_START:.1f} s "
          f"from its start, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
