"""The port's study of the SSM families against the JAX package's, on the
CPU: reduced xlstm-125m (mLSTM then sLSTM, FFN ``none``; 24 points) and
reduced jamba (Mamba with attention at position 4, dense and MoE FFNs; 48
points), both studies built on one parameter tree.

- every point's ``kernel_sequence`` carries the JAX study's signatures and
  occurrence counts;
- ``mamba_fb``, ``mlstm_fb`` and ``slstm_fb`` at ``ssm_chunk`` 8 and 32 x
  remat none and full, and the other thunks of both steps (jamba's
  ``attn_fb``, ``dense_fb``, ``moe_fb``; both ``embed_loss_fb``), against
  ``jax.grad`` of the JAX study's closures on the same layer weights and
  input: every gradient within atol 1e-5 x its largest magnitude, none
  zero but the MoE's unread norm;
- the remat is real: at S 32 a chunk of 8 recomputes each chunk's steps
  in the backward, as the reference's ``jax.checkpoint`` of the chunk body
  does (sLSTM: nh S = 128 more matmul calls than at chunk 32; Mamba: S =
  32 more of its ``h . c`` products), and a scan that records no graph
  runs no checkpoint;
- the eager session and the race under a tick clock pick JAX's winner
  with equal records (the daemon's per-shape studies of xlstm-125m:
  ``tests/test_torch_daemon.py``).

The tree is drawn with numpy in the JAX layout, from the JAX package's own
spec (``_spec_tree``): no JAX init to compile.  Norms and zero biases are
drawn (zeros would hide a port that scales by ``w`` or drops a bias);
Mamba's ``a_log``, ``dt_b`` and ``d`` keep the JAX init's values.
"""

import math
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import _spec_tree
from repro.tune import lm_study as jax_lm_study
from repro.tune.lm_study import LMStudy as JaxStudy
from repro.tune.lm_study import StepKnobs as JaxStepKnobs
from repro.tune.lm_study import lm_config_space as jax_space
from repro_torch.core.signatures import Signature
from repro_torch.kernels import ops
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_jax
from repro_torch.tune import LMStudy, StepKnobs, lm_config_space

ATOL = 1e-5
XLSTM, JAMBA = "xlstm-125m", "jamba-v0.1-52b"
SEQ = 32


def numpy_tree(arch, seed=0):
    """A JAX-layout parameter tree of the reduced ``arch``, drawn with
    numpy: weights N(0, 1/fan_in), embeddings N(0, 0.02^2), norms and the
    init's zero biases N(0, 0.01), Mamba's ``a_log`` log(1..N), ``dt_b``
    log(expm1(0.01)) and skip ``d`` ones as the JAX init; the MoE experts'
    down-projections scaled by 0.1 (the reference's MoE reads the
    un-normalized residual, ``tests/test_torch_ssm.py``)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for g, sub in sorted(_spec_tree(jax_get_config(arch,
                                                   reduced=True)).items()):
        for nm, (shape, _, fan) in sorted(sub.items()):
            if nm.endswith("a_log"):
                a = np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)),
                                    shape)
            elif nm.endswith("dt_b"):
                a = np.full(shape, math.log(math.expm1(0.01)))
            elif nm.endswith("mix_d"):
                a = np.ones(shape)
            elif nm.endswith(("ln", "b_if", "_b")) or fan == 0.0:
                a = rng.standard_normal(shape) * 0.1
            else:
                std = 0.02 if fan == -1 else 1.0 / math.sqrt(max(fan, 1))
                a = rng.standard_normal(shape) * std
                if nm == "ffn_w_down" and "ffn_router" in sub:
                    a = a * 0.1
            tree.setdefault(g, {})[nm] = np.ascontiguousarray(a, np.float32)
    return tree


def both_studies(arch):
    """(JAX study, port study) of the reduced ``arch`` at batch 2 x seq 32
    on one numpy tree (the JAX study is built on it, not on a draw of its
    own) and on the JAX study's batch (tokens, labels, patches)."""
    tree = numpy_tree(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lm_study, "init_params",
                   lambda cfg, key: jax.tree.map(jnp.asarray, tree))
        js = JaxStudy(arch, batch=2, seq=SEQ)
    ts = LMStudy(arch, batch=2, seq=SEQ, device="cpu")
    ts.params = params_from_jax(tree, ts.cfg, device="cpu")
    ts.batch_data = {k: torch.from_numpy(np.array(v))
                     for k, v in js.batch_data.items()}
    return js, ts


@pytest.fixture(scope="module")
def studies():
    return {arch: both_studies(arch) for arch in (XLSTM, JAMBA)}


def close_grads(tg, jg, unread=()):
    """Every gradient within atol 1e-5 x its largest magnitude (rtol
    1e-4), none zero but those named ``unread`` (zero in both)."""
    assert set(tg) == set(jg)
    for k in tg:
        if isinstance(jg[k], dict):
            close_grads(tg[k], jg[k],
                        tuple(u[len(k) + 1:] for u in unread
                              if u.startswith(k + "/")))
            continue
        want = np.asarray(jg[k])
        got = tg[k].detach().numpy()
        peak = float(np.abs(want).max())
        assert (peak == 0.0) == (k in unread), k
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-4,
                                   atol=ATOL * max(1.0, peak), err_msg=k)


def _sigs(seq):
    return [(s.kind, s.name, s.params, f) for s, _, f in seq]


@pytest.mark.parametrize("arch,index", [(XLSTM, i) for i in range(24)]
                         + [(JAMBA, i) for i in range(48)])
def test_kernel_sequence_matches_jax(studies, arch, index):
    js, ts = studies[arch]
    jkn, tkn = jax_space(js.cfg)[index], lm_config_space(ts.cfg)[index]
    assert asdict(tkn) == asdict(jkn)
    tseq = ts.kernel_sequence(tkn)
    assert all(isinstance(s, Signature) for s, _, _ in tseq)
    assert _sigs(tseq) == _sigs(js.kernel_sequence(jkn))
    names = {s.name for s, _, _ in tseq}
    if arch == XLSTM:        # FFN none: no FFN kernel
        assert names == {"mlstm_fb", "slstm_fb", "embed_loss_fb", "adamw"}
    else:
        assert names == {"mamba_fb", "attn_fb", "dense_fb", "moe_fb",
                         "embed_loss_fb", "adamw"}


def _thunk_grads(studies, arch, which, **kn):
    """(port grads, JAX grads) of one thunk of layer ``pos``'s weights at
    these knobs, on the same input: ``which`` is (mixer or ffn kind, pos)
    or "embed"."""
    js, ts = studies[arch]
    jk, tk = JaxStepKnobs("k", **kn), StepKnobs("k", **kn)
    if which == "embed":
        (jsig, jb), (tsig, tb) = (js._embed_loss_kernel(jk, 2),
                                  ts._embed_loss_kernel(tk, 2))
        jfn, jargs = js._kernel(jsig, jb)
        tfn, targs = tb()
        return tfn(*targs), jfn(*jargs)
    kind, pos = which
    mixer = kind in ("attn", "mamba", "mlstm", "slstm")
    make = "_mixer_kernel" if mixer else "_ffn_kernel"
    jsig, jb = getattr(js, make)(kind, pos, jk, 2)
    tsig, tb = getattr(ts, make)(kind, pos, tk, 2)
    assert (tsig.name, tsig.params) == (jsig.name, jsig.params)
    jfn, (jp, _) = js._kernel(jsig, jb)      # compiled once, kept for the
    tfn, (tp, _) = tb()                      # sessions below
    x = np.random.default_rng(pos + 3).standard_normal(
        (2, SEQ, ts.cfg.d_model)).astype(np.float32)
    return tfn(tp, torch.from_numpy(x)), jfn(jp, jnp.asarray(x))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("ssm", [8, 32])
@pytest.mark.parametrize("arch,kind,pos", [(XLSTM, "mlstm", 0),
                                           (XLSTM, "slstm", 1),
                                           (JAMBA, "mamba", 0)])
def test_ssm_fb_grads_match_jax(studies, arch, kind, pos, ssm, remat):
    tg, jg = _thunk_grads(studies, arch, (kind, pos), ssm_chunk=ssm,
                          remat=remat)
    close_grads(tg, jg)


@pytest.mark.parametrize("arch,which,kn", [
    (XLSTM, "embed", {}),
    (JAMBA, "embed", {}),
    (JAMBA, ("attn", 4), {"kv_chunk": 16}),
    (JAMBA, ("dense", 0), {}),
    (JAMBA, ("moe", 1), {"moe_dispatch": "sort"}),
    (JAMBA, ("moe", 1), {"moe_dispatch": "dense", "remat": "full"})])
def test_other_thunks_grads_match_jax(studies, arch, which, kn):
    tg, jg = _thunk_grads(studies, arch, which, **kn)
    moe = which != "embed" and which[0] == "moe"
    close_grads(tg, jg, unread=("ln",) if moe else ())


def _scan_calls(study, kind, pos, ssm, remat, monkeypatch):
    """(matmul plain calls, ``h . c`` einsum calls) of one call of the
    port's ``{kind}_fb`` at these knobs."""
    n = {"einsum": 0}
    einsum = torch.einsum

    def counting(eq, *a):
        n["einsum"] += eq == "bcn,bn->bc"
        return einsum(eq, *a)
    monkeypatch.setattr(torch, "einsum", counting)
    _, build = study._mixer_kernel(kind, pos, StepKnobs(
        "k", ssm_chunk=ssm, remat=remat), 2)
    fn, args = build()
    n["einsum"] = 0
    m0 = ops.plain_calls["matmul"]
    fn(*args)
    monkeypatch.setattr(torch, "einsum", einsum)
    return ops.plain_calls["matmul"] - m0, n["einsum"]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_chunk_remat_recomputes_each_chunk(studies, remat, monkeypatch):
    """At S 32, chunk 8 runs 4 checkpointed chunks: the backward recomputes
    every step once more than chunk 32 (one plain loop) does.  sLSTM's
    recurrent products are nh launches a step, so nh S = 128 more matmul
    calls; Mamba's step has one ``h . c`` product, S = 32 more, and its
    projections (outside the scan) the same count."""
    ts = studies[XLSTM][1]
    nh = ts.cfg.n_heads
    s8, _ = _scan_calls(ts, "slstm", 1, 8, remat, monkeypatch)
    s32, _ = _scan_calls(ts, "slstm", 1, 32, remat, monkeypatch)
    assert s8 - s32 == nh * SEQ == 128
    tj = studies[JAMBA][1]
    m8, e8 = _scan_calls(tj, "mamba", 0, 8, remat, monkeypatch)
    m32, e32 = _scan_calls(tj, "mamba", 0, 32, remat, monkeypatch)
    assert (m8, e8 - e32) == (m32, SEQ)
    assert e32 == SEQ * (2 if remat == "full" else 1)


def _step(c, x):
    c = torch.tanh(c + x)
    return c, 2.0 * c


def test_chunked_scan_checkpoints_only_a_recorded_scan(monkeypatch):
    """Without a graph (inputs that need no grad, or ``no_grad``) the scan
    is one loop and calls no checkpoint; recorded, its values and
    gradients are the plain loop's."""
    xs = torch.randn(12, 3, generator=torch.Generator().manual_seed(0))
    want_c, want_y = S._loop(_step, torch.zeros(3), xs)
    calls = []
    real = S.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(S, "checkpoint", spy)
    c, y = S.chunked_scan(_step, torch.zeros(3), xs, chunk=4)
    assert not calls and torch.equal(y, want_y) and torch.equal(c, want_c)
    leaf = xs.clone().requires_grad_(True)
    with torch.no_grad():
        S.chunked_scan(_step, torch.zeros(3), leaf, chunk=4)
    assert not calls
    c, y = S.chunked_scan(_step, torch.zeros(3), leaf, chunk=4)
    assert len(calls) == 3
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    g = torch.autograd.grad((y.sum() + c.sum()), leaf)[0]
    plain = xs.clone().requires_grad_(True)
    pc, py = S._loop(_step, torch.zeros(3), plain)
    torch.testing.assert_close(
        g, torch.autograd.grad(py.sum() + pc.sum(), plain)[0])
    with pytest.raises(ValueError, match="whole number"):
        S.chunked_scan(_step, torch.zeros(3), leaf, chunk=5)


class TickClock:
    """Every reading advances time by ``dt``."""

    def __init__(self, dt: float = 1e-3):
        self.dt, self.now = dt, 0.0

    def __call__(self) -> float:
        self.now += self.dt
        return self.now


def _records(result):
    return [r.to_json() for r in result.records]


def test_eager_session_picks_jax_winner_under_tick_clock(studies):
    """xlstm-125m's first 4 points (ssm 8 and 32 at each KV chunk, which
    its step does not read): the same winner, records and costs."""
    js, ts = studies[XLSTM]
    kw = dict(policy="eager", trials=2, max_configs=4)
    jr = js.session(clock=TickClock(), **kw).run()
    tr = ts.session(clock=TickClock(), **kw).run()
    assert tr.chosen.name == jr.chosen.name
    assert _records(tr) == _records(jr)
    assert tr.full_tuning_time == jr.full_tuning_time
    assert tr.selective_tuning_time == jr.selective_tuning_time


def test_race_picks_jax_winner_under_tick_clock(studies):
    js, ts = studies[XLSTM]
    kw = dict(policy="conditional", max_configs=4, max_rounds=3)
    jr = js.race(clock=TickClock(), **kw)
    tr = ts.race(clock=TickClock(), **kw)
    assert tr.extra["best"] == jr.extra["best"]
    assert _records(tr) == _records(jr)

