"""The port's measured mode (``repro_torch.linalg.blas.MeasuredTimer``)
against the JAX package's, on the CPU.

One signature of each compute kind that the four ``ci`` studies emit: the
port draws the reference's operands exactly (float64 draws cast to
float32, in the same order from one seeded generator), computes what the
reference's jitted functions compute within each kind's tolerance, passes
communication signatures to the cost model unchanged, and, under one fake
clock shared by both modules, drives the paper's ``Autotuner`` to the same
report record for record.
"""

import numpy as np
import pytest
import torch

import repro.linalg.blas as jax_blas
import repro_torch.linalg.blas as port_blas
from repro.core.signatures import Signature as JaxSignature
from repro_torch.core.signatures import Signature

# (kind, params) from the ci studies: SLATE Cholesky (256-wide tiles),
# CANDMC QR (8-wide panels of a 512-row block column), Capital Cholesky
# and SLATE QR
SIGS = [("gemm", (256, 256, 256)), ("syrk", (256, 256)), ("trmm", (8, 63)),
        ("trsm", (256, 256)), ("potrf", (256,)), ("trtri", (16,)),
        ("geqrf", (512, 8)), ("tpqrt", (64, 8)), ("ormqr", (512, 8, 8)),
        ("tpmqrt", (64, 64, 8)), ("blk2cyc", (2048,))]
MATMUL_KINDS = {"gemm", "syrk", "trmm", "ormqr", "tpmqrt"}
# (rtol, atol as a fraction of the reference output's largest magnitude):
# the matmul family; the triangular solves, Cholesky and QR (as R^T R)
TOL = {"matmul": (1e-4, 1e-4), "solve": (1e-3, 1e-5)}


@pytest.fixture(scope="module")
def drawn():
    """Every signature's operands and result from one timer of each
    package, drawn in SIGS order (the shared generator's order)."""
    ref = jax_blas.MeasuredTimer(seed=0)
    port = port_blas.MeasuredTimer(seed=0, device="cpu")
    out = {}
    for name, params in SIGS:
        rfn, rargs = ref._operands(JaxSignature("comp", name, params))
        pfn, pargs = port._operands(Signature("comp", name, params))
        if rfn == "copy":
            rout, pout = np.asarray(rargs[0]), pargs[0].clone().numpy()
        else:
            rout = np.asarray(rfn(*rargs))
            pout = pfn(*pargs).numpy()
        out[name] = ([np.asarray(a) for a in rargs], pargs, rout, pout)
    return out


@pytest.mark.parametrize("name", [n for n, _ in SIGS])
def test_operands_equal_the_references(drawn, name):
    rargs, pargs, _, _ = drawn[name]
    assert len(rargs) == len(pargs)
    for r, p in zip(rargs, pargs):
        assert p.dtype == torch.float32 and r.dtype == np.float32
        assert p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), r)


@pytest.mark.parametrize("name", [n for n, _ in SIGS])
def test_results_agree_with_the_references(drawn, name):
    _, _, want, got = drawn[name]
    assert got.dtype == np.float32
    if name == "blk2cyc":
        np.testing.assert_array_equal(got, want)
        return
    if name in ("geqrf", "tpqrt"):
        # R is unique only up to the signs of its rows: compare R^T R
        want, got = want.T @ want, got.T @ got
    rtol, arel = TOL["matmul" if name in MATMUL_KINDS else "solve"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=arel * float(np.abs(want).max()))


def test_comm_signatures_go_to_the_cost_model():
    from repro.simmpi.costmodel import CostModel as JaxCostModel
    from repro.simmpi.costmodel import KNL_STAMPEDE2 as JAX_KNL
    from repro_torch.simmpi.costmodel import KNL_STAMPEDE2, CostModel
    sigs = [("bcast", (65536, 8, 1)), ("send", (2048, 2, 1)),
            ("allreduce", (8, 64, 1))]
    ref = jax_blas.MeasuredTimer(JaxCostModel(JAX_KNL, allocation=0, seed=3))
    port = port_blas.MeasuredTimer(CostModel(KNL_STAMPEDE2, allocation=0,
                                             seed=3), device="cpu")
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    got = [port(Signature("comm", n, p), pr) for n, p in sigs]
    want = [ref(JaxSignature("comm", n, p), rr) for n, p in sigs]
    assert got == want and port.calls == ref.calls == 0
    with pytest.raises(RuntimeError, match="comm cost model"):
        port_blas.MeasuredTimer(device="cpu")(Signature("comm", *sigs[0]),
                                              pr)
    with pytest.raises(KeyError, match="no measured realization"):
        port_blas.MeasuredTimer(device="cpu")._operands(
            Signature("comp", "getrf", (8,)))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert port_blas.MeasuredTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_blas.MeasuredTimer()


class _FakeTime:
    """A module-``time`` stand-in whose perf_counter advances on every
    read by a step that cycles with the read's position, so that a timing
    depends on where in the call sequence it was taken."""

    def __init__(self):
        self.now, self.reads = 0.0, 0

    def perf_counter(self) -> float:
        self.reads += 1
        self.now += 1e-4 * (1 + (self.reads % 7) / 10)
        return self.now


def test_warm_up_and_call_counts_follow_the_reference(monkeypatch):
    """A signature's first call runs its kernel once outside the timed
    region, then once timed; a copy is timed from its first call; every
    compute call counts and reads the clock twice."""
    runs = {}
    for mod in (jax_blas, port_blas):
        def counting(*args, real=mod._gemm, key=mod.__name__):
            runs[key] = runs.get(key, 0) + 1
            return real(*args)
        monkeypatch.setattr(mod, "_gemm", counting)
        monkeypatch.setattr(mod, "time", _FakeTime())
    sigs = [("gemm", (16, 8, 4)), ("blk2cyc", (64,))] * 2
    ref = jax_blas.MeasuredTimer(seed=0)
    port = port_blas.MeasuredTimer(seed=0, device="cpu")
    want = [ref(JaxSignature("comp", n, p), None) for n, p in sigs]
    got = [port(Signature("comp", n, p), None) for n, p in sigs]
    assert got == want
    assert runs == {jax_blas.__name__: 3, port_blas.__name__: 3}
    assert port.calls == ref.calls == 4
    assert port_blas.time.reads == jax_blas.time.reads == 8


def test_autotuner_reports_equal_under_a_shared_fake_clock(monkeypatch):
    """The paper's harness over one SLATE Cholesky ci configuration (the
    widest tile, 832: the fewest kernels) under both timers: same records,
    same number of timed calls, same clock reads."""
    from repro.core.policies import policy as jax_policy
    from repro.core.tuner import Autotuner as JaxAutotuner
    from repro.linalg.studies import slate_cholesky_study as jax_study
    from repro.simmpi.costmodel import CostModel as JaxCostModel
    from repro.simmpi.costmodel import KNL_STAMPEDE2 as JAX_KNL
    from repro_torch.core.policies import policy
    from repro_torch.core.tuner import Autotuner
    from repro_torch.linalg.studies import slate_cholesky_study
    from repro_torch.simmpi.costmodel import KNL_STAMPEDE2, CostModel

    clocks = (_FakeTime(), _FakeTime())
    monkeypatch.setattr(jax_blas, "time", clocks[0])
    monkeypatch.setattr(port_blas, "time", clocks[1])
    reports, timers = [], []
    for study, tuner_cls, pol, cm, knl, mk in (
            (jax_study, JaxAutotuner, jax_policy, JaxCostModel, JAX_KNL,
             lambda c: jax_blas.MeasuredTimer(c, seed=0)),
            (slate_cholesky_study, Autotuner, policy, CostModel,
             KNL_STAMPEDE2,
             lambda c: port_blas.MeasuredTimer(c, seed=0, device="cpu"))):
        st = study("ci")
        st.configs = st.configs[-1:]
        timer = mk(cm(knl, allocation=0, seed=0))
        reports.append(tuner_cls(st, pol("conditional", tolerance=0.25),
                                 trials=2, seed=0, timer=timer).tune())
        timers.append(timer)
    ref, port = reports
    assert port.records[0].name == "slate-chol-t832-la1"
    assert [r.to_json() for r in port.records] == \
        [r.to_json() for r in ref.records]
    assert port.full_tuning_time == ref.full_tuning_time
    assert port.selective_tuning_time == ref.selective_tuning_time
    assert timers[1].calls == timers[0].calls > 0
    assert clocks[1].reads == clocks[0].reads == 2 * timers[0].calls
