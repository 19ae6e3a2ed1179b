"""The port's spans and counters (``repro_torch.obs``) on the CPU: nothing
recorded or launched while tracing is off, the span tree of the engine and
the train step under a profiler session, the MoE's counters against a hand
count, the spans on the profiler's clock, and one session's records at a
time."""

import threading
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.model import Model, ModelKnobs
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.train.optim import adamw_init
from repro_torch.train.step import TrainConfig, make_train_step

CFG = get_config("phi3.5-moe", reduced=True)
PROMPTS = [5, 9, 6]


@pytest.fixture(scope="module")
def weights():
    model = Model(CFG, ModelKnobs(remat="full"), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@contextmanager
def session():
    """A profiler session after untraced work, as a traced stretch follows
    a run's untraced steps: the recorder then starts afresh."""
    with obs.span("untraced"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def _serve(weights, traced: bool):
    """Three requests over two slots; returns the engine."""
    model, params = weights
    eng = Engine(model, params, ServeConfig(batch_size=2, s_max=32,
                                            max_new_tokens=3))

    def go():
        for uid, n in enumerate(PROMPTS):
            eng.submit(Request(uid, np.arange(n) % CFG.vocab))
        eng.run()
    with torch.no_grad():
        if traced:
            with session():
                go()
        else:
            go()
    return eng


def _train(weights, traced: bool):
    """One step of two microbatches of 2 x 8 tokens."""
    model, params = weights
    step = make_train_step(model, TrainConfig(grad_accum=2))
    tok = torch.randint(0, CFG.vocab, (4, 9),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if traced:
        with session():
            step(params, adamw_init(params), batch)
    else:
        step(params, adamw_init(params), batch)


def _refuse(*_, **__):
    raise AssertionError("called while tracing is off")


def test_tracing_off_records_and_launches_nothing(weights, monkeypatch):
    _serve(weights, traced=True)        # a session's records, kept
    before = (list(obs.spans()), obs.counters())
    monkeypatch.setattr(obs, "_range", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.Tensor, "item", _refuse)
    eng = _serve(weights, traced=False)
    _train(weights, traced=False)
    sink = []
    with obs.span("x", device=True, sink=sink):
        obs.count("y", torch.ones(3))
    assert obs.span("x") is obs.span("z", uid=1, device=True)
    monkeypatch.undo()
    assert (obs.spans(), obs.counters()) == before
    assert len(sink) == 1 and sink[0] >= 0
    # the sinks still fed: one prefill a request, one decode a step
    assert len(eng.timings["prefill_s"]) == len(PROMPTS)
    assert len(eng.timings["decode_s"]) > 0


def test_engine_timings_the_same_traced_or_not(weights):
    off, on = _serve(weights, traced=False), _serve(weights, traced=True)
    assert {k: len(v) for k, v in on.timings.items()} \
        == {k: len(v) for k, v in off.timings.items()}
    assert {u: r.tokens for u, r in on.results.items()} \
        == {u: r.tokens for u, r in off.results.items()}
    spans = obs.spans()
    # the sink holds each span's host duration
    assert [s.ms / 1e3 for s in spans if s.name == "engine.decode"] \
        == pytest.approx(on.timings["decode_s"], abs=1e-4)


def test_engine_span_tree(weights):
    eng = _serve(weights, traced=True)
    spans = obs.spans()
    names = [s.name for s in spans]
    assert set(names) == {"engine.step", "engine.queued", "engine.prefill",
                          "engine.decode", "engine.sample", "model.moe_ffn"}
    parent = {i: spans[s.parent].name if s.parent is not None else None
              for i, s in enumerate(spans)}
    for i, s in enumerate(spans):
        want = {"engine.step": {None}, "engine.queued": {None},
                "engine.prefill": {"engine.step"},
                "engine.decode": {"engine.step"},
                "engine.sample": {"engine.step"},
                "model.moe_ffn": {"engine.prefill", "engine.decode"}}
        assert parent[i] in want[s.name], (i, s)
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert names.count("engine.decode") == len(eng.timings["decode_s"])
    assert names.count("engine.sample") == names.count("engine.decode")
    # one prefill and one queued span a request, each under its uid
    pre = {s.uid: s for s in spans if s.name == "engine.prefill"}
    queued = {s.uid: s for s in spans if s.name == "engine.queued"}
    assert sorted(pre) == sorted(queued) == list(range(len(PROMPTS)))
    assert names.count("engine.prefill") == len(PROMPTS)
    assert names.count("engine.queued") == len(PROMPTS)
    for uid, q in queued.items():
        assert q.end_ns <= pre[uid].start_ns
    # the third request waits for a slot: its queue outlasts a decode step
    assert queued[2].ms > min(s.ms for s in spans
                              if s.name == "engine.decode")
    # a layer a prefill or a decode step, and no other span carries a uid
    assert names.count("model.moe_ffn") == CFG.n_layers * (
        len(PROMPTS) + names.count("engine.decode"))
    assert {s.uid for s in spans if s.name not in (
        "engine.prefill", "engine.queued")} == {None}
    # on the CPU no span has device times
    assert all(s.device_ms is None for s in spans)


def test_train_span_tree(weights):
    _train(weights, traced=True)
    spans = obs.spans()
    top = [(s.name, spans[s.parent].name if s.parent is not None else None)
           for s in spans if s.name != "model.moe_ffn"]
    assert top == [("train.step", None)] + [
        ("train.forward", "train.step"),
        ("train.backward", "train.step")] * 2 + [
        ("train.optimizer", "train.step")]
    moe_parents = [spans[s.parent].name for s in spans
                   if s.name == "model.moe_ffn"]
    # remat full: each microbatch's layers in the forward and again in the
    # backward's recompute
    assert moe_parents == (["train.forward"] * CFG.n_layers
                           + ["train.backward"] * CFG.n_layers) * 2
    c = obs.counters()
    assert list(c) == ["train.step"]
    # 2 microbatches x 16 tokens x top-2 x 2 layers, twice (the recompute)
    assert c["train.step"]["moe.pairs"] == 2 * 16 * 2 * CFG.n_layers * 2


def _forced_routing():
    """Four tokens whose router logits pick experts (0, 1), (0, 2), (0, 3),
    (1, 2): at capacity factor 1 each expert holds round(8 / 4) = 2 rows,
    and the third pair of expert 0 is dropped."""
    E, D, F = CFG.moe.n_experts, CFG.d_model, CFG.moe.d_ff_expert
    g = torch.Generator().manual_seed(2)
    router = torch.zeros(D, E)
    router[:E, :E] = torch.eye(E)
    p = {"router": router,
         "w_gate": torch.randn(E, D, F, generator=g) * 0.1,
         "w_up": torch.randn(E, D, F, generator=g) * 0.1,
         "w_down": torch.randn(E, F, D, generator=g) * 0.1}
    x = torch.zeros(1, 4, D)
    for t, (a, b) in enumerate([(0, 1), (0, 2), (0, 3), (1, 2)]):
        x[0, t, a], x[0, t, b] = 5.0, 4.0
    cfg = replace(CFG, moe=replace(CFG.moe, capacity_factor=1.0))
    return p, x, cfg


def test_moe_counters_equal_the_hand_count_in_each_phase():
    p, x, cfg = _forced_routing()
    routing = []
    with session():
        for phase in ("engine.prefill", "engine.decode", "train.step"):
            with obs.span(phase):
                with obs.span("inner"):
                    moe.moe_ffn(p, x, cfg, dispatch="sort",
                                routing=routing)
        moe.moe_ffn(p, x, cfg, dispatch="sort")
        moe.moe_ffn(p, x, cfg, dispatch="dense")        # not counted
    hand = {"moe.pairs": 8, "moe.rows": 4 * 2, "moe.kept": 7}
    assert obs.counters() == {ph: hand for ph in (
        "engine.prefill", "engine.decode", "train.step", "other")}
    # the counter and the kept mask agree, and the dropped pair is the
    # third token's at expert 0 (stable order: tokens 0 and 1 come first)
    for idx, kept in routing:
        assert int(kept.sum()) == 7
        assert not bool(kept[2, 0]) and int(idx[2, 0]) == 0


def test_span_starts_on_the_profilers_clock():
    with session() as prof:
        with obs.span("obs.warm"):
            pass
        for _ in range(5):
            with obs.span("obs.clock"):
                torch.ones(64).sum()
    ours = [s.start_ns for s in obs.spans() if s.name == "obs.clock"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    theirs = [t0 + e.time_range.start * 1e3 for e in prof.events()
              if e.name == "obs.clock"]
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, sorted(theirs)):
        assert abs(a - b) < 1e6


def test_an_untraced_thread_leaves_the_traced_threads_records():
    """A thread the profiler does not trace (the daemon's tuner beside a
    traced serve loop) checks, spans and counts while the main thread
    records: the main thread's spans, nesting and counters survive."""
    p, x, cfg = _forced_routing()
    other = threading.Event()
    done = threading.Event()

    def untraced():
        other.wait()
        with obs.span("engine.decode"):
            obs.count("moe.pairs", 100)
            moe.moe_ffn(p, x, cfg, dispatch="sort")
        done.set()

    t = threading.Thread(target=untraced)
    t.start()
    with session():
        with obs.span("engine.prefill"):
            with obs.span("outer"):
                other.set()
                done.wait()
                with obs.span("inner"):
                    obs.count("moe.pairs", 3)
    t.join()
    spans = obs.spans()
    assert [(s.name, spans[s.parent].name if s.parent is not None else None)
            for s in spans] == [("engine.prefill", None),
                                ("outer", "engine.prefill"),
                                ("inner", "outer")]
    assert obs.counters() == {"engine.prefill": {"moe.pairs": 3}}


def test_a_second_session_starts_afresh():
    with session():
        with obs.span("first"):
            obs.count("n", 2)
    assert [s.name for s in obs.spans()] == ["first"]
    with obs.span("between"):       # tracing off: a check, no record
        obs.count("n", 5)
    assert [s.name for s in obs.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("second"):
            obs.count("n", torch.tensor([1, 2]))
    assert [s.name for s in obs.spans()] == ["second"]
    assert obs.counters() == {"other": {"n": 3}}
