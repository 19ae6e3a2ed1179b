"""The port's always-on tuning daemon against the JAX package's, on the CPU
(smollm-135m reduced: d_model 64, 4/2 heads of 8, 2 layers, vocab 256).

(a) ``run_daemon_demo(synchronous=True)`` on deterministic virtual clocks
    gives the same summary in both packages: counters, steady-state
    counters, ratios, second tuned serves, re-tunes and the event journal,
    field for field (studies on the port's plain versions, on the CPU);
(b) the daemon's shape-miss study lands the same winner as an offline
    ``LMStudy.session`` under the same clock, in both packages
    (``tests/test_daemon.py``'s offline pattern);
(c) the daemon buckets request shapes with the engine's own
    ``bucket_length``;
(d) the CLI's ``--daemon`` runs on the CPU when asked (reduced
    xlstm-125m's studies too), and the provider wants the card by
    default;
(e) the lazy state that two threads share (an ``LMStudy``'s kernel
    closures, the kernel libraries, the cached workspace) is built once.
"""

import ctypes
import sys
import threading
import time

import pytest
import torch

from repro.serve.tuner import run_daemon_demo as jax_demo
from repro_torch.api.daemon import TUNED, DaemonConfig
from repro_torch.kernels import _build
from repro_torch.serve.tuner import (LMShapeProvider, ServingTuner,
                                     VirtualClock, run_daemon_demo,
                                     shape_key)
from repro_torch.tune import LMStudy

ARCH = "smollm-135m"
SUMMARY_KEYS = ["counters", "steady_state_counters", "ratios",
                "second_tuned_serves", "served_while_retuning",
                "drift_detected", "retunes", "events"]


@pytest.fixture(scope="module")
def demos():
    return (run_daemon_demo(ARCH, device="cpu", synchronous=True),
            jax_demo(ARCH, synchronous=True))


@pytest.mark.parametrize("key", SUMMARY_KEYS)
def test_daemon_demo_matches_jax(demos, key):
    port, ref = demos
    assert port[key] == ref[key]


def test_daemon_demo_lands_every_phase(demos):
    port, _ = demos
    assert port["drift_detected"] and port["retunes"] > 0
    assert port["steady_state_counters"]["cold_banked_exec"] == 0
    kinds = {e["event"] for e in port["events"]}
    assert {"tune_started", "tune_complete", "drift_detected",
            "retune_started", "retune_complete"} <= kinds
    assert "study_failed" not in kinds and "scheduler" not in kinds


def test_daemon_winner_matches_offline_lm_session():
    """The daemon's shape-miss study converges to the same winner as an
    offline port ``LMStudy.session`` and as the JAX daemon, under the same
    deterministic clock."""
    from repro.serve.tuner import LMShapeProvider as JaxProvider
    from repro.serve.tuner import ServingTuner as JaxTuner
    from repro.api.daemon import DaemonConfig as JaxConfig

    offline = LMStudy(ARCH, batch=2, seq=16, device="cpu").session(
        policy="eager", trials=2, max_configs=2,
        clock=VirtualClock(), collect_stats=True).run()

    winners = []
    for tuner in (
            ServingTuner(ARCH, seq_buckets=(16,), clock=VirtualClock(),
                         provider=LMShapeProvider(trials=2, max_configs=2,
                                                  clock=VirtualClock(),
                                                  device="cpu"),
                         config=DaemonConfig(shadow_every=3,
                                             serve_min_samples=2,
                                             synchronous=True)),
            JaxTuner(ARCH, seq_buckets=(16,), clock=VirtualClock(),
                     provider=JaxProvider(trials=2, max_configs=2,
                                          clock=VirtualClock()),
                     config=JaxConfig(shadow_every=3, serve_min_samples=2,
                                      synchronous=True))):
        assert tuner.serve_step(2, 16)["state"] == "miss"
        tuner.daemon.pump()
        info = tuner.serve_step(2, 16)
        assert info["state"] == TUNED
        assert info["executed"] == 0 and info["cold_banked"] == 0
        assert tuner.knobs_for(2, 16).name == info["winner"]
        winners.append(info["winner"])
        tuner.close(checkpoint=False)
    assert winners == [offline.chosen.name] * 2


def test_daemon_buckets_with_the_engine_function():
    from repro_torch.serve.engine import Engine, bucket_length

    class _FakeEngine:
        class sc:
            prompt_buckets = (16, 32, 64)

    for n in (1, 16, 17, 32, 50, 64, 100):
        assert Engine._bucket(_FakeEngine(), n) == \
            bucket_length(n, (16, 32, 64))
    tuner = ServingTuner(ARCH, seq_buckets=(16, 32),
                         provider=LMShapeProvider(device="cpu"))
    for n in (1, 16, 17, 24, 32, 100):
        key, meta = tuner.shape_of(2, n)
        assert meta["seq"] == bucket_length(n, (16, 32))
        assert key == shape_key(ARCH, 2, bucket_length(n, (16, 32)))
    tuner.close(checkpoint=False)


def test_cli_daemon_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    summary = main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--daemon", "--rounds", "2"])
    assert summary["shapes"] == 3 and summary["drift_detected"]
    assert summary["steady_state_counters"]["cold_banked_exec"] == 0
    out = capsys.readouterr().out
    assert "hit ratio" in out and "2nd tuned serve" in out


def test_cli_daemon_tunes_the_ssm_family_on_the_cpu(capsys):
    """The daemon's per-shape studies construct for reduced xlstm-125m
    (mLSTM and sLSTM thunks at ssm_chunk 8 and 32) and land a winner for
    every shape."""
    from repro_torch.launch.serve import main
    summary = main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                    "--daemon", "--rounds", "2"])
    winners = [v["winner"] for v in summary["second_tuned_serves"].values()]
    assert len(winners) == 3 and all(
        w and w.endswith(("-ssm8", "-ssm32")) for w in winners)
    assert summary["steady_state_counters"]["cold_banked_exec"] == 0
    assert "study_failed" not in {e["event"] for e in summary["events"]}
    assert "hit ratio" in capsys.readouterr().out


def test_provider_wants_the_card_by_default():
    meta = {"arch": ARCH, "batch": 2, "seq": 16}
    if torch.cuda.is_available():
        assert LMShapeProvider().study(meta).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMShapeProvider().study(meta)
    assert LMShapeProvider(device="cpu").study(meta).device.type == "cpu"


# -- lazy state shared by two threads ----------------------------------------

def _race(n_threads, fn):
    """Run ``fn`` on ``n_threads`` threads released together, with a short
    switch interval; returns their results."""
    barrier = threading.Barrier(n_threads)
    results = [None] * n_threads

    def run(i):
        barrier.wait()
        results[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return results


def test_study_kernel_is_built_once_under_threads():
    study = LMStudy(ARCH, batch=2, seq=16, device="cpu")
    knobs = study.search_space(1).points[0].payload
    sig, build = study._ffn_kernel("dense", 0, knobs, 2)
    builds = []

    def counted():
        builds.append(1)
        time.sleep(0.01)            # widen the check-then-build window
        return build()

    results = _race(8, lambda: study._kernel(sig, counted))
    assert len(builds) == 1
    assert all(r[0] is results[0][0] for r in results)


def test_kernel_library_is_built_and_loaded_once(monkeypatch, tmp_path):
    import _ctypes
    lib = tmp_path / "probe.so"
    builds = []

    def fake_build():
        builds.append(1)
        time.sleep(0.01)
        lib.write_bytes(open(_ctypes.__file__, "rb").read())
        return {}

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_lib_path", lambda name: lib)
    monkeypatch.setattr(_build, "build_all", fake_build)
    results = _race(8, lambda: _build.load("probe"))
    assert len(builds) == 1
    assert all(isinstance(r, ctypes.CDLL) and r is results[0]
               for r in results)


def test_scratch_keeps_the_largest_workspace_under_threads(monkeypatch):
    cpu = torch.device("cpu")
    sizes = [(1 << 16) + 4096 * i for i in range(16)]
    for _ in range(10):
        monkeypatch.setattr(_build, "_scratch", {})
        it = iter(sizes)
        lock = threading.Lock()

        def grow():
            with lock:
                n = next(it)
            ws, cnt = _build.scratch(cpu, 0, n, 1 << 12)
            return ws.numel() >= n

        assert all(_race(16, grow))
        ws, _ = _build._scratch[(None, 0)]
        assert ws.numel() >= max(sizes)
