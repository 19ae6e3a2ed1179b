"""A serving cell: the program's ``Engine`` (``serve/engine.py``: prefill,
the cache splice, decode steps over all slots, greedy) under a closed or
an open loop (``traffic.py``).

In a closed loop each client sends its next request when its last one
completes; in an open one requests arrive by the mix's gap law whatever
the engine does, and wait in its queue.  The engine admits what waits at
the start of each step.  A request's time to first token runs from its
submission (an open loop: from when it was due) to the end of its
prefill, whose logits' copy to the host ends the engine's ``prefill_s``
span: the requests one step admits are prefilled in submission order, so
the k-th one's first token arrives after the first k prefills of that
step.  Set-up runs the loop until ``warmup_completions`` requests have
completed (every kernel built and run, the requests' phases spread); the
window then runs for its seconds, and a traced run goes on under the
profiler for ``TRACE_SECONDS``.

The check: a sample drawn from the seed of the requests completed in the
window, the longest among them, each prompt with its served tokens run
through the reference once; each served token's logit is compared with
the reference's best at its position (the widest gap; where the family
allows more than one answer, as at a near tie of a routing, the least gap
of its ``candidates``).  The reference reads the prompt as the one batch
the engine's prefill made of it (an MoE's capacity group) and each decode
position alone; the family refuses slots whose decode step it could not
reproduce so (``check_slots``: for an MoE, a step that can drop pairs).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import shared as RS
from . import program, trace, weights
from .metrics import Run
from .traffic import Arrivals, Requests

# the seconds a traced run traces, and the requests the check compares
TRACE_SECONDS = 2.0
CHECK_REQUESTS = 8


class Loop:
    """The requests of a traffic mix and their records on one engine."""

    def __init__(self, eng, reqs: Requests, traffic: dict,
                 arrivals: Arrivals = None):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.eng, self.reqs = eng, reqs
        self.info = {}          # uid -> record
        self.live = set()
        now = time.perf_counter()
        self.open = traffic["loop"] == "open"
        self.arrivals = arrivals
        self.due = now
        if not self.open:
            for _ in range(traffic["clients"]):
                self._send(now)

    def _arrivals(self, now: float) -> None:
        """An open loop's requests due by ``now``, sent as of their due
        times."""
        while self.open and self.due <= now:
            self._send(self.due)
            self.due += self.arrivals.next()

    def _send(self, now: float) -> None:
        uid, toks, out = self.reqs.next()
        self.eng.submit(self.Request(uid, toks, max_new_tokens=out))
        self.info[uid] = {"n": len(toks), "out": out, "sent": now,
                          "prompt": toks}
        self.live.add(uid)

    def step(self, rec: dict) -> None:
        """One engine step; records into ``rec`` the first tokens' waits,
        the prefills, the decode tokens' positions and the completions."""
        eng = self.eng
        self._arrivals(time.perf_counter())
        if not eng.queue and not eng.active.any():
            time.sleep(max(0.0, self.due - time.perf_counter()))
            return
        admitted = [r.uid for r in eng.queue]
        n_pre = len(eng.timings["prefill_s"])
        n_dec = len(eng.timings["decode_s"])
        before = {u: len(eng.results[u].tokens) for u in self.live}
        t0 = time.perf_counter()
        eng.step()
        now = time.perf_counter()
        pre = eng.timings["prefill_s"][n_pre:]
        admitted = admitted[:len(pre)]
        done_at = t0 + np.cumsum(pre)
        for uid, t in zip(admitted, done_at):
            info = self.info[uid]
            info["first"] = t
            rec["ttft_s"].append(t - info["sent"])
            rec["prefills"].append(info["n"])
        rec["prefill_s"] += float(sum(pre))
        rec["decode_s"] += eng.timings["decode_s"][n_dec:]
        new = set(admitted)
        rows = 0
        for uid in list(self.live):
            got = len(eng.results[uid].tokens)
            had = before[uid] + (1 if uid in new else 0)
            info = self.info[uid]
            for j in range(had, got):
                rec["positions"].append(info["n"] + j - 1)
                rows += 1
            if got >= info["out"]:
                self.live.discard(uid)
                info["done"] = now
                info["tokens"] = list(eng.results[uid].tokens)
                rec["completed"].append(uid)
                rec["served"] += info["n"] + got
                if not self.open:
                    self._send(now)
        rec["decode_rows"].append(rows)


def _record():
    return {"ttft_s": [], "prefills": [], "prefill_s": 0.0, "decode_s": [],
            "positions": [], "decode_rows": [], "completed": [],
            "served": 0}


def run(cell, seed: int, seconds: float, traced: bool, device, t_start):
    from repro_torch.serve.engine import Engine, ServeConfig
    spec, tr = cell.spec, cell.traffic
    slots = tr["slots"]
    spec.family.reference.check_slots(spec, slots)
    model = program.model(spec, "none", device)
    params = weights.make(spec, seed, device)
    eng = Engine(model, params, ServeConfig(
        batch_size=slots, s_max=tr["s_max"],
        max_new_tokens=tr["output"]["max"], temperature=0.0, eos_id=None))
    loop = Loop(eng, Requests(tr, seed, spec.vocab, cell.root), tr,
                Arrivals(tr["arrival"], seed, cell.root)
                if tr["loop"] == "open" else None)
    warm = _record()
    with torch.no_grad():
        while len(warm["completed"]) < tr["warmup_completions"]:
            loop.step(warm)
        setup_s = time.perf_counter() - t_start
        rec = _record()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loop.step(rec)
        elapsed = time.perf_counter() - t0
        run_ = Run("serve", device.type, spec, tr, setup_s, window=dict(
            rec, seconds=elapsed, steps=len(rec["decode_s"]),
            backlog=len(eng.queue)))
        if traced:
            tail = _record()
            with trace.traced(device) as got:
                t1 = time.perf_counter()
                while time.perf_counter() - t1 < TRACE_SECONDS:
                    loop.step(tail)
            run_.trace = got[0]
            run_.traced = tail
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    done = [loop.info[u] for u in rec["completed"]]
    del eng, loop, model, params
    program.free(device)
    return run_, pick(done, seed, CHECK_REQUESTS), peak, \
        len(rec["completed"])


def pick(done: list, seed: int, n: int) -> list:
    """The longest completed request and n - 1 others drawn from the
    seed."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: -(done[i]["n"] + done[i]["out"]))
    rest = np.random.default_rng([seed, 3]).permutation(order[1:])
    return [done[i] for i in [order[0], *rest[:n - 1]]]


def _sequence(info, device):
    """A request's prompt and served tokens as the reference reads them:
    (tokens (1, S), its capacity groups, the positions that predicted each
    served token).  The prompt is one capacity group, the decode positions
    are uncapped."""
    n, toks = info["n"], info["tokens"]
    seq = torch.as_tensor(np.concatenate([info["prompt"], toks[:-1]]),
                          device=device)[None]
    S = seq.shape[1]
    groups = [(0, n, True)] + ([(n, S, False)] if S > n else [])
    return seq, groups, list(range(n - 1, S))


def check(cell, seed: int, device, sample: list, controls: bool = False):
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position, over the sample (the least gap
    of the answers the family allows there: its ``candidates``); with
    ``controls`` also that of the tokens the reference in float8 puts first
    at the same positions (``control.logit_gap``)."""
    spec = cell.spec
    ref = spec.family.reference
    if not sample:
        return {"logit_gap": float("inf")}
    RS.exact_f32()
    params = weights.make(spec, seed, device, torch.float32)
    worst = {"logit_gap": 0.0}
    low = RS.Precision("float8")
    with torch.no_grad():
        for info in sample:
            seq, groups, rows = _sequence(info, device)
            cands = ref.candidates(params, seq, spec, rows, groups)
            picks = {"logit_gap": info["tokens"]}
            if controls:
                picks["control.logit_gap"] = ref.logits_at(
                    params, seq, spec, rows, groups, low).argmax(1).tolist()
            for key, toks in picks.items():
                for c, t in zip(cands, toks):
                    gap = float((c.max(1).values - c[:, t]).min())
                    worst[key] = max(worst.get(key, 0.0), gap)
    return worst
