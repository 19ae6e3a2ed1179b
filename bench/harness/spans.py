"""The program's own spans and counters (``repro_torch.obs``) as the
per-layer metrics read them.  The program records them only while a
profiler session records, and keeps each thread's latest session: read
from the thread that ran a traced run, the traced stretch's.  A program
without ``obs`` records none, and its readers read nothing."""

from __future__ import annotations


def recorded(run, kind: str):
    """(spans, counters) of a traced run of ``kind``; None for another
    kind, an untraced run or a program without spans."""
    if run.kind != kind or run.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.spans(), obs.counters()


def under(spans, name: str, within: str) -> list:
    """The spans named ``name`` that have an ancestor named ``within``."""
    def inside(s):
        while s.parent is not None:
            s = spans[s.parent]
            if s.name == within:
                return True
        return False
    return [s for s in spans if s.name == name and inside(s)]


def device_ms_per(run, kind: str, name: str, per: str, within=None):
    """The device milliseconds of the spans ``name`` (those inside a span
    ``within``, if given) over the number of spans ``per``; None off the
    card or where either is missing."""
    got = recorded(run, kind)
    if got is None or run.device != "cuda":
        return None
    spans = got[0]
    mine = under(spans, name, within) if within \
        else [s for s in spans if s.name == name]
    n = sum(s.name == per for s in spans)
    if not mine or not n or any(s.device_ms is None for s in mine):
        return None
    return sum(s.device_ms for s in mine) / n


def expert_fill(run, kind: str, phase: str):
    """The share of the experts' computed rows that hold a routed pair
    (``moe.kept`` / ``moe.rows``) under the phase span ``phase``, in %."""
    got = recorded(run, kind)
    if got is None:
        return None
    c = got[1].get(phase, {})
    if not c.get("moe.rows"):
        return None
    return 100 * c["moe.kept"] / c["moe.rows"]
