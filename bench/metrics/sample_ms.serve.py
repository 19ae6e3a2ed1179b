"""The host's sampling after a decode step (the program's ``engine.sample``
spans of the traced stretch: each active slot's token from its logits, its
budget and retirement), mean milliseconds a decode step.  One sample a
decode step: about 13 in the closed cell's 2-s stretch."""

from bench.harness.spans import recorded


def read(run):
    got = recorded(run, "serve")
    ms = [s.ms for s in got[0] if s.name == "engine.sample"] if got else []
    return sum(ms) / len(ms) if ms else None
