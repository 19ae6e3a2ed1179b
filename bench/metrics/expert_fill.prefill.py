"""The share of the expert rows a prefill computes that hold a routed
pair: the program's ``moe.kept`` over ``moe.rows`` counters under
``engine.prefill`` in the traced stretch (every layer of every prefill
summed; about 11 prefills in the open cell)."""

from bench.harness.spans import expert_fill


def read(run):
    return expert_fill(run, "serve", "engine.prefill")
