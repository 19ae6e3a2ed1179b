"""The share of the expert rows a decode step computes that hold a routed
pair: the program's ``moe.kept`` over ``moe.rows`` counters under
``engine.decode`` in the traced stretch (every layer of every decode step
summed; the rows are E x the capacity, padded)."""

from bench.harness.spans import expert_fill


def read(run):
    return expert_fill(run, "serve", "engine.decode")
