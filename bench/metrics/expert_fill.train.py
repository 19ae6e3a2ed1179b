"""The share of the expert rows a train step computes that hold a routed
pair: the program's ``moe.kept`` over ``moe.rows`` counters under
``train.step`` in the traced steps (2; remat's recompute counts both
again, which leaves the share as it is)."""

from bench.harness.spans import expert_fill


def read(run):
    return expert_fill(run, "train", "train.step")
