"""core — the statistics of the paper's selective execution, as far as the
wall-clock tuning loop needs them: kernel signatures, per-kernel running
statistics with their confidence intervals, and the skipping policies.

Verbatim copies of ``repro.core.{signatures,stats,policies}`` (only
``repro.`` imports rewritten; ``tests/test_torch_copies.py`` holds them to
the originals).  The simulator's ``Critter`` and its engine are not ported.
"""

from .signatures import (Signature, SignatureInterner, comp_sig, comm_sig,
                         p2p_sig, flops_of, bytes_of)
from .stats import KernelStats, t_quantile_975
from .policies import POLICIES, Policy, policy

__all__ = [
    "Signature", "SignatureInterner", "comp_sig", "comm_sig", "p2p_sig",
    "flops_of", "bytes_of",
    "KernelStats", "t_quantile_975",
    "POLICIES", "Policy", "policy",
]
