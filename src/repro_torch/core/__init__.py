"""core — the paper's contribution: statistical selective-execution
autotuning with online critical-path analysis (Critter)."""

from .signatures import (Signature, SignatureInterner, comp_sig, comm_sig,
                         p2p_sig, flops_of, bytes_of)
from .stats import KernelStats, t_quantile_975
from .pathset import EngineState
from .channels import Channel, ChannelRegistry, ranks_to_channel
from .policies import POLICIES, Policy, policy
from .critter import Critter, IterationReport
from .models import Extrapolator, FamilyModel
from .tuner import (Autotuner, Configuration, ConfigRecord, RacingReport,
                    Study, StudyReport)

__all__ = [
    "Signature", "SignatureInterner", "comp_sig", "comm_sig", "p2p_sig",
    "flops_of", "bytes_of",
    "KernelStats", "t_quantile_975",
    "EngineState",
    "Channel", "ChannelRegistry", "ranks_to_channel",
    "POLICIES", "Policy", "policy",
    "Critter", "IterationReport",
    "Extrapolator", "FamilyModel",
    "Autotuner", "Configuration", "ConfigRecord", "RacingReport",
    "Study", "StudyReport",
]
