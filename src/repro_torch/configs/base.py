"""Architecture configuration schema + the four assigned input shapes.

The port's own copy of ``repro.configs.base`` (it imports nothing of the
JAX package); the schema is plain dataclasses and needs no framework.

Every assigned architecture is expressed as an ArchConfig; the model code
(models/model.py) consumes only this schema.  ``reduced()`` produces the
small same-family variant used by the per-arch CPU smoke tests; the full
configs are exercised only via the dry-run (ShapeDtypeStruct, no
allocation).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, Shape] = {
    "train_4k":    Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  Shape("decode_32k", 32768, 128, "decode"),
    "long_500k":   Shape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    d_rope: int = 64
    d_nope: int = 128
    d_v: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # layer pattern: kinds within one scan period, cycled over n_layers.
    # kinds: 'attn', 'mla', 'mamba', 'mlstm', 'slstm'
    pattern: Tuple[str, ...] = ("attn",)
    # ffn kind per pattern position: 'dense' | 'moe' | 'none'
    ffn_pattern: Tuple[str, ...] = ("dense",)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    d_head: int = 0           # 0 => d_model // n_heads
    # ssm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # frontend stubs
    n_codebooks: int = 0      # musicgen: EnCodec codebooks
    n_patches: int = 0        # internvl2: ViT patch embeddings (stubbed)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # whether attention is full/quadratic (drives the long_500k skip)
    subquadratic: bool = False
    tie_embeddings: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} % period {len(self.pattern)}"
        assert len(self.pattern) == len(self.ffn_pattern)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    # -- parameter counting (used for MODEL_FLOPS and roofline) -------------

    def param_counts(self) -> Dict[str, float]:
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KV, dh = self.n_heads, self.n_kv_heads, self.head_dim
        per_kind: Dict[str, float] = {}
        mixer = {}
        mixer["attn"] = D * (H * dh) + 2 * D * (KV * dh) + (H * dh) * D
        if self.mla:
            m = self.mla
            mixer["mla"] = (D * m.q_lora + m.q_lora * H * (m.d_nope + m.d_rope)
                            + D * (m.kv_lora + m.d_rope)
                            + m.kv_lora * H * (m.d_nope + m.d_v)
                            + H * m.d_v * D)
        di = self.d_inner
        mixer["mamba"] = (D * 2 * di + di * self.d_conv
                          + di * (di // 16 + 2 * self.d_state)
                          + (di // 16) * di + 2 * di + di * D)
        mixer["mlstm"] = D * 3 * di + 3 * di + di * D + D * 2 * di + di * D
        mixer["slstm"] = 4 * D * D + 4 * D + D * 2 * di + di * D
        ffn = {"dense": 3 * D * F, "none": 0.0}
        if self.moe:
            e = self.moe
            ffn["moe"] = ((e.n_experts + e.n_shared) * 3 * D * e.d_ff_expert
                          + D * e.n_experts)
            ffn["moe_active"] = ((e.top_k + e.n_shared) * 3 * D * e.d_ff_expert
                                 + D * e.n_experts)
        total = 0.0
        active = 0.0
        for kind, fk in zip(self.pattern, self.ffn_pattern):
            total += mixer[kind] + ffn[fk]
            active += mixer[kind] + ffn.get(
                fk + "_active", ffn[fk]) if fk == "moe" else mixer[kind] + ffn[fk]
        total *= self.n_periods
        active *= self.n_periods
        n_embed_tables = max(self.n_codebooks, 1)
        embed = n_embed_tables * V * D
        head = D * V * n_embed_tables if not self.tie_embeddings else 0.0
        return {"total": total + embed + head,
                "active": active + embed + head,
                "body": total, "body_active": active,
                "embed": embed + head}

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests: fewer/narrower
        layers, few experts, tiny vocab — same structure."""
        period = self.period
        moe = None
        if self.moe:
            moe = replace(self.moe, n_experts=4,
                          top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                          n_shared=min(self.moe.n_shared, 1))
        mla = None
        if self.mla:
            mla = MLAConfig(kv_lora=32, q_lora=48, d_rope=8, d_nope=16, d_v=16)
        dh = 8
        return replace(
            self, n_layers=period * 2, d_model=64,
            n_heads=min(self.n_heads, 4), n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128 if self.d_ff else 0, vocab=256,
            moe=moe, mla=mla, d_head=dh, d_state=4, d_conv=4,
            n_patches=8 if self.n_patches else 0)


def supported_shapes(cfg: ArchConfig) -> List[str]:
    """The runnable (arch x shape) cells.  long_500k requires sub-quadratic
    attention (skip for pure full-attention archs, DESIGN.md §4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
