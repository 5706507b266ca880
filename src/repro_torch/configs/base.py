"""Architecture configuration: the port's copy of the reference's
``configs/base.py`` data classes.

``ArchConfig`` describes one model (layer pattern, widths, vocabulary);
``reduced()`` gives the same family at a tiny size for CPU runs.  A
config and its ``reduced()`` read field for field like the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["MoESpec", "SSMSpec", "FTSpec", "LayerSpec", "ArchConfig", "ShapeConfig", "SHAPES"]


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMSpec:
    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # ceil(d_model/16) by default
    # rwkv6
    rwkv_head_dim: int = 64
    decay_lora: int = 64


@dataclass(frozen=True)
class FTSpec:
    """Fault-tolerance parameters feeding the paper's policy (Section 5
    defaults; C, D, R, M in seconds)."""

    n_nodes: int = 512
    mu_ind: float = 125 * 365.25 * 86400.0  # individual MTBF: 125 years (s)
    C: float = 600.0  # checkpoint cost prior (s)
    D: float = 60.0  # downtime (s)
    R: float = 600.0  # recovery (s)
    M: float = 300.0  # migration cost (s)
    predictor: str = "paper-accurate"

    @property
    def mu(self) -> float:
        return self.mu_ind / self.n_nodes


@dataclass(frozen=True)
class LayerSpec:
    """One position of the repeating block pattern."""

    mixer: str  # "attn" | "mamba" | "rwkv"
    mlp: str  # "dense" | "moe" | "none" (rwkv has its own channel mix)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: Optional[MoESpec] = None
    ssm: SSMSpec = field(default_factory=SSMSpec)
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    tie_embeddings: bool = False
    # modality frontends: precomputed frame/patch embeddings of this length
    frontend: Optional[str] = None  # "audio_frames" | "vision_patches"
    frontend_prefix: int = 0
    subquadratic: bool = False
    param_dtype: str = "float32"
    optimizer: str = "adamw"
    ft: FTSpec = field(default_factory=FTSpec)
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def n_repeats(self) -> int:
        return self.num_layers // len(self.pattern)

    def shard_heads_ok(self, tp: int = 16) -> bool:
        """The head count divides a model axis of ``tp`` (attention-free:
        true), the reference's test for sharding heads."""
        if self.num_heads == 0:
            return True
        return self.num_heads % tp == 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.ssm.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings counted once)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        total = V * D + D  # embedding, final norm
        if not self.tie_embeddings:
            total += D * V  # head
        n = self.n_repeats
        for spec in self.pattern:
            if spec.mixer == "attn":
                attn = D * H * hd + 2 * D * KV * hd + H * hd * D
                if self.qkv_bias:
                    attn += (H + 2 * KV) * hd
                total += n * (attn + D)  # + norm
            elif spec.mixer == "mamba":
                din, ds = self.d_inner, self.ssm.d_state
                dtr = self.ssm.dt_rank or math.ceil(D / 16)
                m = (D * 2 * din + din * self.ssm.d_conv + din * (dtr + 2 * ds)
                     + dtr * din + din * ds + din + din * D)
                total += n * (m + D)
            elif spec.mixer == "rwkv":
                hdim, nh, lora = self.ssm.rwkv_head_dim, self.rwkv_heads, self.ssm.decay_lora
                tm = (5 * D + D * lora + lora * nh * hdim + 2 * nh * hdim
                      + 4 * D * nh * hdim + nh * hdim * D + nh * hdim)
                cm = 2 * D + D * F + F * D + D * D
                total += n * (tm + cm + 2 * D)
            if spec.mlp == "dense":
                total += n * (3 * D * F + D)
            elif spec.mlp == "moe":
                e = self.moe.num_experts
                total += n * (D * e + e * 3 * D * F + D)
                if self.moe.dense_residual:
                    total += n * 3 * D * F
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        expert_params = 0
        for spec in self.pattern:
            if spec.mlp == "moe":
                expert_params += self.n_repeats * e * 3 * self.d_model * self.d_ff
        return full - expert_params + int(expert_params * (k / e))

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU runs."""
        pat = len(self.pattern)
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=8, top_k=min(self.moe.top_k, 2))
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(pat, 2 if pat == 1 else pat),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe=moe,
            ssm=replace(self.ssm, d_state=8, rwkv_head_dim=16, decay_lora=8),
            frontend_prefix=8 if self.frontend else 0,
            param_dtype="float32",
            optimizer="adamw",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """A batch shape of a step (the reference's)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
