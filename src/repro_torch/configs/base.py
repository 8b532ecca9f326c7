"""Model / run configuration schema.

Every assigned architecture gets one ``ModelConfig`` in its own module under
``repro.configs``; the registry in ``__init__`` resolves ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # layer pattern: one scan unit; num_layers = units * len(pattern) + rem
    # kinds: 'attn' (dense MLP), 'moe' (MoE MLP), 'mamba', 'rglru'
    pattern: Tuple[str, ...] = ("attn",)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # expert hidden dim (0 -> d_ff)
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_seq_group: int = 0         # >0: dispatch per token-group (perf opt)
    prefill_last_only: bool = False  # perf opt: unembed only the last position
    attn_shard_fallback: str = "head_dim"  # when H % model_ways != 0:
                                   # 'head_dim' (baseline) | 'replicate' (perf:
                                   # avoids the scores psum over sharded hd)
    moe_pad_experts: int = 0       # pad expert count to this (perf: enables
                                   # expert-parallel sharding when E doesn't
                                   # divide the model axis)

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # hybrid (RG-LRU)
    lru_width: int = 0             # 0 -> d_model

    # attention details
    window: int = 0                # sliding window (0 = full causal)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0

    # MLP / norms
    mlp_act: str = "swiglu"        # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = True

    # enc-dec (whisper): encoder layers with cross-attention in the decoder
    encoder_layers: int = 0
    encoder_seq: int = 1500        # stub frame count (whisper-tiny 30 s)

    # modality frontend stub: '' | 'vision' | 'audio'
    frontend: str = ""
    frontend_tokens: int = 0       # patch/frame embeddings per sample

    # numerics
    dtype: str = "bfloat16"        # activation / param dtype for dry-run
    source: str = ""               # citation

    use_pallas: bool = False       # route attention through the Pallas
                                   # kernels (TPU; interpret=True on CPU)

    # lowering controls (cost-probe mode unrolls every scan so XLA's
    # HloCostAnalysis counts each layer/round; see launch/dryrun.py)
    unroll: bool = False
    q_chunk: int = 1024            # attention query-chunk (lax.map) size
    scan_chunk: int = 64           # linear-recurrence chunk size

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type == "ssm" and not self.dt_rank:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))
        if self.arch_type == "moe" and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.arch_type == "hybrid" and not self.lru_width:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def units_and_rem(self) -> tuple:
        k = len(self.pattern)
        return self.num_layers // k, self.num_layers % k

    def reduced(self, layers: int = 2, d_model: int = 256, d_ff: int = 512,
                experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (the contract:
        <=2 layers-ish, d_model <= 512, <= 4 experts)."""
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kvh = min(self.num_kv_heads, heads) if heads else 0
        if heads:
            kvh = max(1, kvh)
            # keep the GQA ratio flavour: kv strictly less than q if original had GQA
            if self.num_kv_heads < self.num_heads and heads > 1:
                kvh = max(1, heads // 2)
        k = len(self.pattern)
        nl = max(layers, k)          # at least one full pattern unit
        nl = (nl // k) * k if nl % k == 0 else nl
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=(d_model // heads if heads else 0),
            d_ff=d_ff,
            moe_d_ff=(d_ff if self.num_experts else 0),
            vocab_size=vocab,
            num_experts=min(self.num_experts, experts) if self.num_experts else 0,
            experts_per_token=(min(self.experts_per_token, min(self.num_experts, experts))
                               if self.num_experts else 0),
            moe_capacity_factor=64.0,  # dropless at smoke scale
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            dt_rank=(-(-d_model // 16) if self.arch_type == "ssm" else 0),
            lru_width=(d_model if self.arch_type == "hybrid" else 0),
            window=min(self.window, 64) if self.window else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 32),
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
