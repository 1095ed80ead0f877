"""Configuration dataclasses.

The reference scatters configuration across compile-time macros
(`include/H100/llama/config.h`, `include/H100/deepseek/config.h`,
`include/H100/norm/config.h`), an env var (`USE_CLUSTER_FUSION`,
`chat/llama/model.py:273`), and CLI flags (`chat/chat.py:8-16`) — and needs a
recompile to change model geometry.  Here everything is a runtime
dataclass: model geometry is static to ``jax.jit``, and the mesh config
drives `jax.sharding`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family model geometry (≈ reference `config.h:2-5` + ModelArgs,
    `chat/llama/model.py:22-34`)."""

    hidden_dim: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None  # GQA; None → MHA (= n_heads)
    head_dim: Optional[int] = None
    ffn_dim: int = 11008              # SwiGLU intermediate size
    n_layers: int = 32
    vocab_size: int = 32000
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    # "neox" (rotate-half, sglang kernels) or "gptj" (interleaved, meta llama)
    rope_style: str = "gptj"
    # Sliding-window attention (Mistral semantics): a token at position p
    # attends positions >= p+1-window only.  0 = full context (the
    # reference supports full context only).
    sliding_window: int = 0
    # Which layers the sliding window applies to: "all" (mistral) or
    # "even" (gemma-2 interleaved local/global: even layers windowed, odd
    # layers full-context).
    window_pattern: str = "all"
    # QKV projection bias (Qwen2 family; llama/mistral have none).
    qkv_bias: bool = False
    # Gated-FFN activation: "silu" (SwiGLU — llama/mistral/qwen) or
    # "gelu_tanh" (GeGLU — gemma).
    ffn_act: str = "silu"
    # Gemma-2 sandwich norms: extra RMSNorms on the attention output
    # (post_attention_layernorm) and the FFN output
    # (post_feedforward_layernorm), applied BEFORE their residual adds.
    # Adds per-layer "post_attn_norm"/"post_ffn_norm" [L, hidden] params.
    sandwich_norms: bool = False
    # Gemma-2 logit softcapping: s -> cap*tanh(s/cap) on attention logits
    # (pre-mask) and on final LM logits.  0.0 = off.
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # Llama-3.1/3.2 rope frequency rescale (HF rope_scaling
    # rope_type="llama3"): factor > 1 enables; long wavelengths divide by
    # `factor`, short ones keep, with a smooth band between (see
    # ops.rope.llama3_scaled_inv_freq).  A build-time table transform —
    # every kernel path inherits it through model.rope_table.
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_orig_max_pos: int = 8192

    @property
    def llama3_scaling(self):
        """(factor, low, high, orig_max) for ops.rope, or None."""
        if self.rope_scaling_factor > 1.0:
            return (self.rope_scaling_factor, self.rope_low_freq_factor,
                    self.rope_high_freq_factor, self.rope_orig_max_pos)
        return None

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_dim // self.n_heads

    @property
    def qkv_dim(self) -> int:
        return (self.n_heads + 2 * self.kv_heads) * self.head_dim_

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=5120, n_heads=40, ffn_dim=13824, n_layers=40)

    @staticmethod
    def llama2_70b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=8192, n_heads=64, n_kv_heads=8,
                           ffn_dim=28672, n_layers=80)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=4096, n_heads=32, n_kv_heads=8,
                           ffn_dim=14336, n_layers=32, vocab_size=128256,
                           rope_theta=500000.0, norm_eps=1e-5,
                           rope_style="neox")

    @staticmethod
    def llama31_8b() -> "LlamaConfig":
        # Llama-3.1-8B: 3.0 geometry + the "llama3" rope frequency rescale
        # (HF rope_scaling: factor 8, low 1, high 4, orig 8192)
        import dataclasses as _dc
        return _dc.replace(LlamaConfig.llama3_8b(),
                           rope_scaling_factor=8.0,
                           rope_low_freq_factor=1.0,
                           rope_high_freq_factor=4.0,
                           rope_orig_max_pos=8192)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        # Mistral-7B-v0.1: sliding_window=4096 (HF config.json)
        return LlamaConfig(hidden_dim=4096, n_heads=32, n_kv_heads=8,
                           ffn_dim=14336, n_layers=32, vocab_size=32000,
                           rope_theta=10000.0, rope_style="neox",
                           sliding_window=4096)

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        # Qwen2/2.5-7B (HF config.json): QKV bias, tied rope at 1e6
        return LlamaConfig(hidden_dim=3584, n_heads=28, n_kv_heads=4,
                           ffn_dim=18944, n_layers=28, vocab_size=152064,
                           rope_theta=1000000.0, norm_eps=1e-6,
                           rope_style="neox", qkv_bias=True)

    @staticmethod
    def gemma2_9b() -> "LlamaConfig":
        # Gemma-2-9B (HF config.json): GeGLU FFN, sandwich norms, logit
        # softcaps, interleaved local(4096)/global attention, head_dim 256
        # (query_pre_attn_scalar 256 == head_dim -> standard 1/sqrt(hd)
        # scale), norm weights stored as (1+w) at load, embeddings scaled
        # by sqrt(hidden) at load, LM head tied to the UNSCALED embedding.
        return LlamaConfig(hidden_dim=3584, n_heads=16, n_kv_heads=8,
                           head_dim=256, ffn_dim=14336, n_layers=42,
                           vocab_size=256000, norm_eps=1e-6,
                           rope_theta=10000.0, rope_style="neox",
                           sliding_window=4096, window_pattern="even",
                           ffn_act="gelu_tanh", sandwich_norms=True,
                           attn_logit_softcap=50.0,
                           final_logit_softcap=30.0)

    @staticmethod
    def tinyllama_1b() -> "LlamaConfig":
        return LlamaConfig(hidden_dim=2048, n_heads=32, n_kv_heads=4,
                           head_dim=64, ffn_dim=5632, n_layers=22,
                           vocab_size=32000, rope_style="neox")

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small geometry for tests (head_dim 128)."""
        defaults = dict(hidden_dim=512, n_heads=4, ffn_dim=1024, n_layers=2,
                        vocab_size=384, max_seq_len=256)
        defaults.update(kw)
        return LlamaConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    """DeepSeek-V2(-lite) MLA geometry (≈ reference `deepseek/config.h:1-8`).

    Unlike the reference, seq len is a runtime quantity, not a compile-time
    macro (`deepseek/config.h:9` hardcodes SEQ_LEN 4096)."""

    hidden_dim: int = 2048
    n_heads: int = 16
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    kv_lora_rank: int = 512
    norm_eps: float = 1e-6
    # model-level fields (beyond the reference, whose deepseek support is a
    # single-layer kernel prototype with no model around it)
    n_layers: int = 27
    ffn_dim: int = 10944
    vocab_size: int = 102400
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    # MoE (DeepSeek-V2 interleaves MLA with routed-expert FFN; the
    # reference has no FFN/MoE path at all).  n_experts=0 → dense FFN;
    # n_experts>0 → ffn_dim acts as the shared-expert width and each of
    # the n_experts routed experts has moe_ffn_dim columns.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_ffn_dim: int = 1408
    # gating convention: V2/V2-Lite configs set norm_topk_prob=false with a
    # routed_scaling_factor (16.0 / 1.0); V3 renormalizes the top-k probs
    moe_norm_topk_prob: bool = True
    moe_routed_scaling: float = 1.0
    # YaRN rope scaling (V2/V2-Lite ship {type: yarn, factor 40, ...});
    # yarn_factor <= 1 disables.  mscale_all_dim feeds the softmax scale
    # (HF multiplies head_dim**-0.5 by get_mscale(factor, mscale_all)^2).
    yarn_factor: float = 1.0
    yarn_orig_max: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim

    @property
    def softmax_scale(self) -> float:
        import math
        base = 1.0 / math.sqrt(self.head_dim)
        if self.yarn_factor > 1.0:
            from clusterfusion.ops.rope import yarn_softmax_scale_mult
            base *= yarn_softmax_scale_mult(self.yarn_factor,
                                            self.yarn_mscale_all_dim)
        return base

    @property
    def mla_head_dim(self) -> int:
        return self.kv_lora_rank + self.rope_head_dim

    @property
    def n_proj(self) -> int:
        """Fused projection width: q_nope | q_pe | ckv | k_pe."""
        return (self.n_heads * self.head_dim
                + self.kv_lora_rank + self.rope_head_dim)

    @staticmethod
    def tiny(**kw) -> "DeepSeekConfig":
        """Small geometry for tests (lora 128, rope 64)."""
        defaults = dict(hidden_dim=512, n_heads=4, nope_head_dim=128,
                        rope_head_dim=64, kv_lora_rank=128, n_layers=2,
                        ffn_dim=1024, vocab_size=384, max_seq_len=256)
        defaults.update(kw)
        return DeepSeekConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for multi-device / multi-host execution.

    Within a host every GPU reaches every other over NVLink at the same
    rate, so the axes follow the algorithm alone.  Axes (outermost first):

    - ``dcn``: the cross-host axis.  Collectives over it ride the slower
      host network, so only *data parallelism* maps onto it: batch rows for
      training, whole requests for serving.  Weights are replicated over
      dcn; tp/sp collectives never cross it.
    - ``pp``: pipeline parallelism (layer stages; GPipe microbatch schedule,
      `parallel.pp.make_pp_train_step`) — activations ppermute stage→stage.
    - ``dp``: intra-host data parallelism (batch).
    - ``tp``: tensor parallelism (attention heads + ffn columns).
    - ``ep``: expert parallelism (MoE expert arrays sharded on their leading
      axis; `parallel.ep.make_ep_moe_ffn`).  Dense models leave it 1; ep
      can also ride the tp axis (``axis="tp"``).
    - ``sp``: sequence parallelism (training activations + decode KV).

    The reference's only cross-device parallelism is fairscale TP over NCCL
    on the *unfused* path (`chat/llama/generation.py:86-89`).
    """

    dp: int = 1
    tp: int = 1
    sp: int = 1
    dcn: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def shape(self):
        return {"dcn": self.dcn, "pp": self.pp, "dp": self.dp,
                "tp": self.tp, "ep": self.ep, "sp": self.sp}

    @property
    def n_devices(self) -> int:
        return self.dcn * self.pp * self.dp * self.tp * self.ep * self.sp
