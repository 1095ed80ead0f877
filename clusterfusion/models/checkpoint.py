"""Checkpoint loading — twin of the reference's Meta-format loader
(`chat/llama/generation.py:101-120`) plus the fused-weight transform
(`chat/llama/model.py:292-328`), generalized:

- Meta llama `.pth` + `params.json` (single consolidated shard, or multiple
  model-parallel shards which are re-assembled — the reference instead picks
  one shard per rank).
- HuggingFace safetensors directories (single or indexed multi-file). HF
  checkpoints store q/k permuted for NEOX rope, so rope_style is set
  accordingly.

Weights land directly in the kernel-native fused layout (see
``models.llama.fuse_attention_weights``); nothing is kept in torch.
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models.llama import (LlamaParams, fuse_attention_weights,
                                        fuse_qkv_bias)


def _meta_ffn_dim(dim: int, multiple_of: int, ffn_dim_multiplier) -> int:
    """Meta llama FFN sizing rule (`chat/llama/model.py:413-424`)."""
    hidden = int(2 * (4 * dim) / 3)
    if ffn_dim_multiplier is not None:
        hidden = int(ffn_dim_multiplier * hidden)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)


def config_from_params_json(path: str, max_seq_len: int = 2048) -> LlamaConfig:
    with open(path) as f:
        p = json.load(f)
    dim = p["dim"]
    n_heads = p["n_heads"]
    return LlamaConfig(
        hidden_dim=dim,
        n_heads=n_heads,
        n_kv_heads=p.get("n_kv_heads"),
        ffn_dim=_meta_ffn_dim(dim, p.get("multiple_of", 256),
                              p.get("ffn_dim_multiplier")),
        n_layers=p["n_layers"],
        vocab_size=p.get("vocab_size", 32000) if p.get("vocab_size", -1) > 0 else 32000,
        norm_eps=p.get("norm_eps", 1e-5),
        rope_theta=p.get("rope_theta", 10000.0),
        max_seq_len=max_seq_len,
        rope_style="gptj",     # meta checkpoints use the complex/interleaved rope
    )


# --- Meta .pth -------------------------------------------------------------

# (key suffix, shard axis) for model-parallel reassembly; axis None = replicated
_META_SHARD_AXES = {
    "attention.wq.weight": 0, "attention.wk.weight": 0, "attention.wv.weight": 0,
    "attention.wo.weight": 1,
    "feed_forward.w1.weight": 0, "feed_forward.w3.weight": 0,
    "feed_forward.w2.weight": 1,
    "tok_embeddings.weight": 1, "output.weight": 0,
    "attention_norm.weight": None, "ffn_norm.weight": None, "norm.weight": None,
}


def _load_meta_state(ckpt_dir: str) -> Dict[str, np.ndarray]:
    import torch  # cpu-only usage: deserialize + to numpy

    paths = sorted(glob(os.path.join(ckpt_dir, "*.pth")))
    assert paths, f"no .pth checkpoints in {ckpt_dir}"
    shards = [torch.load(p, map_location="cpu", weights_only=True) for p in paths]
    state: Dict[str, np.ndarray] = {}
    for key in shards[0]:
        suffix = key.split(".", 2)[-1] if key.startswith("layers.") else key
        axis = _META_SHARD_AXES.get(suffix, None)
        if len(shards) == 1 or axis is None:
            t = shards[0][key]
        else:
            t = __import__("torch").cat([s[key] for s in shards], dim=axis)
        state[key] = t.to(torch.float32).numpy()
    return state


def load_meta_checkpoint(ckpt_dir: str, max_seq_len: int = 2048,
                         dtype=jnp.bfloat16
                         ) -> Tuple[LlamaParams, LlamaConfig]:
    """Load a Meta llama checkpoint dir (params.json + *.pth)."""
    cfg = config_from_params_json(os.path.join(ckpt_dir, "params.json"),
                                  max_seq_len)
    state = _load_meta_state(ckpt_dir)
    if "tok_embeddings.weight" in state:
        vocab = state["tok_embeddings.weight"].shape[0]
        if vocab != cfg.vocab_size:
            cfg = LlamaConfig(**{**cfg.__dict__, "vocab_size": vocab})

    def get(i, name):
        return jnp.asarray(state[f"layers.{i}.{name}"], dtype)

    wqkv_l, wo_l, w13_l, w2_l, an_l, fn_l = [], [], [], [], [], []
    for i in range(cfg.n_layers):
        wqkv_f, wo_f = fuse_attention_weights(
            get(i, "attention.wq.weight"), get(i, "attention.wk.weight"),
            get(i, "attention.wv.weight"), get(i, "attention.wo.weight"), cfg)
        wqkv_l.append(wqkv_f)
        wo_l.append(wo_f)
        w13_l.append(jnp.stack([get(i, "feed_forward.w1.weight").T,
                                get(i, "feed_forward.w3.weight").T], axis=0))
        w2_l.append(get(i, "feed_forward.w2.weight").T)
        an_l.append(get(i, "attention_norm.weight"))
        fn_l.append(get(i, "ffn_norm.weight"))

    params: LlamaParams = {
        "embed": jnp.asarray(state["tok_embeddings.weight"], dtype),
        "layers": {
            "wqkv_f": jnp.stack(wqkv_l), "wo_f": jnp.stack(wo_l),
            "w13": jnp.stack(w13_l), "w2": jnp.stack(w2_l),
            "attn_norm": jnp.stack(an_l), "ffn_norm": jnp.stack(fn_l),
        },
        "final_norm": jnp.asarray(state["norm.weight"], dtype),
        "lm_head": jnp.asarray(state["output.weight"], dtype).T,
    }
    return params, cfg


# --- HF safetensors --------------------------------------------------------


def _load_hf_state(model_dir: str) -> Dict[str, np.ndarray]:
    from safetensors import safe_open

    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
    else:
        files = [os.path.basename(p) for p in
                 glob(os.path.join(model_dir, "*.safetensors"))]
    state: Dict[str, np.ndarray] = {}
    for fname in files:
        with safe_open(os.path.join(model_dir, fname), framework="np") as f:
            for k in f.keys():
                state[k] = f.get_tensor(k)
    return state


def _hf_window(hc: dict) -> int:
    """Token window from an HF llama-family config dict (0 = full ctx).

    Honors ``use_sliding_window`` (Qwen2/2.5 ship sliding_window=131072
    with the flag false) and ``max_window_layers`` (HF windows only layers
    >= max_window_layers).  max_window_layers >= n_layers therefore means
    no layer is windowed; a strictly mixed stack has no matching
    window_pattern in the kernels ("all"/"even") and is rejected."""
    win = hc.get("sliding_window") or 0
    if not win or not hc.get("use_sliding_window", True):
        return 0
    mwl = hc.get("max_window_layers", 0) or 0
    if mwl >= hc["num_hidden_layers"]:
        return 0                       # every layer keeps full attention
    if mwl > 0:
        raise NotImplementedError(
            f"use_sliding_window with 0 < max_window_layers={mwl} < "
            f"num_hidden_layers={hc['num_hidden_layers']} needs a "
            f"first-{mwl}-layers-full window pattern; the kernels support "
            f"window_pattern 'all' and 'even' only")
    return int(win)


def load_hf_checkpoint(model_dir: str, max_seq_len: int = 2048,
                       dtype=jnp.bfloat16
                       ) -> Tuple[LlamaParams, LlamaConfig]:
    """Load an HF-format llama directory (config.json + *.safetensors)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    gemma2 = hc.get("model_type") == "gemma2"
    # Llama-3.1/3.2 frequency rescale (rope_scaling rope_type="llama3") —
    # without it every position gets wrong long-wavelength frequencies.
    # "default"/null pass through; other types are rejected loudly.
    rs = hc.get("rope_scaling") or {}
    rs_type = rs.get("rope_type", rs.get("type", "default"))
    l3 = dict(rope_scaling_factor=1.0)
    if rs and rs_type == "llama3":
        l3 = dict(
            rope_scaling_factor=float(rs.get("factor", 8.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_orig_max_pos=int(rs.get(
                "original_max_position_embeddings", 8192)))
    elif rs and rs_type != "default":
        raise NotImplementedError(
            f"rope_scaling type {rs_type!r} is not supported for "
            f"llama-family checkpoints (supported: llama3, default)")
    cfg = LlamaConfig(
        hidden_dim=hc["hidden_size"],
        n_heads=hc["num_attention_heads"],
        n_kv_heads=hc.get("num_key_value_heads"),
        head_dim=hc.get("head_dim"),
        ffn_dim=hc["intermediate_size"],
        n_layers=hc["num_hidden_layers"],
        vocab_size=hc["vocab_size"],
        norm_eps=hc.get("rms_norm_eps", 1e-5),
        rope_theta=hc.get("rope_theta", 10000.0),
        max_seq_len=max_seq_len,
        rope_style="neox",     # HF stores q/k pre-permuted for rotate-half
        # mistral-family HF configs carry sliding_window (null = full ctx).
        # Qwen2/2.5 ship sliding_window=131072 with use_sliding_window=false
        # — the window must stay OFF there (advisor r4) or a full-context
        # model gets windowed kernels, rolling-buffer serving, and a
        # spurious sp-decode error.  When use_sliding_window IS true, HF
        # semantics window only layers >= max_window_layers (the first
        # max_window_layers layers keep full attention): handled exactly
        # for the two degenerate cases (all layers windowed / none), and
        # rejected for a genuine mixed stack — the kernels implement
        # window_pattern "all"/"even", not "first-N-full".
        sliding_window=_hf_window(hc),
        # gemma-2: interleaved local/global attention, GeGLU, sandwich
        # norms, logit softcaps
        window_pattern="even" if gemma2 else "all",
        ffn_act="gelu_tanh" if gemma2 else "silu",
        sandwich_norms=gemma2,
        attn_logit_softcap=hc.get("attn_logit_softcapping") or 0.0,
        final_logit_softcap=hc.get("final_logit_softcapping") or 0.0,
        **l3,
    )
    state = _load_hf_state(model_dir)

    def get(name):
        return jnp.asarray(state[name].astype(np.float32), dtype)

    has_bias = "model.layers.0.self_attn.q_proj.bias" in state
    if has_bias:
        cfg = LlamaConfig(**{**cfg.__dict__, "qkv_bias": True})

    def norm_w(name):
        """RMSNorm weight; gemma stores w with (1+w)·normed semantics —
        fold the +1 at load so the kernels' plain w·normed applies."""
        w = get(name)
        return w + 1.0 if gemma2 else w

    # gemma-2 scales attention logits by 1/sqrt(query_pre_attn_scalar), not
    # 1/sqrt(head_dim) (27B: scalar 144 vs head_dim 128; 9B: 256 == hd).
    # The kernels hardcode 1/sqrt(hd), and RoPE commutes with a scalar, so
    # fold sqrt(hd/scalar) into the q projection columns at load — then
    # (q·f)·k/sqrt(hd) == q·k/sqrt(scalar) on every path, softcap included.
    qpas = hc.get("query_pre_attn_scalar")
    q_mult = float(np.sqrt(cfg.head_dim_ / qpas)) if (gemma2 and qpas) \
        else 1.0

    wqkv_l, wo_l, w13_l, w2_l, an_l, fn_l, bqkv_l = [], [], [], [], [], [], []
    pa_l, pf_l = [], []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        wqkv_f, wo_f = fuse_attention_weights(
            get(pre + "self_attn.q_proj.weight") * q_mult,
            get(pre + "self_attn.k_proj.weight"),
            get(pre + "self_attn.v_proj.weight"),
            get(pre + "self_attn.o_proj.weight"), cfg)
        wqkv_l.append(wqkv_f)
        wo_l.append(wo_f)
        if has_bias:
            # Qwen2-family QKV bias → wqkv_f's column layout
            bqkv_l.append(fuse_qkv_bias(
                get(pre + "self_attn.q_proj.bias") * q_mult,
                get(pre + "self_attn.k_proj.bias"),
                get(pre + "self_attn.v_proj.bias"), cfg))
        w13_l.append(jnp.stack([get(pre + "mlp.gate_proj.weight").T,
                                get(pre + "mlp.up_proj.weight").T], axis=0))
        w2_l.append(get(pre + "mlp.down_proj.weight").T)
        an_l.append(norm_w(pre + "input_layernorm.weight"))
        if gemma2:
            # gemma-2 sandwich: pre-FFN norm is its OWN weight; the name
            # "post_attention_layernorm" is the post-attn sandwich norm
            fn_l.append(norm_w(pre + "pre_feedforward_layernorm.weight"))
            pa_l.append(norm_w(pre + "post_attention_layernorm.weight"))
            pf_l.append(norm_w(pre + "post_feedforward_layernorm.weight"))
        else:
            fn_l.append(norm_w(pre + "post_attention_layernorm.weight"))

    lm_head = state.get("lm_head.weight", state["model.embed_tokens.weight"])
    embed = get("model.embed_tokens.weight")
    if gemma2:
        # gemma scales embedding OUTPUTS by sqrt(hidden); the tied LM head
        # reads the UNSCALED table, so fold the scale into `embed` only
        embed = embed * jnp.asarray(np.sqrt(cfg.hidden_dim), dtype)
    params: LlamaParams = {
        "embed": embed,
        "layers": {
            "wqkv_f": jnp.stack(wqkv_l), "wo_f": jnp.stack(wo_l),
            "w13": jnp.stack(w13_l), "w2": jnp.stack(w2_l),
            "attn_norm": jnp.stack(an_l), "ffn_norm": jnp.stack(fn_l),
        },
        "final_norm": norm_w("model.norm.weight"),
        "lm_head": jnp.asarray(lm_head.astype(np.float32), dtype).T,
    }
    if has_bias:
        params["layers"]["bqkv_f"] = jnp.stack(bqkv_l)
    if gemma2:
        params["layers"]["post_attn_norm"] = jnp.stack(pa_l)
        params["layers"]["post_ffn_norm"] = jnp.stack(pf_l)
    return params, cfg


def load_checkpoint(path: str, max_seq_len: int = 2048, dtype=jnp.bfloat16):
    """Dispatch: Meta dir (params.json) vs HF dir (config.json)."""
    if os.path.exists(os.path.join(path, "params.json")):
        return load_meta_checkpoint(path, max_seq_len, dtype)
    if os.path.exists(os.path.join(path, "config.json")):
        return load_hf_checkpoint(path, max_seq_len, dtype)
    raise FileNotFoundError(f"no params.json or config.json under {path}")


# --- HF DeepSeek-V2 --------------------------------------------------------


def _deinterleave_rope_rows(w: np.ndarray) -> np.ndarray:
    """HF DeepSeek stores rope dims interleaved and permutes at runtime
    (`modeling_deepseek.DeepseekV2Attention`: view(d/2, 2).transpose);
    fold that permutation into the rows once at load so the kernel's NEOX
    rotate-half applies directly.  w: [rope_dim, ...] row-permuted."""
    d = w.shape[0]
    return np.concatenate([w[0::2], w[1::2]], axis=0)


def load_deepseek_hf(model_dir: str, max_seq_len: int = 4096,
                     dtype=jnp.bfloat16):
    """Load an HF DeepSeek-V2-Lite-style directory into the kernel-native
    pre-fused layout of ``models.deepseek`` (wproj | wuk | wuv | wo_t).

    Layer uniformity: DeepSeek-V2 mixes dense-MLP layers
    (first_k_dense_replace) with MoE layers (shared + routed experts);
    the stacked-layer model needs uniform shapes, so the dense MLP and
    the concatenated shared experts both land in the per-layer shared
    FFN, zero-padded to the wider of the two (zero gate/up columns are
    exact SwiGLU no-ops), and dense layers carry all-zero routed experts
    and router rows (zero experts contribute exactly zero).

    YaRN rope scaling from config.json is honored (freq ramp + the
    mscale^2 softmax-scale correction).  Requires a direct q projection
    (V2-Lite; V2-proper's q-LoRA + intermediate layernorm cannot fold
    into wproj -> clear NotImplementedError) and
    v_head_dim == qk_nope_head_dim.
    Returns (params, DeepSeekConfig)."""
    from clusterfusion.config import DeepSeekConfig

    with open(os.path.join(model_dir, "config.json")) as f:
        hc = json.load(f)
    h = hc["num_attention_heads"]
    nope = hc["qk_nope_head_dim"]
    rope = hc["qk_rope_head_dim"]
    lora = hc["kv_lora_rank"]
    v_dim = hc["v_head_dim"]
    assert v_dim == nope, (v_dim, nope)
    hidden = hc["hidden_size"]
    L = hc["num_hidden_layers"]
    E = hc.get("n_routed_experts", 0) or 0
    top_k = hc.get("num_experts_per_tok", 2) or 2
    f_dense = hc["intermediate_size"]
    f_moe = hc.get("moe_intermediate_size", 0) or 0
    n_shared = hc.get("n_shared_experts", 0) or 0
    first_dense = hc.get("first_k_dense_replace", 0)
    f_shared = max(f_dense, n_shared * f_moe)

    if hc.get("q_lora_rank"):
        raise NotImplementedError(
            "DeepSeek-V2 proper uses a low-rank q projection with a "
            "layernorm between q_a_proj and q_b_proj (q_lora_rank="
            f"{hc['q_lora_rank']}), which cannot be folded into the fused "
            "wproj; only direct-q checkpoints (V2-Lite) are supported")

    rs = hc.get("rope_scaling") or {}
    yarn = dict(yarn_factor=1.0)
    if rs:
        assert rs.get("type", "yarn") == "yarn", rs
        yarn = dict(
            yarn_factor=float(rs.get("factor", 1.0)),
            yarn_orig_max=int(rs.get("original_max_position_embeddings",
                                     4096)),
            yarn_beta_fast=float(rs.get("beta_fast", 32.0)),
            yarn_beta_slow=float(rs.get("beta_slow", 1.0)),
            yarn_mscale=float(rs.get("mscale", 1.0)),
            yarn_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)))

    cfg = DeepSeekConfig(
        hidden_dim=hidden, n_heads=h, nope_head_dim=nope,
        rope_head_dim=rope, kv_lora_rank=lora,
        norm_eps=hc.get("rms_norm_eps", 1e-6), n_layers=L,
        ffn_dim=f_shared, vocab_size=hc["vocab_size"],
        max_seq_len=max_seq_len, rope_theta=hc.get("rope_theta", 10000.0),
        n_experts=E, moe_top_k=top_k, moe_ffn_dim=f_moe,
        moe_norm_topk_prob=bool(hc.get("norm_topk_prob", False)),
        moe_routed_scaling=float(hc.get("routed_scaling_factor", 1.0)),
        **yarn)

    state = _load_hf_state(model_dir)

    def npf(name):
        return state[name].astype(np.float32)

    def pad_shared(w13, w2, f):
        if f < f_shared:
            w13 = np.pad(w13, ((0, 0), (0, 0), (0, f_shared - f)))
            w2 = np.pad(w2, ((0, f_shared - f), (0, 0)))
        return w13, w2

    Ls = {k: [] for k in ("wproj", "wuk", "wuv", "wo_t", "attn_norm",
                          "ckv_norm", "w13", "w2", "ffn_norm",
                          "router", "w13_e", "w2_e")}
    for i in range(L):
        pre = f"model.layers.{i}."
        q = npf(pre + "self_attn.q_proj.weight").reshape(h, nope + rope,
                                                         hidden)
        q_nope = q[:, :nope]                               # [h, nope, hid]
        q_pe = np.stack([_deinterleave_rope_rows(q[j, nope:])
                         for j in range(h)])               # [h, rope, hid]
        kv_a = npf(pre + "self_attn.kv_a_proj_with_mqa.weight")
        ckv_w = kv_a[:lora]                                # [lora, hid]
        kpe_w = _deinterleave_rope_rows(kv_a[lora:])       # [rope, hid]
        wproj = np.concatenate([
            q_nope.reshape(h * nope, hidden).T,
            q_pe.reshape(h * rope, hidden).T,
            ckv_w.T, kpe_w.T], axis=-1)                    # [hid, n_proj]
        kv_b = npf(pre + "self_attn.kv_b_proj.weight").reshape(
            h, nope + v_dim, lora)
        Ls["wproj"].append(wproj)
        Ls["wuk"].append(kv_b[:, :nope])                   # [h, nope, lora]
        Ls["wuv"].append(kv_b[:, nope:].transpose(0, 2, 1))  # [h, lora, v]
        Ls["wo_t"].append(npf(pre + "self_attn.o_proj.weight").T)
        Ls["attn_norm"].append(npf(pre + "input_layernorm.weight"))
        Ls["ckv_norm"].append(npf(pre + "self_attn.kv_a_layernorm.weight"))
        Ls["ffn_norm"].append(npf(pre + "post_attention_layernorm.weight"))

        moe_layer = E > 0 and i >= first_dense
        if moe_layer:
            sg = [npf(pre + "mlp.shared_experts.gate_proj.weight").T]
            su = [npf(pre + "mlp.shared_experts.up_proj.weight").T]
            sd = [npf(pre + "mlp.shared_experts.down_proj.weight").T]
            w13 = np.stack([np.concatenate(sg, -1), np.concatenate(su, -1)])
            w2 = np.concatenate(sd, 0)
            w13, w2 = pad_shared(w13, w2, w13.shape[-1])
            Ls["router"].append(npf(pre + "mlp.gate.weight").T)  # [hid, E]
            e13, e2 = [], []
            for e in range(E):
                ep = pre + f"mlp.experts.{e}."
                e13.append(np.stack([npf(ep + "gate_proj.weight").T,
                                     npf(ep + "up_proj.weight").T]))
                e2.append(npf(ep + "down_proj.weight").T)
            Ls["w13_e"].append(np.stack(e13))
            Ls["w2_e"].append(np.stack(e2))
        else:
            w13 = np.stack([npf(pre + "mlp.gate_proj.weight").T,
                            npf(pre + "mlp.up_proj.weight").T])
            w2 = npf(pre + "mlp.down_proj.weight").T
            w13, w2 = pad_shared(w13, w2, w2.shape[0])
            if E:
                Ls["router"].append(np.zeros((hidden, E), np.float32))
                Ls["w13_e"].append(np.zeros((E, 2, hidden, f_moe),
                                            np.float32))
                Ls["w2_e"].append(np.zeros((E, f_moe, hidden), np.float32))
        Ls["w13"].append(w13)
        Ls["w2"].append(w2)

    layers = {k: jnp.asarray(np.stack(v), dtype)
              for k, v in Ls.items() if v}
    lm_key = ("lm_head.weight" if "lm_head.weight" in state
              else "model.embed_tokens.weight")
    params = {
        "embed": jnp.asarray(npf("model.embed_tokens.weight"), dtype),
        "layers": layers,
        "final_norm": jnp.asarray(npf("model.norm.weight"), dtype),
        "lm_head": jnp.asarray(npf(lm_key), dtype).T,
    }
    return params, cfg
