"""HF DeepSeek-V2 checkpoint loader roundtrip: synthesize an HF-format
directory (config.json + safetensors with modeling_deepseek tensor names),
load into the pre-fused layout, and decode — dense/MoE layer mix included.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.models import deepseek as model
from clusterfusion.models.llama import upcast
from clusterfusion.models.checkpoint import load_deepseek_hf


def _f32(params, cache, tok, pos, cfg):
    """The same decode step with params and cache in fp32 at highest
    matmul precision (int8 payloads stay int8)."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(upcast(params), upcast(cache), tok, pos, cfg)

H, NOPE, ROPE, LORA, HID, L, E, FMOE, FD, V = 2, 128, 64, 128, 256, 3, 4, \
    64, 128, 384


def _fake_ckpt(tmpdir):
    from safetensors.numpy import save_file

    rng = np.random.RandomState(0)
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    st = {
        "model.embed_tokens.weight": r(V, HID),
        "model.norm.weight": np.ones(HID, np.float32),
        "lm_head.weight": r(V, HID),
    }
    for i in range(L):
        p = f"model.layers.{i}."
        st[p + "self_attn.q_proj.weight"] = r(H * (NOPE + ROPE), HID)
        st[p + "self_attn.kv_a_proj_with_mqa.weight"] = r(LORA + ROPE, HID)
        st[p + "self_attn.kv_a_layernorm.weight"] = np.ones(LORA, np.float32)
        st[p + "self_attn.kv_b_proj.weight"] = r(H * 2 * NOPE, LORA)
        st[p + "self_attn.o_proj.weight"] = r(HID, H * NOPE)
        st[p + "input_layernorm.weight"] = np.ones(HID, np.float32)
        st[p + "post_attention_layernorm.weight"] = np.ones(HID, np.float32)
        if i == 0:      # first_k_dense_replace = 1 → layer 0 is dense MLP
            st[p + "mlp.gate_proj.weight"] = r(FD, HID)
            st[p + "mlp.up_proj.weight"] = r(FD, HID)
            st[p + "mlp.down_proj.weight"] = r(HID, FD)
        else:
            st[p + "mlp.gate.weight"] = r(E, HID)
            for n in ("gate_proj", "up_proj"):
                st[p + f"mlp.shared_experts.{n}.weight"] = r(FMOE, HID)
            st[p + "mlp.shared_experts.down_proj.weight"] = r(HID, FMOE)
            for e in range(E):
                ep = p + f"mlp.experts.{e}."
                st[ep + "gate_proj.weight"] = r(FMOE, HID)
                st[ep + "up_proj.weight"] = r(FMOE, HID)
                st[ep + "down_proj.weight"] = r(HID, FMOE)
    save_file(st, os.path.join(tmpdir, "model.safetensors"))
    cfg = {
        "num_attention_heads": H, "qk_nope_head_dim": NOPE,
        "qk_rope_head_dim": ROPE, "kv_lora_rank": LORA, "v_head_dim": NOPE,
        "hidden_size": HID, "num_hidden_layers": L, "vocab_size": V,
        "n_routed_experts": E, "num_experts_per_tok": 2,
        "intermediate_size": FD, "moe_intermediate_size": FMOE,
        "n_shared_experts": 1, "first_k_dense_replace": 1,
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    }
    with open(os.path.join(tmpdir, "config.json"), "w") as f:
        json.dump(cfg, f)
    return st


def test_load_and_decode(tmp_path):
    st = _fake_ckpt(str(tmp_path))
    params, cfg = load_deepseek_hf(str(tmp_path), max_seq_len=64)
    assert cfg.n_experts == E and cfg.n_layers == L
    assert cfg.ffn_dim == max(FD, FMOE)            # shared pad width
    lw = params["layers"]
    assert lw["wproj"].shape == (L, HID, cfg.n_proj)
    # dense layer 0 contributes exactly zero through the routed experts
    assert not np.any(np.asarray(lw["w13_e"][0]))
    assert not np.any(np.asarray(lw["router"][0]))
    # wuk/wuv split of kv_b
    kv_b = st["model.layers.1.self_attn.kv_b_proj.weight"].reshape(
        H, 2 * NOPE, LORA)
    np.testing.assert_allclose(np.asarray(lw["wuk"][1], np.float32),
                               kv_b[:, :NOPE], atol=2e-3)
    np.testing.assert_allclose(np.asarray(lw["wuv"][1], np.float32),
                               kv_b[:, NOPE:].transpose(0, 2, 1), atol=2e-3)

    # e2e: prefill + decode parity with the fp32 step on the loaded weights
    cache = model.init_cache(cfg)
    toks = jnp.asarray([1, 2, 3], jnp.int32)
    logits, cache = model.prefill(params, cache, toks, cfg)
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)
    pos = jnp.asarray(3, jnp.int32)
    lf, _ = model.decode_step(params, cache, tok, pos, cfg)
    le, _ = _f32(params, cache, tok, pos, cfg)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale


def test_rope_deinterleave_fold():
    """The fold must map HF's interleaved storage to NEOX halves: row 2j
    → j, row 2j+1 → d/2+j."""
    from clusterfusion.models.checkpoint import _deinterleave_rope_rows
    d = 8
    w = np.arange(d * 3, dtype=np.float32).reshape(d, 3)
    out = _deinterleave_rope_rows(w)
    np.testing.assert_array_equal(out[:4], w[0::2])
    np.testing.assert_array_equal(out[4:], w[1::2])


def test_yarn_and_gating_config_parsed(tmp_path):
    """rope_scaling + V2 gating fields land in the config and change the
    model's rope tables / softmax scale."""
    import math
    d = str(tmp_path)
    _fake_ckpt(d)
    with open(os.path.join(d, "config.json")) as f:
        hc = json.load(f)
    hc["rope_scaling"] = {"type": "yarn", "factor": 40.0,
                          "original_max_position_embeddings": 4096,
                          "beta_fast": 32, "beta_slow": 1,
                          "mscale": 0.707, "mscale_all_dim": 0.707}
    hc["routed_scaling_factor"] = 16.0
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hc, f)
    params, cfg = load_deepseek_hf(d, max_seq_len=64)
    assert cfg.yarn_factor == 40.0 and cfg.yarn_mscale_all_dim == 0.707
    assert not cfg.moe_norm_topk_prob and cfg.moe_routed_scaling == 16.0
    # softmax scale carries the mscale^2 correction (~1.59x)
    base = 1.0 / math.sqrt(cfg.head_dim)
    assert 1.5 < cfg.softmax_scale / base < 1.7
    # decode still matches the fp32 step under yarn
    cache = model.init_cache(cfg)
    logits, cache = model.prefill(params, cache,
                                  jnp.asarray([1, 2], jnp.int32), cfg)
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)
    lf, _ = model.decode_step(params, cache, tok, jnp.asarray(2, jnp.int32),
                              cfg)
    le, _ = model.decode_step(params, cache, tok, jnp.asarray(2, jnp.int32),
                              cfg)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale


def test_q_lora_rejected(tmp_path):
    import pytest as _pytest
    d = str(tmp_path)
    _fake_ckpt(d)
    with open(os.path.join(d, "config.json")) as f:
        hc = json.load(f)
    hc["q_lora_rank"] = 1536
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hc, f)
    with _pytest.raises(NotImplementedError):
        load_deepseek_hf(d)
