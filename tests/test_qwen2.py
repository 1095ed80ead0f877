"""Qwen2-family support: QKV projection bias through every decode path.

Qwen2/2.5 is llama-shaped (neox rope, GQA, SwiGLU, RMSNorm) plus a bias
on the Q/K/V projections only: one extra [L, kv, (g+2)·hd] parameter
added pre-rope (``_qkv_eager`` and the serving step's batched QKV).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models import speculative as spec
from clusterfusion.ops.quant import quantize_llama_params

CFG = LlamaConfig.tiny(qkv_bias=True, n_kv_heads=2)


def _setup(cfg, seed=0, quant=None):
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    assert "bqkv_f" in params["layers"]
    # amplify the bias so a wiring miss cannot hide in tolerance
    params["layers"]["bqkv_f"] = params["layers"]["bqkv_f"] * 4.0
    if quant:
        params = quantize_llama_params(params, quant, 128)
        assert not hasattr(params["layers"]["bqkv_f"], "kind")
    kc, vc = model.init_cache(cfg)
    prompt = (jnp.arange(6, dtype=jnp.int32) * 7 + 1) % cfg.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
    return params, kc, vc, 6


def _oracle(params, toks, cfg=CFG):
    prompt = (jnp.arange(6, dtype=jnp.int32) * 7 + 1) % cfg.vocab_size
    return model.reference_logits(
        params, jnp.concatenate([prompt, jnp.asarray(toks, jnp.int32)]), cfg)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_bias_decode_fused_matches_eager(quant):
    params, kc, vc, pos0 = _setup(CFG, quant=quant)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos0, jnp.int32)
    lf, kf, _ = model.decode_step(params, kc, vc, tok, pos, CFG)
    le = _oracle(params, [7])[-1]
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale, quant
    # the appended row is what a prefill of the same tokens writes
    prompt = (jnp.arange(6, dtype=jnp.int32) * 7 + 1) % CFG.vocab_size
    kp, vp = model.init_cache(CFG)
    _, kp, _ = model.prefill(params, kp, vp,
                             jnp.concatenate([prompt, tok[None]]), CFG)
    np.testing.assert_allclose(np.asarray(kf[0, :, pos0], jnp.float32),
                               np.asarray(kp[0, :, pos0], jnp.float32),
                               atol=0.05)


def test_bias_actually_changes_logits():
    """Guard against a silently-dropped bias operand: zeroing the bias must
    change the decode output."""
    params, kc, vc, pos0 = _setup(CFG)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos0, jnp.int32)
    lb, _, _ = model.decode_step(params, kc, vc, tok, pos, CFG)
    p0 = dict(params)
    p0["layers"] = dict(params["layers"])
    p0["layers"]["bqkv_f"] = jnp.zeros_like(params["layers"]["bqkv_f"])
    kc0, vc0 = model.init_cache(CFG)
    prompt = (jnp.arange(6, dtype=jnp.int32) * 7 + 1) % CFG.vocab_size
    _, kc0, vc0 = model.prefill(p0, kc0, vc0, prompt, CFG)
    l0, _, _ = model.decode_step(p0, kc0, vc0, tok, pos, CFG)
    assert float(jnp.max(jnp.abs(lb - l0))) > 1e-3


def test_bias_verify_fused_matches_eager():
    params, kc, vc, pos0 = _setup(CFG, seed=3)
    toks = (jnp.arange(4, dtype=jnp.int32) * 3 + 2) % CFG.vocab_size
    pos = jnp.asarray(pos0, jnp.int32)
    lf, _, _ = spec.verify_step(params, kc, vc, toks, pos, CFG)
    le = _oracle(params, toks)[pos0:]
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.08 * scale


def test_bias_prefill_flash_matches_eager():
    cfg = CFG
    params = model.init_params(cfg, jax.random.PRNGKey(9))
    params["layers"]["bqkv_f"] = params["layers"]["bqkv_f"] * 4.0
    kc, vc = model.init_cache(cfg)
    toks = (jnp.arange(40, dtype=jnp.int32) * 13 + 1) % cfg.vocab_size
    lf, kf, _ = model.prefill(params, kc, vc, toks, cfg)
    le = model.reference_logits(params, toks, cfg)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale


def test_fuse_qkv_bias_layout():
    """fuse_qkv_bias's grouped columns must line up with
    fuse_attention_weights': project with weights+bias the torch way and
    compare against the fused-layout eager path."""
    cfg = LlamaConfig.tiny(qkv_bias=True, n_kv_heads=2)
    kv, g, hd, h = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, \
        cfg.head_dim_, cfg.hidden_dim
    ks = jax.random.split(jax.random.PRNGKey(4), 8)
    wq = jax.random.normal(ks[0], (cfg.n_heads * hd, h), jnp.float32) * 0.1
    wk = jax.random.normal(ks[1], (kv * hd, h), jnp.float32) * 0.1
    wv = jax.random.normal(ks[2], (kv * hd, h), jnp.float32) * 0.1
    wo = jax.random.normal(ks[3], (h, cfg.n_heads * hd), jnp.float32) * 0.1
    bq = jax.random.normal(ks[4], (cfg.n_heads * hd,), jnp.float32)
    bk = jax.random.normal(ks[5], (kv * hd,), jnp.float32)
    bv = jax.random.normal(ks[6], (kv * hd,), jnp.float32)
    x = jax.random.normal(ks[7], (1, 1, h), jnp.float32)

    wqkv_f, _ = model.fuse_attention_weights(wq, wk, wv, wo, cfg)
    bqkv_f = model.fuse_qkv_bias(bq, bk, bv, cfg)
    q, k, v = model._qkv_eager(x, wqkv_f, cfg, bqkv_f)

    # torch-side truth: y = x @ W.T + b, heads split kv-major
    q_t = (x[0] @ wq.T + bq).reshape(1, kv, g, hd)
    k_t = (x[0] @ wk.T + bk).reshape(1, kv, hd)
    v_t = (x[0] @ wv.T + bv).reshape(1, kv, hd)
    np.testing.assert_allclose(np.asarray(q[0], np.float32),
                               np.asarray(q_t, np.float32), atol=2e-2)
    np.testing.assert_allclose(np.asarray(k[0], np.float32),
                               np.asarray(k_t, np.float32), atol=2e-2)
    np.testing.assert_allclose(np.asarray(v[0], np.float32),
                               np.asarray(v_t, np.float32), atol=2e-2)


def test_bias_serving_matches_single_seq():
    """Continuous-batching serving with QKV bias must equal the
    single-sequence greedy decode."""
    from clusterfusion.runtime.serving import ServingEngine
    cfg = LlamaConfig.tiny(max_seq_len=64, qkv_bias=True, n_kv_heads=2)
    params = model.init_params(cfg, jax.random.PRNGKey(12))
    params["layers"]["bqkv_f"] = params["layers"]["bqkv_f"] * 4.0

    def ref_greedy(prompt, n_gen):
        kc, vc = model.init_cache(cfg)
        logits, kc, vc = model.prefill(params, kc, vc,
                                       jnp.asarray(prompt, jnp.int32), cfg)
        toks = [int(jnp.argmax(logits[len(prompt) - 1]))]
        pos = len(prompt)
        for _ in range(n_gen - 1):
            lg, kc, vc = model.decode_step(
                params, kc, vc, jnp.asarray(toks[-1], jnp.int32),
                jnp.asarray(pos, jnp.int32), cfg)
            toks.append(int(jnp.argmax(lg)))
            pos += 1
        return toks

    prompts = {0: [1, 2, 3], 1: [4, 5, 6, 7, 8]}
    eng = ServingEngine(params, cfg, page_size=8, num_pages=64, max_batch=4)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    for rid, p in prompts.items():
        assert out[rid] == ref_greedy(p, 4), rid


def test_qwen2_preset_geometry():
    cfg = LlamaConfig.qwen2_7b()
    assert cfg.qkv_bias and cfg.rope_style == "neox"
    assert cfg.qkv_dim == (28 + 2 * 4) * 128
    assert cfg.kv_heads == 4 and cfg.vocab_size == 152064
    assert cfg.rope_theta == 1000000.0


def test_qwen2_hf_loader_use_sliding_window_gate(tmp_path):
    """Qwen2/2.5 HF configs ship sliding_window=131072 with
    use_sliding_window=false — the loader must leave windowing OFF
    (advisor r4: a spuriously-windowed Qwen2 got windowed kernels,
    rolling-buffer serving, and an sp-decode hard error), while honoring
    a genuinely-enabled window and the mistral-style configs that have no
    use_sliding_window key at all."""
    import json
    from safetensors.numpy import save_file
    from clusterfusion.models.checkpoint import load_hf_checkpoint

    h, heads, kvh, hd, f, L, V = 256, 2, 1, 128, 512, 1, 512
    rng = np.random.RandomState(0)
    st = {"model.embed_tokens.weight":
          rng.randn(V, h).astype(np.float32) * 0.02,
          "model.norm.weight": rng.randn(h).astype(np.float32) * 0.1,
          "lm_head.weight": rng.randn(V, h).astype(np.float32) * 0.02}
    p = "model.layers.0."
    st[p + "self_attn.q_proj.weight"] = \
        rng.randn(heads * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.k_proj.weight"] = \
        rng.randn(kvh * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.v_proj.weight"] = \
        rng.randn(kvh * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.o_proj.weight"] = \
        rng.randn(h, heads * hd).astype(np.float32) * 0.05
    for nm in ("q", "k", "v"):
        st[p + f"self_attn.{nm}_proj.bias"] = \
            rng.randn(st[p + f"self_attn.{nm}_proj.weight"].shape[0]
                      ).astype(np.float32) * 0.05
    st[p + "mlp.gate_proj.weight"] = \
        rng.randn(f, h).astype(np.float32) * 0.05
    st[p + "mlp.up_proj.weight"] = rng.randn(f, h).astype(np.float32) * 0.05
    st[p + "mlp.down_proj.weight"] = rng.randn(h, f).astype(np.float32) * 0.05
    st[p + "input_layernorm.weight"] = rng.randn(h).astype(np.float32) * 0.1
    st[p + "post_attention_layernorm.weight"] = \
        rng.randn(h).astype(np.float32) * 0.1

    base = {"model_type": "qwen2", "hidden_size": h,
            "num_attention_heads": heads, "num_key_value_heads": kvh,
            "head_dim": hd, "intermediate_size": f, "num_hidden_layers": L,
            "vocab_size": V, "rms_norm_eps": 1e-6, "rope_theta": 10000.0}
    for name, extra, want in [
            # the real Qwen2.5 shape: giant window, gate false -> OFF
            ("off", {"sliding_window": 131072,
                     "use_sliding_window": False}, 0),
            # gate true -> honored
            ("on", {"sliding_window": 64, "use_sliding_window": True}, 64),
            # mistral-style: no gate key -> honored (default True)
            ("nokey", {"sliding_window": 48}, 48)]:
        d = tmp_path / name
        d.mkdir()
        save_file(st, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps({**base, **extra}))
        params, cfg = load_hf_checkpoint(str(d), max_seq_len=128)
        assert cfg.sliding_window == want, (name, cfg.sliding_window)
        assert cfg.qkv_bias and "bqkv_f" in params["layers"]


def test_hf_window_max_window_layers():
    """HF semantics window only layers >= max_window_layers; the loader
    handles the degenerate cases exactly (mwl >= L -> fully off, mwl == 0
    -> fully on) and rejects a genuinely mixed stack, which has no
    matching kernel window_pattern."""
    import pytest
    from clusterfusion.models.checkpoint import _hf_window

    base = {"sliding_window": 64, "use_sliding_window": True,
            "num_hidden_layers": 8}
    assert _hf_window(base) == 64                       # no mwl key
    assert _hf_window({**base, "max_window_layers": 0}) == 64
    assert _hf_window({**base, "max_window_layers": 8}) == 0   # all full
    assert _hf_window({**base, "max_window_layers": 12}) == 0
    assert _hf_window({**base, "use_sliding_window": False,
                       "max_window_layers": 4}) == 0    # gate wins
    assert _hf_window({**base, "sliding_window": None}) == 0
    with pytest.raises(NotImplementedError):
        _hf_window({**base, "max_window_layers": 4})    # mixed stack
