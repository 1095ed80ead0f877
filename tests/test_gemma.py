"""Gemma-2 family support: GeGLU FFN, sandwich norms, logit softcapping,
interleaved local/global attention — each wired through decode, verify
and serving and validated against the fp32 oracle, plus the HF gemma2
checkpoint loader
(norm +1 fold, embed sqrt(hidden) scale, tied unscaled LM head).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models import speculative as spec

# tiny gemma-shaped geometry: every gemma-2 feature on
GCFG = LlamaConfig.tiny(n_layers=4, max_seq_len=512, n_kv_heads=2,
                        ffn_act="gelu_tanh", sandwich_norms=True,
                        attn_logit_softcap=50.0, final_logit_softcap=30.0,
                        sliding_window=100, window_pattern="even")


def _params(cfg, seed=0):
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    if cfg.sandwich_norms:
        # random-ish post norms so a dropped operand cannot hide
        for k in ("post_attn_norm", "post_ffn_norm"):
            params["layers"][k] = params["layers"][k] + \
                0.3 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                        params["layers"][k].shape,
                                        jnp.bfloat16)
    return params


def _rel_close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = max(float(np.max(np.abs(b))), 1.0)
    return float(np.max(np.abs(a - b))) < tol * scale


def test_gemma_decode_fused_matches_eager():
    params = _params(GCFG)
    kc, vc = model.init_cache(GCFG)
    toks = (jnp.arange(200, dtype=jnp.int32) * 13 + 1) % GCFG.vocab_size
    feed = jnp.asarray([7, 99, 250], jnp.int32)
    _, kc, vc = model.prefill(params, kc, vc, toks, GCFG)
    want = model.reference_logits(params, jnp.concatenate([toks, feed]),
                                  GCFG)
    for step in range(3):
        pos = jnp.asarray(200 + step, jnp.int32)
        lf, kc, vc = model.decode_step(params, kc, vc, feed[step], pos, GCFG)
        # softcap bounds |logits| <= 30
        assert _rel_close(lf, want[200 + step], 0.02), step


def test_gemma_features_each_matter():
    """Disabling any single gemma feature must change the logits —
    catches silently-dropped operands/flags."""
    import dataclasses
    params = _params(GCFG)
    kc, vc = model.init_cache(GCFG)
    toks = (jnp.arange(150, dtype=jnp.int32) * 11 + 2) % GCFG.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, toks, GCFG)
    tok, pos = jnp.asarray(7, jnp.int32), jnp.asarray(150, jnp.int32)
    base, _, _ = model.decode_step(params, kc, vc, tok, pos, GCFG)
    for change in (dict(ffn_act="silu"), dict(attn_logit_softcap=0.0),
                   dict(final_logit_softcap=0.0), dict(window_pattern="all"),
                   dict(sliding_window=0)):
        cfg2 = dataclasses.replace(GCFG, **change)
        if "sliding_window" in change or "window_pattern" in change:
            # window changes need a fresh prefill under the same cfg family
            kc2, vc2 = model.init_cache(cfg2)
            _, kc2, vc2 = model.prefill(params, kc2, vc2, toks, cfg2)
        else:
            kc2, vc2 = kc, vc
        l2, _, _ = model.decode_step(params, kc2, vc2, tok, pos, cfg2)
        assert float(jnp.max(jnp.abs(base - l2))) > 1e-3, change
    # sandwich_norms=False changes the pytree; check via zeroed... the
    # random post norms already guarantee the operands are live (decode
    # parity above would fail if a path dropped them)


def test_gemma_verify_fused_matches_eager():
    params = _params(GCFG, seed=3)
    kc, vc = model.init_cache(GCFG)
    toks = (jnp.arange(150, dtype=jnp.int32) * 7 + 1) % GCFG.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, toks, GCFG)
    draft = (jnp.arange(4, dtype=jnp.int32) * 3 + 2) % GCFG.vocab_size
    pos = jnp.asarray(150, jnp.int32)
    lf, _, _ = spec.verify_step(params, kc, vc, draft, pos, GCFG)
    le = model.reference_logits(params, jnp.concatenate([toks, draft]),
                                GCFG)[150:]
    assert _rel_close(lf, le, 0.02)


def test_gemma_serving_matches_single_seq():
    from clusterfusion.runtime.serving import ServingEngine
    import dataclasses
    cfg = dataclasses.replace(GCFG, max_seq_len=64, sliding_window=24,
                              n_layers=2)
    params = _params(cfg, seed=5)

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

    prompts = {0: list(range(1, 30)), 1: [4, 5, 6]}
    eng = ServingEngine(params, cfg, page_size=8, num_pages=64, max_batch=4)
    # interleaved-window gemma serves from split rolling-buffer pools
    assert eng.evenwin
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    for rid, p in prompts.items():
        assert out[rid] == ref_greedy(p, 4), rid


def test_gemma_rolling_buffer_serving_capacity():
    """Gemma-2 analog of test_rolling_buffer_serving_capacity: with the
    split-pool rolling buffer, the windowed EVEN layers live in a fixed
    O(window·batch) ring pool — sized for 3 window pages per slot here,
    far too small to hold the full 40-token context that the generation
    reaches — while odd layers keep full history in the (half-height)
    scheduler pool.  Long generations must wrap the ring (ceil(40/8)=5
    absolute pages > wp=3) and still match the single-sequence windowed
    decode, with two concurrent requests exercising distinct slots."""
    from clusterfusion.runtime.serving import ServingEngine
    import dataclasses
    cfg = dataclasses.replace(GCFG, max_seq_len=64, sliding_window=12,
                              n_layers=2)
    params = _params(cfg, seed=14)
    prompts = {0: list(range(1, 25)), 1: list(range(3, 20))}
    n_gen = 16
    eng = ServingEngine(params, cfg, page_size=8, num_pages=32, max_batch=2)
    assert eng.evenwin
    # the even-layer pool is O(window·batch): max_batch·(ceil(12/8)+1)+1
    # pages and L/2 layers, independent of max_seq_len
    assert eng.k_pool_loc.shape == (1, 2 * 3 + 1, cfg.kv_heads, 8,
                                    cfg.head_dim_)
    assert eng.k_pool.shape[0] == cfg.n_layers // 2
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=n_gen, temperature=0.0)
    out = eng.run()
    for rid in prompts:
        assert eng.last_results[rid].error is None
        assert len(out[rid]) == n_gen

    # teacher-forced validation against the single-seq windowed oracle
    # (tie-robust: every served token must be a near-argmax choice of the
    # oracle given the same prefix)
    for rid, prompt in prompts.items():
        kc, vc = model.init_cache(cfg)
        logits, kc, vc = model.prefill(params, kc, vc,
                                       jnp.asarray(prompt, jnp.int32), cfg)
        lg = logits[len(prompt) - 1]
        pos = len(prompt)
        for i, tok in enumerate(out[rid]):
            gap = float(jnp.max(lg) - lg[tok])
            scale = max(float(jnp.max(jnp.abs(lg))), 1.0)
            assert gap < 0.02 * scale, (rid, i, tok, gap)
            lg, kc, vc = model.decode_step(
                params, kc, vc, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cfg)
            pos += 1


def test_gemma2_hf_loader(tmp_path):
    """Synthetic HF gemma2 checkpoint: model_type detection, (1+w) norm
    fold, sqrt(hidden) embed scale with UNSCALED tied LM head, sandwich
    norm tensors, and an end-to-end decode parity check on the loaded
    tree."""
    from safetensors.numpy import save_file
    from clusterfusion.models.checkpoint import load_hf_checkpoint

    # head_dim independent of hidden/heads (gemma-2 trait: 16*256 != 3584)
    h, heads, kvh, hd, f, L, V = 256, 4, 2, 128, 512, 2, 512
    rng = np.random.RandomState(0)
    st = {"model.embed_tokens.weight":
          rng.randn(V, h).astype(np.float32) * 0.02,
          "model.norm.weight": rng.randn(h).astype(np.float32) * 0.1}
    for i in range(L):
        p = f"model.layers.{i}."
        st[p + "self_attn.q_proj.weight"] = \
            rng.randn(heads * hd, h).astype(np.float32) * 0.05
        st[p + "self_attn.k_proj.weight"] = \
            rng.randn(kvh * hd, h).astype(np.float32) * 0.05
        st[p + "self_attn.v_proj.weight"] = \
            rng.randn(kvh * hd, h).astype(np.float32) * 0.05
        st[p + "self_attn.o_proj.weight"] = \
            rng.randn(h, heads * hd).astype(np.float32) * 0.05
        st[p + "mlp.gate_proj.weight"] = \
            rng.randn(f, h).astype(np.float32) * 0.05
        st[p + "mlp.up_proj.weight"] = \
            rng.randn(f, h).astype(np.float32) * 0.05
        st[p + "mlp.down_proj.weight"] = \
            rng.randn(h, f).astype(np.float32) * 0.05
        for nm in ("input_layernorm", "post_attention_layernorm",
                   "pre_feedforward_layernorm",
                   "post_feedforward_layernorm"):
            st[p + nm + ".weight"] = rng.randn(h).astype(np.float32) * 0.1
    d = tmp_path / "gemma2"
    d.mkdir()
    save_file(st, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "model_type": "gemma2", "hidden_size": h,
        "num_attention_heads": heads, "num_key_value_heads": kvh,
        "head_dim": hd, "intermediate_size": f, "num_hidden_layers": L,
        "vocab_size": V, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "sliding_window": 32, "attn_logit_softcapping": 50.0,
        "final_logit_softcapping": 30.0, "tie_word_embeddings": True}))

    params, cfg = load_hf_checkpoint(str(d), max_seq_len=128)
    assert cfg.sandwich_norms and cfg.ffn_act == "gelu_tanh"
    assert cfg.window_pattern == "even" and cfg.sliding_window == 32
    assert cfg.attn_logit_softcap == 50.0 and cfg.head_dim_ == hd
    # (1+w) fold
    np.testing.assert_allclose(
        np.asarray(params["layers"]["attn_norm"][0], np.float32),
        st["model.layers.0.input_layernorm.weight"] + 1.0, atol=1e-2)
    # embed scaled, LM head tied UNSCALED
    np.testing.assert_allclose(
        np.asarray(params["embed"], np.float32),
        st["model.embed_tokens.weight"] * np.sqrt(h), atol=1e-2)
    np.testing.assert_allclose(
        np.asarray(params["lm_head"], np.float32),
        st["model.embed_tokens.weight"].T, atol=1e-3)
    assert "post_attn_norm" in params["layers"]

    # loaded tree decodes, matching the fp32 oracle
    kc, vc = model.init_cache(cfg)
    toks = (jnp.arange(40, dtype=jnp.int32) * 3 + 1) % cfg.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, toks, cfg)
    tok, pos = jnp.asarray(5, jnp.int32), jnp.asarray(40, jnp.int32)
    lf, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    le = model.reference_logits(params, jnp.concatenate([toks, tok[None]]),
                                cfg)[-1]
    assert _rel_close(lf, le, 0.02)


def test_gemma2_preset_geometry():
    cfg = LlamaConfig.gemma2_9b()
    assert cfg.sandwich_norms and cfg.window_pattern == "even"
    assert cfg.head_dim_ == 256 and cfg.ffn_act == "gelu_tanh"
    assert cfg.sliding_window == 4096 and cfg.vocab_size == 256000
    assert cfg.attn_logit_softcap == 50.0 and cfg.final_logit_softcap == 30.0


def test_gemma2_query_pre_attn_scalar_fold(tmp_path):
    """Gemma-2 scales attention logits by 1/sqrt(query_pre_attn_scalar)
    (27B: 144 vs head_dim 128; 9B: 256 == hd).  The loader folds
    sqrt(hd/scalar) into the q projection (RoPE commutes with scalars), so
    every path's 1/sqrt(hd) yields q·k/sqrt(scalar).  Checks: q columns scale by exactly sqrt(hd/scalar),
    k/v columns and everything else untouched."""
    from safetensors.numpy import save_file
    from clusterfusion.models.checkpoint import load_hf_checkpoint

    h, heads, kvh, hd, f, L, V = 256, 4, 2, 128, 512, 1, 512
    rng = np.random.RandomState(7)
    st = {"model.embed_tokens.weight":
          rng.randn(V, h).astype(np.float32) * 0.02,
          "model.norm.weight": rng.randn(h).astype(np.float32) * 0.1}
    p = "model.layers.0."
    st[p + "self_attn.q_proj.weight"] = \
        rng.randn(heads * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.k_proj.weight"] = \
        rng.randn(kvh * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.v_proj.weight"] = \
        rng.randn(kvh * hd, h).astype(np.float32) * 0.05
    st[p + "self_attn.o_proj.weight"] = \
        rng.randn(h, heads * hd).astype(np.float32) * 0.05
    st[p + "mlp.gate_proj.weight"] = rng.randn(f, h).astype(np.float32) * .05
    st[p + "mlp.up_proj.weight"] = rng.randn(f, h).astype(np.float32) * .05
    st[p + "mlp.down_proj.weight"] = rng.randn(h, f).astype(np.float32) * .05
    for nm in ("input_layernorm", "post_attention_layernorm",
               "pre_feedforward_layernorm", "post_feedforward_layernorm"):
        st[p + nm + ".weight"] = rng.randn(h).astype(np.float32) * 0.1
    base = {"model_type": "gemma2", "hidden_size": h,
            "num_attention_heads": heads, "num_key_value_heads": kvh,
            "head_dim": hd, "intermediate_size": f, "num_hidden_layers": L,
            "vocab_size": V, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
            "sliding_window": 32, "attn_logit_softcapping": 50.0,
            "final_logit_softcapping": 30.0, "tie_word_embeddings": True}

    trees = {}
    for name, qpas in [("eq", hd), ("gemma27b_like", hd // 4)]:
        d = tmp_path / name
        d.mkdir()
        save_file(st, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(
            {**base, "query_pre_attn_scalar": qpas}))
        params, cfg = load_hf_checkpoint(str(d), max_seq_len=128,
                                         dtype=jnp.float32)
        trees[name] = params

    w_eq = np.asarray(trees["eq"]["layers"]["wqkv_f"][0], np.float32)
    w_27 = np.asarray(trees["gemma27b_like"]["layers"]["wqkv_f"][0],
                      np.float32)
    # fused layout: per KV head, columns [q_0..q_{g-1} | k | v]
    g = heads // kvh
    assert w_eq.shape == (kvh, h, (g + 2) * hd)
    factor = np.sqrt(hd / (hd // 4))                     # = 2.0
    np.testing.assert_allclose(w_27[..., :g * hd],
                               w_eq[..., :g * hd] * factor, rtol=1e-5)
    np.testing.assert_allclose(w_27[..., g * hd:], w_eq[..., g * hd:],
                               rtol=1e-6)
    # only the q columns differ anywhere in the tree
    np.testing.assert_allclose(
        np.asarray(trees["eq"]["layers"]["wo_f"], np.float32),
        np.asarray(trees["gemma27b_like"]["layers"]["wo_f"], np.float32))


def test_gemma_evenwin_serving_int8():
    """Split-pool rolling-buffer serving over an INT8 gemma tree: the
    serving step's scale-after-dot projections compose with the pair-scan
    pools (greedy parity vs the single-seq quantized decode)."""
    from clusterfusion.ops.quant import quantize_llama_params
    from clusterfusion.runtime.serving import ServingEngine
    import dataclasses
    cfg = dataclasses.replace(GCFG, max_seq_len=64, sliding_window=16,
                              n_layers=2)
    params = quantize_llama_params(_params(cfg, seed=11), "int8")
    eng = ServingEngine(params, cfg, page_size=8, num_pages=32, max_batch=2)
    assert eng.evenwin
    prompts = {0: list(range(1, 26)), 1: [4, 9, 2, 7]}
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    # tie-robust: every served token must be a near-argmax choice of the
    # single-seq quantized decode given the SAME prefix (batched vs
    # single-row int8 rounding can flip exact ties on random weights)
    for rid, prompt in prompts.items():
        kc, vc = model.init_cache(cfg)
        logits, kc, vc = model.prefill(params, kc, vc,
                                       jnp.asarray(prompt, jnp.int32), cfg)
        lg = logits[len(prompt) - 1]
        pos = len(prompt)
        for i, tok in enumerate(out[rid]):
            gap = float(jnp.max(lg) - lg[tok])
            scale = max(float(jnp.max(jnp.abs(lg))), 1.0)
            assert gap < 0.02 * scale, (rid, i, tok, gap)
            lg, kc, vc = model.decode_step(
                params, kc, vc, jnp.asarray(tok, jnp.int32),
                jnp.asarray(pos, jnp.int32), cfg)
            pos += 1
