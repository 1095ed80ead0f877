"""End-to-end model tests on a tiny Llama: decode and prefill must agree
with the fp32 oracle forward (``model.reference_logits``), and generation
must run hermetically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models.generation import Llama

CFG = LlamaConfig.tiny()


@pytest.fixture(scope="module")
def setup():
    params = model.init_params(CFG, jax.random.PRNGKey(0))
    k_cache, v_cache = model.init_cache(CFG)
    return params, k_cache, v_cache


def _rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / max(float(jnp.max(jnp.abs(b))),
                                               1.0))


def test_fused_decode_matches_eager(setup):
    """One decode step after a prefill against the fp32 oracle; the K/V
    rows it appends equal what a prefill of the same tokens writes."""
    params, k_cache, v_cache = setup
    toks = jnp.asarray([5, 17, 42, 9], jnp.int32)
    logits, kc, vc = model.prefill(params, k_cache, v_cache, toks, CFG)

    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(len(toks), jnp.int32)
    lf, kf, vf = model.decode_step(params, kc, vc, tok, pos, CFG)
    seq = jnp.concatenate([toks, tok[None]])
    want = model.reference_logits(params, seq, CFG)
    assert _rel(lf, want[-1]) < 0.05
    _, kp, vp = model.prefill(params, k_cache, v_cache, seq, CFG)
    np.testing.assert_allclose(
        np.asarray(kf[:, :, len(toks)], jnp.float32),
        np.asarray(kp[:, :, len(toks)], jnp.float32), atol=0.05)


def test_multistep_decode_consistency(setup):
    """Teacher-forced 4-step decode: per-step logits track the fp32 oracle
    of the whole sequence (greedy argmax comparison is tie-unstable with
    random weights — near-flat logits flip on sub-tolerance differences)."""
    params, k_cache, v_cache = setup
    toks = jnp.asarray([1, 2, 3], jnp.int32)
    feed = jnp.asarray([11, 7, 301, 40], jnp.int32)
    logits, kc, vc = model.prefill(params, k_cache, v_cache, toks, CFG)
    want = model.reference_logits(params, jnp.concatenate([toks, feed]), CFG)
    for step in range(4):
        pos = jnp.asarray(len(toks) + step, jnp.int32)
        lf, kc, vc = model.decode_step(params, kc, vc, feed[step], pos, CFG)
        err = _rel(lf, want[len(toks) + step])
        assert err < 0.05, f"step {step}: decode vs oracle rel err {err}"


def test_flash_prefill_matches_eager(setup):
    """Whole-model prefill against the fp32 oracle at every position."""
    params, k_cache, v_cache = setup
    toks = (jnp.arange(37, dtype=jnp.int32) * 13) % CFG.vocab_size
    lf, kf, vf = model.prefill(params, k_cache, v_cache, toks, CFG)
    assert _rel(lf, model.reference_logits(params, toks, CFG)) < 0.05
    assert np.isfinite(np.asarray(kf, np.float32)).all()


@pytest.mark.parametrize("split", [16, 5])
def test_chunked_prefill_matches_whole(setup, split):
    """prefill_chunk over two chunks == one-shot prefill (same logits tail,
    same caches) — the chunked-prefill capability the reference lacks."""
    params, k_cache, v_cache = setup
    toks = (jnp.arange(29, dtype=jnp.int32) * 7) % CFG.vocab_size
    l1, k1, v1 = model.prefill(params, k_cache, v_cache, toks, CFG)
    _, kc, vc = model.prefill_chunk(params, k_cache, v_cache, toks[:split],
                                    CFG, pos0=0)
    l2, kc, vc = model.prefill_chunk(params, kc, vc, toks[split:], CFG,
                                     pos0=split)
    scale = max(float(jnp.max(jnp.abs(l1))), 1.0)
    assert float(jnp.max(jnp.abs(l2[-1] - l1[-1]))) < 0.05 * scale
    np.testing.assert_allclose(np.asarray(kc, np.float32),
                               np.asarray(k1, np.float32), atol=0.05)
    np.testing.assert_allclose(np.asarray(vc, np.float32),
                               np.asarray(v1, np.float32), atol=0.05)


def test_generation_engine_smoke():
    eng = Llama.synthetic(CFG)
    out = eng.text_completion(["hello"], temperature=0.0, max_gen_len=8)
    assert len(out) == 1 and isinstance(out[0]["generation"], str)
    assert eng.stats.gen_tokens > 0


def test_chat_template():
    eng = Llama.synthetic(CFG)
    toks = eng._encode_dialog([
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"},
    ])
    text = eng.tokenizer.decode(toks)
    assert "[INST]" in text and "<<SYS>>" in text


def test_gqa_decode_matches_eager():
    cfg = LlamaConfig.tiny(n_kv_heads=2)   # 4 q heads, 2 kv heads → group 2
    params = model.init_params(cfg, jax.random.PRNGKey(1))
    k_cache, v_cache = model.init_cache(cfg)
    toks = jnp.asarray([4, 8, 15], jnp.int32)
    logits, kc, vc = model.prefill(params, k_cache, v_cache, toks, cfg)
    tok = jnp.asarray(16, jnp.int32)
    pos = jnp.asarray(3, jnp.int32)
    lf, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    want = model.reference_logits(
        params, jnp.concatenate([toks, tok[None]]), cfg)
    assert _rel(lf, want[-1]) < 0.05


def test_batched_generate_matches_greedy_oracle():
    """`Llama.generate` decodes the whole batch together (reference
    `generation.py:159-213` parity) — rows must equal per-row greedy
    single-sequence decode, with per-row stopping at max_gen_len."""
    cfg = LlamaConfig.tiny(max_seq_len=64)
    eng = Llama.synthetic(cfg, seed=3)
    params = eng.params
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]
    n_gen = 5
    toks, lps = eng.generate(prompts, n_gen, temperature=0.0)
    assert lps is None
    assert len(toks) == 3
    for row, p in zip(toks, prompts):
        kc, vc = model.init_cache(cfg)
        logits, kc, vc = model.prefill(params, kc, vc,
                                       jnp.asarray(p, jnp.int32), cfg)
        want = [int(jnp.argmax(logits[len(p) - 1]))]
        pos = len(p)
        for _ in range(n_gen - 1):
            lg, kc, vc = model.decode_step(
                params, kc, vc, jnp.asarray(want[-1], jnp.int32),
                jnp.asarray(pos, jnp.int32), cfg)
            want.append(int(jnp.argmax(lg)))
            pos += 1
        if eng.tokenizer.eos_id in want:        # generate cuts at eos
            want = want[:want.index(eng.tokenizer.eos_id)]
        assert row == want, (row, want)


def test_generate_logprobs_match_forward_oracle():
    """logprobs=True: each kept token's logprob must match a teacher-forced
    full forward (the reference computes them as -cross_entropy,
    `generation.py:136,186-193`); echo covers prompt positions with
    token_logprobs[0] == 0.0 for bos."""
    cfg = LlamaConfig.tiny(max_seq_len=64)
    eng = Llama.synthetic(cfg, seed=4)
    prompts = [[9, 8, 7, 6], [5, 4, 3]]
    toks, lps = eng.generate(prompts, 4, temperature=0.0,
                             logprobs=True, echo=True)
    for row, lp, p in zip(toks, lps, prompts):
        assert row[:len(p)] == p                      # echo
        assert len(lp) == len(row)
        assert lp[0] == 0.0
        full = jnp.asarray(row, jnp.int32)
        logits = model.forward(eng.params, full[None], cfg)[0]  # [T, vocab]
        lw = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        want = np.asarray(
            jnp.take_along_axis(lw[:-1], full[1:, None], axis=-1)[:, 0])
        got = np.asarray(lp[1:], np.float32)
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)


def test_text_completion_logprobs_fields():
    cfg = LlamaConfig.tiny(max_seq_len=64)
    eng = Llama.synthetic(cfg, seed=5)
    out = eng.text_completion(["ab", "xyz"], temperature=0.0,
                              max_gen_len=4, logprobs=True)
    for r in out:
        assert set(r) == {"generation", "tokens", "logprobs"}
        assert len(r["tokens"]) == len(r["logprobs"])


def test_llama3_rope_scaling_matches_hf_formula():
    """ops.rope.llama3_scaled_inv_freq must reproduce transformers'
    _compute_llama3_parameters exactly (Llama-3.1/3.2 rope_scaling)."""
    import numpy as np
    from clusterfusion.ops.rope import llama3_scaled_inv_freq

    hd, theta = 128, 500000.0
    factor, low, high, orig = 8.0, 1.0, 4.0, 8192
    inv = 1.0 / (theta ** (np.arange(0, hd, 2) / hd))
    got = llama3_scaled_inv_freq(inv, factor, low, high, orig)

    # independent restatement of the HF reference computation
    low_wl = orig / low
    high_wl = orig / high
    want = []
    for f in inv:
        wl = 2 * np.pi / f
        if wl < high_wl:
            want.append(f)
        elif wl > low_wl:
            want.append(f / factor)
        else:
            s = (orig / wl - low) / (high - low)
            want.append((1 - s) * f / factor + s * f)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12)
    # the rescale must actually bite: lowest frequency divided by ~factor
    assert got[-1] < inv[-1] / (factor * 0.9)
    # and the highest frequencies must be untouched
    np.testing.assert_allclose(got[0], inv[0])


def test_llama31_scaled_decode_fused_matches_eager():
    """The scaled tables flow through model.rope_table into every path:
    decode matches the fp32 oracle with rope_scaling_factor=8, and the
    scaled model's logits genuinely differ from the unscaled one."""
    import dataclasses
    cfg = LlamaConfig.tiny(max_seq_len=64, rope_style="neox",
                           rope_scaling_factor=8.0,
                           rope_low_freq_factor=1.0,
                           rope_high_freq_factor=4.0,
                           rope_orig_max_pos=32)
    params = model.init_params(cfg, jax.random.PRNGKey(11))
    kc, vc = model.init_cache(cfg)
    prompt = (jnp.arange(20, dtype=jnp.int32) * 7 + 3) % cfg.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
    tok = jnp.asarray(5, jnp.int32)
    pos = jnp.asarray(20, jnp.int32)
    lf, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    le = model.reference_logits(
        params, jnp.concatenate([prompt, tok[None]]), cfg)[-1]
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale

    cfg0 = dataclasses.replace(cfg, rope_scaling_factor=1.0)
    kc0, vc0 = model.init_cache(cfg0)
    _, kc0, vc0 = model.prefill(params, kc0, vc0, prompt, cfg0)
    l0, _, _ = model.decode_step(params, kc0, vc0, tok, pos, cfg0)
    assert float(jnp.max(jnp.abs(lf - l0))) > 0.01 * scale


def test_hf_loader_rope_scaling(tmp_path):
    """load_hf_checkpoint parses rope_scaling: llama3 configs populate the
    scaling fields, default/null pass through, unknown types error."""
    import json
    import numpy as np
    from safetensors.numpy import save_file
    from clusterfusion.models.checkpoint import load_hf_checkpoint

    h, heads, kvh, hd, f, V = 256, 2, 1, 128, 512, 512
    rng = np.random.RandomState(3)
    st = {"model.embed_tokens.weight":
          rng.randn(V, h).astype(np.float32) * 0.02,
          "model.norm.weight": rng.randn(h).astype(np.float32) * 0.1,
          "lm_head.weight": rng.randn(V, h).astype(np.float32) * 0.02}
    p = "model.layers.0."
    for nm, shp in [("self_attn.q_proj", (heads * hd, h)),
                    ("self_attn.k_proj", (kvh * hd, h)),
                    ("self_attn.v_proj", (kvh * hd, h)),
                    ("self_attn.o_proj", (h, heads * hd)),
                    ("mlp.gate_proj", (f, h)), ("mlp.up_proj", (f, h)),
                    ("mlp.down_proj", (h, f))]:
        st[p + nm + ".weight"] = rng.randn(*shp).astype(np.float32) * 0.05
    for nm in ("input_layernorm", "post_attention_layernorm"):
        st[p + nm + ".weight"] = rng.randn(h).astype(np.float32) * 0.1
    base = {"model_type": "llama", "hidden_size": h,
            "num_attention_heads": heads, "num_key_value_heads": kvh,
            "head_dim": hd, "intermediate_size": f, "num_hidden_layers": 1,
            "vocab_size": V, "rms_norm_eps": 1e-5, "rope_theta": 500000.0}

    def load(name, rope_scaling):
        d = tmp_path / name
        d.mkdir()
        save_file(st, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(
            {**base, "rope_scaling": rope_scaling}))
        return load_hf_checkpoint(str(d), max_seq_len=64)

    _, cfg = load("l31", {"rope_type": "llama3", "factor": 8.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 8192})
    assert cfg.rope_scaling_factor == 8.0 and cfg.rope_orig_max_pos == 8192
    assert cfg.llama3_scaling == (8.0, 1.0, 4.0, 8192)

    _, cfg0 = load("plain", None)
    assert cfg0.llama3_scaling is None

    import pytest as _pt
    with _pt.raises(NotImplementedError):
        load("bad", {"rope_type": "yarn", "factor": 4.0})
