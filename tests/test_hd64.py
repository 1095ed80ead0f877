"""head_dim=64 geometries (TinyLlama-1.1B, Qwen2-0.5B): decode, windows,
serving and speculative verify against the fp32 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import quantize_llama_params

CFG = LlamaConfig.tiny(head_dim=64, n_kv_heads=2, n_layers=2,
                       max_seq_len=256, rope_style="neox")


def _setup(quant, kv_dtype, seed=0):
    params = model.init_params(CFG, jax.random.PRNGKey(seed))
    if quant:
        params = quantize_llama_params(params, quant)
    kc, vc = model.init_cache(CFG, dtype=kv_dtype)
    prompt = (jnp.arange(9, dtype=jnp.int32) * 5 + 2) % CFG.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, prompt, CFG)
    return params, kc, vc, 9


def _oracle(params, prompt_len, toks, cfg=CFG):
    prompt = (jnp.arange(prompt_len, dtype=jnp.int32) * 5 + 2) % cfg.vocab_size
    return model.reference_logits(
        params, jnp.concatenate([prompt, jnp.asarray(toks, jnp.int32)]), cfg)


@pytest.mark.parametrize("quant,kv_dtype", [
    (None, jnp.bfloat16),
    ("int8", jnp.bfloat16),
    ("int4", "int8"),
])
def test_hd64_fused_decode_matches_eager(quant, kv_dtype):
    params, kc, vc, pos_i = _setup(quant, kv_dtype)
    tok = jnp.asarray(3, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)
    lf, kf, vf = model.decode_step(params, kc, vc, tok, pos, CFG)
    le = np.asarray(_oracle(params, pos_i, [3])[-1])
    lf = np.asarray(lf, np.float32)
    scale = max(float(np.max(np.abs(le))), 1.0)
    # bf16 activations; an int8 KV cache adds its row quantization
    tol = 0.05 if kv_dtype == jnp.bfloat16 else 0.1
    assert float(np.max(np.abs(lf - le))) < tol * scale, quant
    # the appended row is the prefill's row for the same token
    prompt = (jnp.arange(pos_i, dtype=jnp.int32) * 5 + 2) % CFG.vocab_size
    kp, _ = model.init_cache(CFG, dtype=kv_dtype)
    _, kp, _ = model.prefill(params, kp, kp,
                             jnp.concatenate([prompt, tok[None]]), CFG)
    if kv_dtype == "int8":
        def deq(c):
            H = c.q.shape[1]
            sf = np.asarray(c.s, np.float32).reshape(c.s.shape[0], H, -1)
            return (np.asarray(c.q[:, :, pos_i], np.float32)
                    * sf[:, :, pos_i:pos_i + 1])
        np.testing.assert_allclose(deq(kf), deq(kp), atol=0.08)
    else:
        np.testing.assert_allclose(np.asarray(kf[:, :, pos_i], np.float32),
                                   np.asarray(kp[:, :, pos_i], np.float32),
                                   atol=0.045 if quant else 0.03)


def test_hd64_decode_loop_multistep():
    """Teacher-forced 3-step decode vs the oracle at hd=64 — appended rows
    feed later steps correctly."""
    params, kc, vc, pos_i = _setup("int4", "int8")
    feed = [7, 100, 42]
    want = _oracle(params, pos_i, feed)
    for step in range(3):
        pos = jnp.asarray(pos_i + step, jnp.int32)
        lf, kc, vc = model.decode_step(params, kc, vc,
                                       jnp.asarray(feed[step], jnp.int32),
                                       pos, CFG)
        le = want[pos_i + step]
        scale = max(float(jnp.max(jnp.abs(le))), 1.0)
        assert float(jnp.max(jnp.abs(lf - le))) < 0.1 * scale, step


def test_hd64_windowed():
    """Sliding window at hd=64 (the Qwen2-0.5B/TinyLlama geometries can be
    windowed too)."""
    import dataclasses
    cfg = dataclasses.replace(CFG, sliding_window=6)
    params = model.init_params(cfg, jax.random.PRNGKey(4))
    kc, vc = model.init_cache(cfg)
    prompt = (jnp.arange(12, dtype=jnp.int32) * 3 + 1) % cfg.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
    tok = jnp.asarray(5, jnp.int32)
    pos = jnp.asarray(12, jnp.int32)
    lf, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    le = model.reference_logits(params, jnp.concatenate([prompt, tok[None]]),
                                cfg)[-1]
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale


def test_hd64_serving_matches_single_seq():
    """Paged serving at hd=64 reproduces single-sequence greedy decode."""
    from clusterfusion.runtime.serving import ServingEngine

    params = model.init_params(CFG, jax.random.PRNGKey(6))

    def ref_greedy(prompt, n_gen):
        kc, vc = model.init_cache(CFG)
        logits, kc, vc = model.prefill(params, kc, vc,
                                       jnp.asarray(prompt, jnp.int32), CFG)
        toks = [int(jnp.argmax(logits[len(prompt) - 1]))]
        pos = len(prompt)
        for _ in range(n_gen - 1):
            lg, kc, vc = model.decode_step(
                params, kc, vc, jnp.asarray(toks[-1], jnp.int32),
                jnp.asarray(pos, jnp.int32), CFG)
            toks.append(int(jnp.argmax(lg)))
            pos += 1
        return toks

    prompts = {0: list(range(1, 22)), 1: [9, 4, 17]}
    eng = ServingEngine(params, CFG, page_size=8, num_pages=64, max_batch=4)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    for rid, p in prompts.items():
        assert out[rid] == ref_greedy(p, 4), rid


def test_hd64_spec_verify_falls_back_to_eager():
    """Speculative verify at hd=64: every row matches the fp32 oracle, and
    row 0 the single-token decode at the same state."""
    from clusterfusion.models import speculative as spec

    params, kc, vc, pos_i = _setup(None, jnp.bfloat16, seed=8)
    draft = (jnp.arange(4, dtype=jnp.int32) * 3 + 2) % CFG.vocab_size
    pos = jnp.asarray(pos_i, jnp.int32)
    lv, kv2, vv2 = spec.verify_step(params, kc, vc, draft, pos, CFG)
    l0, _, _ = model.decode_step(params, kc, vc, draft[0], pos, CFG)
    np.testing.assert_allclose(np.asarray(lv[0], np.float32),
                               np.asarray(l0, np.float32),
                               atol=0.03, rtol=0.02)
    want = _oracle(params, pos_i, draft)[pos_i:]
    scale = max(float(jnp.max(jnp.abs(want))), 1.0)
    assert float(jnp.max(jnp.abs(lv - want))) < 0.05 * scale
