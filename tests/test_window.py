"""Sliding-window attention (Mistral semantics) across every path that
takes a ``window``: the single-layer op, the decode step, prefill, paged
serving and the n-row verify step.

These tests pin the wiring: every windowed path vs a windowed fp32
oracle, including windows that start mid-page and the ``window >= seq+1``
== full-attention identity.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models import speculative as spec
from clusterfusion.ops import llama_decoder_layer_sglang
from clusterfusion.ops.reference import llama_decoder_layer_sglang_ref

HIDDEN = 512
HEADS = 4
HEAD_DIM = 128


def _max_err(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def _make_inputs(key, seqlen, hidden=HIDDEN, dtype=jnp.bfloat16):
    ks = jax.random.split(key, 8)
    rnd = lambda k, shape, s=1.0: (jax.random.normal(k, shape, jnp.float32) * s).astype(dtype)
    return dict(
        input=rnd(ks[0], (1, hidden)),
        residual=rnd(ks[1], (1, hidden)),
        w_qkv=rnd(ks[2], (3 * hidden, hidden), 0.1),
        w_o=rnd(ks[3], (hidden, hidden), 0.1),
        k_cache=rnd(ks[4], (seqlen, hidden)),
        v_cache=rnd(ks[5], (seqlen, hidden)),
        rms_w=rnd(ks[6], (hidden,), 0.1),
    )


# window values: 1 (only the new token), 64, 130, 100 (start mid-way
# through the cache), and seq+1 (must equal full attention)
@pytest.mark.parametrize("seqlen,window", [
    (37, 1), (37, 64), (256, 64), (256, 130), (256, 257), (400, 100),
])
def test_single_layer_window_matches_oracle(seqlen, window):
    d = _make_inputs(jax.random.PRNGKey(seqlen * 7 + window), seqlen)
    angle = jax.random.uniform(jax.random.PRNGKey(99), (HEAD_DIM // 2,),
                               jnp.float32) * math.pi
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    eps = 1e-5

    got = llama_decoder_layer_sglang(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], eps, cos, sin,
        window=window)
    want = llama_decoder_layer_sglang_ref(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], eps, cos, sin,
        n_heads=HEADS, head_dim=HEAD_DIM, window=window)

    assert _max_err(got[1], want[1]) < 2e-2, "residual"
    assert _max_err(got[0], want[0]) < 1e-1, "output"


def test_single_layer_full_window_equals_no_window():
    """window >= seq+1 must reproduce full attention exactly (every mask
    is all-true)."""
    seqlen = 256
    d = _make_inputs(jax.random.PRNGKey(3), seqlen)
    angle = jax.random.uniform(jax.random.PRNGKey(99), (HEAD_DIM // 2,),
                               jnp.float32) * math.pi
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    args = (d["input"], d["residual"], d["w_qkv"], d["w_o"],
            d["k_cache"], d["v_cache"], d["rms_w"], 1e-5, cos, sin)
    full = llama_decoder_layer_sglang(*args, window=0)
    wide = llama_decoder_layer_sglang(*args, window=seqlen + 1)
    np.testing.assert_array_equal(np.asarray(full[0], np.float32),
                                  np.asarray(wide[0], np.float32))


# --- decode step -------------------------------------------------------------


def _f32_step(params, kc, vc, tok, pos, cfg):
    """The same decode step with params and caches in fp32 at highest
    matmul precision."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(model.upcast(params), model.upcast(kc),
                                 model.upcast(vc), tok, pos, cfg)


def _stack_setup(window, cap=512, pos_i=400, seed=11):
    cfg = LlamaConfig.tiny(max_seq_len=cap, sliding_window=window)
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    shape = (cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 2)
    mask = (jnp.arange(cap) < pos_i)[None, None, :, None]
    kc = jnp.where(mask, jax.random.normal(ks[0], shape, jnp.bfloat16) * 0.5, 0)
    vc = jnp.where(mask, jax.random.normal(ks[1], shape, jnp.bfloat16) * 0.5, 0)
    return cfg, params, kc, vc, pos_i


# seq=400 with window=100: the window starts mid-way through the cache
@pytest.mark.parametrize("window", [100, 130, 256])
def test_stack_window_fused_matches_eager(window):
    cfg, params, kc, vc, pos_i = _stack_setup(window)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)
    lf, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    le, _, _ = _f32_step(params, kc, vc, tok, pos, cfg)
    a, b = np.asarray(lf, np.float32), np.asarray(le, np.float32)
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert np.max(np.abs(a - b)) < 0.08 * scale, window


def test_stack_window_differs_from_full_attention():
    """Guard against the wiring bug recurring in the OTHER direction: a
    small window must actually change the logits vs full attention."""
    cfg, params, kc, vc, pos_i = _stack_setup(window=100)
    cfg_full = dataclasses.replace(cfg, sliding_window=0)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)
    lw, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    lfull, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg_full)
    assert float(jnp.max(jnp.abs(lw - lfull))) > 1e-3


def test_stack_full_window_equals_no_window():
    """window >= seq+1 == full attention on the decode step."""
    cfg, params, kc, vc, pos_i = _stack_setup(window=512)
    cfg_full = dataclasses.replace(cfg, sliding_window=0)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)     # pos_i=400: window 512 >= seq+1
    lw, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    lfull, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg_full)
    np.testing.assert_array_equal(np.asarray(lw), np.asarray(lfull))


# --- prefill -----------------------------------------------------------------

@pytest.mark.parametrize("window", [64, 130, 1000])
def test_prefill_flash_window_matches_eager(window):
    cfg = LlamaConfig.tiny(max_seq_len=512, sliding_window=window)
    params = model.init_params(cfg, jax.random.PRNGKey(5))
    kc, vc = model.init_cache(cfg)
    toks = (jnp.arange(300, dtype=jnp.int32) * 13 + 1) % cfg.vocab_size
    lf, kf, vf = model.prefill(params, kc, vc, toks, cfg)
    b = np.asarray(model.reference_logits(params, toks, cfg))
    a = np.asarray(lf, np.float32)
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert np.max(np.abs(a - b)) < 0.08 * scale


def test_prefill_then_windowed_decode_consistency():
    """End-to-end Mistral-style flow: windowed prefill then windowed
    decode must track the fp32 oracle step by step."""
    cfg = LlamaConfig.tiny(max_seq_len=512, sliding_window=100)
    params = model.init_params(cfg, jax.random.PRNGKey(6))
    kc, vc = model.init_cache(cfg)
    toks = (jnp.arange(150, dtype=jnp.int32) * 11 + 2) % cfg.vocab_size
    feed = jnp.asarray([9, 31, 200], jnp.int32)
    _, kc, vc = model.prefill(params, kc, vc, toks, cfg)
    want = model.reference_logits(params, jnp.concatenate([toks, feed]), cfg)
    for step in range(3):
        pos = jnp.asarray(len(toks) + step, jnp.int32)
        lf, kc, vc = model.decode_step(params, kc, vc, feed[step], pos, cfg)
        err = float(jnp.max(jnp.abs(lf - want[len(toks) + step])))
        assert err < 0.1, f"step {step}: {err}"


# --- paged serving ---------------------------------------------------------

def test_window_serving_matches_single_seq():
    """Continuous-batching serving with sliding_window (rolling page
    buffer, below-window pages masked) must equal the windowed
    single-sequence greedy decode."""
    from clusterfusion.runtime.serving import ServingEngine
    cfg = LlamaConfig.tiny(max_seq_len=64, sliding_window=12)
    params = model.init_params(cfg, jax.random.PRNGKey(13))

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

    # prompt longer than the window: the window actually bites during
    # decode (positions 0..len-12 are masked out)
    prompts = {0: list(range(1, 21)), 1: [4, 5, 6]}
    eng = ServingEngine(params, cfg, page_size=8, num_pages=64, max_batch=4)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    for rid, p in prompts.items():
        assert out[rid] == ref_greedy(p, 4), rid


@pytest.mark.parametrize("quant,kv", [("int8", "int8"), ("int4", "int8"),
                                      ("int4", "fp8")])
def test_window_quant_kv_matrix(quant, kv):
    """Window x weight-quant x 8-bit KV interactions: the window mask must
    compose with int8 scale planes and fp8 reads."""
    from clusterfusion.ops.quant import quantize_llama_params
    cfg = LlamaConfig.tiny(max_seq_len=512, sliding_window=100)
    params = model.init_params(cfg, jax.random.PRNGKey(31))
    params = quantize_llama_params(params, quant, 128)
    kv_dtype = "int8" if kv == "int8" else jnp.float8_e4m3fn
    kcf, vcf = model.init_cache(cfg, dtype=kv_dtype)
    kce, vce = kcf, vcf
    # both precisions start from the same (zero) history and decode 3
    # windowed steps at positions past the window; rows they append feed
    # later steps
    tok = jnp.asarray(7, jnp.int32)
    for step in range(200, 203):
        pos = jnp.asarray(step, jnp.int32)
        lf, kcf, vcf = model.decode_step(params, kcf, vcf, tok, pos, cfg)
        le, kce, vce = _f32_step(params, kce, vce, tok, pos, cfg)
    a, b = np.asarray(lf, np.float32), np.asarray(le, np.float32)
    assert np.all(np.isfinite(a)), (quant, kv)
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert np.max(np.abs(a - b)) < 0.1 * scale, (quant, kv)


def test_rolling_buffer_scheduler():
    """Rolling page buffer (native scheduler window mode): a windowed
    request's REAL page count caps at window_pages; below-window table
    slots become the NULL page; recycled ids move to the tail slot."""
    from clusterfusion.runtime.native import PagedKVScheduler
    s = PagedKVScheduler(num_pages=8, page_size=4, max_pages_per_req=8)
    s.set_window_pages(2)
    s.add(1, prompt_len=13)             # 4 slots (13+1 over page 4)
    ids, table, lens, poss, fresh = s.prepare_batch(2)
    assert list(ids) == [1] and fresh[0]
    pages = s.request_pages(1)
    # 4 slots, only the last 2 real
    assert len(pages) == 4 and list(pages[:2]) == [0, 0]
    assert all(p != 0 for p in pages[2:])
    assert s.free_pages == 7 - 2
    # decode across the next page boundary: slot 4 recycles slot 2's page
    old = int(pages[2])
    for _ in range(3):                  # len 13 -> 16: slot 4 appears
        s.commit_batch()
        s.prepare_batch(2)
    pages = s.request_pages(1)
    assert len(pages) == 5
    assert int(pages[4]) == old and int(pages[2]) == 0
    assert s.free_pages == 7 - 2        # no new pages consumed
    # release returns exactly the real pages, no double-free of NULLs
    s.release(1)
    assert s.free_pages == 7


def test_rolling_buffer_serving_capacity():
    """With the rolling buffer, long windowed generations run in a pool
    that full-context serving could not fit, and still match the windowed
    single-sequence greedy decode."""
    from clusterfusion.runtime.serving import ServingEngine
    cfg = LlamaConfig.tiny(max_seq_len=64, sliding_window=12)
    params = model.init_params(cfg, jax.random.PRNGKey(14))
    prompt = list(range(1, 25))         # 24 cached + 16 generated = 40 toks
    n_gen = 16
    # full-context would need ceil(41/8) = 6 pages; give the pool 4 usable
    # (5 minus the NULL page): only the window cap (ceil(12/8)+1 = 3)
    # lets this run without preemption
    eng = ServingEngine(params, cfg, page_size=8, num_pages=5, max_batch=2)
    eng.submit(0, prompt, max_gen_len=n_gen, temperature=0.0)
    out = eng.run()
    assert eng.last_results[0].error is None
    assert len(out[0]) == n_gen

    # teacher-forced validation (tie-robust: with random weights the top-2
    # logits can sit within bf16 noise, so exact greedy equality between
    # the batched serving step and the single-seq oracle is flaky — what
    # must hold is that every served token was a near-argmax choice of the
    # windowed oracle given the SAME prefix)
    kc, vc = model.init_cache(cfg)
    logits, kc, vc = model.prefill(params, kc, vc,
                                   jnp.asarray(prompt, jnp.int32), cfg)
    lg = logits[len(prompt) - 1]
    pos = len(prompt)
    for i, tok in enumerate(out[0]):
        gap = float(jnp.max(lg) - lg[tok])
        scale = max(float(jnp.max(jnp.abs(lg))), 1.0)
        assert gap < 0.02 * scale, (i, tok, gap)
        lg, kc, vc = model.decode_step(
            params, kc, vc, jnp.asarray(tok, jnp.int32),
            jnp.asarray(pos, jnp.int32), cfg)
        pos += 1


# --- n-row verify ------------------------------------------------------------

@pytest.mark.parametrize("window", [100, 401])
def test_verify_window_fused_matches_eager(window):
    cfg, params, kc, vc, pos_i = _stack_setup(window, seed=21)
    toks = (jnp.arange(4, dtype=jnp.int32) * 3 + 2) % cfg.vocab_size
    pos = jnp.asarray(pos_i, jnp.int32)
    lf, kf, vf = spec.verify_step(params, kc, vc, toks, pos, cfg)
    with jax.default_matmul_precision("highest"):
        le, ke, ve = spec.verify_step(model.upcast(params), model.upcast(kc),
                                      model.upcast(vc), toks, pos, cfg)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.06 * scale, window
    np.testing.assert_allclose(np.asarray(kf, np.float32),
                               np.asarray(ke, np.float32), atol=0.08)
