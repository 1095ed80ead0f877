"""End-to-end DeepSeek MLA model: decode vs the fp32 step and prefill.
The reference has no model around its deepseek kernel at all (SURVEY.md
§2.1 — single-layer prototype); these tests cover the full stack:
prefill → cached decode → logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import DeepSeekConfig
from clusterfusion.models import deepseek as model
from clusterfusion.models.llama import upcast


def _f32(params, cache, tok, pos, cfg):
    """The same decode step with params and cache in fp32 at highest
    matmul precision (int8 payloads stay int8)."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(upcast(params), upcast(cache), tok, pos, cfg)

CFG = DeepSeekConfig.tiny()


@pytest.fixture(scope="module")
def setup():
    params = model.init_params(CFG, jax.random.PRNGKey(0))
    cache = model.init_cache(CFG)
    return params, cache


def test_fused_decode_matches_eager(setup):
    params, cache = setup
    toks = jnp.asarray([5, 17, 42, 9], jnp.int32)
    logits, cache = model.prefill(params, cache, toks, CFG)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(4, jnp.int32)
    lf, cf = model.decode_step(params, cache, tok, pos, CFG)
    le, ce = _f32(params, cache, tok, pos, CFG)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale
    # the appended compressed row must agree
    np.testing.assert_allclose(np.asarray(cf[:, 4], np.float32),
                               np.asarray(ce[:, 4], np.float32), atol=0.05)


def test_prefill_then_decode_matches_all_prefill(setup):
    """prefill(T) + decode == prefill(T+1) logits at the last position."""
    params, cache = setup
    toks = jnp.asarray([3, 1, 4, 1, 5, 9], jnp.int32)
    l_all, _ = model.prefill(params, cache, toks, CFG)
    l_pre, c = model.prefill(params, cache, toks[:-1], CFG)
    l_dec, c = model.decode_step(params, c, toks[-1],
                                 jnp.asarray(5, jnp.int32), CFG)
    scale = max(float(jnp.max(jnp.abs(l_all[-1]))), 1.0)
    assert float(jnp.max(jnp.abs(l_dec - l_all[-1]))) < 0.05 * scale


def test_multistep_fused_vs_eager(setup):
    """Teacher-forced 3-step decode tracks the fp32 step."""
    params, cache = setup
    toks = jnp.asarray([2, 7, 18], jnp.int32)
    logits, c0 = model.prefill(params, cache, toks, CFG)
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)
    cf, ce = c0, c0
    for step in range(3):
        pos = jnp.asarray(3 + step, jnp.int32)
        lf, cf = model.decode_step(params, cf, tok, pos, CFG)
        le, ce = _f32(params, ce, tok, pos, CFG)
        scale = max(float(jnp.max(jnp.abs(le))), 1.0)
        err = float(jnp.max(jnp.abs(lf - le)))
        assert err < 0.05 * scale, (step, err)
        tok = jnp.argmax(le).astype(jnp.int32)


def test_generate_greedy_runs(setup):
    params, _ = setup
    out = model.generate_greedy(params, CFG, [1, 2, 3], n_gen=5)
    assert len(out) == 5 and all(0 <= t < CFG.vocab_size for t in out)
    # determinism (replaces the reference's 10k-repetition race sweep)
    out2 = model.generate_greedy(params, CFG, [1, 2, 3], n_gen=5)
    assert out == out2


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_fused_decode_matches_eager(quant):
    """Weight-only quantized MLA: the four fused projections
    (wproj/wuk/wuv/wo_t — the reference's five GEMVs,
    `deepseek/kernel.cuh:128-288`) and the dense FFN dequantize the same
    QuantizedTensors as the fp32 step, so parity proves the dequant
    wiring."""
    from clusterfusion.ops.quant import (QuantizedTensor,
                                             quantize_deepseek_params)
    params = model.init_params(CFG, jax.random.PRNGKey(2))
    qparams = quantize_deepseek_params(params, quant)
    for nm in ("wproj", "wuk", "wuv", "wo_t", "w13", "w2"):
        assert isinstance(qparams["layers"][nm], QuantizedTensor), nm
    cache = model.init_cache(CFG)
    toks = jnp.asarray([5, 17, 42, 9, 23], jnp.int32)
    logits, cache = model.prefill(qparams, cache, toks, CFG)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(5, jnp.int32)
    lf, cf = model.decode_step(qparams, cache, tok, pos, CFG)
    le, ce = _f32(qparams, cache, tok, pos, CFG)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale, quant
    # appended row: bf16 vs f32 dequantized projections — allow a couple
    # of bf16 ulps of rounding on O(1) values
    np.testing.assert_allclose(np.asarray(cf[:, 5], np.float32),
                               np.asarray(ce[:, 5], np.float32), atol=0.08)
    # and the quantized logits must still track the bf16 model's — a
    # sanity bound on genuine quantization error through 2 random-init
    # layers + LM head (int4 carries ~4x the int8 error)
    lb, _ = model.decode_step(params, cache, tok, pos, CFG)
    tol = 0.25 if quant == "int8" else 0.45
    assert float(jnp.max(jnp.abs(lf - lb))) < tol * scale, quant


@pytest.mark.parametrize("quant", [None, "int4"])
def test_fp8_ckv_cache_fused_decode(quant):
    """8-bit compressed-ckv cache (fp8 e4m3): decode over an fp8 cache must
    match the fp32 step over the same stored rows, and track the bf16-cache
    logits within fp8 rounding."""
    params = model.init_params(CFG, jax.random.PRNGKey(4))
    if quant:
        from clusterfusion.ops.quant import quantize_deepseek_params
        params = quantize_deepseek_params(params, quant)
    toks = jnp.asarray([3, 11, 29, 6, 14, 2], jnp.int32)
    tok = jnp.asarray(8, jnp.int32)
    pos = jnp.asarray(6, jnp.int32)

    cache8 = model.init_cache(CFG, dtype=jnp.float8_e4m3fn)
    _, cache8 = model.prefill(params, cache8, toks, CFG)
    lf, c8f = model.decode_step(params, cache8, tok, pos, CFG)
    le, c8e = _f32(params, cache8, tok, pos, CFG)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale
    assert c8f.dtype == jnp.float8_e4m3fn
    # e4m3 rows: one fp8 ulp is 2^-3 RELATIVE (0.25 absolute at value 2.0)
    # and the appended row is rounded to fp8 in one precision only
    np.testing.assert_allclose(np.asarray(c8f[:, 6], np.float32),
                               np.asarray(c8e[:, 6], np.float32),
                               atol=0.05, rtol=0.15)

    cacheb = model.init_cache(CFG)
    _, cacheb = model.prefill(params, cacheb, toks, CFG)
    lb, _ = model.decode_step(params, cacheb, tok, pos, CFG)
    assert float(jnp.max(jnp.abs(lf - lb))) < 0.2 * scale
