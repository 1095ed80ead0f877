"""Quantization tests: INT8/INT4 weight-only quantization + FP8 KV cache.

Strategy (extends the reference's pure-oracle diff pattern,
`tests/test_llama_tilelang.py:18-49`): the quantized decode is compared
against the *same step in fp32 on the same quantized weights* — both share
the dequantization semantics, so tolerances stay tight and test failures
point at the decode path, not at quantization error.  A separate test
bounds quantization error itself (quantize→dequantize roundtrip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import (
    QuantizedTensor,
    quantize,
    quantize_llama_params,
)

CFG = LlamaConfig.tiny(max_seq_len=64)


def _params(seed=0):
    return model.init_params(CFG, jax.random.PRNGKey(seed))


def _f32_step(params, kc, vc, tok, pos):
    """The decode step with fp32 params at highest matmul precision (int8
    payloads stay int8, caches keep their dtype)."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(model.upcast(params), kc, vc, tok, pos, CFG)


# --------------------------------------------------------------------------
# quantize/dequantize roundtrip
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,tol", [("int8", 0.01), ("int4", 0.15)])
def test_roundtrip(kind, tol):
    w = jax.random.normal(jax.random.PRNGKey(3), (4, 256, 384),
                          jnp.float32) * 0.3
    qt = quantize(w, kind, -2, 128)
    wd = qt.dequantize(jnp.float32)
    assert qt.q.dtype == jnp.int8
    # error bounded by scale/2 per element; amax 0.3·~4σ → loose abs bound
    assert float(jnp.max(jnp.abs(wd - w))) < tol
    assert qt.shape == w.shape


def test_int4_pack_axis_output():
    """w2-style packing along the output axis (pack_axis != reduction)."""
    w = jax.random.normal(jax.random.PRNGKey(4), (256, 512), jnp.float32)
    qt = quantize(w, "int4", -2, 128, pack_axis=-1)
    assert qt.q.shape == (256, 256)
    assert qt.s.shape == (2, 512)
    wd = qt.dequantize(jnp.float32)
    # same values as reduction-axis packing — packing is layout only
    qt2 = quantize(w, "int4", -2, 128)
    np.testing.assert_allclose(np.asarray(wd),
                               np.asarray(qt2.dequantize(jnp.float32)))


def test_int4_halves_bytes():
    w = jax.random.normal(jax.random.PRNGKey(5), (256, 512), jnp.bfloat16)
    q8 = quantize(w, "int8", -2)
    q4 = quantize(w, "int4", -2, 128)
    assert q8.q.size == w.size                      # 1 B/elem
    assert q4.q.size == w.size // 2                 # 0.5 B/elem


# --------------------------------------------------------------------------
# decode on quantized weights vs the same step in fp32
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g32"])
def test_decode_step_quantized_fused_vs_eager(kind):
    """Decode on quantized weights vs the fp32 step on the same weights
    (int4 at the default group of 128 and at group 32)."""
    qkind, gs = ("int4", 32) if kind == "int4_g32" else (kind, 128)
    qp = quantize_llama_params(_params(), qkind, gs)
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(5, jnp.int32)

    lg_f, kf, vf = model.decode_step(qp, kc, vc, tok, pos, CFG)
    lg_e, ke, ve = _f32_step(qp, kc, vc, tok, pos)
    np.testing.assert_allclose(np.asarray(lg_f, np.float32),
                               np.asarray(lg_e, np.float32),
                               atol=0.12, rtol=0.05)
    np.testing.assert_allclose(np.asarray(kf, np.float32),
                               np.asarray(ke, np.float32), atol=0.06)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_close_to_bf16(kind):
    """Quantized decode tracks the bf16 model (weight-only quant keeps the
    model usable — the perplexity-parity proxy at tiny scale)."""
    params = _params()
    qp = quantize_llama_params(params, kind, 128)
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(11, jnp.int32)
    pos = jnp.asarray(0, jnp.int32)
    lg_ref, _, _ = model.decode_step(params, kc, vc, tok, pos, CFG)
    lg_q, _, _ = model.decode_step(qp, kc, vc, tok, pos, CFG)
    ref = np.asarray(lg_ref, np.float32)
    q = np.asarray(lg_q, np.float32)
    # random-init weights lack real-model structure, so int4 noise is
    # larger than it would be on trained weights — bound at 25% of scale
    frac = 0.25 if kind == "int4" else 0.15
    assert np.max(np.abs(ref - q)) < frac * max(np.max(np.abs(ref)), 1.0)


def test_quantized_decode_deterministic():
    qp = quantize_llama_params(_params(), "int4", 128)
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(3, jnp.int32)
    pos = jnp.asarray(2, jnp.int32)
    a, _, _ = model.decode_step(qp, kc, vc, tok, pos, CFG)
    b, _, _ = model.decode_step(qp, kc, vc, tok, pos, CFG)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_scan_slices_quantized_tensor():
    """QuantizedTensor rides lax.scan xs with negative static axes intact."""
    w = jax.random.normal(jax.random.PRNGKey(6), (3, 8, 256, 128),
                          jnp.float32)
    qt = quantize(w, "int4", -2, 128)

    def body(c, x):
        assert isinstance(x, QuantizedTensor)
        return c, x.dequantize(jnp.float32)

    _, deq = jax.lax.scan(body, 0, qt)
    np.testing.assert_allclose(np.asarray(deq),
                               np.asarray(qt.dequantize(jnp.float32)),
                               atol=1e-6)


# --------------------------------------------------------------------------
# FP8 KV cache
# --------------------------------------------------------------------------


def test_fp8_kv_cache_decode():
    params = _params()
    kc8, vc8 = model.init_cache(CFG, dtype=jnp.float8_e4m3fn)
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(9, jnp.int32)

    # multi-step: fill a few positions so the cache is actually read back
    pos = jnp.asarray(0, jnp.int32)
    lg8, kc8, vc8 = model.decode_step(params, kc8, vc8, tok, pos, CFG)
    lgr, kc, vc = model.decode_step(params, kc, vc, tok, pos, CFG)
    assert kc8.dtype == jnp.float8_e4m3fn
    for step in range(1, 4):
        pos = jnp.asarray(step, jnp.int32)
        lg8, kc8, vc8 = model.decode_step(params, kc8, vc8, tok, pos, CFG,
                                          )
        lgr, kc, vc = model.decode_step(params, kc, vc, tok, pos, CFG,
                                        )
    a = np.asarray(lg8, np.float32)
    b = np.asarray(lgr, np.float32)
    # e4m3 has a 3-bit mantissa: attention over an fp8 cache stays close
    assert np.max(np.abs(a - b)) < 0.25 * max(np.max(np.abs(b)), 1.0)
    assert np.all(np.isfinite(a))


def test_fp8_kv_fused_vs_eager():
    """bf16 and fp32 steps each read/write their own fp8 cache →
    near-identical logits."""
    params = _params()
    tok = jnp.asarray(5, jnp.int32)
    kcf, vcf = model.init_cache(CFG, dtype=jnp.float8_e4m3fn)
    kce, vce = kcf, vcf
    for step in range(3):
        pos = jnp.asarray(step, jnp.int32)
        lf, kcf, vcf = model.decode_step(params, kcf, vcf, tok, pos, CFG)
        le, kce, vce = _f32_step(params, kce, vce, tok, pos)
    np.testing.assert_allclose(np.asarray(lf, np.float32),
                               np.asarray(le, np.float32),
                               atol=0.12, rtol=0.05)


# --------------------------------------------------------------------------
# engine integration
# --------------------------------------------------------------------------


def test_engine_quantized_generation():
    from clusterfusion.models.generation import Llama
    eng = Llama.synthetic(CFG, quant="int8", kv_dtype=jnp.float8_e4m3fn)
    toks = list(eng.stream_generate([1, 2, 3], max_gen_len=4,
                                    temperature=0.0))
    assert len(toks) == 4
    assert all(0 <= t < CFG.vocab_size for t in toks)


def test_int8_lm_head():
    """Per-column int8 LM head: decode and prefill consume the
    QuantizedTensor; logits must match the bf16 LM head to int8 rounding,
    and the fp32 step on the same quantized head."""
    params = _params()
    qp = quantize_llama_params(params, "int8", 128, lm_head=True)
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(3, jnp.int32)
    pos = jnp.asarray(0, jnp.int32)

    lf, _, _ = model.decode_step(qp, kc, vc, tok, pos, CFG)
    le, _, _ = _f32_step(qp, kc, vc, tok, pos)
    np.testing.assert_allclose(np.asarray(lf, np.float32),
                               np.asarray(le, np.float32),
                               atol=0.12, rtol=0.05)

    # vs the bf16 head on otherwise-identical int8 weights
    qp_bf = quantize_llama_params(params, "int8", 128, lm_head=False)
    lb, _, _ = model.decode_step(qp_bf, kc, vc, tok, pos, CFG)
    a, b = np.asarray(lf, np.float32), np.asarray(lb, np.float32)
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert np.max(np.abs(a - b)) < 0.02 * scale
    # prefill path consumes the quantized head too
    lg, _, _ = model.prefill(qp, kc, vc, jnp.arange(4, dtype=jnp.int32), CFG)
    assert np.all(np.isfinite(np.asarray(lg, np.float32)))
