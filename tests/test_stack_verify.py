"""Multi-token verify step (speculative decoding) vs the fp32 oracle
forward and vs a prefill of the same tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models import speculative as spec
from clusterfusion.ops.quant import quantize_llama_params

CFG = LlamaConfig.tiny()


def _setup(cfg, seed=0, prompt_len=5, kv_dtype=jnp.bfloat16, quant=None):
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    if quant:
        params = quantize_llama_params(params, quant, 128)
    kc, vc = model.init_cache(cfg, dtype=kv_dtype)
    prompt = (jnp.arange(prompt_len, dtype=jnp.int32) * 7 + 1) % cfg.vocab_size
    _, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
    return params, kc, vc, prompt_len


def _expected(params, cfg, prompt_len, toks, kv_dtype=jnp.bfloat16):
    """(fp32 oracle logits of the verified rows, caches a prefill of
    prompt + toks writes)."""
    prompt = (jnp.arange(prompt_len, dtype=jnp.int32) * 7 + 1) % cfg.vocab_size
    seq = jnp.concatenate([prompt, toks])
    kp, vp = model.init_cache(cfg, dtype=kv_dtype)
    _, kp, vp = model.prefill(params, kp, vp, seq, cfg)
    return model.reference_logits(params, seq, cfg)[prompt_len:], kp, vp


def _check(cfg, n, **kw):
    params, kc, vc, pos0 = _setup(cfg, **kw)
    toks = (jnp.arange(n, dtype=jnp.int32) * 3 + 2) % cfg.vocab_size
    pos = jnp.asarray(pos0, jnp.int32)
    lf, kf, vf = spec.verify_step(params, kc, vc, toks, pos, cfg)
    le, ke, ve = _expected(params, cfg, pos0, toks)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.06 * scale
    np.testing.assert_allclose(np.asarray(kf, np.float32),
                               np.asarray(ke, np.float32), atol=0.08)
    np.testing.assert_allclose(np.asarray(vf, np.float32),
                               np.asarray(ve, np.float32), atol=0.08)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_fused_verify_matches_eager(n):
    _check(CFG, n)


def test_gqa():
    _check(LlamaConfig.tiny(n_kv_heads=2), 4)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized(quant):
    _check(CFG, 4, quant=quant)


def test_fp8_cache():
    params, kc, vc, pos0 = _setup(CFG, kv_dtype=jnp.float8_e4m3fn)
    toks = jnp.asarray([2, 9, 4], jnp.int32)
    pos = jnp.asarray(pos0, jnp.int32)
    lf, kf, _ = spec.verify_step(params, kc, vc, toks, pos, CFG)
    le, ke, _ = _expected(params, CFG, pos0, toks, jnp.float8_e4m3fn)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    # the oracle reads exact K/V; the verify step reads them as e4m3
    assert float(jnp.max(jnp.abs(lf - le))) < 0.15 * scale
    # layer 0 sees identical inputs -> rows agree to 1 fp8 ulp (12.5% rel);
    # deeper layers accumulate fp8 attention differences from below
    a = np.asarray(kf, np.float32)
    b = np.asarray(ke, np.float32)
    assert np.all(np.abs(a[0] - b[0])
                  <= 0.13 * np.maximum(np.abs(a[0]), np.abs(b[0])) + 0.03)
    assert np.max(np.abs(a - b)) < 0.5


def test_near_capacity_edge():
    """The verified rows end 3 positions short of the cache capacity."""
    cfg = LlamaConfig.tiny(max_seq_len=64)
    params, kc, vc, _ = _setup(cfg, prompt_len=57)
    toks = jnp.asarray([5, 1, 2, 8], jnp.int32)
    pos = jnp.asarray(57, jnp.int32)          # 57 + 4 <= 64
    lf, kf, vf = spec.verify_step(params, kc, vc, toks, pos, cfg)
    le, ke, ve = _expected(params, cfg, 57, toks)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.06 * scale
    np.testing.assert_allclose(np.asarray(kf, np.float32),
                               np.asarray(ke, np.float32), atol=0.08)


def test_deterministic():
    params, kc, vc, pos0 = _setup(CFG)
    toks = jnp.asarray([2, 9, 4], jnp.int32)
    pos = jnp.asarray(pos0, jnp.int32)
    l1, *_ = spec.verify_step(params, kc, vc, toks, pos, CFG)
    l2, *_ = spec.verify_step(params, kc, vc, toks, pos, CFG)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
