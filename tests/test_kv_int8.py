"""INT8 KV cache (`ops.quant.Int8KV`): int8 payload + per-position scales.

Checks, all through the production paths:

- decode over an int8 cache == the same step computed in fp32 over the
  same int8 cache (same quantization math);
- int8-KV decode tracks the bf16-KV decode within the quantization error
  bound (the Δ that bench_ppl.py quantifies as perplexity);
- prefill fills int8 caches (payload + scale planes) consistently with
  per-row quantization of the bf16 prefill;
- the n-row verify step scores/appends over int8 caches consistently
  with n single-token steps;
- capacities of several scale-plane rows index the planes correctly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import Int8KV, kv_scales_flat

CFG = LlamaConfig.tiny(max_seq_len=64)


def _f32_step(params, kc, vc, tok, pos, cfg):
    """The same decode step with params and caches in fp32 at highest
    matmul precision (int8 payloads stay int8)."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(model.upcast(params), model.upcast(kc),
                                 model.upcast(vc), tok, pos, cfg)


def _prefilled(cfg, dtype, toks, seed=0):
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    kc, vc = model.init_cache(cfg, dtype=dtype)
    logits, kc, vc = model.prefill(params, kc, vc,
                                   jnp.asarray(toks, jnp.int32), cfg)
    return params, logits, kc, vc


def test_int8kv_fused_matches_eager():
    toks = [5, 17, 42, 9, 3]
    params, _, kc, vc = _prefilled(CFG, "int8", toks)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(len(toks), jnp.int32)
    lf, kf, vf = model.decode_step(params, kc, vc, tok, pos, CFG)
    le, ke, ve = _f32_step(params, kc, vc, tok, pos, CFG)
    assert isinstance(kf, Int8KV) and isinstance(ke, Int8KV)
    err = float(jnp.max(jnp.abs(lf - le)))
    assert err < 0.1, f"decode vs fp32 logits max err {err}"
    # the appended int8 rows and their scales must agree.  Codes may differ
    # by a couple of ulps: bf16 and fp32 pre-quantization K/V rows near a
    # rounding boundary land on adjacent codes — the dequantized VALUES are
    # what matter (scales agree to 2e-2 below).
    np.testing.assert_allclose(
        np.asarray(kf.q[:, :, len(toks)], np.int32),
        np.asarray(ke.q[:, :, len(toks)], np.int32), atol=2)
    np.testing.assert_allclose(
        np.asarray(kv_scales_flat(kf.s, 64)[..., len(toks)]),
        np.asarray(kv_scales_flat(ke.s, 64)[..., len(toks)]),
        rtol=2e-2)


def test_int8kv_tracks_bf16():
    toks = [1, 2, 3, 4]
    params, _, k8, v8 = _prefilled(CFG, "int8", toks, seed=1)
    _, _, kb, vb = _prefilled(CFG, jnp.bfloat16, toks, seed=1)
    tok = jnp.asarray(11, jnp.int32)
    pos = jnp.asarray(len(toks), jnp.int32)
    l8, _, _ = model.decode_step(params, k8, v8, tok, pos, CFG)
    lb, _, _ = model.decode_step(params, kb, vb, tok, pos, CFG)
    scale = max(float(jnp.max(jnp.abs(lb))), 1.0)
    assert float(jnp.max(jnp.abs(l8 - lb))) < 0.05 * scale


def test_int8kv_prefill_scales_match_rowwise_quant():
    toks = [9, 8, 7, 6, 5]
    params, _, k8, v8 = _prefilled(CFG, "int8", toks, seed=2)
    _, _, kb, vb = _prefilled(CFG, jnp.float32, toks, seed=2)
    # dequantized int8 rows must reproduce the f32 rows to int8 precision
    sflat = np.asarray(kv_scales_flat(k8.s, 64))[:, :, :len(toks), None]
    deq = np.asarray(k8.q, np.float32)[:, :, :len(toks)] * sflat
    ref = np.asarray(kb, np.float32)[:, :, :len(toks)]
    amax = np.abs(ref).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(deq, ref, atol=float(amax.max()) / 127 + 1e-5)


def test_int8kv_verify_matches_single_steps():
    from clusterfusion.models.speculative import verify_step
    toks = [3, 1, 4, 1, 5]
    draft = [9, 2, 6, 5]
    params, _, kc, vc = _prefilled(CFG, "int8", toks, seed=3)
    lg_v, kv_, vv_ = verify_step(params, kc, vc,
                                 jnp.asarray(draft, jnp.int32),
                                 jnp.asarray(len(toks), jnp.int32), CFG)
    kc1, vc1 = kc, vc
    for i, t in enumerate(draft):
        lg1, kc1, vc1 = model.decode_step(
            params, kc1, vc1, jnp.asarray(t, jnp.int32),
            jnp.asarray(len(toks) + i, jnp.int32), CFG)
        err = float(jnp.max(jnp.abs(lg_v[i] - lg1)))
        assert err < 0.15, f"row {i}: verify vs step err {err}"
    np.testing.assert_allclose(np.asarray(kv_.q, np.int32),
                               np.asarray(kc1.q, np.int32), atol=1)


@pytest.mark.parametrize("cap", [256, 1024])
def test_int8kv_multichunk_capacity(cap):
    """Capacities spanning several 128-position scale rows: prefill past
    the first row, then a decode step whose append lands in the second."""
    cfg = LlamaConfig.tiny(max_seq_len=cap)
    toks = list(range(1, 140))          # fills beyond one scale row
    params, _, kc, vc = _prefilled(cfg, "int8", toks, seed=4)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(len(toks), jnp.int32)
    lf, kf, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    le, ke, _ = _f32_step(params, kc, vc, tok, pos, cfg)
    err = float(jnp.max(jnp.abs(lf - le)))
    assert err < 0.1, f"cap={cap}: decode vs fp32 err {err}"
    np.testing.assert_allclose(
        np.asarray(kv_scales_flat(kf.s, cap)[..., len(toks)]),
        np.asarray(kv_scales_flat(ke.s, cap)[..., len(toks)]), rtol=2e-2)
