"""MoE FFN: router properties, decode-vs-dense parity, and the DeepSeek
model with routed experts end-to-end (capability beyond the reference,
which has no FFN/MoE path — `include/H100/deepseek/` is attention-only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import DeepSeekConfig
from clusterfusion.models import deepseek as model
from clusterfusion.models.llama import upcast
from clusterfusion.ops.moe import (moe_ffn_decode, moe_ffn_dense,
                                       route_top_k)


def _f32(params, cache, tok, pos, cfg):
    """The same decode step with params and cache in fp32 at highest
    matmul precision (int8 payloads stay int8)."""
    with jax.default_matmul_precision("highest"):
        return model.decode_step(upcast(params), upcast(cache), tok, pos, cfg)

E, H, F = 8, 256, 128


def _weights(key):
    ks = jax.random.split(key, 4)
    r = lambda k, s, f: (jax.random.normal(k, s, jnp.float32) / np.sqrt(f)
                         ).astype(jnp.bfloat16)
    return (r(ks[0], (H, E), H), r(ks[1], (E, 2, H, F), H),
            r(ks[2], (E, F, H), F))


def test_router_top_k():
    router_w, _, _ = _weights(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (5, H), jnp.bfloat16)
    for k in (1, 2, 4):
        g, sel = route_top_k(x, router_w, k)
        nz = np.count_nonzero(np.asarray(g), axis=-1)
        np.testing.assert_array_equal(nz, k)
        np.testing.assert_allclose(np.asarray(jnp.sum(g, -1)), 1.0,
                                   rtol=1e-5)
        assert sel.shape == (5, k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_decode_matches_dense(top_k):
    """The gathered-expert decode formulation == the masked-dense one."""
    router_w, w13, w2 = _weights(jax.random.PRNGKey(2))
    x = jax.random.normal(jax.random.PRNGKey(3), (1, H), jnp.bfloat16)
    a = moe_ffn_decode(x, router_w, w13, w2, top_k)
    b = moe_ffn_dense(x, router_w, w13, w2, top_k)
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=0.02)


MOE_CFG = DeepSeekConfig.tiny(n_experts=4, moe_top_k=2, moe_ffn_dim=256)


def test_deepseek_moe_fused_vs_eager():
    params = model.init_params(MOE_CFG, jax.random.PRNGKey(4))
    cache = model.init_cache(MOE_CFG)
    toks = jnp.asarray([5, 17, 42], jnp.int32)
    logits, cache = model.prefill(params, cache, toks, MOE_CFG)
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)
    pos = jnp.asarray(3, jnp.int32)
    lf, _ = model.decode_step(params, cache, tok, pos, MOE_CFG)
    le, _ = _f32(params, cache, tok, pos, MOE_CFG)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale


def test_deepseek_moe_prefill_decode_consistency():
    """prefill(T) [masked-dense MoE] + decode [gathered MoE] == prefill(T+1)
    — the two MoE formulations must agree through the model."""
    params = model.init_params(MOE_CFG, jax.random.PRNGKey(5))
    cache = model.init_cache(MOE_CFG)
    toks = jnp.asarray([3, 1, 4, 1, 5], jnp.int32)
    l_all, _ = model.prefill(params, cache, toks, MOE_CFG)
    l_pre, c = model.prefill(params, cache, toks[:-1], MOE_CFG)
    l_dec, _ = model.decode_step(params, c, toks[-1],
                                 jnp.asarray(4, jnp.int32), MOE_CFG)
    scale = max(float(jnp.max(jnp.abs(l_all[-1]))), 1.0)
    assert float(jnp.max(jnp.abs(l_dec - l_all[-1]))) < 0.05 * scale


def test_deepseek_moe_generate():
    params = model.init_params(MOE_CFG, jax.random.PRNGKey(6))
    out = model.generate_greedy(params, MOE_CFG, [1, 2, 3], n_gen=4)
    assert len(out) == 4 and all(0 <= t < MOE_CFG.vocab_size for t in out)
    assert out == model.generate_greedy(params, MOE_CFG, [1, 2, 3], n_gen=4)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_moe_quantized_matches_dequantized(kind):
    """Quantized routed experts (round 5): int8 streams per-expert with
    scale-after-dot, int4 dequantizes only the gathered top-k experts.
    Both formulations must match running the dequantized bf16 experts."""
    from clusterfusion.ops.quant import quantize

    rng = jax.random.PRNGKey(7)
    ks = jax.random.split(rng, 4)
    router = jax.random.normal(ks[0], (H, E), jnp.bfloat16) * 0.1
    w13 = jax.random.normal(ks[1], (E, 2, H, F), jnp.bfloat16) * 0.05
    w2 = jax.random.normal(ks[2], (E, F, H), jnp.bfloat16) * 0.05
    q13 = quantize(w13, kind, -2, 128, -2)
    q2 = quantize(w2, kind, -2, 128, -2)
    d13 = q13.dequantize(jnp.bfloat16)
    d2 = q2.dequantize(jnp.bfloat16)

    x1 = jax.random.normal(ks[3], (1, H), jnp.bfloat16)
    oq = moe_ffn_decode(x1, router, q13, q2, 2)
    od = moe_ffn_decode(x1, router, d13, d2, 2)
    np.testing.assert_allclose(np.asarray(oq, np.float32),
                               np.asarray(od, np.float32),
                               atol=0.03, rtol=0.05)

    xt = jax.random.normal(jax.random.PRNGKey(9), (5, H), jnp.bfloat16)
    oqd = moe_ffn_dense(xt, router, q13, q2, 2)
    odd = moe_ffn_dense(xt, router, d13, d2, 2)
    np.testing.assert_allclose(np.asarray(oqd, np.float32),
                               np.asarray(odd, np.float32),
                               atol=0.03, rtol=0.05)


def test_deepseek_moe_model_quantized_decode():
    """End-to-end DeepSeek MoE model with a fully quantized tree (MLA
    projections + dense FFN + routed experts): decode matches the fp32
    step on the same int8 tree."""
    from clusterfusion.ops.quant import (QuantizedTensor,
                                             quantize_deepseek_params)

    cfg = DeepSeekConfig.tiny(n_experts=4, moe_ffn_dim=128, ffn_dim=512)
    params = model.init_params(cfg, jax.random.PRNGKey(3))
    qparams = quantize_deepseek_params(params, "int8")
    assert isinstance(qparams["layers"]["w13_e"], QuantizedTensor)
    cache = model.init_cache(cfg)
    toks = jnp.asarray([5, 17, 42, 9], jnp.int32)
    logits, cache = model.prefill(qparams, cache, toks, cfg)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(4, jnp.int32)
    lf, _ = model.decode_step(qparams, cache, tok, pos, cfg)
    le, _ = _f32(qparams, cache, tok, pos, cfg)
    scale = max(float(jnp.max(jnp.abs(le))), 1.0)
    assert float(jnp.max(jnp.abs(lf - le))) < 0.05 * scale
