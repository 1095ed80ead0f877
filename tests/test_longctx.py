"""Long-context correctness at the north-star operating lengths (4K / 8K
ctx — BASELINE.md configs[2]/[3]; the reference's own long test is 4096,
`tests/test_llama_tilelang.py:69-77`).

A random *warm* cache at a high position exercises exactly what an 8K
prefill would — the full KV chunk walk, the position masking at a
non-aligned seq, and the near-capacity append — without paying an 8K
prefill per test.  The decode step and the same step in fp32 read the same
cache, so logits must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import Int8KV, quantize_llama_params


def _warm_bf16_cache(cfg, cap, pos, seed):
    """Random K/V history in rows [0, pos), zeros above (masked rows are
    still read, so they must not be garbage — matching init_cache
    semantics)."""
    shape = (cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_)
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    mask = (jnp.arange(cap) < pos)[None, None, :, None]
    k = jnp.where(mask, jax.random.normal(ks[0], shape, jnp.bfloat16) * 0.5, 0)
    v = jnp.where(mask, jax.random.normal(ks[1], shape, jnp.bfloat16) * 0.5, 0)
    return k, v


def _to_int8kv(c):
    """bf16 cache -> Int8KV with per-(head, position) scales (both
    precisions then see identical dequantized values)."""
    from clusterfusion.ops.quant import quantize_kv_rows
    L, H, cap, hd = c.shape
    q, s = quantize_kv_rows(c)                      # [L,H,cap,hd], [L,H,cap]
    R = max(-(-cap // 128), 8)
    planes = jnp.zeros((L, H, R * 128), jnp.float32).at[:, :, :cap].set(s)
    return Int8KV(q, planes.reshape(L, H, R, 128))


@pytest.mark.parametrize("cap,quant,kv", [
    (4096, None, "bf16"),
    (4096, "int4", "bf16"),
    (8192, None, "bf16"),
    (8192, "int8", "int8"),      # the 8-bit-KV long-context operating point
])
def test_long_context_fused_matches_eager(cap, quant, kv):
    cfg = LlamaConfig.tiny(max_seq_len=cap)
    params = model.init_params(cfg, jax.random.PRNGKey(1))
    if quant:
        params = quantize_llama_params(params, quant, 128)
    pos_i = cap - 17                 # near capacity, non-aligned chunk tail
    kc, vc = _warm_bf16_cache(cfg, cap, pos_i, seed=2)
    if kv == "int8":
        kc, vc = _to_int8kv(kc), _to_int8kv(vc)
    tok = jnp.asarray(7, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)

    lf, kcf, vcf = model.decode_step(params, kc, vc, tok, pos, cfg)
    with jax.default_matmul_precision("highest"):
        le, kce, vce = model.decode_step(
            model.upcast(params), model.upcast(kc), model.upcast(vc), tok,
            pos, cfg)
    a = np.asarray(lf, np.float32)
    b = np.asarray(le, np.float32)
    assert np.all(np.isfinite(a)), (cap, quant, kv)
    scale = max(float(np.max(np.abs(b))), 1.0)
    assert np.max(np.abs(a - b)) < 0.08 * scale, (cap, quant, kv)

    # the near-capacity append landed at `pos` in both precisions
    kf = np.asarray(kcf.q if kv == "int8" else kcf, np.float32)
    ke = np.asarray(kce.q if kv == "int8" else kce, np.float32)
    assert np.any(kf[0, :, pos_i] != 0.0), "append missing"
    # int8 codes may differ by 1 ulp between bf16 and fp32 rows (rounding
    # before absmax); values, not codes, matter
    atol = 1.0 if kv == "int8" else 0.05
    np.testing.assert_allclose(kf[0, :, pos_i], ke[0, :, pos_i], atol=atol)
    # history untouched (zero-copy in-place append, no torn rows)
    np.testing.assert_array_equal(kf[0, :, : pos_i - 1],
                                  np.asarray(kc.q if kv == "int8" else kc,
                                             np.float32)[0, :, : pos_i - 1])


def test_long_context_determinism_8k():
    """Two identical 8K-ctx decode steps must be bit-equal (SURVEY §4c)."""
    cfg = LlamaConfig.tiny(max_seq_len=8192)
    params = model.init_params(cfg, jax.random.PRNGKey(3))
    pos_i = 8000
    kc, vc = _warm_bf16_cache(cfg, 8192, pos_i, seed=4)
    tok = jnp.asarray(5, jnp.int32)
    pos = jnp.asarray(pos_i, jnp.int32)
    l1, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    l2, _, _ = model.decode_step(params, kc, vc, tok, pos, cfg)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
