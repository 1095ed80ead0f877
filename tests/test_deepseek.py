"""DeepSeek MLA decode layer vs fp32 oracle (DeepSeek-V2-lite geometry,
reference `deepseek/config.h:1-8`), with dynamic seqlens — the reference
prototype only ever ran SEQ_LEN 4096."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import DeepSeekConfig
from clusterfusion.ops import deepseek_decoder_layer
from clusterfusion.ops.reference import deepseek_decoder_layer_ref

CFG = DeepSeekConfig(hidden_dim=1024, n_heads=4)   # scaled-down lite geometry


def _mx(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def _make(key, seq, cfg=CFG, dtype=jnp.bfloat16):
    h, nope, rope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    hid = cfg.hidden_dim
    ks = jax.random.split(key, 12)
    r = lambda k, shape, s=0.1: (jax.random.normal(k, shape, jnp.float32) * s).astype(dtype)
    angle = jax.random.uniform(ks[11], (rope // 2,), jnp.float32) * 3.0
    return dict(
        input=r(ks[0], (1, hid), 1.0),
        weight_q_nope=r(ks[1], (h * nope, hid)),
        weight_q_pe=r(ks[2], (h * rope, hid)),
        weight_uk=r(ks[3], (h, nope, lora)),
        weight_kv_nope=r(ks[4], (lora, hid)),
        weight_k_pe=r(ks[5], (rope, hid)),
        weight_uv=r(ks[6], (h, lora, nope)),
        weight_o=r(ks[7], (hid, h * nope)),
        ckv_cache=r(ks[8], (seq, lora + rope), 1.0),
        rms_input_weight=r(ks[9], (hid,)),
        rms_ckv_weight=r(ks[10], (lora,)),
        cos=jnp.cos(angle), sin=jnp.sin(angle),
    )


@pytest.mark.parametrize("seq", [1, 37, 300])
def test_mla_matches_oracle(seq):
    d = _make(jax.random.PRNGKey(seq), seq)
    kw = dict(n_heads=CFG.n_heads, nope_dim=CFG.nope_head_dim,
              rope_dim=CFG.rope_head_dim, lora_rank=CFG.kv_lora_rank)
    got_out, got_ckv = deepseek_decoder_layer(**d, **kw)
    want_out, want_ckv = deepseek_decoder_layer_ref(**d, **kw)
    assert _mx(got_ckv, want_ckv) < 5e-2, "ckv_new"
    assert _mx(got_out, want_out) < 1e-1, "output"
    assert float(jnp.mean(jnp.abs(got_out.astype(jnp.float32)
                                  - want_out.astype(jnp.float32)))) < 1e-2


def test_mla_deterministic():
    d = _make(jax.random.PRNGKey(5), 64)
    kw = dict(n_heads=CFG.n_heads, nope_dim=CFG.nope_head_dim,
              rope_dim=CFG.rope_head_dim, lora_rank=CFG.kv_lora_rank)
    a = deepseek_decoder_layer(**d, **kw)
    b = deepseek_decoder_layer(**d, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
