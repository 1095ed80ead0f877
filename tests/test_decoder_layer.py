"""Decoder-layer public ops vs fp32 JAX oracle.

Mirrors the reference's oracle-diff strategy (`tests/test_llama_tilelang.py`):
random weights scaled ×0.1, seqlens including the odd 37 and the seq=1 edge
case (exercising padding/bounds logic), all four outputs checked, and a
determinism assert replacing the reference's 10k-repetition race hunt
(SURVEY.md §4)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.ops import llama_decoder_layer, llama_decoder_layer_sglang
from clusterfusion.ops.reference import (
    llama_decoder_layer_ref,
    llama_decoder_layer_sglang_ref,
)
from clusterfusion.ops.rope import rope_tables_gptj

HIDDEN = 512
HEADS = 4
HEAD_DIM = 128


def _mae(a, b):
    return float(jnp.mean(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


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


@pytest.mark.parametrize("seqlen", [1, 37, 256, 1024, 4096])
def test_sglang_variant_matches_oracle(seqlen):
    d = _make_inputs(jax.random.PRNGKey(seqlen), seqlen)
    angle = jax.random.uniform(jax.random.PRNGKey(99), (HEAD_DIM // 2,),
                               jnp.float32) * math.pi
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    eps = 1e-5

    got = llama_decoder_layer_sglang(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], eps, cos, sin)
    want = llama_decoder_layer_sglang_ref(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], eps, cos, sin,
        n_heads=HEADS, head_dim=HEAD_DIM)

    # Reference tolerances (test_llama_tilelang.py:100), relaxed fp16→bf16.
    assert _max_err(got[1], want[1]) < 2e-2, "residual"
    assert _max_err(got[2], want[2]) < 5e-2, "k_new"
    assert _max_err(got[3], want[3]) < 5e-2, "v_new"
    assert _max_err(got[0], want[0]) < 1e-1, "output"
    assert _mae(got[0], want[0]) < 1e-2, "output mae"


@pytest.mark.parametrize("seqlen", [1, 37, 256])
def test_gptj_variant_matches_oracle(seqlen):
    d = _make_inputs(jax.random.PRNGKey(seqlen + 1000), seqlen)
    pos = seqlen
    cos_t, sin_t = rope_tables_gptj(HEAD_DIM, pos + 1)
    cos, sin = cos_t[pos:pos + 1], sin_t[pos:pos + 1]

    got = llama_decoder_layer(
        d["input"], d["w_qkv"], d["w_o"], d["k_cache"], d["v_cache"],
        d["rms_w"], cos, sin)
    want = llama_decoder_layer_ref(
        d["input"], d["w_qkv"], d["w_o"], d["k_cache"], d["v_cache"],
        d["rms_w"], cos, sin, n_heads=HEADS, head_dim=HEAD_DIM)

    assert _max_err(got[1], want[1]) < 5e-2, "k_new"
    assert _max_err(got[2], want[2]) < 5e-2, "v_new"
    assert _max_err(got[0], want[0]) < 1e-1, "output"
    assert _mae(got[0], want[0]) < 1e-2, "output mae"


def test_llama7b_geometry_smoke():
    """One case at the reference's true operating point (hidden 4096,
    32 heads — `H100/llama/config.h:2-5`), short cache for CI speed."""
    seqlen, hidden = 64, 4096
    d = _make_inputs(jax.random.PRNGKey(7), seqlen, hidden=hidden)
    angle = jax.random.uniform(jax.random.PRNGKey(8), (128 // 2,),
                               jnp.float32) * math.pi
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    got = llama_decoder_layer_sglang(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], 1e-5, cos, sin)
    want = llama_decoder_layer_sglang_ref(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], 1e-5, cos, sin,
        n_heads=32, head_dim=128)
    assert _mae(got[0], want[0]) < 2e-2
    assert _max_err(got[2], want[2]) < 5e-2


@pytest.mark.parametrize("window", [1, 40, 200])
def test_sglang_window_matches_oracle(window):
    """Sliding-window attention (Mistral semantics) against the oracle;
    a window wider than the context equals full attention."""
    seqlen = 100
    d = _make_inputs(jax.random.PRNGKey(3), seqlen)
    angle = jnp.linspace(0.1, 1.0, HEAD_DIM // 2)
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    args = (d["input"], d["residual"], d["w_qkv"], d["w_o"], d["k_cache"],
            d["v_cache"], d["rms_w"], 1e-5, cos, sin)
    got = llama_decoder_layer_sglang(*args, window=window)
    want = llama_decoder_layer_sglang_ref(*args, n_heads=HEADS,
                                          head_dim=HEAD_DIM, window=window)
    assert _max_err(got[0], want[0]) < 1e-1
    assert _mae(got[0], want[0]) < 1e-2
    if window > seqlen:
        full = llama_decoder_layer_sglang(*args)
        assert _max_err(got[0], full[0]) == 0.0


def test_deterministic():
    seqlen = 37
    d = _make_inputs(jax.random.PRNGKey(5), seqlen)
    angle = jnp.linspace(0.1, 1.0, HEAD_DIM // 2)
    cos, sin = jnp.cos(angle), jnp.sin(angle)
    a = llama_decoder_layer_sglang(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], 1e-5, cos, sin)
    b = llama_decoder_layer_sglang(
        d["input"], d["residual"], d["w_qkv"], d["w_o"],
        d["k_cache"], d["v_cache"], d["rms_w"], 1e-5, cos, sin)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
