"""Prefill attention (``models.llama.attend`` and the first chunk's
``prompt_attention``) vs a self-contained fp32 oracle.

Covers the reference test plan's odd/edge sequence lengths (seqlens
{1, 37, 256} of `tests/test_llama_tilelang.py:69-77`) plus what the
reference cannot do: GQA panels and chunked-prefill query offsets.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.models.llama import attend, prompt_attention


def oracle(q, k, v, q_offset, window=0):
    kv, T, g, hd = q.shape
    S = k.shape[1]
    scores = jnp.einsum("ktgd,ksd->ktgs", q.astype(jnp.float32),
                        k.astype(jnp.float32)) / np.sqrt(hd)
    qpos = q_offset + jnp.arange(T)[None, :, None, None]
    kpos = jnp.arange(S)[None, None, None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = jnp.where(mask, scores, -1e30)
    p = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("ktgs,ksd->ktgd", p, v.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("q_offset", "window"))
def prefill_attention(q, k, v, q_offset=0, window=0):
    """attend() on q [kv, T, g, hd], k/v [kv, S, hd] with keys at positions
    0..S-1 and queries at q_offset..  Computed in fp32: these tests check
    the causal, offset and GQA masking (the CPU backend has no batched
    bf16 x bf16 -> f32 dot for every layout)."""
    T, S = q.shape[1], k.shape[1]
    f32 = jnp.float32
    o = attend(q.transpose(1, 0, 2, 3).astype(f32), k.astype(f32),
               v.astype(f32), q_offset + jnp.arange(T), jnp.arange(S), window)
    return o.transpose(1, 0, 2, 3)


def _run(kv, T, g, hd, q_offset=0, extra_keys=0, seed=0):
    rng = np.random.RandomState(seed)
    S = q_offset + T + extra_keys
    q = jnp.asarray(rng.randn(kv, T, g, hd), jnp.bfloat16)
    k = jnp.asarray(rng.randn(kv, S, hd), jnp.bfloat16)
    v = jnp.asarray(rng.randn(kv, S, hd), jnp.bfloat16)
    o = prefill_attention(q, k, v, q_offset=q_offset)
    ref = oracle(q, k, v, q_offset)
    np.testing.assert_allclose(np.asarray(o, np.float32), np.asarray(ref),
                               atol=0.03, rtol=0.05)
    return o


@pytest.mark.parametrize("T", [1, 37, 256])
def test_seqlens(T):
    _run(kv=2, T=T, g=1, hd=128)


def test_gqa_panel():
    _run(kv=2, T=64, g=4, hd=128)


def test_blocks_smaller_than_seq():
    # odd length, head_dim 64, GQA group 2
    _run(kv=1, T=130, g=2, hd=64)


@pytest.mark.parametrize("q_offset,extra", [(93, 0), (70, 30), (1, 1)])
def test_chunked_offsets(q_offset, extra):
    # chunk continuation: queries shifted, padded keys beyond the chunk
    # must never influence the output
    _run(kv=2, T=33, g=2, hd=64, q_offset=q_offset, extra_keys=extra)


def test_padded_keys_ignored():
    # same inputs, garbage vs zeros in the never-read key tail -> identical
    rng = np.random.RandomState(3)
    kv, T, hd, S = 1, 40, 64, 64
    q = jnp.asarray(rng.randn(kv, T, 1, hd), jnp.bfloat16)
    k = jnp.asarray(rng.randn(kv, S, hd), jnp.bfloat16)
    v = jnp.asarray(rng.randn(kv, S, hd), jnp.bfloat16)
    tail = jnp.zeros((kv, S - T, hd), jnp.bfloat16)
    k2 = jnp.concatenate([k[:, :T], tail + 37.0], axis=1)
    v2 = jnp.concatenate([v[:, :T], tail - 11.0], axis=1)
    o1 = prefill_attention(q, k, v)
    o2 = prefill_attention(q, k2, v2)
    np.testing.assert_array_equal(np.asarray(o1, np.float32),
                                  np.asarray(o2, np.float32))


def test_deterministic():
    # XLA determinism replaces the reference's 10k-repetition race sweep
    # (`tests/test_llama.py:22`): two runs must be bit-equal
    o1 = _run(kv=2, T=37, g=2, hd=64, seed=5)
    o2 = _run(kv=2, T=37, g=2, hd=64, seed=5)
    np.testing.assert_array_equal(np.asarray(o1, np.float32),
                                  np.asarray(o2, np.float32))


def _prompt(kv, T, g, hd, window, dtype, seed=0):
    """prompt_attention on q [kv, T, g, hd], k/v [kv, T, hd] against the
    oracle; returns (output, oracle) as [kv, T, g, hd] f32 arrays."""
    rng = np.random.RandomState(seed)
    q = jnp.asarray(rng.randn(kv, T, g, hd), dtype)
    k = jnp.asarray(rng.randn(kv, T, hd), dtype)
    v = jnp.asarray(rng.randn(kv, T, hd), dtype)
    o = jax.jit(prompt_attention, static_argnames=("window",))(
        q.transpose(1, 0, 2, 3)[None], k, v, window)
    return (np.asarray(o[0].transpose(1, 0, 2, 3), np.float32),
            np.asarray(oracle(q, k, v, 0, window)))


@pytest.mark.parametrize("window", [0, 24])
def test_prompt_attention_off_gpu_is_attend(window):
    """Off the GPU a prompt's first chunk runs the einsum path, windowed
    or not."""
    o, ref = _prompt(kv=2, T=70, g=2, hd=64, window=window,
                     dtype=jnp.float32)
    np.testing.assert_allclose(o, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("T,window,g,hd", [(1024, 0, 1, 128),
                                           (301, 0, 4, 128),
                                           (700, 256, 4, 128),
                                           (130, 0, 8, 64)])
def test_prompt_attention_cudnn_matches_oracle(gpu, T, window, g, hd):
    """On the card a prompt's first chunk runs cuDNN's fused attention:
    causal, windowed, GQA, odd lengths, head_dim 64 and 128."""
    o, ref = _prompt(kv=2, T=T, g=g, hd=hd, window=window,
                     dtype=jnp.bfloat16)
    np.testing.assert_allclose(o, ref, atol=0.03, rtol=0.05)
