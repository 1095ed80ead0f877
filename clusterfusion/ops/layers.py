"""The reference's public op surface (`pybind.cpp:108-123`), in plain JAX.

Each op keeps the reference's name, argument layout and semantics and is
computed in the input's dtype: bf16 operands with fp32 accumulation, fp32
norms, softmax and RoPE.  XLA fuses the elementwise work into its matmuls;
the fp32 oracles these are tested against live in ``ops.reference``.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from clusterfusion.ops.reference import fused_add_rmsnorm_ref, rmsnorm_ref
from clusterfusion.ops.rope import apply_rope_gptj, apply_rope_neox

f32 = jnp.float32


@functools.partial(jax.jit, static_argnames=("eps",))
def rmsnorm(input: jnp.ndarray, weight: jnp.ndarray,
            eps: float = 1e-6) -> jnp.ndarray:
    """y = x * rsqrt(mean(x², axis=-1) + eps) * w, in fp32, cast back.
    Twin of the reference op ``clusterfusion.rmsnorm``
    (`pybind.cpp:61-64,114`)."""
    return rmsnorm_ref(input, weight, eps)


@functools.partial(jax.jit, static_argnames=("eps",))
def fused_add_rmsnorm(input: jnp.ndarray, residual: jnp.ndarray,
                      weight: jnp.ndarray, eps: float = 1e-5):
    """h = input + residual; returns (rmsnorm(h), h)."""
    return fused_add_rmsnorm_ref(input, residual, weight, eps)


def _dot(a, b):
    return jnp.dot(a, b.astype(a.dtype), preferred_element_type=f32)


def _attention_half(xn, wq, wk, wv, wo, k_cache, v_cache, rope, heads: int,
                    window: int = 0):
    """QKV from [in, out] weights, RoPE, attention over the cache plus the
    current token, O projection.  xn [1, hidden] (normed, compute dtype);
    caches [seq, hidden].  Returns (out, k_new, v_new), each [1, hidden]."""
    dt = xn.dtype
    hidden = xn.shape[-1]
    hd = hidden // heads
    q = rope(_dot(xn, wq).reshape(heads, hd))
    k = rope(_dot(xn, wk).reshape(heads, hd))
    v = _dot(xn, wv).astype(dt).reshape(heads, hd)
    seq = k_cache.shape[0]
    K = jnp.concatenate([k_cache.reshape(seq, heads, hd), k.astype(dt)[None]])
    V = jnp.concatenate([v_cache.reshape(seq, heads, hd), v[None]])
    s = jnp.einsum("hd,shd->hs", q.astype(dt), K,
                   preferred_element_type=f32) / math.sqrt(hd)
    if window:
        s = jnp.where(jnp.arange(seq + 1) >= seq + 1 - window, s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1).astype(dt)
    o = jnp.einsum("hs,shd->hd", p, V, preferred_element_type=f32)
    out = _dot(o.astype(dt).reshape(1, hidden), wo).astype(dt)
    return (out, k.astype(dt).reshape(1, hidden),
            v.reshape(1, hidden))


@functools.partial(jax.jit, static_argnames=("eps", "window"))
def llama_decoder_layer_sglang(
    input: jnp.ndarray,       # [1, hidden]
    residual: jnp.ndarray,    # [1, hidden]
    weight_qkv: jnp.ndarray,  # [3*hidden, hidden]  (torch Linear [out, in])
    weight_o: jnp.ndarray,    # [hidden, hidden]
    k_cache: jnp.ndarray,     # [seq, hidden]
    v_cache: jnp.ndarray,     # [seq, hidden]
    rms_w: jnp.ndarray,       # [hidden]
    eps: float,
    cos: jnp.ndarray,         # [head_dim/2]
    sin: jnp.ndarray,         # [head_dim/2]
    window: int = 0,
):
    """Attention half of a decoder layer, sglang variant: fused residual
    add, RMSNorm with runtime eps, QKV, NEOX RoPE, decode attention, O
    projection; weights in torch Linear [out, in] layout.  Twin of the
    reference op `clusterfusion.llama_decoder_layer_sglang`
    (`pybind.cpp:14-25,111`).

    ``window`` > 0 enables sliding-window attention (Mistral semantics: the
    token at position seq attends positions >= seq+1-window only; the
    reference is full-context-only).

    Returns (output, residual_out, k_new, v_new), each [1, hidden]."""
    hidden = input.shape[-1]
    heads = hidden // (2 * cos.shape[-1])
    xn, res = fused_add_rmsnorm_ref(input, residual, rms_w, eps)
    wq, wk, wv = jnp.split(weight_qkv.T, 3, axis=1)
    rope = lambda x: apply_rope_neox(x, cos.astype(f32), sin.astype(f32))
    out, k_new, v_new = _attention_half(xn, wq, wk, wv, weight_o.T, k_cache,
                                        v_cache, rope, heads, window)
    return out, res, k_new, v_new


@functools.partial(jax.jit, static_argnames=("eps",))
def llama_decoder_layer(
    input: jnp.ndarray,       # [1, hidden]
    weight_qkv: jnp.ndarray,  # [3*hidden, hidden] of stacked W.T ([in, out]) blocks
    weight_o: jnp.ndarray,    # [hidden, hidden] = wo.T ([in, out])
    k_cache: jnp.ndarray,     # [seq, hidden]
    v_cache: jnp.ndarray,     # [seq, hidden]
    rms_w: jnp.ndarray,       # [hidden]
    cos: jnp.ndarray,         # [1, head_dim] repeat_interleaved
    sin: jnp.ndarray,         # [1, head_dim]
    eps: float = 1e-6,
):
    """Attention half of a decoder layer, meta-llama variant: GPT-J
    interleaved RoPE, no residual add (caller adds,
    `chat/llama/model.py:492`), eps=1e-6 (`kernel.cuh:58`), weights in the
    transposed [in, out] layout built by ``_build_cf_weights``
    (`chat/llama/model.py:316-322`).  Twin of the reference op
    `clusterfusion.llama_decoder_layer` (`pybind.cpp:3-12,110`).

    Returns (output, k_new, v_new), each [1, hidden]."""
    hidden = input.shape[-1]
    hd = cos.shape[-1]
    xn = rmsnorm_ref(input, rms_w, eps)
    wq, wk, wv = jnp.split(weight_qkv, 3, axis=0)
    rope = lambda x: apply_rope_gptj(x, cos.reshape(1, hd).astype(f32),
                                     sin.reshape(1, hd).astype(f32))
    return _attention_half(xn, wq, wk, wv, weight_o, k_cache, v_cache, rope,
                           hidden // hd)


@functools.partial(jax.jit, static_argnames=("layer_id", "eps", "n_heads",
                                             "head_dim"))
def llama_decoder_layer_batch_decode_sglang(
    input: jnp.ndarray,            # [batch, hidden]
    residual: jnp.ndarray,         # [batch, hidden]
    weight_qkv: jnp.ndarray,       # [3*hidden, hidden] ([out, in])
    weight_o: jnp.ndarray,         # [hidden, hidden]   ([out, in])
    paged_kv_indptr: jnp.ndarray,  # [batch+1] int32
    paged_kv_indices: jnp.ndarray, # [total] int32, page size = 1 token
    k_cache: jnp.ndarray,          # [n_layers, num_pages, hidden]
    v_cache: jnp.ndarray,          # [n_layers, num_pages, hidden]
    layer_id: int,
    rms_w: jnp.ndarray,            # [hidden]
    eps: float,
    positions: jnp.ndarray,        # [batch] int32
    cos_sin: jnp.ndarray,          # [max_pos, head_dim]: cos half ‖ sin half
    n_heads: int = 32,
    head_dim: int = 128,
):
    """Batched decode over a paged KV pool with sglang's calling convention
    (`pybind.cpp:27-43,112`), functional: returns (output, residual_out,
    k_cache', v_cache') with the new token's K/V written to pool row
    ``indices[indptr[b+1]-1]`` (`kernel_batch_sglang.cuh:340-346`).

    A composition over the serving engine's pieces: the indptr/indices
    lists become a one-token-page block table and the attention is
    ``ops.paged_attention.paged_attention``."""
    from clusterfusion.ops.paged_attention import paged_attention
    B, hidden = input.shape
    hd, heads = head_dim, n_heads
    L, num_pages, _ = k_cache.shape
    xn, res = fused_add_rmsnorm_ref(input, residual, rms_w, eps)
    qkv = _dot(xn, weight_qkv.T).astype(input.dtype)       # [B, 3*hidden]
    q, k, v = (t.reshape(B, heads, hd) for t in jnp.split(qkv, 3, axis=-1))
    cs = cos_sin.astype(f32)[positions]                    # [B, hd]
    cos, sin = cs[:, None, : hd // 2], cs[:, None, hd // 2:]
    q = apply_rope_neox(q.astype(f32), cos, sin).astype(input.dtype)
    k = apply_rope_neox(k.astype(f32), cos, sin).astype(input.dtype)

    # indptr/indices (page=1) -> block table; row b lists the request's
    # pages INCLUDING the tail slot for the new token
    max_pages = paged_kv_indices.shape[0]
    j = jnp.arange(max_pages)[None, :]
    starts = paged_kv_indptr[:-1, None]
    table = paged_kv_indices[jnp.clip(starts + j, 0, max_pages - 1)]
    seq_lens = paged_kv_indptr[1:] - paged_kv_indptr[:-1] - 1  # excl. new

    o, kp, vp = paged_attention(
        q[:, :, None], k, v, k_cache.reshape(L, num_pages, heads, 1, hd),
        v_cache.reshape(L, num_pages, heads, 1, hd), table, seq_lens,
        layer_id)
    out = _dot(o, weight_o.T).astype(input.dtype)
    return (out, res, kp.reshape(L, num_pages, hidden),
            vp.reshape(L, num_pages, hidden))


@functools.partial(jax.jit, static_argnames=(
    "n_heads", "nope_dim", "rope_dim", "lora_rank", "eps"))
def deepseek_decoder_layer(
    input: jnp.ndarray,          # [1, hidden]
    weight_q_nope: jnp.ndarray,  # [heads*nope_dim, hidden]  ([out, in])
    weight_q_pe: jnp.ndarray,    # [heads*rope_dim, hidden]
    weight_uk: jnp.ndarray,      # [heads, nope_dim, lora_rank]
    weight_kv_nope: jnp.ndarray, # [lora_rank, hidden]
    weight_k_pe: jnp.ndarray,    # [rope_dim, hidden]
    weight_uv: jnp.ndarray,      # [heads, lora_rank, nope_dim]
    weight_o: jnp.ndarray,       # [hidden, heads*nope_dim]  ([out, in])
    ckv_cache: jnp.ndarray,      # [seq, lora_rank + rope_dim]
    rms_input_weight: jnp.ndarray,  # [hidden]
    rms_ckv_weight: jnp.ndarray,    # [lora_rank]
    cos: jnp.ndarray,            # [rope_dim/2]
    sin: jnp.ndarray,            # [rope_dim/2]
    n_heads: int = 16,
    nope_dim: int = 128,
    rope_dim: int = 64,
    lora_rank: int = 512,
    eps: float = 1e-6,
):
    """MLA decode layer.  Twin of the reference op
    `clusterfusion.deepseek_decoder_layer` (`pybind.cpp:45-59,113`).
    Returns (output [1, hidden], ckv_new [1, lora_rank + rope_dim]) — the
    reference returns output only and never appends to the cache; ckv_new
    fixes that.  The math is ``models.deepseek``'s decode layer on the
    fused projection layout."""
    from clusterfusion.config import DeepSeekConfig
    from clusterfusion.models.deepseek import _eager_mla
    cfg = DeepSeekConfig(hidden_dim=input.shape[-1], n_heads=n_heads,
                         nope_head_dim=nope_dim, rope_head_dim=rope_dim,
                         kv_lora_rank=lora_rank, norm_eps=eps)
    p = {"wproj": jnp.concatenate([weight_q_nope.T, weight_q_pe.T,
                                   weight_kv_nope.T, weight_k_pe.T], axis=-1),
         "wuk": weight_uk, "wuv": weight_uv, "wo_t": weight_o.T,
         "attn_norm": rms_input_weight, "ckv_norm": rms_ckv_weight}
    return _eager_mla(input, p, ckv_cache, ckv_cache.shape[0], cos, sin, cfg)
