"""Pure-JAX fp32 reference implementations (oracles) for the public ops
and the paged attention.

These are the ground truth the ops, the paged-attention kernel and the
serving path are tested against — the same role the self-contained PyTorch
oracle plays in the reference (`tests/test_llama_tilelang.py:18-49`).
Everything is computed in fp32 and cast back to the input dtype at the end,
mirroring the reference kernels' fp16-storage/fp32-accumulate discipline
(`kernel.cuh:58-62`).  On a GPU, call them under
``jax.default_matmul_precision("highest")``: fp32 matmuls there otherwise
run in TF32.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from clusterfusion.ops.rope import apply_rope_gptj, apply_rope_neox


def rmsnorm_ref(x: jnp.ndarray, weight: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Batched RMSNorm: y = x / sqrt(mean(x^2) + eps) * w.

    Oracle for the standalone ``rmsnorm`` op (reference `norm/kernel.cuh:8-77`,
    which normalizes bs=64 × hidden=8192 rows)."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps) * weight.astype(jnp.float32)
    return y.astype(x.dtype)


def fused_add_rmsnorm_ref(x: jnp.ndarray, residual: jnp.ndarray,
                          weight: jnp.ndarray, eps: float = 1e-5
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """h = x + residual; returns (rmsnorm(h), h) — the flashinfer
    ``fused_add_rmsnorm`` semantics the sglang kernel fuses in
    (`kernel_sglang.cuh:98-106`)."""
    h = x.astype(jnp.float32) + residual.astype(jnp.float32)
    var = jnp.mean(h * h, axis=-1, keepdims=True)
    y = h * jax.lax.rsqrt(var + eps) * weight.astype(jnp.float32)
    return y.astype(x.dtype), h.astype(x.dtype)


def _attend_single(q, K, V, head_dim, window: int = 0):
    """q: [heads, d]; K/V: [seq, heads, d] (fp32). Returns [heads, d].

    ``window`` > 0 = sliding-window attention (Mistral semantics): the query
    at position seq-1 attends only positions >= seq-window."""
    scores = jnp.einsum("hd,shd->hs", q, K) / math.sqrt(head_dim)
    if window:
        seq = K.shape[0]
        pos = jnp.arange(seq)
        scores = jnp.where(pos[None, :] >= seq - window, scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("hs,shd->hd", probs, V)


def llama_decoder_layer_sglang_ref(
    input: jnp.ndarray,       # [1, hidden]
    residual: jnp.ndarray,    # [1, hidden]
    weight_qkv: jnp.ndarray,  # [3*hidden, hidden]  (torch Linear [out, in])
    weight_o: jnp.ndarray,    # [hidden, hidden]    (torch Linear [out, in])
    k_cache: jnp.ndarray,     # [seq, hidden]
    v_cache: jnp.ndarray,     # [seq, hidden]
    rms_w: jnp.ndarray,       # [hidden]
    eps: float,
    cos: jnp.ndarray,         # [head_dim/2]
    sin: jnp.ndarray,         # [head_dim/2]
    *,
    n_heads: int,
    head_dim: int,
    window: int = 0,
):
    """Oracle for the sglang-variant fused layer: fused residual-add +
    RMSNorm + QKV + NEOX RoPE + decode attention + O-proj.

    Mirrors reference `tests/test_llama_tilelang.py:18-49` exactly.
    Returns (output [1,hidden], residual_out [1,hidden],
    k_new [1,hidden], v_new [1,hidden])."""
    hidden = input.shape[-1]
    h = input.astype(jnp.float32) + residual.astype(jnp.float32)
    residual_out = h
    var = jnp.mean(h * h, axis=-1, keepdims=True)
    x = h * jax.lax.rsqrt(var + eps) * rms_w.astype(jnp.float32)

    qkv = x @ weight_qkv.astype(jnp.float32).T            # [1, 3*hidden]
    q, k, v = jnp.split(qkv[0], 3)
    q = q.reshape(n_heads, head_dim)
    k = k.reshape(n_heads, head_dim)
    v = v.reshape(n_heads, head_dim)

    cos = cos.astype(jnp.float32)
    sin = sin.astype(jnp.float32)
    q = apply_rope_neox(q, cos, sin)
    k = apply_rope_neox(k, cos, sin)

    seq = k_cache.shape[0]
    K = jnp.concatenate(
        [k_cache.astype(jnp.float32).reshape(seq, n_heads, head_dim), k[None]], axis=0)
    V = jnp.concatenate(
        [v_cache.astype(jnp.float32).reshape(seq, n_heads, head_dim), v[None]], axis=0)
    o = _attend_single(q, K, V, head_dim, window=window)

    output = o.reshape(1, hidden) @ weight_o.astype(jnp.float32).T
    dt = input.dtype
    return (output.astype(dt), residual_out.astype(dt),
            k.reshape(1, hidden).astype(dt), v.reshape(1, hidden).astype(dt))


def llama_decoder_layer_ref(
    input: jnp.ndarray,       # [1, hidden]
    weight_qkv: jnp.ndarray,  # [3*hidden, hidden] of stacked W.T blocks ([in, out])
    weight_o: jnp.ndarray,    # [hidden, hidden] = wo.T  ([in, out])
    k_cache: jnp.ndarray,     # [seq, hidden]
    v_cache: jnp.ndarray,     # [seq, hidden]
    rms_w: jnp.ndarray,       # [hidden]
    cos: jnp.ndarray,         # [1, head_dim] (repeat_interleaved)
    sin: jnp.ndarray,         # [1, head_dim]
    *,
    n_heads: int,
    head_dim: int,
    eps: float = 1e-6,
):
    """Oracle for the GPT-J-RoPE fused layer (`kernel.cuh:20-619`).

    Differences from the sglang variant, per SURVEY §2.1: no residual-add
    (done by the caller, `model.py:492`), eps fixed at 1e-6
    (`kernel.cuh:58`), GPT-J interleaved RoPE with full-dim
    repeat_interleaved cos/sin (`model.py:276-282`), and weights in the
    *transposed* ([in, out]) layout produced by ``_build_cf_weights``
    (`model.py:316-322`).

    Returns (output [1,hidden], k_new [1,hidden], v_new [1,hidden])."""
    hidden = input.shape[-1]
    xf = input.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    x = xf * jax.lax.rsqrt(var + eps) * rms_w.astype(jnp.float32)

    w = weight_qkv.astype(jnp.float32).reshape(3, hidden, hidden)
    q = (x @ w[0])[0].reshape(n_heads, head_dim)
    k = (x @ w[1])[0].reshape(n_heads, head_dim)
    v = (x @ w[2])[0].reshape(n_heads, head_dim)

    cos = cos.reshape(1, head_dim).astype(jnp.float32)
    sin = sin.reshape(1, head_dim).astype(jnp.float32)
    q = apply_rope_gptj(q, cos, sin)
    k = apply_rope_gptj(k, cos, sin)

    seq = k_cache.shape[0]
    K = jnp.concatenate(
        [k_cache.astype(jnp.float32).reshape(seq, n_heads, head_dim), k[None]], axis=0)
    V = jnp.concatenate(
        [v_cache.astype(jnp.float32).reshape(seq, n_heads, head_dim), v[None]], axis=0)
    o = _attend_single(q, K, V, head_dim)

    output = o.reshape(1, hidden) @ weight_o.astype(jnp.float32)
    dt = input.dtype
    return (output.astype(dt),
            k.reshape(1, hidden).astype(dt), v.reshape(1, hidden).astype(dt))


def llama_decoder_layer_batch_paged_ref(
    input: jnp.ndarray,            # [batch, hidden]
    residual: jnp.ndarray,         # [batch, hidden]
    weight_qkv: jnp.ndarray,       # [3*hidden, hidden] ([out, in])
    weight_o: jnp.ndarray,         # [hidden, hidden]   ([out, in])
    paged_kv_indptr: jnp.ndarray,  # [batch+1] int32
    paged_kv_indices: jnp.ndarray, # [total_pages] int32 (page size = 1 token)
    k_cache: jnp.ndarray,          # [num_pages, hidden] token-row pool
    v_cache: jnp.ndarray,          # [num_pages, hidden]
    rms_w: jnp.ndarray,            # [hidden]
    eps: float,
    positions: jnp.ndarray,        # [batch] int32
    cos_sin: jnp.ndarray,          # [max_pos, head_dim]: cos half ‖ sin half
    *,
    n_heads: int,
    head_dim: int,
):
    """Oracle for the batched paged-KV decode layer
    (`kernel_batch_sglang.cuh:43-663`).

    Paged layout facts (verified against the CUDA kernel): page size is one
    token row (`k_cache[page * HIDDEN_DIM + ...]`, `:341`); for request b the
    existing tokens live at pool rows
    ``indices[indptr[b] : indptr[b+1]-1]`` and the new token's k/v are
    written to pool row ``indices[indptr[b+1]-1]`` (`:340-346`); RoPE is NEOX
    with a fused per-position cos‖sin table indexed by ``positions[b]``
    (`:320-336`).

    Returns (output [batch,hidden], residual_out [batch,hidden],
    k_cache', v_cache') — caches functionally updated (the CUDA kernel
    writes them in place)."""
    batch, hidden = input.shape
    h = input.astype(jnp.float32) + residual.astype(jnp.float32)
    residual_out = h
    var = jnp.mean(h * h, axis=-1, keepdims=True)
    x = h * jax.lax.rsqrt(var + eps) * rms_w.astype(jnp.float32)

    qkv = x @ weight_qkv.astype(jnp.float32).T            # [batch, 3*hidden]
    q, k, v = jnp.split(qkv, 3, axis=-1)
    q = q.reshape(batch, n_heads, head_dim)
    k = k.reshape(batch, n_heads, head_dim)
    v = v.reshape(batch, n_heads, head_dim)

    cs = cos_sin.astype(jnp.float32)[positions]           # [batch, head_dim]
    cos = cs[:, None, : head_dim // 2]
    sin = cs[:, None, head_dim // 2:]
    q = apply_rope_neox(q, cos, sin)
    k = apply_rope_neox(k, cos, sin)

    # Append new kv into the pool at each request's tail page.
    new_slots = paged_kv_indices[paged_kv_indptr[1:] - 1]  # [batch]
    kc = k_cache.astype(jnp.float32).at[new_slots].set(k.reshape(batch, hidden))
    vc = v_cache.astype(jnp.float32).at[new_slots].set(v.reshape(batch, hidden))

    # Masked per-request gather (jittable: padded to the total page count).
    max_pages = paged_kv_indices.shape[0]
    j = jnp.arange(max_pages)[None, :]                     # [1, max_pages]
    starts = paged_kv_indptr[:-1, None]                    # [batch, 1]
    lens = (paged_kv_indptr[1:] - paged_kv_indptr[:-1])[:, None]  # incl. new
    valid = j < lens                                       # [batch, max_pages]
    rows = paged_kv_indices[jnp.clip(starts + j, 0, max_pages - 1)]
    Kb = kc[rows].reshape(batch, max_pages, n_heads, head_dim)
    Vb = vc[rows].reshape(batch, max_pages, n_heads, head_dim)
    scores = jnp.einsum("bhd,bshd->bhs", q, Kb) / math.sqrt(head_dim)
    scores = jnp.where(valid[:, None, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    o = jnp.einsum("bhs,bshd->bhd", probs, Vb)             # [batch, heads, d]

    output = o.reshape(batch, hidden) @ weight_o.astype(jnp.float32).T
    dt = input.dtype
    return (output.astype(dt), residual_out.astype(dt),
            kc.astype(k_cache.dtype), vc.astype(v_cache.dtype))


def paged_attention_ref(q, k_pool, v_pool, block_table, lens, layer,
                        window: int = 0, softcap: float = 0.0):
    """Oracle for paged decode attention, one request at a time in fp32.

    q ``[B, kv, g, hd]``; pools ``[L, n_pages, kv, page, hd]`` (or an
    ``Int8KV`` pool with scales ``[L, n_pages, kv, page]``); request b
    attends its first ``lens[b]`` rows, ``block_table[b]`` naming its pages
    in order; ``window`` > 0 keeps positions ``>= lens[b] - window``.
    Returns fp32 ``[B, kv, g, hd]``."""
    def rows(pool, pages):
        if hasattr(pool, "s"):
            x = pool.q[layer, pages].astype(jnp.float32) \
                * pool.s[layer, pages][..., None]
        else:
            x = pool[layer, pages].astype(jnp.float32)   # [P, kv, page, hd]
        return x.transpose(1, 0, 2, 3).reshape(x.shape[1], -1, x.shape[3])

    outs = []
    hd = q.shape[-1]
    for b in range(q.shape[0]):
        n = int(lens[b])
        K = rows(k_pool, block_table[b])[:, :n]           # [kv, n, hd]
        V = rows(v_pool, block_table[b])[:, :n]
        s = jnp.einsum("kgd,knd->kgn", q[b].astype(jnp.float32), K,
                       precision="highest") / math.sqrt(hd)
        if softcap:
            s = softcap * jnp.tanh(s / softcap)
        if window:
            s = jnp.where(jnp.arange(n) >= n - window, s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        outs.append(jnp.einsum("kgn,knd->kgd", p, V, precision="highest"))
    return jnp.stack(outs)


def deepseek_decoder_layer_ref(
    input: jnp.ndarray,          # [1, hidden]
    weight_q_nope: jnp.ndarray,  # [heads*nope_dim, hidden]   ([out, in])
    weight_q_pe: jnp.ndarray,    # [heads*rope_dim, hidden]
    weight_uk: jnp.ndarray,      # [heads, nope_dim, lora_rank]  (absorbed W_UK)
    weight_kv_nope: jnp.ndarray, # [lora_rank, hidden]
    weight_k_pe: jnp.ndarray,    # [rope_dim, hidden]
    weight_uv: jnp.ndarray,      # [heads, lora_rank, nope_dim]  (absorbed W_UV)
    weight_o: jnp.ndarray,       # [hidden, heads*nope_dim]   ([out, in])
    ckv_cache: jnp.ndarray,      # [seq, lora_rank + rope_dim]
    rms_input_weight: jnp.ndarray,  # [hidden]
    rms_ckv_weight: jnp.ndarray,    # [lora_rank]
    cos: jnp.ndarray,            # [rope_dim/2]
    sin: jnp.ndarray,            # [rope_dim/2]
    *,
    n_heads: int,
    nope_dim: int,
    rope_dim: int,
    lora_rank: int,
    eps: float = 1e-6,
):
    """Oracle for the DeepSeek MLA fused layer (`deepseek/kernel.cuh:9-697`).

    MLA decode with the matrix-absorption trick: queries are projected to
    nope+rope parts, the nope part is absorbed through W_UK into the
    compressed-KV (lora_rank) space, attention runs against the compressed
    ckv cache (which serves as both K-nope and V), and the output is mapped
    back through W_UV then W_O.  The current token's compressed kv (ckv‖k_pe)
    is computed, RMSNorm'd (ckv part), RoPE'd (k_pe part) and attended to
    alongside the cache.  Unlike the reference prototype, seq len is dynamic
    and the new ckv row is returned for cache append (the reference never
    appends — `SURVEY.md` §2.1 "prototype status").

    Returns (output [1,hidden], ckv_new [1, lora_rank+rope_dim])."""
    xf = input.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    x = xf * jax.lax.rsqrt(var + eps) * rms_input_weight.astype(jnp.float32)

    f32 = jnp.float32
    q_nope = (x @ weight_q_nope.astype(f32).T).reshape(n_heads, nope_dim)
    q_pe = (x @ weight_q_pe.astype(f32).T).reshape(n_heads, rope_dim)
    ckv = (x @ weight_kv_nope.astype(f32).T)[0]           # [lora_rank]
    k_pe = (x @ weight_k_pe.astype(f32).T)[0]             # [rope_dim]

    cos = cos.astype(f32)
    sin = sin.astype(f32)
    q_pe = apply_rope_neox(q_pe, cos, sin)
    k_pe = apply_rope_neox(k_pe, cos, sin)

    # RMSNorm on the compressed kv (kv_a_layernorm in the HF impl).
    cvar = jnp.mean(ckv * ckv, keepdims=True)
    ckv = ckv * jax.lax.rsqrt(cvar + eps) * rms_ckv_weight.astype(f32)

    # Absorb q_nope through W_UK into lora_rank space.
    q_lora = jnp.einsum("hd,hdr->hr", q_nope, weight_uk.astype(f32))  # [h, r]

    cache = ckv_cache.astype(f32)
    ckv_new = jnp.concatenate([ckv, k_pe])                # [r + rope_dim]
    full = jnp.concatenate([cache, ckv_new[None]], axis=0)
    Kn = full[:, :lora_rank]                              # [S+1, r]
    Kp = full[:, lora_rank:]                              # [S+1, rope_dim]

    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    scores = (q_lora @ Kn.T + q_pe @ Kp.T) * scale        # [h, S+1]
    probs = jax.nn.softmax(scores, axis=-1)
    o_lora = probs @ Kn                                   # [h, r] (ckv is V)
    o = jnp.einsum("hr,hrd->hd", o_lora, weight_uv.astype(f32))  # [h, nope]

    output = o.reshape(1, n_heads * nope_dim) @ weight_o.astype(f32).T
    dt = input.dtype
    return output.astype(dt), ckv_new[None].astype(dt)
