"""Batched paged decode attention with in-place append.

The serving engine keeps K and V in page pools ``[L, n_pages, kv, page, hd]``
(``Int8KV`` pools pair an int8 payload with f32 scales ``[L, n_pages, kv,
page]``).  Each decode step appends the current token's K/V at
``block_table[b, seq_lens[b] // page]``, row ``seq_lens[b] % page``, then
attends every request's ``seq_lens[b] + 1`` rows.

Two implementations of the attention, chosen by platform:

- :func:`paged_attention_xla` — plain JAX: gather each request's pages into a
  contiguous ``[B, kv, W·page, hd]`` copy and run masked softmax attention.
  It runs everywhere and is the reference the kernel is checked against.
- :func:`paged_attention_kernel` — a Pallas kernel on the Triton route, the
  batched decode design of ClusterFusion (`kernel_batch_sglang.cuh`): one
  program per (request, kv head, KV split) with the GQA query group on the
  rows.  Each program loads its own block-table slice, gathers whole pages
  straight from the pool (no contiguous copy), skips pages below the sliding
  window, applies Int8KV scales and the fp8 convert at the load and runs an
  online softmax in the exp2 domain.  The KV splits take the place of the
  cluster's CTAs; their log-sum-exp merge, which the original did over
  distributed shared memory, is a second pass in XLA.

The append is an XLA scatter placed before the attention, so the current
token is read back from the pool like every other row.  Under a jit that
donates the pools the scatter is in place.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from clusterfusion.ops.quant import Int8KV, quantize_kv_rows

_LOG2E = 1.4426950408889634
_NEG = -1e30
# Triton's tensor-core dot needs at least 16 rows: the query group is padded.
_MIN_ROWS = 16
# KV splits are sized so that the grid holds about this many programs
# (a few waves over the H100's 132 SMs).
_TARGET_PROGRAMS = 528


def init_paged_pool(shape, kv_dtype=jnp.bfloat16):
    """Zeroed pool of ``shape = (L, n_pages, kv, page, hd)``.  ``kv_dtype``
    "int8" gives an :class:`Int8KV` pool with per-row scales."""
    if kv_dtype == "int8" or kv_dtype == jnp.int8:
        return Int8KV(jnp.zeros(shape, jnp.int8),
                      jnp.ones(shape[:-1], jnp.float32))
    return jnp.zeros(shape, kv_dtype)


def pool_shape(pool):
    return pool.q.shape if isinstance(pool, Int8KV) else pool.shape


def _scatter_leading(x, idx, upd):
    """``x[idx[i, 0], .., idx[i, k-1]] = upd[i]`` for every row of ``idx
    [n, k]``.  The indexed dims lead ``x``'s, the form XLA scatters in
    place.  Indexing as ``pool.at[layer, pg, :, off]`` instead leaves an
    axis between indexed dims, and XLA then keeps the whole pool
    transposed, with a pool-sized copy at each end of the step."""
    k = idx.shape[1]
    dn = jax.lax.ScatterDimensionNumbers(
        update_window_dims=tuple(range(1, upd.ndim)),
        inserted_window_dims=tuple(range(k)),
        scatter_dims_to_operand_dims=tuple(range(k)))
    return jax.lax.scatter(x, idx, upd.astype(x.dtype), dn)


@functools.partial(jax.jit, donate_argnums=0)
def pool_set_pages(pool, pages, blocks):
    """Write page blocks ``[L, n, kv, page, hd]`` at pool pages ``pages``
    (all layers), quantizing per row for an :class:`Int8KV` pool.  The pool
    is donated: the write is in place."""
    L, n = blocks.shape[:2]
    idx = jnp.stack([jnp.repeat(jnp.arange(L, dtype=jnp.int32), n),
                     jnp.tile(jnp.asarray(pages, jnp.int32), L)], axis=1)
    flat = lambda x: x.reshape(L * n, *x.shape[2:])
    if isinstance(pool, Int8KV):
        q8, s = quantize_kv_rows(blocks)
        return Int8KV(_scatter_leading(pool.q, idx, flat(q8)),
                      _scatter_leading(pool.s, idx, flat(s)))
    return _scatter_leading(pool, idx, flat(blocks))


def paged_append(pool, rows, block_table, seq_lens, layer):
    """Write ``rows [B, kv, hd]`` at each request's next slot of layer
    ``layer``: page ``block_table[b, seq_lens[b] // page]``, row
    ``seq_lens[b] % page``."""
    page = pool_shape(pool)[3]
    B, kv = rows.shape[:2]
    pg = block_table[jnp.arange(B), seq_lens // page]
    # one index row (layer, page id, kv head, row) per (request, kv head)
    col = lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.int32).reshape(-1, 1),
                                     (B, kv)).reshape(-1)
    idx = jnp.stack([col(layer), col(pg),
                     jnp.tile(jnp.arange(kv, dtype=jnp.int32), B),
                     col(seq_lens % page)], axis=1)
    flat = lambda x: x.reshape(B * kv, *x.shape[2:])
    if isinstance(pool, Int8KV):
        q8, s = quantize_kv_rows(rows)
        return Int8KV(_scatter_leading(pool.q, idx, flat(q8)),
                      _scatter_leading(pool.s, idx, flat(s)))
    return _scatter_leading(pool, idx, flat(rows))


def paged_attention_xla(q, k_pool, v_pool, block_table, lens, layer,
                        window=0, softcap: float = 0.0):
    """Plain-JAX paged attention.  q ``[B, kv, g, hd]`` (rope'd, unscaled);
    ``lens [B]`` rows to attend per request (current token included);
    ``window`` (int or traced scalar, 0 = full context): attend positions
    ``>= lens - window`` only.  Returns f32 ``[B, kv, g, hd]``."""
    B, kv, g, hd = q.shape

    def gather(pool):
        if isinstance(pool, Int8KV):
            x = (pool.q[layer][block_table].astype(jnp.float32)
                 * pool.s[layer][block_table][..., None])
        else:
            x = pool[layer][block_table]
        W, page = x.shape[1], x.shape[3]
        return x.transpose(0, 2, 1, 3, 4).reshape(B, kv, W * page, hd)

    kb, vb = gather(k_pool), gather(v_pool)
    dt = jnp.float32 if kb.dtype == jnp.float32 else jnp.bfloat16
    s = jnp.einsum("bkgd,bksd->bkgs", q.astype(dt), kb.astype(dt),
                   preferred_element_type=jnp.float32) / math.sqrt(hd)
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    pos = jnp.arange(kb.shape[2])[None, :]
    valid = pos < lens[:, None]
    valid &= pos >= lens[:, None] - jnp.where(window > 0, window, lens[:, None])
    s = jnp.where(valid[:, None, None, :], s, _NEG)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bkgs,bksd->bkgd", p.astype(dt), vb.astype(dt),
                      preferred_element_type=jnp.float32)


def _kernel_blocks(head_dim: int, page: int):
    """(pages per loop step, rows per loop step): about 16 KB of bf16 K
    per step (64 rows at head_dim 128), never less than one page."""
    rows = max(page, 8192 // head_dim)
    return rows // page, rows


def _splits(B: int, kv: int, width: int, ppb: int):
    """(pages per split, number of splits) for a table of ``width`` pages."""
    n_blocks = -(-width // ppb)
    want = max(1, min(n_blocks, -(-_TARGET_PROGRAMS // (B * kv))))
    pps = -(-n_blocks // want) * ppb
    return pps, -(-width // pps)


def _paged_kernel(layer_ref, lens_ref, win_ref, table_ref, q_ref, k_ref,
                  v_ref, *refs, kv_heads, n_pages, page, ppb, pps, scale,
                  softcap, quant):
    if quant:
        ks_ref, vs_ref, o_ref, m_ref, l_ref = refs
    else:
        o_ref, m_ref, l_ref = refs
    b, h, split = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    rows_q, hd = q_ref.shape
    bk = ppb * page
    n = lens_ref[b]
    win = win_ref[0]
    lo = jnp.where(win > 0, jnp.maximum(n - win, 0), 0)
    p_begin = jnp.maximum(split * pps, lo // page)
    p_end = jnp.minimum((split + 1) * pps, (n + page - 1) // page)
    # a split's last loop step may run past its own pages: mask them
    hi = jnp.minimum(n, p_end * page)
    base = layer_ref[0] * n_pages
    q = q_ref[...]

    def body(i, carry):
        acc, m, l = carry
        p0 = p_begin + i * ppb
        pages = table_ref[b, pl.ds(p0, ppb)]
        rows = (base + pages) * kv_heads + h
        k = k_ref[rows].reshape(bk, hd).astype(jnp.bfloat16)
        v = v_ref[rows].reshape(bk, hd).astype(jnp.bfloat16)
        pos = p0 * page + jax.lax.broadcasted_iota(jnp.int32, (bk,), 0)
        valid = (pos < hi) & (pos >= lo)
        s = pl.dot(q, k, trans_b=True)                    # [rows_q, bk] f32
        if quant:
            s = s * (ks_ref[rows].reshape(1, bk) * scale)
        else:
            s = s * scale
        if softcap:
            s = softcap * jnp.tanh(s * (1.0 / softcap))
        s = jnp.where(valid[None, :], s, _NEG)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.where(valid[None, :], jnp.exp2(s - m_new[:, None]), 0.0)
        l = l * alpha + jnp.sum(p, axis=1)
        if quant:
            p = p * vs_ref[rows].reshape(1, bk)
        v = jnp.where(valid[:, None], v, jnp.zeros_like(v))
        acc = acc * alpha[:, None] + pl.dot(p.astype(jnp.bfloat16), v)
        return acc, m_new, l

    n_it = jnp.maximum(p_end - p_begin + ppb - 1, 0) // ppb
    acc, m, l = jax.lax.fori_loop(
        0, n_it, body,
        (jnp.zeros((rows_q, hd), jnp.float32),
         jnp.full((rows_q,), _NEG, jnp.float32),
         jnp.zeros((rows_q,), jnp.float32)))
    o_ref[...] = acc
    m_ref[...] = m
    l_ref[...] = l


def paged_attention_kernel(q, k_pool, v_pool, block_table, lens, layer,
                           window=0, softcap: float = 0.0, *,
                           interpret: bool = False):
    """Triton-route Pallas paged attention; same contract as
    :func:`paged_attention_xla`."""
    B, kv, g, hd = q.shape
    quant = isinstance(k_pool, Int8KV)
    kq, vq = (k_pool.q, v_pool.q) if quant else (k_pool, v_pool)
    L, n_pages, _, page, _ = kq.shape
    ppb, _ = _kernel_blocks(hd, page)
    width = block_table.shape[1]
    pps, n_splits = _splits(B, kv, width, ppb)
    # every loop step reads ppb table entries: pad so none runs off the end
    table = jnp.pad(block_table.astype(jnp.int32), ((0, 0), (0, ppb)))
    rows_q = max(_MIN_ROWS, pl.next_power_of_2(g))
    # q is rounded to bf16 as it is, the same operand the XLA path and the
    # bs=1 decode step take; the softmax scale is applied to the f32 scores
    qs = jnp.pad(q.astype(jnp.bfloat16),
                 ((0, 0), (0, 0), (0, rows_q - g), (0, 0)))
    flat = lambda x: x.reshape(L * n_pages * kv, *x.shape[3:])
    operands = [jnp.asarray(layer, jnp.int32).reshape(1),
                lens.astype(jnp.int32),
                jnp.asarray(window, jnp.int32).reshape(1), table, qs,
                flat(kq), flat(vq)]
    if quant:
        operands += [flat(k_pool.s), flat(v_pool.s)]
    whole = lambda x: pl.BlockSpec(x.shape, lambda *_: (0,) * x.ndim)
    in_specs = [whole(x) for x in operands]
    in_specs[4] = pl.BlockSpec((None, None, rows_q, hd),
                               lambda b, h, s: (b, h, 0, 0))
    o, m, l = pl.pallas_call(
        functools.partial(_paged_kernel, kv_heads=kv, n_pages=n_pages,
                          page=page, ppb=ppb, pps=pps,
                          scale=_LOG2E / math.sqrt(hd),
                          softcap=softcap * _LOG2E, quant=quant),
        grid=(B, kv, n_splits),
        in_specs=in_specs,
        out_specs=[
            pl.BlockSpec((None, None, None, rows_q, hd),
                         lambda b, h, s: (s, b, h, 0, 0)),
            pl.BlockSpec((None, None, None, rows_q),
                         lambda b, h, s: (s, b, h, 0)),
            pl.BlockSpec((None, None, None, rows_q),
                         lambda b, h, s: (s, b, h, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_splits, B, kv, rows_q, hd), jnp.float32),
            jax.ShapeDtypeStruct((n_splits, B, kv, rows_q), jnp.float32),
            jax.ShapeDtypeStruct((n_splits, B, kv, rows_q), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="paged_attention",
    )(*operands)
    # second pass: log-sum-exp merge of the KV splits (exp2 domain)
    m_all = jnp.max(m, axis=0)
    w = jnp.exp2(m - m_all[None])
    o = jnp.sum(o * w[..., None], axis=0) / jnp.sum(l * w, axis=0)[..., None]
    return o[:, :, :g]


def _attend(q, k_pool, v_pool, block_table, lens, layer, window, softcap):
    return jax.lax.platform_dependent(
        q, k_pool, v_pool, block_table, lens, layer, window,
        cuda=functools.partial(paged_attention_kernel, softcap=softcap),
        default=functools.partial(paged_attention_xla, softcap=softcap))


def paged_attention(q, k_new, v_new, k_pool, v_pool, block_table, seq_lens,
                    layer, *, window=0, softcap: float = 0.0):
    """Append the current token's K/V, then attend.

    q ``[B, kv, g, hd]`` (rope'd, unscaled); k_new/v_new ``[B, kv, hd]``;
    ``seq_lens [B]`` cached rows before this token.  On a CUDA device the
    attention is :func:`paged_attention_kernel`, elsewhere
    :func:`paged_attention_xla`.  Returns (o ``[B, kv·g·hd]`` in q's dtype,
    k_pool', v_pool')."""
    B, kv, g, hd = q.shape
    k_pool = paged_append(k_pool, k_new, block_table, seq_lens, layer)
    v_pool = paged_append(v_pool, v_new, block_table, seq_lens, layer)
    o = _attend(q, k_pool, v_pool, block_table, seq_lens + 1, layer,
                jnp.asarray(window, jnp.int32), softcap)
    return o.reshape(B, kv * g * hd).astype(q.dtype), k_pool, v_pool
