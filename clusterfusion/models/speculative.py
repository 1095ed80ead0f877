"""Greedy speculative decoding: draft model + multi-token verify step.

Beyond the reference (which decodes strictly one token per step,
`chat/llama/generation.py:129-231`): a small draft model proposes
``n_draft`` tokens, the target model scores them all in ONE forward
(``verify_step`` — an n-row decode at a dynamic position), and the longest
agreeing prefix plus one bonus token is emitted.  Per round the target
runs once instead of up to ``n_draft + 1`` times; decode at bs=1 is
HBM-bound on weight streaming, and an n-row verify streams the same bytes
as a 1-row decode, so accepted drafts are nearly free target tokens.

Cache discipline (why there is NO rollback code): both caches are
append-by-position with attention masked to ``kpos <= query position``.
After accepting ``m`` of ``n`` drafts at base position ``pos``:

- rows ``pos .. pos+m`` hold KV of the emitted tokens — valid;
- stale rows (rejected drafts) sit strictly above ``pos+m`` and strictly
  below the next round's write span start + span length, so every stale
  row is overwritten before any query position ever reaches it.

Greedy acceptance means the emitted stream equals the target model's own
greedy decode (under the verify step's numerics): token i is emitted only
as the argmax of target logits given the true emitted prefix.

Memory note: when ``spec_decode_loop`` runs MULTIPLE rounds inside one
dispatch at large bf16 scales, XLA hoists a layout-transposed copy of the
whole stacked wqkv out of the rounds scan (+3 GB HBM at 7B — enough to
OOM next to 13.4 GB of params).  A single-round dispatch compiles with
0.09 GB temp.  ``Llama.spec_generate`` therefore defaults to
``rounds_per_dispatch=1``; raise it to amortize dispatch overhead when
the target is quantized or small enough to leave headroom.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from clusterfusion.config import LlamaConfig
from clusterfusion.models.llama import (
    LlamaParams, _apply_rope, _cache_layer, _decode_step_impl, _lm_logits,
    _qkv_eager, attend, ffn_block, layer_window, maybe_dequantize,
    rope_table, round_q)
from clusterfusion.ops.quant import Int8KV, cache_fill_rows
from clusterfusion.ops.reference import fused_add_rmsnorm_ref


def _cache_fill_layer(cache, rows, l, pos):
    """Write [kv, n, hd] rows of layer ``l`` at positions pos..pos+n-1."""
    if isinstance(cache, Int8KV):
        one = jax.tree.map(
            lambda a: jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=True),
            cache)
        one = cache_fill_rows(one, rows[None], pos)
        return jax.tree.map(
            lambda a, u: jax.lax.dynamic_update_index_in_dim(a, u, l, 0),
            cache, one)
    return jax.lax.dynamic_update_slice(
        cache, rows[None].astype(cache.dtype), (l, 0, pos, 0))


@functools.partial(jax.jit, static_argnames=("cfg",))
def verify_step(params: LlamaParams, k_cache, v_cache, tokens: jnp.ndarray,
                pos: jnp.ndarray, cfg: LlamaConfig):
    """Score ``n`` tokens at dynamic positions ``pos .. pos+n-1`` in one
    forward, appending their K/V.  tokens: [n] int32 (the last emitted
    token followed by the draft proposals).  Returns (logits [n, vocab],
    k_cache', v_cache').

    The multi-token sibling of ``models.llama._decode_step_impl`` — same
    math per row, n rows wide.  The n·cap attention masks by position, so
    ``pos`` stays dynamic — no per-position recompiles."""
    n = tokens.shape[0]
    hd = cfg.head_dim_
    cos_t, sin_t = rope_table(cfg)
    cos = jax.lax.dynamic_slice(cos_t, (pos, 0), (n, hd))[None]   # [1,n,hd]
    sin = jax.lax.dynamic_slice(sin_t, (pos, 0), (n, hd))[None]

    x = params["embed"][tokens]                                   # [n, hidden]
    residual = jnp.zeros_like(x)

    def layer(carry, l):
        x, residual, kc, vc = carry
        # slice the layer INSIDE the body (scanning weight stacks as xs lets
        # XLA hoist a layout-changing copy of the WHOLE stack out of the
        # loop — observed: a 3 GB transposed wqkv copy → OOM at 7B; a
        # per-layer slice bounds any such copy to one layer)
        p = jax.tree.map(
            lambda a: jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False),
            params["layers"])
        xn, residual = fused_add_rmsnorm_ref(x, residual, p["attn_norm"],
                                             cfg.norm_eps)
        q, k, v = _qkv_eager(xn[None], p["wqkv_f"], cfg, p.get("bqkv_f"))   # q [1,n,kv,g,hd]
        q = round_q(_apply_rope(q, cos[..., None, None, :],
                                sin[..., None, None, :], cfg.rope_style),
                    x.dtype)
        k = _apply_rope(k, cos[..., None, :], sin[..., None, :],
                        cfg.rope_style)
        kc = _cache_fill_layer(kc, k[0].transpose(1, 0, 2), l, pos)
        vc = _cache_fill_layer(vc, v[0].transpose(1, 0, 2), l, pos)
        o = attend(q[0], _cache_layer(kc, l), _cache_layer(vc, l),
                   pos + jnp.arange(n), jnp.arange(kc.shape[2]),
                   layer_window(cfg, l), cfg.attn_logit_softcap)
        G = p["wo_f"].shape[0]
        attn = jnp.einsum("tGc,Gco->to", o.reshape(n, G, -1),
                          maybe_dequantize(p["wo_f"], x.dtype),
                          preferred_element_type=jnp.float32).astype(x.dtype)
        x, residual = ffn_block(attn, residual, p, cfg)
        return (x, residual, kc, vc), None

    layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
    (x, residual, k_cache, v_cache), _ = jax.lax.scan(
        layer, (x, residual, k_cache, v_cache), layer_idx)
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    logits = _lm_logits(xn, params["lm_head"])
    if cfg.final_logit_softcap:
        cc = cfg.final_logit_softcap
        logits = cc * jnp.tanh(logits / cc)
    return logits, k_cache, v_cache


def _spec_round(params, draft_params, carry, cfg: LlamaConfig,
                draft_cfg: LlamaConfig, n_draft: int):
    """One speculative round.  carry = (tok, pos, kc_t, vc_t, kc_d, vc_d).
    Returns (carry', (targets [n_draft+1], n_emitted))."""
    tok, pos, kc_t, vc_t, kc_d, vc_d = carry

    # -- draft n_draft tokens with its own cache.  One EXTRA step feeds the
    # last proposal too: on full acceptance the emitted history includes
    # d_n at position pos+n, and without this step the draft cache would
    # have a zero row there — a gap that silently poisons every subsequent
    # round's drafts (observed: acceptance collapses to 1/round).
    def draft_body(c, i):
        t, kc, vc = c
        lg, kc, vc = _decode_step_impl(draft_params, kc, vc, t, pos + i,
                                       draft_cfg)
        nxt = jnp.argmax(lg).astype(jnp.int32)
        return (nxt, kc, vc), nxt

    (_, kc_d, vc_d), drafts = jax.lax.scan(
        draft_body, (tok, kc_d, vc_d),
        jnp.arange(n_draft + 1, dtype=jnp.int32))
    drafts = drafts[:n_draft]

    # -- target scores [tok, d1..dn] in one forward -> t1..t_{n+1}
    vtoks = jnp.concatenate([tok[None], drafts])
    logits, kc_t, vc_t = verify_step(params, kc_t, vc_t, vtoks, pos, cfg)
    targets = jnp.argmax(logits, axis=-1).astype(jnp.int32)  # [n_draft+1]

    # longest agreeing prefix: drafts[:m] == targets[:m]; emit targets[:m+1]
    eq = (drafts == targets[:-1]).astype(jnp.int32)
    m = jnp.sum(jnp.cumprod(eq))
    n_emit = m + 1
    tok_next = targets[m]
    return (tok_next, pos + n_emit, kc_t, vc_t, kc_d, vc_d), \
        (targets, n_emit)


def _spec_decode_impl(params, k_cache, v_cache, draft_params, kd_cache,
                      vd_cache, first_token, start_pos,
                      cfg: LlamaConfig, draft_cfg: LlamaConfig,
                      n_draft: int = 4, n_rounds: int = 16):
    """On-device speculative decode: ``n_rounds`` rounds of draft+verify in
    one dispatch.  The draft's cache must be prefilled with the same
    prompt.  Returns (targets [n_rounds, n_draft+1], counts [n_rounds],
    target caches, draft caches); round r emits ``targets[r, :counts[r]]``.
    Total emitted tokens vary per round (1..n_draft+1); callers flatten
    with the counts and stop at their length budget."""
    def body(carry, _):
        carry, out = _spec_round(params, draft_params, carry, cfg, draft_cfg,
                                 n_draft)
        return carry, out

    carry = (first_token, start_pos, k_cache, v_cache, kd_cache, vd_cache)
    (tok, pos, kc_t, vc_t, kc_d, vc_d), (targets, counts) = jax.lax.scan(
        body, carry, None, length=n_rounds)
    return targets, counts, kc_t, vc_t, kc_d, vc_d


spec_decode_loop = jax.jit(
    _spec_decode_impl,
    static_argnames=("cfg", "draft_cfg", "n_draft", "n_rounds"),
    donate_argnums=(1, 2, 4, 5))


def flatten_rounds(targets, counts, max_tokens=None):
    """Host helper: [rounds, n+1] targets + per-round counts -> emitted
    token list (optionally truncated to ``max_tokens``)."""
    out = []
    for r in range(targets.shape[0]):
        out.extend(int(t) for t in targets[r, : int(counts[r])])
    return out[:max_tokens] if max_tokens is not None else out
