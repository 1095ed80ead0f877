"""Functional DeepSeek-V2 MLA model.

The reference ships DeepSeek support as a single-layer kernel prototype
with no model, no cache append, and a compile-time SEQ_LEN
(`include/H100/deepseek/kernel.cuh`, `deepseek/config.h:9`; SURVEY.md §2.1
"prototype status").  This module is the full model around that layer's
math (matrix-absorbed MLA decode): embeddings, stacked MLA decoder layers
with a compressed-KV cache of *capacity* (dynamic position), SwiGLU FFN,
final norm + LM head, prefill, and greedy decode — structured like
``models.llama`` (functional params/caches, ``lax.scan`` over layers).

The FFN is dense SwiGLU by default, with optional DeepSeek-V2-style MoE
(``cfg.n_experts > 0``): a dense shared expert plus ``moe_top_k`` routed
experts (``ops.moe``) — gathered-expert weights at decode (minimum HBM
traffic), masked-dense at prefill (expert-axis shardable).  The reference
kernel library has no FFN/MoE path at all.

Weights live in a pre-fused layout from init
(``wproj [hidden, n_proj]`` = q_nope|q_pe|ckv|k_pe columns,
``wo_t [h·nope, hidden]``), mirroring the llama model's
fused-layout-from-load-time design.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp

from clusterfusion.config import DeepSeekConfig
from clusterfusion.models.llama import _ffn
from clusterfusion.ops.moe import moe_ffn_decode, moe_ffn_dense
from clusterfusion.ops.quant import maybe_dequantize
from clusterfusion.ops.reference import rmsnorm_ref
from clusterfusion.ops.rope import apply_rope_neox, rope_tables_neox

DeepSeekParams = Dict[str, Any]


def rope_table(cfg: DeepSeekConfig, max_pos: int | None = None):
    """Half-dim NEOX (cos, sin) tables [max_pos, rope_head_dim/2]
    (YaRN-scaled when cfg.yarn_factor > 1 — V2/V2-Lite checkpoints)."""
    mp = max_pos or cfg.max_seq_len
    if cfg.yarn_factor > 1.0:
        from clusterfusion.ops.rope import rope_tables_yarn
        return rope_tables_yarn(
            cfg.rope_head_dim, mp, cfg.rope_theta, factor=cfg.yarn_factor,
            orig_max=cfg.yarn_orig_max, beta_fast=cfg.yarn_beta_fast,
            beta_slow=cfg.yarn_beta_slow, mscale=cfg.yarn_mscale,
            mscale_all_dim=cfg.yarn_mscale_all_dim)
    return rope_tables_neox(cfg.rope_head_dim, mp, cfg.rope_theta)


def init_params(cfg: DeepSeekConfig, key, dtype=jnp.bfloat16) -> DeepSeekParams:
    h, nope, rope = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    lora, hid, L, V = cfg.kv_lora_rank, cfg.hidden_dim, cfg.n_layers, \
        cfg.vocab_size
    f = cfg.ffn_dim
    ks = jax.random.split(key, 10)

    def norm(k, shape, fan_in):
        return jax.random.normal(k, shape, dtype) / jnp.sqrt(fan_in).astype(dtype)

    layers = {
        "wproj": norm(ks[1], (L, hid, cfg.n_proj), hid),
        "wuk": norm(ks[2], (L, h, nope, lora), nope),
        "wuv": norm(ks[3], (L, h, lora, nope), lora),
        "wo_t": norm(ks[4], (L, h * nope, hid), h * nope),
        "attn_norm": jnp.ones((L, hid), dtype),
        "ckv_norm": jnp.ones((L, lora), dtype),
        "w13": norm(ks[5], (L, 2, hid, f), hid),
        "w2": norm(ks[6], (L, f, hid), f),
        "ffn_norm": jnp.ones((L, hid), dtype),
    }
    if cfg.n_experts:
        E, fe = cfg.n_experts, cfg.moe_ffn_dim
        layers["router"] = norm(ks[8], (L, hid, E), hid)
        layers["w13_e"] = norm(ks[9], (L, E, 2, hid, fe), hid)
        layers["w2_e"] = norm(jax.random.fold_in(ks[9], 1),
                              (L, E, fe, hid), fe)
    return {
        "embed": norm(ks[0], (V, hid), hid),
        "layers": layers,
        "final_norm": jnp.ones((hid,), dtype),
        "lm_head": norm(ks[7], (hid, V), hid),
    }


def init_cache(cfg: DeepSeekConfig, max_seq: int | None = None,
               dtype=jnp.bfloat16):
    """Compressed-KV cache [L, capacity, lora + rope] — ~9x smaller than a
    materialized K/V cache at V2-lite geometry (the whole point of MLA)."""
    cap = max_seq or cfg.max_seq_len
    return jnp.zeros((cfg.n_layers, cap, cfg.mla_head_dim), dtype)


def _eager_mla(x, p, cache_l, pos, cos, sin, cfg: DeepSeekConfig):
    """Single-token MLA decode (fp32 math, capacity cache + position mask).
    x: [1, hidden]; cache_l: [cap, mla]; cos/sin: [rope/2].  Returns
    (attn_out [1, hidden], ckv_new [1, mla])."""
    h, nope, rope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    f32 = jnp.float32
    xn = rmsnorm_ref(x, p["attn_norm"], cfg.norm_eps).astype(f32)
    proj = xn @ maybe_dequantize(p["wproj"], f32)          # [1, n_proj]
    qn_off, qp_off = 0, h * nope
    ckv_off = qp_off + h * rope
    kpe_off = ckv_off + lora
    q_nope = proj[0, :qp_off].reshape(h, nope)
    q_pe = apply_rope_neox(proj[0, qp_off:ckv_off].reshape(h, rope), cos, sin)
    ckv = proj[0, ckv_off:kpe_off]
    cvar = jnp.mean(ckv * ckv, keepdims=True)
    ckv = ckv * jax.lax.rsqrt(cvar + cfg.norm_eps) * p["ckv_norm"].astype(f32)
    k_pe = apply_rope_neox(proj[0, kpe_off:], cos, sin)
    ckv_new = jnp.concatenate([ckv, k_pe])[None]           # [1, mla]

    q_lora = jnp.einsum("hd,hdr->hr", q_nope,
                        maybe_dequantize(p["wuk"], f32))
    q = jnp.concatenate([q_lora, q_pe], axis=-1)           # [h, mla]
    scale = jnp.float32(cfg.softmax_scale)
    cache_f = cache_l.astype(f32)
    scores = q @ cache_f.T * scale                         # [h, cap]
    valid = jnp.arange(cache_l.shape[0])[None, :] < pos
    scores = jnp.where(valid, scores, -1e30)
    s_cur = jnp.sum(q * ckv_new[0] * scale, axis=-1, keepdims=True)
    full = jnp.concatenate([scores, s_cur], axis=-1)       # [h, cap+1]
    probs = jax.nn.softmax(full, axis=-1)
    o_lora = (probs[:, :-1] @ cache_f[:, :lora]
              + probs[:, -1:] * ckv_new[0, :lora])         # [h, lora]
    o = jnp.einsum("hr,hrd->hd", o_lora, maybe_dequantize(p["wuv"], f32))
    out = o.reshape(1, h * nope) @ maybe_dequantize(p["wo_t"], f32)
    return out.astype(x.dtype), ckv_new.astype(x.dtype)


def _decode_step_impl(params: DeepSeekParams, cache, token, pos,
                      cfg: DeepSeekConfig):
    """One decode step at dynamic ``pos``.  Returns (logits [vocab],
    cache')."""
    cos_t, sin_t = rope_table(cfg)
    half = cfg.rope_head_dim // 2
    cos = jax.lax.dynamic_slice(cos_t, (pos, 0), (1, half))[0]
    sin = jax.lax.dynamic_slice(sin_t, (pos, 0), (1, half))[0]
    x = params["embed"][token][None]                       # [1, hidden]

    lw = params["layers"]

    def layer(carry, l):
        x, cache = carry
        p = jax.tree.map(
            lambda a: jax.lax.dynamic_index_in_dim(a, l, 0,
                                                   keepdims=False), lw)
        cache_l = jax.lax.dynamic_index_in_dim(cache, l, 0, keepdims=False)
        attn, ckv_new = _eager_mla(x, p, cache_l, pos, cos, sin, cfg)
        cache = jax.lax.dynamic_update_slice(
            cache, ckv_new[None].astype(cache.dtype), (l, pos, 0))
        x = x + attn.astype(x.dtype)
        xn2 = rmsnorm_ref(x, p["ffn_norm"], cfg.norm_eps)
        y = _ffn(xn2, p["w13"], p["w2"])         # shared expert (dense)
        if cfg.n_experts:
            y = y + moe_ffn_decode(xn2, p["router"], p["w13_e"], p["w2_e"],
                                   cfg.moe_top_k,
                                   norm_topk_prob=cfg.moe_norm_topk_prob,
                                   routed_scaling_factor=cfg.moe_routed_scaling)
        x = x + y
        return (x, cache), None

    layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
    (x, cache), _ = jax.lax.scan(layer, (x, cache), layer_idx)
    xn = rmsnorm_ref(x, params["final_norm"], cfg.norm_eps)
    logits = jnp.dot(xn[0], params["lm_head"],
                     preferred_element_type=jnp.float32)
    return logits, cache


decode_step = jax.jit(_decode_step_impl, static_argnames=("cfg",))


@functools.partial(jax.jit, static_argnames=("cfg",))
def prefill(params: DeepSeekParams, cache, tokens, cfg: DeepSeekConfig):
    """Eager batched-T prefill: fills the compressed cache, returns
    (logits [T, vocab], cache')."""
    T = tokens.shape[0]
    h, nope, rope, lora = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    f32 = jnp.float32
    cos_t, sin_t = rope_table(cfg)
    cos, sin = cos_t[:T], sin_t[:T]                        # [T, rope/2]
    x = params["embed"][tokens]                            # [T, hidden]
    mask = jnp.tril(jnp.ones((T, T), jnp.bool_))

    def layer(carry, p):
        x = carry
        xn = rmsnorm_ref(x, p["attn_norm"], cfg.norm_eps).astype(f32)
        proj = xn @ maybe_dequantize(p["wproj"], f32)      # [T, n_proj]
        qp_off = h * nope
        ckv_off = qp_off + h * rope
        kpe_off = ckv_off + lora
        q_nope = proj[:, :qp_off].reshape(T, h, nope)
        q_pe = apply_rope_neox(proj[:, qp_off:ckv_off].reshape(T, h, rope),
                               cos[:, None], sin[:, None])
        ckv = proj[:, ckv_off:kpe_off]
        cvar = jnp.mean(ckv * ckv, axis=-1, keepdims=True)
        ckv = ckv * jax.lax.rsqrt(cvar + cfg.norm_eps) \
            * p["ckv_norm"].astype(f32)
        k_pe = apply_rope_neox(proj[:, kpe_off:], cos, sin)
        rows = jnp.concatenate([ckv, k_pe], axis=-1)       # [T, mla]

        q_lora = jnp.einsum("thd,hdr->thr", q_nope,
                            maybe_dequantize(p["wuk"], f32))
        q = jnp.concatenate([q_lora, q_pe], axis=-1)       # [T, h, mla]
        scale = jnp.float32(cfg.softmax_scale)
        scores = jnp.einsum("thm,sm->hts", q, rows) * scale
        scores = jnp.where(mask[None], scores, -1e30)
        probs = jax.nn.softmax(scores, axis=-1)
        o_lora = jnp.einsum("hts,sr->thr", probs, ckv)
        o = jnp.einsum("thr,hrd->thd", o_lora,
                       maybe_dequantize(p["wuv"], f32))
        out = (o.reshape(T, h * nope)
               @ maybe_dequantize(p["wo_t"], f32)).astype(x.dtype)
        x = x + out
        xn2 = rmsnorm_ref(x, p["ffn_norm"], cfg.norm_eps)
        y = _ffn(xn2, p["w13"], p["w2"])         # shared expert (dense)
        if cfg.n_experts:
            y = y + moe_ffn_dense(xn2, p["router"], p["w13_e"], p["w2_e"],
                                  cfg.moe_top_k,
                                  norm_topk_prob=cfg.moe_norm_topk_prob,
                                  routed_scaling_factor=cfg.moe_routed_scaling)
        x = x + y
        return x, rows.astype(cache.dtype)

    x, rows = jax.lax.scan(layer, x, params["layers"])     # rows [L, T, mla]
    cache = jax.lax.dynamic_update_slice(cache, rows, (0, 0, 0))
    xn = rmsnorm_ref(x, params["final_norm"], cfg.norm_eps)
    logits = jnp.dot(xn, params["lm_head"], preferred_element_type=jnp.float32)
    return logits, cache


def _decode_loop_impl(params, cache, first_token, start_pos,
                      cfg: DeepSeekConfig, n_steps: int):
    def body(carry, _):
        tok, pos, cache = carry
        logits, cache = _decode_step_impl(params, cache, tok, pos, cfg)
        nxt = jnp.argmax(logits).astype(jnp.int32)
        return (nxt, pos + 1, cache), nxt

    (_, _, cache), toks = jax.lax.scan(
        body, (first_token, start_pos, cache), None, length=n_steps)
    return toks, cache


# module-level jit: params enter as arguments (closure-captured params
# would retrace per call AND bake 13+ GB of constants into the program)
decode_loop = jax.jit(_decode_loop_impl,
                      static_argnames=("cfg", "n_steps"))


def generate_greedy(params, cfg: DeepSeekConfig, prompt, n_gen: int):
    """Convenience: prefill + greedy decode.  Returns the generated ids."""
    cache = init_cache(cfg)
    logits, cache = prefill(params, cache,
                            jnp.asarray(prompt, jnp.int32), cfg)
    first = jnp.argmax(logits[-1]).astype(jnp.int32)
    toks, _ = decode_loop(params, cache, first,
                          jnp.asarray(len(prompt), jnp.int32), cfg,
                          n_steps=n_gen - 1)
    return [int(first)] + [int(t) for t in toks]
