"""Functional JAX Llama — the model layer of the reference
(`chat/llama/model.py`): decode step, chunked prefill and the batched
training/eval forward, all plain JAX compiled by XLA.

Design deltas from the reference:

- Functional params/caches (pytrees) instead of nn.Module state; the layer
  stack runs under ``lax.scan`` so 32 layers trace once.
- Attention weights are stored fused per KV head from load time
  (`wqkv_f [kv, hidden, (g+2)·hd]`, `wo_f [kv, g·hd, hidden]`); the
  reference rebuilds fused weights in a post-load hook
  (`model.py:286-328`).  The KV-head axis is what tensor parallelism shards.
- The sglang residual-pair convention is used end-to-end: each layer takes
  (hidden, residual) and returns (attn_out, residual'), so the residual add
  sits with the attention block's RMSNorm (`kernel_sglang.cuh:98-106`).
- KV caches are preallocated to capacity [L, kv_heads, max_seq, head_dim]
  with a dynamic position — no per-length recompiles (the reference derives
  SEQ_LEN from the cache tensor shape per call,
  `llama_kernel_dispatch.cu:35`).
- GQA is native (the reference is MHA-only).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from clusterfusion.config import LlamaConfig
from clusterfusion.ops.reference import fused_add_rmsnorm_ref, rmsnorm_ref
from clusterfusion.ops.rope import (
    apply_rope_gptj,
    apply_rope_neox,
    rope_tables_gptj,
    rope_tables_neox,
)
from clusterfusion.ops.quant import (Int8KV, QuantizedTensor,
    maybe_dequantize, quantize_kv_rows)

LlamaParams = Dict[str, Any]


# --------------------------------------------------------------------------
# Parameter construction
# --------------------------------------------------------------------------


def fuse_attention_weights(wq, wk, wv, wo, cfg: LlamaConfig):
    """Torch-Linear-layout projections -> the per-KV-head fused layout.

    wq: [heads·hd, hidden]; wk/wv: [kv·hd, hidden]; wo: [hidden, heads·hd]
    (all [out, in]).  Returns (wqkv_f [kv, hidden, (g+2)·hd],
    wo_f [kv, g·hd, hidden]) — the counterpart of ``_build_cf_weights``
    (`chat/llama/model.py:292-328`), done once at load."""
    kv, g, hd, hidden = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, \
        cfg.head_dim_, cfg.hidden_dim
    q = wq.reshape(kv, g, hd, hidden).transpose(0, 3, 1, 2).reshape(kv, hidden, g * hd)
    k = wk.reshape(kv, hd, hidden).transpose(0, 2, 1)
    v = wv.reshape(kv, hd, hidden).transpose(0, 2, 1)
    return (jnp.concatenate([q, k, v], axis=-1),
            wo.T.reshape(kv, g * hd, hidden))


def fuse_qkv_bias(bq, bk, bv, cfg: LlamaConfig):
    """Per-projection bias vectors (torch layout: bq [heads·hd],
    bk/bv [kv·hd]) → [kv, (g+2)·hd], matching ``fuse_attention_weights``'s
    wqkv_f columns (Qwen2 family)."""
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    return jnp.concatenate(
        [bq.reshape(kv, g * hd), bk.reshape(kv, hd), bv.reshape(kv, hd)],
        axis=-1)


def init_params(cfg: LlamaConfig, key, dtype=jnp.bfloat16) -> LlamaParams:
    """Random-init params in the fused layout (layer arrays stacked on axis
    0 for lax.scan)."""
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    h, L, V, f = cfg.hidden_dim, cfg.n_layers, cfg.vocab_size, cfg.ffn_dim
    ks = jax.random.split(key, 8)

    def norm(k, shape, fan_in):
        # generate directly in the target dtype: at 7B scale an fp32
        # intermediate would blow HBM during init
        return jax.random.normal(k, shape, dtype) / jnp.sqrt(fan_in).astype(dtype)

    params = {
        "embed": norm(ks[0], (V, h), h),
        "layers": {
            "wqkv_f": norm(ks[1], (L, kv, h, (g + 2) * hd), h),
            "wo_f": norm(ks[2], (L, kv, g * hd, h), g * hd),
            "w13": norm(ks[3], (L, 2, h, f), h),
            "w2": norm(ks[4], (L, f, h), f),
            "attn_norm": jnp.ones((L, h), dtype),
            "ffn_norm": jnp.ones((L, h), dtype),
        },
        "final_norm": jnp.ones((h,), dtype),
        "lm_head": norm(ks[5], (h, V), h),
    }
    if cfg.qkv_bias:
        # Qwen2-family QKV bias, per-KV-head columns matching wqkv_f
        params["layers"]["bqkv_f"] = norm(ks[6], (L, kv, (g + 2) * hd), hd)
    if cfg.sandwich_norms:
        # gemma-2 post-attention / post-FFN RMSNorm weights
        params["layers"]["post_attn_norm"] = jnp.ones((L, h), dtype)
        params["layers"]["post_ffn_norm"] = jnp.ones((L, h), dtype)
    return params


@jax.named_scope("lm_head")
def _lm_logits(xn, lm):
    """LM-head projection accepting a bf16 matrix or a per-column-int8
    QuantizedTensor (dequant commutes with the dot: scale the logits)."""
    if isinstance(lm, QuantizedTensor):
        y = jnp.dot(xn, lm.q.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
        return y * lm.s.reshape(-1)     # [V] broadcast: keeps y's rank
    return jnp.dot(xn, lm, preferred_element_type=jnp.float32)


def rope_table(cfg: LlamaConfig, max_pos: Optional[int] = None):
    """Full-dim (cos, sin) tables [max_pos, head_dim] for cfg.rope_style
    (NEOX tables repeat the half-dim table twice)."""
    hd = cfg.head_dim_
    max_pos = max_pos or cfg.max_seq_len
    l3 = cfg.llama3_scaling
    if cfg.rope_style == "neox":
        c, s = rope_tables_neox(hd, max_pos, cfg.rope_theta, l3)
        return (jnp.concatenate([c, c], axis=-1), jnp.concatenate([s, s], axis=-1))
    c, s = rope_tables_gptj(hd, max_pos, cfg.rope_theta, l3)
    return c, s


def init_cache(cfg: LlamaConfig, max_seq: Optional[int] = None,
               dtype=jnp.bfloat16):
    """[L, kv_heads, capacity, head_dim] ×2, zero-filled (masked rows are
    still multiplied by zero probabilities, so they must not be NaN).

    dtype "int8" (or jnp.int8) → :class:`~clusterfusion.ops.quant.Int8KV`
    caches (int8 payload + per-position scale planes); capacity rounds up to
    the scale-plane row (128)."""
    cap = max_seq or cfg.max_seq_len
    if dtype == "int8" or dtype == jnp.int8:
        from clusterfusion.ops.quant import init_kv_int8
        if cap > 128:
            cap = -(-cap // 128) * 128
        return (init_kv_int8(cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_),
                init_kv_int8(cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_))
    shape = (cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_)
    return jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------


def glu_act(y_gate, y_up, act: str = "silu"):
    """Gated-linear-unit activation for the SwiGLU/GeGLU FFN families:
    ``act(gate) * up`` in f32.  "silu" = llama/mistral/qwen SwiGLU;
    "gelu_tanh" = gemma GeGLU (HF gelu_pytorch_tanh)."""
    if act == "silu":
        g = jax.nn.silu(y_gate)
    elif act == "gelu_tanh":
        g = jax.nn.gelu(y_gate, approximate=True)
    else:
        raise ValueError(f"unknown ffn activation {act!r}")
    return g * y_up


def _ffn(x, w13, w2, act: str = "silu"):
    """SwiGLU/GeGLU in bf16 with fp32 accumulation.

    w13: [2, hidden, ffn] = stacked (w1, w3) so a tp shard of the ffn axis
    holds *matching* gate/up columns (no resharding at the gate·up product).
    """
    if isinstance(w13, QuantizedTensor) and w13.kind == "int8":
        # INT8 per-column scales commute with the dot: scale the result
        # (XLA fuses the int8->bf16 convert into the matmul; a dequantized
        # copy would materialize ~185 MB/layer at 7B)
        y = jnp.einsum("...d,udf->...uf", x, w13.q.astype(x.dtype),
                       preferred_element_type=jnp.float32) * w13.s[:, 0, :]
        act = glu_act(y[..., 0, :], y[..., 1, :], act).astype(x.dtype)
        return (jnp.dot(act, w2.q.astype(x.dtype),
                        preferred_element_type=jnp.float32)
                * w2.s).astype(x.dtype)
    w13 = maybe_dequantize(w13, x.dtype)
    w2 = maybe_dequantize(w2, x.dtype)
    y = jnp.einsum("...d,udf->...uf", x, w13,
                   preferred_element_type=jnp.float32)
    act = glu_act(y[..., 0, :], y[..., 1, :], act).astype(x.dtype)
    return jnp.dot(act, w2, preferred_element_type=jnp.float32).astype(x.dtype)


def _qkv_eager(x, wqkv_f, cfg: LlamaConfig, bias=None):
    """x [B?, T, h] → q [.., T, kv, g, hd], k/v [.., T, kv, hd] from the
    per-KV-head fused layout [kv, h, (g+2)·hd].  ``bias`` [kv, (g+2)·hd]:
    optional QKV projection bias in the same column layout (Qwen2-family;
    llama/mistral have none)."""
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    wqkv_f = maybe_dequantize(wqkv_f, x.dtype)
    y = jnp.einsum("...td,Gdc->...tGc", x, wqkv_f,
                   preferred_element_type=jnp.float32).astype(x.dtype)
    if bias is not None:
        y = y + bias.astype(y.dtype)
    # kv heads from the weight: a tp shard holds only its own heads
    y = y.reshape(*y.shape[:-2], -1, (g + 2) * hd)
    q = y[..., : g * hd].reshape(*y.shape[:-1], g, hd)
    k = y[..., g * hd:(g + 1) * hd]
    v = y[..., (g + 1) * hd:]
    return q, k, v


def _apply_rope(x, cos, sin, style):
    if style == "neox":
        hd = x.shape[-1]
        return apply_rope_neox(x, cos[..., : hd // 2], sin[..., : hd // 2])
    return apply_rope_gptj(x, cos, sin)


def _prefix_rows(cache_l, pos0: int):
    """First pos0 positions of a per-layer cache slice [kv, S, hd]
    (dequantized for Int8KV)."""
    if isinstance(cache_l, Int8KV):
        H = cache_l.q.shape[0]
        sflat = cache_l.s.reshape(H, -1)[:, :pos0]
        return cache_l.q[:, :pos0].astype(jnp.float32) * sflat[:, :, None]
    return cache_l[:, :pos0]


def _cache_fill(cache, rows, pos0: int):
    """Write [L, kv, T, hd] freshly-computed rows at positions
    pos0..pos0+T-1 (quantizing per row for Int8KV)."""
    from clusterfusion.ops.quant import cache_fill_rows
    return cache_fill_rows(cache, rows, pos0)


def layer_window(cfg: LlamaConfig, l):
    """Sliding window of layer ``l`` (0 = full context): every layer for
    pattern "all" (Mistral), even layers only for "even" (Gemma-2)."""
    if not cfg.sliding_window:
        return 0
    if cfg.window_pattern == "even":
        return jnp.where(l % 2 == 0, cfg.sliding_window, 0)
    return cfg.sliding_window


def attend(q, k, v, qpos, kpos, window, softcap: float = 0.0):
    """Causal (optionally windowed, softcapped) attention of queries at
    positions ``qpos [T]`` over keys at ``kpos [S]``.

    q [..., T, kv, g, hd]; k/v [kv, S, hd].  bf16 operands with fp32
    accumulation; ``window`` may be traced (0 = full context).  Returns
    [..., T, kv, g, hd] in q's dtype."""
    hd = q.shape[-1]
    dt = q.dtype
    s = jnp.einsum("...tkgd,ksd->...kgts", q, k.astype(dt),
                   preferred_element_type=jnp.float32) / jnp.sqrt(
                       jnp.float32(hd))
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    mask = kpos[None, :] <= qpos[:, None]                  # [T, S]
    lo = qpos[:, None] - jnp.where(window > 0, window, qpos[:, None] + 1)
    mask &= kpos[None, :] > lo
    s = jnp.where(mask, s, -1e30)
    p = jax.nn.softmax(s, axis=-1).astype(dt)
    return jnp.einsum("...kgts,ksd->...tkgd", p, v.astype(dt),
                      preferred_element_type=jnp.float32).astype(q.dtype)


def round_q(q, dtype):
    """RoPE'd decode queries rounded to the model's ``dtype`` and kept in
    q's own.  The serving step's paged attention takes q in bf16, so the
    decode and verify steps round it the same way: every decode path then
    attends over the same operand values."""
    return q.astype(dtype).astype(q.dtype)


def prompt_attention(q, k, v, window, softcap: float = 0.0):
    """Causal attention of a prompt chunk that starts at position 0 over
    itself: q [1, T, kv, g, hd], k/v [kv, T, hd].  RoPE leaves q and k in
    fp32; v carries the model's dtype.

    On a GPU, where cuDNN's fused attention takes the features (a bf16 or
    fp16 model, head_dim <= 128, no softcap, a static window), it runs
    there on q and k rounded to v's dtype: at T=1,024 and Llama-2-7B widths
    it took 144 µs a layer against 273 µs for :func:`attend` (H100 80GB
    HBM3 at 400 W).  Elsewhere :func:`attend`."""
    B, T, kv, g, hd = q.shape
    dt = v.dtype
    if (jax.default_backend() != "gpu" or softcap or hd > 128
            or dt not in (jnp.bfloat16, jnp.float16)
            or not isinstance(window, int)):
        pos = jnp.arange(T)
        return attend(q, k, v, pos, pos, window, softcap)
    k, v = (x.transpose(1, 0, 2)[None].astype(dt) for x in (k, v))
    o = jax.nn.dot_product_attention(
        q.reshape(B, T, kv * g, hd).astype(dt), k, v, is_causal=True,
        local_window_size=(window - 1, 0) if window else None,
        implementation="cudnn")
    return o.reshape(B, T, kv, g, hd).astype(q.dtype)


# --------------------------------------------------------------------------
# Prefill.  ``pos0`` makes it a *chunked* prefill: tokens occupy absolute
# positions pos0..pos0+T-1 and attend to the already-filled cache prefix —
# a serving capability the reference (which prefills whole prompts with a
# materialized [T, S] score tensor, `model.py:589-603`) lacks.  The first
# chunk's attention is :func:`prompt_attention`; a later chunk's is the XLA
# einsum of :func:`attend` over the cached prefix and itself.
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("cfg", "pos0"))
def prefill_chunk(params: LlamaParams, k_cache, v_cache, tokens: jnp.ndarray,
                  cfg: LlamaConfig, pos0: int = 0):
    """Process tokens [T] at positions pos0..pos0+T-1, filling the caches.

    Requires the first ``pos0`` cache positions to be filled.  Returns
    (logits [T, vocab], k_cache', v_cache')."""
    T = tokens.shape[0]
    cos_t, sin_t = rope_table(cfg, max_pos=max(pos0 + T, cfg.max_seq_len))
    cos, sin = cos_t[pos0:pos0 + T][None], sin_t[pos0:pos0 + T][None]
    h = params["embed"][tokens][None]                      # [1, T, hidden]
    qpos = pos0 + jnp.arange(T)
    kpos = jnp.arange(pos0 + T)

    def one_layer(h, xs):
        p, kc_l, vc_l, l = xs
        xn = rmsnorm_ref(h, p["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv_eager(xn, p["wqkv_f"], cfg, p.get("bqkv_f"))
        q = _apply_rope(q, cos[..., None, None, :], sin[..., None, None, :],
                        cfg.rope_style)
        k = _apply_rope(k, cos[..., None, :], sin[..., None, :], cfg.rope_style)
        k_new = k[0].transpose(1, 0, 2)                    # [kv, T, hd]
        v_new = v[0].transpose(1, 0, 2)
        window = layer_window(cfg, l)
        if pos0:
            k_ctx = jnp.concatenate(
                [_prefix_rows(kc_l, pos0).astype(h.dtype), k_new], axis=1)
            v_ctx = jnp.concatenate(
                [_prefix_rows(vc_l, pos0).astype(h.dtype), v_new], axis=1)
            o = attend(q, k_ctx, v_ctx, qpos, kpos, window,
                       cfg.attn_logit_softcap)             # [1,T,kv,g,hd]
        else:
            o = prompt_attention(q, k_new, v_new, window,
                                 cfg.attn_logit_softcap)
        G = p["wo_f"].shape[0]
        attn = jnp.einsum("btGc,Gco->bto", o.reshape(1, T, G, -1),
                          maybe_dequantize(p["wo_f"], h.dtype),
                          preferred_element_type=jnp.float32
                          ).astype(h.dtype)
        if cfg.sandwich_norms:
            attn = rmsnorm_ref(attn, p["post_attn_norm"], cfg.norm_eps)
        h = h + attn
        xn2 = rmsnorm_ref(h, p["ffn_norm"], cfg.norm_eps)
        f_out = _ffn(xn2, p["w13"], p["w2"], cfg.ffn_act)
        if cfg.sandwich_norms:
            f_out = rmsnorm_ref(f_out, p["post_ffn_norm"], cfg.norm_eps)
        return h + f_out, (k_new, v_new)

    h, (k_new, v_new) = jax.lax.scan(
        one_layer, h, (params["layers"], k_cache, v_cache,
                       jnp.arange(cfg.n_layers, dtype=jnp.int32)))
    k_cache = _cache_fill(k_cache, k_new, pos0)
    v_cache = _cache_fill(v_cache, v_new, pos0)
    xn = rmsnorm_ref(h, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(xn[0], params["lm_head"])
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * jnp.tanh(logits / c)
    return logits, k_cache, v_cache


def prefill(params: LlamaParams, k_cache, v_cache, tokens: jnp.ndarray,
            cfg: LlamaConfig):
    """Process a full prompt from position 0, fill caches.

    tokens: [T] int32.  Returns (logits [T, vocab], k_cache', v_cache').
    The reference's analogue is the eager mask path (`model.py:589-603`)."""
    return prefill_chunk(params, k_cache, v_cache, tokens, cfg, pos0=0)


# --------------------------------------------------------------------------
# Batched training/eval forward (no cache) — differentiable, GSPMD-shardable
# --------------------------------------------------------------------------


def layer_forward(h, p, cos, sin, mask, cfg: LlamaConfig):
    """One decoder layer of the batched training/eval forward.

    h [B, T, hidden]; p: one layer's slice of the ``layers`` pytree;
    cos/sin [1, T, hd]; mask [T, T] causal.  Shared by :func:`forward`
    (full stack via lax.scan) and the pipeline-parallel schedule
    (``parallel.pp``: each pp stage scans its local sub-stack)."""
    B, T = h.shape[0], h.shape[1]
    kv, g, hd = cfg.kv_heads, cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    xn = rmsnorm_ref(h, p["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv_eager(xn, p["wqkv_f"], cfg, p.get("bqkv_f"))         # q [B,T,kv,g,hd]
    q = _apply_rope(q, cos[..., None, None, :], sin[..., None, None, :],
                    cfg.rope_style)
    k = _apply_rope(k, cos[..., None, :], sin[..., None, :], cfg.rope_style)
    scale = 1.0 / jnp.sqrt(jnp.float32(cfg.head_dim_))
    scores = jnp.einsum("btkgd,bskd->bkgts", q, k,
                        preferred_element_type=jnp.float32) * scale
    if cfg.attn_logit_softcap:
        csc = cfg.attn_logit_softcap
        scores = csc * jnp.tanh(scores / csc)
    scores = jnp.where(mask[None, None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(h.dtype)
    o = jnp.einsum("bkgts,bskd->btkgd", probs, v,
                   preferred_element_type=jnp.float32).astype(h.dtype)
    G = p["wo_f"].shape[0]
    attn = jnp.einsum("btGc,Gco->bto",
                      o.reshape(B, T, G, (kv // G) * g * hd),
                      maybe_dequantize(p["wo_f"], h.dtype),
                      preferred_element_type=jnp.float32
                      ).astype(h.dtype)
    if cfg.sandwich_norms:
        attn = rmsnorm_ref(attn, p["post_attn_norm"], cfg.norm_eps)
    h2 = h + attn
    xn2 = rmsnorm_ref(h2, p["ffn_norm"], cfg.norm_eps)
    f_out = _ffn(xn2, p["w13"], p["w2"], cfg.ffn_act)
    if cfg.sandwich_norms:
        f_out = rmsnorm_ref(f_out, p["post_ffn_norm"], cfg.norm_eps)
    return h2 + f_out


def forward(params: LlamaParams, tokens: jnp.ndarray, cfg: LlamaConfig,
            dtype=None):
    """Causal LM forward for training/eval.  tokens: [B, T] int32 →
    logits [B, T, vocab] fp32.  Differentiable.

    ``dtype=jnp.float32`` computes every layer in fp32, each layer's
    weights upcast inside the layer scan (one layer in fp32 at a time) —
    under ``jax.default_matmul_precision("highest")`` this is the fp32
    oracle the decode, prefill and serving paths are checked against."""
    T = tokens.shape[1]
    cos_t, sin_t = rope_table(cfg, max_pos=max(T, cfg.max_seq_len))
    cos, sin = cos_t[:T][None], sin_t[:T][None]            # [1, T, hd]
    h = params["embed"][tokens]                            # [B, T, hidden]
    if dtype is not None:
        h = h.astype(dtype)

    def one_layer(h, p, m):
        if dtype is not None:
            p = upcast(p, dtype)
        return layer_forward(h, p, cos, sin, m, cfg)

    mask = jnp.tril(jnp.ones((T, T), jnp.bool_))
    mask_w = mask
    if cfg.sliding_window:
        mask_w = mask & jnp.triu(jnp.ones((T, T), jnp.bool_),
                                 k=1 - cfg.sliding_window)

    if cfg.sliding_window and cfg.window_pattern == "even":
        # gemma-2 interleaved local/global: scan layer pairs (even layer
        # windowed, odd layer full-context)
        assert cfg.n_layers % 2 == 0, cfg.n_layers
        lp2 = jax.tree.map(
            lambda a: a.reshape(cfg.n_layers // 2, 2, *a.shape[1:]),
            params["layers"])

        def pairf(h, p2):
            for i, m in enumerate((mask_w, mask)):
                pi = jax.tree.map(lambda a: a[i], p2)
                h = one_layer(h, pi, m)
            return h, None

        h, _ = jax.lax.scan(pairf, h, lp2)
    else:
        m = mask_w if cfg.sliding_window else mask
        h, _ = jax.lax.scan(
            lambda h, p: (one_layer(h, p, m), None), h, params["layers"])
    xn = rmsnorm_ref(h, params["final_norm"], cfg.norm_eps)
    logits = _lm_logits(xn, params["lm_head"])
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * jnp.tanh(logits / c)
    return logits


@functools.partial(jax.jit, static_argnames=("cfg",))
def reference_logits(params: LlamaParams, tokens: jnp.ndarray,
                     cfg: LlamaConfig):
    """fp32 oracle logits [T, vocab] of one token sequence [T]: the
    training forward with every layer in fp32 at highest matmul
    precision (GPU float32 matmuls otherwise run in TF32)."""
    with jax.default_matmul_precision("highest"):
        return forward(params, tokens[None], cfg, dtype=jnp.float32)[0]


def upcast(tree, dtype=jnp.float32):
    """Every floating leaf of a pytree (params, caches) cast to ``dtype``;
    int8 payloads stay as they are."""
    return jax.tree.map(
        lambda a: a.astype(dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


# --------------------------------------------------------------------------
# Decode step
# --------------------------------------------------------------------------


def _cache_append(cache, rows, l, pos):
    """Append [kv, 1, hd] new rows at (layer l, position pos) — plain dtype
    cast for bf16/fp8 caches, row quantization + scale-plane write for
    :class:`Int8KV`."""
    if isinstance(cache, Int8KV):
        q8, s = quantize_kv_rows(rows)               # [kv,1,hd], [kv,1]
        H = q8.shape[0]
        qc = jax.lax.dynamic_update_slice(cache.q, q8[None], (l, 0, pos, 0))
        sc = jax.lax.dynamic_update_slice(
            cache.s, s.reshape(1, H, 1, 1).astype(cache.s.dtype),
            (l, 0, pos // 128, pos - (pos // 128) * 128))
        return Int8KV(qc, sc)
    return jax.lax.dynamic_update_slice(
        cache, rows[None].astype(cache.dtype), (l, 0, pos, 0))


def _cache_layer(cache, l):
    """Layer l of a cache, dequantized to f32-compatible values:
    [kv, cap, hd]."""
    if isinstance(cache, Int8KV):
        ql = jax.lax.dynamic_index_in_dim(cache.q, l, 0, keepdims=False)
        sl = jax.lax.dynamic_index_in_dim(cache.s, l, 0, keepdims=False)
        H, cap, _ = ql.shape
        sflat = sl.reshape(H, -1)[:, :cap]           # [kv, cap]
        return ql.astype(jnp.float32) * sflat[:, :, None]
    return jax.lax.dynamic_index_in_dim(cache, l, 0, keepdims=False)


@jax.named_scope("attention")
def attention_block(x, residual, p, kc, vc, l, pos, cos, sin,
                    cfg: LlamaConfig):
    """The attention half of one decoder layer for one token — the unit
    ClusterFusion fuses into one kernel launch: residual add, RMSNorm, QKV
    (+ bias), RoPE, KV append at ``pos``, decode attention over positions
    ``<= pos`` and the O projection.

    x/residual [1, hidden]; ``p`` one layer's weights, possibly a tp shard
    (the head count comes from the weights); kc/vc the stacked caches.
    Returns (attn [1, hidden] — a per-shard partial under tp —, residual',
    kc', vc')."""
    xn, residual = fused_add_rmsnorm_ref(x, residual, p["attn_norm"],
                                         cfg.norm_eps)
    q, k, v = _qkv_eager(xn[None], p["wqkv_f"], cfg, p.get("bqkv_f"))
    q = round_q(_apply_rope(q, cos[0], sin[0], cfg.rope_style), x.dtype)
    k = _apply_rope(k, cos[0], sin[0], cfg.rope_style)
    kc = _cache_append(kc, k[0].transpose(1, 0, 2), l, pos)
    vc = _cache_append(vc, v[0].transpose(1, 0, 2), l, pos)
    kl, vl = _cache_layer(kc, l), _cache_layer(vc, l)
    o = attend(q[0], kl, vl, pos[None], jnp.arange(kl.shape[1]),
               layer_window(cfg, l), cfg.attn_logit_softcap)
    G = p["wo_f"].shape[0]
    attn = jnp.einsum("Gc,Gco->o", o.reshape(G, -1),
                      maybe_dequantize(p["wo_f"], x.dtype),
                      preferred_element_type=jnp.float32
                      ).astype(x.dtype)[None]
    return attn, residual, kc, vc


@jax.named_scope("ffn")
def ffn_block(attn, residual, p, cfg: LlamaConfig,
              reduce=lambda y: y):
    """The FFN half: optional post-attention norm, residual add + RMSNorm,
    gated FFN, optional post-FFN norm.  ``reduce`` sums per-shard partials
    (tensor parallelism) before each nonlinear norm."""
    attn = reduce(attn)
    if cfg.sandwich_norms:
        attn = rmsnorm_ref(attn, p["post_attn_norm"], cfg.norm_eps)
    xn2, residual = fused_add_rmsnorm_ref(attn, residual, p["ffn_norm"],
                                          cfg.norm_eps)
    x = reduce(_ffn(xn2, p["w13"], p["w2"], cfg.ffn_act))
    if cfg.sandwich_norms:
        x = rmsnorm_ref(x, p["post_ffn_norm"], cfg.norm_eps)
    return x, residual


def _decode_step_impl(params: LlamaParams, k_cache, v_cache,
                      token: jnp.ndarray, pos: jnp.ndarray, cfg: LlamaConfig,
                      reduce=lambda y: y):
    """One autoregressive decode step at position ``pos`` (``pos`` tokens
    already cached).  token: [] int32.  Returns (logits [vocab], k_cache',
    v_cache').  ``reduce``: see :func:`ffn_block`."""
    hd = cfg.head_dim_
    cos_t, sin_t = rope_table(cfg)
    cos = jax.lax.dynamic_slice(cos_t, (pos, 0), (1, hd))   # [1, hd]
    sin = jax.lax.dynamic_slice(sin_t, (pos, 0), (1, hd))
    x = params["embed"][token][None]                        # [1, hidden]
    residual = jnp.zeros_like(x)

    def layer(carry, xs):
        x, residual, kc, vc = carry
        p, l = xs
        attn, residual, kc, vc = attention_block(x, residual, p, kc, vc, l,
                                                 pos, cos, sin, cfg)
        x, residual = ffn_block(attn, residual, p, cfg, reduce)
        return (x, residual, kc, vc), None

    layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
    (x, residual, k_cache, v_cache), _ = jax.lax.scan(
        layer, (x, residual, k_cache, v_cache),
        (params["layers"], layer_idx))
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    logits = _lm_logits(xn[0], params["lm_head"])
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * jnp.tanh(logits / c)
    return logits, k_cache, v_cache


# Test/parity variant: inputs preserved (caches copied on update).
decode_step = jax.jit(_decode_step_impl, static_argnames=("cfg",))


def _decode_loop_impl(params, k_cache, v_cache, first_token, start_pos,
                      cfg: LlamaConfig, n_steps: int = 32):
    """Greedy-decode ``n_steps`` tokens entirely on device (one dispatch).

    Returns (tokens [n_steps] — the inputs' successors, k_cache', v_cache').
    The host-side streaming loop lives in models.generation; this is the
    throughput path (no host round-trip per token)."""
    def body(carry, _):
        tok, pos, kc, vc = carry
        logits, kc, vc = _decode_step_impl(params, kc, vc, tok, pos, cfg)
        nxt = jnp.argmax(logits).astype(jnp.int32)
        return (nxt, pos + 1, kc, vc), nxt

    (_, _, k_cache, v_cache), toks = jax.lax.scan(
        body, (first_token, start_pos, k_cache, v_cache), None,
        length=n_steps)
    return toks, k_cache, v_cache


decode_loop = jax.jit(_decode_loop_impl,
                      static_argnames=("cfg", "n_steps"),
                      donate_argnums=(1, 2))

# Engine variant: donates the caches so the per-layer appends are in place
# (no full-cache copy per token).
decode_step_donated = jax.jit(_decode_step_impl, static_argnames=("cfg",),
                              donate_argnums=(1, 2))
