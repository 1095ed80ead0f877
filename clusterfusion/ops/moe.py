"""Mixture-of-Experts SwiGLU FFN (top-k routed + shared experts).

DeepSeek-V2 interleaves MLA attention with MoE FFN layers; the reference
kernel library stops at the attention half (`include/H100/deepseek/` has no
FFN at all), so this is capability beyond it:

- **Decode (bs=1..few)**: the minimum-HBM-traffic formulation — gather the
  ``top_k`` selected experts' weights by ``dynamic_index`` and run k dense
  SwiGLUs.  At bs=1 only k·(2·h·f + f·h) weight bytes move, the same as a
  dense FFN of k experts' size; a masked-dense pass would read all E
  experts.
- **Prefill / training / multi-chip**: the masked-dense formulation —
  every expert processes every token, masked+weighted by the router.
  O(E) FLOPs, but it is `shard_map`-friendly: shard the expert axis
  across chips and the combine is one ``psum`` (each chip computes its
  local experts' contribution).  For T tokens with top-k routing, tokens
  per expert average T·k/E, so at prefill scale the waste is bounded and
  the all-to-all machinery XLA would otherwise need disappears.

Router: softmax over expert logits, top-k, renormalized within the k
selected (DeepSeek-V2 convention).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from clusterfusion.ops.quant import QuantizedTensor, maybe_dequantize


def route_top_k(x, router_w, top_k: int, *, norm_topk_prob: bool = True,
                routed_scaling_factor: float = 1.0):
    """x [T, h], router_w [h, E] → (gates [T, E] with EXACTLY top_k
    nonzero per row, sel [T, top_k] expert indices).  f32 throughout.

    One ``top_k`` call ranks and selects (a threshold-mask formulation
    picks extra experts on tied probabilities and diverges between the
    dense and gathered formulations).  ``norm_topk_prob=True`` renormalizes
    the selected gates to sum 1 (DeepSeek-V3 convention);
    ``False`` keeps raw softmax probs scaled by ``routed_scaling_factor``
    (DeepSeek-V2/V2-Lite convention: their configs set
    norm_topk_prob=false, routed_scaling_factor 16.0 / 1.0)."""
    logits = jnp.einsum("th,he->te", x.astype(jnp.float32),
                        router_w.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    vals, sel = jax.lax.top_k(probs, top_k)                # [T, k] each
    if norm_topk_prob:
        vals = vals / jnp.sum(vals, axis=-1, keepdims=True)
    else:
        vals = vals * routed_scaling_factor
    E = probs.shape[-1]
    onehot = jax.nn.one_hot(sel, E, dtype=jnp.float32)     # [T, k, E]
    gates = jnp.einsum("tk,tke->te", vals, onehot)
    return gates, sel


def _swiglu(x, w13, w2):
    """Per-expert SwiGLU; int8 QuantizedTensor experts stream as int8 with
    scale-after-dot (no materialized copies — the decode formulation's
    whole point is minimum HBM bytes); int4 falls back to tile dequant of
    the ONE gathered expert (still k experts' bytes, not E's)."""
    if isinstance(w13, QuantizedTensor) and w13.kind == "int8":
        y = jnp.einsum("...d,udf->...uf", x, w13.q.astype(x.dtype),
                       preferred_element_type=jnp.float32) \
            * w13.s[:, 0, :]
        act = (jax.nn.silu(y[..., 0, :]) * y[..., 1, :]).astype(x.dtype)
        return jnp.dot(act, w2.q.astype(x.dtype),
                       preferred_element_type=jnp.float32) * w2.s
    w13 = maybe_dequantize(w13, x.dtype).astype(x.dtype)
    w2 = maybe_dequantize(w2, x.dtype).astype(x.dtype)
    y = jnp.einsum("...d,udf->...uf", x, w13,
                   preferred_element_type=jnp.float32)
    act = (jax.nn.silu(y[..., 0, :]) * y[..., 1, :]).astype(x.dtype)
    return jnp.dot(act, w2, preferred_element_type=jnp.float32)


def _expert(w_all, e):
    """Expert slice that also descends QuantizedTensor pytrees (q and s
    both carry the leading expert axis)."""
    return jax.tree.map(
        lambda a: jax.lax.dynamic_index_in_dim(a, e, 0, keepdims=False),
        w_all)


def moe_ffn_decode(x, router_w, w13_all, w2_all, top_k: int = 2, *,
                   norm_topk_prob: bool = True,
                   routed_scaling_factor: float = 1.0):
    """Gathered-expert MoE for decode.  x [1, h]; w13_all [E, 2, h, f];
    w2_all [E, f, h].  Returns [1, h] in x.dtype."""
    gates, sel = route_top_k(x, router_w, top_k,
                             norm_topk_prob=norm_topk_prob,
                             routed_scaling_factor=routed_scaling_factor)
    out = jnp.zeros((1, x.shape[-1]), jnp.float32)
    for i in range(top_k):
        e = sel[0, i]
        out = out + gates[0, e] * _swiglu(x, _expert(w13_all, e),
                                          _expert(w2_all, e))
    return out.astype(x.dtype)


def moe_ffn_dense(x, router_w, w13_all, w2_all, top_k: int = 2, *,
                  norm_topk_prob: bool = True,
                  routed_scaling_factor: float = 1.0):
    """Masked-dense MoE: every expert runs on every token (shardable over
    the expert axis; the cross-expert sum commutes with ``psum``).
    x [T, h] → [T, h]."""
    gates, _ = route_top_k(x, router_w, top_k,
                           norm_topk_prob=norm_topk_prob,
                           routed_scaling_factor=routed_scaling_factor)
    def body(acc, ew):
        w13, w2, g = ew                                    # g [T]
        y = _swiglu(x, w13, w2)                            # [T, h]
        return acc + g[:, None] * y, None
    acc = jnp.zeros(x.shape, jnp.float32)
    acc, _ = jax.lax.scan(body, acc, (w13_all, w2_all, gates.T))
    return acc.astype(x.dtype)
