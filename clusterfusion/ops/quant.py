"""Weight-only quantization (INT8 per-channel, INT4 group-wise) and 8-bit
KV caches — capabilities beyond the reference (which is fp16-only,
`kernel.cuh:58-62`).

Design:

- ``QuantizedTensor`` is a registered pytree (q, s) + static (kind, axis,
  group_size), so quantized weights ride ``lax.scan`` xs, ``jax.jit``
  arguments, and ``shard_map`` like plain arrays.
- INT8 is symmetric per-*output-channel*: the scale is constant along the
  reduction axis, so dequantization commutes with the matmul —
  ``x @ (q·s) == (x @ q)·s`` — and the matmuls apply the scale to the
  result, not the weight (integers ≤127 are exact in bf16).
- INT4 is symmetric group-wise along the reduction axis (default group 128),
  two nibbles packed per int8 byte (adjacent elements 2b / 2b+1).  The
  scale depends on the reduction position, so the weight is dequantized
  (``maybe_dequantize``) before the dot.
- FP8 KV cache: allocate the cache as ``float8_e4m3fn``; reads convert to
  bf16 and new K/V is rounded to fp8 on append.  No scale is needed at e4m3
  range (±448) for post-RoPE K and V.
- INT8 KV cache (:class:`Int8KV`): int8 payload plus a per-(head, position)
  scale.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Int8KV(NamedTuple):
    """INT8 KV cache: int8 payload with per-(head, position) symmetric
    scales, which commute with the attention dots:

        scores[:, j] = (q · k8_j) · sk_j      (row scale on scores)
        o = Σ_j (p_j · sv_j) · v8_j           (scale folded into p)

    Contiguous caches (``models.llama.init_cache``):
    q: int8 ``[L, H, S, hd]`` (same layout as a bf16 cache).
    s: f32 ``[L, H, R, 128]`` with R = max(ceil(S/128), 8) — position p's
       scale lives at ``[l, h, p//128, p%128]``.

    Paged pools (``ops.paged_attention.init_paged_pool``):
    q: int8 ``[L, pages, H, page, hd]``, s: f32 ``[L, pages, H, page]``.
    """

    q: jnp.ndarray
    s: jnp.ndarray

    @property
    def dtype(self):          # duck-type jnp.ndarray for cache callers
        return jnp.int8

    @property
    def shape(self):
        return self.q.shape


def init_kv_int8(n_layers: int, kv_heads: int, cap: int,
                 head_dim: int) -> Int8KV:
    rows = max(-(-cap // 128), 8)
    return Int8KV(jnp.zeros((n_layers, kv_heads, cap, head_dim), jnp.int8),
                  jnp.ones((n_layers, kv_heads, rows, 128), jnp.float32))


def kv_scales_flat(s: jnp.ndarray, cap: int) -> jnp.ndarray:
    """[L, H, R, 128] → [L, H, cap] per-position scales (eager/oracle use)."""
    L, H, R, _ = s.shape
    return s.reshape(L, H, R * 128)[..., :cap]


def quantize_kv_rows(x: jnp.ndarray):
    """Symmetric int8 row quantization over the trailing dim.
    x [..., hd] → (q int8 [..., hd], s f32 [...])."""
    xa = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xa), axis=-1), 1e-8) * (1.0 / 127.0)
    q = jnp.round(xa / s[..., None]).astype(jnp.int8)
    return q, s


def cache_fill_rows(cache, rows, pos0):
    """Write ``[L, kv, T, hd]`` freshly-computed KV rows at positions
    pos0..pos0+T-1 of a stacked cache — bf16/fp8 by dtype cast, Int8KV by
    per-row quantization with the scale landing in the [L, H, R, 128]
    plane at ``[l, h, p // 128, p % 128]``.  The single owner of the
    contiguous Int8KV scale-plane write layout."""
    if isinstance(cache, Int8KV):
        q8, s = quantize_kv_rows(rows)                 # s [L, kv, T]
        qc = jax.lax.dynamic_update_slice(cache.q, q8, (0, 0, pos0, 0))
        L, H, R, _ = cache.s.shape
        sflat = jax.lax.dynamic_update_slice(
            cache.s.reshape(L, H, R * 128), s.astype(cache.s.dtype),
            (0, 0, pos0))
        return Int8KV(qc, sflat.reshape(L, H, R, 128))
    return jax.lax.dynamic_update_slice(
        cache, rows.astype(cache.dtype), (0, 0, pos0, 0))


def _norm_axis(axis: int, ndim: int) -> int:
    """Normalize to a NEGATIVE index: ``lax.scan`` slices the leading layer
    axis off stacked weight leaves while the static aux data is shared, so
    axes must count from the end to survive the rank change."""
    return axis if axis < 0 else axis - ndim


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QuantizedTensor:
    """Weight-only quantized tensor.

    q: int8 payload.  INT8: same shape as the original.  INT4: ``pack_axis``
       is halved (ADJACENT elements 2b / 2b+1 in one byte's lo/hi nibble,
       so any even-sized block of the pack axis unpacks locally).
    s: float32 scales.  INT8: reduction axis collapsed to 1 (per output
       channel).  INT4: reduction axis of size K/group_size.
    kind: "int8" | "int4" (static).
    axis: reduction axis of the original tensor (static, stored negative so
       ``lax.scan`` slicing a leading layer axis keeps it valid).
    group_size: INT4 quantization group along the reduction axis (static).
    pack_axis: INT4 nibble-packing axis (static, negative; == axis by
       default).
    """

    q: jnp.ndarray
    s: jnp.ndarray
    kind: str
    axis: int
    group_size: int
    pack_axis: int = -1

    def tree_flatten(self):
        return (self.q, self.s), (self.kind, self.axis, self.group_size,
                                  self.pack_axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, s = children
        return cls(q, s, *aux)

    # -- convenience -------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        shp = list(self.q.shape)
        if self.kind == "int4":
            shp[self.pack_axis] *= 2
        return tuple(shp)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def dequantize(self, dtype=jnp.bfloat16) -> jnp.ndarray:
        if self.kind == "int8":
            return (self.q.astype(jnp.float32) * self.s).astype(dtype)
        w = unpack_int4(self.q, self.pack_axis)
        s = expand_group_scales(self.s, self.axis, self.group_size)
        return (w.astype(jnp.float32) * s).astype(dtype)


def quantize_int8(w: jnp.ndarray, axis: int) -> QuantizedTensor:
    """Symmetric per-output-channel INT8 over reduction ``axis``."""
    axis = _norm_axis(axis, w.ndim)
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=axis, keepdims=True)
    s = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / s), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q, s, "int8", axis, 0, axis)


def quantize_int4(w: jnp.ndarray, axis: int, group_size: int = 128,
                  pack_axis: int | None = None) -> QuantizedTensor:
    """Symmetric group-wise INT4 over reduction ``axis`` (values in
    [-7, 7]; -8 unused to keep the grid symmetric), nibble-packed along
    ``pack_axis`` (default: the reduction axis)."""
    axis = _norm_axis(axis, w.ndim)
    pack_axis = axis if pack_axis is None else _norm_axis(pack_axis, w.ndim)
    K = w.shape[axis]
    assert K % group_size == 0, (K, group_size)
    assert w.shape[pack_axis] % 2 == 0, (pack_axis, w.shape)
    wf = jnp.moveaxis(w.astype(jnp.float32), axis, 0)      # [K, ...]
    grp = wf.reshape(K // group_size, group_size, *wf.shape[1:])
    amax = jnp.max(jnp.abs(grp), axis=1)                   # [K/gs, ...]
    s = jnp.maximum(amax, 1e-8) / 7.0
    # scales are rounded to bf16 BEFORE computing the codes, so a bf16
    # copy of the scales reproduces the (code, scale) pairs exactly (codes
    # re-optimize against the rounded scale).
    s = s.astype(jnp.bfloat16).astype(jnp.float32)
    s_rep = jnp.repeat(s, group_size, axis=0)              # [K, ...]
    q = jnp.clip(jnp.round(wf / s_rep), -7, 7).astype(jnp.int32)
    q = jnp.moveaxis(q, 0, axis)
    qp = jnp.moveaxis(q, pack_axis, 0)
    # adjacent pairing: byte b = (row 2b lo, row 2b+1 hi)
    lo, hi = qp[0::2], qp[1::2]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(jnp.int8)
    packed = jnp.moveaxis(packed, 0, pack_axis)
    s = jnp.moveaxis(s, 0, axis)
    return QuantizedTensor(packed, s, "int4", axis, group_size, pack_axis)


def unpack_int4(packed: jnp.ndarray, axis: int) -> jnp.ndarray:
    """int8-packed nibbles [..K/2..] → int32 values [..K..] (rows in natural
    order: byte b holds rows 2b (lo) and 2b+1 (hi) — adjacent pairing).
    hi is one arithmetic shift (``p >> 4`` sign-extends the top nibble);
    lo is ``((p & 15) ^ 8) - 8``."""
    axis = _norm_axis(axis, packed.ndim)
    p = jnp.moveaxis(packed, axis, 0).astype(jnp.int32)    # [K/2, ...]
    lo = ((p & 15) ^ 8) - 8
    hi = jnp.right_shift(p, 4)
    out = jnp.stack([lo, hi], axis=1).reshape((-1,) + p.shape[1:])
    return jnp.moveaxis(out, 0, axis)


def expand_group_scales(s: jnp.ndarray, axis: int,
                        group_size: int) -> jnp.ndarray:
    """[..K/gs..] → [..K..] with each scale row repeated ``gs`` times
    consecutively, via broadcast+reshape (no gather)."""
    axis = _norm_axis(axis, s.ndim)
    s = jnp.moveaxis(s, axis, 0)                           # [K/gs, ...]
    ng = s.shape[0]
    out = jnp.broadcast_to(s[:, None], (ng, group_size) + s.shape[1:])
    out = out.reshape(ng * group_size, *s.shape[1:])
    return jnp.moveaxis(out, 0, axis)


def quantize(w: jnp.ndarray, kind: str, axis: int, group_size: int = 128,
             pack_axis: int | None = None) -> QuantizedTensor:
    if kind == "int8":
        return quantize_int8(w, axis)
    if kind == "int4":
        return quantize_int4(w, axis, group_size, pack_axis)
    raise ValueError(f"unknown quantization kind {kind!r}")


# (reduction axis, int4 pack axis) of the fused-layout weight tensors, as
# negative indices so both stacked [L, ...] and single-layer trees work.
_WEIGHT_AXES = {"wqkv_f": (-2, -2), "wo_f": (-2, -2),
                "w13": (-2, -2), "w2": (-2, -2),
                # DeepSeek MLA stacks (models.deepseek layouts): reduction
                # is the second-minor axis everywhere, same as llama
                "wproj": (-2, -2),   # [L, hidden, n_proj]
                "wuk": (-2, -2),     # [L, h, nope, lora]
                "wuv": (-2, -2),     # [L, h, lora, nope]
                "wo_t": (-2, -2),    # [L, h*nope, hidden]
                # routed-expert stacks (ops.moe gathered formulation)
                "w13_e": (-2, -2),   # [L, E, 2, hidden, f]
                "w2_e": (-2, -2)}    # [L, E, f, hidden]


def quantize_deepseek_params(params, kind: str = "int8",
                             group_size: int = 128, lm_head: bool = False):
    """Weight-only quantization of a DeepSeek MLA param tree: the four
    attention projections (wproj/wuk/wuv/wo_t — the reference's five GEMVs,
    `deepseek/kernel.cuh:128-288`, fused here as proj+absorb+expand+O), the
    dense/shared-expert FFN (w13/w2), and — when present — the
    routed-expert stacks (w13_e/w2_e: int8 streams per-expert with
    scale-after-dot in ops.moe; int4 dequantizes only the gathered top-k
    experts).  The router and norms / embed stay bf16."""
    targets = ["wproj", "wuk", "wuv", "wo_t", "w13", "w2"]
    if "w13_e" in params["layers"]:
        targets += ["w13_e", "w2_e"]
    return quantize_llama_params(params, kind, group_size,
                                 targets=tuple(targets), lm_head=lm_head)


def quantize_llama_params(params, kind: str = "int8", group_size: int = 128,
                          targets=("wqkv_f", "wo_f", "w13", "w2"),
                          lm_head: bool = False):
    """Quantize the per-layer projection weights of a Llama param tree
    (embed / norms stay bf16, standard weight-only practice).  Works on
    both stacked [L, ...] trees and single-layer trees.

    ``lm_head=True`` also quantizes the LM head per-output-column INT8
    (regardless of ``kind``: per-column int8 commutes with the logits dot
    and already halves the head's bytes)."""
    layers = dict(params["layers"])
    for name in targets:
        w = layers[name]
        if isinstance(w, QuantizedTensor):
            continue
        axis, pack_axis = _WEIGHT_AXES[name]
        layers[name] = quantize(w, kind, axis, group_size, pack_axis)
    out = dict(params)
    out["layers"] = layers
    if lm_head and not isinstance(out["lm_head"], QuantizedTensor):
        out["lm_head"] = quantize_int8(out["lm_head"], axis=-2)
    return out


def maybe_dequantize(w, dtype=jnp.bfloat16):
    return w.dequantize(dtype) if isinstance(w, QuantizedTensor) else w
