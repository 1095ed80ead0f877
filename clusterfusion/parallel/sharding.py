"""PartitionSpecs for params, caches, and activations.

Megatron-style TP mapped onto the fused layouts:

- ``wqkv_f [L, kv_heads, hidden, (g+2)·hd]`` — shard kv_heads over tp
  (column-parallel QKV: each device computes its heads end-to-end).
- ``wo_f [L, kv_heads, g·hd, hidden]`` — shard kv_heads over tp
  (row-parallel O: per-device partial outputs, summed by one all-reduce —
  the device-scope analogue of the reference's DSM `Stage::ATTN` reduce +
  cross-head atomicAdd, `kernel.cuh:561-568,600`).
- ``w13 [L, 2, hidden, ffn]`` / ``w2 [L, ffn, hidden]`` — column/row
  parallel; the stacked (w1, w3) layout keeps matching gate/up columns on
  the same chip, so the SwiGLU product needs no resharding.
- KV caches — shard kv_heads over tp, sequence over sp.
- batch/data — dp on the leading activation axis.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from clusterfusion.config import LlamaConfig


def _qt_spec(spec: P, qt):
    """Spec node for a :class:`QuantizedTensor` param, mirroring its pytree
    structure (same aux data, so spec and param trees stay isomorphic).

    The int8 payload / int4 packed payload keeps the weight's spec (packing
    shrinks an axis but not its meaning).  Scales keep it too, EXCEPT the
    int8 per-output-channel case, whose reduction axis collapsed to 1 and
    must therefore replicate even when the weight shards that axis (w2's
    row-parallel f).  int4 group-scale rows shard with the weight — their
    count along any tp-sharded axis must divide tp."""
    from clusterfusion.ops.quant import QuantizedTensor
    sspec = list(spec) + [None] * (qt.s.ndim - len(spec))
    if qt.kind == "int8":
        sspec[qt.axis] = None
    return QuantizedTensor(spec, P(*sspec), qt.kind, qt.axis,
                           qt.group_size, qt.pack_axis)


def param_pspecs(cfg: LlamaConfig, tp: int, params=None) -> Dict[str, Any]:
    """PartitionSpec pytree matching the param pytree (for shard_map and
    NamedSharding construction).

    Pass ``params`` when the tree holds :class:`QuantizedTensor` weights:
    the matching spec entries are expanded into QuantizedTensor-shaped
    spec nodes (payload + scale specs) so the spec tree stays isomorphic
    to the param tree — quantized tensor-parallel decode works with the
    same mesh layout as bf16."""
    assert cfg.kv_heads % tp == 0, f"tp={tp} must divide kv_heads={cfg.kv_heads}"
    assert cfg.ffn_dim % tp == 0
    specs = {
        "embed": P(None, None),
        "layers": {
            "wqkv_f": P(None, "tp", None, None),
            "wo_f": P(None, "tp", None, None),
            "w13": P(None, None, None, "tp"),
            "w2": P(None, "tp", None),
            "attn_norm": P(None, None),
            "ffn_norm": P(None, None),
        },
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }
    if cfg.qkv_bias:
        # [L, kv_heads, (g+2)·hd] — kv_heads ride tp as in wqkv_f
        specs["layers"]["bqkv_f"] = P(None, "tp", None)
    if cfg.sandwich_norms:
        # [L, hidden] norms replicate like attn_norm/ffn_norm
        specs["layers"]["post_attn_norm"] = P(None, None)
        specs["layers"]["post_ffn_norm"] = P(None, None)
    if params is not None:
        from clusterfusion.ops.quant import QuantizedTensor
        for name in list(specs["layers"]):
            w = params["layers"].get(name)
            if isinstance(w, QuantizedTensor):
                specs["layers"][name] = _qt_spec(specs["layers"][name], w)
        if isinstance(params.get("lm_head"), QuantizedTensor):
            specs["lm_head"] = _qt_spec(specs["lm_head"],
                                        params["lm_head"])
    return specs


def param_shardings(cfg: LlamaConfig, mesh: Mesh,
                    params=None) -> Dict[str, Any]:
    specs = param_pspecs(cfg, mesh.shape["tp"], params)
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


def cache_pspec() -> P:
    """[L, kv_heads, capacity, head_dim] — heads on tp, sequence local
    (``parallel.sp_decode`` shards the sequence too)."""
    return P(None, "tp", None, None)


def cache_shardings(mesh: Mesh):
    return NamedSharding(mesh, cache_pspec())


def shard_params(params, cfg: LlamaConfig, mesh: Mesh):
    """Place a param pytree onto the mesh with the canonical shardings
    (quantized trees included — scale planes shard alongside payloads)."""
    shardings = param_shardings(cfg, mesh, params)
    return jax.tree.map(jax.device_put, params, shardings)
