"""Sequence-parallel (+ tensor-parallel) decode across the device mesh.

The reference scales sequence length *inside one GPU* by splitting the KV
cache across the CTAs of a cluster and merging per-CTA online-softmax
states over DSM (`llama_kernel_dispatch.cu:36`, `kernel.cuh:479-551`); it
has no cross-device sequence parallelism (SURVEY.md §2.3).  This module
lifts that same two-level merge algebra to device scope (SURVEY.md §5
"long-context"):

- the KV cache is sharded over the ``sp`` mesh axis (each device owns a
  contiguous ``capacity/sp`` slice of positions) and over ``tp`` (heads);
- the owner of position ``pos`` appends the current token's K/V to its
  slice (the rank-0-only insertion of `kernel.cuh:444-477`);
- each device attends its local slice and keeps the unnormalized per-head
  softmax state (acc, m, l) — one CTA's state before the cluster merge;
- the device-scope merge is `kernel.cuh:506-551` with collectives in
  place of DSM scalar reduces:
  ``m* = pmax(m); l* = Σ l·e^(m−m*); acc* = Σ acc·e^(m−m*)``;
- the O-projection runs on the merged, normalized heads and is row-parallel
  over ``tp`` (one psum), as in the tp-only path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import maybe_dequantize
from clusterfusion.ops.reference import fused_add_rmsnorm_ref
from clusterfusion.parallel.collective import Stage, cluster_reduce
from clusterfusion.parallel.sharding import param_pspecs


def cache_pspec_2d() -> P:
    """[L, kv_heads, capacity, head_dim]: heads on tp, sequence on sp."""
    return P(None, "tp", "sp", None)


def cache_shardings_2d(mesh: Mesh):
    return NamedSharding(mesh, cache_pspec_2d())


def softmax_partials(q, k, v, valid, softcap: float = 0.0):
    """Unnormalized attention state of queries ``q [kv, g, hd]`` over keys
    ``k/v [kv, S, hd]`` where ``valid [S]``: (acc [kv, g, hd], m [kv, g],
    l [kv, g]) with ``acc / l`` the softmax-weighted mean.  A slice with no
    valid key gives (0, -1e30, 0), which :func:`merge_partials` ignores."""
    s = jnp.einsum("kgd,ksd->kgs", q, k.astype(q.dtype),
                   preferred_element_type=jnp.float32) / jnp.sqrt(
                       jnp.float32(q.shape[-1]))
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    s = jnp.where(valid, s, -1e30)
    m = jnp.max(s, axis=-1)
    p = jnp.where(valid, jnp.exp(s - m[..., None]), 0.0)
    acc = jnp.einsum("kgs,ksd->kgd", p.astype(q.dtype), v.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    return acc, m, jnp.sum(p, axis=-1)


def merge_partials(acc, m, l, axis_name: str):
    """Log-sum-exp merge of per-device softmax states over ``axis_name``;
    returns the normalized attention output [kv, g, hd]."""
    m_g = jax.lax.pmax(m, axis_name)
    alpha = jnp.exp(m - m_g)
    l_g = jax.lax.psum(l * alpha, axis_name)
    acc_g = jax.lax.psum(acc * alpha[..., None], axis_name)
    return acc_g / l_g[..., None]


def make_sp_sharded_decode_step(cfg: LlamaConfig, mesh: Mesh, params=None):
    """Build a jitted (tp, sp)-sharded decode step:

    ``step(params, k_cache, v_cache, token, pos) ->
    (logits [vocab], k_cache', v_cache')``

    params sharded with ``param_shardings`` (tp on heads/ffn, sp
    replicated); caches with ``cache_shardings_2d``.  Requires
    capacity % sp == 0."""
    tp = mesh.shape["tp"]
    hd = cfg.head_dim_

    def local_step(params, k_cache, v_cache, token, pos):
        sp_idx = jax.lax.axis_index("sp")
        cap_l = k_cache.shape[2]                       # local slice length
        start = sp_idx * cap_l
        owner = (pos >= start) & (pos < start + cap_l)
        pos_local = jnp.clip(pos - start, 0, cap_l - 1)
        kpos = start + jnp.arange(cap_l)               # global positions

        cos_t, sin_t = model.rope_table(cfg)
        cos = jax.lax.dynamic_slice(cos_t, (pos, 0), (1, hd))
        sin = jax.lax.dynamic_slice(sin_t, (pos, 0), (1, hd))
        x = params["embed"][token][None]
        residual = jnp.zeros_like(x)

        def append(cache, rows, l):
            cur = jax.lax.dynamic_slice(
                cache, (l, 0, pos_local, 0), (1, cache.shape[1], 1, hd))
            new = jnp.where(owner, rows[None, :, None, :].astype(cache.dtype),
                            cur)
            return jax.lax.dynamic_update_slice(cache, new,
                                                (l, 0, pos_local, 0))

        def layer(carry, xs):
            x, res, kc, vc = carry
            p, l = xs
            xn, res = fused_add_rmsnorm_ref(x, res, p["attn_norm"],
                                            cfg.norm_eps)
            q, k, v = model._qkv_eager(xn[None], p["wqkv_f"], cfg,
                                       p.get("bqkv_f"))
            q = model.round_q(model._apply_rope(q, cos[0], sin[0],
                                                cfg.rope_style)[0, 0],
                              x.dtype)
            k = model._apply_rope(k, cos[0], sin[0], cfg.rope_style)[0, 0]
            kc = append(kc, k, l)
            vc = append(vc, v[0, 0], l)
            window = model.layer_window(cfg, l)
            valid = (kpos <= pos) & (
                kpos > pos - jnp.where(window > 0, window, pos + 1))
            acc, m, lsum = softmax_partials(
                q, jax.lax.dynamic_index_in_dim(kc, l, 0, keepdims=False),
                jax.lax.dynamic_index_in_dim(vc, l, 0, keepdims=False),
                valid, cfg.attn_logit_softcap)
            o = merge_partials(acc, m, lsum, "sp").astype(x.dtype)
            G = p["wo_f"].shape[0]
            attn = jnp.einsum("Gc,Gco->o", o.reshape(G, -1),
                              maybe_dequantize(p["wo_f"], x.dtype),
                              preferred_element_type=jnp.float32)[None]
            x, res = model.ffn_block(attn.astype(x.dtype), res, p, cfg,
                                     lambda y: cluster_reduce(
                                         y, "tp", Stage.ATTN))
            return (x, res, kc, vc), None

        layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
        (x, residual, k_cache, v_cache), _ = jax.lax.scan(
            layer, (x, residual, k_cache, v_cache),
            (params["layers"], layer_idx))
        xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                      cfg.norm_eps)
        logits = model._lm_logits(xn[0], params["lm_head"])
        return logits, k_cache, v_cache               # logits vocab-sharded

    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(param_pspecs(cfg, tp, params), cache_pspec_2d(),
                  cache_pspec_2d(), P(), P()),
        out_specs=(P("tp"), cache_pspec_2d(), cache_pspec_2d()),
        check_vma=False,
    )
    return jax.jit(step)
