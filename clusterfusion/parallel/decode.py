"""Tensor-parallel decode and serving across a device mesh.

Inside one GPU the reference's fused layer reduces partial results over
the distributed shared memory of a thread-block cluster (SURVEY.md §2.4);
across devices the same two reduction points — after the head-parallel
attention block (the reference's `Stage::ATTN` DSM reduce + cross-head
atomicAdd, `kernel.cuh:561-568,600`) and after the row-parallel FFN —
become two ``psum`` collectives over the ``tp`` axis, which XLA hands to
NCCL over NVLink.

Layout per device: ``kv_heads/tp`` heads of every weight + cache; RMSNorms
and the residual stream are replicated; logits are vocab-sharded.  The
single-device code runs unchanged on each shard: the head count comes from
the local weights and a ``reduce`` hook sums the partial outputs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.reference import fused_add_rmsnorm_ref
from clusterfusion.parallel.collective import Stage, cluster_reduce
from clusterfusion.parallel.sharding import cache_pspec, param_pspecs


def _tp_reduce(y):
    return cluster_reduce(y, "tp", Stage.ATTN)


def make_sharded_decode_step(cfg: LlamaConfig, mesh: Mesh, params=None):
    """Build a jitted tp-sharded decode step:

    ``step(params, k_cache, v_cache, token, pos) ->
    (logits [vocab], k_cache', v_cache')``

    params/caches must be device_put with ``param_shardings``/
    ``cache_shardings`` of the same mesh (pass ``params`` for quantized
    trees so the spec tree matches)."""
    tp = mesh.shape["tp"]
    local_step = functools.partial(model._decode_step_impl, cfg=cfg,
                                   reduce=_tp_reduce)
    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(param_pspecs(cfg, tp, params), cache_pspec(),
                  cache_pspec(), P(), P()),
        out_specs=(P("tp"), cache_pspec(), cache_pspec()),
        check_vma=False,
    )
    return jax.jit(step)


def make_sharded_serving_step(cfg: LlamaConfig, mesh: Mesh, params=None):
    """Tensor-parallel batched serving step — the ServingEngine's step
    (``runtime.serving.batched_layer``) with heads, FFN columns, paged KV
    pools, and the LM head sharded over ``tp``.

    Per device: local per-head projections (M=B matmuls on the weight
    shard), paged attention over the LOCAL kv-head slice of the pools,
    then the two reduction points as psums.

    ``step(params, k_pool, v_pool, tokens, positions, table, seq_lens)
    -> (logits [B, vocab], k_pool', v_pool')``.  Pools are sharded
    ``P(None, "dcn", "tp")`` (pages over hosts, kv-heads over tp).
    bf16 and int8 param trees supported (int8 dots apply scales after
    the matmul — no materialized copies; pass ``params`` so the spec tree
    matches).

    Multi-host: the batch axis (tokens, positions, block table, seq_lens)
    and the page pool are sharded over ``dcn`` — each host runs continuous
    batching on its own requests with its own page pool, weights replicated
    per host and tp-sharded inside it.  No collective crosses dcn in the
    decode hot path."""
    from clusterfusion.runtime.serving import batched_layer

    tp = mesh.shape["tp"]

    def local_step(params, k_pool, v_pool, tokens, positions, table,
                   seq_lens):
        cos_t, sin_t = model.rope_table(cfg)
        cos = cos_t[positions]
        sin = sin_t[positions]
        x = params["embed"][tokens]
        residual = jnp.zeros_like(x)

        def layer(carry, l):
            x, res, kp, vp = carry
            x, res, kp, vp = batched_layer(
                x, res, params["layers"], l, kp, vp, table, l, seq_lens,
                cos, sin, cfg, model.layer_window(cfg, l), _tp_reduce)
            return (x, res, kp, vp), None

        layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
        (x, residual, k_pool, v_pool), _ = jax.lax.scan(
            layer, (x, residual, k_pool, v_pool), layer_idx)
        xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                      cfg.norm_eps)
        logits = model._lm_logits(xn, params["lm_head"])
        return logits, k_pool, v_pool            # logits vocab-sharded

    pool_spec = P(None, "dcn", "tp")
    batch_spec = P("dcn")
    step = shard_map(
        local_step, mesh=mesh,
        in_specs=(param_pspecs(cfg, tp, params), pool_spec, pool_spec,
                  batch_spec, batch_spec, batch_spec, batch_spec),
        out_specs=(P("dcn", "tp"), pool_spec, pool_spec),
        check_vma=False,
    )
    return jax.jit(step)
