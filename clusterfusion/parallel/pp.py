"""Pipeline parallelism: a GPipe microbatch schedule over the mesh's
``pp`` axis.

The reference has no pipeline story at all (SURVEY.md §2.3 marks
data/pipeline/expert parallelism absent; its only cross-device mechanism is
fairscale TP over NCCL, `chat/llama/generation.py:86-89`).  Pipeline
parallelism scales the *layer* dimension past one device's memory: each of
the S = ``pp`` stages holds L/S layers (the stacked ``[L, ...]`` weight
arrays shard on their leading axis), and activations hop stage→stage with
``lax.ppermute`` — a single neighbor hop per microbatch per tick.

Design notes (why it looks like this and not like a GPU pipeline runtime):

- The whole schedule lives INSIDE one ``shard_map``/``lax.scan``: SPMD means
  every stage executes the same program, so the "schedule" is just a scan
  over M + S - 1 ticks in which stage 0 injects microbatch ``t`` and the
  last stage banks its output for microbatch ``t - (S-1)``.  No host-side
  orchestration, no per-stage streams — the compiler sees one static graph
  and overlaps the ppermute with the next tick's compute where profitable.
- Backward needs no hand-written schedule either: ``jax.grad``
  differentiates through the scan, and the transpose of ``ppermute`` is the
  reverse ppermute — the backward pass is automatically the mirrored
  pipeline (activations flow last→first), which is exactly GPipe.
- Bubble fraction is the usual (S-1)/(M+S-1); pick ``n_microbatches`` ≥ 4·S
  for real runs.  The bubble ticks still execute (SPMD), their results are
  masked out of the loss, so their gradient contribution is exactly zero.
- Composes with dp: the batch axis shards over ``dp``, each dp replica runs
  its own pipeline, and the loss is ``pmean``-ed over dp (grads follow).
  tp *inside* a stage is GSPMD's job, not this schedule's — run the pp step
  under a (pp, dp) mesh and let jit shard the within-stage matmuls if
  needed.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from clusterfusion.config import LlamaConfig


def pp_param_pspecs(cfg: LlamaConfig) -> Dict[str, Any]:
    """PartitionSpecs for pipeline sharding: the stacked per-layer arrays
    shard their leading [L] axis over "pp"; embed / final norm / LM head
    replicate (stage 0 reads the embedding, the last stage runs the head —
    the replicas on other stages contribute zero gradient through the loss
    mask, and psum-on-transpose makes the replicated-param grads exact)."""
    lp = {
        "wqkv_f": P("pp", None, None, None),
        "wo_f": P("pp", None, None, None),
        "w13": P("pp", None, None, None),
        "w2": P("pp", None, None),
        "attn_norm": P("pp", None),
        "ffn_norm": P("pp", None),
    }
    if cfg.qkv_bias:
        lp["bqkv_f"] = P("pp", None, None)
    if cfg.sandwich_norms:
        lp["post_attn_norm"] = P("pp", None)
        lp["post_ffn_norm"] = P("pp", None)
    return {"embed": P(), "layers": lp, "final_norm": P(), "lm_head": P()}


def pp_param_shardings(cfg: LlamaConfig, mesh: Mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, s),
                        pp_param_pspecs(cfg),
                        is_leaf=lambda x: isinstance(x, P))


def shard_params_pp(params, cfg: LlamaConfig, mesh: Mesh):
    return jax.tree.map(jax.device_put, params,
                        pp_param_shardings(cfg, mesh))


def pipeline_lm_loss(params, tokens, targets, cfg: LlamaConfig, mesh: Mesh,
                     n_microbatches: int) -> jnp.ndarray:
    """Mean next-token cross-entropy through the GPipe schedule.

    tokens/targets [B, T] int32; B shards over dp and splits into
    ``n_microbatches`` per dp replica.  Equals ``train.lm_loss`` bit-for-
    algebra (same layer math via ``models.llama.layer_forward``); tested
    against it in tests/test_parallel.py."""
    from clusterfusion.models import llama as model

    S = mesh.shape["pp"]
    dp = mesh.shape.get("dp", 1)
    assert cfg.n_layers % S == 0, \
        f"pp={S} must divide n_layers={cfg.n_layers}"
    M = n_microbatches
    B, T = tokens.shape
    assert (B // dp) % M == 0, \
        f"per-replica batch {B // dp} must divide into {M} microbatches"
    mb = B // dp // M

    cos_t, sin_t = model.rope_table(cfg, max_pos=max(T, cfg.max_seq_len))
    cos, sin = cos_t[:T][None], sin_t[:T][None]
    mask = jnp.tril(jnp.ones((T, T), jnp.bool_))

    def local(params, tokens, targets):
        # tokens/targets local: [B/dp, T]; layer stacks local: [L/S, ...]
        s = jax.lax.axis_index("pp")
        is_last = (s == S - 1).astype(jnp.float32)
        layers_local = params["layers"]

        h_mb = params["embed"][tokens].reshape(M, mb, T, -1)

        def stage_fwd(h):
            h, _ = jax.lax.scan(
                lambda h, p: (model.layer_forward(h, p, cos, sin, mask, cfg),
                              None),
                h, layers_local)
            return h

        perm = [(i, (i + 1) % S) for i in range(S)]

        def tick(carry, t):
            act, out = carry
            # stage 0 injects microbatch t (clamped during drain ticks —
            # those outputs never reach a bank slot); others consume the
            # activation ppermuted in at the previous tick
            inj = jax.lax.dynamic_index_in_dim(
                h_mb, jnp.clip(t, 0, M - 1), 0, keepdims=False)
            x = jnp.where(s == 0, inj, act)
            y = stage_fwd(x)
            # last stage banks microbatch m = t - (S-1) once it's real
            m = t - (S - 1)
            write = (s == S - 1) & (m >= 0)
            idx = jnp.clip(m, 0, M - 1)
            cur = jax.lax.dynamic_index_in_dim(out, idx, 0, keepdims=False)
            out = jax.lax.dynamic_update_index_in_dim(
                out, jnp.where(write, y, cur), idx, 0)
            act = jax.lax.ppermute(y, "pp", perm)
            return (act, out), None

        act0 = jnp.zeros((mb, T, cfg.hidden_dim), h_mb.dtype)
        out0 = jnp.zeros((M, mb, T, cfg.hidden_dim), h_mb.dtype)
        (_, out), _ = jax.lax.scan(tick, (act0, out0),
                                   jnp.arange(M + S - 1))

        # head + loss on the banked hiddens.  Non-last stages run this on
        # zeros; the is_last mask zeroes both their loss and (through the
        # where) their gradient contribution.
        from clusterfusion.ops.reference import rmsnorm_ref
        xn = rmsnorm_ref(out.reshape(M * mb, T, -1), params["final_norm"],
                         cfg.norm_eps)
        logits = model._lm_logits(xn, params["lm_head"])
        logp = jax.nn.log_softmax(logits, axis=-1)
        tg = targets.reshape(M * mb, T)
        nll = -jnp.take_along_axis(logp, tg[..., None], axis=-1)[..., 0]
        local_loss = jnp.mean(nll)
        loss = jax.lax.psum(jnp.where(is_last > 0, local_loss, 0.0), "pp")
        if dp > 1:
            loss = jax.lax.pmean(loss, "dp")
        return loss

    in_specs = (pp_param_pspecs(cfg), P("dp"), P("dp"))
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=P(),
                   check_vma=False)
    return fn(params, tokens, targets)


def make_pp_train_step(cfg: LlamaConfig, mesh: Mesh,
                       n_microbatches: int = 4, optimizer=None):
    """Jitted ``train_step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` with the forward+backward pipelined over the mesh's
    pp axis.  Shard params with :func:`shard_params_pp` first."""
    import optax
    from clusterfusion.train import make_optimizer
    optimizer = optimizer or make_optimizer()

    def loss_fn(params, tokens, targets):
        return pipeline_lm_loss(params, tokens, targets, cfg, mesh,
                                n_microbatches)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, tokens, targets):
        loss, grads = jax.value_and_grad(loss_fn)(params, tokens, targets)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
