"""Training step — causal-LM loss + optax over the sharded functional model.

The reference is inference-only; a training step exists here because the
framework's model/parallel layers are designed to serve both directions:
the differentiable forward (``models.llama.forward``) is sharded dp/tp/sp
via GSPMD, and the trained params drive the decode and serving paths
unchanged."""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model


def lm_loss(params, tokens: jnp.ndarray, targets: jnp.ndarray,
            cfg: LlamaConfig) -> jnp.ndarray:
    """Mean next-token cross-entropy.  tokens/targets: [B, T] int32."""
    logits = model.forward(params, tokens, cfg)           # [B, T, V] fp32
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)


def make_optimizer(lr: float = 3e-4) -> optax.GradientTransformation:
    return optax.adamw(lr, weight_decay=0.01)


def make_train_step(cfg: LlamaConfig, optimizer=None):
    """Returns jittable ``train_step(params, opt_state, tokens, targets) ->
    (params, opt_state, loss)``.  Shard params/batch beforehand (see
    ``parallel.sharding``); GSPMD propagates dp/tp/sp and inserts the
    collectives."""
    optimizer = optimizer or make_optimizer()

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, tokens, targets):
        loss, grads = jax.value_and_grad(lm_loss)(params, tokens, targets, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
