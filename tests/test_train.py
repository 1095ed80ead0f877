"""Training step: loss decreases on a tiny overfit task, the trained model
decodes through the decode path, and the step is dp-shardable.
(The reference is inference-only — SURVEY.md §2; training exists because
the functional model serves both directions.)
"""

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.train import lm_loss, make_optimizer, make_train_step

CFG = LlamaConfig.tiny(n_layers=2, max_seq_len=32)


def test_loss_decreases_and_fused_decode_consumes_trained_params():
    params = model.init_params(CFG, jax.random.PRNGKey(0))
    opt = make_optimizer(lr=1e-2)
    step = make_train_step(CFG, opt)
    opt_state = opt.init(params)

    # overfit one repeated sequence
    seq = (jnp.arange(17, dtype=jnp.int32) * 5 + 2) % CFG.vocab_size
    tokens = jnp.tile(seq[None, :-1], (4, 1))
    targets = jnp.tile(seq[None, 1:], (4, 1))

    l0 = float(lm_loss(params, tokens, targets, CFG))
    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    assert losses[-1] < l0 * 0.7, (l0, losses)
    assert np.isfinite(losses).all()

    # the trained params drive the decode path directly
    kc, vc = model.init_cache(CFG)
    logits, kc, vc = model.prefill(params, kc, vc, seq[:8], CFG)
    lg, kc, vc = model.decode_step(params, kc, vc, seq[8],
                                   jnp.asarray(8, jnp.int32), CFG)
    assert np.isfinite(np.asarray(lg)).all()


def test_grads_cover_all_params():
    params = model.init_params(CFG, jax.random.PRNGKey(1))
    tokens = jnp.ones((2, 8), jnp.int32)
    targets = jnp.ones((2, 8), jnp.int32)
    grads = jax.grad(lm_loss)(params, tokens, targets, CFG)
    flat, _ = jax.tree.flatten(
        jax.tree.map(lambda g: float(jnp.max(jnp.abs(g))), grads))
    # every leaf receives gradient signal
    assert all(np.isfinite(v) for v in flat)
    assert sum(v > 0 for v in flat) == len(flat), flat
