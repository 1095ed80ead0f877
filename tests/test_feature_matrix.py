"""Combined-feature matrix: GQA x weight quantization x KV-cache dtype,
all through the decode path vs the fp32 oracle.
Single-feature tests live in their own files; this catches interactions
(e.g. grouped-head layouts under int4 packing, fp8 casts in GQA dots).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import quantize_llama_params

# GQA geometry: 8 query heads, 2 KV heads (group=4)
GQA = LlamaConfig.tiny(n_heads=8, n_kv_heads=2, hidden_dim=1024,
                       max_seq_len=64)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("kv_dtype", [jnp.bfloat16, jnp.float8_e4m3fn])
def test_gqa_quant_kv_matrix(quant, kv_dtype):
    params = model.init_params(GQA, jax.random.PRNGKey(0))
    if quant:
        params = quantize_llama_params(params, quant, 128)
    kc, vc = model.init_cache(GQA, dtype=kv_dtype)
    tok = jnp.asarray(7, jnp.int32)
    for step in range(3):
        pos = jnp.asarray(step, jnp.int32)
        lf, kc, vc = model.decode_step(params, kc, vc, tok, pos, GQA)
    a = np.asarray(lf, np.float32)
    b = np.asarray(model.reference_logits(params, jnp.full((3,), 7), GQA)[-1])
    assert np.all(np.isfinite(a))
    scale = max(float(np.max(np.abs(b))), 1.0)
    # bf16 activations; fp8 KV adds e4m3 rounding (3 mantissa bits)
    tol = 0.05 if kv_dtype == jnp.bfloat16 else 0.15
    assert np.max(np.abs(a - b)) < tol * scale, (quant, kv_dtype)
    # exactly the 3 decoded positions were written, every one of them
    kf = np.asarray(kc, np.float32)
    assert not np.any(kf[:, :, 3:])
    assert np.all(np.any(kf[:, :, :3] != 0.0, axis=-1))
