"""Perplexity-parity regression (north-star: Δppl ≤ 0.1 at every
quantized operating point vs bf16).  Small version of bench_ppl.py — a
byte-level model overfit on the repo's docs, scored teacher-forced through
the n-row verify step."""

import jax.numpy as jnp
import pytest

from bench_ppl import corpus_tokens, score_ppl, train_model
from clusterfusion.config import LlamaConfig
from clusterfusion.ops.quant import quantize_llama_params

TOKENS = 512
WINDOW = 256


@pytest.fixture(scope="module")
def trained():
    cfg = LlamaConfig.tiny(max_seq_len=WINDOW + 16)
    toks = corpus_tokens(TOKENS)
    params = train_model(cfg, toks, steps=150, seq=WINDOW)
    base = score_ppl(params, cfg, toks, window=WINDOW, block=16)
    assert base < 4.0, f"undertrained: bf16 ppl {base}"
    return cfg, toks, params, base


@pytest.mark.parametrize("point", ["int8", "int4", "int8+int8kv"])
def test_quantized_ppl_within_north_star_delta(trained, point):
    cfg, toks, params, base = trained
    kvd = jnp.bfloat16
    if point == "int8":
        p = quantize_llama_params(params, "int8")
    elif point == "int4":
        p = quantize_llama_params(params, "int4", 128)
    else:
        p = quantize_llama_params(params, "int8")
        kvd = "int8"
    ppl = score_ppl(p, cfg, toks, kv_dtype=kvd, window=WINDOW, block=16)
    assert abs(ppl - base) <= 0.1, (point, ppl, base)
