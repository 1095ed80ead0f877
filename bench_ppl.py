"""Perplexity-parity harness: quantized decode vs the bf16 path.

North-star acceptance (BASELINE.md): INT8 / INT4 weight quantization and
8-bit KV caches must match the full-precision model's perplexity within
Δ = 0.1.  The reference's analogous evidence is its 10k-run numeric error
sweep vs flashinfer (`tests/test_llama.py:186-215`); here the claim is made
on *language-model loss*, end to end, through the production decode path:

1. train a byte-level Llama on a real-text corpus (this repo's own docs —
   no network, fully hermetic) with ``train.make_train_step`` until it has
   non-trivial structure;
2. score the corpus teacher-forced through the n-row decode step
   (``models.speculative.verify_step`` — the same weight path, dequant
   path, and KV-cache path production decode uses, block by block so every
   KV row is written by the decode path itself);
3. report ppl per operating point (bf16 / int8 / int4 / fp8-KV / int8-KV)
   and the delta vs bf16.

Usage:
    python bench_ppl.py                # tiny model, ~2 min on a CPU
    python bench_ppl.py --scale small  # 4-layer/512-hidden, longer train
    python bench_ppl.py --steps 800 --tokens 4096

Prints one JSON line per operating point:
    {"config": "int8", "ppl": 2.31, "delta_vs_bf16": 0.004}
"""

from __future__ import annotations

import argparse
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models.speculative import verify_step
from clusterfusion.models.tokenizer import load_tokenizer
from clusterfusion.train import make_optimizer, make_train_step

_DOCS = ("README.md", "SURVEY.md", "BASELINE.md")


def corpus_tokens(n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic real-text byte corpus from the repo's own docs."""
    root = pathlib.Path(__file__).parent
    text = "\n".join((root / f).read_text(errors="ignore")
                     for f in _DOCS if (root / f).exists())
    tok = load_tokenizer("bytes")
    ids = tok.encode(text, bos=True, eos=False)
    assert len(ids) >= n_tokens, (len(ids), n_tokens)
    return np.asarray(ids[:n_tokens], np.int32)


def train_model(cfg: LlamaConfig, toks: np.ndarray, steps: int,
                seq: int = 128, batch: int = 8, seed: int = 0,
                verbose: bool = False):
    """Overfit ``cfg`` on the corpus (next-byte LM)."""
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    opt = make_optimizer()
    step = make_train_step(cfg, opt)
    opt_state = opt.init(params)
    rng = np.random.RandomState(seed)
    n = len(toks) - seq - 1
    for i in range(steps):
        starts = rng.randint(0, n, size=batch)
        batch_toks = np.stack([toks[s:s + seq] for s in starts])
        targets = np.stack([toks[s + 1:s + seq + 1] for s in starts])
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(batch_toks),
                                       jnp.asarray(targets))
        if verbose and i % 100 == 0:
            print(f"  step {i}: loss {float(loss):.4f}", flush=True)
    return params


def score_ppl(params, cfg: LlamaConfig, toks: np.ndarray,
              kv_dtype=jnp.bfloat16, block: int = 8,
              window: int = 256) -> float:
    """Teacher-forced perplexity through the n-row decode step.

    Every scored block runs the production decode math: dequantized
    matmuls, RoPE, softmax over the (possibly quantized) KV cache, KV
    append — so quantization error in *cache contents* compounds across
    the context exactly as it would serving.

    The corpus is scored in independent ``window``-token segments (fresh
    cache, positions 0..window-1) so evaluation positions match the
    training distribution — scoring one long stream would rate the model
    on RoPE positions it never trained at."""
    toks_j = jnp.asarray(toks)
    assert window % block == 0
    total, count = 0.0, 0
    for w0 in range(0, len(toks) - window + 1, window):
        kc, vc = model.init_cache(cfg, max_seq=window + 16, dtype=kv_dtype)
        for pos in range(0, window, block):
            lg, kc, vc = verify_step(
                params, kc, vc,
                jax.lax.dynamic_slice(toks_j, (w0 + pos,), (block,)),
                jnp.asarray(pos, jnp.int32), cfg)
            lw = jax.nn.log_softmax(lg.astype(jnp.float32), axis=-1)
            n_tgt = block if pos + block < window else block - 1
            tgt = jax.lax.dynamic_slice(toks_j, (w0 + pos + 1,), (block,))
            lp = jnp.take_along_axis(lw, tgt[:, None], axis=-1)[:n_tgt, 0]
            total += float(jnp.sum(lp))
            count += n_tgt
    return float(np.exp(-total / count))


def operating_points(params, gs: int = 128):
    """(name, params, kv_dtype) per quantized operating point."""
    from clusterfusion.ops.quant import quantize_llama_params
    p8 = quantize_llama_params(params, "int8")
    p4 = quantize_llama_params(params, "int4", gs)
    p4f = quantize_llama_params(params, "int4", 32)
    return [
        ("bf16", params, jnp.bfloat16),
        ("int8", p8, jnp.bfloat16),
        ("int4", p4, jnp.bfloat16),
        ("int4_g32", p4f, jnp.bfloat16),
        ("int8+fp8kv", p8, jnp.float8_e4m3fn),
        ("int8+int8kv", p8, "int8"),
        ("int4+int8kv", p4, "int8"),
        # int4 weights, int8 KV, int8 LM head
        ("int4+int8kv+lm8",
         quantize_llama_params(params, "int4", gs, lm_head=True), "int8"),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=["tiny", "small"], default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    if args.scale == "tiny":
        cfg = LlamaConfig.tiny(max_seq_len=args.window + 16)
        steps = args.steps or 300
    else:
        cfg = LlamaConfig(hidden_dim=512, n_heads=8, n_kv_heads=4,
                          ffn_dim=1536, n_layers=4, vocab_size=384,
                          max_seq_len=args.window + 16)
        steps = args.steps or 800

    toks = corpus_tokens(args.tokens)
    if args.verbose:
        print(f"training {args.scale} model ({steps} steps) on "
              f"{len(toks)} doc bytes...", flush=True)
    # train at the same window length scoring uses: eval must not rate the
    # model at RoPE positions it never saw
    params = train_model(cfg, toks, steps, seq=args.window,
                         verbose=args.verbose)

    base = None
    for name, p, kvd in operating_points(params):
        ppl = score_ppl(p, cfg, toks, kv_dtype=kvd,
                        block=args.block, window=args.window)
        if base is None:
            base = ppl
        print(json.dumps({"config": name, "ppl": round(ppl, 4),
                          "delta_vs_bf16": round(ppl - base, 4)}),
              flush=True)


if __name__ == "__main__":
    main()
