"""Benchmark harness: end-to-end decode tokens/s on one GPU at Llama-2-7B
geometry, bs=1 (the `chat/chat.py` workload), plus prefill, quantized and
long-context points, DeepSeek-V2-lite and other model families.

Streaming protocol: a CUMULATIVE summary JSON line — the full
`{"metric": ..., "value": N, "unit": ..., ...extras}` record with nulls for
not-yet-measured points — is printed (flushed) after EVERY measured point,
so a wall-clock kill at any moment still leaves the latest complete record
as the last JSON line of output.  The long tail is gated on a wall-clock
budget (env BENCH_BUDGET_S, default 2400 s) and skipped, with a printed
note, when the budget would be exceeded.

Timing: the decode loop runs entirely on device (``model.decode_loop``, one
dispatch for n tokens) and is closed with ``block_until_ready``; compilation
is excluded by a warm-up run of the same shape.  Every record names the
device as JAX reports it and the card's name and power limit as nvidia-smi
reports them.  Without a GPU the harness refuses to run.

Env knobs: BENCH_LAYERS (default 32), BENCH_GEN (default 256 tokens),
BENCH_SMALL=1 → tiny geometry smoke run, BENCH_BUDGET_S → wall-clock budget.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def _decode_tokens_per_s(run_decode, n: int) -> float:
    """Tokens/s of ``run_decode(n)`` (which must end in block_until_ready):
    one warm-up run for compilation, then the faster of two timed runs."""
    run_decode(n)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        run_decode(n)
        best = min(best, time.perf_counter() - t0)
    return n / best


def _steps_that_fit(cap: int, prompt_len: int, n_gen: int) -> int:
    """Tokens per timed run such that three runs stay inside the cache."""
    return max(8, min(n_gen, (cap - prompt_len) // 3))


def _time_decode(params, cfg, n_gen: int, kv_dtype=jnp.bfloat16,
                 prompt_len: int = 16) -> float:
    """Tokens/s of an on-device greedy decode after a ``prompt_len`` prompt
    (chunked prefill for long prompts).  The caches returned by each run
    feed the next, since the decode loop donates them."""
    from clusterfusion.models import llama as model

    n = _steps_that_fit(cfg.max_seq_len, prompt_len, n_gen)
    k_cache, v_cache = model.init_cache(cfg, dtype=kv_dtype)
    prompt = (jnp.arange(prompt_len, dtype=jnp.int32) % 97) + 1
    chunk = min(prompt_len, 512)
    for p0 in range(0, prompt_len - prompt_len % chunk, chunk):
        logits, k_cache, v_cache = model.prefill_chunk(
            params, k_cache, v_cache, prompt[p0:p0 + chunk], cfg, pos0=p0)
    state = {"tok": jnp.argmax(logits[-1]).astype(jnp.int32),
             "pos": prompt_len - prompt_len % chunk,
             "kc": k_cache, "vc": v_cache}

    def run(n):
        toks, kc, vc = model.decode_loop(
            params, state["kc"], state["vc"], state["tok"],
            jnp.asarray(state["pos"], jnp.int32), cfg, n_steps=n)
        jax.block_until_ready(toks)
        state.update(tok=toks[-1], pos=state["pos"] + n, kc=kc, vc=vc)

    return _decode_tokens_per_s(run, n)


def _time_prefill(params, cfg) -> float:
    """Prompt tokens/s of a 1,024-token prefill (time to first token is
    prompt_len / this)."""
    from clusterfusion.models import llama as model

    T = min(cfg.max_seq_len, 1024)
    toks = jnp.arange(T, dtype=jnp.int32) % cfg.vocab_size

    def run():
        kc, vc = model.init_cache(cfg)
        t0 = time.perf_counter()
        lg, kc, vc = model.prefill(params, kc, vc, toks, cfg)
        jax.block_until_ready(lg)
        return time.perf_counter() - t0

    run()                                       # compile
    return T / min(run() for _ in range(3))


def _time_deepseek(n_gen: int, small: bool, quant: str | None = None,
                   kv_dtype=jnp.bfloat16) -> float:
    """Decode tokens/s at DeepSeek-V2-lite MLA geometry (dense FFN).
    ``quant`` = int8/int4 weight-only; ``kv_dtype`` fp8 = 8-bit
    compressed-ckv cache."""
    from clusterfusion.config import DeepSeekConfig
    from clusterfusion.models import deepseek as dsm
    from clusterfusion.ops.quant import quantize_deepseek_params

    cfg = (DeepSeekConfig.tiny() if small
           else DeepSeekConfig(max_seq_len=4096))
    params = dsm.init_params(cfg, jax.random.PRNGKey(3))
    if quant:
        params = quantize_deepseek_params(params, quant)
    cache = dsm.init_cache(cfg, dtype=kv_dtype)
    prompt = jnp.arange(16, dtype=jnp.int32) % 100
    lg, cache = dsm.prefill(params, cache, prompt, cfg)
    state = {"tok": jnp.argmax(lg[-1]).astype(jnp.int32), "pos": 16,
             "cache": cache}

    def run(n):
        toks, c2 = dsm.decode_loop(params, state["cache"], state["tok"],
                                   jnp.asarray(state["pos"], jnp.int32),
                                   cfg, n_steps=n)
        jax.block_until_ready(toks)
        state.update(tok=toks[-1], pos=state["pos"] + n, cache=c2)

    return _decode_tokens_per_s(run,
                                _steps_that_fit(cfg.max_seq_len, 16, n_gen))


class _Stream:
    """Streaming result emitter + wall-clock budget.

    Every ``put`` re-prints the FULL cumulative summary record as a flushed
    one-line JSON, so the last JSON line of output is always the complete
    picture of everything measured so far.  ``gate`` implements the
    BENCH_BUDGET_S wall-clock budget for optional points.
    """

    KEYS = [
        "bf16_tokens_per_s", "prefill_tokens_per_s",
        "int8_tokens_per_s", "int4_tokens_per_s",
        "int8_int8kv_tokens_per_s", "int8_fp8kv_tokens_per_s",
        "int4_int8kv_tokens_per_s", "int4_fp8kv_tokens_per_s",
        "int4_int8kv_8kctx_tokens_per_s",
        "int4_int8kv_8kctx_win4k_tokens_per_s",
        "deepseek_v2lite_tokens_per_s",
        "deepseek_v2lite_int4_fp8ckv_tokens_per_s",
        "llama3_8b_int4_int8kv_tokens_per_s",
        "tinyllama_1b_int4_int8kv_tokens_per_s",
        "qwen2_7b_int4_int8kv_tokens_per_s",
        "gemma2_9b_int4_int8kv_4kctx_tokens_per_s",
    ]

    def __init__(self, cfg, device, card):
        self.cfg = cfg
        self.device = device
        self.card = card
        self.t0 = time.monotonic()
        self.budget = float(os.getenv("BENCH_BUDGET_S", "2400"))
        self.r = {}

    def elapsed(self):
        return time.monotonic() - self.t0

    def note(self, msg):
        print(f"# [t={self.elapsed():.0f}s] {msg}", flush=True)

    def gate(self, name, cost_s):
        left = self.budget - self.elapsed()
        if left < cost_s:
            self.note(f"skip {name}: est {cost_s:.0f}s > {left:.0f}s "
                      f"budget left")
            return False
        return True

    def run(self, key, fn, cost_s=None):
        """Measure one point: budget-gate (if cost_s given), catch + note
        failures, record + re-emit the summary."""
        if cost_s is not None and not self.gate(key, cost_s):
            return
        t_in = self.elapsed()
        try:
            v = fn()
        except Exception as e:  # pragma: no cover - bench resilience
            self.note(f"{key} FAILED: {e!r}")
            return
        self.note(f"{key} = {v:.3f} ({self.elapsed() - t_in:.0f}s)")
        self.r[key] = v
        self.emit()

    def emit(self):
        cfg = self.cfg
        out = {
            "metric": "decode_tokens_per_s",
            "value": self.r.get("bf16_tokens_per_s"),
            "unit": "tokens/s",
            "config": (f"hidden={cfg.hidden_dim} heads={cfg.n_heads} "
                       f"L={cfg.n_layers} bs=1 ctx={cfg.max_seq_len} bf16"),
        }
        for k in self.KEYS:
            out[k] = self.r.get(k)
        out["elapsed_s"] = round(self.elapsed(), 1)
        out["device"] = self.device
        out["card"] = self.card
        print(json.dumps(out), flush=True)


def main() -> int:
    from clusterfusion.config import LlamaConfig
    from clusterfusion.models import llama as model
    from clusterfusion.ops.quant import quantize_llama_params
    from clusterfusion.utils.compile_cache import enable_compile_cache
    from clusterfusion.utils.profiling import card_name_and_power

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX platform is {devs[0].platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    card = card_name_and_power()

    small = os.getenv("BENCH_SMALL", "0") == "1"
    n_layers = int(os.getenv("BENCH_LAYERS", "4" if small else "32"))
    n_gen = int(os.getenv("BENCH_GEN", "64" if small else "256"))
    if small:
        cfg = LlamaConfig.tiny(max_seq_len=256)
    else:
        cfg = dataclasses.replace(LlamaConfig.llama2_7b(), n_layers=n_layers,
                                  max_seq_len=1024)
    S = _Stream(cfg, device, card)
    S.note(f"device {device} card {card!r} budget={S.budget:.0f}s "
           f"small={small} L={n_layers} gen={n_gen}")

    def quantized(c, kind):
        return quantize_llama_params(
            model.init_params(c, jax.random.PRNGKey(0)), kind)

    def run_all():
        params = model.init_params(cfg, jax.random.PRNGKey(0))
        S.run("bf16_tokens_per_s", lambda: _time_decode(params, cfg, n_gen))
        S.run("prefill_tokens_per_s", lambda: _time_prefill(params, cfg),
              cost_s=90)
        del params

        for kind in ("int8", "int4"):
            qp = quantized(cfg, kind)
            S.run(f"{kind}_tokens_per_s",
                  lambda: _time_decode(qp, cfg, n_gen))
            S.run(f"{kind}_int8kv_tokens_per_s",
                  lambda: _time_decode(qp, cfg, n_gen, kv_dtype="int8"),
                  cost_s=60)
            S.run(f"{kind}_fp8kv_tokens_per_s",
                  lambda: _time_decode(qp, cfg, n_gen,
                                       kv_dtype=jnp.float8_e4m3fn),
                  cost_s=60)
            if kind == "int4" and not small:
                cfg8k = dataclasses.replace(cfg, max_seq_len=8192)
                pl8 = 8192 - 3 * n_gen - 64
                S.run("int4_int8kv_8kctx_tokens_per_s",
                      lambda: _time_decode(qp, cfg8k, n_gen, kv_dtype="int8",
                                           prompt_len=pl8), cost_s=240)
                cfg8kw = dataclasses.replace(cfg8k, sliding_window=4096)
                S.run("int4_int8kv_8kctx_win4k_tokens_per_s",
                      lambda: _time_decode(qp, cfg8kw, n_gen,
                                           kv_dtype="int8", prompt_len=pl8),
                      cost_s=200)
            del qp

        S.run("deepseek_v2lite_tokens_per_s",
              lambda: _time_deepseek(n_gen, small), cost_s=240)
        S.run("deepseek_v2lite_int4_fp8ckv_tokens_per_s",
              lambda: _time_deepseek(n_gen, small, quant="int4",
                                     kv_dtype=jnp.float8_e4m3fn), cost_s=240)

        if not small:
            def fam(preset, max_seq=1024, prompt_len=16):
                cfgf = dataclasses.replace(preset, max_seq_len=max_seq)
                return _time_decode(quantized(cfgf, "int4"), cfgf, n_gen,
                                    kv_dtype="int8", prompt_len=prompt_len)

            S.run("llama3_8b_int4_int8kv_tokens_per_s",
                  lambda: fam(LlamaConfig.llama3_8b()), cost_s=300)
            S.run("tinyllama_1b_int4_int8kv_tokens_per_s",
                  lambda: fam(LlamaConfig.tinyllama_1b()), cost_s=200)
            S.run("qwen2_7b_int4_int8kv_tokens_per_s",
                  lambda: fam(LlamaConfig.qwen2_7b()), cost_s=300)
            S.run("gemma2_9b_int4_int8kv_4kctx_tokens_per_s",
                  lambda: fam(LlamaConfig.gemma2_9b(), max_seq=4096,
                              prompt_len=2048), cost_s=360)

    try:
        run_all()
    except BaseException as e:
        # the streamed summary lines are the record: emit the final one
        # even when a point escapes (e.g. device memory exhausted)
        S.note(f"bench aborted early: {e!r}")
    S.note("bench complete")
    S.emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
