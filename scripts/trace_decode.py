"""Device time of the decode paths at real widths, and where the bs=1 decode
step spends it.

    python scripts/trace_decode.py --out traces      # on a GPU
    python scripts/trace_decode.py --tiny --out /tmp/t   # CPU rehearsal

Each step is timed warm, closed by ``block_until_ready``, and set beside its
floor: the bytes it must read over the H100 SXM's 3.35 TB/s (HBM3 peak), or
for prefill its matmul FLOPs over 989 TFLOP/s (dense bf16 peak).  Then three
bs=1 Llama-2-7B decode steps run under ``jax.profiler``: the GPU's op events
are summed by the named scope of the HLO op they ran (``attention``,
``ffn``, ``lm_head``), with the device's busy time and idle share over the
traced span.  The per-op table and the step's HLO go to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def log(*a):
    print(*a, flush=True)


def per_call(fn, n: int = 10) -> float:
    """Seconds per call of ``fn()``, warm: the best of 3 windows of ``n``."""
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def nbytes(tree) -> int:
    import jax
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


def report(name: str, t: float, floor_s: float, what: str) -> None:
    log(f"  {name}: {t * 1e3:.3f} ms; floor {floor_s * 1e3:.3f} ms ({what}),"
        f" {100 * floor_s / t:.1f}% of it")


def scopes_by_op(hlo: str) -> dict:
    """HLO instruction name, as the trace spells it (``fusion.3`` becomes
    ``fusion_3``) -> the named scope in its op_name metadata."""
    out = {}
    for m in re.finditer(r'^\s*%?([\w.\-]+) = [^\n]*?op_name="([^"]*)"', hlo,
                         re.M):
        parts = m.group(2).split("/")
        scope = next((p for p in parts
                      if p in ("attention", "ffn", "lm_head")), "other")
        out[m.group(1).replace(".", "_")] = scope
    return out


def device_ops(trace_dir: str):
    """(events [(name, start_ns, dur_ns)], line names) of the first GPU
    plane's op line, or ([], []) when the trace holds no GPU plane."""
    from jax.profiler import ProfileData
    files = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    pd = ProfileData.from_file(max(files, key=os.path.getmtime))
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        names = [ln.name for ln in lines]
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or \
            [ln for ln in lines if ln.name.startswith("Stream")]
        ev = [(e.name, e.start_ns, e.duration_ns)
              for ln in ops for e in ln.events]
        return ev, names
    return [], []


def busy_ns(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, -1.0
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s + d <= end:
            continue
        total += s + d - max(s, end)
        end = s + d
    return total


def trace_decode(params, cfg, out: str, n_steps: int = 3) -> None:
    import jax
    import jax.numpy as jnp
    from clusterfusion.models import llama as model
    kc, vc = model.init_cache(cfg)
    tok = jnp.asarray(1, jnp.int32)
    args = lambda pos: (params, kc, vc, tok, jnp.asarray(pos, jnp.int32), cfg)
    compiled = model.decode_step_donated.lower(*args(0)).compile()
    hlo = compiled.as_text()
    with open(f"{out}/decode_step.hlo.txt", "w") as f:
        f.write(hlo)
    scope = scopes_by_op(hlo)
    for i in range(3):
        lg, kc, vc = model.decode_step_donated(*args(16 + i))
    jax.block_until_ready(lg)
    jax.profiler.start_trace(f"{out}/trace")
    for i in range(n_steps):
        lg, kc, vc = model.decode_step_donated(*args(20 + i))
    jax.block_until_ready(lg)
    jax.profiler.stop_trace()
    events, lines = device_ops(f"{out}/trace")
    if not events:
        log(f"  no GPU op events in the trace (lines: {lines})")
        return
    span = max(s + d for _, s, d in events) - min(s for _, s, _ in events)
    busy = busy_ns(events)
    log(f"  traced {n_steps} bs=1 decode steps: {len(events)} device ops, "
        f"busy {busy / n_steps / 1e6:.3f} ms/step over a span of "
        f"{span / n_steps / 1e6:.3f} ms/step, idle share "
        f"{100 * (1 - busy / span):.1f}%")
    by_scope, by_op = {}, {}
    for name, _, d in events:
        key = name.split(" = ")[0].lstrip("%")
        sc = "memcpy" if key.startswith("Memcpy") else scope.get(key, "other")
        by_scope[sc] = by_scope.get(sc, 0) + d
        by_op[(sc, key)] = by_op.get((sc, key), 0) + d
    for sc, d in sorted(by_scope.items(), key=lambda x: -x[1]):
        log(f"    {sc:10s} {d / n_steps / 1e3:10.1f} us/step "
            f"({100 * d / busy:.1f}% of busy)")
    with open(f"{out}/decode_ops.txt", "w") as f:
        f.write(f"# GPU op lines: {lines}\n")
        for (sc, k), d in sorted(by_op.items(), key=lambda x: -x[1]):
            f.write(f"{d / n_steps / 1e3:10.1f} us/step  {sc:10s} {k}\n")
    top = sorted(by_op.items(), key=lambda x: -x[1])[:8]
    for (sc, k), d in top:
        log(f"      {d / n_steps / 1e3:9.1f} us/step  {sc:9s} {k[:60]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for the trace, "
                    "the per-op table and the decode step's HLO")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths, for a rehearsal off the GPU")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    from clusterfusion.config import DeepSeekConfig, LlamaConfig
    from clusterfusion.models import deepseek as dsm
    from clusterfusion.models import llama as model
    from clusterfusion.models.speculative import verify_step
    from clusterfusion.runtime.serving import _jitted_step
    from clusterfusion.ops.paged_attention import init_paged_pool
    from clusterfusion.utils.compile_cache import enable_compile_cache
    from clusterfusion.utils.profiling import card_name_and_power

    devs = jax.devices()
    if devs[0].platform != "gpu" and not args.tiny:
        log(f"needs a GPU (or --tiny); JAX platform is {devs[0].platform!r}")
        return 1
    enable_compile_cache()
    # op_name metadata is left out of the cache key by default: a cached
    # executable compiled before a named scope existed would lack it
    jax.config.update("jax_compilation_cache_include_metadata_in_key", True)
    os.makedirs(args.out, exist_ok=True)
    log(f"device: {devs[0].device_kind}; nvidia-smi: {card_name_and_power()}")
    if args.tiny:
        cfg = LlamaConfig.tiny(max_seq_len=256, n_layers=2)
        dcfg = DeepSeekConfig.tiny(max_seq_len=256)
        ctx, B, T = 160, 4, 128
    else:
        cfg = dataclasses.replace(LlamaConfig.llama2_7b(), max_seq_len=2048)
        dcfg = DeepSeekConfig(max_seq_len=4096)
        ctx, B, T = 2048, 8, 1024
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    w_bytes = nbytes(params) - nbytes(params["embed"])
    kv_row = 2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim_ * 2
    log(f"Llama-2-7B widths, {cfg.n_layers} layers: {w_bytes / 1e9:.2f} GB "
        f"of weights read per step")

    # bs=1 decode: greedy on device, one dispatch for 32 tokens
    kc, vc = model.init_cache(cfg)
    lg, kc, vc = model.prefill(params, kc, vc, jnp.arange(16, dtype=jnp.int32)
                               + 3, cfg)
    st = {"kc": kc, "vc": vc, "pos": 16}
    del kc, vc

    def loop():
        toks, st["kc"], st["vc"] = model.decode_loop(
            params, st["kc"], st["vc"], jnp.asarray(5, jnp.int32),
            jnp.asarray(16, jnp.int32), cfg, n_steps=32)
        return toks
    t = per_call(loop, n=2) / 32
    report("bs=1 decode step (decode_loop, ctx 16..48)", t,
           (w_bytes + 48 * kv_row) / HBM_BYTES_PER_S, "weights + live KV")
    log(f"    = {1 / t:.1f} tok/s; the step attends the whole "
        f"{cfg.max_seq_len}-row cache, {cfg.max_seq_len * kv_row / 1e9:.2f} "
        f"GB a step")
    del st

    # prefill of T tokens
    toks = jnp.arange(T, dtype=jnp.int32) % cfg.vocab_size

    def pre():
        kc, vc = model.init_cache(cfg)
        return model.prefill(params, kc, vc, toks, cfg)[0]
    flops = 2 * T * (w_bytes // 2) + 2 * cfg.n_layers * T * T * \
        cfg.n_heads * cfg.head_dim_
    report(f"prefill {T} tokens", per_call(pre, n=3),
           flops / BF16_FLOP_PER_S, "matmul FLOPs at the bf16 peak")

    # speculative verify of 5 tokens (the n-token step), caches donated
    verify = jax.jit(verify_step.__wrapped__, static_argnames=("cfg",),
                     donate_argnums=(1, 2))
    vst = dict(zip("kv", model.init_cache(cfg)))
    vt = jnp.arange(5, dtype=jnp.int32) + 3

    def ver():
        lg, vst["k"], vst["v"] = verify(params, vst["k"], vst["v"], vt,
                                        jnp.asarray(64, jnp.int32), cfg)
        return lg
    report("verify 5 tokens", per_call(ver),
           (w_bytes + 69 * kv_row) / HBM_BYTES_PER_S, "weights + live KV")
    del vst

    # the serving step: B requests of ctx rows in a paged pool
    page, width = 16, -(-ctx // 16)
    n_pages = B * width + 1
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page, cfg.head_dim_)
    sp = {"k": init_paged_pool(shape), "v": init_paged_pool(shape)}
    table = jnp.arange(B * width, dtype=jnp.int32).reshape(B, width) + 1
    lens = jnp.full((B,), ctx - 1, jnp.int32)
    step = _jitted_step(cfg, False)
    i32 = jnp.int32

    def serve():
        nxt, _, sp["k"], sp["v"] = step(
            params, sp["k"], sp["v"], jnp.zeros(B, i32), lens, table, lens,
            jax.random.PRNGKey(0), jnp.zeros(B), jnp.full(B, 0.9))
        return nxt
    report(f"serving step B={B}, {ctx} rows each", per_call(serve),
           (w_bytes + B * ctx * kv_row) / HBM_BYTES_PER_S,
           "weights + live KV")
    del sp

    # MLA decode at DeepSeek-V2-lite widths, full depth, dense FFN
    dparams = dsm.init_params(dcfg, jax.random.PRNGKey(1))
    dst = {"c": dsm.init_cache(dcfg)}

    def mla():
        toks, dst["c"] = dsm.decode_loop(dparams, dst["c"],
                                         jnp.asarray(5, jnp.int32),
                                         jnp.asarray(16, jnp.int32), dcfg,
                                         n_steps=8)
        return toks
    dw = nbytes(dparams) - nbytes(dparams["embed"])
    report(f"MLA decode step ({dcfg.n_layers} layers, dense FFN)",
           per_call(mla, n=2) / 8,
           (dw + 24 * dcfg.n_layers * dcfg.mla_head_dim * 2) / HBM_BYTES_PER_S,
           "bf16 weights + live ckv")
    del dparams, dst

    log("trace of the bs=1 decode step")
    trace_decode(params, cfg, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
