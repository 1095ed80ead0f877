"""Smoke test of the compiled GPU path: one process, one card.

    python chip_smoke.py            # phases 1-3 on one GPU
    python chip_smoke.py --multi    # tensor-sharded serving + sequence-
                                    # parallel decode over 4 GPUs only

Phases, in order; any failure exits non-zero:

1. Device: the platform must be "gpu" (no CPU fallback).  Prints the card's
   name and power limit as nvidia-smi reports them.
2. Kernels at real widths: the paged-attention kernel and its XLA path at
   Llama-2-7B, Mistral-7B, Gemma-2-9B and TinyLlama widths for bf16, Int8KV
   and fp8 pools, prefill attention, and MLA decode, each compared once with
   the fp32 oracle in ``clusterfusion.ops.reference``; then the kernel and
   the XLA path timed in turns at B=8, 2K context.
3. Main path at full Llama-2-7B width with synthetic weights: served
   generation through ``Llama.generate`` (ServingEngine, native scheduler,
   paged pool) and bs=1 streaming decode, checked against each other and the
   prompt-end logits against an fp32 forward.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def check(name: str, err: float, tol: float, why: str) -> None:
    ok = err <= tol
    log(f"  {'PASS' if ok else 'FAIL'} {name}: max err {err:.3e} "
        f"(tol {tol:.1e}: {why})")
    if not ok:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.1e}")


def rel_err(a, ref) -> float:
    a = np.asarray(a, np.float32)
    ref = np.asarray(ref, np.float32)
    if not np.all(np.isfinite(a)):
        return float("inf")
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


def bench(fn, *args, n_iter: int = 20) -> float:
    """Median seconds per call over 5 windows of ``n_iter`` calls (warm)."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / n_iter)
    return float(np.median(times))


# --------------------------------------------------------------------------
# Phase 2: kernels and XLA paths at real widths
# --------------------------------------------------------------------------

# name: (kv heads, query group, head_dim, window, softcap)
PAGED_WIDTHS = {
    "llama2_7b": (32, 1, 128, 0, 0.0),
    "mistral_7b": (8, 4, 128, 4096, 0.0),
    "gemma2_9b": (8, 2, 256, 4096, 50.0),
    "tinyllama_1b": (4, 8, 64, 0, 0.0),
}
# bf16 operands (8-bit mantissa) for q·k and p·v with fp32 accumulation
PAGED_TOL = 2e-2


def paged_inputs(kv, g, hd, B, ctx, kv_dtype, seed, page=16, L=2):
    """Random q, pools holding ``B`` requests of ragged lengths up to
    ``ctx`` on shuffled pages, their block table and lengths."""
    import jax
    import jax.numpy as jnp
    from clusterfusion.ops import paged_attention as pa
    width = -(-ctx // page)
    n_pages = B * width + 1
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    shape = (L, n_pages, kv, page, hd)
    q = jax.random.normal(ks[0], (B, kv, g, hd), jnp.bfloat16)
    pools = []
    for k in ks[1:3]:
        pool = pa.init_paged_pool(shape, kv_dtype)
        pools.append(pa.pool_set_pages(
            pool, jnp.arange(n_pages),
            jax.random.normal(k, shape, jnp.bfloat16)))
    table = (jax.random.permutation(ks[3], n_pages - 1)[:B * width]
             .reshape(B, width) + 1).astype(jnp.int32)
    lens = jnp.asarray(np.linspace(ctx // 3, ctx, B).astype(np.int32))
    return q, pools[0], pools[1], table, lens


def phase_paged(seed: int, ctx: int = 2048, B: int = 8, widths=PAGED_WIDTHS,
                kv_dtypes=None, kernel_fn=None):
    """Kernel and XLA paged attention against the fp32 oracle."""
    import jax
    import jax.numpy as jnp
    from clusterfusion.ops import paged_attention as pa
    from clusterfusion.ops.reference import paged_attention_ref
    kernel_fn = kernel_fn or pa.paged_attention_kernel
    kv_dtypes = kv_dtypes or {"bf16": jnp.bfloat16, "int8kv": "int8",
                              "fp8": jnp.float8_e4m3fn}
    for name, (kv, g, hd, window, softcap) in widths.items():
        # Mistral's window bites only past 4K: give it a longer context
        c = ctx + window if window else ctx
        for dname, dt in kv_dtypes.items():
            q, kp, vp, table, lens = paged_inputs(kv, g, hd, B, c, dt, seed)
            with jax.default_matmul_precision("highest"):
                ref = paged_attention_ref(q, kp, vp, table, lens, 1,
                                          window, softcap)
            fns = {"kernel": jax.jit(functools.partial(
                       kernel_fn, window=window, softcap=softcap)),
                   "xla": jax.jit(functools.partial(
                       pa.paged_attention_xla, window=window,
                       softcap=softcap))}
            for impl, fn in fns.items():
                out = fn(q, kp, vp, table, lens, 1)
                check(f"paged {impl} {name} {dname} ctx {c}",
                      rel_err(out, ref), PAGED_TOL,
                      "bf16 q/k/p operands, fp32 accumulation")


def time_paged(seed: int, B: int = 8, ctx: int = 2048):
    """Kernel and XLA paged attention at B=8, 2K context, Llama-2-7B widths,
    timed in turns (kernel, xla, xla, kernel).  Returns seconds per call."""
    import jax
    from clusterfusion.ops import paged_attention as pa
    import jax.numpy as jnp
    kv, g, hd, _, _ = PAGED_WIDTHS["llama2_7b"]
    q, kp, vp, table, lens = paged_inputs(kv, g, hd, B, ctx, jnp.bfloat16,
                                          seed)
    fns = {"kernel": jax.jit(pa.paged_attention_kernel),
           "xla": jax.jit(pa.paged_attention_xla)}
    res = {"kernel": [], "xla": []}
    for impl in ("kernel", "xla", "xla", "kernel"):
        res[impl].append(bench(fns[impl], q, kp, vp, table, lens, 1))
    out = {k: float(np.min(v)) for k, v in res.items()}
    kv_bytes = 2 * int(np.sum(np.asarray(lens))) * kv * hd * 2
    for k, t in out.items():
        log(f"  paged attention {k}: {t * 1e6:.1f} us/call at B={B}, "
            f"ctx {ctx} (min of 2 turns), {kv_bytes / t / 1e9:.0f} GB/s "
            f"of live KV")
    return out


# prefill attention: bf16 q/k/p operands over T keys, fp32 accumulation
PREFILL_TOL = 2e-2


def phase_prefill(seed: int, T: int = 1024, kv: int = 32, g: int = 1,
                  hd: int = 128, dtype="bfloat16"):
    """Prefill attention at Llama-2-7B widths against an fp32 einsum: a
    prompt's first chunk (``prompt_attention``, cuDNN on the GPU) causal,
    windowed and at an odd length, and a later chunk (``attend``) at an
    offset."""
    import jax
    import jax.numpy as jnp
    from clusterfusion.models.llama import attend, prompt_attention
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (1, T, kv, g, hd), dtype)
    k = jax.random.normal(ks[1], (kv, T, hd), dtype)
    v = jax.random.normal(ks[2], (kv, T, hd), dtype)
    first = jax.jit(prompt_attention, static_argnames=("window",))
    odd = T * 3 // 10 + 1
    for name, q0, S, window in (("causal", 0, T, 0), ("window", 0, T, T // 4),
                                ("causal odd length", 0, odd, 0),
                                ("chunk offset", T // 2, T, 0)):
        qpos = q0 + jnp.arange(S - q0)
        kpos = jnp.arange(S)
        qq, kk, vv = q[:, q0:S], k[:, :S], v[:, :S]
        if q0:
            got = jax.jit(attend)(qq, kk, vv, qpos, kpos, window)
        else:
            got = first(qq, kk, vv, window)
        with jax.default_matmul_precision("highest"):
            f32 = jnp.float32
            s = jnp.einsum("btkgd,ksd->bkgts", qq.astype(f32),
                           kk.astype(f32)) / jnp.sqrt(f32(hd))
            mask = kpos[None] <= qpos[:, None]
            if window:
                mask &= kpos[None] > qpos[:, None] - window
            p = jax.nn.softmax(jnp.where(mask, s, -jnp.inf), axis=-1)
            ref = jnp.einsum("bkgts,ksd->btkgd", p, vv.astype(f32))
        check(f"prefill attention {name} T={S}", rel_err(got, ref),
              PREFILL_TOL, "bf16 q/k/p operands, fp32 accumulation")


# MLA decode: the layer computes in fp32; the bf16 inputs and output round
MLA_TOL = 1e-2


def phase_mla(seed: int, cfg=None, seq: int = 2048):
    """MLA decode at DeepSeek-V2-lite widths: the public layer op against
    its fp32 oracle, and a 2-layer model decode step against the same step
    in fp32."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from clusterfusion.config import DeepSeekConfig
    from clusterfusion.models import deepseek as dsm
    from clusterfusion.models.llama import upcast
    from clusterfusion.ops import deepseek_decoder_layer
    from clusterfusion.ops.reference import deepseek_decoder_layer_ref
    cfg = cfg or dataclasses.replace(DeepSeekConfig(), n_layers=2,
                                     max_seq_len=seq + 16)
    h, nope, rope, lora, hid = (cfg.n_heads, cfg.nope_head_dim,
                                cfg.rope_head_dim, cfg.kv_lora_rank,
                                cfg.hidden_dim)
    ks = jax.random.split(jax.random.PRNGKey(seed), 12)
    r = lambda k, shape, sc=0.05: (jax.random.normal(k, shape) * sc
                                   ).astype(jnp.bfloat16)
    angle = jax.random.uniform(ks[11], (rope // 2,)) * 3.0
    args = dict(
        input=r(ks[0], (1, hid), 1.0), weight_q_nope=r(ks[1], (h * nope, hid)),
        weight_q_pe=r(ks[2], (h * rope, hid)), weight_uk=r(ks[3], (h, nope, lora)),
        weight_kv_nope=r(ks[4], (lora, hid)), weight_k_pe=r(ks[5], (rope, hid)),
        weight_uv=r(ks[6], (h, lora, nope)), weight_o=r(ks[7], (hid, h * nope)),
        ckv_cache=r(ks[8], (seq, lora + rope), 1.0),
        rms_input_weight=r(ks[9], (hid,), 1.0),
        rms_ckv_weight=r(ks[10], (lora,), 1.0),
        cos=jnp.cos(angle), sin=jnp.sin(angle))
    kw = dict(n_heads=h, nope_dim=nope, rope_dim=rope, lora_rank=lora,
              eps=cfg.norm_eps)
    out, ckv = deepseek_decoder_layer(**args, **kw)
    with jax.default_matmul_precision("highest"):
        want_out, want_ckv = deepseek_decoder_layer_ref(**args, **kw)
    check(f"MLA layer op seq={seq}", rel_err(out, want_out), MLA_TOL,
          "fp32 math, bf16 inputs and output")
    check(f"MLA layer ckv_new seq={seq}", rel_err(ckv, want_ckv), MLA_TOL,
          "fp32 math, bf16 output")

    params = dsm.init_params(cfg, jax.random.PRNGKey(seed + 1))
    cache = dsm.init_cache(cfg)
    prompt = jax.random.randint(ks[0], (seq,), 0, cfg.vocab_size)
    _, cache = dsm.prefill(params, cache, prompt, cfg)
    tok, pos = jnp.asarray(7, jnp.int32), jnp.asarray(seq, jnp.int32)
    lg, _ = dsm.decode_step(params, cache, tok, pos, cfg)
    with jax.default_matmul_precision("highest"):
        want, _ = dsm.decode_step(upcast(params), upcast(cache), tok, pos,
                                  cfg)
    check(f"MLA model decode ({cfg.n_layers} layers) vs fp32 step",
          rel_err(lg, want), 3e-2, "bf16 FFN and residual stream")


# --------------------------------------------------------------------------
# Phase 3: the main path at full width
# --------------------------------------------------------------------------

# prompt-end logits after 32 bf16 layers against the fp32 forward
LOGITS_TOL = 5e-2


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: unavailable"
    gb = lambda n: f"{n / 2**30:.2f} GiB"
    return (f"arguments {gb(m.argument_size_in_bytes)}, outputs "
            f"{gb(m.output_size_in_bytes)}, aliased "
            f"{gb(m.alias_size_in_bytes)}, temporaries "
            f"{gb(m.temp_size_in_bytes)}")


def compare_greedy(eng, prompt, served, stream, n: int) -> str:
    """Check the served greedy tokens against the bs=1 stream's, step by
    step for ``n`` steps.

    Both paths compute in bf16 with the same attention operands, but their
    matmuls sum in different orders.  Where the two tokens differ, the step
    must be a tie the bf16 model cannot resolve: the fp32 forward scores
    the two tokens less than 2·d apart, where d is the bf16 model's largest
    logit deviation from that forward at this step, read here from the
    bf16 prefill of the same prefix.  (Two paths that each stay within d
    of the fp32 logits can rank two tokens differently only then.)  The
    bs=1 stream then restarts from the served token, so every later step
    is still compared."""
    import jax.numpy as jnp
    from clusterfusion.models import llama as model
    cfg = eng.cfg
    n = min(n, len(served))
    stream = list(stream)
    ties = []
    for t in range(n):
        if served[t] == stream[t]:
            continue
        seq = list(prompt) + served[:t]
        x = jnp.asarray(seq, jnp.int32)
        ref = model.reference_logits(eng.params, x, cfg)[-1]
        kc, vc = model.init_cache(cfg)
        lg = model.prefill(eng.params, kc, vc, x, cfg)[0][-1]
        del kc, vc
        dev = float(jnp.max(jnp.abs(lg - ref)))
        gap = abs(float(ref[served[t]]) - float(ref[stream[t]]))
        what = (f"step {t}: served {served[t]}, bs=1 {stream[t]}, fp32 gap "
                f"{gap:.3e} (absolute) against 2·d = {2 * dev:.3e}")
        if gap >= 2 * dev:
            raise AssertionError(f"served and bs=1 tokens part at {what}")
        ties.append(what)
        stream[t:] = [served[t]] + list(eng.stream_generate(
            seq + [served[t]], n - t - 1, temperature=0.0))
    line = f"{n - len(ties)} of {n} steps equal"
    return line + "".join(f"; a tie at {w}" for w in ties)


def phase_main(seed: int, card: str, cfg=None,
               prompt_lens=(64, 300, 700, 1024), n_gen: int = 32,
               n_check: int = 16):
    """Served generation and bs=1 streaming decode at full width."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from clusterfusion.config import LlamaConfig
    from clusterfusion.models import llama as model
    from clusterfusion.models.generation import Llama
    cfg = cfg or dataclasses.replace(LlamaConfig.llama2_7b(),
                                     max_seq_len=2048)
    t0 = time.perf_counter()
    eng = Llama.synthetic(cfg, seed=seed)
    jax.block_until_ready(eng.params)
    log(f"  synthetic weights ({sum(x.size for x in jax.tree.leaves(eng.params)) / 1e9:.2f} B"
        f" params) in {time.perf_counter() - t0:.1f}s")
    rng = np.random.RandomState(seed)
    prompts = [list(rng.randint(3, cfg.vocab_size, n)) for n in prompt_lens]

    # prompt-end logits against the fp32 forward
    pl = jnp.asarray(prompts[-1], jnp.int32)
    kc, vc = model.init_cache(cfg)
    t0 = time.perf_counter()
    lg, _, _ = model.prefill(eng.params, kc, vc, pl, cfg)
    jax.block_until_ready(lg)
    t_compile = time.perf_counter() - t0
    kc, vc = model.init_cache(cfg)
    t0 = time.perf_counter()
    lg, _, _ = model.prefill(eng.params, kc, vc, pl, cfg)
    jax.block_until_ready(lg)
    t_prefill = time.perf_counter() - t0
    log(f"  prefill {len(pl)} tokens: {t_prefill * 1e3:.1f} ms warm "
        f"({len(pl) / t_prefill:.0f} tok/s; first call with compile "
        f"{t_compile:.1f}s) [{card}]")
    del kc, vc
    ref = model.reference_logits(eng.params, pl, cfg)
    check(f"prompt-end logits vs fp32 forward, {cfg.n_layers} layers",
          rel_err(lg[-1], ref[-1]), LOGITS_TOL,
          "bf16 weights and activations through every layer")

    # the bs=1 decode step: compile time and memory
    kc, vc = model.init_cache(cfg)
    t0 = time.perf_counter()
    compiled = model.decode_step_donated.lower(
        eng.params, kc, vc, jnp.asarray(1, jnp.int32),
        jnp.asarray(0, jnp.int32), cfg).compile()
    log(f"  decode step compile {time.perf_counter() - t0:.1f}s; "
        f"{memory_line(compiled)}")
    del kc, vc, compiled

    # bs=1 streaming decode, the chat.py path
    streams = []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        it = eng.stream_generate(p, n_gen, temperature=0.0)
        toks = [next(it)]
        t1 = time.perf_counter()
        toks += list(it)
        t2 = time.perf_counter()
        streams.append(toks)
        log(f"  stream prompt {len(p)}: {len(toks)} tokens, first after "
            f"{t1 - t0:.2f}s, then {(len(toks) - 1) / max(t2 - t1, 1e-9):.1f}"
            f" tok/s{' (includes compiles)' if i == 0 else ''} [{card}]")

    # served generation through the engine, twice (the first compiles)
    for run in ("first (compiles)", "second"):
        t0 = time.perf_counter()
        served, _ = eng.generate(prompts, n_gen, temperature=0.0)
        dt = time.perf_counter() - t0
        n_tok = sum(len(s) for s in served)
        log(f"  served {len(prompts)} requests, {n_tok} tokens, {run}: "
            f"{dt:.2f}s -> {n_tok / dt:.1f} tok/s aggregate incl. prefill "
            f"[{card}]")
    for p, sv, st in zip(prompts, served, streams):
        log(f"  request prompt {len(p)}: served vs bs=1 "
            f"{compare_greedy(eng, p, sv, st, n_check)}")
    return eng, prompts


def check_serving_step(eng, prompts, card: str):
    """The compiled serving step: memory, and the kernel's custom call when
    the kernel runs on this platform."""
    import jax
    import jax.numpy as jnp
    from clusterfusion.runtime.serving import ServingEngine
    cfg = eng.cfg
    B = len(prompts)
    s = ServingEngine(eng.params, cfg, page_size=16,
                      num_pages=B * (cfg.max_seq_len // 16) + 1, max_batch=8)
    w = cfg.max_seq_len // 16
    i32 = jnp.int32
    args = (eng.params, s.k_pool, s.v_pool, jnp.zeros(8, i32),
            jnp.zeros(8, i32), jnp.zeros((8, w), i32), jnp.zeros(8, i32),
            jax.random.PRNGKey(0), jnp.zeros(8), jnp.full(8, 0.9))
    t0 = time.perf_counter()
    compiled = s._step.lower(*args).compile()
    pool = 2 * s.k_pool.size * s.k_pool.dtype.itemsize
    log(f"  serving step B=8 width {w} compile "
        f"{time.perf_counter() - t0:.1f}s; pools {pool / 2**30:.2f} GiB; "
        f"{memory_line(compiled)}")
    m = compiled.memory_analysis()
    if m is not None and pool > 2**30:
        # at real sizes a copy of the pools would dwarf every other buffer
        assert m.temp_size_in_bytes < pool / 2, "a pool-sized copy appeared"
    hlo = compiled.as_text()
    on_gpu = jax.devices()[0].platform == "gpu"
    # the paged-attention kernel is the step's only Triton custom call
    has_kernel = "triton" in hlo.lower()
    log(f"  serving step runs the paged-attention kernel: {has_kernel} "
        f"(kernel name in HLO: {'paged_attention' in hlo})")
    assert has_kernel == on_gpu
    del s, compiled


# --------------------------------------------------------------------------
# --multi: tensor-sharded serving and sequence-parallel decode, 4 devices
# --------------------------------------------------------------------------

# same bf16 math split over devices: the sums run in another order
MULTI_TOL = 3e-2


def multi_cfg(n_layers: int = 8):
    """Llama-2-13B widths (40 heads, hidden 5120, ffn 13824), depth cut."""
    import dataclasses
    from clusterfusion.config import LlamaConfig
    return dataclasses.replace(LlamaConfig.llama2_13b(), n_layers=n_layers,
                               max_seq_len=4096)


def phase_tp_serving(seed: int, cfg, n_dev: int = 4, B: int = 8,
                     ctx: int = 2048, page: int = 16):
    """make_sharded_serving_step over ``n_dev`` devices (tp) vs the
    engine's serving step on one device, same params and pools."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from clusterfusion.config import MeshConfig
    from clusterfusion.models import llama as model
    from clusterfusion.ops.paged_attention import (init_paged_pool,
                                                   pool_set_pages)
    from clusterfusion.parallel import build_mesh, shard_params
    from clusterfusion.parallel.decode import make_sharded_serving_step
    from clusterfusion.runtime.serving import _paged_decode_step
    devs = jax.devices()[:n_dev]
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    width = -(-ctx // page)
    n_pages = B * width + 1
    shape = (cfg.n_layers, n_pages, cfg.kv_heads, page, cfg.head_dim_)
    ks = jax.random.split(jax.random.PRNGKey(seed + 1), 2)
    kp = pool_set_pages(init_paged_pool(shape), jnp.arange(n_pages),
                        jax.random.normal(ks[0], shape, jnp.bfloat16))
    vp = pool_set_pages(init_paged_pool(shape), jnp.arange(n_pages),
                        jax.random.normal(ks[1], shape, jnp.bfloat16))
    table = (jnp.arange(B * width, dtype=jnp.int32).reshape(B, width) + 1)
    lens = jnp.asarray(np.linspace(ctx // 4, ctx - 1, B).astype(np.int32))
    toks = jnp.asarray(np.arange(B) * 7 + 3, jnp.int32)
    nxt1, lp1, kp1, _ = jax.jit(functools.partial(
        _paged_decode_step, cfg=cfg))(
        params, kp, vp, toks, lens, table, lens, jax.random.PRNGKey(0),
        jnp.zeros(B), jnp.full(B, 0.9))
    mesh = build_mesh(MeshConfig(tp=n_dev), devices=devs)
    pool_sh = NamedSharding(mesh, P(None, "dcn", "tp"))
    step = make_sharded_serving_step(cfg, mesh)
    lg, kps, _ = step(shard_params(params, cfg, mesh),
                      jax.device_put(kp, pool_sh), jax.device_put(vp, pool_sh),
                      toks, lens, table, lens)
    nxt = np.asarray(jnp.argmax(lg, -1))
    lp = np.asarray(jax.nn.log_softmax(lg.astype(jnp.float32), -1)
                    )[np.arange(B), nxt]
    log(f"  tp={n_dev} serving step, {cfg.n_layers} layers of hidden "
        f"{cfg.hidden_dim} / {cfg.n_heads} heads, B={B}, ctx up to {ctx}: "
        f"tokens {nxt.tolist()} vs one device {np.asarray(nxt1).tolist()}")
    assert nxt.tolist() == np.asarray(nxt1).tolist()
    check(f"tp={n_dev} serving logprob of the chosen token",
          float(np.max(np.abs(lp - np.asarray(lp1)))), MULTI_TOL,
          "bf16 partial sums reduced across devices")
    pg = table[jnp.arange(B), lens // page]
    check(f"tp={n_dev} serving appended K rows",
          rel_err(kps[:, pg, :, lens % page], kp1[:, pg, :, lens % page]),
          MULTI_TOL, "bf16 projections, sharded by head")


def phase_sp_decode(seed: int, cfg, n_dev: int = 4, prompt_len: int = 3000):
    """make_sp_sharded_decode_step with the KV cache split over ``n_dev``
    devices vs the decode step on one device, two steps."""
    import jax
    import jax.numpy as jnp
    from clusterfusion.config import MeshConfig
    from clusterfusion.models import llama as model
    from clusterfusion.parallel import (build_mesh, cache_shardings_2d,
                                        make_sp_sharded_decode_step,
                                        shard_params)
    devs = jax.devices()[:n_dev]
    params = model.init_params(cfg, jax.random.PRNGKey(seed))
    prompt = jax.random.randint(jax.random.PRNGKey(seed + 2), (prompt_len,),
                                3, cfg.vocab_size)
    kc, vc = model.init_cache(cfg)
    _, kc, vc = model.prefill(params, kc, vc, prompt, cfg)
    mesh = build_mesh(MeshConfig(sp=n_dev), devices=devs)
    step = make_sp_sharded_decode_step(cfg, mesh)
    sparams = shard_params(params, cfg, mesh)
    kcs = jax.device_put(kc, cache_shardings_2d(mesh))
    vcs = jax.device_put(vc, cache_shardings_2d(mesh))
    for i, t in enumerate((7, 11)):
        tok = jnp.asarray(t, jnp.int32)
        pos = jnp.asarray(prompt_len + i, jnp.int32)
        ref, kc, vc = model.decode_step(params, kc, vc, tok, pos, cfg)
        lg, kcs, vcs = step(sparams, kcs, vcs, tok, pos)
        check(f"sp={n_dev} decode step {i}, KV {prompt_len + i} rows over "
              f"{n_dev} devices", rel_err(lg, ref), MULTI_TOL,
              "softmax partials merged across devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU tensor-sharded serving and "
                         "sequence-parallel decode checks")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        log(f"no GPU: JAX platform is {platform!r}")
        print(json.dumps({"ok": False, "device": {
            "platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}}))
        return 1
    from clusterfusion.utils.compile_cache import enable_compile_cache
    from clusterfusion.utils.profiling import card_name_and_power
    log(f"compile cache: {enable_compile_cache()}")
    card = card_name_and_power()
    log(f"device: {devs[0].device_kind} x{len(devs)}; nvidia-smi: {card}")

    t_start = time.perf_counter()
    if args.multi:
        if len(devs) < 4:
            raise SystemExit(f"--multi needs 4 GPUs, found {len(devs)}")
        cfg = multi_cfg()
        log("multi: tensor-sharded serving step over 4 GPUs")
        phase_tp_serving(args.seed, cfg)
        log("multi: sequence-parallel decode over 4 GPUs")
        phase_sp_decode(args.seed, cfg)
    else:
        log("phase 2: kernels and XLA paths at real widths")
        phase_paged(args.seed)
        times = time_paged(args.seed)
        log(f"  faster at B=8, 2K: "
            f"{min(times, key=times.get)} [{card}]")
        phase_prefill(args.seed)
        phase_mla(args.seed)
        log("phase 3: Llama-2-7B at full width, synthetic weights")
        eng, prompts = phase_main(args.seed, card)
        check_serving_step(eng, prompts, card)
    log(f"all phases passed in {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
