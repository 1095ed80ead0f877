"""Native runtime tests: C++ page allocator/scheduler unit tests, and the
continuous-batching serving engine end-to-end against the single-sequence
engine (same params ⇒ same greedy tokens) — the correctness property that
makes continuous batching trustworthy, which the reference leaves to its
external runner (SGLang) entirely untested in-repo (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.runtime.native import PagedKVScheduler


# --------------------------------------------------------------------------
# allocator / scheduler (pure host, no device)
# --------------------------------------------------------------------------


def test_pool_reserves_null_page():
    s = PagedKVScheduler(num_pages=8, page_size=4, max_pages_per_req=4)
    assert s.free_pages == 7
    seen = set()
    for i in range(7):
        s.add(i, prompt_len=2)          # 1 page each (2+1 fits a page of 4)
    ids, table, lens, poss, fresh = s.prepare_batch(max_batch=8)
    assert len(ids) == 7 and fresh.all()
    for b in range(7):
        seen.add(int(table[b, 0]))
    assert 0 not in seen and len(seen) == 7
    assert s.free_pages == 0


def test_admission_fcfs_and_release():
    s = PagedKVScheduler(num_pages=5, page_size=4, max_pages_per_req=4)
    s.add(1, prompt_len=10)             # needs 3 pages
    s.add(2, prompt_len=2)              # needs 1 page
    ids, *_ = s.prepare_batch(4)
    assert list(ids) == [1, 2]
    s.add(3, prompt_len=10)             # 3 pages > 0 free → queued
    ids, *_ = s.prepare_batch(4)
    assert list(ids) == [1, 2]
    s.release(1)
    ids, table, lens, _, fresh = s.prepare_batch(4)
    assert list(ids) == [2, 3] and list(fresh) == [False, True]
    assert s.request_len(1) == -1


def test_growth_across_page_boundary():
    s = PagedKVScheduler(num_pages=8, page_size=4, max_pages_per_req=4)
    s.add(7, prompt_len=3)              # 3+1 fills page exactly → 1 page
    ids, table, lens, poss, _ = s.prepare_batch(2)
    assert s.free_pages == 6
    s.commit_batch()                    # len 4: next prepare needs page 2
    ids, table, lens, poss, _ = s.prepare_batch(2)
    assert lens[0] == 4 and poss[0] == 4
    assert s.free_pages == 5
    assert len(s.request_pages(7)) == 2


def test_preemption_requeues_newest():
    s = PagedKVScheduler(num_pages=4, page_size=2, max_pages_per_req=3)
    s.add(1, prompt_len=1)              # 1 page
    s.add(2, prompt_len=1)              # 1 page
    ids, *_ = s.prepare_batch(4)
    assert list(ids) == [1, 2]
    # drain the pool: grow both requests until one must be preempted
    for _ in range(4):
        s.commit_batch()
        ids, table, lens, poss, fresh = s.prepare_batch(4)
        assert len(ids) >= 1
        assert list(ids)[0] == 1        # oldest survives
        if len(ids) == 1:
            break
    else:
        pytest.fail("expected preemption")
    # request 2 was preempted (pages freed) and waits in the queue
    assert s.request_len(2) >= 1
    s.release(1)
    ids, table, lens, poss, fresh = s.prepare_batch(4)
    assert list(ids) == [2] and fresh[0]   # re-admitted, needs re-prefill


def test_discard_batch_keeps_lengths():
    s = PagedKVScheduler(num_pages=8, page_size=4, max_pages_per_req=4)
    s.add(1, prompt_len=5)
    s.prepare_batch(2)
    s.discard_batch()
    assert s.request_len(1) == 5
    s.prepare_batch(2)
    s.commit_batch()
    assert s.request_len(1) == 6


# --------------------------------------------------------------------------
# serving engine end-to-end
# --------------------------------------------------------------------------


CFG = LlamaConfig.tiny(max_seq_len=64)


def _reference_greedy(params, prompt, n_gen, kv_dtype=jnp.bfloat16):
    """Single-sequence decode (the already-tested path) as oracle."""
    kc, vc = model.init_cache(CFG, dtype=kv_dtype)
    logits, kc, vc = model.prefill(params, kc, vc,
                                   jnp.asarray(prompt, jnp.int32), CFG)
    toks = [int(jnp.argmax(logits[len(prompt) - 1]))]
    pos = len(prompt)
    for _ in range(n_gen - 1):
        lg, kc, vc = model.decode_step(params, kc, vc,
                                       jnp.asarray(toks[-1], jnp.int32),
                                       jnp.asarray(pos, jnp.int32), CFG)
        toks.append(int(jnp.argmax(lg)))
        pos += 1
    return toks


def test_serving_engine_matches_single_seq():
    """3 requests with different prompts/lengths decoded together must equal
    per-request single-sequence greedy decode.  Weights and KV are fp32, so
    the two paths differ only in summation order and a near-tie of the
    random weights' logits cannot flip a greedy choice."""
    params = model.upcast(model.init_params(CFG, jax.random.PRNGKey(0)))
    from clusterfusion.runtime.serving import ServingEngine

    prompts = {0: [1, 2, 3], 1: [4, 5, 6, 7, 8, 9, 10], 2: [11, 12]}
    n_gen = 5
    eng = ServingEngine(params, CFG, page_size=8, num_pages=64, max_batch=4,
                        kv_dtype=jnp.float32)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=n_gen, temperature=0.0)
    out = eng.run()
    assert set(out) == set(prompts)
    for rid, p in prompts.items():
        want = _reference_greedy(params, p, n_gen, jnp.float32)
        assert out[rid] == want, (rid, out[rid], want)


def test_serving_engine_staggered_submission():
    """A request submitted mid-flight joins the running batch and still
    decodes correctly (true continuous batching)."""
    params = model.init_params(CFG, jax.random.PRNGKey(1))
    from clusterfusion.runtime.serving import ServingEngine

    eng = ServingEngine(params, CFG, page_size=8, num_pages=64, max_batch=4)
    eng.submit(0, [3, 1, 4], max_gen_len=6, temperature=0.0)
    for _ in range(2):
        assert eng.step()
    eng.submit(1, [1, 5, 9, 2], max_gen_len=3, temperature=0.0)
    out = eng.run()
    assert out[0] == _reference_greedy(params, [3, 1, 4], 6)
    assert out[1] == _reference_greedy(params, [1, 5, 9, 2], 3)


def test_serving_engine_queue_overflow():
    """More requests than pages: later requests wait, then run to the same
    greedy result once pages free up."""
    params = model.init_params(CFG, jax.random.PRNGKey(2))
    from clusterfusion.runtime.serving import ServingEngine

    # pool sized so only ~2 requests fit at once
    eng = ServingEngine(params, CFG, page_size=8, num_pages=7, max_batch=4,
                        max_pages_per_req=3)
    prompts = {0: [1, 2, 3, 4], 1: [5, 6, 7], 2: [8, 9]}
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    for rid, p in prompts.items():
        assert out[rid] == _reference_greedy(params, p, 4), rid


def test_serving_engine_int8_quantized():
    """Continuous-batched INT8 decode (scale-after-dot projections) is
    batching-invariant: decoding requests together bit-matches decoding
    each alone through the same engine.  (A cross-path token-level
    comparison would be brittle: quantized random-weight logits have
    near-ties that argmax resolves differently between the batched step
    and the single-sequence decode.)"""
    from clusterfusion.ops.quant import quantize_llama_params
    from clusterfusion.runtime.serving import ServingEngine

    params = quantize_llama_params(
        model.init_params(CFG, jax.random.PRNGKey(3)), "int8", 128)
    prompts = {0: [1, 2, 3], 1: [5, 6, 7, 8]}

    # same max_batch both ways: the step pads rows to max_batch, so the
    # compiled shapes (and therefore XLA's rounding) are identical and the
    # comparison is bit-exact
    solo = {}
    for rid, p in prompts.items():
        eng1 = ServingEngine(params, CFG, page_size=8, num_pages=64,
                             max_batch=4)
        eng1.submit(rid, p, max_gen_len=4, temperature=0.0)
        solo.update(eng1.run())

    eng = ServingEngine(params, CFG, page_size=8, num_pages=64, max_batch=4)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=4, temperature=0.0)
    out = eng.run()
    assert out == solo, (out, solo)


def test_serving_engine_recompute_preemption():
    """A request preempted mid-generation under pool pressure (pages freed,
    recompute policy) must resume EXACTLY: its KV re-prefilled from
    prompt + generated[:-1] and no duplicate token sampled.  Regression for
    the round-1 bug where re-admission re-prefilled only the prompt (stale
    zero KV rows) and re-sampled an extra token (ADVICE.md, high)."""
    from clusterfusion.runtime.serving import ServingEngine

    params = model.init_params(CFG, jax.random.PRNGKey(7))
    # 3 usable pages of 8 tokens: two 3-token prompts fit, but crossing the
    # first page boundary (len 8 -> 2 pages each) exhausts the pool and
    # forces a recompute preemption of the newer request
    eng = ServingEngine(params, CFG, page_size=8, num_pages=4, max_batch=4,
                        max_pages_per_req=3)

    # record re-admissions (fresh rows whose request already generated)
    readmitted = []
    orig_prepare = eng.sched.prepare_batch

    def spy(max_batch):
        ids, table, lens, poss, fresh = orig_prepare(max_batch)
        for b in range(len(ids)):
            if fresh[b] and eng._reqs[int(ids[b])].generated:
                readmitted.append(int(ids[b]))
        return ids, table, lens, poss, fresh

    eng.sched.prepare_batch = spy
    prompts = {0: [1, 2, 3], 1: [4, 5, 6]}
    for rid, p in prompts.items():
        eng.submit(rid, p, max_gen_len=10, temperature=0.0)
    out = eng.run()
    assert readmitted, "pool geometry no longer forces a preemption"
    for rid, p in prompts.items():
        want = _reference_greedy(params, p, 10)
        assert out[rid] == want, (rid, out[rid], want)


def test_serving_engine_cancel_and_stats():
    from clusterfusion.runtime.serving import ServingEngine

    params = model.init_params(CFG, jax.random.PRNGKey(4))
    eng = ServingEngine(params, CFG, page_size=8, num_pages=32, max_batch=4)
    eng.submit(0, [1, 2, 3], max_gen_len=10, temperature=0.0)
    eng.submit(1, [4, 5], max_gen_len=10, temperature=0.0)
    for _ in range(2):
        assert eng.step()
    st = eng.stats()
    assert st["active"] == 2 and st["free_pages"] < st["total_pages"]
    partial = eng.cancel(0)
    assert len(partial) >= 1
    out = eng.run()
    assert 0 not in out and len(out[1]) == 10
    assert eng.stats()["requests"] == 0


def test_serving_engine_fp8_pool():
    """Serving over an fp8 KV pool stays close to the bf16-pool engine."""
    from clusterfusion.runtime.serving import ServingEngine

    params = model.init_params(CFG, jax.random.PRNGKey(5))
    outs = {}
    for dt in (jnp.bfloat16, jnp.float8_e4m3fn):
        eng = ServingEngine(params, CFG, page_size=8, num_pages=64,
                            max_batch=2, kv_dtype=dt)
        eng.submit(0, [1, 2, 3, 4, 5], max_gen_len=6, temperature=0.0)
        outs[dt] = eng.run()[0]
    # greedy tokens may drift where logits are near-tied; most should agree
    agree = sum(a == b for a, b in zip(outs[jnp.bfloat16],
                                       outs[jnp.float8_e4m3fn]))
    assert agree >= 3, outs


def test_serving_engine_chunked_prefill():
    """Long prompt prefilled in fixed-size chunks must decode to the same
    greedy tokens as the single-sequence path (chunked prefill is a
    capability the reference lacks — its prefill is always one shot)."""
    from clusterfusion.runtime.serving import ServingEngine

    params = model.init_params(CFG, jax.random.PRNGKey(5))
    long_prompt = [int(x) for x in (np.arange(41) * 11 + 3) % CFG.vocab_size]
    short_prompt = [7, 8, 9]
    # 3 tokens: with these weights the 4th token is a sub-ulp argmax tie
    eng = ServingEngine(params, CFG, page_size=8, num_pages=64, max_batch=4,
                        prefill_chunk=16)
    eng.submit(0, long_prompt, max_gen_len=3, temperature=0.0)
    eng.submit(1, short_prompt, max_gen_len=3, temperature=0.0)
    out = eng.run()
    assert out[0] == _reference_greedy(params, long_prompt, 3)
    assert out[1] == _reference_greedy(params, short_prompt, 3)


def test_serving_step_impls_agree():
    """The serving step over paged pools agrees with the single-sequence
    decode step over each row's pages gathered into a contiguous cache:
    same greedy tokens, same logprobs, same appended K/V rows."""
    import functools
    from clusterfusion.runtime import serving as S

    params = model.init_params(CFG, jax.random.PRNGKey(6))
    B, page, P, num_pages = 3, 8, 8, 32
    rng = np.random.RandomState(0)
    shape = (CFG.n_layers, num_pages, CFG.kv_heads, page, CFG.head_dim_)
    kp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    vp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
    table = jnp.asarray(np.arange(1, 1 + B * P).reshape(B, P), jnp.int32)
    lens = jnp.asarray([11, 5, 16], jnp.int32)
    toks = jnp.asarray([3, 9, 1], jnp.int32)
    key = jax.random.PRNGKey(0)
    temps = jnp.zeros((B,))
    tops = jnp.full((B,), 0.9)
    nxt, lp, kp2, vp2 = jax.jit(functools.partial(
        S._paged_decode_step, cfg=CFG))(
        params, kp, vp, toks, lens, table, lens, key, temps, tops)

    def contiguous(pool, b):       # [L, kv, P*page, hd]
        x = pool[:, table[b]]      # [L, P, kv, page, hd]
        return x.transpose(0, 2, 1, 3, 4).reshape(
            CFG.n_layers, CFG.kv_heads, P * page, CFG.head_dim_)

    for b in range(B):
        lg, kc, vc = model.decode_step(params, contiguous(kp, b),
                                       contiguous(vp, b), toks[b], lens[b],
                                       CFG)
        assert int(nxt[b]) == int(jnp.argmax(lg)), b
        want_lp = float(jax.nn.log_softmax(lg)[int(nxt[b])])
        assert abs(float(lp[b]) - want_lp) < 0.05, b
        n = int(lens[b])
        np.testing.assert_allclose(
            np.asarray(contiguous(kp2, b)[:, :, n], np.float32),
            np.asarray(kc[:, :, n], np.float32), atol=0.06)


def test_set_window_token_api():
    """Token-window-aware rolling-buffer setup (advisor r4): set_window
    derives the minimal safe page cap; the low-level set_window_pages
    rejects a cap that violates the recycle-safety invariant
    window <= (window_pages-1)*page_size + 1 when told the token window."""
    sched = PagedKVScheduler(num_pages=32, page_size=8, max_pages_per_req=16)
    assert sched.set_window(17) == 4          # ceil(17/8)+1
    # exact-boundary cap passes the invariant (17 <= 2*8+1)
    sched.set_window_pages(3, _window_tokens=17)
    with pytest.raises(ValueError):
        sched.set_window_pages(2, _window_tokens=17)   # 17 > 1*8+1
    with pytest.raises(ValueError):
        sched.set_window(0)
