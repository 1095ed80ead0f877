"""Failure detection (SURVEY §5): the serving engine isolates per-request
faults (numeric watchdog, prefill exceptions) and trips an engine-level
breaker when the step itself is broken.  The reference has no failure story
at all — it ignores even CUresult (`llama_kernel_dispatch.cu:48`)."""

import jax
import numpy as np
import pytest

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.runtime.serving import EngineHealthError, ServingEngine

CFG = LlamaConfig.tiny(max_seq_len=64)


def _engine(seed=0, **kw):
    params = model.init_params(CFG, jax.random.PRNGKey(seed))
    kw.setdefault("page_size", 8)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_batch", 4)
    return ServingEngine(params, CFG, **kw)


def _poison_step(eng, rows="all", n_steps=None):
    """Wrap eng._step so decode rows come back numerically broken (NaN
    logprob) — simulating NaN logits from a corrupted weight/cache."""
    real = eng._step
    state = {"calls": 0}

    def bad(*args):
        nxt, lp, kp, vp = real(*args)
        state["calls"] += 1
        if n_steps is None or state["calls"] <= n_steps:
            if rows == "all":
                lp = lp * np.float32(np.nan)
            else:
                lp = lp.at[rows].set(np.nan)
        return nxt, lp, kp, vp

    eng._step = bad
    return state


def test_numeric_watchdog_isolates_one_request():
    """A single NaN row kills only that request: it ends with error set and
    partial output intact; the other request decodes to completion and the
    engine stays healthy."""
    eng = _engine()
    eng.submit(0, [1, 2, 3], max_gen_len=5, temperature=0.0)
    eng.submit(1, [4, 5, 6], max_gen_len=5, temperature=0.0)
    # let one clean step commit a token for both rows first
    assert eng.step()
    _poison_step(eng, rows=0, n_steps=1)
    out = eng.run()
    errs = [r for r in eng.last_results.values() if r.error is not None]
    ok = [r for r in eng.last_results.values() if r.error is None]
    assert len(errs) == 1 and "numeric watchdog" in errs[0].error
    assert len(ok) == 1 and len(ok[0].generated) == 5
    # the failed request kept its pre-fault tokens (no garbage committed)
    assert 1 <= len(errs[0].generated) < 5
    assert set(out) == {0, 1}


def test_engine_breaker_on_step_level_fault():
    """Every row failing for max_bad_steps consecutive steps is a fault in
    the step itself — the engine raises instead of spinning on garbage."""
    eng = _engine(seed=1)
    eng.submit(0, [1, 2, 3], max_gen_len=50, temperature=0.0)
    _poison_step(eng, rows="all")
    # each poisoned step evicts the (sole) row, so resubmit to keep load;
    # breaker counts consecutive fully-failed steps
    with pytest.raises(EngineHealthError):
        for i in range(10):
            if not eng.step():
                eng.submit(100 + i, [1, 2, 3], max_gen_len=50,
                           temperature=0.0)
    assert eng.stats()["failed"] >= eng.max_bad_steps


def test_prefill_fault_isolated(monkeypatch):
    """An exception inside prefill kills only the faulting request."""
    eng = _engine(seed=2)
    real_prefill = model.prefill
    boom = {"armed": True}

    def flaky(params, kc, vc, toks, cfg, **kw):
        if boom["armed"] and int(np.asarray(toks)[0]) == 99:
            raise ValueError("injected prefill fault")
        return real_prefill(params, kc, vc, toks, cfg, **kw)

    monkeypatch.setattr(model, "prefill", flaky)
    eng.submit(0, [99, 2, 3], max_gen_len=4, temperature=0.0)
    eng.submit(1, [4, 5, 6], max_gen_len=4, temperature=0.0)
    out = eng.run()
    r0, r1 = eng.last_results[0], eng.last_results[1]
    assert r0.error is not None and "injected prefill fault" in r0.error
    assert r0.generated == [] and out[0] == []
    assert r1.error is None and len(r1.generated) == 4
    # pool fully reclaimed after both finished
    assert eng.stats()["free_pages"] == eng.stats()["total_pages"]


def test_clean_run_reports_no_failures():
    eng = _engine(seed=3)
    eng.submit(0, [7, 8], max_gen_len=3, temperature=0.0)
    eng.run()
    assert eng.stats()["failed"] == 0
    assert all(r.error is None for r in eng.last_results.values())
