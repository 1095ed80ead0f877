"""chip_smoke.py's phases at tiny sizes on the CPU: the same functions the
GPU run calls at full width, with the kernel in interpret mode."""

import functools
import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs
from clusterfusion.config import DeepSeekConfig, LlamaConfig
from clusterfusion.ops import paged_attention as pa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and last["device"]["platform"] == "cpu"


def test_kernel_phases_tiny():
    cs.phase_paged(0, ctx=48, B=3,
                   widths={"gqa": (2, 4, 64, 0, 0.0),
                           "window_softcap": (2, 2, 128, 20, 50.0)},
                   kernel_fn=functools.partial(pa.paged_attention_kernel,
                                               interpret=True))
    cs.phase_prefill(0, T=64, kv=2, g=2, hd=64, dtype="float32")
    cs.phase_mla(0, cfg=DeepSeekConfig.tiny(max_seq_len=80), seq=64)


def test_main_path_tiny():
    cfg = LlamaConfig.tiny(max_seq_len=128, n_layers=2)
    eng, prompts = cs.phase_main(0, "cpu", cfg=cfg, prompt_lens=(5, 17, 40),
                                 n_gen=6, n_check=6)
    cs.check_serving_step(eng, prompts, "cpu")


def test_multi_phases_tiny():
    cfg = LlamaConfig.tiny(max_seq_len=256, n_kv_heads=4, n_layers=2)
    cs.phase_tp_serving(0, cfg, n_dev=4, B=3, ctx=100)
    cs.phase_sp_decode(0, cfg, n_dev=4, prompt_len=150)


@pytest.mark.parametrize("err,ok", [(0.01, True), (0.03, False)])
def test_check_enforces_tolerance(err, ok):
    if ok:
        cs.check("x", err, 0.02, "why")
    else:
        with pytest.raises(AssertionError):
            cs.check("x", err, 0.02, "why")


def test_rel_err_flags_non_finite():
    import numpy as np
    assert cs.rel_err(np.array([1.0, np.nan]), np.array([1.0, 1.0])) \
        == float("inf")
    assert cs.rel_err(np.array([1.0, 2.1]), np.array([1.0, 2.0])) \
        == pytest.approx(0.05)


@pytest.mark.parametrize("flip", [False, True])
def test_compare_greedy_refuses_a_clear_mismatch(flip):
    """Equal streams pass step for step; a served token that the fp32
    forward ranks far below the bs=1 token is refused."""
    import jax.numpy as jnp
    from clusterfusion.models import llama as model
    from clusterfusion.models.generation import Llama
    eng = Llama.synthetic(LlamaConfig.tiny(max_seq_len=64, n_layers=2))
    prompt = [5, 9, 2, 7]
    stream = list(eng.stream_generate(prompt, 4, temperature=0.0))
    served = list(stream)
    if not flip:
        assert cs.compare_greedy(eng, prompt, served, stream, 4) \
            == "4 of 4 steps equal"
        return
    # the token the fp32 forward scores lowest at step 1
    ref = model.reference_logits(
        eng.params, jnp.asarray(prompt + served[:1], jnp.int32), eng.cfg)[-1]
    served[1] = int(jnp.argmin(ref))
    with pytest.raises(AssertionError, match="part at step 1"):
        cs.compare_greedy(eng, prompt, served, stream, 4)
