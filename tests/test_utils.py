"""Utils tests: native checkpoint roundtrip (incl. quantized params) and
profiling primitives."""

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import QuantizedTensor, quantize_llama_params
from clusterfusion.utils import (
    LatencyStats,
    load_native_checkpoint,
    save_checkpoint,
)

CFG = LlamaConfig.tiny(max_seq_len=64)


def _tree_equal(a, b):
    fa = jax.tree.leaves(a)
    fb = jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        assert np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32))


def test_checkpoint_roundtrip_bf16(tmp_path):
    params = model.init_params(CFG, jax.random.PRNGKey(0))
    save_checkpoint(str(tmp_path / "ck"), params, CFG)
    loaded, cfg2 = load_native_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == CFG
    _tree_equal(params, loaded)


def test_checkpoint_roundtrip_quantized(tmp_path):
    params = quantize_llama_params(
        model.init_params(CFG, jax.random.PRNGKey(1)), "int4", 128)
    save_checkpoint(str(tmp_path / "ck"), params, CFG)
    loaded, cfg2 = load_native_checkpoint(str(tmp_path / "ck"))
    qt = loaded["layers"]["wqkv_f"]
    assert isinstance(qt, QuantizedTensor)
    assert qt.kind == "int4" and qt.group_size == 128
    _tree_equal(params, loaded)

    # loaded params decode identically
    kc, vc = model.init_cache(CFG)
    tok = jnp.asarray(3, jnp.int32)
    pos = jnp.asarray(0, jnp.int32)
    a, _, _ = model.decode_step(params, kc, vc, tok, pos, CFG)
    b, _, _ = model.decode_step(loaded, kc, vc, tok, pos, CFG)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_latency_stats():
    st = LatencyStats()
    for _ in range(5):
        with st.measure():
            pass
    s = st.summary()
    assert s["count"] == 5 and s["p99_ms"] >= 0


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory."""
    from clusterfusion.utils.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset, the cache is <checkout>/.jax_cache — a fixed path, never
    derived from a pid, a temporary name or the time."""
    import os
    from clusterfusion.utils.compile_cache import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        path = enable_compile_cache()
        assert path == os.path.join(repo, ".jax_cache")
        assert enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_card_name_without_nvidia_smi(monkeypatch):
    """No nvidia-smi on the PATH: a message, not an exception."""
    from clusterfusion.utils.profiling import card_name_and_power
    monkeypatch.setenv("PATH", "")
    assert "nvidia-smi" in card_name_and_power()
