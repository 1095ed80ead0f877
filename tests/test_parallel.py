"""Multi-device validation on a virtual 8-device CPU mesh — what the reference
never tests (it pins --nproc_per_node 1, `scripts/llama2.sh:4`; SURVEY.md
§4d calls for exactly this).  Runs in a subprocess with its own 8 virtual
CPU devices."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu(code: str, timeout: int = 600) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


def test_dryrun_multichip_8():
    out = _run_cpu("import __graft_entry__ as g; g.dryrun_multichip(8)")
    assert "dryrun_multichip OK" in out


def test_sharded_decode_matches_single_device():
    """tp=4 sharded decode must produce the same logits as the unsharded
    decode step."""
    code = """
import jax, jax.numpy as jnp
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings,
                                        make_sharded_decode_step)

cfg = LlamaConfig.tiny(max_seq_len=64)
params = model.init_params(cfg, jax.random.PRNGKey(0))
k_cache, v_cache = model.init_cache(cfg)
tok = jnp.asarray(9, jnp.int32)
pos = jnp.asarray(0, jnp.int32)

ref_logits, ref_k, _ = model.decode_step(params, k_cache, v_cache, tok, pos,
                                         cfg)

mesh = build_mesh(MeshConfig(dp=1, tp=4, sp=2),
                  devices=jax.devices()[:8])
sp = shard_params(params, cfg, mesh)
kc = jax.device_put(k_cache, cache_shardings(mesh))
vc = jax.device_put(v_cache, cache_shardings(mesh))
step = make_sharded_decode_step(cfg, mesh)
logits, kc, vc = step(sp, kc, vc, tok, pos)

err = float(jnp.max(jnp.abs(logits - ref_logits)))
assert err < 5e-2, f"sharded vs single logits err {err}"
kerr = float(jnp.max(jnp.abs(jnp.asarray(kc, jnp.float32)
                             - jnp.asarray(ref_k, jnp.float32))))
assert kerr < 5e-2, f"cache err {kerr}"
print("SHARDED_DECODE_OK", err)
"""
    out = _run_cpu(code)
    assert "SHARDED_DECODE_OK" in out


def test_sp_sharded_decode_matches_single_device():
    """(tp=2, sp=2) and (tp=1, sp=4) sequence-parallel decode must match
    the unsharded step: KV sharded over sp, per-device softmax partials
    merged with pmax/psum (the device-scope restatement of the reference's
    intra-cluster flash-decode merge, `kernel.cuh:479-551`)."""
    code = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings_2d,
                                        make_sp_sharded_decode_step)

cfg = LlamaConfig.tiny(max_seq_len=64)
params = model.init_params(cfg, jax.random.PRNGKey(0))
k_cache, v_cache = model.init_cache(cfg)

# warm the cache with a short prefill so sp shards actually hold history
prompt = jnp.arange(20, dtype=jnp.int32) % cfg.vocab_size
_, k_cache, v_cache = model.prefill(params, k_cache, v_cache, prompt, cfg)
tok = jnp.asarray(9, jnp.int32)
pos = jnp.asarray(20, jnp.int32)

ref_logits, ref_k, ref_v = model.decode_step(params, k_cache, v_cache, tok,
                                             pos, cfg)

for tp, sp in [(2, 2), (1, 4)]:
    mesh = build_mesh(MeshConfig(dp=1, tp=tp, sp=sp),
                      devices=jax.devices()[: tp * sp])
    sparams = shard_params(params, cfg, mesh)
    kc = jax.device_put(k_cache, cache_shardings_2d(mesh))
    vc = jax.device_put(v_cache, cache_shardings_2d(mesh))
    step = make_sp_sharded_decode_step(cfg, mesh)
    logits, kc, vc = step(sparams, kc, vc, tok, pos)
    np.testing.assert_allclose(np.asarray(logits, np.float32),
                               np.asarray(ref_logits, np.float32),
                               atol=0.05, rtol=0.02)
    # the appended token's K/V at layers >= 1 carries bf16 noise from the
    # slightly different (merged) layer-0 output — history must be exact
    np.testing.assert_allclose(np.asarray(kc, np.float32),
                               np.asarray(ref_k, np.float32), atol=0.05)
    np.testing.assert_allclose(np.asarray(vc, np.float32),
                               np.asarray(ref_v, np.float32), atol=0.05)
    np.testing.assert_array_equal(np.asarray(kc)[:, :, :20],
                                  np.asarray(ref_k)[:, :, :20])
    # decode a second token to prove the sp append really landed
    logits2, kc, vc = step(sparams, kc, vc,
                           jnp.asarray(4, jnp.int32), jnp.asarray(21, jnp.int32))
    ref2, _, _ = model.decode_step(params, ref_k, ref_v,
                                   jnp.asarray(4, jnp.int32),
                                   jnp.asarray(21, jnp.int32), cfg)
    np.testing.assert_allclose(np.asarray(logits2, np.float32),
                               np.asarray(ref2, np.float32),
                               atol=0.05, rtol=0.02)
    print(f"sp decode ok tp={tp} sp={sp}")
print("SP_OK")
"""
    out = _run_cpu(code)
    assert "SP_OK" in out


def test_expert_sharded_moe_matches_single_device():
    """Expert-parallel MoE (`parallel.ep.make_ep_moe_ffn`): experts sharded
    over the mesh's ep axis, per-device masked-dense contributions combined
    with psum — must equal the unsharded masked-dense MoE (and hence the
    gathered-expert decode).  Covers a pure ep=4 mesh and a mixed
    (tp=2, ep=2, dp=2) mesh where ep is one axis of several."""
    code = """
import jax, jax.numpy as jnp, numpy as np
from clusterfusion.config import MeshConfig
from clusterfusion.ops.moe import moe_ffn_dense
from clusterfusion.parallel import build_mesh, make_ep_moe_ffn

E, H, F, K = 8, 256, 128, 2
ks = jax.random.split(jax.random.PRNGKey(0), 4)
r = lambda k, s, f: (jax.random.normal(k, s, jnp.float32)/np.sqrt(f)).astype(jnp.bfloat16)
router_w = r(ks[0], (H, E), H)
w13 = r(ks[1], (E, 2, H, F), H)
w2 = r(ks[2], (E, F, H), F)
x = jax.random.normal(ks[3], (4, H), jnp.bfloat16)

want = moe_ffn_dense(x, router_w, w13, w2, K)

for mcfg in (MeshConfig(ep=4), MeshConfig(tp=2, ep=2, dp=2)):
    mesh = build_mesh(mcfg, devices=jax.devices()[:mcfg.n_devices])
    f = make_ep_moe_ffn(mesh, K)
    got = f(x, router_w, w13, w2)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32)
                                - want.astype(jnp.float32))))
    assert err < 0.02, (mcfg, err)
    print("ep OK", mcfg.shape, err)
print("EP_ALL_OK")
"""
    out = _run_cpu(code)
    assert "EP_ALL_OK" in out


def test_pipeline_parallel_train_matches_single_device():
    """GPipe pipeline-parallel training (`parallel.pp`): loss AND gradients
    through the (pp=2, dp=2) microbatch schedule must equal the
    single-device `train.lm_loss` (the schedule is pure re-ordering — no
    numeric deltas beyond bf16 noise), and `make_pp_train_step` must run."""
    code = """
import jax, jax.numpy as jnp, numpy as np
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, make_pp_train_step,
                                        pipeline_lm_loss, shard_params_pp)
from clusterfusion.train import lm_loss, make_optimizer

cfg = LlamaConfig.tiny(max_seq_len=64)
params = model.init_params(cfg, jax.random.PRNGKey(0))
B, T = 4, 16
rng = np.random.RandomState(0)
tokens = jnp.asarray(rng.randint(0, cfg.vocab_size, (B, T)), jnp.int32)
targets = jnp.asarray(rng.randint(0, cfg.vocab_size, (B, T)), jnp.int32)
want = float(lm_loss(params, tokens, targets, cfg))
g_ref = jax.grad(lm_loss)(params, tokens, targets, cfg)

mesh = build_mesh(MeshConfig(pp=2, dp=2), devices=jax.devices()[:4])
sp = shard_params_pp(params, cfg, mesh)
got = float(jax.jit(
    lambda p, a, b: pipeline_lm_loss(p, a, b, cfg, mesh, 2))(sp, tokens,
                                                             targets))
assert abs(want - got) < 1e-3, (want, got)

g_pp = jax.grad(lambda p: pipeline_lm_loss(p, tokens, targets, cfg, mesh,
                                           2))(sp)
for leaf, a, b in (("embed", g_ref["embed"], g_pp["embed"]),
                   ("lm_head", g_ref["lm_head"], g_pp["lm_head"]),
                   ("w2", g_ref["layers"]["w2"], g_pp["layers"]["w2"]),
                   ("wqkv_f", g_ref["layers"]["wqkv_f"],
                    g_pp["layers"]["wqkv_f"])):
    e = float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float32)
                              - jnp.asarray(b, jnp.float32))))
    assert e < 2e-2, (leaf, e)

step = make_pp_train_step(cfg, mesh, n_microbatches=2)
opt = make_optimizer().init(sp)
p2, opt, loss = step(sp, opt, tokens, targets)
assert jnp.isfinite(loss)
print("PP_OK", want, got)
"""
    out = _run_cpu(code)
    assert "PP_OK" in out


def test_sharded_serving_step_matches_single_device():
    """tp=4 sharded BATCHED serving step (multi-device continuous
    batching) == the single-device serving step."""
    code = """
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import build_mesh, shard_params
from clusterfusion.parallel.decode import make_sharded_serving_step
from clusterfusion.runtime.serving import _paged_decode_step

cfg = LlamaConfig.tiny(max_seq_len=64)
params = model.init_params(cfg, jax.random.PRNGKey(0))
B, page, P_, num_pages, L = 2, 8, 4, 16, cfg.n_layers
rng = np.random.RandomState(0)
shape = (L, num_pages, cfg.kv_heads, page, cfg.head_dim_)
kp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
vp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
table = jnp.asarray(np.arange(1, 1 + B * P_).reshape(B, P_), jnp.int32)
lens = jnp.asarray([11, 5], jnp.int32)
toks = jnp.asarray([3, 9], jnp.int32)

# single-device reference via the batched step (greedy: temperature 0)
key = jax.random.PRNGKey(0)
nxt_ref, _, kp_ref, vp_ref = jax.jit(functools.partial(
    _paged_decode_step, cfg=cfg))(
    params, kp, vp, toks, lens, table, lens, key,
    jnp.zeros((B,)), jnp.full((B,), 0.9))

mesh = build_mesh(MeshConfig(dp=1, tp=4, sp=2), devices=jax.devices()[:8])
sp = shard_params(params, cfg, mesh)
pool_sh = NamedSharding(mesh, P(None, None, "tp"))
kps = jax.device_put(kp, pool_sh)
vps = jax.device_put(vp, pool_sh)
step = make_sharded_serving_step(cfg, mesh)
logits, kps, vps = step(sp, kps, vps, toks, lens, table, lens)
nxt = jnp.argmax(logits, -1).astype(jnp.int32)
assert list(np.asarray(nxt)) == list(np.asarray(nxt_ref)), (nxt, nxt_ref)
kerr = float(jnp.max(jnp.abs(jnp.asarray(kps, jnp.float32)
                             - jnp.asarray(kp_ref, jnp.float32))))
assert kerr < 5e-2, kerr
print("SHARDED_SERVING_OK")
"""
    out = _run_cpu(code)
    assert "SHARDED_SERVING_OK" in out


def test_dcn_2host_serving_matches_per_host_reference():
    """(dcn=2, tp=4) serving step — a 2-host topology modeled on the
    virtual mesh: requests data-parallel over the host axis,
    page pools sharded per host, weights tp-sharded inside each host.  Each
    host's rows must equal running the single-device batched step on that
    host's pool shard alone (no cross-host interaction in the decode path).
    """
    code = """
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import build_mesh, shard_params
from clusterfusion.parallel.decode import make_sharded_serving_step
from clusterfusion.runtime.serving import _paged_decode_step

cfg = LlamaConfig.tiny(max_seq_len=64)
params = model.init_params(cfg, jax.random.PRNGKey(0))
B, page, W, num_pages, L = 4, 8, 2, 8, cfg.n_layers
rng = np.random.RandomState(0)
shape = (L, num_pages, cfg.kv_heads, page, cfg.head_dim_)
kp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
vp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
# per-host-local page indices (each host's table indexes its own shard)
table = jnp.asarray(np.arange(B * W).reshape(B, W) % (num_pages // 2),
                    jnp.int32)
lens = jnp.asarray([11, 5, 9, 3], jnp.int32)
toks = jnp.asarray([3, 9, 1, 4], jnp.int32)

# per-host single-device reference: host h = rows [2h,2h+2) on pool half h
key = jax.random.PRNGKey(0)
ref_step = jax.jit(functools.partial(
    _paged_decode_step, cfg=cfg))
ref_next = []
half = num_pages // 2
for h in range(2):
    r = slice(2 * h, 2 * h + 2)
    nxt, _, kp_h, vp_h = ref_step(
        params, kp[:, h * half:(h + 1) * half], vp[:, h * half:(h + 1) * half],
        toks[r], lens[r], table[r], lens[r], key,
        jnp.zeros((2,)), jnp.full((2,), 0.9))
    ref_next.append(np.asarray(nxt))
ref_next = np.concatenate(ref_next)

mesh = build_mesh(MeshConfig(dcn=2, tp=4), devices=jax.devices()[:8])
sp = shard_params(params, cfg, mesh)
pool_sh = NamedSharding(mesh, P(None, "dcn", "tp"))
bsh = NamedSharding(mesh, P("dcn"))
kps = jax.device_put(kp, pool_sh)
vps = jax.device_put(vp, pool_sh)
step = make_sharded_serving_step(cfg, mesh)
logits, kps, vps = step(sp, kps, vps,
                        jax.device_put(toks, bsh), jax.device_put(lens, bsh),
                        jax.device_put(table, bsh), jax.device_put(lens, bsh))
nxt = np.asarray(jnp.argmax(logits, -1).astype(jnp.int32))
assert list(nxt) == list(ref_next), (nxt, ref_next)
print("DCN_SERVING_OK")
"""
    out = _run_cpu(code)
    assert "DCN_SERVING_OK" in out


def test_gemma_tp_decode_matches_single_device():
    """Gemma-2 features (sandwich norms + GeGLU + softcaps + interleaved
    windows) through the tp decode path — the post-norms must land AFTER
    each cross-device reduce."""
    code = """
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings,
                                        make_sharded_decode_step)

cfg = LlamaConfig.tiny(max_seq_len=64, ffn_act="gelu_tanh",
                       sandwich_norms=True, attn_logit_softcap=50.0,
                       sliding_window=24, window_pattern="even")
params = model.init_params(cfg, jax.random.PRNGKey(0))
for k in ("post_attn_norm", "post_ffn_norm"):
    params["layers"][k] = params["layers"][k] + 0.3 * jax.random.normal(
        jax.random.PRNGKey(3), params["layers"][k].shape, jnp.bfloat16)
k_cache, v_cache = model.init_cache(cfg)
prompt = jnp.arange(30, dtype=jnp.int32) % cfg.vocab_size
_, k_cache, v_cache = model.prefill(params, k_cache, v_cache, prompt, cfg)
tok = jnp.asarray(9, jnp.int32)
pos = jnp.asarray(30, jnp.int32)
ref_logits, _, _ = model.decode_step(params, k_cache, v_cache, tok, pos,
                                     cfg)
mesh = build_mesh(MeshConfig(dp=1, tp=4, sp=1), devices=jax.devices()[:4])
sp = shard_params(params, cfg, mesh)
kc = jax.device_put(k_cache, cache_shardings(mesh))
vc = jax.device_put(v_cache, cache_shardings(mesh))
step = make_sharded_decode_step(cfg, mesh)
logits, _, _ = step(sp, kc, vc, tok, pos)
logits = logits.reshape(-1)[: cfg.vocab_size]
np.testing.assert_allclose(np.asarray(logits, np.float32),
                           np.asarray(ref_logits, np.float32),
                           atol=0.05, rtol=0.02)
print("GEMMA_TP_OK")
"""
    out = _run_cpu(code, timeout=1200)
    assert "GEMMA_TP_OK" in out


def test_windowed_sp_decode_matches_single_device():
    """Sliding-window (Mistral-style, pattern "all") decode on the
    sequence-parallel path: each device masks its KV slice by global
    position, so a window spanning the shard boundary masks exactly the
    same positions as the single-device windowed step.  Covers: window
    crossing shards (device 0 partially in-window), a device fully below
    the window (its partial merges as m=-1e30/l=0), and the full-history
    case (window wider than the live context)."""
    code = """
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings_2d,
                                        make_sp_sharded_decode_step)

for window, n_prompt in [(24, 44),   # wlo=21: crosses the sp=2 boundary
                         (8, 44),    # wlo=37: device 0 fully below window
                         (24, 10)]:  # window > live context: full history
    cfg = LlamaConfig.tiny(max_seq_len=64, sliding_window=window)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    k_cache, v_cache = model.init_cache(cfg)
    prompt = (jnp.arange(n_prompt, dtype=jnp.int32) * 5 + 3) % cfg.vocab_size
    _, k_cache, v_cache = model.prefill(params, k_cache, v_cache, prompt, cfg)
    tok = jnp.asarray(9, jnp.int32)
    pos = jnp.asarray(n_prompt, jnp.int32)
    ref_logits, ref_k, ref_v = model.decode_step(params, k_cache, v_cache,
                                                 tok, pos, cfg)
    for tp, sp in [(2, 2), (1, 4)]:
        mesh = build_mesh(MeshConfig(dp=1, tp=tp, sp=sp),
                          devices=jax.devices()[: tp * sp])
        sparams = shard_params(params, cfg, mesh)
        kc = jax.device_put(k_cache, cache_shardings_2d(mesh))
        vc = jax.device_put(v_cache, cache_shardings_2d(mesh))
        step = make_sp_sharded_decode_step(cfg, mesh)
        logits, kc, vc = step(sparams, kc, vc, tok, pos)
        np.testing.assert_allclose(np.asarray(logits, np.float32),
                                   np.asarray(ref_logits, np.float32),
                                   atol=0.05, rtol=0.02)
        # second step: append landed + window slid by one
        logits2, kc, vc = step(sparams, kc, vc, jnp.asarray(4, jnp.int32),
                               jnp.asarray(n_prompt + 1, jnp.int32))
        ref2, _, _ = model.decode_step(params, ref_k, ref_v,
                                       jnp.asarray(4, jnp.int32),
                                       jnp.asarray(n_prompt + 1, jnp.int32),
                                       cfg)
        np.testing.assert_allclose(np.asarray(logits2, np.float32),
                                   np.asarray(ref2, np.float32),
                                   atol=0.05, rtol=0.02)
        print(f"windowed sp ok w={window} np={n_prompt} tp={tp} sp={sp}")
print("WINDOWED_SP_OK")
"""
    out = _run_cpu(code, timeout=1800)
    assert "WINDOWED_SP_OK" in out


def test_gemma_sp_decode_matches_single_device():
    """The full gemma-2 feature set INCLUDING interleaved local/global
    windows on the (tp, sp) path: even layers windowed, odd layers full
    context."""
    code = """
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings_2d,
                                        make_sp_sharded_decode_step)

cfg = LlamaConfig.tiny(max_seq_len=64, ffn_act="gelu_tanh",
                       sandwich_norms=True, attn_logit_softcap=50.0,
                       sliding_window=24, window_pattern="even")
params = model.init_params(cfg, jax.random.PRNGKey(0))
for k in ("post_attn_norm", "post_ffn_norm"):
    params["layers"][k] = params["layers"][k] + 0.3 * jax.random.normal(
        jax.random.PRNGKey(3), params["layers"][k].shape, jnp.bfloat16)
k_cache, v_cache = model.init_cache(cfg)
# 40 live tokens: at sp=2 (32-position shards) the even-layer window
# [17, 40] crosses the shard boundary while odd layers read full history
prompt = jnp.arange(40, dtype=jnp.int32) % cfg.vocab_size
_, k_cache, v_cache = model.prefill(params, k_cache, v_cache, prompt, cfg)
tok = jnp.asarray(9, jnp.int32)
pos = jnp.asarray(40, jnp.int32)
ref_logits, _, _ = model.decode_step(params, k_cache, v_cache, tok, pos,
                                     cfg)

mesh2 = build_mesh(MeshConfig(dp=1, tp=2, sp=2), devices=jax.devices()[:4])
sp2 = shard_params(params, cfg, mesh2)
kc = jax.device_put(k_cache, cache_shardings_2d(mesh2))
vc = jax.device_put(v_cache, cache_shardings_2d(mesh2))
step = make_sp_sharded_decode_step(cfg, mesh2)
logits, _, _ = step(sp2, kc, vc, tok, pos)
logits = logits.reshape(-1)[: cfg.vocab_size]
np.testing.assert_allclose(np.asarray(logits, np.float32),
                           np.asarray(ref_logits, np.float32),
                           atol=0.05, rtol=0.02)
print("GEMMA_SP_OK")
"""
    out = _run_cpu(code, timeout=1200)
    assert "GEMMA_SP_OK" in out


def test_quantized_tp_and_sp_decode_matches_single_device():
    """Quantized tensor-parallel / sequence-parallel decode:
    QuantizedTensor params shard with QuantizedTensor-shaped spec nodes
    (payload keeps the weight's spec; int8 per-output-channel scales
    replicate over a sharded reduction axis, int4 group-scale rows shard
    with it).  tp=2 and tp=2xsp=2 decode over int8 and int4 trees must
    match the single-device quantized step."""
    code = """
import numpy as np
import jax, jax.numpy as jnp
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import QuantizedTensor, quantize_llama_params
from clusterfusion.parallel import (build_mesh, shard_params,
                                        cache_shardings, cache_shardings_2d,
                                        make_sharded_decode_step,
                                        make_sp_sharded_decode_step)

for kind in ("int8", "int4"):
    cfg = LlamaConfig.tiny(max_seq_len=64, n_kv_heads=4, hidden_dim=512,
                           ffn_dim=1024)
    params = model.init_params(cfg, jax.random.PRNGKey(0))
    params = quantize_llama_params(params, kind, 128, lm_head=True)
    assert isinstance(params["layers"]["wqkv_f"], QuantizedTensor)
    k_cache, v_cache = model.init_cache(cfg)
    prompt = (jnp.arange(20, dtype=jnp.int32) * 3 + 1) % cfg.vocab_size
    _, k_cache, v_cache = model.prefill(params, k_cache, v_cache, prompt, cfg)
    tok = jnp.asarray(9, jnp.int32)
    pos = jnp.asarray(20, jnp.int32)
    ref_logits, _, _ = model.decode_step(params, k_cache, v_cache, tok, pos,
                                         cfg)

    # tensor-parallel
    mesh = build_mesh(MeshConfig(dp=1, tp=2, sp=1), devices=jax.devices()[:2])
    sparams = shard_params(params, cfg, mesh)
    kc = jax.device_put(k_cache, cache_shardings(mesh))
    vc = jax.device_put(v_cache, cache_shardings(mesh))
    step = make_sharded_decode_step(cfg, mesh, params=params)
    logits, _, _ = step(sparams, kc, vc, tok, pos)
    logits = logits.reshape(-1)[: cfg.vocab_size]
    np.testing.assert_allclose(np.asarray(logits, np.float32),
                               np.asarray(ref_logits, np.float32),
                               atol=0.06, rtol=0.03)
    print(f"quant tp ok {kind}")

    # tensor+sequence-parallel
    mesh2 = build_mesh(MeshConfig(dp=1, tp=2, sp=2),
                       devices=jax.devices()[:4])
    sp2 = shard_params(params, cfg, mesh2)
    kc2 = jax.device_put(k_cache, cache_shardings_2d(mesh2))
    vc2 = jax.device_put(v_cache, cache_shardings_2d(mesh2))
    step2 = make_sp_sharded_decode_step(cfg, mesh2, params=params)
    logits2, _, _ = step2(sp2, kc2, vc2, tok, pos)
    logits2 = logits2.reshape(-1)[: cfg.vocab_size]
    np.testing.assert_allclose(np.asarray(logits2, np.float32),
                               np.asarray(ref_logits, np.float32),
                               atol=0.06, rtol=0.03)
    print(f"quant sp ok {kind}")
print("QUANT_PARALLEL_OK")
"""
    out = _run_cpu(code, timeout=1800)
    assert "QUANT_PARALLEL_OK" in out


def test_sharded_serving_step_int8_matches_single_device():
    """tp-sharded batched serving over an INT8 tree: the scale-after-dot
    einsums shard like bf16 (int8 per-output-channel scales replicate
    over the sharded reduction axis), so multi-device
    continuous batching runs quantized without materialized copies.

    Reference: the same step over the DEQUANTIZED bf16 tree on the same
    mesh (the unsharded CPU jit of the int8 step hits CPU XLA's missing
    bf16xbf16->f32 DotThunk; the GPU has no such limitation)."""
    code = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from clusterfusion.config import LlamaConfig, MeshConfig
from clusterfusion.models import llama as model
from clusterfusion.ops.quant import (QuantizedTensor,
                                         maybe_dequantize,
                                         quantize_llama_params)
from clusterfusion.parallel import build_mesh, shard_params
from clusterfusion.parallel.decode import make_sharded_serving_step

cfg = LlamaConfig.tiny(max_seq_len=64)
params0 = model.init_params(cfg, jax.random.PRNGKey(0))
qparams = quantize_llama_params(params0, "int8")
dparams = jax.tree.map(
    lambda w: maybe_dequantize(w) if isinstance(w, QuantizedTensor) else w,
    qparams, is_leaf=lambda x: isinstance(x, QuantizedTensor))
B, page, P_, num_pages, L = 2, 8, 4, 16, cfg.n_layers
rng = np.random.RandomState(0)
shape = (L, num_pages, cfg.kv_heads, page, cfg.head_dim_)
kp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
vp = jnp.asarray(rng.randn(*shape), jnp.bfloat16)
table = jnp.asarray(np.arange(1, 1 + B * P_).reshape(B, P_), jnp.int32)
lens = jnp.asarray([11, 5], jnp.int32)
toks = jnp.asarray([3, 9], jnp.int32)

mesh = build_mesh(MeshConfig(dp=1, tp=4, sp=2), devices=jax.devices()[:8])
pool_sh = NamedSharding(mesh, P(None, None, "tp"))
kps = jax.device_put(kp, pool_sh)
vps = jax.device_put(vp, pool_sh)

logits_q, _, _ = make_sharded_serving_step(cfg, mesh, params=qparams)(
    shard_params(qparams, cfg, mesh), kps, vps, toks, lens, table, lens)
logits_d, _, _ = make_sharded_serving_step(cfg, mesh)(
    shard_params(dparams, cfg, mesh),
    jax.device_put(kp, pool_sh), jax.device_put(vp, pool_sh),
    toks, lens, table, lens)
a = np.asarray(logits_q, np.float32)
b = np.asarray(logits_d, np.float32)
scale = max(float(np.max(np.abs(b))), 1.0)
assert np.max(np.abs(a - b)) < 0.03 * scale, np.max(np.abs(a - b))
print("SHARDED_SERVING_INT8_OK")
"""
    out = _run_cpu(code)
    assert "SHARDED_SERVING_INT8_OK" in out


def test_sp_partial_merge_equals_full_attention():
    """Softmax partials over disjoint KV slices, merged with pmax/psum over
    a named axis, equal attention over the whole sequence — including a
    slice with no valid key (window or causal mask)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from clusterfusion.parallel.sp_decode import (merge_partials,
                                                  softmax_partials)

    rng = np.random.RandomState(0)
    kv, g, hd, S, n = 2, 3, 64, 32, 4
    q = jnp.asarray(rng.randn(kv, g, hd), jnp.float32)
    k = jnp.asarray(rng.randn(kv, S, hd), jnp.float32)
    v = jnp.asarray(rng.randn(kv, S, hd), jnp.float32)
    valid = jnp.arange(S) < 21              # last slice fully masked

    def per_slice(ks, vs, ms):
        acc, m, l = softmax_partials(q, ks, vs, ms)
        return merge_partials(acc, m, l, "sp")

    split = lambda x: x.reshape(kv, n, S // n, hd).transpose(1, 0, 2, 3)
    out = jax.vmap(per_slice, axis_name="sp")(
        split(k), split(v), valid.reshape(n, S // n))
    s = jnp.einsum("kgd,ksd->kgs", q, k) / np.sqrt(hd)
    p = jax.nn.softmax(jnp.where(valid, s, -jnp.inf), axis=-1)
    want = jnp.einsum("kgs,ksd->kgd", p, v)
    for i in range(n):
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
