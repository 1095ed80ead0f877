"""Tests for the device-scope collective layer (the DSM `cluster_reduce`
equivalent, `dsm.cuh:20-171`).

Runs in a CPU subprocess (8 virtual devices) like tests/test_parallel.py,
checking the XLA collectives numerically.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu(code: str) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return r.stdout


SCRIPT = r"""
import jax, jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from clusterfusion.parallel.collective import (
    Stage, cluster_gather, cluster_reduce)

N = 4
mesh = Mesh(np.array(jax.devices()[:N]), ("tp",))
assert jax.devices()[0].platform == "cpu"
x = jnp.arange(N * 8 * 128, dtype=jnp.float32).reshape(N * 8, 128) / 100 - 1.0
want = np.asarray(x).reshape(N, 8, 128).sum(0)

def run(fn, out_specs=P("tp")):
    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=P("tp"), out_specs=out_specs,
        check_vma=False))(x))

out = run(lambda v: cluster_reduce(v, "tp", Stage.LINEAR))
assert np.allclose(out, np.tile(want, (N, 1))), "LINEAR reduce"

out = run(lambda v: cluster_reduce(v, "tp", Stage.FFN))
assert np.allclose(out, np.tile(np.maximum(want, 0), (N, 1))), "FFN relu"

out = run(lambda v: cluster_gather(v, "tp"), P(None, None))
assert np.array_equal(out, np.asarray(x)), "gather"

# bf16 partials are summed in fp32 and cast back
xb = x.astype(jnp.bfloat16)
outb = np.asarray(jax.jit(shard_map(
    lambda v: cluster_reduce(v, "tp", Stage.ATTN), mesh=mesh,
    in_specs=P("tp"), out_specs=P("tp"), check_vma=False))(xb))
assert outb.dtype == jnp.bfloat16
wantb = np.asarray(xb, np.float32).reshape(N, 8, 128).sum(0)
assert np.allclose(outb.astype(np.float32), np.tile(wantb, (N, 1)),
                   rtol=1e-2, atol=1e-2), "bf16 reduce"

# determinism: two runs bit-equal (SURVEY.md §4c)
a = run(lambda v: cluster_reduce(v, "tp", Stage.ATTN))
b = run(lambda v: cluster_reduce(v, "tp", Stage.ATTN))
assert np.array_equal(a, b), "all-reduce nondeterministic"

print("COLLECTIVE_OK")
"""


def test_collectives_on_virtual_mesh():
    out = _run_cpu(SCRIPT)
    assert "COLLECTIVE_OK" in out
