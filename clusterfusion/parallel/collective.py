"""Device-scope collective primitives — the reference's DSM collective layer
(`include/dsm.cuh:20-171`) lifted to the device mesh.

The reference gives its fused kernels a *named, stage-specialized*
collective (`cluster_reduce<CLUSTER_SIZE, Stage>` with Stage::LINEAR / ATTN
/ FFN / QUK_DEEPSEEK ..., `dsm.cuh:11-25`) over distributed shared memory
between the CTAs of a cluster.  Across GPUs the same reduction points
become XLA collectives inside ``shard_map`` (``lax.psum`` /
``lax.all_gather``), which XLA hands to NCCL over NVLink:

- ``Stage`` — the reference's stage taxonomy, kept as documentation of
  *where* in the layer each collective sits (LINEAR: partial-QKV reduce;
  ATTN: head-output reduce; FFN: down-projection reduce with optional fused
  activation, `dsm.cuh:140-153`; QUK: all-gather of absorbed q@W_UK,
  `dsm.cuh:31-79`).
- ``cluster_reduce(x, axis_name, stage)`` — all-reduce (sum) over a mesh
  axis, accumulated in fp32.
- ``cluster_gather(x, axis_name)`` — all-gather over a mesh axis.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp


class Stage(enum.Enum):
    """Where in the decoder layer the collective sits — the reference's
    `Stage` enum (`dsm.cuh:11-18`).  All reduce-stages share one
    implementation; FFN fuses a ReLU after the sum like `dsm.cuh:140-153`
    (a shipped capability there, unused by the reference's kernels)."""

    LINEAR = "linear"            # partial-QKV all-reduce (dsm.cuh Stage::LINEAR)
    ATTN = "attn"                # head-output all-reduce (Stage::ATTN)
    FFN = "ffn"                  # down-proj all-reduce + optional act (Stage::FFN)
    LINEAR_DEEPSEEK = "linear_deepseek"
    ATTN_DEEPSEEK = "attn_deepseek"
    QUK_DEEPSEEK = "quk_deepseek"   # all-gather (dsm.cuh:31-79)


def cluster_reduce(x, axis_name: str, stage: Stage = Stage.LINEAR):
    """All-reduce (sum) over ``axis_name`` — the device-scope
    `cluster_reduce` (`dsm.cuh:20-25`).  Accumulates in fp32 regardless of
    input dtype (the reference accumulates partials in fp32 registers,
    `kernel.cuh:58-62`).  Stage::FFN applies a ReLU to the sum
    (`dsm.cuh:140-153`)."""
    out = jax.lax.psum(x.astype(jnp.float32), axis_name)
    if stage == Stage.FFN:
        out = jnp.maximum(out, 0)
    return out.astype(x.dtype)


def cluster_gather(x, axis_name: str, stage: Stage = Stage.QUK_DEEPSEEK):
    """All-gather over ``axis_name`` along axis 0 (shards concatenated in
    rank order) — the device-scope `Stage::QUK_DEEPSEEK` gather
    (`dsm.cuh:31-79`)."""
    del stage
    return jax.lax.all_gather(x, axis_name, axis=0, tiled=True)
