"""Device mesh construction.

Axes: dcn (cross-host), dp (data), tp (tensor: attention heads + ffn
columns), sp (sequence).  The reference's only multi-device mechanism is
fairscale TP over NCCL on the *unfused* path
(`chat/llama/generation.py:86-89`); here the mesh drives both paths via
jax.sharding, and the dcn axis carries the multi-host story the reference's
single-process NCCL scope never reaches."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from clusterfusion.config import MeshConfig

AXES = ("dcn", "pp", "dp", "tp", "ep", "sp")


def build_mesh(mcfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dcn, dp, tp, sp) mesh.  Default: all of ``jax.devices()`` on
    tp (decode-oriented: weights sharded, batch usually 1).

    Single-process use (and the CPU 8-device simulation): the device list is
    reshaped directly, dcn outermost — on a virtual mesh this *models* a
    2-host topology.  Within one host the GPUs are joined all to all, so
    the order of the intra-host axes does not matter.  Real multi-host
    deployments should use :func:`build_hybrid_mesh`, which keeps each
    host's devices contiguous on the intra-host axes so only the dcn axis
    crosses hosts."""
    devices = list(devices if devices is not None else jax.devices())
    if mcfg is None:
        mcfg = MeshConfig(tp=len(devices))
    assert mcfg.n_devices == len(devices), \
        f"mesh {mcfg.shape} needs {mcfg.n_devices} devices, got {len(devices)}"
    arr = np.array(devices).reshape(mcfg.dcn, mcfg.pp, mcfg.dp, mcfg.tp,
                                    mcfg.ep, mcfg.sp)
    return Mesh(arr, AXES)


def build_hybrid_mesh(mcfg: MeshConfig) -> Mesh:
    """Build a multi-host (dcn, dp, tp, sp) mesh with DCN-aware placement.

    Uses ``mesh_utils.create_hybrid_device_mesh`` so the dcn axis maps to
    the process boundary (hosts) and dp×tp×sp stay inside each host's
    NVLink domain — the counterpart of the reference's
    `init_process_group("nccl")` + fairscale model-parallel topology
    (`chat/llama/generation.py:84-89`).  Requires ``jax.distributed`` to be
    initialized on every host; falls back to :func:`build_mesh` when there
    is only one process (e.g. the CPU simulation)."""
    if jax.process_count() == 1:
        return build_mesh(mcfg)
    from jax.experimental import mesh_utils
    arr = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=(mcfg.pp, mcfg.dp, mcfg.tp, mcfg.ep, mcfg.sp),
        dcn_mesh_shape=(mcfg.dcn, 1, 1, 1, 1),
        devices=jax.devices())
    # hybrid shape comes back (dcn*pp, dp, tp, ep, sp), dcn on the slow axis
    arr = arr.reshape(mcfg.dcn, mcfg.pp, mcfg.dp, mcfg.tp, mcfg.ep, mcfg.sp)
    return Mesh(arr, AXES)
