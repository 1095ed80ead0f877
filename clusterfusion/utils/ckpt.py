"""Native checkpoint save/resume.

The reference is load-only (SURVEY.md §5: Meta `.pth` + post-load fused
transform, "no saving, no conversion tools").  This module closes the loop:
save a param tree — already in the kernel-native fused layout, optionally
weight-only quantized — and load it back without re-running the fusion or
quantization transforms.  Combined with ``models.checkpoint`` loaders this
is the conversion tool the reference lacks: load HF/Meta once, quantize,
save native, serve from the native artifact thereafter.

Format: a directory with ``manifest.json`` (config + tree structure +
QuantizedTensor aux data) and one ``.npz`` holding every leaf.  No orbax
dependency; arrays are written via numpy and reloaded as jax arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.ops.quant import QuantizedTensor

# v2: int4 nibble pairing changed from split-halves (b, b+K/2) to ADJACENT
# (2b, 2b+1) (ops/quant.py).  v1 quantized
# checkpoints would silently dequantize wrong, so the version check refuses
# them; requantize from the source weights.
_FORMAT_VERSION = 2


def _flatten(tree, prefix="") -> Dict[str, Any]:
    """Flatten a params dict into {path: leaf}; QuantizedTensor leaves keep
    their identity (returned whole, not decomposed)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def save_checkpoint(path: str, params, cfg: LlamaConfig) -> None:
    """Write params (possibly quantized) + config to ``path`` (a dir)."""
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(params)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "format_version": _FORMAT_VERSION,
        "config": dataclasses.asdict(cfg),
        "leaves": {},
    }
    for name, leaf in leaves.items():
        key = name.replace("/", ".")
        if isinstance(leaf, QuantizedTensor):
            arrays[key + ".q"] = np.asarray(jax.device_get(leaf.q))
            arrays[key + ".s"] = np.asarray(jax.device_get(leaf.s))
            manifest["leaves"][name] = {
                "quantized": True, "kind": leaf.kind, "axis": leaf.axis,
                "group_size": leaf.group_size, "pack_axis": leaf.pack_axis,
            }
        else:
            arr = np.asarray(jax.device_get(leaf))
            if arr.dtype == jnp.bfloat16:
                arrays[key] = arr.view(np.uint16)
                manifest["leaves"][name] = {"quantized": False,
                                            "dtype": "bfloat16"}
            else:
                arrays[key] = arr
                manifest["leaves"][name] = {"quantized": False,
                                            "dtype": str(arr.dtype)}
    np.savez(os.path.join(path, "weights.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_native_checkpoint(path: str) -> Tuple[Dict, LlamaConfig]:
    """Load a ``save_checkpoint`` directory → (params, cfg)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    got = manifest["format_version"]
    assert got == _FORMAT_VERSION, (
        f"checkpoint format v{got} != v{_FORMAT_VERSION}: the int4 nibble "
        f"layout changed in v2 (adjacent pairing) — requantize and re-save")
    cfg = LlamaConfig(**manifest["config"])
    data = np.load(os.path.join(path, "weights.npz"))
    flat: Dict[str, Any] = {}
    for name, meta in manifest["leaves"].items():
        key = name.replace("/", ".")
        if meta["quantized"]:
            flat[name] = QuantizedTensor(
                jnp.asarray(data[key + ".q"]),
                jnp.asarray(data[key + ".s"]),
                meta["kind"], meta["axis"], meta["group_size"],
                meta["pack_axis"])
        elif meta["dtype"] == "bfloat16":
            flat[name] = jnp.asarray(data[key].view(jnp.bfloat16))
        else:
            flat[name] = jnp.asarray(data[key])
    return _unflatten(flat), cfg
