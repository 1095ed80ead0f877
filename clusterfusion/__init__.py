"""ClusterFusion in JAX: LLM decode and serving built around the fused
decoder layer of ClusterFusion (arXiv:2508.18850; reference CUDA
implementation surveyed in SURVEY.md).

The public op surface mirrors the reference python package
(`clusterfusion/__init__.py:6-16` + `include/pybind.cpp:108-123` in the
reference tree):

- ``llama_decoder_layer``          — attention half, GPT-J interleaved RoPE
- ``llama_decoder_layer_sglang``   — attention half, NEOX RoPE +
                                     fused residual-add, runtime eps
- ``llama_decoder_layer_batch_decode_sglang`` — batched decode with paged KV
- ``deepseek_decoder_layer``       — DeepSeek-V2 MLA decode layer
- ``rmsnorm``                      — standalone batched RMSNorm

Everything is JAX compiled by XLA, except the serving engine's paged
attention, which is a Pallas kernel on the Triton route on a CUDA device
(``ops.paged_attention``).  Across devices the reference's cluster
reductions become ``lax.psum`` collectives (``clusterfusion.parallel``).
"""

from clusterfusion.config import (
    LlamaConfig,
    DeepSeekConfig,
    MeshConfig,
)
from clusterfusion.ops import (
    rmsnorm,
    fused_add_rmsnorm,
    llama_decoder_layer,
    llama_decoder_layer_sglang,
    llama_decoder_layer_batch_decode_sglang,
    deepseek_decoder_layer,
    QuantizedTensor,
    quantize_llama_params,
)

from clusterfusion.runtime import PagedKVScheduler, ServingEngine

__version__ = "0.1.0"

__all__ = [
    "LlamaConfig",
    "DeepSeekConfig",
    "MeshConfig",
    "rmsnorm",
    "fused_add_rmsnorm",
    "llama_decoder_layer",
    "llama_decoder_layer_sglang",
    "llama_decoder_layer_batch_decode_sglang",
    "deepseek_decoder_layer",
    "QuantizedTensor",
    "quantize_llama_params",
    "PagedKVScheduler",
    "ServingEngine",
]
