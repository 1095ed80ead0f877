"""Op layer: the reference's public ops (`include/`, SURVEY.md §2.2) in
plain JAX, the paged-attention kernel of the serving engine, quantization
formats, and the fp32 oracles everything is tested against."""

from clusterfusion.ops.layers import (
    deepseek_decoder_layer,
    fused_add_rmsnorm,
    llama_decoder_layer,
    llama_decoder_layer_batch_decode_sglang,
    llama_decoder_layer_sglang,
    rmsnorm,
)
from clusterfusion.ops.quant import (
    QuantizedTensor,
    maybe_dequantize,
    quantize,
    quantize_int4,
    quantize_int8,
    quantize_llama_params,
)

__all__ = [
    "rmsnorm",
    "fused_add_rmsnorm",
    "llama_decoder_layer",
    "llama_decoder_layer_sglang",
    "llama_decoder_layer_batch_decode_sglang",
    "deepseek_decoder_layer",
    "QuantizedTensor",
    "maybe_dequantize",
    "quantize",
    "quantize_int4",
    "quantize_int8",
    "quantize_llama_params",
]
