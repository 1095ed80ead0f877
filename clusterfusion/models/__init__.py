"""Model layer — the counterpart of the reference's `chat/llama/` stack."""

from clusterfusion.models.llama import (
    LlamaParams,
    init_params,
    fuse_attention_weights,
    prefill,
    decode_step,
    init_cache,
)
