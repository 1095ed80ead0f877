#!/usr/bin/env bash
# A quantized operating point (beyond the reference): INT4 weights + INT8
# KV cache.
set -euo pipefail

export MODEL_PATH=${MODEL_PATH:-/models/llama-2-7b-chat}
export TOKENIZER_PATH=${TOKENIZER_PATH:-/models/llama-2-7b/tokenizer.model}

python "$(dirname "$0")/../chat.py" \
  --ckpt_dir "$MODEL_PATH" \
  --tokenizer_path "$TOKENIZER_PATH" \
  --quant int4 --kv_int8 \
  --max_seq_len 1024 \
  --max_gen_len 1024
