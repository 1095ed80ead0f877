#!/usr/bin/env bash
# Chat launch — twin of the reference's scripts/llama2.sh and
# scripts/llama2_clusterfusion.sh (one JAX process drives the GPU; there is
# no process launcher and no fused/unfused switch).
set -euo pipefail

export MODEL_PATH=${MODEL_PATH:-/models/llama-2-7b-chat}
export TOKENIZER_PATH=${TOKENIZER_PATH:-/models/llama-2-7b/tokenizer.model}

python "$(dirname "$0")/../chat.py" \
  --ckpt_dir "$MODEL_PATH" \
  --tokenizer_path "$TOKENIZER_PATH" \
  --max_seq_len 1024 \
  --max_gen_len 1024
