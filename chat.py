"""Streaming chat CLI — twin of the reference harness (`chat/chat.py`):
loads a model, streams a completion, prints total time and tokens/sec.

Usage:
    python chat.py --ckpt_dir <meta-or-hf dir> --tokenizer_path <spm.model|dir>
    python chat.py --synthetic          # random tiny model, byte tokenizer
"""

from __future__ import annotations

import argparse
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", type=str, default=None)
    ap.add_argument("--tokenizer_path", type=str, default=None)
    ap.add_argument("--prompt", type=str,
                    default="Tell me the story about computer science.")
    ap.add_argument("--temperature", type=float, default=0.6)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--max_seq_len", type=int, default=1024)
    ap.add_argument("--max_gen_len", type=int, default=512)
    ap.add_argument("--synthetic", action="store_true",
                    help="random weights + byte tokenizer (no checkpoint)")
    ap.add_argument("--quant", type=str, default=None,
                    choices=["int8", "int4"],
                    help="weight-only quantization")
    ap.add_argument("--kv_fp8", action="store_true",
                    help="store the KV cache as float8_e4m3")
    ap.add_argument("--kv_int8", action="store_true",
                    help="store the KV cache as int8 + per-position scales")
    ap.add_argument("--spec_draft", type=str, default=None,
                    help="draft checkpoint dir for speculative decoding "
                         "('synthetic' for a random tiny draft); forces "
                         "greedy sampling")
    ap.add_argument("--n_draft", type=int, default=4,
                    help="draft tokens per speculative round")
    args = ap.parse_args()

    from clusterfusion.config import LlamaConfig
    from clusterfusion.models.generation import Llama
    from clusterfusion.utils.compile_cache import enable_compile_cache

    import jax.numpy as jnp

    enable_compile_cache()
    kv_dtype = ("int8" if args.kv_int8
                else jnp.float8_e4m3fn if args.kv_fp8 else jnp.bfloat16)
    if args.synthetic:
        cfg = LlamaConfig.tiny(max_seq_len=args.max_seq_len)
        gen = Llama.synthetic(cfg, quant=args.quant,
                              kv_dtype=kv_dtype)
    else:
        assert args.ckpt_dir and args.tokenizer_path, \
            "--ckpt_dir/--tokenizer_path required (or --synthetic)"
        gen = Llama.build(args.ckpt_dir, args.tokenizer_path,
                          max_seq_len=args.max_seq_len,
                          quant=args.quant, kv_dtype=kv_dtype)

    draft = None
    if args.spec_draft == "synthetic":
        dcfg = LlamaConfig.tiny(max_seq_len=args.max_seq_len)
        draft = Llama.synthetic(dcfg, seed=1)
    elif args.spec_draft:
        draft = Llama.build(args.spec_draft, args.tokenizer_path,
                            max_seq_len=args.max_seq_len)

    toks = gen.tokenizer.encode(args.prompt, bos=True, eos=False)
    print(f"[prompt: {len(toks)} tokens"
          + (f" | quant={args.quant}" if args.quant else "")
          + (" | kv=fp8" if args.kv_fp8 else "")
          + (" | kv=int8" if args.kv_int8 else "")
          + (f" | spec n_draft={args.n_draft}" if draft else "") + "]")
    t0 = time.perf_counter()
    if draft is not None:
        out = gen.spec_generate(toks, args.max_gen_len, draft,
                                n_draft=args.n_draft)
        n = len(out)
        sys.stdout.write(gen.tokenizer.decode(out))
        sys.stdout.flush()
        dt = time.perf_counter() - t0
        st = gen.spec_stats
        print(f"\n\n[{n} tokens in {dt:.2f}s -> {n / dt:.2f} tokens/sec | "
              f"{st['rounds']} rounds, {st['accepted_drafts']} drafts "
              f"accepted]")
        return
    n = 0
    pieces = []
    for t in gen.stream_generate(toks, args.max_gen_len, args.temperature,
                                 args.top_p):
        n += 1
        pieces.append(t)
        sys.stdout.write(gen.tokenizer.decode([t]))
        sys.stdout.flush()
    dt = time.perf_counter() - t0
    print(f"\n\n[{n} tokens in {dt:.2f}s -> {n / dt:.2f} tokens/sec]")


if __name__ == "__main__":
    main()
