"""Generation engine — twin of the reference `Llama` class
(`chat/llama/generation.py`): build / generate / stream_generate /
text_completion / chat_completion with top-p sampling and llama-2 [INST]
dialog templating.

Differences: no process groups to initialize (sharding is declarative; see
``clusterfusion.parallel``), caches are functional values threaded
through a jitted decode step, and there is one decode path — the
reference's fused-vs-eager switch (``USE_CLUSTER_FUSION``, `model.py:273`)
has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Generator, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.models import llama as model
from clusterfusion.models.sampling import sample
from clusterfusion.models.tokenizer import load_tokenizer

# llama-2 chat templating tokens (`generation.py:331-344`)
B_INST, E_INST = "[INST]", "[/INST]"
B_SYS, E_SYS = "<<SYS>>\n", "\n<</SYS>>\n\n"


@dataclasses.dataclass
class GenStats:
    prompt_tokens: int = 0
    gen_tokens: int = 0
    total_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.gen_tokens / self.total_s if self.total_s else 0.0


class Llama:
    """Decode engine around the functional model."""

    def __init__(self, params, cfg: LlamaConfig, tokenizer,
                 quant: Optional[str] = None,
                 kv_dtype=jnp.bfloat16):
        """quant: None | "int8" | "int4" — weight-only quantization;
        kv_dtype: bf16, ``jnp.float8_e4m3fn`` or "int8" (Int8KV) KV cache.
        Both are capabilities beyond the fp16-only reference (SURVEY.md §7
        step 6)."""
        if quant:
            from clusterfusion.ops.quant import quantize_llama_params
            params = quantize_llama_params(params, quant)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype
        self.stats = GenStats()

    # -- construction --------------------------------------------------------

    @staticmethod
    def build(ckpt_dir: str, tokenizer_path: str, max_seq_len: int = 2048,
              max_batch_size: int = 1, dtype=jnp.bfloat16,
              quant: Optional[str] = None,
              kv_dtype=jnp.bfloat16) -> "Llama":
        """Mirror of `Llama.build` (`generation.py:52-127`); max_batch_size
        kept for signature parity (``generate`` sizes its engine from the
        prompts it is given)."""
        from clusterfusion.models.checkpoint import load_checkpoint
        params, cfg = load_checkpoint(ckpt_dir, max_seq_len, dtype)
        tokenizer = load_tokenizer(tokenizer_path)
        return Llama(params, cfg, tokenizer, quant=quant, kv_dtype=kv_dtype)

    @staticmethod
    def synthetic(cfg: LlamaConfig, seed: int = 0,
                  quant: Optional[str] = None,
                  kv_dtype=jnp.bfloat16) -> "Llama":
        """Random-weight engine with a byte tokenizer — hermetic e2e testing
        and benchmarking without a checkpoint."""
        params = model.init_params(cfg, jax.random.PRNGKey(seed))
        return Llama(params, cfg, load_tokenizer("bytes"), quant=quant,
                     kv_dtype=kv_dtype)

    # -- core loops -----------------------------------------------------------

    def _decode_one(self, k_cache, v_cache, token, pos):
        # donating variant: cache appends are in-place on device
        return model.decode_step_donated(self.params, k_cache, v_cache,
                                         token, pos, self.cfg)

    def stream_generate(self, prompt_tokens: Sequence[int],
                        max_gen_len: int, temperature: float = 0.6,
                        top_p: float = 0.9, seed: int = 0,
                        echo: bool = False) -> Generator[int, None, None]:
        """Yield tokens one at a time (`generation.py:233-271`)."""
        cfg = self.cfg
        toks = list(prompt_tokens)
        assert len(toks) + max_gen_len <= cfg.max_seq_len, "exceeds max_seq_len"
        k_cache, v_cache = model.init_cache(cfg, dtype=self.kv_dtype)

        t0 = time.perf_counter()
        logits, k_cache, v_cache = model.prefill(
            self.params, k_cache, v_cache, jnp.asarray(toks, jnp.int32), cfg)
        key = jax.random.PRNGKey(seed)
        key, sub = jax.random.split(key)
        tok = sample(sub, logits[-1], temperature, top_p)

        if echo:
            yield from toks
        pos = len(toks)
        n_gen = 0
        for _ in range(max_gen_len):
            t = int(tok)
            yield t
            n_gen += 1
            if t == self.tokenizer.eos_id:
                break
            logits, k_cache, v_cache = self._decode_one(
                k_cache, v_cache, jnp.asarray(t, jnp.int32),
                jnp.asarray(pos, jnp.int32))
            key, sub = jax.random.split(key)
            tok = sample(sub, logits, temperature, top_p)
            pos += 1
        self.stats = GenStats(len(toks), n_gen, time.perf_counter() - t0)

    def spec_generate(self, prompt_tokens: Sequence[int], max_gen_len: int,
                      draft: "Llama", n_draft: int = 4,
                      rounds_per_dispatch: int = 1) -> List[int]:
        """Greedy speculative decode with ``draft`` as the proposal model.

        Emits exactly the greedy stream of this (target) model — the draft
        only changes how many target forwards it takes (see
        models.speculative).  Sets ``self.spec_stats`` with per-run
        acceptance counters.  ``rounds_per_dispatch > 1`` amortizes
        dispatch overhead but costs a +3 GB HBM temp at 7B-bf16 scale
        (see the memory note in models.speculative)."""
        from clusterfusion.models import speculative as spec_mod
        cfg = self.cfg
        toks = list(prompt_tokens)
        span = n_draft + 1
        t0 = time.perf_counter()
        k_cache, v_cache = model.init_cache(cfg, dtype=self.kv_dtype)
        logits, k_cache, v_cache = model.prefill(
            self.params, k_cache, v_cache, jnp.asarray(toks, jnp.int32), cfg)
        kd, vd = model.init_cache(draft.cfg, dtype=draft.kv_dtype)
        _, kd, vd = model.prefill(draft.params, kd, vd,
                                  jnp.asarray(toks, jnp.int32), draft.cfg)
        tok = jnp.argmax(logits[-1]).astype(jnp.int32)
        out = [int(tok)]
        pos = len(toks)
        rounds = accepted = 0
        eos = self.tokenizer.eos_id
        while len(out) < max_gen_len and out[-1] != eos:
            # cache budget: round r writes rows up to pos + (r-1)·span + n_draft
            cap_rounds = (cfg.max_seq_len - 1 - n_draft - pos) // span + 1
            r = min(rounds_per_dispatch, cap_rounds)
            if r < 1:
                break
            targets, counts, k_cache, v_cache, kd, vd = \
                spec_mod.spec_decode_loop(
                    self.params, k_cache, v_cache, draft.params, kd, vd,
                    tok, jnp.asarray(pos, jnp.int32), cfg, draft.cfg,
                    n_draft=n_draft, n_rounds=r)
            counts = np.asarray(counts)
            emitted = spec_mod.flatten_rounds(np.asarray(targets), counts)
            rounds += r
            accepted += int(counts.sum()) - r      # drafts accepted (excl. bonus)
            pos += int(counts.sum())
            tok = jnp.asarray(emitted[-1], jnp.int32)
            if eos in emitted:
                emitted = emitted[: emitted.index(eos) + 1]
                out.extend(emitted)
                break
            out.extend(emitted)
        out = out[:max_gen_len]
        self.stats = GenStats(len(toks), len(out), time.perf_counter() - t0)
        self.spec_stats = {"rounds": rounds, "accepted_drafts": accepted,
                           "tokens": len(out)}
        return out

    def generate(self, prompt_tokens: Sequence[Sequence[int]],
                 max_gen_len: int, temperature: float = 0.6,
                 top_p: float = 0.9, seed: int = 0,
                 logprobs: bool = False, echo: bool = False,
                 ) -> Tuple[List[List[int]], Optional[List[List[float]]]]:
        """Batched generation (`generation.py:129-231` parity): all rows
        decode together through the continuous-batching engine — one device
        dispatch per step for the whole batch — with per-row eos stopping
        and, with ``logprobs=True``, per-token logprobs of every kept token
        (prompt tokens included under ``echo``, matching the reference's
        ``-F.cross_entropy`` accounting).

        Differences by design: rows with shorter prompts never see other
        rows' pad positions (each request owns its pages — no padded
        lockstep, so no prompt-forcing pass), and sampling consumes the
        engine's per-step PRNG stream seeded by ``seed`` rather than a
        global torch generator."""
        from clusterfusion.runtime.serving import ServingEngine
        cfg = self.cfg
        prompts = [list(t) for t in prompt_tokens]
        assert prompts and all(prompts), "empty prompt"
        assert max(len(t) for t in prompts) <= cfg.max_seq_len
        B = len(prompts)
        page = 16
        mb = 4
        while mb < B:
            mb *= 2
        need = sum(-(-min(len(t) + max_gen_len, cfg.max_seq_len) // page)
                   for t in prompts)
        eng = ServingEngine(
            self.params, cfg, page_size=page, num_pages=need + 1,
            max_batch=mb, eos_id=self.tokenizer.eos_id,
            kv_dtype=self.kv_dtype, seed=seed)
        t0 = time.perf_counter()
        for i, toks in enumerate(prompts):
            eng.submit(i, toks, min(max_gen_len,
                                    cfg.max_seq_len - len(toks)),
                       temperature, top_p, logprobs=logprobs)
        eng.run()
        out_tokens, out_logprobs = [], []
        for i, prompt in enumerate(prompts):
            req = eng.last_results[i]
            toks = list(req.generated[:max_gen_len])
            probs = list(req.logprobs[:max_gen_len]) if logprobs else None
            if echo:
                toks = prompt + toks
                if logprobs:
                    probs = list(req.prompt_logprobs) + probs
            if self.tokenizer.eos_id in toks:
                eos_idx = toks.index(self.tokenizer.eos_id)
                toks = toks[:eos_idx]
                probs = probs[:eos_idx] if logprobs else None
            out_tokens.append(toks)
            out_logprobs.append(probs)
        self.stats = GenStats(sum(len(p) for p in prompts),
                              sum(len(r.generated)
                                  for r in eng.last_results.values()),
                              time.perf_counter() - t0)
        return out_tokens, out_logprobs if logprobs else None

    # -- prompt APIs ----------------------------------------------------------

    def text_completion(self, prompts: List[str], temperature: float = 0.6,
                        top_p: float = 0.9, max_gen_len: Optional[int] = None,
                        logprobs: bool = False,
                        echo: bool = False) -> List[dict]:
        """`generation.py:274-323`: batched completion; with
        ``logprobs=True`` each prediction carries per-token strings and
        their logprobs, reference dict layout."""
        if max_gen_len is None:
            max_gen_len = self.cfg.max_seq_len - 1
        prompt_tokens = [self.tokenizer.encode(p, bos=True, eos=False)
                         for p in prompts]
        toks, lps = self.generate(prompt_tokens, max_gen_len, temperature,
                                  top_p, logprobs=logprobs, echo=echo)
        if logprobs:
            return [{"generation": self.tokenizer.decode(t),
                     "tokens": [self.tokenizer.decode([x]) for x in t],
                     "logprobs": lp}
                    for t, lp in zip(toks, lps)]
        return [{"generation": self.tokenizer.decode(t)} for t in toks]

    def chat_completion(self, dialogs: List[List[dict]],
                        temperature: float = 0.6, top_p: float = 0.9,
                        max_gen_len: Optional[int] = None,
                        logprobs: bool = False) -> List[dict]:
        """llama-2 [INST] chat templating (`generation.py:325-436`)."""
        if max_gen_len is None:
            max_gen_len = self.cfg.max_seq_len - 1
        prompt_tokens = [self._encode_dialog(d) for d in dialogs]
        toks, lps = self.generate(prompt_tokens, max_gen_len, temperature,
                                  top_p, logprobs=logprobs)
        results = []
        for i, t in enumerate(toks):
            r = {"generation": {"role": "assistant",
                                "content": self.tokenizer.decode(t)}}
            if logprobs:
                r["tokens"] = [self.tokenizer.decode([x]) for x in t]
                r["logprobs"] = lps[i]
            results.append(r)
        return results

    def _encode_dialog(self, dialog: List[dict]) -> List[int]:
        """`generation.py:352-402`: fold an optional system prompt into the
        first user turn, then alternate [INST] user [/INST] assistant."""
        if dialog and dialog[0]["role"] == "system":
            sys, rest = dialog[0], dialog[1:]
            rest = list(rest)
            rest[0] = {
                "role": rest[0]["role"],
                "content": B_SYS + sys["content"] + E_SYS + rest[0]["content"],
            }
            dialog = rest
        assert all(m["role"] == ("user" if i % 2 == 0 else "assistant")
                   for i, m in enumerate(dialog)), \
            "dialog must alternate user/assistant and end with user"
        assert dialog[-1]["role"] == "user"
        toks: List[int] = []
        for i in range(0, len(dialog) - 1, 2):
            user, ans = dialog[i], dialog[i + 1]
            toks += self.tokenizer.encode(
                f"{B_INST} {user['content'].strip()} {E_INST} "
                f"{ans['content'].strip()} ", bos=True, eos=True)
        toks += self.tokenizer.encode(
            f"{B_INST} {dialog[-1]['content'].strip()} {E_INST}",
            bos=True, eos=False)
        return toks
