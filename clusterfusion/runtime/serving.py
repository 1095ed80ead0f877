"""Continuous-batching serving engine over a paged KV pool.

The reference exposes its paged batch-decode op for an external runner
(SGLang — `README.md:55-76` documents the integration; the runner itself is
not in the repo).  This engine is that runner, framework-native:

- page bookkeeping + admission live in the native C++ scheduler
  (``runtime.native.PagedKVScheduler`` over native/kv_runtime.cpp);
- the device step is one jitted program: embeddings → lax.scan over layers
  (batched M=B projections, paged attention with in-place append
  (``ops.paged_attention``), batched gated FFN) → final norm → lm head →
  per-row sampling;
- batch rows are padded to a fixed ``max_batch`` so the step compiles once
  per block-table width bucket; padding rows carry the NULL page (page 0,
  never allocated) and seq_len 0, so their writes are harmless;
- prompts are prefilled (``models.llama.prefill_chunk``) into a temporary
  contiguous cache, then the pages are scattered into the pool.

Decode keeps per-request state device-free except one [max_batch] token
fetch per step — the continuous-batching loop is host-driven like every
serving runtime, but each step is a single device dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from clusterfusion.config import LlamaConfig
from clusterfusion.config import round_up
from clusterfusion.models import llama as model
from clusterfusion.models.sampling import sample, sample_batch
from clusterfusion.ops.paged_attention import (init_paged_pool,
    paged_attention, pool_set_pages)
from clusterfusion.ops.quant import QuantizedTensor, maybe_dequantize
from clusterfusion.ops.reference import fused_add_rmsnorm_ref
from clusterfusion.runtime.native import PagedKVScheduler


class EngineHealthError(RuntimeError):
    """The decode step itself is broken (every live row failing the numeric
    watchdog for several consecutive steps) — not a per-request fault.
    Raised so the caller can fail over / restart rather than spin emitting
    garbage.  Failure-detection layer the reference lacks (SURVEY §5: it
    ignores even CUresult, `llama_kernel_dispatch.cu:48`)."""


@dataclasses.dataclass
class _Req:
    id: int
    prompt: List[int]
    max_gen_len: int
    temperature: float
    top_p: float
    cur_token: int = -1            # token to feed at the next step
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set when the request was killed by the failure detector (numeric
    # watchdog / prefill exception); partial output stays readable
    error: Optional[str] = None
    want_logprobs: bool = False
    # logprob of generated[i] (natural log, reference parity)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # logprob of prompt[i] given prompt[:i]; index 0 (bos) stays 0.0 like
    # the reference's untouched token_logprobs[:, 0]
    prompt_logprobs: List[float] = dataclasses.field(default_factory=list)


def _chosen_logprob(logits: jnp.ndarray, chosen: jnp.ndarray) -> jnp.ndarray:
    """Natural-log probability of each row's chosen token — the per-token
    ``logprobs`` the reference computes as ``-F.cross_entropy``
    (`chat/llama/generation.py:136,186-193`)."""
    lw = jax.nn.log_softmax(logits, axis=-1)
    return jnp.take_along_axis(lw, chosen[:, None], axis=-1)[:, 0]


# -- batched quant-aware projection helpers (shared by the serving step and
# -- the tp-sharded serving step in parallel.decode) ------------------------


def batched_qkv_dot(xn, w):
    """[B,h] @ [G,h,c] -> [B,G,c]; int8 scales commute with the dot
    (applied to the [B,G,c] result — int8 streams as int8, no materialized
    bf16 copy)."""
    if isinstance(w, QuantizedTensor) and w.kind == "int8":
        return (jnp.einsum("bd,Gdc->bGc", xn, w.q.astype(xn.dtype),
                           preferred_element_type=jnp.float32)
                * w.s[:, 0, :]).astype(xn.dtype)
    return jnp.einsum("bd,Gdc->bGc", xn, maybe_dequantize(w, xn.dtype),
                      preferred_element_type=jnp.float32).astype(xn.dtype)


def batched_o_dot(o3, w):
    """[B,G,c] @ [G,c,hidden] -> [B,hidden] with per-group int8 scales
    applied before the cross-group sum."""
    if isinstance(w, QuantizedTensor) and w.kind == "int8":
        y = jnp.einsum("bGc,Gco->bGo", o3, w.q.astype(o3.dtype),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * w.s[:, 0, :], axis=1)
    return jnp.einsum("bGc,Gco->bo", o3, maybe_dequantize(w, o3.dtype),
                      preferred_element_type=jnp.float32)


def batched_layer(x, res, lw, l, kp, vp, table, pool_l, seq_lens, cos, sin,
                  cfg: LlamaConfig, window, reduce=lambda y: y):
    """One decoder layer for a batch of single-token rows.

    ``l`` indexes the weight stacks, ``pool_l`` the KV pools (they differ
    for Gemma-2's split pools), ``table`` the matching block table;
    ``window`` is this layer's sliding window (0 = full context).  The head
    count comes from the weights, so a tp shard runs its own heads; its
    partial sums go through ``reduce`` (see ``models.llama.ffn_block``)."""
    B = x.shape[0]
    g, hd = cfg.n_heads // cfg.kv_heads, cfg.head_dim_
    p = jax.tree.map(
        lambda a: jax.lax.dynamic_index_in_dim(a, l, 0, keepdims=False), lw)
    with jax.named_scope("attention"):
        xn, res = fused_add_rmsnorm_ref(x, res, p["attn_norm"], cfg.norm_eps)
        y = batched_qkv_dot(xn, p["wqkv_f"])          # [B, kv, (g+2)*hd]
        if "bqkv_f" in p:                             # Qwen2 QKV bias
            y = y + p["bqkv_f"][None].astype(y.dtype)
        y = y.reshape(B, -1, (g + 2) * hd)
        q = y[..., : g * hd].reshape(B, -1, g, hd)
        k = y[..., g * hd:(g + 1) * hd]
        v = y[..., (g + 1) * hd:]
        q = model._apply_rope(q, cos[:, None, None, :], sin[:, None, None, :],
                              cfg.rope_style)
        k = model._apply_rope(k, cos[:, None, :], sin[:, None, :],
                              cfg.rope_style)
        o, kp, vp = paged_attention(q, k, v, kp, vp, table, seq_lens, pool_l,
                                    window=window,
                                    softcap=cfg.attn_logit_softcap)
        G = p["wo_f"].shape[0]
        attn = batched_o_dot(o.reshape(B, G, -1), p["wo_f"]).astype(x.dtype)
    h, res = model.ffn_block(attn, res, p, cfg, reduce)
    return h.astype(x.dtype), res.astype(x.dtype), kp, vp


def _paged_decode_step(params, k_pool, v_pool, tokens, positions,
                       block_table, seq_lens, key, temperatures, top_ps,
                       cfg: LlamaConfig, k_pool_loc=None, v_pool_loc=None,
                       table_loc=None, split_pools: bool = False):
    """One batched decode step.  tokens/positions/seq_lens: [B] int32,
    block_table: [B, P] int32, temperatures/top_ps: [B] f32 (per-request
    sampling params, traced).  Returns (next_tokens [B], logprobs [B],
    k_pool', v_pool'[, k_pool_loc', v_pool_loc']).

    The projections, O-projection, FFN and LM head are batched M=B
    matmuls, so each weight streams once per step for the whole batch.

    ``split_pools`` (Gemma-2 ``window_pattern="even"`` rolling-buffer
    serving): the windowed EVEN layers read/append a separate
    O(window·batch) ring pool (``k_pool_loc``/``v_pool_loc`` with the
    per-slot ring ``table_loc`` built by the engine), while the
    full-context ODD layers keep the scheduler-managed ``k_pool``; both
    pools are then [L/2, pages, ...] and the layer scan walks PAIRS, so
    even-layer serving memory is capped at the window regardless of
    context length.
    """
    cos_t, sin_t = model.rope_table(cfg)
    cos = cos_t[positions]                            # [B, hd]
    sin = sin_t[positions]
    x = params["embed"][tokens]                       # [B, hidden]
    residual = jnp.zeros_like(x)
    lw = params["layers"]

    if split_pools:
        def pair(carry, i):
            x, res, kpg, vpg, kpl, vpl = carry
            x, res, kpl, vpl = batched_layer(
                x, res, lw, 2 * i, kpl, vpl, table_loc, i, seq_lens, cos,
                sin, cfg, cfg.sliding_window)
            x, res, kpg, vpg = batched_layer(
                x, res, lw, 2 * i + 1, kpg, vpg, block_table, i, seq_lens,
                cos, sin, cfg, 0)
            return (x, res, kpg, vpg, kpl, vpl), None

        pair_idx = jnp.arange(cfg.n_layers // 2, dtype=jnp.int32)
        (x, residual, k_pool, v_pool, k_pool_loc, v_pool_loc), _ = \
            jax.lax.scan(pair, (x, residual, k_pool, v_pool,
                                k_pool_loc, v_pool_loc), pair_idx)
    else:
        def layer(carry, l):
            x, res, kp, vp = carry
            x, res, kp, vp = batched_layer(
                x, res, lw, l, kp, vp, block_table, l, seq_lens, cos, sin,
                cfg, model.layer_window(cfg, l))
            return (x, res, kp, vp), None

        layer_idx = jnp.arange(cfg.n_layers, dtype=jnp.int32)
        (x, residual, k_pool, v_pool), _ = jax.lax.scan(
            layer, (x, residual, k_pool, v_pool), layer_idx)
    xn, _ = fused_add_rmsnorm_ref(x, residual, params["final_norm"],
                                  cfg.norm_eps)
    logits = model._lm_logits(xn, params["lm_head"])
    if cfg.final_logit_softcap:
        _c = cfg.final_logit_softcap
        logits = _c * jnp.tanh(logits / _c)
    nxt = sample_batch(key, logits, temperatures, top_ps).astype(jnp.int32)
    if split_pools:
        return (nxt, _chosen_logprob(logits, nxt), k_pool, v_pool,
                k_pool_loc, v_pool_loc)
    return nxt, _chosen_logprob(logits, nxt), k_pool, v_pool


@functools.partial(jax.jit, static_argnames=())
def _prompt_logprobs(logits: jnp.ndarray, targets: jnp.ndarray):
    """logprob of ``targets[t]`` under ``logits[t]`` (the prefill logits row
    that predicts it) — the prompt-echo side of the reference's logprobs
    (`chat/llama/generation.py:179-193`).  [T, vocab], [T] -> [T]."""
    return _chosen_logprob(logits, targets.astype(jnp.int32))


# One jitted step per (model geometry, pool mode) — shared across engine
# instances so a short-lived engine (e.g. one built per ``Llama.generate``
# call) doesn't pay a fresh trace + compile.
_STEP_CACHE: Dict = {}


def _jitted_step(cfg: LlamaConfig, split_pools: bool):
    key = (cfg, split_pools)
    fn = _STEP_CACHE.get(key)
    if fn is None:
        if split_pools:
            # the caller passes k_pool_loc / v_pool_loc / table_loc as
            # KEYWORDS; local pools donated alongside the global ones
            fn = jax.jit(functools.partial(_paged_decode_step, cfg=cfg,
                                           split_pools=True),
                         donate_argnums=(1, 2),
                         donate_argnames=("k_pool_loc", "v_pool_loc"))
        else:
            fn = jax.jit(functools.partial(_paged_decode_step, cfg=cfg),
                         donate_argnums=(1, 2))
        _STEP_CACHE[key] = fn
    return fn


class ServingEngine:
    """Continuous-batching decode over a paged KV pool.

    >>> eng = ServingEngine(params, cfg, page_size=16, num_pages=512)
    >>> eng.submit(0, prompt_tokens, max_gen_len=64)
    >>> outputs = eng.run()     # {req_id: [generated tokens]}
    """

    def __init__(self, params, cfg: LlamaConfig, *,
                 page_size: int = 16, num_pages: int = 256,
                 max_batch: int = 8, max_pages_per_req: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 kv_dtype=jnp.bfloat16, seed: int = 0,
                 prefill_chunk: Optional[int] = 1024):
        """``kv_dtype``: pool storage — bf16, ``jnp.float8_e4m3fn``, or
        "int8" for :class:`~clusterfusion.ops.quant.Int8KV` pools."""
        if max_pages_per_req is None:
            max_pages_per_req = round_up(cfg.max_seq_len, page_size) // page_size
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        self.page_size = page_size
        # chunk must divide every power-of-two bucket it splits
        assert prefill_chunk is None or (prefill_chunk & (prefill_chunk - 1)) == 0
        self.prefill_chunk = prefill_chunk
        self.sched = PagedKVScheduler(num_pages, page_size, max_pages_per_req)
        if cfg.sliding_window and cfg.window_pattern == "all":
            # rolling page buffer: a windowed request owns at most
            # ceil(window/page)+1 real pages regardless of context length
            # (the +1 is the filling tail page); below-window block-table
            # slots hold the NULL page, which the window-aware attention
            # never reads.  set_window derives + validates the page cap
            # from the token window (recycle-safety contract in native.py).
            self.sched.set_window(cfg.sliding_window)
        self.max_batch = max_batch
        # gemma-2 interleaved local/global serving: split pools — windowed
        # EVEN layers live in a fixed-size per-slot ring pool of
        # max_batch·(ceil(window/page)+1) pages (O(window·batch) memory
        # regardless of context), while the full-context ODD layers keep
        # the scheduler-managed pool, now only L/2 layers deep.
        self.evenwin = bool(cfg.sliding_window) \
            and cfg.window_pattern == "even"
        if self.evenwin:
            assert cfg.n_layers % 2 == 0, cfg.n_layers
            self.window_pages = -(-cfg.sliding_window // page_size) + 1
            Lh = cfg.n_layers // 2
            shape = (Lh, num_pages, cfg.kv_heads, page_size, cfg.head_dim_)
            n_loc = max_batch * self.window_pages + 1      # page 0 = NULL
            shape_loc = (Lh, n_loc, cfg.kv_heads, page_size, cfg.head_dim_)
            self.k_pool_loc = init_paged_pool(shape_loc, kv_dtype)
            self.v_pool_loc = init_paged_pool(shape_loc, kv_dtype)
            # ring slots: request -> fixed page range in the local pool
            self._slot_of: Dict[int, int] = {}
            self._free_slots: List[int] = list(range(max_batch))
            self._batch_ids: set = set()
        else:
            shape = (cfg.n_layers, num_pages, cfg.kv_heads, page_size,
                     cfg.head_dim_)
        self.k_pool = init_paged_pool(shape, kv_dtype)
        self.v_pool = init_paged_pool(shape, kv_dtype)
        self._reqs: Dict[int, _Req] = {}
        self._key = jax.random.PRNGKey(seed)
        self._step = _jitted_step(cfg, self.evenwin)
        # failure detection (SURVEY §5): consecutive fully-failed steps
        # before the engine declares itself unhealthy
        self._bad_steps = 0
        self.max_bad_steps = 3

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req_id: int, prompt_tokens: Sequence[int],
               max_gen_len: int, temperature: float = 0.0,
               top_p: float = 0.9, logprobs: bool = False) -> None:
        prompt = list(prompt_tokens)
        assert prompt, "empty prompt"
        self._reqs[req_id] = _Req(req_id, prompt, max_gen_len,
                                  temperature, top_p, want_logprobs=logprobs)
        self.sched.add(req_id, len(prompt))

    def _prefill_into_pool(self, req: _Req) -> None:
        """Eager prefill of the request's cached tokens, pages scattered into
        the pool, and — for a first admission — the first generated token
        sampled from the prompt logits.

        On RE-admission after a recompute preemption (``req.generated``
        non-empty), the scheduler freed the pages but kept ``len`` = cached
        tokens = prompt + generated[:-1] (the last generated token is
        ``cur_token``, not yet fed through the model).  Those tokens are
        re-prefilled verbatim and decode resumes at ``cur_token`` — no new
        token is sampled, matching the vLLM-style recompute policy
        (native/kv_runtime.cpp prepare_batch step 1).

        The token run is zero-padded to a power-of-two page count so prefill
        compiles per BUCKET, not per token-run length (causality makes the
        padding inert: logits at T-1 and KV rows < T are unaffected, and
        rows >= T are masked by seq_len everywhere downstream).

        Runs longer than ``prefill_chunk`` go as fixed-size chunks
        (``model.prefill_chunk``): compile variants stay
        bounded by max_seq/chunk instead of one per bucket, and activation
        memory is O(chunk), not O(prompt)."""
        cfg, page = self.cfg, self.page_size
        readmit = bool(req.generated)
        cached = req.prompt + (req.generated[:-1] if readmit else [])
        T = len(cached)
        n_bucket = 1
        while n_bucket * page < T:
            n_bucket *= 2
        cap = n_bucket * page
        prompt_pad = cached + [0] * (cap - T)
        # bf16 staging cache: the pool's own format is applied when the
        # pages are scattered in
        kc = jnp.zeros((cfg.n_layers, cfg.kv_heads, cap, cfg.head_dim_),
                       jnp.bfloat16)
        vc = jnp.zeros_like(kc)
        want_plp = req.want_logprobs and not readmit
        chunk = self.prefill_chunk
        if chunk and cap > chunk:
            toks = jnp.asarray(prompt_pad, jnp.int32)
            n_real = round_up(T, chunk)        # skip all-padding tail chunks
            plp_parts = []
            for p0 in range(0, n_real, chunk):
                logits, kc, vc = model.prefill_chunk(
                    self.params, kc, vc, toks[p0:p0 + chunk], cfg, pos0=p0)
                if want_plp:
                    # logits row t predicts cached[p0+t+1]
                    tgt = jnp.asarray(
                        (cached + [0])[p0 + 1: p0 + chunk + 1]
                        + [0] * max(0, p0 + chunk + 1 - len(cached) - 1),
                        jnp.int32)
                    plp_parts.append(np.asarray(
                        _prompt_logprobs(logits, tgt[:chunk])))
            last_logits = logits[(T - 1) - (n_real - chunk)]
            if want_plp:
                flat = np.concatenate(plp_parts)
                req.prompt_logprobs = [0.0] + [float(v)
                                               for v in flat[:T - 1]]
        else:
            logits, kc, vc = model.prefill(
                self.params, kc, vc, jnp.asarray(prompt_pad, jnp.int32), cfg)
            last_logits = logits[T - 1]
            if want_plp:
                tgt = jnp.asarray(cached[1:] + [0] * (cap - T + 1), jnp.int32)
                plp = np.asarray(_prompt_logprobs(logits, tgt))
                req.prompt_logprobs = [0.0] + [float(v)
                                               for v in plp[:T - 1]]
        owned = self.sched.request_pages(req.id)
        n_used = min(len(owned), cap // page)
        pages = owned[:n_used]

        def to_pages(c, j0, j1):
            """cache [Lx, kv, cap, hd] rows [j0·page, j1·page) as page
            blocks [Lx, j1-j0, kv, page, hd]."""
            return (c[:, :, j0 * page: j1 * page]
                    .reshape(c.shape[0], cfg.kv_heads, j1 - j0, page,
                             cfg.head_dim_).transpose(0, 2, 1, 3, 4))

        pages_j = jnp.asarray(np.asarray(pages), jnp.int32)
        if self.evenwin:
            # odd (full-context) layers -> scheduler pages of the global
            # pool; even (windowed) layers -> this request's ring slot in
            # the local pool: absolute page j lands at base + (j mod wp),
            # only pages holding in-window rows are written (older ring
            # content is out-of-window and never read)
            self.k_pool = pool_set_pages(self.k_pool, pages_j,
                                         to_pages(kc[1::2], 0, n_used))
            self.v_pool = pool_set_pages(self.v_pool, pages_j,
                                         to_pages(vc[1::2], 0, n_used))
            wp = self.window_pages
            slot = self._ensure_slot(req.id)
            base = 1 + slot * wp
            j_hi = -(-T // page)                   # pages with real rows
            j_lo = max(0, (T + 1 - cfg.sliding_window) // page)
            ring = np.asarray([base + (j % wp) for j in range(j_lo, j_hi)],
                              np.int32)
            self.k_pool_loc = pool_set_pages(self.k_pool_loc, ring,
                                             to_pages(kc[0::2], j_lo, j_hi))
            self.v_pool_loc = pool_set_pages(self.v_pool_loc, ring,
                                             to_pages(vc[0::2], j_lo, j_hi))
        else:
            self.k_pool = pool_set_pages(self.k_pool, pages_j,
                                         to_pages(kc, 0, n_used))
            self.v_pool = pool_set_pages(self.v_pool, pages_j,
                                         to_pages(vc, 0, n_used))
        if readmit:
            # resume mid-generation: the next step feeds the last generated
            # token; sampling again would duplicate a token in the output
            req.cur_token = req.generated[-1]
            return
        self._key, sub = jax.random.split(self._key)
        tok = int(sample(sub, last_logits, req.temperature, req.top_p))
        req.cur_token = tok
        req.generated.append(tok)
        if req.want_logprobs:
            req.logprobs.append(float(_prompt_logprobs(
                last_logits[None], jnp.asarray([tok], jnp.int32))[0]))
        self._maybe_finish(req)

    def _ensure_slot(self, req_id: int) -> int:
        """Ring slot for a request in evenwin mode.  Slots are fixed page
        ranges in the local pool; at most ``max_batch`` requests are ever
        in a prepared batch, so a slot can always be found — if the free
        list is empty, steal one from a request NOT in the current batch
        (such a request was preempted under the recompute policy: its
        pages are freed and its next admission re-prefills from scratch,
        ring included)."""
        s = self._slot_of.get(req_id)
        if s is not None:
            return s
        if not self._free_slots:
            victim = next(r for r in self._slot_of
                          if r not in self._batch_ids)
            self._free_slots.append(self._slot_of.pop(victim))
        s = self._free_slots.pop()
        self._slot_of[req_id] = s
        return s

    def _release(self, req_id: int) -> None:
        """Free scheduler pages and (evenwin) the ring slot."""
        self.sched.release(req_id)
        if self.evenwin:
            s = self._slot_of.pop(req_id, None)
            if s is not None:
                self._free_slots.append(s)

    def _fail(self, req: _Req, msg: str) -> None:
        """Kill ONE request (numeric fault / prefill exception): evict it,
        keep its partial output + error readable, keep the engine serving.
        The reference has no failure story at all (SURVEY §5)."""
        req.error = msg
        if not req.done:
            req.done = True
            self._release(req.id)

    def _maybe_finish(self, req: _Req) -> None:
        hit_eos = self.eos_id is not None and req.generated \
            and req.generated[-1] == self.eos_id
        total = len(req.prompt) + len(req.generated)
        if (hit_eos or len(req.generated) >= req.max_gen_len
                or total > self.sched.max_tokens):
            req.done = True
            self._release(req.id)

    # -- decode loop -----------------------------------------------------------

    def step(self) -> bool:
        """One continuous-batching iteration: admit/grow/preempt via the
        native scheduler, prefill fresh rows, run one fused decode step for
        the whole batch, sample, commit.  Returns False when idle."""
        ids, table, lens, poss, fresh = self.sched.prepare_batch(
            self.max_batch)
        B = len(ids)
        if B == 0:
            return False
        if self.evenwin:
            self._batch_ids = {int(i) for i in ids}

        for b in range(B):
            if fresh[b]:
                req = self._reqs[int(ids[b])]
                try:
                    self._prefill_into_pool(req)
                except Exception as e:
                    # per-request fault isolation: a failing prefill kills
                    # only this request (done+error, pages released); the
                    # stale-batch rebuild below re-prepares without it
                    self._fail(req, f"prefill: {type(e).__name__}: {e}")
        # prefill may have finished a fresh request (eos / max_gen_len=1 at
        # the first sampled token) and released its pages — the prepared
        # batch is stale; discard it (no lengths advance) and rebuild
        if any(self._reqs[int(i)].done for i in ids):
            self.sched.discard_batch()
            return self.step() if self.sched.num_requests else False

        P = self.sched.max_pages_per_req
        mb = self.max_batch
        tokens = np.zeros(mb, np.int32)
        for b in range(B):
            tokens[b] = self._reqs[int(ids[b])].cur_token
        # bucket the block-table width by the LIVE max length (power of
        # two): attention work and the XLA path's gather scale with the
        # width, not the capacity; one compile per bucket, <= log2(P)
        # variants
        need_pages = int(max(lens)) // self.page_size + 1
        w = 1
        while w < need_pages:
            w *= 2
        w = min(w, P)
        table_p = np.zeros((mb, w), np.int32)
        table_p[:B] = table[:, :w]
        lens_p = np.zeros(mb, np.int32)
        lens_p[:B] = lens
        poss_p = np.zeros(mb, np.int32)
        poss_p[:B] = poss

        # per-request sampling params (traced → no recompile per mix)
        temps = np.zeros(mb, np.float32)
        tops = np.full(mb, 0.9, np.float32)
        for b in range(B):
            r = self._reqs[int(ids[b])]
            temps[b] = r.temperature
            tops[b] = r.top_p
        self._key, sub = jax.random.split(self._key)
        if self.evenwin:
            # per-slot ring block table for the windowed even layers:
            # absolute page j of row b -> slot base + (j mod wp) for the
            # pages holding in-window rows (plus the append target page);
            # below-window entries stay NULL (masked by the window, and
            # the kernel skips them)
            wp, W = self.window_pages, self.cfg.sliding_window
            base = 1 + np.array([self._slot_of[int(i)] for i in ids[:B]],
                                np.int32) * wp
            j_lo = np.maximum(0, (poss[:B].astype(np.int64) + 1 - W)
                              // self.page_size)
            j_hi = np.minimum(w, lens[:B] // self.page_size + 1)
            j = np.arange(w, dtype=np.int64)[None, :]
            live = (j >= j_lo[:, None]) & (j < j_hi[:, None])
            table_l = np.zeros((mb, w), np.int32)
            table_l[:B] = np.where(live, base[:, None] + (j % wp), 0)
            (nxt, lp, self.k_pool, self.v_pool, self.k_pool_loc,
             self.v_pool_loc) = self._step(
                self.params, self.k_pool, self.v_pool,
                jnp.asarray(tokens), jnp.asarray(poss_p),
                jnp.asarray(table_p), jnp.asarray(lens_p), sub,
                jnp.asarray(temps), jnp.asarray(tops),
                k_pool_loc=self.k_pool_loc, v_pool_loc=self.v_pool_loc,
                table_loc=jnp.asarray(table_l))
        else:
            nxt, lp, self.k_pool, self.v_pool = self._step(
                self.params, self.k_pool, self.v_pool,
                jnp.asarray(tokens), jnp.asarray(poss_p),
                jnp.asarray(table_p), jnp.asarray(lens_p), sub,
                jnp.asarray(temps), jnp.asarray(tops))
        nxt = np.asarray(jax.device_get(nxt))
        lp = np.asarray(jax.device_get(lp))
        self.sched.commit_batch()

        bad = 0
        for b in range(B):
            req = self._reqs[int(ids[b])]
            tok = int(nxt[b])
            lpb = float(lp[b])
            # numeric watchdog: an out-of-range token or non-finite
            # logprob means this row's logits were NaN/inf (numeric fault
            # in weights, cache, or kernel) — evict the request instead of
            # silently committing garbage into its output and KV pages
            if not (0 <= tok < self.cfg.vocab_size) or not np.isfinite(lpb):
                self._fail(req, f"numeric watchdog: token={tok} "
                                f"logprob={lpb}")
                bad += 1
                continue
            req.cur_token = tok
            req.generated.append(tok)
            if req.want_logprobs:
                req.logprobs.append(lpb)
            self._maybe_finish(req)
        # engine breaker: every live row failing for several consecutive
        # steps is a step-level fault (bad params / broken kernel), not a
        # request-level one — stop instead of spinning
        if B > 0 and bad == B:
            self._bad_steps += 1
            if self._bad_steps >= self.max_bad_steps:
                raise EngineHealthError(
                    f"all {B} rows failed the numeric watchdog for "
                    f"{self._bad_steps} consecutive steps")
        else:
            self._bad_steps = 0
        return True

    def cancel(self, req_id: int) -> List[int]:
        """Abort a request (frees its pages immediately); returns whatever
        was generated so far."""
        req = self._reqs.pop(req_id, None)
        if req is None:
            raise KeyError(req_id)
        if not req.done:
            self._release(req_id)
        return req.generated

    def stats(self) -> Dict[str, int]:
        """Pool / queue occupancy for schedulers and dashboards."""
        return {
            "free_pages": self.sched.free_pages,
            "total_pages": self.sched.num_pages - 1,   # page 0 reserved
            "requests": self.sched.num_requests,
            "active": sum(1 for r in self._reqs.values() if not r.done),
            "failed": sum(1 for r in self._reqs.values()
                          if r.error is not None),
        }

    def run(self) -> Dict[int, List[int]]:
        """Decode until every submitted request finishes.  Per-request
        detail (logprobs, prompt logprobs) for the drained batch stays
        readable on ``self.last_results`` until the next ``run``."""
        while self.step():
            pass
        out = {rid: r.generated for rid, r in self._reqs.items()}
        self.last_results = dict(self._reqs)
        self._reqs = {r.id: r for r in self._reqs.values() if not r.done}
        return out
