"""Paged batch-decode attention vs oracles.

Covers the reference-parity sglang indptr/indices (page=1) op against the
fp32 paged oracle, the block-table paged attention of the serving engine
(page>1, in-place append) against ``ops.reference.paged_attention_ref``,
and the Triton-route kernel in interpret mode against the same oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clusterfusion.ops import llama_decoder_layer_batch_decode_sglang
from clusterfusion.ops import paged_attention as pa
from clusterfusion.ops.paged_attention import paged_attention
from clusterfusion.ops.quant import Int8KV
from clusterfusion.ops.reference import (
    llama_decoder_layer_batch_paged_ref,
    paged_attention_ref,
)

HIDDEN = 512
HEADS = 4
HEAD_DIM = 128


def _mx(a, b):
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def _mk_weights(key, dtype=jnp.bfloat16):
    k1, k2, k3 = jax.random.split(key, 3)
    w_qkv = (jax.random.normal(k1, (3 * HIDDEN, HIDDEN), jnp.float32) * 0.1).astype(dtype)
    w_o = (jax.random.normal(k2, (HIDDEN, HIDDEN), jnp.float32) * 0.1).astype(dtype)
    rms_w = (jax.random.normal(k3, (HIDDEN,), jnp.float32) * 0.1).astype(dtype)
    return w_qkv, w_o, rms_w


def test_sglang_paged_parity():
    """3 requests with lengths 5/17/1 in a shuffled token pool."""
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 6)
    dtype = jnp.bfloat16
    B, L, layer_id = 3, 2, 1
    lens = [5, 17, 1]                       # cached tokens per request
    total = sum(lens) + B                   # + one new slot each
    num_pages = total + 7                   # a few unused pool rows

    rng = np.random.RandomState(0)
    perm = rng.permutation(num_pages)[:total].astype(np.int32)
    indices = jnp.asarray(perm)
    indptr = jnp.asarray(np.cumsum([0] + [l + 1 for l in lens]), jnp.int32)

    w_qkv, w_o, rms_w = _mk_weights(ks[0])
    x = jax.random.normal(ks[1], (B, HIDDEN), dtype)
    res = jax.random.normal(ks[2], (B, HIDDEN), dtype)
    k_cache = jax.random.normal(ks[3], (L, num_pages, HIDDEN), dtype)
    v_cache = jax.random.normal(ks[4], (L, num_pages, HIDDEN), dtype)
    positions = jnp.asarray(lens, jnp.int32)
    max_pos = max(lens) + 1
    angle = np.outer(np.arange(max_pos), 0.3 * np.arange(HEAD_DIM // 2) + 0.1)
    cos_sin = jnp.asarray(
        np.concatenate([np.cos(angle), np.sin(angle)], axis=-1), jnp.float32)
    eps = 1e-5

    got = llama_decoder_layer_batch_decode_sglang(
        x, res, w_qkv, w_o, indptr, indices, k_cache, v_cache, layer_id,
        rms_w, eps, positions, cos_sin, n_heads=HEADS, head_dim=HEAD_DIM)
    want = llama_decoder_layer_batch_paged_ref(
        x, res, w_qkv, w_o, indptr, indices, k_cache[layer_id],
        v_cache[layer_id], rms_w, eps, positions, cos_sin,
        n_heads=HEADS, head_dim=HEAD_DIM)

    assert _mx(got[0], want[0]) < 1e-1, "output"
    assert _mx(got[1], want[1]) < 2e-2, "residual"
    assert _mx(got[2][layer_id], want[2]) < 5e-2, "k pool"
    assert _mx(got[3][layer_id], want[3]) < 5e-2, "v pool"
    # untouched layer must be bit-identical
    np.testing.assert_array_equal(np.asarray(got[2][0]), np.asarray(k_cache[0]))


def _pools(rng, L, n_pages, kv, page, hd, kv_dtype=jnp.bfloat16):
    shape = (L, n_pages, kv, page, hd)
    out = []
    for _ in range(2):
        x = jnp.asarray(rng.randn(*shape), jnp.float32)
        out.append(pa.pool_set_pages(pa.init_paged_pool(shape, kv_dtype),
                                     jnp.arange(n_pages), x))
    return out


def _table(rng, B, width, n_pages):
    return jnp.asarray(rng.permutation(n_pages - 1)[: B * width]
                       .reshape(B, width).astype(np.int32) + 1)


@pytest.mark.parametrize("page", [16, 64])
def test_block_table_paged_vs_single_seq_oracle(page):
    """Block-table paged attention with append, each request checked
    against the fp32 oracle on its own pages; the new K/V lands at
    ``table[b, len // page]``, row ``len % page``."""
    rng = np.random.RandomState(7)
    B, kv, g, hd, width, L = 2, 4, 1, 128, 4, 1
    lens = [page + 3, 2 * page]             # crosses page boundaries
    n_pages = B * width + 1
    kp, vp = _pools(rng, L, n_pages, kv, page, hd)
    table = _table(rng, B, width, n_pages)
    q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
    k_new = jnp.asarray(rng.randn(B, kv, hd), jnp.bfloat16)
    v_new = jnp.asarray(rng.randn(B, kv, hd), jnp.bfloat16)
    seq_lens = jnp.asarray(lens, jnp.int32)
    o, kp2, vp2 = jax.jit(paged_attention)(q, k_new, v_new, kp, vp, table,
                                           seq_lens, 0)
    want = paged_attention_ref(q, kp2, vp2, table, seq_lens + 1, 0)
    np.testing.assert_allclose(np.asarray(o, np.float32),
                               np.asarray(want).reshape(B, -1), atol=3e-2)
    for b in range(B):
        pg, off = int(table[b, lens[b] // page]), lens[b] % page
        np.testing.assert_array_equal(np.asarray(kp2[0, pg, :, off]),
                                      np.asarray(k_new[b]))
        np.testing.assert_array_equal(np.asarray(vp2[0, pg, :, off]),
                                      np.asarray(v_new[b]))


def test_block_table_paged_multi_window():
    """Kernel (interpret mode) over several loop steps and KV splits: the
    per-split online softmax and the log-sum-exp merge pass against the
    oracle, with ragged lengths ending mid-page."""
    rng = np.random.RandomState(11)
    B, kv, g, hd, page, width, L = 3, 2, 2, 64, 8, 24, 1
    n_pages = B * width + 1
    kp, vp = _pools(rng, L, n_pages, kv, page, hd)
    table = _table(rng, B, width, n_pages)
    assert pa._splits(B, kv, width, pa._kernel_blocks(hd, page)[0])[1] > 1
    q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
    lens = jnp.asarray([1, 5 * page + 3, width * page], jnp.int32)
    got = pa.paged_attention_kernel(q, kp, vp, table, lens, 0,
                                    interpret=True)
    want = paged_attention_ref(q, kp, vp, table, lens, 0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-2)


def test_paged_attention_multi_window():
    """Sliding window in the kernel (interpret mode): pages wholly below
    the window are skipped, the window edge is masked inside a page, and a
    window wider than the context equals full attention."""
    rng = np.random.RandomState(9)
    B, kv, g, hd, page, width, L = 2, 4, 2, 128, 8, 8, 2
    n_pages = B * width + 1
    kp, vp = _pools(rng, L, n_pages, kv, page, hd)
    table = _table(rng, B, width, n_pages)
    q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
    lens = jnp.asarray([3 * page + 2, width * page], jnp.int32)
    for window in (5, 2 * page + 3, 10 * width * page):
        got = pa.paged_attention_kernel(q, kp, vp, table, lens, 1, window,
                                        interpret=True)
        want = paged_attention_ref(q, kp, vp, table, lens, 1, window)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-2)
    full = paged_attention_ref(q, kp, vp, table, lens, 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(full), atol=2e-2)


def test_paged_attention_matches_oracle():
    """The serving engine's paged attention (append, then attend) vs dense
    attention on the gathered pages plus the current token; other layers
    stay untouched."""
    rng = np.random.RandomState(3)
    B, kv, g, hd, page, P, L = 2, 4, 2, 128, 8, 4, 2
    num_pages = B * P + 1
    q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
    k_new = jnp.asarray(rng.randn(B, kv, hd), jnp.bfloat16)
    v_new = jnp.asarray(rng.randn(B, kv, hd), jnp.bfloat16)
    kp = jnp.asarray(rng.randn(L, num_pages, kv, page, hd), jnp.bfloat16)
    vp = jnp.asarray(rng.randn(L, num_pages, kv, page, hd), jnp.bfloat16)
    table = jnp.asarray(rng.permutation(num_pages - 1)[: B * P]
                        .reshape(B, P).astype(np.int32) + 1) % num_pages
    lens = jnp.asarray([11, 26], jnp.int32)
    layer = 1

    o, kp2, vp2 = jax.jit(paged_attention)(
        q, k_new, v_new, kp, vp, table, lens, layer)

    for b in range(2):
        s = int(lens[b])
        rows_k, rows_v = [], []
        for t in range(s):
            pg, off = int(table[b, t // page]), t % page
            rows_k.append(np.asarray(kp[layer, pg, :, off], np.float32))
            rows_v.append(np.asarray(vp[layer, pg, :, off], np.float32))
        rows_k.append(np.asarray(k_new[b], np.float32))
        rows_v.append(np.asarray(v_new[b], np.float32))
        K = np.stack(rows_k)                       # [s+1, kv, hd]
        V = np.stack(rows_v)
        qb = np.asarray(q[b], np.float32)          # [kv, g, hd]
        scores = np.einsum("kgd,skd->kgs", qb, K) / np.sqrt(hd)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        want = np.einsum("kgs,skd->kgd", p, V).reshape(kv * g * hd)
        got = np.asarray(o[b], np.float32)
        np.testing.assert_allclose(got, want, atol=0.03)
        # appended row landed in the right slot
        pg, off = int(table[b, s // page]), s % page
        np.testing.assert_allclose(
            np.asarray(kp2[layer, pg, :, off], np.float32),
            np.asarray(k_new[b], np.float32), atol=0.02)
    # other layers untouched
    np.testing.assert_array_equal(np.asarray(kp2[0], np.float32),
                                  np.asarray(kp[0], np.float32))


# (kv heads, query group, head_dim, window, softcap, pool dtype)
KERNEL_CASES = {
    "mha": (4, 1, 128, 0, 0.0, jnp.bfloat16),
    "gqa": (2, 4, 128, 0, 0.0, jnp.bfloat16),
    "hd64_group8": (2, 8, 64, 0, 0.0, jnp.bfloat16),
    "hd256_softcap": (2, 2, 256, 0, 50.0, jnp.bfloat16),
    "window": (2, 4, 128, 21, 0.0, jnp.bfloat16),
    "int8kv": (2, 4, 128, 0, 0.0, "int8"),
    "fp8": (2, 4, 128, 0, 0.0, jnp.float8_e4m3fn),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_paged_kernel_interpret_matches_oracle(case):
    """The Triton-route kernel in interpret mode against the fp32 oracle:
    ragged lengths (one row, mid-page, a full table), GQA and MHA groups,
    head_dim 64/128/256, softcap, sliding window, Int8KV scales and fp8
    converted at the load."""
    kv, g, hd, window, softcap, dt = KERNEL_CASES[case]
    rng = np.random.RandomState(len(case))
    B, page, width, L = 3, 16, 6, 2
    n_pages = B * width + 1
    kp, vp = _pools(rng, L, n_pages, kv, page, hd, dt)
    table = _table(rng, B, width, n_pages)
    q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
    lens = jnp.asarray([1, 2 * page + 7, width * page], jnp.int32)
    got = pa.paged_attention_kernel(q, kp, vp, table, lens, 1, window,
                                    softcap, interpret=True)
    want = paged_attention_ref(q, kp, vp, table, lens, 1, window, softcap)
    assert got.shape == (B, kv, g, hd)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=3e-2)


def test_int8kv_append_quantizes_rows():
    """Appending into an Int8KV pool writes the row's int8 codes and its
    scale; reading them back reproduces the row to int8 precision."""
    rng = np.random.RandomState(4)
    B, kv, hd, page = 2, 2, 128, 16
    pool = pa.init_paged_pool((1, 5, kv, page, hd), "int8")
    rows = jnp.asarray(rng.randn(B, kv, hd), jnp.float32)
    table = jnp.asarray([[1, 2], [3, 4]], jnp.int32)
    lens = jnp.asarray([17, 3], jnp.int32)
    out = pa.paged_append(pool, rows, table, lens, 0)
    assert isinstance(out, Int8KV)
    for b, (pg, off) in enumerate([(2, 1), (3, 3)]):
        back = (np.asarray(out.q[0, pg, :, off], np.float32)
                * np.asarray(out.s[0, pg, :, off])[:, None])
        np.testing.assert_allclose(back, np.asarray(rows[b]),
                                   atol=np.abs(rows[b]).max() / 127)


@pytest.mark.parametrize("B,kv,width,page,hd", [
    (1, 32, 1, 16, 128), (8, 32, 128, 16, 128), (8, 8, 384, 16, 128),
    (3, 2, 5, 1, 64), (2, 8, 7, 16, 256)])
def test_kernel_split_covers_table(B, kv, width, page, hd):
    """Every page of the block table falls in exactly one KV split, the
    loop step is whole pages, and the grid never drops below one wave of
    programs when the table has pages to spare."""
    ppb, rows = pa._kernel_blocks(hd, page)
    assert rows == ppb * page and ppb >= 1
    pps, n_splits = pa._splits(B, kv, width, ppb)
    assert pps % ppb == 0
    assert (n_splits - 1) * pps < width <= n_splits * pps
    n_blocks = -(-width // ppb)
    assert n_splits == n_blocks or B * kv * n_splits >= pa._TARGET_PROGRAMS


def test_paged_attention_uses_xla_path_off_gpu():
    """The choice of implementation follows the platform: off a CUDA
    device the serving engine's attention lowers to plain XLA, with no
    Triton custom call in the program; on one, to the kernel."""
    rng = np.random.RandomState(0)
    kp, vp = _pools(rng, 1, 5, 2, 16, 64)
    args = (jnp.ones((2, 2, 1, 64), jnp.bfloat16),
            jnp.ones((2, 2, 64), jnp.bfloat16),
            jnp.ones((2, 2, 64), jnp.bfloat16), kp, vp,
            jnp.asarray([[1, 2], [3, 4]], jnp.int32),
            jnp.asarray([3, 20], jnp.int32), 0)
    hlo = jax.jit(paged_attention).lower(*args).compile().as_text()
    on_gpu = jax.devices()[0].platform == "gpu"
    assert ("triton" in hlo.lower()) == on_gpu


@pytest.mark.gpu
def test_paged_kernel_compiled_matches_xla(gpu):
    """The kernel compiled for the card (no interpret mode) against the
    XLA path, bf16 and Int8KV pools, windowed."""
    rng = np.random.RandomState(1)
    B, kv, g, hd, page, width, L = 4, 8, 4, 128, 16, 32, 2
    n_pages = B * width + 1
    for dt in (jnp.bfloat16, "int8"):
        kp, vp = _pools(rng, L, n_pages, kv, page, hd, dt)
        table = _table(rng, B, width, n_pages)
        q = jnp.asarray(rng.randn(B, kv, g, hd), jnp.bfloat16)
        lens = jnp.asarray([1, 100, 300, width * page], jnp.int32)
        got = jax.jit(pa.paged_attention_kernel)(q, kp, vp, table, lens, 1,
                                                 200)
        want = jax.jit(pa.paged_attention_xla)(q, kp, vp, table, lens, 1,
                                               200)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=2e-2)
