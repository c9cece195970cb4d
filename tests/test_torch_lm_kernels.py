"""The LM stack's kernels of the port against the JAX package, on the CPU.

Each plain PyTorch version (what the CUDA wrapper runs on CPU tensors) is
held to the JAX package's Pallas kernel in interpret mode and to its
``kernels/ref.py`` oracle, on the same numpy inputs, with the JAX
package's own kernel tolerances (tests/test_kernels.py: fp32 2e-5, bf16
2e-2): flash attention (causal or not, window, softcap, GQA, head dims 64
and 128), decode attention (pos 1, mid, full; pos 0 pinned), the SSD chunk
and the chunked SSD scan built on it, also with every chunk in one call
on the model's strided views. Three helpers here repeat the arithmetic of
the CUDA kernels' designs, which the plain versions do not: the split-KV
decode kernel's per-chunk partials and their merge, the bf16 flash
kernel's P rounded to bf16 before P V, and the bf16 SSD kernel's S' and
w ∘ X rounded to bf16; all are held to the Pallas kernels too.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as pallas_decode  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as pallas_ssd_chunk  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test: the suite runs in parallel
    workers beside XLA's thread pools, and torch's default pool (a thread
    per core in every worker) oversubscribes the cores several times over.
    The port's tests use small tensors, where one thread loses little."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# the JAX package's kernel tolerances (tests/test_kernels.py:10)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype` (both
    round fp32 to bf16 to nearest even)."""
    a = a.astype(np.float32)
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **TOL[dtype])


# -- flash attention ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (1, 128, 4, 4, 64, True, 0, 0.0),
    (2, 256, 8, 2, 64, False, 0, 0.0),
    (1, 256, 4, 1, 128, True, 0, 0.0),
    (1, 256, 4, 2, 64, True, 100, 0.0),
    (1, 128, 4, 4, 64, True, 0, 20.0),
])
def test_flash_attention_plain_matches_pallas_and_ref(dtype, b, s, hq, hkv, d,
                                                      causal, window, cap):
    rng = np.random.default_rng(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(b, s, h, d)), dtype) for h in (hq, hkv, hkv))
    kw = dict(causal=causal, window=window, cap=cap)
    out = ops.flash_attention(tq, tk, tv, **kw)          # model layout
    assert out.dtype == tq.dtype and out.shape == tq.shape
    pallas = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    _close(out, pallas, dtype)
    oracle = ref.flash_attention_ref(*(jnp.swapaxes(t, 1, 2)
                                       for t in (jq, jk, jv)), **kw)
    _close(out, jnp.swapaxes(oracle, 1, 2), dtype)
    kernel_layout = fa.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                       tv.transpose(1, 2), **kw)
    assert torch.equal(kernel_layout.transpose(1, 2), out)


def _flash_p_rounded(q, k, v, *, causal, window, cap, block_k=64):
    """The bf16 flash kernel's arithmetic in fp32 torch, kernel layout: an
    online softmax over 64-key tiles, l summing the fp32 p = exp(s - m)
    and P rounded to bf16 before P V (the wgmma kernel's A operand)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    vr = v.float().repeat_interleave(hq // hkv, dim=1)
    m = torch.full((b, hq, sq, 1), fa.NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        kt, vt = kr[:, :, k0:k0 + block_k], vr[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt) / math.sqrt(d)
        if cap:
            s = cap * torch.tanh(s / cap)
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)).to(q.dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (1, 128, 4, 4, 64, True, 0, 0.0),
    (2, 256, 8, 2, 64, False, 0, 0.0),
    (1, 256, 4, 1, 128, True, 0, 0.0),
    (1, 256, 4, 2, 64, True, 100, 0.0),
    (1, 128, 4, 4, 64, True, 0, 20.0),
])
def test_flash_p_rounded_to_bf16_stays_within_bf16_of_pallas(b, s, hq, hkv, d,
                                                             causal, window,
                                                             cap):
    """P rounded to bf16 before P V (the wgmma kernel) against the Pallas
    kernel in interpret mode, bf16 inputs, the bf16 kernel tolerance; the
    same shapes as the plain version's test above."""
    rng = np.random.default_rng(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(b, s, h, d)), "bfloat16")
        for h in (hq, hkv, hkv))
    kw = dict(causal=causal, window=window, cap=cap)
    out = _flash_p_rounded(tq.transpose(1, 2), tk.transpose(1, 2),
                           tv.transpose(1, 2), **kw).transpose(1, 2)
    pallas = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    _close(out, pallas, "bfloat16")
    _close(out, ops.flash_attention(tq, tk, tv, **kw).float(), "bfloat16")


def test_flash_attention_keeps_the_block_contract():
    """The wrapper's contract: any sequence length (the CUDA kernel masks
    its ragged last tiles, so the exact-length prefills of the ssm and
    hybrid families reach it; the TPU kernel's multiple of min(128, S) is
    not asked), equal to the JAX package's oracle at a ragged length under
    a window; impl="cuda" only on the card."""
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(1, 200, h, 64)),
                                          "float32") for h in (4, 2, 2))
    out = ops.flash_attention(tq, tk, tv, window=64)
    _close(out.transpose(1, 2), ref.flash_attention_ref(
        jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
        jv.transpose(0, 2, 1, 3), window=64), "float32")
    q = torch.zeros((1, 200, 2, 64))
    with pytest.raises(ValueError, match="'cuda'"):
        ops.flash_attention(q[:, :128], q[:, :128], q[:, :128], impl="cuda")


# -- decode attention ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,skv,hq,hkv,d,pos", [
    (2, 512, 4, 2, 64, 1), (2, 512, 4, 2, 64, 200), (2, 512, 4, 2, 64, 512),
    (1, 512, 8, 8, 128, 300)])
def test_decode_attention_plain_matches_pallas_and_ref(dtype, b, skv, hq, hkv,
                                                       d, pos):
    rng = np.random.default_rng(pos)
    jq, tq = _pair(rng.normal(size=(b, 1, hq, d)), dtype)
    jk, tk = _pair(rng.normal(size=(b, skv, hkv, d)), dtype)
    jv, tv = _pair(rng.normal(size=(b, skv, hkv, d)), dtype)
    out = ops.decode_attention(tq, tk, tv, pos, block_k=256)
    _close(out, jops.decode_attention(jq, jk, jv, pos, block_k=256), dtype)
    oracle = ref.decode_attention_ref(jnp.swapaxes(jq, 1, 2), jk, jv, pos)
    _close(out, jnp.swapaxes(oracle, 1, 2), dtype)
    # one position per batch row: each row equals its own scalar call
    rows = ops.decode_attention(tq, tk, tv, torch.tensor([pos, 1][:b]))
    assert torch.equal(rows[:1], out[:1])


def test_decode_attention_at_pos_0_is_zero_like_the_tpu_kernel():
    """At pos = 0 the Pallas kernel skips every block and returns
    acc / max(l, 1e-20) = 0; its oracle ref.decode_attention_ref is a
    plain softmax over an all-masked row and returns the mean of v. The
    port computes the kernel's function (ROADMAP section 3)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 4, 1, 64)).astype(np.float32)
    k = rng.normal(size=(1, 256, 2, 64)).astype(np.float32)
    v = rng.normal(size=(1, 256, 2, 64)).astype(np.float32)
    out = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), 0)
    assert float(out.abs().max()) == 0.0
    pallas = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0,
                           block_k=128)
    assert float(jnp.abs(pallas).max()) == 0.0
    oracle = np.asarray(ref.decode_attention_ref(jnp.asarray(q),
                                                 jnp.asarray(k),
                                                 jnp.asarray(v), 0))
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)[:, :, None]   # [1,4,1,64]
    np.testing.assert_allclose(oracle, mean_v, rtol=1e-5, atol=1e-6)
    assert np.abs(oracle).max() > 0.1


def _split_kv_decode(q, k, v, pos, chunk):
    """The split-KV decode kernel's arithmetic in fp32 torch: keys
    [c0, c0 + chunk) below pos[b] give one partial (m, l, acc) each, a
    chunk starting at or past pos[b] none, and the partials merge as the
    last block merges them: m = max m_s, l = sum l_s exp(m_s - m), acc =
    sum acc_s exp(m_s - m), out = acc / max(l, 1e-20). q [B,Hq,1,D],
    cache [B,Skv,Hkv,D], pos a list of B ints."""
    b, hq, _, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    out = torch.zeros((b, hkv, g, d))
    for r in range(b):
        n = min(max(pos[r], 0), skv)
        qr = q[r].float().reshape(hkv, g, d)
        parts = []
        for c0 in range(0, n, chunk):
            kc = k[r, c0:min(c0 + chunk, n)].float()
            vc = v[r, c0:min(c0 + chunk, n)].float()
            s = torch.einsum("hgd,khd->hgk", qr, kc) / math.sqrt(d)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgk,khd->hgd", p, vc)))
        mx = torch.full((hkv, g), da.NEG_INF)
        for m, _, _ in parts:
            mx = torch.maximum(mx, m)
        lsum = torch.zeros((hkv, g))
        acc = torch.zeros((hkv, g, d))
        for m, ls, a in parts:
            f = torch.exp(m - mx)
            lsum = lsum + ls * f
            acc = acc + a * f[..., None]
        out[r] = acc / torch.clamp(lsum, min=1e-20)[..., None]
    return out.reshape(b, hq, 1, d).to(q.dtype)


@pytest.mark.parametrize("chunk,pos", [
    (64, 200),      # chunks below pos, the last one partial
    (200, 200),     # one chunk ending at pos
    (256, 200),     # one chunk past pos
    (128, 512),     # the full cache
    (64, 1),        # one key, every other chunk empty
    (512, 0),       # no key: 0, as the TPU kernel
])
def test_split_kv_merge_matches_pallas_and_the_plain_version(chunk, pos):
    """The split-KV kernel's partials and merge, fp32, against the Pallas
    decode kernel in interpret mode (scalar pos) and the port's plain
    version with a position per row, within fp32 1e-5."""
    b, skv, hq, hkv, d = 2, 512, 4, 2, 64
    rng = np.random.default_rng(chunk + pos)
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    qt = tq.transpose(1, 2)
    tol = dict(rtol=1e-5, atol=1e-5)
    merged = _split_kv_decode(qt, tk, tv, [pos, pos], chunk)
    pallas = pallas_decode(jnp.swapaxes(jnp.asarray(q), 1, 2),
                           jnp.asarray(k), jnp.asarray(v), pos, block_k=128)
    np.testing.assert_allclose(merged.numpy(), np.asarray(pallas), **tol)
    if pos == 0:
        assert float(merged.abs().max()) == 0.0
    rows = [pos, 37]                      # a second row, ragged in a chunk
    merged = _split_kv_decode(qt, tk, tv, rows, chunk)
    plain = da.decode_attention_plain(qt, tk, tv, torch.tensor(rows))
    np.testing.assert_allclose(merged.numpy(), plain.numpy(), **tol)


def test_decode_attention_keeps_the_block_contract():
    q, k = torch.zeros((1, 1, 2, 64)), torch.zeros((1, 384, 2, 64))
    with pytest.raises(ValueError, match="block_k"):
        ops.decode_attention(q, k, k, 10, block_k=256)


# -- SSD ----------------------------------------------------------------------

def _ssd_inputs(b, s, h, p, n, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(b, s, h, p))
    bb = 0.3 * rng.normal(size=(b, s, n))
    cc = 0.3 * rng.normal(size=(b, s, n))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    pairs = [_pair(a, dtype) for a in (x, bb, cc)]
    pairs += [(jnp.asarray(a), torch.from_numpy(a)) for a in (dt, a_log)]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(1, 64, 2, 32, 16), (2, 128, 4, 64, 32)])
def test_ssd_chunk_plain_matches_pallas_and_ref(dtype, dims):
    jin, tin = _ssd_inputs(*dims, dtype=dtype)
    y, state, decay = sc.ssd_chunk(*tin)
    b, q, h, p, n = dims
    assert y.dtype == tin[0].dtype and state.shape == (b, h, n, p)
    py, pst, pdec = pallas_ssd_chunk(*jin)
    _close(y, py, dtype)
    # states and decays are fp32 on both sides
    _close(state, pst, "float32" if dtype == "float32" else dtype)
    _close(decay, pdec, "float32")
    ry, rst, rdec = ref.ssd_chunk_ref(*jin)
    _close(y, ry, dtype)
    _close(state, jnp.swapaxes(rst, -1, -2),      # the oracle's [P, N]
           "float32" if dtype == "float32" else dtype)
    _close(decay, rdec, "float32")


def test_ssd_chunked_pallas_matches_jax_and_the_model_scan():
    """The host scan over kernel chunks against the JAX package's, and
    against the port's model-path `ssd_chunked` with d_skip 0 (the
    relation tests/test_kernels.py holds for JAX, at its 2e-4)."""
    b, s, h, p, n = 2, 256, 4, 64, 32
    jin, tin = _ssd_inputs(b, s, h, p, n, seed=1)
    y, fin = ops.ssd_chunked_pallas(*tin, chunk=64)
    jy, jfin = jops.ssd_chunked_pallas(*jin, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=2e-5,
                               atol=2e-5)
    cfg = dataclasses.replace(get_config("mamba2-130m"), ssm_chunk=64,
                              ssm_head_dim=p)
    ym, fm = ssd_chunked(*tin[:4], tin[4], torch.zeros(h), cfg)
    np.testing.assert_allclose(y.numpy(), ym.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(fin.numpy(), fm.numpy(), rtol=2e-4, atol=2e-4)
    jcfg = dataclasses.replace(jax_get_config("mamba2-130m"), ssm_chunk=64,
                               ssm_head_dim=p)
    jym, jfm = jax_ssd_chunked(*jin[:4], jin[4], jnp.zeros(h), jcfg)
    np.testing.assert_allclose(ym.numpy(), np.asarray(jym), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(fm.numpy(), np.asarray(jfm), rtol=2e-5,
                               atol=2e-5)


def test_ssd_chunked_pallas_rounds_y_intra_to_the_input_type():
    """bf16 inputs: y_intra is rounded to bf16 before the inter-chunk term
    is added (JAX's ops.ssd_chunked_pallas does so), and the result matches
    JAX's at bf16 tolerance."""
    jin, tin = _ssd_inputs(1, 128, 2, 32, 16, seed=2, dtype="bfloat16")
    y, fin = ops.ssd_chunked_pallas(*tin, chunk=64)
    jy, jfin = jops.ssd_chunked_pallas(*jin, chunk=64)
    assert y.dtype == torch.bfloat16
    _close(y, jy, "bfloat16")
    _close(fin, jfin, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_ssd_chunked_pallas_matches_jax_on_the_models_views(dtype):
    """Every chunk goes to ssd_chunk as a batch row of one call; the inputs
    are the model's views (x, B and C split from one [B,S,d_inner+2N]
    tensor, x reshaped to heads), at mamba2's P 64, N 128, two chunks of
    128, 4 heads, against JAX's scan of one kernel call per chunk."""
    bsz, s, h, p, n, q = 1, 256, 4, 64, 128, 128
    d_inner = h * p
    rng = np.random.default_rng(11)
    xbc = 0.3 * rng.normal(size=(bsz, s, d_inner + 2 * n))
    dt = np.log1p(np.exp(rng.normal(size=(bsz, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    jxbc, txbc = _pair(xbc, dtype)
    xi, tb, tc = torch.split(txbc, [d_inner, n, n], dim=-1)
    tx = xi.reshape(bsz, s, h, p)
    assert not (tx.is_contiguous() or tb.is_contiguous())
    # the batched call's reshape is a view of the model's tensor
    assert tx.reshape(bsz * s // q, q, h, p).data_ptr() == txbc.data_ptr()
    y, fin = ops.ssd_chunked_pallas(tx, tb, tc, torch.from_numpy(dt),
                                    torch.from_numpy(a_log), chunk=q)
    jx = jxbc[..., :d_inner].reshape(bsz, s, h, p)
    jy, jfin = jops.ssd_chunked_pallas(
        jx, jxbc[..., d_inner:d_inner + n], jxbc[..., d_inner + n:],
        jnp.asarray(dt), jnp.asarray(a_log), chunk=q)
    assert y.dtype == tx.dtype and fin.shape == (bsz, h, p, n)
    _close(y, jy, dtype)
    _close(fin, jfin, dtype)


def _ssd_wgmma_emulated(x, b, c, dt, a_log):
    """The bf16 ssd_chunk_wgmma_kernel's rounding points in fp32 torch:
    S' = C Bᵀ ∘ L ∘ dt_r rounded to bf16 (L's mask a select), y = S' X
    accumulated in fp32 and rounded to x's type; w ∘ X rounded to bf16
    (w_r = exp(a_Q - a_r) dt_r) and state = Bᵀ (w ∘ X) in fp32. X, B and C
    reach the products as stored."""
    def bf16(t):
        return t.to(torch.bfloat16).float()
    q = x.shape[1]
    a = -torch.exp(a_log.float())
    acum = torch.cumsum(dt.float() * a, dim=1)                  # [B,Q,H]
    diff = acum[:, :, None, :] - acum[:, None, :, :]            # [B,s,r,H]
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool))[None, :, :, None]
    lmat = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    cb = torch.einsum("bsn,brn->bsr", c.float(), b.float())
    s_rounded = bf16(cb[..., None] * lmat * dt.float()[:, None])
    y = torch.einsum("bsrh,brhp->bshp", s_rounded, x.float())
    w = torch.exp(acum[:, -1:] - acum) * dt.float()             # [B,Q,H]
    wx = bf16(x.float() * w[..., None])                         # [B,Q,H,P]
    state = torch.einsum("brn,brhp->bhnp", b.float(), wx)
    return y.to(x.dtype), state, torch.exp(acum[:, -1])


@pytest.mark.parametrize("dims", [(1, 128, 4, 64, 128), (1, 128, 4, 64, 16),
                                  (2, 64, 4, 32, 16), (1, 100, 4, 64, 128)])
def test_ssd_wgmma_rounding_stays_within_bf16_of_pallas(dims):
    """The bf16 kernel's numerical design, pinned before the card: its
    rounding points (bf16 S', bf16 w ∘ X, fp32 accumulation) against the
    Pallas kernel in interpret mode on bf16 inputs, the bf16 kernel
    tolerance, at mamba2's widths, hymba's N 16, the padded P 32 / N 16
    and a ragged chunk of 100 rows."""
    jin, tin = _ssd_inputs(*dims, seed=sum(dims), dtype="bfloat16")
    y, state, decay = _ssd_wgmma_emulated(*tin)
    py, pst, pdec = pallas_ssd_chunk(*jin)
    _close(y, py, "bfloat16")
    _close(state, pst, "bfloat16")
    _close(decay, pdec, "float32")
    # the plain version (what the wrapper runs on the CPU) within the same
    for got, want in zip((y, state), sc.ssd_chunk_plain(*tin)[:2]):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_wgmma_wrapper_checks_what_the_kernel_takes():
    """The bf16 kernel's limits, checked before a launch: shared memory
    as the kernel lays it out, Q and P per block, N and P in 16-byte
    chunks, 16-byte aligned rows."""
    assert sc.wgmma_smem_bytes(128, 128, 64) == 1024 + 4 * 128 * 192 + 1032
    assert sc.wgmma_smem_bytes(100, 16, 32) == sc.wgmma_smem_bytes(128, 64,
                                                                   64)

    def check(q, n, p, b=1, offset=0):
        x = torch.zeros(b * q * 4 * p + offset, dtype=torch.bfloat16)
        x = x[offset:].view(b, q, 4, p)
        bc = torch.zeros((b, q, n), dtype=torch.bfloat16)
        sc._check_wgmma(x, bc, bc, q, n, p)
    check(128, 128, 64)
    check(256, 128, 64)
    check(100, 16, 32)
    for bad in (dict(q=257, n=128, p=64), dict(q=128, n=128, p=128),
                dict(q=128, n=12, p=64), dict(q=128, n=128, p=72),
                dict(q=128, n=128, p=64, offset=4),
                dict(q=256, n=256, p=64)):
        with pytest.raises(ValueError):
            check(**bad)


def test_lm_kernel_wrappers_do_not_count_on_the_cpu():
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    reset_launches()
    _, tin = _ssd_inputs(1, 64, 2, 32, 16)
    ops.ssd_chunked_pallas(*tin, chunk=32)
    q = torch.zeros((1, 128, 2, 64))
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :1], q, q, 3)
    assert LAUNCHES["flash_attention"] == LAUNCHES["decode_attention"] \
        == LAUNCHES["ssd_chunk"] == 0
    assert jax.default_backend() == "cpu"
