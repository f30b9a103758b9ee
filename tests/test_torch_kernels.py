"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and
``kernels/ref.py`` oracles, and the wrappers' CPU routing. The CUDA
kernels against their plain versions are in tests/test_torch_cuda.py.

Tolerances are the reference's (tests/test_kernels.py,
tests/test_batched_db.py): hessian_accum 1e-3·√N fp32, 1e-1·√N bf16,
1e-4·√N with an accumulator; obs_downdate 1e-5; flash attention 2e-5
fp32, 2e-2 bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.flash_attention import flash_attention_kernel
from repro.models.attention import \
    flash_attention_chunked as ref_flash_attention_chunked
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 hessian_accum, hessian_accum_plain,
                                 obs_downdate, obs_downdate_plain,
                                 reset_launch_counts)
from repro_torch.kernels.hessian_accum import last_wave_fill, split_plan
from repro_torch.models.attention import flash_attention_chunked


def _x(shape, seed, dtype):
    """The same values on both sides: fp32 numpy, rounded once to bf16
    (round-to-nearest-even in both frameworks) when asked."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("shape", [(100, 64), (1000, 200), (513, 300),
                                   (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_acc", [False, True])
def test_hessian_accum_plain_matches_pallas(shape, dtype, with_acc):
    n, d = shape
    xj, xt = _x(shape, n + d, dtype)
    acc_j = acc_t = None
    if with_acc:
        acc_j, acc_t = _x((d, d), 7, "float32")
    want = ops.hessian_accum(xj, acc_j, block_d=128, block_n=256,
                             interpret=True)
    oracle = ref.hessian_ref(xj) if acc_j is None \
        else acc_j + ref.hessian_ref(xj)
    got = hessian_accum_plain(xt, acc_t)
    assert got.dtype == torch.float32 and got.shape == (d, d)
    tol = 1e-3 if dtype == "float32" else 1e-1
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=tol * n ** 0.5, rtol=tol)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (129, 33), (300, 70)])
def test_hessian_accum_plain_with_accumulator_matches_pallas(shape):
    n, d = shape
    xj, xt = _x(shape, 14, "float32")
    acc_j, acc_t = _x((d, d), 15, "float32")
    want = ops.hessian_accum(xj, acc_j, block_d=32, block_n=64,
                             interpret=True)
    got = hessian_accum_plain(xt, acc_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4 * n ** 0.5, rtol=1e-4)


# the CUDA kernel's split plan: the paths' widths at N = 4096, splits of N
# above 1 at narrow D, ragged D, N below one strip, empty N
PLAN_SHAPES = [(4096, 768), (4096, 3072), (4096, 5120), (8192, 256),
               (257, 131), (513, 300), (5, 96), (1, 1), (0, 7)]
# (SMs, blocks per SM): H100 SXM and PCIe, A100, and a small card
PLAN_CARDS = [(132, 2), (114, 2), (108, 1), (80, 2)]


@pytest.mark.parametrize("n,d", PLAN_SHAPES)
@pytest.mark.parametrize("sms,bps", PLAN_CARDS)
def test_split_plan_covers_every_upper_tile_once(n, d, sms, bps):
    plan = split_plan(n, d, sms, bps)
    t = -(-d // 128)
    assert plan.tiles == t
    assert sorted(plan.upper) == [(i, j) for i in range(t)
                                  for j in range(i, t)]
    assert len(set(plan.upper)) == len(plan.upper) == t * (t + 1) // 2
    assert plan.items == plan.splits * len(plan.upper)
    assert plan.workspace_shape == (None if plan.splits == 1 else
                                    (plan.splits, len(plan.upper), 128, 128))


@pytest.mark.parametrize("n,d", PLAN_SHAPES)
@pytest.mark.parametrize("sms,bps", PLAN_CARDS)
def test_split_plan_partitions_the_rows(n, d, sms, bps):
    plan = split_plan(n, d, sms, bps)
    rows = plan.rows()
    assert len(rows) == plan.splits and plan.chunk % 16 == 0
    assert rows[0][0] == 0 and rows[-1][1] == n
    for (lo, hi), (nxt, _) in zip(rows, rows[1:]):
        assert lo < hi == nxt  # no gap, no overlap, none empty
    assert all(hi - lo == plan.chunk for lo, hi in rows[:-1])


@pytest.mark.parametrize("n,d", PLAN_SHAPES)
@pytest.mark.parametrize("sms,bps", PLAN_CARDS)
def test_split_plan_fills_the_last_wave(n, d, sms, bps):
    """The fewest splits whose last wave of work items is at least 75%
    full, among splits of whole 16-row strips, at most N // 128 of them;
    if none is, the fullest last wave."""
    plan = split_plan(n, d, sms, bps)
    tiles = len(plan.upper)
    strips = max(1, -(-n // 16))

    def fill(s):
        items, slots = s * tiles, sms * bps
        return (items - (-(-items // slots) - 1) * slots) / slots

    splits = sorted({-(-strips // -(-strips // w))
                     for w in range(1, max(1, n // 128) + 1)})
    full = [s for s in splits if fill(s) >= 0.75]
    want = full[0] if full else max(splits, key=lambda s: (fill(s), -s))
    assert plan.splits == want
    assert last_wave_fill(plan.items, sms * bps) == pytest.approx(fill(want))


def test_split_plan_at_the_paths_widths_on_an_h100():
    """The plans that the kernel's source header states (132 SMs, 2
    blocks each): (splits, rows per split, waves)."""
    for d, splits, chunk, waves in [(768, 10, 416, 1), (3072, 6, 688, 7),
                                    (5120, 8, 512, 25)]:
        plan = split_plan(4096, d, 132, 2)
        assert (plan.splits, plan.chunk) == (splits, chunk)
        assert -(-plan.items // 264) == waves
        assert last_wave_fill(plan.items, 264) >= 0.75


def _downdate_inputs(M, d_in, d_out, gs, seed, d_live=None):
    """Module-stacked inputs; with d_live, rows/cols past it are dead
    (zero), as live-set compaction leaves them."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((M, d_in, d_out))
    H = rng.standard_normal((M, d_in, d_in))
    Hinv = H @ H.transpose(0, 2, 1)
    HcolS = rng.standard_normal((M, d_in, gs))
    KsWS = rng.standard_normal((M, gs, d_out))
    KsHcolT = rng.standard_normal((M, gs, d_in))
    keep = (rng.random((M, d_in)) > 0.3).astype(np.float64)
    if d_live is not None:
        W[:, d_live:] = 0
        Hinv[:, d_live:] = 0
        Hinv[:, :, d_live:] = 0
        HcolS[:, d_live:] = 0
        KsHcolT[:, :, d_live:] = 0
        keep[:, d_live:] = 0
    return [a.astype(np.float32) for a in (W, Hinv, HcolS, KsWS, KsHcolT,
                                           keep)]


# (M, d_in, d_out, gs, d_live, block_d): gs == 1 is the outer-product
# branch; d_live < d_in the live-prefix restriction
DOWNDATE_CASES = [(3, 16, 8, 2, None, 8), (2, 96, 64, 16, None, 32),
                  (3, 33, 7, 1, None, 16), (2, 130, 12, 5, None, 64),
                  (2, 96, 24, 4, 64, 32), (3, 130, 12, 1, 96, 64),
                  (2, 64, 16, 8, 32, 16)]


@pytest.mark.parametrize("case", DOWNDATE_CASES)
def test_obs_downdate_plain_matches_pallas(case):
    M, d_in, d_out, gs, d_live, block_d = case
    arrs = _downdate_inputs(M, d_in, d_out, gs, d_in + gs, d_live)
    got_w, got_h = obs_downdate_plain(*map(torch.from_numpy, arrs),
                                      d_live=d_live)
    assert got_w.shape == (M, d_in, d_out) and got_h.shape == (M, d_in, d_in)
    for m in range(M):  # the reference runs one module per call (vmap)
        one = [jnp.asarray(a[m]) for a in arrs]
        want = ops.obs_downdate(*one, block_d=block_d, interpret=True,
                                d_live=d_live)
        oracle = ref.obs_downdate_ref(*one, d_live=d_live)
        for w_w, w_h in (want, oracle):
            np.testing.assert_allclose(got_w[m].numpy(), np.asarray(w_w),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(got_h[m].numpy(), np.asarray(w_h),
                                       atol=1e-5, rtol=1e-5)


# b, sq, sk, hq, hkv, d, causal, window: tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, True, 0),
    (1, 256, 256, 8, 2, 64, True, 0),
    (2, 128, 128, 4, 1, 128, True, 64),
    (1, 96, 224, 2, 2, 64, True, 0),      # q shorter than kv (chunk case)
    (1, 128, 128, 4, 4, 64, False, 0),    # bidirectional (encoder)
    (2, 130, 130, 2, 2, 32, True, 0),     # non-multiple-of-block shapes
]


def _qkv(case, dtype, seed=0):
    b, sq, sk, hq, hkv, d = case[:6]
    return [_x(shape, seed + i, dtype) for i, shape in
            enumerate([(b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)])]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(case, dtype):
    causal, window = case[6], case[7]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype)
    want = ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    got = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _pallas_folded(qj, kj, vj, **kw):
    """The Pallas kernel on (B, S, H, D) inputs: heads folded into the
    leading axis and GQA repeated, as ``ops._flash_attention_ref`` feeds
    the oracle; 64-row blocks."""
    b, sq, hq, d = qj.shape
    hkv = kj.shape[2]
    kj, vj = (jnp.repeat(x, hq // hkv, axis=2) for x in (kj, vj))
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * hq, x.shape[1], d)
    out = flash_attention_kernel(fold(qj), fold(kj), fold(vj), block_q=64,
                                 block_k=64, interpret=True, **kw)
    return np.asarray(out.reshape(b, hq, sq, d).transpose(0, 2, 1, 3),
                      np.float32)


# b, sq, sk, hq, hkv, d, causal, window, q_offset: GQA with a window and
# queries inside the keys, and a ragged head-dim-16 case whose lengths
# are no multiple of 16 (every row has keys in both)
FLASH_OFFSET_CASES = [(2, 100, 300, 8, 2, 64, True, 96, 150),
                      (2, 77, 130, 4, 2, 16, True, 24, 53)]


@pytest.mark.parametrize("case", FLASH_OFFSET_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_with_q_offset(case, dtype):
    causal, window, q_offset = case[6:]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype, seed=case[1])
    want = _pallas_folded(qj, kj, vj, causal=causal, window=window,
                          q_offset=q_offset)
    got = flash_attention_plain(qt, kt, vt, causal=causal, window=window,
                                q_offset=q_offset)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=tol)


def test_flash_attention_rows_without_keys_follow_the_oracle():
    """Causal with Sq > Sk: query rows 0..69 sit before every key. The
    oracle (``ref.attention_ref``) gives them the mean of the Sk values,
    and so does the plain version on every row; the Pallas kernel pads
    the keys to whole blocks and gives the padded keys the same finite
    NEG_INF, so on those rows it divides by the padded count instead
    (192 for Sk = 130 and 64-row blocks) and agrees on the rest."""
    b, sq, sk, h, d = 2, 200, 130, 1, 16
    (qj, qt), (kj, kt), (vj, vt) = _qkv((b, sq, sk, h, h, d), "float32",
                                        seed=9)
    fold = lambda x: x[:, :, 0]
    oracle = np.asarray(ref.attention_ref(fold(qj), fold(kj), fold(vj),
                                          causal=True))
    pallas = _pallas_folded(qj, kj, vj, causal=True)[:, :, 0]
    plain = flash_attention_plain(qt, kt, vt, causal=True)[:, :, 0].numpy()
    no_keys = sq - sk
    np.testing.assert_allclose(plain, oracle, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(plain[:, :no_keys],
                               np.broadcast_to(vt[:, :, 0].numpy().mean(
                                   1, keepdims=True), (b, no_keys, d)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(pallas[:, no_keys:], oracle[:, no_keys:],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(pallas[:, :no_keys] * 192 / sk,
                               oracle[:, :no_keys], atol=2e-5, rtol=2e-5)
    assert np.abs(pallas[:, :no_keys] - oracle[:, :no_keys]).max() > 1e-2


# sq, sk, hq, hkv, causal, window, chunk_target: each needs >= 2 query
# chunks; the windowed one slices each chunk's keys to its band
CHUNKED_CASES = [(96, 96, 4, 2, True, 0, 40), (80, 80, 2, 2, True, 24, 32),
                 (64, 64, 2, 1, False, 0, 32)]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_flash_attention_chunked_matches_reference(case):
    sq, sk, hq, hkv, causal, window, target = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv((2, sq, sk, hq, hkv, 16), "float32",
                                        seed=sq)
    want = ref_flash_attention_chunked(qj, kj, vj, causal=causal,
                                       window=window, block_k=32,
                                       chunk_target=target)
    got = flash_attention_chunked(qt, kt, vt, causal=causal, window=window,
                                  chunk_target=target)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_wrappers_use_plain_versions_on_cpu_without_launching():
    reset_launch_counts()
    xt = torch.randn(40, 12)
    assert torch.equal(hessian_accum(xt), hessian_accum_plain(xt))
    arrs = [torch.from_numpy(a) for a in _downdate_inputs(2, 24, 8, 4, 1)]
    for got, want in zip(obs_downdate(*arrs, d_live=16),
                         obs_downdate_plain(*arrs, d_live=16)):
        assert torch.equal(got, want)
    q, k, v = (t for _, t in _qkv((1, 24, 40, 4, 2, 16), "float32"))
    kw = {"causal": True, "window": 8, "q_offset": 10}
    assert torch.equal(flash_attention(q, k, v, **kw),
                       flash_attention_plain(q, k, v, **kw))
    assert hessian_accum.launches == 0 and obs_downdate.launches == 0
    assert flash_attention.launches == 0
