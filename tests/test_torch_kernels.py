"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and
``kernels/ref.py`` oracles, and the wrappers' CPU routing. The CUDA
kernels against their plain versions are in tests/test_torch_cuda.py.

Tolerances are the reference's (tests/test_kernels.py,
tests/test_batched_db.py): hessian_accum 1e-3·√N fp32, 1e-1·√N bf16,
1e-4·√N with an accumulator; obs_downdate 1e-5; flash attention 2e-5
fp32, 2e-2 bf16; the SSD kernel's split-TF32 arithmetic 1e-4 (its fp32
tolerance on the card).
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
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.hessian_accum import last_wave_fill, split_plan
from repro_torch.kernels.ssd_scan import (BWD_SETUP, BWD_WAVE, DBC_HPG,
                                          DBC_TILE, HEAD_DIMS, MAX_CHUNK,
                                          SMEM_LIMIT, bwd_layout, bwd_plan,
                                          intra_chunk_inputs, ssd_chunked,
                                          ssd_intra_chunk,
                                          ssd_intra_chunk_plain, ssd_layout,
                                          ssd_plan, waves)
from repro_torch.models.attention import flash_attention_chunked


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


GRAD_WRAPPERS = ["flash_attention", "ssd_intra_chunk", "ssd_chunked"]


def grad_call(name, device):
    """One small call of a kernel wrapper: (fn, inputs on ``device`` that
    require grad)."""
    g = torch.Generator().manual_seed(0)
    if name == "flash_attention":
        args = [torch.randn(shape, generator=g) for shape in
                [(1, 24, 4, 16), (1, 24, 2, 16), (1, 24, 2, 16)]]
        fn = lambda *a: flash_attention(*a, causal=True)  # noqa: E731
    else:
        b, s, h, p, n, chunk = 1, 64, 2, 16, 8, 32
        x = torch.randn((b, s, h, p), generator=g) * 0.5
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
        A = -torch.exp(torch.randn((h,), generator=g) * 0.3)
        B, C = (torch.randn((b, s, n), generator=g) * 0.5 for _ in range(2))
        if name == "ssd_chunked":
            args = [x, dt, A, B, C]
            fn = lambda *a: ssd_chunked(*a, chunk)[0]  # noqa: E731
        else:
            args = list(intra_chunk_inputs(x, dt, A, B, C, chunk))
            fn = lambda *a: ssd_intra_chunk(*a)[0]  # noqa: E731
    return fn, [a.to(device).requires_grad_(True) for a in args]


def _grad_fn_names(out):
    """The names of the autograd nodes ``out`` was computed through."""
    seen, todo, names = set(), [out.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(fn for fn, _ in node.next_functions)
    return names


@pytest.mark.parametrize("name", GRAD_WRAPPERS)
def test_kernel_wrappers_refuse_inputs_that_require_grad(name, monkeypatch):
    """Off the CPU a wrapper launches its kernel. Flash attention's kernel
    has no backward: a call with grad mode on and an input that requires
    grad raises before the launch instead of returning a result without a
    ``grad_fn``. The SSD pass has one now (``SsdIntraChunk``), so its two
    wrappers no longer refuse: the contract that replaced the refusal
    (and keeps this test's name) is that their result carries
    ``SsdIntraChunk``'s ``grad_fn``, so no gradient is dropped. The meta
    device takes the kernel's branch on a machine without a card; the SSD
    forward launch is swapped for a stub that returns empty outputs of
    the right shapes."""
    fn, args = grad_call(name, "meta")
    if name == "flash_attention":
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        return

    def stub(xdt, dacs, B, C):
        b, nc, q, h, p = xdt.shape
        return (torch.empty_like(xdt),
                torch.empty((b, nc, h, p, B.shape[3]), device=xdt.device))

    monkeypatch.setattr(ssd_scan, "_launch_forward", stub)
    out = fn(*args)
    assert out.device.type == "meta" and out.shape == args[0].shape
    assert "SsdIntraChunkBackward" in _grad_fn_names(out)


@pytest.mark.parametrize("name", GRAD_WRAPPERS)
def test_plain_paths_stay_differentiable_on_the_cpu(name):
    reset_launch_counts()
    fn, args = grad_call(name, "cpu")
    out = fn(*args)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for a in args:
        assert a.grad is not None and bool(torch.isfinite(a.grad).all())
        assert bool(a.grad.any())
    assert flash_attention.launches == 0 and ssd_intra_chunk.launches == 0


# ----------------------------------------------------------------------
# the SSD kernel's arithmetic and launch plan (csrc/ssd_scan.cu), on the
# CPU: the card tests hold the kernel itself to its plain version
# ----------------------------------------------------------------------

# b, s, h, p, n, chunk: the reference's SSD_CASES (tests/test_kernels.py),
# then one full-width batch of Mamba-2 2.7B: one 128-step chunk, 80 heads
SSD_EMULATED = [(2, 64, 4, 32, 16, 32), (1, 96, 8, 16, 8, 32),
                (2, 50, 2, 64, 32, 16), (1, 128, 6, 32, 16, 64),
                (1, 128, 80, 64, 128, 128)]
SSD_TOL = 1e-4  # the kernel's fp32 tolerance (atol = rtol)


def _tf32(x):
    """TF32 rounding as the kernel does it: to nearest, ties away from
    zero, on the low 13 bits of the fp32 pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_mm(a, b, products):
    """a @ b on TF32 operands with fp32 sums: 3 products (lo*hi + hi*lo +
    hi*hi, x = hi + lo, hi = tf32(x), lo = tf32(x - hi)), 2 where b is
    exact in TF32 (lo*b + hi*b), or 1 (tf32(a) tf32(b))."""
    a_hi = _tf32(a)
    if products == 1:
        return a_hi @ _tf32(b)
    a_lo = _tf32(a - a_hi)
    if products == 2:
        return a_lo @ b + a_hi @ b
    b_hi = _tf32(b)
    b_lo = _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _ssd_emulated(xdt, dacs, B, C, split=True):
    """The kernel's arithmetic: scores exact from bf16 B and C (bf16 MMA)
    or in split TF32 from fp32; y_diag = M xdt in split TF32 (3 products);
    the states in split TF32 (2 products with bf16 B, 3 with fp32). With
    ``split=False`` every fp32 operand takes a single TF32 product."""
    q = xdt.shape[2]
    exact = B.dtype == torch.bfloat16
    Bf, Cf = B.float(), C.float()
    full = 3 if split else 1
    scores = (Cf @ Bf.transpose(-1, -2) if exact
              else _split_mm(Cf, Bf.transpose(-1, -2), full))
    diff = dacs[:, :, :, None, :] - dacs[:, :, None, :, :]  # (b,nc,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    decay = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    m = (scores[..., None] * decay).permute(0, 1, 4, 2, 3)  # (b,nc,h,q,k)
    y = _split_mm(m, xdt.permute(0, 1, 3, 2, 4), full).permute(0, 1, 3, 2, 4)
    xdec = xdt * torch.exp(dacs[:, :, -1:, :] - dacs)[..., None]
    states = _split_mm(xdec.permute(0, 1, 3, 4, 2), Bf[:, :, None],
                       (2 if exact else 3) if split else 1)
    return y, states


def _ssd_case_inputs(case, dtype):
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B, C = (rng.standard_normal((b, s, n)) * 0.5 for _ in range(2))
    x, dt, A, B, C = (torch.from_numpy(a.astype(np.float32))
                      for a in (x, dt, A, B, C))
    xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, chunk)
    return xdt, dacs, Bb.to(dtype), Cb.to(dtype)


@pytest.mark.parametrize("case", SSD_EMULATED, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32 B/C", "bf16 B/C"])
def test_ssd_split_tf32_arithmetic_holds_the_fp32_tolerance(case, dtype):
    """The kernel's split TF32 against its plain version in fp32 (with
    bf16 B and C the plain version on B and C in fp32: the kernel's bf16
    scores are exact products), within 1e-4; a single TF32 product
    beside it, printed: it is why the kernel pays for the split."""
    xdt, dacs, B, C = _ssd_case_inputs(case, dtype)
    want = ssd_intra_chunk_plain(xdt, dacs, B.float(), C.float())
    split = _ssd_emulated(xdt, dacs, B, C)
    single = _ssd_emulated(xdt, dacs, B, C, split=False)
    for name, got, w in zip(("y_diag", "states"), split, want):
        err = float((got - w).abs().max())
        err1 = float((single[name == "states"] - w).abs().max())
        print(f"{case} {dtype}: {name} split TF32 max_abs_err={err:.2e}, "
              f"single TF32 {err1:.2e} (|plain| up to "
              f"{float(w.abs().max()):.2e})")
        torch.testing.assert_close(got, w, atol=SSD_TOL, rtol=SSD_TOL)
    if case[2] == 80:  # at full width a single TF32 product misses 1e-4
        assert not all(torch.allclose(g, w, atol=SSD_TOL, rtol=SSD_TOL)
                       for g, w in zip(single, want))


def _ssd_bwd_emulated(xdt, dacs, B, C, dy, dstates, split=True):
    """The backward kernel's arithmetic (csrc/ssd_scan_bwd.cu), fp32 out:
    S exact from bf16 B and C (bf16 MMA) or in split TF32 from fp32; G^T =
    xdt dy^T, (S o L)^T dy and the states' share of dB in split TF32 (3
    products); W = B dstates^T, dC = dS B and dS^T C in 2 (lo*B + hi*B)
    with bf16 B and C, 3 with fp32. With ``split=False`` every product is
    a single TF32 one."""
    q = xdt.shape[2]
    exact = B.dtype == torch.bfloat16
    Bf, Cf = B.float(), C.float()
    full = 3 if split else 1
    half = (2 if exact else 3) if split else 1
    S = (Cf @ Bf.transpose(-1, -2) if exact
         else _split_mm(Cf, Bf.transpose(-1, -2), full))     # (b,nc,q,k)
    diff = dacs[:, :, :, None, :] - dacs[:, :, None, :, :]  # (b,nc,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool).tril()[:, :, None]
    L = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    e = torch.exp(dacs[:, :, -1:, :] - dacs)                  # (b,nc,q,h)
    xh, yh = xdt.permute(0, 1, 3, 2, 4), dy.permute(0, 1, 3, 2, 4)
    Gt = _split_mm(xh, yh.transpose(-1, -2), full)            # (b,nc,h,k,q)
    GL = Gt.permute(0, 1, 4, 3, 2) * L                         # (b,nc,q,k,h)
    dS = GL.sum(-1)
    R = GL * S[..., None]
    M = (S[..., None] * L).permute(0, 1, 4, 3, 2)              # (b,nc,h,k,q)
    # W^T = dstates B^T: dstates split, B exact when bf16
    W = _split_mm(dstates, Bf[:, :, None].transpose(-1, -2),
                  half).transpose(-1, -2)                      # (b,nc,h,k,p)
    dx = (_split_mm(M, yh, full) + e.permute(0, 1, 3, 2)[..., None] * W)
    u = (xh * W).sum(-1).permute(0, 1, 3, 2)                   # (b,nc,q,h)
    b, nc, _, h, p = xdt.shape
    xe = (xdt * e[..., None]).reshape(b, nc, q, h * p)
    dB = (_split_mm(xe, dstates.reshape(b, nc, h * p, -1), full)
          + _split_mm(dS.transpose(-1, -2), Cf, half))
    dC = _split_mm(dS, Bf, half)
    eu = e * u
    ddacs = R.sum(3) - R.sum(2) - eu
    ddacs = torch.cat([ddacs[:, :, :-1], ddacs[:, :, -1:]
                       + eu.sum(2, keepdim=True)], dim=2)
    return dx.permute(0, 1, 3, 2, 4), ddacs, dB, dC


def _ssd_bwd_cotangents(case, xdt, n):
    b, nc, q, h, p = xdt.shape
    rng = np.random.default_rng(sum(case) + 1)
    return (torch.from_numpy(rng.standard_normal(xdt.shape)
                             .astype(np.float32)),
            torch.from_numpy(rng.standard_normal((b, nc, h, p, n))
                             .astype(np.float32)))


@pytest.mark.parametrize("case", SSD_EMULATED, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32 B/C", "bf16 B/C"])
def test_ssd_backward_split_tf32_arithmetic_holds_the_fp32_tolerance(
        case, dtype):
    """The backward kernel's split TF32 against
    ``ssd_intra_chunk_backward_plain`` (on B and C in fp32: the kernel's
    bf16 scores and bf16 operands are exact), each gradient within 1e-4
    of its own scale; a single TF32 product beside it, printed. At the
    80-head case a single product misses 1e-4 of scale (ddacs too, whose
    row and column sums of R cancel): it is why the kernel pays for the
    split."""
    xdt, dacs, B, C = _ssd_case_inputs(case, dtype)
    dy, dstates = _ssd_bwd_cotangents(case, xdt, B.shape[-1])
    want = ssd_scan.ssd_intra_chunk_backward_plain(
        xdt, dacs, B.float(), C.float(), dy, dstates)
    split = _ssd_bwd_emulated(xdt, dacs, B, C, dy, dstates)
    single = _ssd_bwd_emulated(xdt, dacs, B, C, dy, dstates, split=False)
    missed = []
    for name, got, one, w in zip(("dxdt", "ddacs", "dB", "dC"), split,
                                 single, want):
        scale = float(w.abs().max())
        err, err1 = (float((x - w).abs().max()) for x in (got, one))
        print(f"{case} {dtype}: {name} split TF32 {err / scale:.2e} of "
              f"scale, single TF32 {err1 / scale:.2e} (scale {scale:.2e})")
        assert err <= SSD_TOL * scale, name
        if err1 > SSD_TOL * scale:
            missed.append(name)
    if case[2] == 80:
        assert missed, "a single TF32 product held 1e-4 of scale"


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 step above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -11 - 2.0 ** -23])
    assert _tf32(x).tolist() == [1.0, one, 1.0, -one, 1.0]


@pytest.mark.parametrize("p", HEAD_DIMS)
def test_ssd_layout_fits_every_chunk_the_wrapper_takes(p):
    """Every chunk of 1..512 rows: a query tile of whole 16-row slices
    (the chunk up to 128 rows, else 64-row tiles), aligned regions in
    order, the score tiles of the last query tile, within Hopper's 232,448
    bytes of shared memory a block."""
    for q in range(1, MAX_CHUNK + 1):
        lay = ssd_layout(q, p)
        assert lay.qt % 16 == 0 and lay.qt <= 128
        assert lay.qt * (lay.tiles - 1) < q <= lay.qt * lay.tiles
        assert lay.tiles == 1 or lay.qt == 64
        regions = [0, lay.off_s, lay.off_b, lay.off_dac, lay.off_dec,
                   lay.smem]
        assert all(r % 16 == 0 for r in regions[:-1])
        assert regions == sorted(regions)
        # two xdt stages, or the C and B rows of the score pass
        assert lay.off_s >= max(2 * lay.qt * (p + 4) * 4,
                                (lay.qt + 64) * 272)
        r, i0 = lay.qt // 16, (lay.tiles - 1) * lay.qt
        assert lay.off_b - lay.off_s == sum(
            i0 // 8 + 2 * (s + 1) for s in range(r)) * 512
        assert lay.off_b + lay.qt * 272 == lay.off_dac
        assert lay.off_dec - lay.off_dac == 2 * (lay.tiles * lay.qt + 4) * 4
        assert lay.smem - lay.off_dec == lay.qt * 4 <= SMEM_LIMIT


# bc, q, h, p: the calibration batch at 80, 16 and 10 heads (unequal
# groups), chunks of two and five query tiles, a ragged chunk at p = 128,
# one row
SSD_PLANS = [(32, 128, 80, 64), (32, 128, 16, 64), (32, 128, 10, 64),
             (2, 256, 5, 64), (1, 300, 3, 32), (3, 100, 7, 128), (1, 1, 2, 16)]
SSD_CARDS = [(132, 1), (132, 2), (114, 1), (8, 1)]


@pytest.mark.parametrize("bc,q,h,p", SSD_PLANS)
@pytest.mark.parametrize("sms,bps", SSD_CARDS)
def test_ssd_plan_covers_every_chunk_head_and_query_tile_once(bc, q, h, p,
                                                              sms, bps):
    plan = ssd_plan(bc, q, h, p, sms, bps)
    tiles = plan.layout.tiles
    assert 1 <= plan.groups <= h
    assert plan.blocks == tiles * bc * plan.groups
    work = list(plan.work())
    assert [w[0] for w in work] == sorted((w[0] for w in work),
                                          reverse=True)  # longest first
    assert all(lo < hi for _, _, lo, hi in work)
    got = [(tile, chunk, hd) for tile, chunk, lo, hi in work
           for hd in range(lo, hi)]
    assert len(got) == len(set(got))
    assert set(got) == {(tile, chunk, hd) for tile in range(tiles)
                        for chunk in range(bc) for hd in range(h)}


@pytest.mark.parametrize("bc,q,h,p", SSD_PLANS)
@pytest.mark.parametrize("sms,bps", SSD_CARDS)
def test_ssd_plan_takes_the_least_waves_times_heads(bc, q, h, p, sms, bps):
    """The head groups minimise waves x (0.5 + the largest group's heads),
    the fewest groups on a tie."""
    plan = ssd_plan(bc, q, h, p, sms, bps)

    def cost(g):
        return (waves(plan.layout.tiles * bc * g, sms * bps)
                * (0.5 + -(-h // g)))

    best = min(range(1, h + 1), key=lambda g: (cost(g), g))
    assert plan.groups == best


def test_ssd_plan_at_the_calibration_batch_on_an_h100():
    """What the kernel's source header states: at (BC, Q, P) = (32, 128,
    64), 142,880 bytes of shared memory (one block an SM) and 4 groups of
    heads, 128 blocks, for 80, 40 and 16 heads. 128 blocks leave 4 of 132
    SMs idle for one wave; 5 groups would take a second wave."""
    assert ssd_layout(128, 64).smem == 142880
    for h in (80, 40, 16):
        plan = ssd_plan(32, 128, h, 64, 132, 1)
        assert plan.groups == 4 and plan.blocks == 128
        assert waves(plan.blocks, 132) == 1
        assert waves(32 * 5, 132) == 2


# b * nc, q, h, p, n: the backward's shapes (the train step's, ragged
# chunks and state sizes, one row, many chunks)
SSD_BWD_PLANS = [(32, 128, 80, 64, 128), (4, 32, 4, 32, 16),
                 (2, 100, 3, 128, 40), (1, 300, 3, 32, 13), (1, 1, 2, 16, 8),
                 (2, 512, 80, 64, 128), (4096, 128, 80, 64, 128)]


@pytest.mark.parametrize("bc,q,h,p,n", SSD_BWD_PLANS)
def test_ssd_backward_plan_splits_within_the_kernels_limits(bc, q, h, p, n):
    """The backward's head groups (dx_pass) and groups of the states'
    product (dbc_pass), from the shapes alone: each group non-empty and
    within the kernels' limits (at most DBC_HPG heads a dbc_pass group,
    its shared memory within SMEM_LIMIT, a launch's blocks within one
    grid dimension); dx_pass's groups minimise waves of BWD_WAVE blocks x
    (BWD_SETUP + the largest group's heads), the fewest on a tie; dbc_pass
    takes about two waves of heavy blocks. At the train step's shape: one
    128-row tile, 4 head groups of 20 heads (128 blocks, one wave on 132
    SMs), 8 groups of 10 heads in dbc_pass (256 heavy blocks)."""
    for bf16 in (True, False):
        plan = bwd_plan(bc, q, h, p, n, bf16)
        pairs = plan.layout.pairs
        assert 1 <= plan.hg <= h and 1 <= plan.sg <= h
        assert -(-h // plan.sg) <= DBC_HPG
        assert plan.blocks == bc * pairs * plan.hg <= 2 ** 31 - 1
        assert plan.dbc_blocks <= 2 ** 31 - 1
        assert plan.dbc_smem <= SMEM_LIMIT

        def cost(g):
            return (waves(bc * pairs * g, BWD_WAVE)
                    * (BWD_SETUP + -(-h // g)))

        assert plan.hg == min(range(1, h + 1), key=lambda g: (cost(g), g))
        units = bc * -(-q // DBC_TILE) * -(-n // DBC_TILE)
        assert plan.sg == min(h, max(-(-h // DBC_HPG), 2 * BWD_WAVE // units))
        assert len(plan.args()) == 19
    if (bc, q, h, p, n) == (32, 128, 80, 64, 128):
        plan = bwd_plan(bc, q, h, p, n, True)
        assert (plan.layout.t, plan.layout.tiles, plan.layout.slots) == \
            (128, 1, 4)
        assert (plan.hg, plan.blocks, waves(plan.blocks, 132)) == (4, 128, 1)
        assert (plan.sg, plan.sg * bc) == (8, 256)


@pytest.mark.parametrize("p", HEAD_DIMS)
def test_ssd_backward_layout_fits_every_shape_the_wrapper_takes(p):
    """Every chunk of 1..512 rows, N in {1, 13, 40, 128, 256}, bf16 and
    fp32 B/C: a tile of whole 16-row slices (the chunk padded up to 128
    rows, 64 at P = 128, else 64-row tiles), a slab of whole k-steps,
    3 or 4 ring slots that hold a head's xdt, dy and dstates slab, the
    regions aligned and in order, within SMEM_LIMIT."""
    tmax = 64 if p == 128 else 128
    for bf16 in (True, False):
        kstep, esize = (16, 2) if bf16 else (8, 4)
        for n in (1, 13, 40, 128, 256):
            for q in range(1, MAX_CHUNK + 1):
                lay = bwd_layout(q, p, n, bf16)
                t, r = lay.t, lay.t // 16
                assert t % 16 == 0 and t <= tmax
                assert t * (lay.tiles - 1) < q <= t * lay.tiles
                if q <= tmax:
                    assert (t, lay.tiles) == (-(-q // 16) * 16, 1)
                else:
                    assert t == 64
                assert lay.ns % kstep == 0 and 0 < lay.ns <= 256 // esize
                assert lay.ns <= -(-n // kstep) * kstep
                assert lay.slots in (3, 4)
                assert lay.slot >= max(t * (p + 4) * 4,
                                       p * (lay.ns + 4) * 4)
                frags = r * (r + 1) if lay.tiles == 1 else 2 * r * r
                b_bytes = t * (lay.ns + (8 if bf16 else 4)) * esize
                regions = [0, lay.off_b, lay.off_ring, lay.off_dac,
                           lay.off_dec, lay.off_red, lay.smem]
                assert all(x % 16 == 0 for x in regions[:-1])
                assert regions == sorted(regions)
                assert lay.off_b == frags * 512
                assert lay.off_ring >= lay.off_b + b_bytes
                assert lay.off_dac - lay.off_ring >= max(
                    lay.slots * lay.slot, b_bytes)
                assert lay.off_dec - lay.off_dac == 2 * (2 * t + 4) * 4
                parts = 8 // ((r + 1) // 2)
                assert lay.smem - lay.off_red == (r + 2 * parts + 1) * t * 4
                assert lay.smem <= SMEM_LIMIT


@pytest.mark.parametrize("bc,q,h,p,n", SSD_BWD_PLANS)
def test_ssd_backward_plan_covers_every_chunk_tile_pair_and_head_once(
        bc, q, h, p, n):
    """dx_pass's blocks, as the kernel decodes them: every (chunk, query
    tile, key tile at or before it, head) exactly once, each block a
    non-empty run of heads."""
    plan = bwd_plan(bc, q, h, p, n)
    tiles = plan.layout.tiles
    got = []
    for chunk, qt, kt, lo, hi in plan.work():
        assert 0 <= kt <= qt < tiles and lo < hi
        got.extend((chunk, qt, kt, hd) for hd in range(lo, hi))
    assert len(got) == len(set(got))
    assert set(got) == {(chunk, qt, kt, hd) for chunk in range(bc)
                        for qt in range(tiles) for kt in range(qt + 1)
                        for hd in range(h)}
