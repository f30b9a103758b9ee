"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one; the
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TF32 is off, so the plain versions' products are full fp32. Tolerances:
hessian_accum 1e-4·√N (the reference's accumulator tolerance; bf16 input
converts exactly to fp32 on both sides; also over an MoE expert's
dispatch slots with the unfilled rows zeroed), obs_downdate 1e-5, flash
attention 2e-5 fp32 and 2e-2 bf16 (the reference's); the SSD intra-chunk
pass 1e-4 in fp32 (fp32 sums of up to a chunk of terms in another order)
and 2e-2 of the output's scale with bf16 B and C (the plain version
rounds the scores to bf16, as the reference's model twin does, the kernel
keeps them fp32: a relative 2^-9 per score, summed over up to a chunk of
terms), and the
chunked scan 2e-3 against the token-by-token recurrence (the reference's
SSD tolerance).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import MAMBA2_2P7B
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 hessian_accum, hessian_accum_plain,
                                 obs_downdate, obs_downdate_plain,
                                 ssd_intra_chunk, ssd_intra_chunk_plain)
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models import forward, generate, model_init
from repro_torch.models.transformer import tree_to


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 64), (1000, 200), (513, 300),
                                   (64, 512), (4096, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hessian_accum_kernel_matches_plain(cuda_device, shape, dtype):
    n, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    acc = torch.randn((d, d), device=cuda_device, generator=g)
    before = hessian_accum.launches
    for a in (None, acc):
        got = hessian_accum(x, a)
        torch.cuda.synchronize()
        want = hessian_accum_plain(x, a)
        torch.testing.assert_close(got, want, atol=1e-4 * n ** 0.5,
                                   rtol=1e-4)
    assert hessian_accum.launches == before + 2


def _hessian_x(n, d, dtype, device, seed, offset=False):
    """Seeded (N, D) input on the card; with ``offset`` a view whose base
    lies one element past the allocation's (not 16-byte aligned)."""
    a = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))
    if not offset:
        return a.to(device=device, dtype=dtype)
    buf = torch.zeros(1 + n * d, dtype=dtype, device=device)
    buf[1:1 + n * d].copy_(a.reshape(-1))
    return buf[1:1 + n * d].view(n, d)


# the kernel's branches: a split of N above 1 (all but the last), D not a
# multiple of 4 (4-byte copies), a base off 16 bytes (4-byte copies), N
# below one strip of 16 rows (one split, direct stores; the direct stores
# of off-diagonal tiles are test_hessian_accum_kernel_matches_plain's
# (64, 512))
@pytest.mark.cuda
@pytest.mark.parametrize("n,d,offset", [(4096, 768, False),
                                        (8192, 256, False),
                                        (257, 131, False),
                                        (1000, 200, True),
                                        (5, 96, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hessian_accum_kernel_branches_match_plain(cuda_device, n, d, offset,
                                                   dtype):
    from repro_torch.kernels.hessian_accum import launch_plan
    x = _hessian_x(n, d, dtype, cuda_device, n * d, offset)
    assert x.is_contiguous()
    if offset:
        assert x.data_ptr() % 16 != 0
    entry, _, plan = launch_plan(x)
    if dtype == torch.float32:
        aligned = d % 4 == 0 and not offset
        assert entry == ("hessian_accum_f32" if aligned
                         else "hessian_accum_f32_unaligned")
    assert (plan.splits > 1) == (n >= 256)  # (5, 96): one split, direct
    acc = _hessian_x(d, d, torch.float32, cuda_device, d)
    for a in (None, acc):
        got = hessian_accum(x, a)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, hessian_accum_plain(x, a),
                                   atol=1e-4 * n ** 0.5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 768), (4096, 3072)])
def test_hessian_accum_kernel_gives_the_same_bits_twice(cuda_device, n, d):
    x = _hessian_x(n, d, torch.float32, cuda_device, 1)
    acc = _hessian_x(d, d, torch.float32, cuda_device, 2)
    first = hessian_accum(x, acc)
    assert torch.equal(first, hessian_accum(x, acc))
    assert torch.equal(hessian_accum(x), hessian_accum(x))


@pytest.mark.cuda
def test_hessian_accum_kernel_takes_an_experts_masked_rows(cuda_device):
    """One expert's dispatch slots in the full-width Phi-3.5-MoE
    calibration (640 slots of d_ff 6400), the slots no token filled
    zeroed by ``core.hessian.xtx``: the kernel against its plain version,
    and against the valid rows alone."""
    from repro_torch.core.hessian import xtx
    n, d = 640, 6400
    x = _hessian_x(n, d, torch.float32, cuda_device, 5)
    valid = torch.from_numpy(np.random.default_rng(6).random(n) > 0.3
                             ).to(cuda_device)
    acc = _hessian_x(d, d, torch.float32, cuda_device, 7)
    before = hessian_accum.launches
    got = xtx(x, valid, acc=acc)
    torch.cuda.synchronize()
    assert hessian_accum.launches == before + 1
    tol = {"atol": 1e-4 * n ** 0.5, "rtol": 1e-4}
    torch.testing.assert_close(
        got, hessian_accum_plain(x * valid[:, None].float(), acc), **tol)
    torch.testing.assert_close(
        got, hessian_accum_plain(x[valid].contiguous(), acc), **tol)


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
    return [torch.from_numpy(a.astype(np.float32))
            for a in (W, Hinv, HcolS, KsWS, KsHcolT, keep)]


# (M, d_in, d_out, gs, d_live): gs == 1 is the outer-product case,
# d_live < d_in the live-prefix restriction; the last two are GPT-2
# small's FFN and attention groups
DOWNDATE_CASES = [(3, 16, 8, 2, None), (2, 96, 64, 16, None),
                  (3, 33, 7, 1, None), (2, 130, 12, 5, None),
                  (2, 96, 24, 4, 64), (3, 130, 12, 1, 96),
                  (2, 64, 16, 8, 32), (12, 3072, 768, 1, None),
                  (12, 768, 768, 64, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DOWNDATE_CASES)
def test_obs_downdate_kernel_matches_plain(cuda_device, case):
    M, d_in, d_out, gs, d_live = case
    arrs = [a.to(cuda_device)
            for a in _downdate_inputs(M, d_in, d_out, gs, 3, d_live)]
    want = obs_downdate_plain(*arrs, d_live=d_live)
    W, Hinv = arrs[0].clone(), arrs[1].clone()
    before = obs_downdate.launches
    got = obs_downdate(W, Hinv, *arrs[2:], d_live=d_live)
    torch.cuda.synchronize()
    assert got[0] is W and got[1] is Hinv  # updated in place
    assert obs_downdate.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_obs_downdate_kernel_takes_a_layers_sixteen_experts(cuda_device):
    """A Phi-3.5-MoE layer's 16 experts as one stack, (M, d_in, d_out, gs)
    = (16, 6400, 4096, 1): the only gs = 1 stack with d_in above 3072
    (inputs drawn on the card; a host draw of Hinv would take minutes)."""
    M, d_in, d_out = 16, 6400, 4096
    g = torch.Generator(device=cuda_device).manual_seed(16)
    W, Hinv = (torch.randn(shape, device=cuda_device, generator=g)
               for shape in ((M, d_in, d_out), (M, d_in, d_in)))
    A, KW, KH = (torch.randn(shape, device=cuda_device, generator=g)
                 for shape in ((M, d_in, 1), (M, 1, d_out), (M, 1, d_in)))
    keep = (torch.rand((M, d_in), device=cuda_device, generator=g) > 0.3
            ).float()
    want = obs_downdate_plain(W, Hinv, A, KW, KH, keep)
    before = obs_downdate.launches
    got = obs_downdate(W, Hinv, A, KW, KH, keep)
    torch.cuda.synchronize()
    assert got[0] is W and got[1] is Hinv
    assert obs_downdate.launches == before + 1
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda_device):
    x = torch.randn((64, 32), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        hessian_accum(x.T)
    with pytest.raises(ValueError, match="acc"):
        hessian_accum(x, torch.zeros((32, 32), dtype=torch.float64,
                                     device=cuda_device))
    arrs = [a.to(cuda_device) for a in _downdate_inputs(2, 24, 8, 4, 1)]
    with pytest.raises(ValueError, match="KsWS"):
        obs_downdate(*arrs[:3], arrs[3].double(), *arrs[4:])
    inside_hinv = arrs[1].view(-1)[:2 * 4 * 24].view(2, 4, 24)
    with pytest.raises(ValueError, match="aliases"):
        obs_downdate(*arrs[:4], inside_hinv, arrs[5])


# b, sq, sk, hq, hkv, d, causal, window, q_offset (None: sk - sq): the
# reference's FLASH_CASES, GPT-2 small's serving prefills, gpt2-tiny's
# head dim, and GQA with a window and queries inside the keys; then the
# rest of the serving buckets (8-256), D = 128 with GQA 8:2 and a window,
# D = 16 and 32 with ragged lengths, one query against 300 keys, fewer
# than 16 keys, non-causal ragged, causal with Sq > Sk (rows without keys,
# no band skip), and a window whose first visited key tile is wholly
# masked for the tile's later rows (q_offset 300, window 20); last
# Phi-3.5-MoE's prefill of 512 tokens (GQA 32:8 at head dim 128)
FLASH_CASES = [(2, 128, 128, 4, 4, 64, True, 0, None),
               (1, 256, 256, 8, 2, 64, True, 0, None),
               (2, 128, 128, 4, 1, 128, True, 64, None),
               (1, 96, 224, 2, 2, 64, True, 0, None),
               (1, 128, 128, 4, 4, 64, False, 0, None),
               (2, 130, 130, 2, 2, 32, True, 0, None),
               (1, 512, 512, 12, 12, 64, True, 0, None),
               (1, 1024, 1024, 12, 12, 64, True, 0, None),
               (3, 77, 77, 4, 4, 16, True, 0, None),
               (2, 100, 300, 8, 2, 64, True, 96, 150)] + [
    (1, s, s, 12, 12, 64, True, 0, None) for s in (8, 16, 32, 64, 128, 256)
] + [(2, 200, 200, 8, 2, 128, True, 48, None),
     (2, 77, 130, 4, 2, 16, True, 0, None),
     (2, 130, 77, 4, 4, 32, True, 24, 90),
     (2, 1, 300, 8, 2, 64, True, 0, 299),
     (2, 9, 12, 4, 2, 64, True, 0, None),
     (2, 77, 130, 4, 4, 32, False, 0, None),
     (2, 200, 130, 4, 2, 16, True, 0, None),
     (2, 128, 500, 4, 2, 64, True, 20, 300),
     (1, 512, 512, 32, 8, 128, True, 0, None)]  # Phi-3.5-MoE's prefill


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, case, dtype):
    b, sq, sk, hq, hkv, d, causal, window, q_offset = case
    g = torch.Generator(device=cuda_device).manual_seed(sq + sk)
    q, k, v = (torch.randn(shape, device=cuda_device, generator=g).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_rows_without_keys_take_the_mean_of_all_values(
        cuda_device, dtype):
    """Causal with Sq > Sk: query rows 0..Sq-Sk-1 sit before every key, so
    every score of theirs is NEG_INF and the oracle (and the plain
    version) gives them the mean of the Sk values, not of a padded count."""
    b, sq, sk, hq, hkv, d = 2, 200, 130, 4, 2, 16
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(shape, device=cuda_device, generator=g).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    mean = v.float().mean(dim=1).repeat_interleave(hq // hkv, dim=1)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[:, :sq - sk].float(),
                               mean[:, None].expand(b, sq - sk, hq, d),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), flash_attention_plain(
        q, k, v, causal=True).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_raises_on_inputs_it_does_not_take(cuda_device):
    q = torch.randn((1, 8, 4, 64), device=cuda_device)
    kv = torch.randn((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                        kv[..., :48].contiguous())
    with pytest.raises(ValueError, match="k must be"):
        flash_attention(q, kv.double(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        kv, kv)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q[:, :, :3].contiguous(), kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q.half(), kv.half(), kv.half())
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(flat[1:].view(q.shape), kv.bfloat16(), kv.bfloat16())


# b, nc, q, h, p, n: the reference's SSD_CASES cut into chunks, Mamba-2
# 2.7B's calibration widths (one batch row), a chunk of 256, a ragged
# chunk with p = 128, and the largest chunk the kernel takes; then the
# kernel's edges: head groups of unequal size (10 heads over 4 groups), a
# chunk that is not a multiple of 16 rows (and of two query tiles), a
# ragged state size (element copies of B and C; 13 is odd, so the states
# are stored element by element), a state size above one slab of B/C
# columns, N = 8 (padded to a k16 step in bf16), P = 16 and P = 128
SSD_CASES = [(2, 2, 32, 4, 32, 16), (1, 3, 32, 8, 16, 8),
             (2, 4, 16, 2, 64, 32), (1, 2, 64, 6, 32, 16),
             (1, 4, 128, 80, 64, 128), (1, 1, 256, 8, 64, 128),
             (2, 1, 100, 3, 128, 40), (1, 1, 512, 2, 16, 8),
             (8, 4, 128, 10, 64, 128), (1, 2, 50, 5, 16, 24),
             (1, 1, 300, 3, 32, 16), (1, 2, 64, 5, 32, 13),
             (1, 1, 128, 4, 64, 200), (2, 1, 128, 3, 128, 8),
             (1, 1, 1, 2, 16, 8)]


def _intra_chunk_inputs(b, nc, q, h, p, n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xdt = torch.randn((b, nc, q, h, p), device=dev, generator=g) * 0.5
    dA = -torch.rand((b, nc, q, h), device=dev, generator=g) * 0.3
    dacs = torch.cumsum(dA, dim=2)
    B, C = (torch.randn((b, nc, q, n), device=dev, generator=g) * 0.5
            for _ in range(2))
    return xdt, dacs, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_matches_plain(cuda_device, case, dtype):
    xdt, dacs, B, C = _intra_chunk_inputs(*case, cuda_device, sum(case))
    B, C = B.to(dtype), C.to(dtype)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(xdt, dacs, B, C)
    torch.cuda.synchronize()
    assert ssd_intra_chunk.launches == before + 1
    want = ssd_intra_chunk_plain(xdt, dacs, B, C)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        else:
            torch.testing.assert_close(g, w, atol=2e-2 * float(w.abs().max()),
                                       rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_takes_an_unaligned_xdt(cuda_device, dtype):
    """xdt 4 bytes past a 16-byte boundary (element copies of xdt), B and C
    views 4 bytes past one too (element copies of B and C)."""
    xdt, dacs, B, C = _intra_chunk_inputs(1, 2, 64, 3, 32, 16, cuda_device, 5)
    B, C = B.to(dtype), C.to(dtype)

    def shifted(t):
        pad = 4 // t.element_size()
        buf = torch.empty(t.numel() + pad, device=cuda_device, dtype=t.dtype)
        buf[pad:].copy_(t.reshape(-1))
        return buf[pad:].view(t.shape)

    xdt_u, B_u, C_u = shifted(xdt), shifted(B), shifted(C)
    assert xdt_u.data_ptr() % 16 != 0 and B_u.data_ptr() % 16 != 0
    got = ssd_intra_chunk(xdt_u, dacs, B_u, C_u)
    torch.cuda.synchronize()
    for g, w in zip(got, ssd_intra_chunk(xdt, dacs, B, C)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(8, 4, 128, 80, 64, 128),
                                  (1, 1, 512, 5, 64, 128),
                                  (2, 1, 100, 3, 128, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel_gives_the_same_bits_twice(cuda_device, case,
                                                          dtype):
    xdt, dacs, B, C = _intra_chunk_inputs(*case, cuda_device, 3)
    B, C = B.to(dtype), C.to(dtype)
    first = ssd_intra_chunk(xdt, dacs, B, C)
    second = ssd_intra_chunk(xdt, dacs, B, C)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def ssd_recurrence(x, dt, A, B, C, initial_state=None):
    """Token-by-token SSD recurrence (the reference's ``ref.ssd_ref``)."""
    b, s, h, p = x.shape
    state = (initial_state if initial_state is not None else
             torch.zeros((b, h, p, B.shape[-1]), device=x.device))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), state))
    return torch.stack(ys, 1).to(x.dtype), state


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 64, 4, 32, 16, 32),
                                             (2, 50, 2, 64, 32, 16),
                                             (1, 300, 8, 64, 128, 128)])
def test_ssd_chunked_on_the_card_matches_the_recurrence(cuda_device, b, s, h,
                                                        p, n, chunk):
    g = torch.Generator(device=cuda_device).manual_seed(s)
    x = torch.randn((b, s, h, p), device=cuda_device, generator=g) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), device=cuda_device, generator=g))
    A = -torch.exp(torch.randn((h,), device=cuda_device, generator=g) * 0.3)
    B, C = (torch.randn((b, s, n), device=cuda_device, generator=g) * 0.5
            for _ in range(2))
    init = torch.randn((b, h, p, n), device=cuda_device, generator=g) * 0.1
    for state in (None, init):
        before = ssd_intra_chunk.launches
        y, st = ssd_chunked(x, dt, A, B, C, chunk, initial_state=state)
        torch.cuda.synchronize()
        assert ssd_intra_chunk.launches == before + 1
        y_w, st_w = ssd_recurrence(x, dt, A, B, C, state)
        torch.testing.assert_close(y, y_w, atol=2e-3, rtol=2e-3)
        torch.testing.assert_close(st, st_w, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_ssd_intra_chunk_raises_on_inputs_it_does_not_take(cuda_device):
    xdt, dacs, B, C = _intra_chunk_inputs(1, 2, 32, 4, 32, 16, cuda_device, 0)
    with pytest.raises(ValueError, match="head dim"):
        ssd_intra_chunk(xdt[..., :24].contiguous(), dacs, B, C)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_intra_chunk(xdt, dacs, B.double(), C.double())
    with pytest.raises(ValueError, match="xdt and dacs must be float32"):
        ssd_intra_chunk(xdt.bfloat16(), dacs, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_intra_chunk(xdt, dacs, B.transpose(2, 3).contiguous()
                        .transpose(2, 3), C)
    big = _intra_chunk_inputs(1, 1, 520, 2, 16, 8, cuda_device, 0)
    with pytest.raises(ValueError, match="chunk"):
        ssd_intra_chunk(*big)


@pytest.mark.cuda
def test_mamba2_forward_and_generate_on_the_card_match_the_cpu(cuda_device):
    """A 2-layer Mamba-2 at the reference's smoke widths, fp32: the card
    (the SSD kernel) against the CPU (its plain version) on the same
    weights."""
    cfg = MAMBA2_2P7B.replace(num_layers=2, d_model=128, ssm_state=16,
                              ssm_head_dim=32, ssm_chunk=32, vocab_size=512,
                              dtype="float32")
    p_cpu = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_to(p_cpu, cuda_device)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 70)))
    before = ssd_intra_chunk.launches
    got = forward(cfg, p_gpu, tokens.to(cuda_device))["logits"].cpu()
    assert ssd_intra_chunk.launches == before + cfg.num_layers
    want = forward(cfg, p_cpu, tokens)["logits"]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(generate(cfg, p_gpu, tokens.to(cuda_device), 8).cpu(),
                       generate(cfg, p_cpu, tokens, 8))
