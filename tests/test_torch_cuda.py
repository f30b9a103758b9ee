"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one; the
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

TF32 is off, so the plain versions' products are full fp32. Tolerances:
hessian_accum 1e-4·√N (the reference's accumulator tolerance; bf16 input
converts exactly to fp32 on both sides), obs_downdate 1e-5, flash
attention 2e-5 fp32 and 2e-2 bf16 (the reference's).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 hessian_accum, hessian_accum_plain,
                                 obs_downdate, obs_downdate_plain)


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
# head dim, and GQA with a window and queries inside the keys
FLASH_CASES = [(2, 128, 128, 4, 4, 64, True, 0, None),
               (1, 256, 256, 8, 2, 64, True, 0, None),
               (2, 128, 128, 4, 1, 128, True, 64, None),
               (1, 96, 224, 2, 2, 64, True, 0, None),
               (1, 128, 128, 4, 4, 64, False, 0, None),
               (2, 130, 130, 2, 2, 32, True, 0, None),
               (1, 512, 512, 12, 12, 64, True, 0, None),
               (1, 1024, 1024, 12, 12, 64, True, 0, None),
               (3, 77, 77, 4, 4, 16, True, 0, None),
               (2, 100, 300, 8, 2, 64, True, 96, 150)]


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
