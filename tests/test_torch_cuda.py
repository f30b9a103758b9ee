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
SSD tolerance). The SSD backward kernel against its plain version 1e-4
of each gradient's scale with fp32 B and C, 2e-2 with bf16 (both sides
form the scores in fp32 and round dB and dC once), and a Mamba-2 train
step's gradients card against CPU 2e-2 of each gradient's scale (the
loss 1e-3 relative). The train step on the card against the CPU: each
metric 1e-3 relative (ROADMAP's loss tolerance), masked rows exactly 0;
a killed and resumed run on the card bit for bit against an
uninterrupted one. The measured latency table's entries within 20% of
the profiler's device time a call of their modules. The smoke models with
frames (Whisper, Llama-3.2-Vision with one and two cross groups), gates
open: logits card against CPU 1e-4 of their scale, greedy tokens through
the cross cache equal. Under fault plans: an injected ``kernel.pallas``
failure raises out of each wrapper on CUDA tensors before it launches,
and decode steps recomputed after a failure give the clean tokens.
Two ranks on the card (gloo groups through ``launch.subproc.run_ranks``):
sharded Hessians within 1e-5 of max |H| of the single-process ones, and
a sharded database fed the single-process Hessians bit for bit the
single-process build (at this width each rank runs one lane of two: the
Algorithm-1 step runs its score sum and solves module by module, since
their batched forms round a lane by the stack's size on the card;
``scripts/diag_torch_lane_bits.py``), on every rank, both kernels
launched on each. A loss-scored SPDY search placed over ``["cuda",
"cuda"]`` (two streams of one card, two threads) gives the unplaced
search's assignments, scores and histories bit for bit.
"""
import itertools
import json
import os
import warnings

# the train step runs under deterministic algorithms, which on CUDA need
# this set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import GPT2_SMALL, MAMBA2_2P7B, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import spdy
from repro_torch.core.database import (SnapshotCache, apply_assignment,
                                       build_database)
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                       gradual_prune, masks_from_assignment)
from repro_torch.data import (calibration_batches, make_batch_np,
                              synthetic_stream)
from repro_torch.launch import train as train_cli
from repro_torch.launch.subproc import run_ranks
from repro_torch.core.latency import build_table
from repro_torch.core.oneshot import make_batched_eval
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 hessian_accum, hessian_accum_plain,
                                 obs_downdate, obs_downdate_plain,
                                 ssd_intra_chunk, ssd_intra_chunk_backward,
                                 ssd_intra_chunk_backward_plain,
                                 ssd_intra_chunk_plain)
from repro_torch.kernels.ssd_scan import intra_chunk_inputs, ssd_chunked
from repro_torch.models import forward, generate, model_init
from repro_torch.models.transformer import tree_to
from repro_torch.optim.adamw import tree_leaves
from repro_torch.robustness import (FaultInjected, FaultPlan, install,
                                    report_scope)
from repro_torch.runtime.costmodel import H100_SXM, HardwareSpec, InferenceEnv
from repro_torch.runtime.device import to_host
from repro_torch.serve import DenseServeModel, ServeEngine, synthetic_requests
from repro_torch.train import (Trainer, make_train_state, make_train_step)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 999, 1000, 1001, 2000, 3500])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32,
                                   torch.int64])
def test_to_host_equals_cpu_at_chunk_edges(cuda_device, n, dtype):
    """The staged device-to-host copy gives ``.cpu()``'s bits at every
    edge of its 1000-element chunks (one buffer, two, a ragged tail)."""
    x = torch.arange(n * 3, device=cuda_device).reshape(n, 3).to(dtype)
    got = to_host(x, chunk=1000)
    assert got.shape == (n, 3)
    assert torch.equal(torch.from_numpy(got), x.cpu())


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


def _grad_call(name, device):
    """One small call of a kernel wrapper: (fn, inputs that require
    grad on ``device``)."""
    g = torch.Generator().manual_seed(0)
    if name == "flash_attention":
        args = [torch.randn(shape, generator=g) for shape in
                [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)]]
        fn = lambda *a: flash_attention(*a, causal=True)  # noqa: E731
    else:
        b, s, h, p, n, chunk = 1, 64, 2, 32, 16, 32
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "ssd_intra_chunk",
                                  "ssd_chunked"])
def test_kernel_wrappers_refuse_grad_on_the_card(cuda_device, name):
    """Flash attention's kernel has no backward: a launch under grad mode
    with an input that requires grad raises, and under no_grad it
    launches. The SSD pass has one (``SsdIntraChunk``), so its wrappers
    no longer refuse (the test keeps its name): under grad mode the
    forward kernel launches, the result carries a ``grad_fn``, and a
    backward pass launches the backward kernel once and gives every input
    a finite gradient; under no_grad only the forward kernel launches."""
    fn, args = _grad_call(name, cuda_device)
    if name == "flash_attention":
        before = flash_attention.launches
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        assert flash_attention.launches == before
        with torch.no_grad():
            out = fn(*args)
        assert flash_attention.launches == before + 1 and out.grad_fn is None
        return
    before = (ssd_intra_chunk.launches, ssd_intra_chunk_backward.launches)
    out = fn(*args)
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (ssd_intra_chunk.launches, ssd_intra_chunk_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    for a in args:
        assert a.grad is not None and bool(torch.isfinite(a.grad).all())
    with torch.no_grad():
        out = fn(*args)
    assert out.grad_fn is None
    assert (ssd_intra_chunk.launches, ssd_intra_chunk_backward.launches) == \
        (before[0] + 2, before[1] + 1)


def _backward_close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())


# b, nc, q, h, p, n: a small case, ragged ones (a chunk of 100 rows,
# N = 40 and 13, a chunk of 300: five 64-row tiles) and Mamba-2 2.7B's
# train step at 8 x 512 tokens
SSD_BWD_CASES = [(2, 2, 32, 4, 32, 16), (2, 1, 100, 3, 128, 40),
                 (1, 1, 300, 3, 32, 13), (8, 4, 128, 80, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain(cuda_device, case, dtype):
    """The backward kernel against ``ssd_intra_chunk_backward_plain``:
    each gradient within 1e-4 (fp32 B and C) or 2e-2 (bf16) of its own
    scale, and the same bits on a second call."""
    xdt, dacs, B, C = _intra_chunk_inputs(*case, cuda_device, 0)
    B, C = B.to(dtype), C.to(dtype)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    b, nc, q, h, p, n = case
    dy = torch.randn(xdt.shape, device=cuda_device, generator=g)
    dst = torch.randn((b, nc, h, p, n), device=cuda_device, generator=g)
    before = ssd_intra_chunk_backward.launches
    got = ssd_intra_chunk_backward(xdt, dacs, B, C, dy, dst)
    torch.cuda.synchronize()
    assert ssd_intra_chunk_backward.launches == before + 1
    _backward_close(got, ssd_intra_chunk_backward_plain(
        xdt, dacs, B, C, dy, dst), 1e-4 if dtype == torch.float32 else 2e-2)
    again = ssd_intra_chunk_backward(xdt, dacs, B, C, dy, dst)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_mamba2_train_step_gradients_on_the_card_match_the_cpu(cuda_device):
    """The gradients of one distillation step of a 2-layer Mamba-2 (fp32,
    8 x 64 tokens: two chunks of 32) on the card (the SSD forward and
    backward kernels) against the CPU's: the loss 1e-3 relative, each
    gradient within 1e-4 of its own scale (the SSD tolerance for fp32 B
    and C)."""
    from repro_torch.distill.losses import distillation_loss
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.train_step import deterministic_algorithms
    cfg = MAMBA2_2P7B.replace(name="mamba2-small", num_layers=2, d_model=128,
                              ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
                              vocab_size=512, dtype="float32")
    student = model_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    teacher = model_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch_np(cfg, 8, 64, seed=5)
    out = {}
    for dev in ("cpu", cuda_device):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        tree_to(student, dev))
        with deterministic_algorithms():
            total, _ = distillation_loss(
                cfg, live, tree_to(teacher, dev),
                {k: v.to(dev) for k, v in batch.items()}, l_logit=1.0,
                l_token=0.5)
            grads = torch.autograd.grad(total, tree_leaves(live))
        out[str(dev)] = (float(total.detach()), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-3)
    for a, w in zip(g_gpu, g_cpu):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


# Hymba-1.5B's shapes: attention (25 query heads on 5 KV heads of 64, a
# 1024-token window) at 4096 tokens whole and as the two query chunks of
# 2048 that the model launches; its SSD heads (25 of 64, state 16, chunk
# 256) on the 8 x 512-token calibration batch, (b, nc, q) = (8, 2, 256)
HYMBA_FLASH = [(1, 4096, 4096, 25, 5, 64, True, 1024, None),
               (1, 2048, 2048, 25, 5, 64, True, 1024, 0),
               (1, 2048, 3072, 25, 5, 64, True, 1024, 1024)]
HYMBA_SSD = (8, 2, 256, 25, 64, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HYMBA_FLASH)
def test_flash_attention_kernel_at_hymbas_shapes(cuda_device, case):
    """bf16, as the model runs it, at the reference's 2e-2."""
    b, sq, sk, hq, hkv, d, causal, window, q_offset = case
    g = torch.Generator(device=cuda_device).manual_seed(sq + sk)
    q, k, v = (torch.randn(shape, device=cuda_device,
                           generator=g).bfloat16()
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernels_at_hymbas_shape(cuda_device, dtype):
    """The forward and backward SSD kernels at Hymba's shape against their
    plain versions (1e-4 with fp32 B and C, 2e-2 of each output's scale
    with bf16), each the same bits on a second call."""
    xdt, dacs, B, C = _intra_chunk_inputs(*HYMBA_SSD, cuda_device, 7)
    B, C = B.to(dtype), C.to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    got = ssd_intra_chunk(xdt, dacs, B, C)
    for a, w in zip(got, ssd_intra_chunk_plain(xdt, dacs, B, C)):
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=tol, rtol=tol)
        else:
            assert float((a - w).abs().max()) <= tol * float(w.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(
        got, ssd_intra_chunk(xdt, dacs, B, C)))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dy = torch.randn(xdt.shape, device=cuda_device, generator=g)
    dst = torch.randn(got[1].shape, device=cuda_device, generator=g)
    grads = ssd_intra_chunk_backward(xdt, dacs, B, C, dy, dst)
    _backward_close(grads, ssd_intra_chunk_backward_plain(
        xdt, dacs, B, C, dy, dst), tol)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, ssd_intra_chunk_backward(xdt, dacs, B, C, dy, dst)))


@pytest.mark.cuda
def test_hybrid_model_on_the_card_matches_the_cpu(cuda_device):
    """The smoke Hymba in fp32 on the card (flash is not reached at 64
    tokens; the SSD forward and backward kernels are) against the CPU:
    logits within 1e-4 of their scale, greedy tokens equal, a
    distillation step's loss 1e-3 relative and each gradient within 1e-4
    of its own scale."""
    from repro_torch.distill.losses import distillation_loss
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train.train_step import deterministic_algorithms
    cfg = smoke_config("hymba-1.5b").replace(dtype="float32")
    student = model_init(cfg, torch.Generator().manual_seed(5), device="cpu")
    teacher = model_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch_np(cfg, 8, 64, seed=5)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_to(student, dev)
        tokens = batch["tokens"].to(dev)
        logits = forward(cfg, p, tokens)["logits"].cpu()
        toks = generate(cfg, p, tokens[:2, :40], 12).cpu()
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        with deterministic_algorithms():
            total, _ = distillation_loss(
                cfg, live, tree_to(teacher, dev),
                {k: v.to(dev) for k, v in batch.items()}, l_logit=1.0,
                l_token=0.5)
            grads = torch.autograd.grad(total, tree_leaves(live))
        out[str(dev)] = (logits, toks, float(total.detach()),
                         [g.cpu() for g in grads])
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert float((gpu[0] - cpu[0]).abs().max()) <= 1e-4 * float(
        cpu[0].abs().max())
    assert torch.equal(gpu[1], cpu[1])
    assert gpu[2] == pytest.approx(cpu[2], rel=1e-3)
    for a, w in zip(gpu[3], cpu[3]):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())


# the smoke models with frames, their cross-attention gates opened: the
# reference's smoke Whisper, its smoke Llama-3.2-Vision (one cross group),
# and the same with two groups over frames of 96 (``frontend_proj``)
CROSS_MODELS = [("whisper-large-v3", {}),
                ("llama-3.2-vision-11b", {}),
                ("llama-3.2-vision-11b", {"frontend_dim": 96,
                                          "num_layers": 4})]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes", CROSS_MODELS,
                         ids=["whisper", "vlm", "vlm-two-groups"])
def test_cross_attention_models_on_the_card_match_the_cpu(cuda_device, arch,
                                                          changes):
    """A smoke model with frames in fp32, gates at 1.0 (at their initial 0
    no frame reaches a logit): the card's logits within 1e-4 of their
    scale of the CPU's, and greedy ``generate(frontend=...)`` through the
    cross cache equal to the CPU's (chip_smoke phase 3's tolerances)."""
    cfg = smoke_config(arch).replace(dtype="float32", **changes)
    params = model_init(cfg, torch.Generator().manual_seed(6), device="cpu")
    owner = params["cross"] if "cross" in params else params["layers"]
    owner["xattn"]["gate"].fill_(1.0)
    batch = make_batch_np(cfg, 4, 48, seed=6)
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_to(params, dev)
        tokens, frames = batch["tokens"].to(dev), batch["frontend"].to(dev)
        logits = forward(cfg, p, tokens, frontend_embeds=frames)["logits"]
        toks = generate(cfg, p, tokens[:2, :32], 12, frontend=frames[:2])
        out[str(dev)] = (logits.cpu(), toks.cpu())
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert float((gpu[0] - cpu[0]).abs().max()) <= 1e-4 * float(
        cpu[0].abs().max())
    assert torch.equal(gpu[1], cpu[1])


TRAIN_CFG = GPT2_SMALL.replace(
    name="gpt2-tiny", num_layers=2, d_model=96, d_ff=384, num_heads=6,
    num_kv_heads=6, head_dim=16, vocab_size=384, dtype="float32")
TRAIN_TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=8,
                         microbatches=2, distill_logit=1.0,
                         distill_token=0.5)


def _train_member():
    """A tiny GPT-2 teacher, a member of its database with 3 of 6 heads
    and 250 of 384 FFN rows removed, and the member's masks (CPU)."""
    cfg = TRAIN_CFG
    teacher = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    calib = calibration_batches(cfg, 16, 64, batch=8)
    db = build_database(cfg, teacher, collect_hessians(cfg, teacher, calib,
                                                       device="cpu"),
                        device="cpu")
    a = {name: (3 if "attn" in name else 250) for name in db}
    student = apply_assignment(cfg, teacher, db, a)
    return teacher, student, masks_from_assignment(cfg, student, db, a), \
        db, a


def _rows_zero(params, db, a):
    for name, removed in a.items():
        mod = db[name].mod
        leaf = params["layers"]["attn"]["wo"] if mod.kind == "attn" \
            else params["layers"]["ffn"]["wd"]
        gs = mod.group_size
        for g in db[name].order[:removed]:
            if bool(leaf[mod.layer, g * gs:(g + 1) * gs].any()):
                return False
    return True


@pytest.mark.cuda
def test_train_steps_on_the_card_match_the_cpu(cuda_device):
    teacher, student, masks, db, a = _train_member()
    states, logs = {}, {}
    for dev in ("cpu", cuda_device):
        step = make_train_step(TRAIN_CFG, TRAIN_TCFG, teacher_params=teacher,
                               masks=masks, device=dev)
        state = make_train_state(TRAIN_CFG, tree_to(student, dev),
                                 TRAIN_TCFG)
        logs[str(dev)] = []
        for i in range(5):
            state, m = step(state, make_batch_np(TRAIN_CFG, 8, 64, seed=2,
                                                 step=i))
            logs[str(dev)].append({k: float(v) for k, v in m.items()})
        states[str(dev)] = tree_to(state.params, "cpu")
        assert _rows_zero(states[str(dev)], db, a)
    for want, got in zip(logs["cpu"], logs[str(cuda_device)]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), k


@pytest.mark.cuda
def test_moe_train_steps_on_the_card_match_the_cpu(cuda_device):
    """The smoke Phi-3.5-MoE (fp32): the expert dispatch's scatter-add
    under deterministic algorithms, card against CPU."""
    cfg = smoke_config("phi3.5-moe-42b-a6.6b").replace(dtype="float32")
    student = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    teacher = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    logs = {}
    for dev in ("cpu", cuda_device):
        step = make_train_step(cfg, TRAIN_TCFG, teacher_params=teacher,
                               device=dev)
        state = make_train_state(cfg, tree_to(student, dev), TRAIN_TCFG)
        logs[str(dev)] = []
        for i in range(3):
            state, m = step(state, make_batch_np(cfg, 4, 64, seed=3, step=i))
            logs[str(dev)].append({k: float(v) for k, v in m.items()})
    for want, got in zip(logs["cpu"], logs[str(cuda_device)]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), k


@pytest.mark.cuda
def test_kill_and_resume_on_the_card_is_bit_identical(cuda_device, tmp_path):
    teacher, student, masks, db, a = _train_member()
    kw = dict(teacher_params=teacher, masks=masks, ckpt_every=4,
              device=cuda_device)
    ta = Trainer(TRAIN_CFG, TRAIN_TCFG, ckpt_dir=str(tmp_path / "a"), **kw)
    sa = ta.fit(ta.init_or_restore(student),
                synthetic_stream(TRAIN_CFG, 8, 64, seed=0), steps=8)
    ta.ckpt.close()
    tb = Trainer(TRAIN_CFG, TRAIN_TCFG, ckpt_dir=str(tmp_path / "b"), **kw)
    tb.fit(tb.init_or_restore(student),
           synthetic_stream(TRAIN_CFG, 8, 64, seed=0), steps=8, stop_after=6)
    tb.ckpt.close()
    tc = Trainer(TRAIN_CFG, TRAIN_TCFG, ckpt_dir=str(tmp_path / "b"), **kw)
    sc = tc.init_or_restore(student)
    assert int(sc.step) == 4
    sc = tc.fit(sc, synthetic_stream(TRAIN_CFG, 8, 64, seed=0, start_step=4),
                steps=8)
    tc.ckpt.close()
    for x, y in zip(tree_leaves({"p": sa.params, "o": sa.opt}),
                    tree_leaves({"p": sc.params, "o": sc.opt})):
        assert torch.equal(x, y)
    assert torch.equal(sa.step, sc.step)
    assert _rows_zero(tree_to(sa.params, "cpu"), db, a)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
def test_train_cli_on_the_card(cuda_device, tmp_path, capsys):
    assert train_cli.main(["--arch", "gpt2-small", "--smoke", "--steps", "3",
                           "--batch", "4", "--seq", "64", "--ckpt-dir",
                           str(tmp_path)]) == 0
    assert "on cuda" in capsys.readouterr().out


# the H100 SXM data sheet's bf16 rate and memory bandwidth; the 2e-6 s a
# module is an assumed launch floor, not a measurement
H100_SHEET = HardwareSpec(name="h100-sxm-datasheet", peak_flops=989e12,
                          hbm_bw=3.35e12, ici_bw=0.0, hbm_bytes=80e9,
                          op_overhead=2e-6)


@pytest.mark.cuda
def test_family_killed_and_resumed_on_the_card_is_bit_identical(
        cuda_device, tmp_path):
    """The tiny gradual family on the card, killed mid-finetune of its
    second target and resumed: each member equal to an uninterrupted
    run's bit for bit, and the resume ran only that finetune."""
    cfg = TRAIN_CFG
    params = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    calib = calibration_batches(cfg, 16, 64, batch=8)
    env = InferenceEnv(batch=8, seq=64, mode="prefill", hw=H100_SHEET)

    def run(base, **kw):
        return gradual_prune(
            cfg, params, env, [1.5, 2.0],
            lambda s: synthetic_stream(cfg, 16, 64, seed=99, start_step=s),
            calib, tcfg=TrainConfig(learning_rate=5e-4, warmup_steps=2,
                                    total_steps=8, distill_logit=1.0,
                                    distill_token=0.5),
            finetune_steps=8, search_steps=4, search_pop=4, ckpt_every=4,
            ckpt_dir=str(base), device=cuda_device, **kw)

    full = run(tmp_path / "a")
    with pytest.raises(FamilyPreempted):
        run(tmp_path / "b", stop_after=(1, "finetune", 6))
    resumed = run(tmp_path / "b")
    for va, vb in zip(full, resumed):
        assert va.assignment == vb.assignment and va.achieved >= va.target
        assert va.loss_before_ft == vb.loss_before_ft
        assert va.loss_after_ft == vb.loss_after_ft
        la, lb = tree_leaves(va.params), tree_leaves(vb.params)
        assert la[0].device.type == "cuda"
        assert all(torch.equal(x, y) for x, y in zip(la, lb))
    with open(os.path.join(family_run_dir(cfg, [1.5, 2.0], 0,
                                          str(tmp_path / "b")),
                           "family.json")) as f:
        executed = json.load(f)["executed"]
    assert [(e["target"], e["stage"]) for e in executed if e["run"] == 2] \
        == [("2", "finetune")]
    assert not torch.are_deterministic_algorithms_enabled()


def _device_ms(fn, args, calls: int = 10, traces: int = 3) -> float:
    """Device milliseconds a call of ``fn(*args)``: the summed self time of
    the card's own activities (kernels, copies) in a ``torch.profiler``
    trace of ``calls`` calls, after 3 untimed ones. Every module timed
    here launches GEMMs, so a trace without device activity (the
    profiler dropped its events, seen once in a few hundred traces) is
    taken again, at most ``traces`` times in all, with a warning for each
    empty trace so that a profiler that drops events often stays seen."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    for k in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
        if us > 0:
            return us / 1e3 / calls
        warnings.warn(f"profiler trace {k + 1} of {traces} held no device "
                      f"activity for {calls} calls of {fn!r}")
    raise AssertionError(f"{traces} profiler traces held no device activity")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gpt2-small", "hymba-1.5b"])
def test_measured_table_prices_modules_by_their_device_time(cuda_device,
                                                            arch):
    """The measured table (16 x 128 prefill, the config's compute type)
    times the card, not the host's launches: attention at one KV group
    costs at most half the dense attention (the profiler's device times
    give 0.30 for GPT-2 small and 0.36 for Hymba), and every entry is
    within 20% of the profiler's device time a call of its module."""
    from repro_torch.configs import get_config
    from repro_torch.core import latency
    from repro_torch.core.structures import UNITS
    from repro_torch.models.layers import compute_dtype

    cfg = get_config(arch)
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    kw = {"reps": 50, "warmup": 5}
    table = latency.build_table(cfg, env, "measure", device=cuda_device,
                                **kw)
    dt, gen = compute_dtype(cfg), torch.Generator().manual_seed(0)

    def module(spec):
        if spec["module"] == "attn":
            return latency._attn_timing_module(cfg, env, spec["groups"], gen,
                                               dt, cuda_device)
        return latency._ffn_timing_module(cfg, spec["tokens"],
                                          spec["f_live"], gen, dt,
                                          cuda_device)

    with torch.no_grad():
        fn, args = module({"module": "attn", "groups": 1})
        one = latency._time_fn(fn, *args, dev=cuda_device, **kw)
        assert one <= 0.5 * table.module_time("attn", 0), (
            one, table.module_time("attn", 0))
        for kind, grid in table.grids.items():
            for removed, secs in zip(grid, table.times[kind]):
                spec = UNITS[kind].timing_spec(cfg, env, int(removed))
                if spec is None:
                    assert secs == 0.0
                    continue
                fn, args = module(spec)
                device = _device_ms(fn, args)
                assert abs(secs * 1e3 - device) <= 0.2 * device, (
                    kind, int(removed), secs * 1e3, device)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [True, False])
def test_compacted_database_on_the_card_keeps_the_plain_orders(cuda_device,
                                                              batched):
    """``build_database(compact=True)`` on the card (the downdate kernel
    launched on the compacted live prefix, ``d_live`` below the working
    rows) removes the structures in the order of the card's plain build,
    with errors within 1e-5 relative and snapshots within float16 of it
    (the same per-step arithmetic). Against the CPU's compacted build it
    keeps the CPU's orders up to the near-ties that the card's rounding
    may swap, the bound chip_smoke's phase 3 holds the plain database to:
    the removed sets differ by at most max(1, n // 50) structures at a
    level. Both kinds compact (FFN 384 rows, attention 6 heads of 16)."""
    cfg = TRAIN_CFG
    params = model_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    hess = collect_hessians(cfg, params, calibration_batches(cfg, 16, 64,
                                                             batch=8),
                            device="cpu")
    cpu = build_database(cfg, params, hess, batched=batched, compact=True,
                         device="cpu")
    card_params = tree_to(params, cuda_device)
    before = obs_downdate.launches
    card = build_database(cfg, card_params, hess, batched=batched,
                          compact=True, device=cuda_device)
    assert obs_downdate.launches > before
    plain = build_database(cfg, card_params, hess, batched=batched,
                           device=cuda_device)
    for name, want in cpu.items():
        got = card[name]
        np.testing.assert_array_equal(got.order, plain[name].order,
                                      err_msg=name)
        np.testing.assert_allclose(got.errors, plain[name].errors,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.snapshots.astype(np.float32),
                                   plain[name].snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)
        n = want.mod.n_structures
        for lvl in want.levels:
            gone = set(got.order[:lvl].tolist())
            assert len(gone ^ set(want.order[:lvl].tolist())) // 2 <= \
                max(1, n // 50), (name, int(lvl))


def _kernel_calls(dev):
    """One call of each kernel wrapper on small tensors on the card."""
    g = torch.Generator(device=dev).manual_seed(7)

    def r(*shape):
        return torch.randn(shape, device=dev, generator=g)

    xdt, dacs, B, C = _intra_chunk_inputs(1, 2, 32, 2, 16, 8, dev, 3)
    return {
        "hessian_accum": (hessian_accum, lambda: hessian_accum(r(64, 32))),
        "obs_downdate": (obs_downdate, lambda: obs_downdate(
            r(1, 8, 4), r(1, 8, 8), r(1, 8, 1), r(1, 1, 4), r(1, 1, 8),
            torch.ones((1, 8), device=dev))),
        "flash_attention": (flash_attention, lambda: flash_attention(
            r(1, 64, 2, 64), r(1, 64, 2, 64), r(1, 64, 2, 64))),
        "ssd_intra_chunk": (ssd_intra_chunk,
                            lambda: ssd_intra_chunk(xdt, dacs, B, C)),
        "ssd_intra_chunk_backward": (
            ssd_intra_chunk_backward, lambda: ssd_intra_chunk_backward(
                xdt, dacs, B, C, r(*xdt.shape), r(1, 2, 2, 16, 8))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hessian_accum", "obs_downdate",
                                  "flash_attention", "ssd_intra_chunk",
                                  "ssd_intra_chunk_backward"])
def test_injected_kernel_failure_raises_on_the_card(cuda_device, name):
    """``kernel.pallas:raise@0`` on CUDA tensors: the wrapper raises the
    injected failure before it launches (its counter unchanged), nothing
    falls back to the plain version and no breaker opens; the next call
    launches."""
    kernel, call = _kernel_calls(cuda_device)[name]
    with torch.no_grad():
        before = kernel.launches
        with install(FaultPlan.parse("kernel.pallas:raise@0")), \
                report_scope() as rep:
            with pytest.raises(FaultInjected, match="kernel.pallas"):
                call()
            assert kernel.launches == before
            call()
        torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert rep.total("demotions") == 0 and not rep.as_dict()["breakers_open"]


@pytest.mark.cuda
def test_recomputed_decode_steps_on_the_card_give_the_clean_tokens(
        cuda_device):
    """``serve.step:nan@2,serve.step:raise@4`` on a dense GPT-2 in fp32 on
    the card: the recomputed steps give the clean run's tokens, and the
    caches they updated in place end with the clean run's bits."""
    cfg = smoke_config("gpt2-small").replace(dtype="float32")
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=cuda_device)
    reqs = synthetic_requests(cfg, 6, seed=3, rate=300.0,
                              prompt_lens=(5, 9, 13), steps_range=(3, 8))

    def serve():
        # a scripted clock (1 ms a read): on the wall clock the retried
        # steps take longer and the arrivals join at other steps
        eng = ServeEngine(DenseServeModel(cfg, params, 64), num_slots=2,
                          clock=itertools.count(0.0, 1e-3).__next__)
        return [r.tokens for r in eng.run(reqs).records], eng.cache

    want, clean_cache = serve()
    with install(FaultPlan.parse("serve.step:nan@2,serve.step:raise@4")), \
            report_scope() as rep:
        got, cache = serve()
    assert got == want
    assert rep.counts["recovered"] == {"serve.step": 2}
    assert all(torch.equal(clean_cache["attn"][k], cache["attn"][k])
               for k in ("k", "v"))
    assert torch.equal(clean_cache["pos"], cache["pos"])


# each rank: a small GPT-2, its Hessians single-process and over a 2-rank
# mesh, and the database of the single-process Hessians both ways
SHARDED_CARD_SCRIPT = r"""
import hashlib

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import GPT2_SMALL
from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.data import calibration_batches
from repro_torch.distributed import make_mesh
from repro_torch.launch.subproc import emit_result, init_rank
from repro_torch.models import model_init

rank, world, dev = init_rank(timeout=300)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = GPT2_SMALL.replace(num_layers=2, d_model=128, d_ff=512, num_heads=4,
                         num_kv_heads=4, head_dim=32, vocab_size=512)
params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
calib = calibration_batches(cfg, 16, 128, batch=8)
mesh = make_mesh((world,), ("data",))
one = collect_hessians(cfg, params, calib, device=dev)
kernels.reset_launch_counts()
sharded = collect_hessians(cfg, params, calib, mesh=mesh, device=dev)
db = build_database(cfg, params, one, mesh=mesh, device=dev)
launches = {k.__name__: k.launches for k in kernels.KERNELS}
ref = build_database(cfg, params, one, device=dev)
emit_result({
    "rel": max(float((sharded[k] - one[k]).abs().max() / one[k].abs().max())
               for k in one),
    "same": all(np.array_equal(getattr(db[k], f), getattr(ref[k], f))
                for k in ref for f in ("order", "errors", "snapshots")),
    "digest": hashlib.sha256(b"".join(
        db[k].snapshots.tobytes() + db[k].errors.tobytes() for k in db)
    ).hexdigest(),
    "launches": launches})
"""


@pytest.mark.cuda
def test_sharded_calibration_and_database_on_the_card(cuda_device):
    ranks = run_ranks(SHARDED_CARD_SCRIPT, 2, device="cuda", timeout=600)
    for r in ranks:
        assert r["rel"] < 1e-5, r["rel"]
        assert r["same"]
        assert r["launches"]["hessian_accum"] > 0
        assert r["launches"]["obs_downdate"] > 0
    assert ranks[0]["digest"] == ranks[1]["digest"]


@pytest.mark.cuda
def test_placed_search_on_two_streams_equals_unplaced(cuda_device):
    cfg = GPT2_SMALL.replace(num_layers=6, d_model=128, d_ff=512,
                             num_heads=4, num_kv_heads=4, head_dim=32,
                             vocab_size=512)
    params = model_init(cfg, torch.Generator().manual_seed(0),
                        device=cuda_device)
    calib = calibration_batches(cfg, 16, 128, batch=8)
    db = build_database(cfg, params, collect_hessians(
        cfg, params, calib, device=cuda_device), device=cuda_device)
    cache = SnapshotCache(cfg, db, device=cuda_device)
    table = build_table(cfg, InferenceEnv(batch=1, seq=128, hw=H100_SXM))
    targets = [1.25, 1.5, 2.0]

    def run(devices=None):
        spdy.reset_placed_scoring()
        fn = make_batched_eval(cfg, params, cache, calib[:1],
                               device=cuda_device)
        res = spdy.search_family(db, table, targets, steps=24, pop=8,
                                 seed=3, eval_batched=fn, devices=devices)
        return res, dict(spdy.PLACED_SCORING), fn

    want, _, _ = run()
    got, placed, fn = run(["cuda", "cuda"])
    for t in targets:
        assert got[t].assignment == want[t].assignment, t
        assert got[t].score == want[t].score, t
        assert got[t].history == want[t].history, t
        assert got[t].n_evals == want[t].n_evals, t
    assert sum(placed["scored"].values()) == want[targets[0]].n_evals
    assert placed["calls"] > 3
    assert list(fn.replicas) == [torch.device("cuda", 0)]


# each rank: the reference tests' gpt2-tiny trained 12 steps on the card
# over a 2-rank mesh, fp32 and then int8_ef, and the single-process
# trainer on the same weights, teacher and batches (the bounds of
# tests/test_trainer_sharded.py)
MESH_TRAIN_CARD_SCRIPT = r"""
import dataclasses, tempfile

import torch

from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic_stream
from repro_torch.distributed import make_mesh
from repro_torch.launch.subproc import emit_result, init_rank
from repro_torch.models import model_init, model_specs
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import Trainer

rank, world, dev = init_rank(timeout=300)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = GPT2_SMALL.replace(name="gpt2-tiny", num_layers=2, d_model=64,
                         d_ff=128, num_heads=4, num_kv_heads=4, head_dim=16,
                         vocab_size=256, dtype="float32")
params = model_init(cfg, torch.Generator().manual_seed(0), device=dev)
teacher = model_init(cfg, torch.Generator().manual_seed(1), device=dev)
mesh = make_mesh((world,), ("data",))
N = 12
tcfg = TrainConfig(learning_rate=1e-3, total_steps=N, warmup_steps=2,
                   microbatches=2, distill_logit=1.0, distill_token=0.5)


def run(compression, on_mesh):
    tr = Trainer(cfg, dataclasses.replace(tcfg, grad_compression=compression),
                 ckpt_dir=tempfile.mkdtemp(), ckpt_every=100, log_every=1,
                 teacher_params=teacher, mesh=mesh if on_mesh else None,
                 specs=model_specs(cfg) if on_mesh else None, device=dev)
    st = tr.init_or_restore(params)
    st = tr.fit(st, synthetic_stream(cfg, 8, 32, seed=3), steps=N,
                save_last=False)
    return tr, st


fp, st_fp = run("none", True)
c, st_c = run("int8_ef", True)
one, st_1 = run("none", False)
emit_result({
    "fp32": [m["loss"] for m in fp.metrics_log],
    "int8": [m["loss"] for m in c.metrics_log],
    "single": [m["loss"] for m in one.metrics_log],
    "kl": [m["logit_kl"] for m in fp.metrics_log],
    "rows": sorted({int(e.shape[0]) for e in tree_leaves(st_c.ef_err)}),
    "nonzero": any(bool((e != 0).any()) for e in tree_leaves(st_c.ef_err)),
    "param_maxdiff": max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(fp.params_of(st_fp)), tree_leaves(st_1.params)))})
"""


@pytest.mark.cuda
def test_mesh_trainer_on_the_card_matches_one_process(cuda_device):
    for r in run_ranks(MESH_TRAIN_CARD_SCRIPT, 2, device="cuda",
                       timeout=600):
        assert r["param_maxdiff"] < 1e-4, r["param_maxdiff"]
        assert r["fp32"] == pytest.approx(r["single"], abs=1e-3)
        assert all(k > 0 for k in r["kl"])
        assert r["rows"] == [1] and r["nonzero"]
        assert abs(r["fp32"][-1] - r["int8"][-1]) < 0.15
        assert r["int8"][-1] < r["int8"][0]
