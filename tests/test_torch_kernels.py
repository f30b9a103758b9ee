"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and
``kernels/ref.py`` oracles, and the wrappers' CPU routing. The CUDA
kernels against their plain versions are in tests/test_torch_cuda.py.

Tolerances are the reference's (tests/test_kernels.py,
tests/test_batched_db.py): hessian_accum 1e-3·√N fp32, 1e-1·√N bf16,
1e-4·√N with an accumulator; obs_downdate 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import (hessian_accum, hessian_accum_plain,
                                 obs_downdate, obs_downdate_plain,
                                 reset_launch_counts)


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


def test_wrappers_use_plain_versions_on_cpu_without_launching():
    reset_launch_counts()
    xt = torch.randn(40, 12)
    assert torch.equal(hessian_accum(xt), hessian_accum_plain(xt))
    arrs = [torch.from_numpy(a) for a in _downdate_inputs(2, 24, 8, 4, 1)]
    for got, want in zip(obs_downdate(*arrs, d_live=16),
                         obs_downdate_plain(*arrs, d_live=16)):
        assert torch.equal(got, want)
    assert hessian_accum.launches == 0 and obs_downdate.launches == 0
