// hessian_accum: out = X^T X, or acc + X^T X, in fp32 on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hessian_accum.py
// (hessian_accum_kernel, bodies _xtx_kernel / _xtx_acc_kernel).
//
// X is (N, D) row-major, fp32 or bf16; out and acc are (D, D) fp32.
// X^T X is symmetric, so only the 64x64 output tiles on or above the
// diagonal are computed, one per block: tile (ti, tj) with ti <= tj is
// written to (ti, tj) and, off the diagonal, mirrored to (tj, ti) through
// shared memory so both stores stay coalesced. acc need not be symmetric:
// each of the two stores adds its own acc entry, so acc + X^T X is one
// pass. The TPU kernel carried its accumulator across a sequential N grid
// axis; blocks on the card run in no order, so here the N reduction is a
// loop inside the block: it stages (32 x 64) strips of the two column
// panels of X in shared memory and accumulates with fp32 FMA in registers
// (4x4 outputs per thread, strided by 16 so the shared-memory reads of a
// warp are broadcasts or conflict-free). Ragged edges of N and D are
// padded with zeros on load and masked on store.
//
// Bound: the distinct entries need N*D*(D+1)/2 FMA, i.e. N*D*(D+1)
// operations (about 38.7 GFLOP at the main path's N = 4096, D = 3072),
// against (N*D + 2*D^2) * 4 bytes, so it is compute-bound on fp32 FMA.
// It deliberately uses no tensor cores: TF32 would keep ~3 decimal digits
// and break the fp32 tolerances the calibration Hessians are held to. The
// design halves the work by symmetry and reaches for the fp32 FMA rate
// with register tiling; wgmma/TMA pipelining is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BT = 64;       // output tile edge
constexpr int BN = 32;       // rows of X staged per step
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xtx_kernel(const T* __restrict__ x, const float* __restrict__ acc,
           float* __restrict__ out, int n, int d, int tiles) {
  __shared__ float xi[BN][BT];
  __shared__ float xj[BN][BT];
  __shared__ float mirror[BT][BT + 1];  // +1: conflict-free column reads
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // block -> upper-triangle tile (ti, tj), row by row
  int ti = 0, rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * BT, j0 = tj * BT;

  float c[4][4] = {};
  for (int n0 = 0; n0 < n; n0 += BN) {
    for (int e = threadIdx.x; e < BN * BT; e += THREADS) {
      const int r = e / BT, col = e % BT;
      const int row = n0 + r;
      const size_t base = (size_t)row * d;
      xi[r][col] = (row < n && i0 + col < d) ? to_f32(x[base + i0 + col]) : 0.0f;
      xj[r][col] = (row < n && j0 + col < d) ? to_f32(x[base + j0 + col]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BN; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = xi[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = xj[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) c[a][b] = fmaf(av[a], bv[b], c[a][b]);
    }
    __syncthreads();
  }

  // tile (ti, tj): row i, column j
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int li = ty + 16 * a, lj = tx + 16 * b;
      const int i = i0 + li, j = j0 + lj;
      if (i < d && j < d) {
        const size_t o = (size_t)i * d + j;
        out[o] = acc != nullptr ? acc[o] + c[a][b] : c[a][b];
      }
      mirror[li][lj] = c[a][b];
    }
  if (ti == tj) return;  // a diagonal tile is its own mirror
  __syncthreads();

  // mirrored tile (tj, ti): row j, column i, consecutive threads along i
  for (int e = threadIdx.x; e < BT * BT; e += THREADS) {
    const int lj = e / BT, li = e % BT;
    const int j = j0 + lj, i = i0 + li;
    if (i < d && j < d) {
      const size_t o = (size_t)j * d + i;
      const float v = mirror[li][lj];
      out[o] = acc != nullptr ? acc[o] + v : v;
    }
  }
}

template <typename T>
int launch(const void* x, const float* acc, float* out, int n, int d,
           void* stream) {
  const int tiles = (d + BT - 1) / BT;
  const int blocks = tiles * (tiles + 1) / 2;
  xtx_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), acc, out, n, d, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc may be null (out = X^T X). out must alias neither x nor acc.
extern "C" int hessian_accum_f32(const void* x, const float* acc, float* out,
                                 int n, int d, void* stream) {
  return launch<float>(x, acc, out, n, d, stream);
}

extern "C" int hessian_accum_bf16(const void* x, const float* acc, float* out,
                                  int n, int d, void* stream) {
  return launch<__nv_bfloat16>(x, acc, out, n, d, stream);
}
