// obs_downdate: one Algorithm-1 step's fused rank-gs update, for a stack
// of M modules in one launch, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/obs_downdate.py
// (obs_downdate_kernel, body _downdate_kernel). Per module m:
//
//   W    <- (W    - HcolS @ KsWS)    * keep[:, None]
//   Hinv <- (Hinv - HcolS @ KsHcolT) * keep[:, None] * keep[None, :]
//
// W (M, d_in, d_out), Hinv (M, d_in, d_in), HcolS (M, d_in, gs),
// KsWS (M, gs, d_out), KsHcolT (M, gs, d_in), keep (M, d_in); all fp32,
// row-major. W and Hinv are updated IN PLACE: the Algorithm-1 loop
// carries them anyway, so this halves the memory of a step. The factor
// inputs must not alias W or Hinv (the wrapper checks).
//
// Rows and columns at or beyond d_live (the live-prefix restriction of
// kernels/ref.py live_prefix_downdate) are written as zeros without
// being read; the live prefix is updated as if it were the whole matrix.
//
// Layout: grid.z is the module, grid.y a strip of TR rows, grid.x a tile
// of TC columns across the concatenated [Hinv | W] column space, so one
// launch covers both matrices of all modules. A block stages its TR rows
// of HcolS and the matching TC columns of the gs-row factor in shared
// memory, GC factor rows at a time, keeps TR running dot products per
// thread in registers, then reads, updates, masks and writes each
// element once. No (d, d) intermediate exists. gs == 1 is the outer
// product: one multiply, rounded, then the subtract, exactly as the plain
// version computes it.
//
// Bound: each element of W and Hinv is read once and written once,
// ~8 bytes against 2*gs FLOP, so the step is memory-bound for gs = 1
// (the FFN group: ~1.1 GB per step for M=12, d_in=3072, d_out=768) and
// near balance at gs = 64. The design keeps the traffic at that minimum:
// threads of a warp touch consecutive columns (coalesced), and the only
// other traffic is the small factors, read once per block from L2.
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int TC = 128;  // columns per block = threads per block
constexpr int TR = 16;   // rows per block
constexpr int GC = 16;   // factor rows staged per step

__global__ void __launch_bounds__(TC)
downdate_kernel(float* __restrict__ W, float* __restrict__ H,
                const float* __restrict__ A, const float* __restrict__ KW,
                const float* __restrict__ KH, const float* __restrict__ keep,
                int d_in, int d_out, int gs, int d_live, int tiles_h) {
  __shared__ float ks[GC][TC];
  __shared__ float as[TR][GC];

  const size_t m = blockIdx.z;
  const bool is_h = (int)blockIdx.x < tiles_h;
  const int ncols = is_h ? d_in : d_out;
  const int c0 = (is_h ? blockIdx.x : blockIdx.x - tiles_h) * TC;
  const int c = c0 + threadIdx.x;
  const int r0 = blockIdx.y * TR;
  float* X = is_h ? H + m * d_in * (size_t)d_in : W + m * d_in * (size_t)d_out;
  const float* K = is_h ? KH + m * gs * (size_t)d_in : KW + m * gs * (size_t)d_out;
  const float* Am = A + m * d_in * (size_t)gs;
  const float* keep_m = keep + m * d_in;

  // whole block in the dead tail: zeros, nothing read
  if (r0 >= d_live || (is_h && c0 >= d_live)) {
    if (c < ncols)
      for (int i = 0; i < TR && r0 + i < d_in; ++i)
        X[(size_t)(r0 + i) * ncols + c] = 0.0f;
    return;
  }

  float acc[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) acc[i] = 0.0f;

  for (int g0 = 0; g0 < gs; g0 += GC) {
    const int gc = min(GC, gs - g0);
    for (int g = 0; g < gc; ++g)
      ks[g][threadIdx.x] = c < ncols ? K[(size_t)(g0 + g) * ncols + c] : 0.0f;
    for (int e = threadIdx.x; e < TR * GC; e += TC) {
      const int i = e / GC, g = e % GC;
      const int r = r0 + i;
      as[i][g] = (r < d_in && g < gc) ? Am[(size_t)r * gs + g0 + g] : 0.0f;
    }
    __syncthreads();
    for (int g = 0; g < gc; ++g) {
      const float kv = ks[g][threadIdx.x];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i] = fmaf(as[i][g], kv, acc[i]);
    }
    __syncthreads();
  }

  if (c >= ncols) return;
  const bool col_live = !is_h || c < d_live;
  const float kc = is_h && col_live ? keep_m[c] : 1.0f;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + i;
    if (r >= d_in) break;
    const size_t idx = (size_t)r * ncols + c;
    if (r >= d_live || !col_live) {
      X[idx] = 0.0f;
    } else {
      X[idx] = (X[idx] - acc[i]) * keep_m[r] * kc;
    }
  }
}

}  // namespace

extern "C" int obs_downdate_f32(float* W, float* Hinv, const float* HcolS,
                                const float* KsWS, const float* KsHcolT,
                                const float* keep, int M, int d_in, int d_out,
                                int gs, int d_live, void* stream) {
  const int tiles_h = (d_in + TC - 1) / TC;
  const int tiles_w = (d_out + TC - 1) / TC;
  dim3 grid(tiles_h + tiles_w, (d_in + TR - 1) / TR, M);
  downdate_kernel<<<grid, TC, 0, static_cast<cudaStream_t>(stream)>>>(
      W, Hinv, HcolS, KsWS, KsHcolT, keep, d_in, d_out, gs, d_live, tiles_h);
  return static_cast<int>(cudaGetLastError());
}
