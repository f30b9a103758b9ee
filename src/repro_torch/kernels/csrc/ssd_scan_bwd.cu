// ssd_scan_bwd: the backward of the Mamba-2 SSD intra-chunk pass on Hopper
// (sm_90a), in fp32 FMA on the CUDA cores.
//
// The TPU kernel src/repro/kernels/ssd_scan.py:52 (ssd_intra_chunk_kernel)
// has no backward: the reference takes the gradient of the intra-chunk
// pass by autodiff of its jnp twin (src/repro/models/ssm.py:93-152). This
// kernel is that gradient, written out (kernels/ssd_scan.py
// ssd_intra_chunk_backward_plain is the same formula in PyTorch).
//
// Per (batch, chunk) and head h, with Q rows to the chunk, S = C B^T
// (fp32 products of the B/C values, as the forward kernel forms them),
// L[q, k] = exp(dacs[q] - dacs[k]) for q >= k (else 0), e[q] =
// exp(dacs[Q-1] - dacs[q]), G = dy xdt^T and W = B dstates^T (Q x P):
//   dxdt  = (S o L)^T dy + e o W
//   dS    = sum_h G o L;  dC = dS B;  dB = dS^T C + sum_h (e o xdt) dstates
//   ddacs = rowsum(R) - colsum(R) - e o u, R = G o S o L, u = rowsum(xdt o W),
//           and the chunk's last row also gets + sum_q e[q] u[q].
// A masked pair (k > q) never forms an exponent: its weight is a select of
// 0, as in the forward. Inputs are the forward's: xdt (BC, Q, H, P) fp32,
// dacs (BC, Q, H) fp32, B and C (BC, Q, N) fp32 or bf16, with the
// cotangents dy (BC, Q, H, P) and dstates (BC, H, P, N) fp32, all
// row-major, BC = batch * chunks. dxdt and ddacs are fp32; dB and dC are
// in B's type, summed in fp32 and rounded once.
//
// Bound. At the training shape (BC, Q, H, P, N) = (32, 128, 80, 64, 128)
// with bf16 B and C the function reads xdt, dy and dstates (83.9 MB each),
// dacs (1.3 MB) and B, C (2.1 MB) and writes dxdt (83.9 MB), ddacs and
// dB, dC: 342.36 MB, 0.1022 ms at 3.35 TB/s. Its products are G and
// (S o L)^T dy (Q(Q+1)/2 x P each a head), W and the states' share of dB
// (Q x P x N each a head), S, dC and dS^T C (Q(Q+1)/2 x N each a chunk):
// 8.175 G multiply-adds, 16.35 GFLOP, 0.0330 ms at the tensor cores' 495
// TFLOP/s TF32 (the rate the forward's bound takes for the same operand
// types), so the bytes bound it at 0.1022 ms. This kernel's fp32 FMA on the
// CUDA cores' 67 TFLOP/s would need 0.2440 ms for the products alone: only
// tensor cores reach the bound. chip_smoke.py counts both from each call's
// shapes.
//
// Design: simple and right first. Six kernels on the launch's stream, the
// product passes each a block per 64 x 64 output tile of 256 threads (4 x 4
// outputs a thread), their operands staged through shared memory 16
// reduction steps at a time:
//   1. ds_pass, a block per (chunk, query tile >= key tile, head group): S
//      of the tile, then for each head of its group G, the group's share of
//      dS += G o L, and R's partial row sums (over the tile's keys) and
//      column sums (over its queries), written per head to workspaces per
//      key tile and per query tile; sum_parts adds the groups' dS;
//   2. dxdt_pass, a block per (chunk, head, key tile): (S o L)^T dy over the
//      query tiles at or after it, W over N, dxdt, and e o u;
//   3. dbc_pass, a block per (chunk, row tile, column tile of N, group of
//      (h, p) pairs): dC = dS B and dS^T C in group 0, and each group's
//      share of (e o xdt) dstates; sum_parts adds the groups' dB;
//   4. ddacs_pass, a thread per (chunk, row, head): the partial sums in tile
//      order, minus e o u, plus sum e o u at the last row.
// The head groups (hg) and (h, p) groups (sg) are kernels/ssd_scan.py
// bwd_plan's, from the shapes alone. At the train step's shape passes 1
// and 3 would otherwise run 96 and 128 blocks on 132 SMs, each a long
// serial loop (that first version took 3.58 ms a call on an H100, in
// chip_smoke.py phase 2); split into 6 and 4 groups (576 and 512 blocks)
// the call takes 2.09 ms (chip_smoke.py's time_ssd_backward splits it by
// pass; PERF.md).
// No atomics: every output and every workspace entry is written by one
// thread, and every sum runs in a fixed order, so two calls give the same
// bits (torch.use_deterministic_algorithms does not see a kernel loaded
// through ctypes; the family engine's resume needs the bits). The next step
// is the forward's: mma.sync or wgmma for the products, S and dS kept in
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE = 64;        // output rows and columns of a block
constexpr int KC = 16;          // reduction steps staged at a time
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDS = TILE + 4;   // pitch of a staged step (floats)
constexpr int RED = 17;         // pitch of the partial-sum buffer

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc[r][c] += sum over k in [k_begin, k_end) of fa(i, k) * fb(k, j) for
// the thread's rows i = 4 ty + r and columns j = 4 tx + c of a 64 x 64
// tile (ty = tid / 16, tx = tid % 16), k in ascending order. fa and fb
// give 0 outside their operands. A_ALONG_K: consecutive threads stage
// consecutive k of A (A contiguous along k in memory), else consecutive i;
// B_ALONG_K likewise for B. Begins with a barrier, so shared values written
// before the call are visible to fa and fb.
template <bool A_ALONG_K, bool B_ALONG_K, class FA, class FB>
__device__ __forceinline__ void tile_mm(float (&acc)[4][4], int k_begin,
                                        int k_end, FA fa, FB fb, float* As,
                                        float* Bs) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    __syncthreads();  // the last step's readers are done
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int i = A_ALONG_K ? e / KC : e % TILE;
      const int ka = A_ALONG_K ? e % KC : e / TILE;
      As[ka * LDS + i] = k0 + ka < k_end ? fa(i, k0 + ka) : 0.0f;
      const int j = B_ALONG_K ? e / KC : e % TILE;
      const int kb = B_ALONG_K ? e % KC : e / TILE;
      Bs[kb * LDS + j] = k0 + kb < k_end ? fb(k0 + kb, j) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * LDS + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * LDS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

// sums v[0..3] of the thread's rows 4 ty + r over the 16 threads of a row
// (the columns), in column order; thread t < 64 gets row t's sum. COLS:
// sum the thread's columns 4 tx + c over the 16 threads of a column.
template <bool COLS>
__device__ __forceinline__ float tile_sum(const float (&v)[4],
                                          float (*red)[RED]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  __syncthreads();  // the last sum's readers are done
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (COLS)
      red[4 * tx + r][ty] = v[r];
    else
      red[4 * ty + r][tx] = v[r];
  }
  __syncthreads();
  float s = 0.0f;
  if (tid < TILE)
    for (int t = 0; t < 16; ++t) s += red[tid][t];
  return s;
}

struct Dims {
  int q, h, p, n, nt;  // rows, heads, head dim, state, row tiles
  int hg, sg;          // head groups of pass 1, (h, p) groups of pass 3
};

// pass 1: block (chunk, tile pair qt >= kt, head group)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ds_pass(const float* __restrict__ xdt, const float* __restrict__ dacs,
        const T* __restrict__ Bg, const T* __restrict__ Cg,
        const float* __restrict__ dy, float* __restrict__ Sw,
        float* __restrict__ dSpart, float* __restrict__ rpart,
        float* __restrict__ cpart, const Dims d) {
  __shared__ __align__(16) float As[KC * LDS];
  __shared__ __align__(16) float Bs[KC * LDS];
  __shared__ float red[TILE][RED];
  __shared__ float aq[TILE], ak[TILE];
  const int Q = d.q, H = d.h, P = d.p, N = d.n;
  const size_t bc = blockIdx.x;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.y) ++qt;
  const int kt = blockIdx.y - qt * (qt + 1) / 2;
  const int q0 = qt * TILE, k0 = kt * TILE;
  const int hg = blockIdx.z;
  const int h_lo = (int)((long long)hg * H / d.hg);
  const int h_hi = (int)((long long)(hg + 1) * H / d.hg);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* Cb = Cg + bc * Q * N;
  const T* Bb = Bg + bc * Q * N;
  const size_t row = (size_t)H * P;  // a row of xdt or dy
  const float* dyb = dy + bc * Q * row;
  const float* xb = xdt + bc * Q * row;
  const float* db = dacs + bc * Q * H;

  float s[4][4];
  zero(s);
  tile_mm<true, true>(
      s, 0, N,
      [&](int i, int k) {
        return q0 + i < Q ? ld(Cb + (size_t)(q0 + i) * N + k) : 0.0f;
      },
      [&](int k, int j) {
        return k0 + j < Q ? ld(Bb + (size_t)(k0 + j) * N + k) : 0.0f;
      },
      As, Bs);
  float* Sb = Sw + bc * Q * Q;
  if (hg == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = q0 + 4 * ty + r, k = k0 + 4 * tx + c;
        if (q < Q && k < Q) Sb[(size_t)q * Q + k] = s[r][c];
      }
  }

  float ds[4][4];
  zero(ds);
  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();  // the last head's readers of aq and ak are done
    if (tid < TILE)
      aq[tid] = q0 + tid < Q ? db[(size_t)(q0 + tid) * H + h] : 0.0f;
    else if (tid < 2 * TILE)
      ak[tid - TILE] =
          k0 + tid - TILE < Q ? db[(size_t)(k0 + tid - TILE) * H + h] : 0.0f;
    float g[4][4];
    zero(g);
    tile_mm<true, true>(
        g, 0, P,
        [&](int i, int p) {
          return q0 + i < Q ? dyb[(size_t)(q0 + i) * row + (size_t)h * P + p]
                            : 0.0f;
        },
        [&](int p, int j) {
          return k0 + j < Q ? xb[(size_t)(k0 + j) * row + (size_t)h * P + p]
                            : 0.0f;
        },
        As, Bs);
    float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ty + r, j = 4 * tx + c;
        if (q0 + i < Q && k0 + j <= q0 + i) {
          const float t = g[r][c] * expf(aq[i] - ak[j]);
          ds[r][c] += t;
          const float R = t * s[r][c];
          rs[r] += R;
          cs[c] += R;
        }
      }
    const size_t hb = (bc * H + h) * d.nt;
    const float rsum = tile_sum<false>(rs, red);
    if (tid < TILE && q0 + tid < Q) rpart[(hb + kt) * Q + q0 + tid] = rsum;
    const float csum = tile_sum<true>(cs, red);
    if (tid < TILE && k0 + tid < Q) cpart[(hb + qt) * Q + k0 + tid] = csum;
  }
  // this head group's share of dS (zero above the diagonal)
  float* dSb = dSpart + ((size_t)hg * gridDim.x + bc) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = q0 + 4 * ty + r, k = k0 + 4 * tx + c;
      if (q < Q && k < Q) dSb[(size_t)q * Q + k] = ds[r][c];
    }
}

// out[e] = the sum of parts[g * total + e] over g = 0 .. nparts - 1, in
// that order, rounded once to T
template <typename T>
__global__ void sum_parts(const float* __restrict__ parts, int nparts,
                          size_t total, T* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = parts[e];
    for (int g = 1; g < nparts; ++g) v += parts[(size_t)g * total + e];
    st(out + e, v);
  }
}

// pass 2: block (chunk, head, key tile)
template <typename T>
__global__ void __launch_bounds__(THREADS)
dxdt_pass(const float* __restrict__ xdt, const float* __restrict__ dacs,
          const T* __restrict__ Bg, const float* __restrict__ dy,
          const float* __restrict__ dst, const float* __restrict__ Sw,
          float* __restrict__ dxdt, float* __restrict__ eu, const Dims d) {
  __shared__ __align__(16) float As[KC * LDS];
  __shared__ __align__(16) float Bs[KC * LDS];
  __shared__ float red[TILE][RED];
  __shared__ float ak[TILE], ek[TILE];
  const int Q = d.q, H = d.h, P = d.p, N = d.n;
  const size_t bc = blockIdx.x;
  const int h = blockIdx.y, k0 = blockIdx.z * TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row = (size_t)H * P;
  const float* db = dacs + bc * Q * H + h;  // row t: db[t * H]
  const float* dyh = dy + bc * Q * row + (size_t)h * P;
  const float* xh = xdt + bc * Q * row + (size_t)h * P;
  float* gh = dxdt + bc * Q * row + (size_t)h * P;
  const float* Sb = Sw + bc * Q * Q;
  const T* Bb = Bg + bc * Q * N;
  const float* sth = dst + (bc * H + h) * (size_t)P * N;
  if (tid < TILE) {
    const int k = k0 + tid;
    ak[tid] = k < Q ? db[(size_t)k * H] : 0.0f;
    ek[tid] = k < Q ? expf(db[(size_t)(Q - 1) * H] - db[(size_t)k * H]) : 0.0f;
  }
  float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p0 = 0; p0 < P; p0 += TILE) {
    float a[4][4], w[4][4];
    zero(a);
    zero(w);
    // (S o L)^T dy: query rows q >= k, from the key tile on
    tile_mm<false, false>(
        a, k0, Q,
        [&](int i, int q) {
          const int k = k0 + i;
          return k < Q && q >= k
                     ? Sb[(size_t)q * Q + k] * expf(db[(size_t)q * H] - ak[i])
                     : 0.0f;
        },
        [&](int q, int j) {
          return p0 + j < P ? dyh[(size_t)q * row + p0 + j] : 0.0f;
        },
        As, Bs);
    // W = B dstates^T
    tile_mm<true, true>(
        w, 0, N,
        [&](int i, int n) {
          return k0 + i < Q ? ld(Bb + (size_t)(k0 + i) * N + n) : 0.0f;
        },
        [&](int n, int j) {
          return p0 + j < P ? sth[(size_t)(p0 + j) * N + n] : 0.0f;
        },
        As, Bs);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ty + r, k = k0 + i, p = p0 + 4 * tx + c;
        if (k < Q && p < P) {
          gh[(size_t)k * row + p] = a[r][c] + ek[i] * w[r][c];
          u[r] += xh[(size_t)k * row + p] * w[r][c];
        }
      }
  }
  const float us = tile_sum<false>(u, red);
  if (tid < TILE && k0 + tid < Q)
    eu[(bc * H + h) * Q + k0 + tid] = ek[tid] * us;
}

// pass 3: block (chunk, row tile, column tile of N x group of (h, p))
template <typename T>
__global__ void __launch_bounds__(THREADS)
dbc_pass(const float* __restrict__ xdt, const float* __restrict__ dacs,
         const T* __restrict__ Bg, const T* __restrict__ Cg,
         const float* __restrict__ dst, const float* __restrict__ dSw,
         float* __restrict__ dBpart, T* __restrict__ dC, const Dims d) {
  __shared__ __align__(16) float As[KC * LDS];
  __shared__ __align__(16) float Bs[KC * LDS];
  const int Q = d.q, H = d.h, P = d.p, N = d.n;
  const size_t bc = blockIdx.x;
  const int sgi = blockIdx.z % d.sg;
  const int r0 = blockIdx.y * TILE, n0 = (blockIdx.z / d.sg) * TILE;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row = (size_t)H * P;
  const int hp_lo = (int)((long long)sgi * H * P / d.sg);
  const int hp_hi = (int)((long long)(sgi + 1) * H * P / d.sg);
  const float* dSb = dSw + bc * Q * Q;
  const T* Bb = Bg + bc * Q * N;
  const T* Cb = Cg + bc * Q * N;
  const float* xb = xdt + bc * Q * row;
  const float* db = dacs + bc * Q * H;
  const float* stb = dst + bc * row * N;
  float acc[4][4];

  // group 0 alone: dC[q, n] = sum over keys k <= q of dS[q, k] B[k, n]
  if (sgi == 0) {  // uniform over the block
    zero(acc);
    tile_mm<true, false>(
        acc, 0, min(Q, r0 + TILE),
        [&](int i, int k) {
          const int q = r0 + i;
          return q < Q && k <= q ? dSb[(size_t)q * Q + k] : 0.0f;
        },
        [&](int k, int j) {
          return n0 + j < N ? ld(Bb + (size_t)k * N + n0 + j) : 0.0f;
        },
        As, Bs);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = r0 + 4 * ty + r, n = n0 + 4 * tx + c;
        if (q < Q && n < N) st(dC + (bc * Q + q) * N + n, acc[r][c]);
      }
  }

  // dB[k, n], this group's share: group 0 sums over queries q >= k of
  // dS[q, k] C[q, n]; every group sums its (h, p) pairs of the states'
  // term e_h[k] xdt[k, h, p] dstates[h, p, n]
  zero(acc);
  tile_mm<false, false>(
      acc, r0, sgi == 0 ? Q : r0,
      [&](int i, int q) {
        const int k = r0 + i;
        return k < Q && q >= k ? dSb[(size_t)q * Q + k] : 0.0f;
      },
      [&](int q, int j) {
        return n0 + j < N ? ld(Cb + (size_t)q * N + n0 + j) : 0.0f;
      },
      As, Bs);
  tile_mm<true, false>(
      acc, hp_lo, hp_hi,
      [&](int i, int hp) {
        const int k = r0 + i;
        if (k >= Q) return 0.0f;
        const int h = hp / P;
        return expf(db[(size_t)(Q - 1) * H + h] - db[(size_t)k * H + h]) *
               xb[(size_t)k * row + hp];
      },
      [&](int hp, int j) {
        return n0 + j < N ? stb[(size_t)hp * N + n0 + j] : 0.0f;
      },
      As, Bs);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = r0 + 4 * ty + r, n = n0 + 4 * tx + c;
      if (k < Q && n < N)
        dBpart[(((size_t)sgi * gridDim.x + bc) * Q + k) * N + n] = acc[r][c];
    }
}

// pass 4: a thread per (chunk, row, head)
__global__ void ddacs_pass(const float* __restrict__ rpart,
                           const float* __restrict__ cpart,
                           const float* __restrict__ eu,
                           float* __restrict__ ddacs, size_t total,
                           const Dims d) {
  const int Q = d.q, H = d.h;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int h = (int)(e % H);
    const int t = (int)((e / H) % Q);
    const size_t bc = e / ((size_t)H * Q);
    const size_t hb = (bc * H + h) * d.nt;
    const int tt = t / TILE;
    float v = 0.0f;
    for (int kt = 0; kt <= tt; ++kt) v += rpart[(hb + kt) * Q + t];
    for (int qt = tt; qt < d.nt; ++qt) v -= cpart[(hb + qt) * Q + t];
    const float* e_u = eu + (bc * H + h) * Q;
    v -= e_u[t];
    if (t == Q - 1) {
      float s = 0.0f;
      for (int k = 0; k < Q; ++k) s += e_u[k];
      v += s;
    }
    ddacs[e] = v;
  }
}

template <typename T>
int launch(const void* xdt, const void* dacs, const void* B, const void* C,
           const void* dy, const void* dst, void* dxdt, void* ddacs, void* dB,
           void* dC, void* Sw, void* dSw, void* dSpart, void* dBpart,
           void* rpart, void* cpart, void* eu, int bc, int q, int h, int p,
           int n, int hg, int sg, void* stream) {
  const int nt = (q + TILE - 1) / TILE, ntn = (n + TILE - 1) / TILE;
  if (bc <= 0 || q <= 0 || h <= 0 || p <= 0 || n <= 0 || hg <= 0 ||
      hg > h || hg > 65535 || sg <= 0 || sg > h * p ||
      (long long)ntn * sg > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d{q, h, p, n, nt, hg, sg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(xdt);
  const float* a = static_cast<const float*>(dacs);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* g = static_cast<const float*>(dy);
  const float* gs = static_cast<const float*>(dst);
  float* S = static_cast<float*>(Sw);
  float* dS = static_cast<float*>(dSw);
  float* rp = static_cast<float*>(rpart);
  float* cp = static_cast<float*>(cpart);
  float* e_u = static_cast<float*>(eu);
  auto grid_of = [](size_t total) {
    const size_t b = (total + 255) / 256;
    return (unsigned)(b < 65536 ? b : 65536);
  };
  ds_pass<T><<<dim3(bc, nt * (nt + 1) / 2, hg), THREADS, 0, s>>>(
      x, a, Bt, Ct, g, S, static_cast<float*>(dSpart), rp, cp, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t ds_total = (size_t)bc * q * q;
  sum_parts<float><<<grid_of(ds_total), 256, 0, s>>>(
      static_cast<const float*>(dSpart), hg, ds_total, dS);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dxdt_pass<T><<<dim3(bc, h, nt), THREADS, 0, s>>>(
      x, a, Bt, g, gs, S, static_cast<float*>(dxdt), e_u, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dbc_pass<T><<<dim3(bc, nt, ntn * sg), THREADS, 0, s>>>(
      x, a, Bt, Ct, gs, dS, static_cast<float*>(dBpart), static_cast<T*>(dC),
      d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t db_total = (size_t)bc * q * n;
  sum_parts<T><<<grid_of(db_total), 256, 0, s>>>(
      static_cast<const float*>(dBpart), sg, db_total, static_cast<T*>(dB));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t total = (size_t)bc * q * h;
  ddacs_pass<<<grid_of(total), 256, 0, s>>>(
      rp, cp, e_u, static_cast<float*>(ddacs), total, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspaces (fp32, allocated by the caller, aliasing nothing): S and dS
// (BC, Q, Q); dSpart (hg, BC, Q, Q); dBpart (sg, BC, Q, N); rpart and
// cpart (BC, H, ceil(Q / 64), Q); eu (BC, H, Q). hg and sg split pass 1's
// heads and pass 3's (h, p) pairs over more blocks (kernels/ssd_scan.py
// bwd_plan). Returns the first launch error of the passes as a cudaError_t.
extern "C" int ssd_intra_chunk_bwd_f32(
    const void* xdt, const void* dacs, const void* B, const void* C,
    const void* dy, const void* dst, void* dxdt, void* ddacs, void* dB,
    void* dC, void* S, void* dS, void* dSpart, void* dBpart, void* rpart,
    void* cpart, void* eu, int bc, int q, int h, int p, int n, int hg, int sg,
    void* stream) {
  return launch<float>(xdt, dacs, B, C, dy, dst, dxdt, ddacs, dB, dC, S, dS,
                       dSpart, dBpart, rpart, cpart, eu, bc, q, h, p, n, hg,
                       sg, stream);
}

extern "C" int ssd_intra_chunk_bwd_bf16(
    const void* xdt, const void* dacs, const void* B, const void* C,
    const void* dy, const void* dst, void* dxdt, void* ddacs, void* dB,
    void* dC, void* S, void* dS, void* dSpart, void* dBpart, void* rpart,
    void* cpart, void* eu, int bc, int q, int h, int p, int n, int hg, int sg,
    void* stream) {
  return launch<bf16>(xdt, dacs, B, C, dy, dst, dxdt, ddacs, dB, dC, S, dS,
                      dSpart, dBpart, rpart, cpart, eu, bc, q, h, p, n, hg,
                      sg, stream);
}
