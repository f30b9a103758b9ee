// ssd_scan: the Mamba-2 SSD intra-chunk pass on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_intra_chunk_kernel, body _ssd_kernel).
//
// Per (batch, chunk) and head, with Q rows to the chunk:
//   scores  = C B^T                                  (Q x Q, shared by heads)
//   M[i, j] = scores[i, j] * exp(dacs[i] - dacs[j])  for j <= i, else 0
//   y_diag  = M xdt                                  (Q x P)
//   states  = (xdt * exp(dacs[Q-1] - dacs))^T B      (P x N)
// xdt is (BC, Q, H, P) fp32, dacs (BC, Q, H) fp32 (the in-chunk cumulative
// sum of dt * A), B and C (BC, Q, N) in fp32 or bf16, all row-major, with
// BC = batch * chunks; y_diag is (BC, Q, H, P) fp32 and states
// (BC, H, P, N) fp32. Weights above the diagonal are exactly zero: the
// exponent of a masked pair is never formed, so a positive difference
// cannot overflow (the reference masks with NEG_INF before its exp).
//
// One launch, 256 threads a block, two kinds of block on grid
// (BC, ceil(H / 8), ceil(Q / 64) + 8):
// - z < ceil(Q / 64): the y block of a 64-row query tile and 8 heads. It
//   computes the tile's score rows once into shared memory (C and B
//   staged 32 state columns at a time, 4 x 4 scores a thread) and reuses
//   them for its 8 heads: per head and 64-row key tile at or below the
//   diagonal, it stages xdt and the decayed weights M and accumulates
//   y_diag in registers (4 rows x P/16 columns a thread).
// - z >= ceil(Q / 64): the state block of one head, P x N outputs in
//   passes of 64 state columns (P/16 x 4 a thread), the Q reduction
//   walked in staged tiles of 32 rows.
// The score rows take 64 * (Q + 1) floats, so shared memory grows with
// the chunk: 83 KB at Q = 128, P = 64, 116 KB at Q = 256; the wrapper
// takes Q up to 512 and P in {16, 32, 64, 128}.
//
// Bound: per chunk Q^2 N (scores) + Q (Q + 1) / 2 * H * P (y_diag, causal)
// + Q H P N (states) multiply-adds, twice that in operations, against
// xdt, y_diag and states moved once (fp32). At the calibration shape
// (BC, Q, H, P, N) = (32, 128, 80, 64, 128) that is 8.3 GFLOP, 0.12 ms
// at the 67 TFLOP/s fp32 rate, and 257 MB, 0.077 ms at 3.35 TB/s: the
// operations bound it. This first version runs fp32 FMA on the CUDA
// cores (no TF32, so it holds the fp32 tolerances); it keeps the Q x Q
// score and decay tiles out of device memory, which is what the TPU
// kernel was for. Tensor-core products of the three matrix steps are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstddef>

namespace {

constexpr int QT = 64;        // query rows per y block (= key rows per tile)
constexpr int NK = 32;        // state columns per staged C/B tile
constexpr int HB = 8;         // heads per block
constexpr int QS = 32;        // rows per staged tile of a state block
constexpr int NS = 64;        // state columns per pass of a state block
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int P>
size_t smem_floats(int q) {
  const size_t y_block = (size_t)QT * (q + 1) + 2 * QT * (NK + 1) +
                         (size_t)QT * P + QT * (QT + 1) + q;
  const size_t state_block = (size_t)QS * P + QS * NS + q;
  return y_block > state_block ? y_block : state_block;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ dacs,
                       const T* __restrict__ B, const T* __restrict__ C,
                       float* __restrict__ y, float* __restrict__ st, int q,
                       int h, int n) {
  extern __shared__ float smem[];
  constexpr int NC = P / 16;  // y columns a thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t bc = blockIdx.x;
  const int nqt = (q + QT - 1) / QT;
  const float* xb = xdt + bc * q * h * P;
  const float* db = dacs + bc * q * h;
  const T* Bb = B + bc * q * n;
  const T* Cb = C + bc * q * n;

  if ((int)blockIdx.z < nqt) {
    // ---- y block: query rows i0 .. i0 + rows - 1, keys 0 .. kend - 1
    const int i0 = blockIdx.z * QT;
    const int rows = min(QT, q - i0);
    const int kend = i0 + rows;
    const int SLD = q + 1;
    float* S = smem;                    // [QT][q + 1] score rows
    float* Cs = S + QT * SLD;           // [QT][NK + 1]
    float* Bs = Cs + QT * (NK + 1);     // [QT][NK + 1]
    float* Xs = Bs + QT * (NK + 1);     // [QT][P] xdt of a key tile
    float* Ms = Xs + QT * P;            // [QT][QT + 1] decayed weights
    float* dac = Ms + QT * (QT + 1);    // [q] dacs of the current head

    for (int j0 = 0; j0 < kend; j0 += QT) {
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = 0.0f;
      for (int k0 = 0; k0 < n; k0 += NK) {
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < QT * NK; e += THREADS) {
          const int r = e / NK, c = e % NK;
          const bool col = k0 + c < n;
          Cs[r * (NK + 1) + c] =
              r < rows && col ? to_f32(Cb[(size_t)(i0 + r) * n + k0 + c])
                              : 0.0f;
          Bs[r * (NK + 1) + c] =
              j0 + r < kend && col
                  ? to_f32(Bb[(size_t)(j0 + r) * n + k0 + c])
                  : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < NK; ++kk) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * (NK + 1) + kk];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = Bs[(tx + 16 * b) * (NK + 1) + kk];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = fmaf(cv[a], bv[b], s[a][b]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + tx + 16 * b;
          if (j < q) S[(ty + 16 * a) * SLD + j] = s[a][b];
        }
    }

    for (int hh = 0; hh < HB; ++hh) {
      const int hd = blockIdx.y * HB + hh;
      if (hd >= h) break;
      __syncthreads();  // score rows written; the last head's readers done
      for (int j = tid; j < kend; j += THREADS) dac[j] = db[(size_t)j * h + hd];
      float acc[4][NC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;
      for (int j0 = 0; j0 < kend; j0 += QT) {
        __syncthreads();  // dac written; the last tile's readers done
        for (int e = tid; e < QT * P; e += THREADS) {
          const int r = e / P, c = e % P;
          Xs[r * P + c] =
              j0 + r < kend ? xb[((size_t)(j0 + r) * h + hd) * P + c] : 0.0f;
        }
        for (int e = tid; e < QT * QT; e += THREADS) {
          const int r = e / QT, c = e % QT;
          const int i = i0 + r, j = j0 + c;
          float m = 0.0f;  // above the diagonal or past the rows: no weight
          if (r < rows && j <= i) m = S[r * SLD + j] * expf(dac[i] - dac[j]);
          Ms[r * (QT + 1) + c] = m;
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < QT; ++jj) {
          float xv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) xv[c] = Xs[jj * P + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float m = Ms[(ty + 16 * a) * (QT + 1) + jj];
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(m, xv[c], acc[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty + 16 * a;
        if (r >= rows) continue;
        float* out = y + ((bc * q + i0 + r) * h + hd) * P;
#pragma unroll
        for (int c = 0; c < NC; ++c) out[tx + 16 * c] = acc[a][c];
      }
    }
    return;
  }

  // ---- state block of head hd: states[p][n] = sum_q xdt[q][p] dec[q] B[q][n]
  const int hd = blockIdx.y * HB + (blockIdx.z - nqt);
  if (hd >= h) return;
  constexpr int PA = P / 16;  // state rows a thread
  float* Xw = smem;           // [QS][P] decayed xdt
  float* Bt = Xw + QS * P;    // [QS][NS]
  float* dec = Bt + QS * NS;  // [q] decay to the chunk's end
  for (int j = tid; j < q; j += THREADS) dec[j] = db[(size_t)j * h + hd];
  __syncthreads();
  const float dend = dec[q - 1];
  __syncthreads();  // every thread has read the last entry
  for (int j = tid; j < q; j += THREADS) dec[j] = expf(dend - dec[j]);
  float* sb = st + (bc * h + hd) * P * n;
  for (int n0 = 0; n0 < n; n0 += NS) {
    float acc[PA][4];
#pragma unroll
    for (int a = 0; a < PA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    for (int q0 = 0; q0 < q; q0 += QS) {
      __syncthreads();  // dec written; the last tile's readers done
      for (int e = tid; e < QS * P; e += THREADS) {
        const int r = e / P, c = e % P, qq = q0 + r;
        Xw[r * P + c] =
            qq < q ? xb[((size_t)qq * h + hd) * P + c] * dec[qq] : 0.0f;
      }
      for (int e = tid; e < QS * NS; e += THREADS) {
        const int r = e / NS, c = e % NS, qq = q0 + r;
        Bt[r * NS + c] = qq < q && n0 + c < n
                             ? to_f32(Bb[(size_t)qq * n + n0 + c])
                             : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < QS; ++r) {
        float xv[PA], bv[4];
#pragma unroll
        for (int a = 0; a < PA; ++a) xv[a] = Xw[r * P + ty + 16 * a];
#pragma unroll
        for (int b = 0; b < 4; ++b) bv[b] = Bt[r * NS + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < PA; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int a = 0; a < PA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int nn = n0 + tx + 16 * b;
        if (nn < n) sb[(size_t)(ty + 16 * a) * n + nn] = acc[a][b];
      }
  }
}

template <typename T, int P>
int launch_p(const void* xdt, const void* dacs, const void* B, const void* C,
             void* y, void* st, int bc, int q, int h, int n, void* stream) {
  const size_t bytes = smem_floats<P>(q) * sizeof(float);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nqt = (q + QT - 1) / QT;
  const dim3 grid(bc, (h + HB - 1) / HB, nqt + HB);
  ssd_intra_chunk_kernel<T, P>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(xdt), static_cast<const float*>(dacs),
          static_cast<const T*>(B), static_cast<const T*>(C),
          static_cast<float*>(y), static_cast<float*>(st), q, h, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xdt, const void* dacs, const void* B, const void* C,
           void* y, void* st, int bc, int q, int h, int p, int n,
           void* stream) {
  switch (p) {
    case 16:
      return launch_p<T, 16>(xdt, dacs, B, C, y, st, bc, q, h, n, stream);
    case 32:
      return launch_p<T, 32>(xdt, dacs, B, C, y, st, bc, q, h, n, stream);
    case 64:
      return launch_p<T, 64>(xdt, dacs, B, C, y, st, bc, q, h, n, stream);
    case 128:
      return launch_p<T, 128>(xdt, dacs, B, C, y, st, bc, q, h, n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y and st must alias no input. Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk_f32(const void* xdt, const void* dacs,
                                   const void* B, const void* C, void* y,
                                   void* st, int bc, int q, int h, int p,
                                   int n, void* stream) {
  return launch<float>(xdt, dacs, B, C, y, st, bc, q, h, p, n, stream);
}

extern "C" int ssd_intra_chunk_bf16(const void* xdt, const void* dacs,
                                    const void* B, const void* C, void* y,
                                    void* st, int bc, int q, int h, int p,
                                    int n, void* stream) {
  return launch<__nv_bfloat16>(xdt, dacs, B, C, y, st, bc, q, h, p, n,
                               stream);
}
