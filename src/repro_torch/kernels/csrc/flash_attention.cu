// flash_attention: forward online-softmax attention on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_kernel, body _flash_kernel).
//
// q is (B, Sq, HQ, D), k and v are (B, Sk, HKV, D), all row-major in one
// type (fp32 or bf16); o is (B, Sq, HQ, D) in that type. Query head h reads
// KV head h / (HQ / HKV): GQA without repeating K or V. Query row i sits at
// key position q_offset + i (q_offset = Sk - Sq aligns the ends, as in the
// reference); causal keeps keys at or before it, window > 0 keeps only the
// last `window` of those. A masked score is the reference's finite
// NEG_INF = -1e30, never -inf: a row whose first tile is wholly masked then
// takes weight 1 per key, and the first tile with a real key wipes that out
// through alpha = exp(m_old - m_new) = 0, exactly as in the reference. Keys
// past Sk take no weight at all.
//
// One block of 256 threads owns one (batch, query head) and a tile of 64
// query rows; it walks the key tiles of 64 rows in order, staging K and V
// in shared memory (converted to fp32), and keeps the running max m, the
// running sum l and the output accumulator in fp32 (m and l in shared
// memory, the 64 x D accumulator in registers, D/4 values per thread).
// Per tile: S = scale * Q K^T (4 x 4 scores per thread), the mask, the
// online-softmax update (4 threads per row), then acc = acc * alpha + P V
// with P rounded to V's type first, as the reference does. At the end
// o = acc / max(l, 1e-30). When every query row has at least one key to
// attend to (`band`), key tiles wholly outside the causal/window band of
// the query tile are skipped: that computes the same function.
//
// Bound: 4 * D operations per attended (query, key) pair and head (the two
// products; causal attention attends about half of Sq * Sk pairs) at the
// bf16 tensor-core rate, against q, k, v and o each moved once. At GPT-2
// small's serving prefills (bf16, D = 64, 12 heads, causal, Sq = Sk) the
// bytes bound is the larger up to about Sq = 1180: at 1024 it is 1.9 us,
// 15% above the operations bound. This first version works on the CUDA
// cores in fp32 FMA, not the tensor cores, so it sits far above that
// bound; it keeps the score matrix out of device memory (the point of the
// TPU kernel) and reads each K/V tile once per query tile. mma/wgmma on
// bf16 tiles and TMA loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstddef>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// p as the reference feeds it to the p.V product: rounded to V's type
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles with a padded row (conflict-free column walks), V, the
  // score tile (padded), and m, l, alpha per query row
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) +
                  3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int hq, int hkv, int q_offset, int causal, int window,
                 int band, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int SLD = BK + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  float* qs = smem;           // [BQ][LD]
  float* ks = qs + BQ * LD;   // [BK][LD]
  float* vs = ks + BK * LD;   // [BK][D]
  float* ss = vs + BK * D;    // [BQ][SLD]
  float* m_s = ss + BQ * SLD; // [BQ]
  float* l_s = m_s + BQ;      // [BQ]
  float* a_s = l_s + BQ;      // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const size_t q_row = (size_t)hq * D;   // elements between query rows
  const size_t kv_row = (size_t)hkv * D; // elements between key rows
  const T* qb = q + (size_t)b * sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;
  T* ob = o + (size_t)b * sq * q_row + (size_t)h * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * LD + c] =
        q0 + r < sq ? to_f32(qb[(size_t)(q0 + r) * q_row + c]) : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  // key range this query tile attends to (all keys unless `band`)
  const int rows = min(BQ, sq - q0);
  const int p_lo = q_offset + q0, p_hi = q_offset + q0 + rows - 1;
  int k_begin = 0, k_end = sk;
  if (band) {
    if (causal) k_end = min(sk, p_hi + 1);
    if (window) k_begin = max(0, p_lo - window + 1);
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      const size_t off = (size_t)(k0 + r) * kv_row + c;
      ks[r * LD + c] = in ? to_f32(kb[off]) : 0.0f;
      vs[r * D + c] = in ? to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();

    // S = scale * Q K^T, masked; rows ty + 16a, columns tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) kv[bb] = ks[(tx + 16 * bb) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          s[a][bb] = fmaf(qv[a], kv[bb], s[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = ty + 16 * a, c = tx + 16 * bb;
        const int qpos = p_lo + r, kpos = k0 + c;
        float val;
        if (kpos >= sk) {
          val = -INFINITY;  // past the keys: weight exactly 0
        } else {
          bool keep = true;
          if (causal) keep = kpos <= qpos;
          if (window) keep = keep && kpos > qpos - window;
          val = keep ? s[a][bb] * scale : NEG_INF;
        }
        ss[r * SLD + c] = val;
      }
    __syncthreads();

    // online softmax: the 4 neighbouring lanes 4r..4r+3 share row r
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SLD + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = round_as(p, vb);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; rows ty + 16a, columns tx + 16c
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
      float pv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) pv[c] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        const float p = ss[r * SLD + j];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          pv[c] = fmaf(p, vs[j * D + tx + 16 * c], pv[c]);
      }
      const float alpha = a_s[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = acc[a][c] * alpha + pv[c];
    }
  }
  __syncthreads();  // m_s/l_s written (also when no tile was visited)

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* out = ob + (size_t)(q0 + r) * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + tx + 16 * c, acc[a][c] / l);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int hq, int hkv, int q_offset, int causal,
             int window, int band, float scale, void* stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_fwd_kernel<T, D>
      <<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hkv,
          q_offset, causal, window, band, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int hq, int hkv, int d, int q_offset, int causal,
           int window, int band, float scale, void* stream) {
  switch (d) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, b, sq, sk, hq, hkv, q_offset, causal,
                             window, band, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, b, sq, sk, hq, hkv, q_offset, causal,
                             window, band, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, b, sq, sk, hq, hkv, q_offset, causal,
                             window, band, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, b, sq, sk, hq, hkv, q_offset,
                              causal, window, band, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// o must alias none of q, k, v. Returns the launch's cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int sq,
                                   int sk, int hq, int hkv, int d,
                                   int q_offset, int causal, int window,
                                   int band, float scale, void* stream) {
  return launch<float>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset, causal,
                       window, band, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int sq,
                                    int sk, int hq, int hkv, int d,
                                    int q_offset, int causal, int window,
                                    int band, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, sq, sk, hq, hkv, d, q_offset,
                               causal, window, band, scale, stream);
}
