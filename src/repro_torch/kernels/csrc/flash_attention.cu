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
// past Sk take no weight at all, so a row with no key to attend to gets
// the mean of all Sk values (the oracle's answer; the TPU kernel divides by
// its padded key count instead). Scores are fp32 (scale * Q K^T), the
// running max m, sum l and output accumulator fp32, P is rounded to V's
// type before P V while l adds the unrounded p, as the reference does; at
// the end o = acc / max(l, 1e-30). When every query row has at least one
// key to attend to (`band`), key tiles wholly outside the causal/window
// band of the query tile are skipped: that computes the same function.
//
// Two kernels compute it; the entry point picks one by type before the
// launch, and neither ever stands in for the other.
//
// bf16, tc::flash_fwd_bf16 (the serving prefill's path): tensor cores. A
// block of 4 warps owns one (batch, query head) and a 64-row query tile;
// each warp owns 16 query rows. Q, K and V stay bf16 in shared memory, in
// rows padded by 16 bytes so that ldmatrix reads no bank twice. K/V tiles
// of 64 keys arrive by cp.async (16 bytes a thread, zero-filled past Sk)
// into two stages: tile j + 1 is in flight while tile j computes. Per tile
// and warp, S = Q K^T runs on mma.sync m16n8k16 (bf16 in, fp32
// accumulate; Q's fragments loaded once by ldmatrix, K's by ldmatrix) and
// stays in registers. The scale and the mask are applied there, the mask
// only on tiles that cross the causal diagonal, the window's edge or Sk.
// The online softmax runs per row with quad shuffles in the accumulator
// layout, in log2 units (x = s * scale * log2 e, p = 2^(x - m) by one
// ex2.approx; on unmasked tiles the scale folds into one FMA per score),
// with l kept per thread and summed over the quad once, at the end. P is
// packed to bf16 in registers, where the m16n8k16 accumulator layout of two
// n8 score tiles is the A operand layout of one k16 step of O += P V (V by
// ldmatrix.trans). The output goes out through the warp's own Q rows in
// shared memory as 16-byte stores. Blocks are numbered so that every
// head's last query tile (under a causal mask the longest) is launched
// first, then every head's tile before it, and so on.
//
// fp32, flash_fwd_kernel: the CUDA cores in fp32 FMA, exact in fp32. One
// block of 256 threads owns one (batch, query head) and a tile of 64 query
// rows; it walks the key tiles of 64 rows in order, staging K and V in
// shared memory, with m and l in shared memory and the 64 x D accumulator
// in registers (D/4 values per thread); the score tile goes through shared
// memory between the products, the mask and the softmax.
//
// Bound: 4 * D operations per attended (query, key) pair and head (the two
// products; causal attention attends about half of Sq * Sk pairs) at the
// bf16 tensor-core rate, against q, k, v and o each moved once. At GPT-2
// small's serving prefills (bf16, D = 64, 12 heads, causal, Sq = Sk) the
// bytes bound is the larger up to about Sq = 1180: at (1, 1024, 1024, 12,
// 12, 64) it is 0.0019 ms against 0.0016 ms of operations; at batch 8 it is
// 0.0150 ms against 0.0130 ms. The serving buckets give few blocks: Sq = 128
// is 2 query tiles x 12 heads = 24 blocks on 132 SMs, 256 is 48, 512 is 96
// and 1024 is 192.
//
// What limits the bf16 kernel. ptxas (phase 1 of chip_smoke.py): 139
// registers at D = 64 (3 blocks of 4 warps an SM; 46,080 bytes of shared
// memory a block, 4 would fit), 234 at D = 128 (2 blocks; 87,040 bytes),
// 105 at D = 32, 80 at D = 16 (with a 4-byte spill); no other spills. At
// batch 1 the time is a latency, not a rate: the block of a head's last
// query tile walks its key tiles one after another, each a chain of mma,
// shuffles, ex2 and mma between two barriers, and the measured time grows
// by about a microsecond per key tile of that block from a floor of about
// 3 microseconds (scripts/bench_torch_flash.py). At batch 8 (1536 blocks)
// it is a rate, well below the tensor cores' (PERF.md): each warp re-reads
// the whole K and V tile from shared memory for its 16 rows, one
// ldmatrix.x4 for every two mma.sync.
//
// The next step is Hopper's own path: wgmma m64nNk16 (a warpgroup owns 64
// rows and reads K and V from shared memory once for all of them, P as the
// register A operand), K/V by TMA into a ring of stages with mbarriers and a
// producer warp; and for the short prefills a split of the longest query
// tiles' keys over more blocks, merged at the end, so that more SMs share
// the critical path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <math.h>
#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// p as the reference feeds it to the p.V product: rounded to V's type
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int BK = 64;          // key rows per tile
constexpr int STAGES = 2;       // K/V tiles in shared memory
static_assert(BQ == BK, "Q, K and V tiles share one layout");
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// tiles of D-wide bf16 rows, each row padded by 16 bytes: the 8 rows one
// ldmatrix reads then start in 8 different 16-byte bank groups
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }
template <int D>
constexpr size_t smem_bytes() {  // Q, then STAGES K and STAGES V tiles
  return sizeof(bf16) * (size_t)(BQ + 2 * STAGES * BK) * ld<D>();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: a 16 x 16 row-major, b 16 x 8 col-major
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x in one MUFU operation; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + 64) of one head (rows `stride` elements apart) into
// a padded tile, asynchronously; rows at or past `nrows` are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int nrows,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(BK * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < BK * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / CH, c = e % CH;
    const bool valid = row0 + r < nrows;
    cp_async16(dst + r * ld<D>() + c * 8,
               src + (size_t)(valid ? row0 + r : 0) * stride + c * 8, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
               int sk, int hq, int hkv, int q_offset, int causal, int window,
               int band, float scale) {
  constexpr int LD = ld<D>();
  constexpr int TILE = BK * LD;  // elements of a padded tile
  constexpr int KD = D / 16;     // k16 steps of S = Q K^T over the head dim
  constexpr int ND = D / 8;      // n8 tiles of O over the head dim
  constexpr int NS = BK / 8;     // n8 tiles of S over a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + TILE;                           // [STAGES][BK][LD]
  bf16* vs = ks + STAGES * TILE;                  // [STAGES][BK][LD]

  // every (batch, head)'s last query tile first, then the one before it
  const int nq = (sq + BQ - 1) / BQ;
  const int nbh = gridDim.x / nq;
  const int bh = blockIdx.x % nbh;
  const int q0 = (nq - 1 - blockIdx.x / nbh) * BQ;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the mma accumulator layout: this thread holds rows g and g + 8 of the
  // warp's 16, columns 2 t and 2 t + 1 of every n8 tile
  const int g = lane / 4, t = lane % 4;

  const size_t q_row = (size_t)hq * D;   // elements between query rows
  const size_t kv_row = (size_t)hkv * D; // elements between key rows
  const bf16* qb = q + (size_t)b * sq * q_row + (size_t)h * D;
  const bf16* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;
  bf16* ob = o + (size_t)b * sq * q_row + (size_t)h * D;

  // key range this query tile attends to (all keys unless `band`)
  const int rows = min(BQ, sq - q0);
  const int p_lo = q_offset + q0, p_hi = q_offset + q0 + rows - 1;
  int k_begin = 0, k_end = sk;
  if (band) {
    if (causal) k_end = min(sk, p_hi + 1);
    if (window) k_begin = max(0, p_lo - window + 1);
  }
  const int j_begin = k_begin / BK, j_end = (k_end + BK - 1) / BK;

  // copy groups: Q, then one for each of the first STAGES - 1 K/V tiles
  load_tile<D>(qs, qb, q_row, q0, sq, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    const int j = j_begin + i;
    if (j < j_end) {
      load_tile<D>(ks + i * TILE, kb, kv_row, j * BK, sk, tid);
      load_tile<D>(vs + i * TILE, vb, kv_row, j * BK, sk, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();  // Q has landed
  __syncthreads();

  unsigned qf[KD][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        (lane >> 4) * 8);

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // scores in log2 units, x = s * scale * log2(e), so that 2^(x - m) is
  // e^(s * scale - m / log2(e)). A masked score is NEG_INF in either unit:
  // in a row whose scores are all masked x - m = 0, weight 1 per key
  const float scale_log2 = scale * LOG2E;
  float m_row[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, in log2 units
  float l_part[2] = {0.0f, 0.0f};       // this thread's share of l
  const int qpos0 = p_lo + warp * 16 + g;

  for (int j = j_begin; j < j_end; ++j) {
    const int st = (j - j_begin) % STAGES;
    {  // tile j + STAGES - 1 is in flight while tile j computes
      const int jn = j + STAGES - 1;
      const int sn = (st + STAGES - 1) % STAGES;
      if (jn < j_end) {
        load_tile<D>(ks + sn * TILE, kb, kv_row, jn * BK, sk, tid);
        load_tile<D>(vs + sn * TILE, vb, kv_row, jn * BK, sk, tid);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();  // tile j has landed
    __syncthreads();
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;

    // S = Q K^T: K's rows are the n dimension, so plain ldmatrix gives the
    // col-major B fragments of two n8 tiles per k16 step
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bf[4];
        ldsm_x4(bf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], bf[0], bf[1]);
        mma(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }

    // the mask, only on a tile that crosses Sk, the causal diagonal or the
    // window's edge for some row of the query tile; the other tiles fold
    // the scale into one FMA per score below
    const int k0 = j * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > p_lo) ||
                      (window && k0 <= p_hi - window);
    float tmax[2];  // the largest x of rows g and g + 8 in this tile
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qpos0 + (e >> 1) * 8;
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          bool keep = true;
          if (causal) keep = kpos <= qpos;
          if (window) keep = keep && kpos > qpos - window;
          // past the keys: weight exactly 0
          s[n][e] = kpos >= sk ? -INFINITY
                               : (keep ? s[n][e] * scale_log2 : NEG_INF);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      tmax[i] = edge ? mx : mx * scale_log2;
    }

    // online softmax; the 4 lanes of a quad share a row
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(m_row[i], tmax[i]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      alpha[i] = exp2_ftz(m_row[i] - mx);
      m_row[i] = mx;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = m_row[e >> 1];
        const float p = exp2_ftz(edge ? s[n][e] - m
                                      : fmaf(s[n][e], scale_log2, -m));
        sum[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_part[i] = l_part[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V: P in bf16 straight from the S accumulators (n8 tiles 2 kj
    // and 2 kj + 1 are the A fragment of k16 step kj); V's rows are the k
    // dimension, so ldmatrix.trans gives its col-major B fragments
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      const unsigned pa[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                              pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                              pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                              pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned bf[4];
        ldsm_x4_trans(bf, vt + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * LD + dp * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp], pa, bf[0], bf[1]);
        mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  cp_async_wait<0>();

  // o = acc / max(l, 1e-30), staged through the warp's own Q rows so that
  // the stores to device memory are 16 bytes a thread
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_part[i];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * i) * LD + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / CH, c = e % CH;
    const int row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(ob + (size_t)row * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + c * 8);
  }
}

}  // namespace tc

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int hq, int hkv, int q_offset, int causal,
             int window, int band, float scale, void* stream) {
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, int,
                 int, int, int, float);
  size_t bytes;
  dim3 grid;
  int threads;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_fwd_kernel<T, D>;
    bytes = smem_bytes<D>();
    grid = dim3((sq + BQ - 1) / BQ, b * hq);
    threads = THREADS;
  } else {
    kernel = tc::flash_fwd_bf16<D>;
    bytes = tc::smem_bytes<D>();
    const long long blocks = (long long)((sq + tc::BQ - 1) / tc::BQ) * b * hq;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    grid = dim3((unsigned)blocks);  // a 1-D grid
    threads = tc::THREADS;
  }
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hkv, q_offset,
      causal, window, band, scale);
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
