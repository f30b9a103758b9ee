// ssd_scan: the Mamba-2 SSD intra-chunk pass on Hopper (sm_90a), on the
// tensor cores.
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
// weight of a masked pair is a select of 0, so a positive difference that
// overflows its exponent never reaches a product (the reference masks with
// NEG_INF before its exp). The decay is the exponent of a difference, never
// exp(a) * exp(-b): a chunk's cumulative decay passes -88 at full width.
//
// Bound. Per chunk the causal scores take Q(Q+1)/2 x N multiply-adds,
// y_diag Q(Q+1)/2 x H x P and the states Q x H x P x N; each input is read
// and each output written once. At Mamba-2 2.7B's calibration batch,
// (BC, Q, H, P, N) = (32, 128, 80, 64, 128) with bf16 B and C, that is
// 8.142 GFLOP, 0.0164 ms at the tensor cores' 495 TFLOP/s (TF32), against
// 255.07 MB, 0.0761 ms at 3.35 TB/s: the bytes bound it (on the CUDA cores'
// 67 TFLOP/s the operations took 0.1215 ms and bounded the kernel before).
// The split products execute about 19.8 GFLOP of TF32 (y_diag 3 products,
// the states 2): 0.040 ms at the tensor cores' peak, still under the bytes.
//
// Design: one launch, plus a reduction only for a chunk above 128 rows.
// The launch plan (query tile, head groups, the shared-memory layout) is
// kernels/ssd_scan.py ssd_plan, from (BC, Q, H, P) and the card's SM count
// and occupancy; the kernel takes it as arguments. What each point does
// about the kernel it replaces (fp32 FMA on the CUDA cores, shared-memory
// bound inner loops, scores recomputed per 8 heads, unbalanced blocks,
// synchronous 4-byte copies):
//
// 1. The three products on the tensor cores, mma.sync with fp32
//    accumulation. Scores from bf16 B and C: m16n8k16 bf16, exact
//    products, the same function as fp32 FMA up to summation order. Every
//    fp32 operand is split, x = hi + lo with hi = tf32(x) and lo =
//    tf32(x - hi), rounding to nearest with ties away, and takes three
//    m16n8k8 TF32 products lo*hi + hi*lo + hi*hi: scores from fp32 B and
//    C, y_diag (M and xdt both fp32), the states with fp32 B. With bf16 B,
//    exact in TF32, the states take two: lo*B + hi*B. A single TF32
//    product keeps about three decimal digits and misses the fp32
//    tolerance of 1e-4. The rounding is two integer operations (with
//    cvt.rna.tf32.f32 in their place the kernel took 6% longer on an H100,
//    scripts/bench_torch_ssd.py --ablate). The products are issued in
//    rounds over a compile-time number of n-tiles (every lo*hi, then every
//    hi*lo, then every hi*hi): no branch splits a round, and no product
//    waits on the one just issued.
// 2. Scores once per block. A block owns one chunk's query tile (the whole
//    chunk up to 128 rows) and a group of heads. It computes the tile's
//    causal scores once, in key blocks of 64 (one 8-key column per warp)
//    over slabs of 128 bf16 or 64 fp32 state columns, skipping 16 x 8 tiles
//    strictly above the diagonal, and keeps them in shared memory in the
//    mma accumulator's layout (a float4 per lane and 16 x 8 tile, read back
//    conflict-free). Per head, a warp reads its score fragments, forms M =
//    scores * decay in registers (the decay by ex2 of the difference of
//    the rows' dacs in log2 units; a key after its row weighs exactly 0)
//    and uses M directly as the A operand of M xdt: the accumulator holds
//    keys 2t and 2t + 1 where the m16n8k8 A operand wants k = t and t + 4,
//    so the k order of each 8-key step is permuted (k = t is key 2t, k =
//    t + 4 key 2t + 1) and xdt's rows are read in that order. B rows of the
//    tile are staged once per block and serve the states of every head (a
//    state size above one slab restages them per head). Padded rows
//    (pitch 4 mod 32 words) make every fragment read conflict-free.
// 3. The states as a (P x Q)(Q x N) product per head, from the same staged
//    xdt tile as y_diag: the decay to the chunk's end, exp(dacs[Q-1] -
//    dacs[q]), is computed once per head and row and folded into the xdt
//    operand as its fragment is read; the q order is permuted as in 2.
// 4. cp.async: xdt tiles (16-byte copies, or element copies for a base that
//    is not 16-byte aligned) and each head's dacs (4-byte copies) into two
//    stages, so the next head's operands arrive while this head computes.
//    B and C rows take 16-byte copies where a row is whole 16-byte chunks
//    and the bases are aligned, else element copies (a ragged N).
// 5. Blocks of 8 warps: warps 0-3 run y_diag and warps 4-7 the states of
//    the same head at once (a barrier of their own orders the decay
//    before the states). A y_diag warp takes the 16-row slices s and
//    R - 1 - s of the tile, so each warp's causal work is the same, and
//    reads and splits each xdt fragment once for both slices; a states
//    warp takes 16 (or 32) rows of P and a share of the columns. The plan
//    picks the head groups per chunk whose waves times the largest group's
//    heads (plus half a head for the score pass) is least: at the
//    calibration shape 4 groups of 20 heads, 128 blocks, one wave on 132
//    SMs (142,880 bytes of shared memory at P = 64: one block an SM; 5
//    groups would take 160 blocks, two waves); at H = 40 and H = 16 also 4
//    groups, 128 blocks. A chunk above 128 rows is cut into query tiles of
//    64 rows (the last ones launched first, since they see the most keys);
//    each writes its rows' share of the states to a workspace, and
//    reduce_tiles sums the shares in tile order. No atomics: two calls
//    give the same bits.
//
// ptxas (nvcc -Xptxas -v, sm_90a; chip_smoke.py phase 1 prints it):
// registers a thread, no spills (0 bytes stack frame, 0 bytes spill stores
// and loads) in every variant, 2 barriers:
//   bf16 B/C: P = 16: 153, P = 32: 156, P = 64: 196, P = 128: 205
//   fp32 B/C: P = 16: 150, P = 32: 156, P = 64: 201, P = 128: 213
//   reduce_tiles: 32
// Shared memory is dynamic, ssd_layout's: 142,880 bytes at (Q, P) = (128,
// 64), up to 214,304 at (512, 128).
//
// What bounds it now (scripts/bench_torch_ssd.py --ablate): neither the
// tensor cores nor the bytes alone. The products alone and the copies
// alone each take most of the kernel's time, and they overlap only in
// part. A wgmma version with TMA copies and stores is the next step
// (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int YW = 4;          // warps 0-3: y_diag
constexpr int SW = WARPS - YW; // warps 4-7: the states
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KB = 64;  // keys per score block: one 8-key column per warp
constexpr int MAX_SMEM = 232448;

// a slab of B or C columns in shared memory; a padded row of either type is
// 272 bytes (16 bytes past a multiple of 128: ldmatrix and the fragment
// reads meet no bank twice)
template <typename T>
struct Slab;
template <>
struct Slab<bf16> {
  static constexpr int COLS = 128, LD = 136, KSTEP = 16;
};
template <>
struct Slab<float> {
  static constexpr int COLS = 64, LD = 68, KSTEP = 8;
};

// what ssd_plan decided, and where its shared-memory regions start (bytes)
struct Plan {
  int bc, q, h, n, qt, tiles, groups;
  int off_s, off_b, off_dac, off_dec;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes into shared memory, zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes into shared memory, zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b, m16n8k16: a 16 x 16 bf16 row-major, b 16 x 8 bf16 col-major
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b, m16n8k8: a 16 x 8 TF32 row-major, b 8 x 8 TF32 col-major
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 rounding, to nearest with ties away from zero (as cvt.rna.tf32.f32
// rounds), in two integer operations
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo in TF32: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b in split TF32: lo*hi + hi*lo + hi*hi, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0,
                                     unsigned bh1, unsigned bl0,
                                     unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// rows [row0, row0 + rows) and columns [col0, col0 + cols) of a source whose
// row j starts at src + j * sld, into dst with a pitch of dld elements; rows
// at or past nrows and columns at or past ncols become zeros. vec: 16-byte
// cp.async (the caller has checked that every source row is 16-byte aligned
// and that cols and ncols are whole 16-byte chunks), else element copies
// through registers.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dld, const T* src,
                                      size_t sld, int row0, int rows,
                                      int nrows, int col0, int cols,
                                      int ncols, bool vec, int tid,
                                      int nthreads) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int ch = cols / E;
    for (int e = tid; e < rows * ch; e += nthreads) {
      const int r = e / ch, c = (e % ch) * E;
      const bool ok = row0 + r < nrows && col0 + c < ncols;
      cp_async16(dst + r * dld + c,
                 ok ? src + (size_t)(row0 + r) * sld + col0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, c = e % cols;
      const bool ok = row0 + r < nrows && col0 + c < ncols;
      dst[r * dld + c] =
          ok ? src[(size_t)(row0 + r) * sld + col0 + c] : zero_of<T>();
    }
  }
}

// 2^x in one MUFU operation; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the states warps' own barrier (the y_diag warps go on meanwhile)
__device__ __forceinline__ void states_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(SW * 32) : "memory");
}

// The decayed weights of one 16 x 8 tile of a 16-row slice as the split
// TF32 A operand of M xdt. s holds the scores in the accumulator layout
// (rows g, g + 8 x keys 2t, 2t + 1); d0, d1 are the rows' dacs and dj the
// keys' dacs, in log2 units; jr = key 2t's offset from the slice's first
// row. A key after its row weighs exactly 0 (a select: the exponent of a
// masked pair is never used). k = t is key 2t and k = t + 4 key 2t + 1.
__device__ __forceinline__ void weights(const float4 s, float d0, float d1,
                                        float2 dj, int jr, unsigned (&ah)[4],
                                        unsigned (&al)[4]) {
  const int g = (threadIdx.x % 32) / 4;
  const float m0 = jr <= g ? s.x * exp2_ftz(d0 - dj.x * LOG2E) : 0.0f;
  const float m1 = jr + 1 <= g ? s.y * exp2_ftz(d0 - dj.y * LOG2E) : 0.0f;
  const float m2 = jr <= g + 8 ? s.z * exp2_ftz(d1 - dj.x * LOG2E) : 0.0f;
  const float m3 = jr + 1 <= g + 8 ? s.w * exp2_ftz(d1 - dj.y * LOG2E) : 0.0f;
  split(m0, ah[0], al[0]);
  split(m2, ah[1], al[1]);
  split(m1, ah[2], al[2]);
  split(m3, ah[3], al[3]);
}

// acc[NTY + nt] += A_b x_nt and, with BOTH, acc[nt] += A_a x_nt, each
// in split TF32 (lo*hi, hi*lo, hi*hi); one round of products over all
// tiles before the next
template <int NTY, bool BOTH>
__device__ __forceinline__ void y_rounds(float (&acc)[2 * NTY][4],
                                         const unsigned (&ah)[2][4],
                                         const unsigned (&al)[2][4],
                                         const unsigned (&xh)[NTY][2],
                                         const unsigned (&xl)[NTY][2]) {
#pragma unroll
  for (int nt = 0; nt < NTY; ++nt) {
    mma_tf32(acc[NTY + nt], al[1], xh[nt][0], xh[nt][1]);
    if (BOTH) mma_tf32(acc[nt], al[0], xh[nt][0], xh[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NTY; ++nt) {
    mma_tf32(acc[NTY + nt], ah[1], xl[nt][0], xl[nt][1]);
    if (BOTH) mma_tf32(acc[nt], ah[0], xl[nt][0], xl[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NTY; ++nt) {
    mma_tf32(acc[NTY + nt], ah[1], xh[nt][0], xh[nt][1]);
    if (BOTH) mma_tf32(acc[nt], ah[0], xh[nt][0], xh[nt][1]);
  }
}

// One warp's y_diag work on a key tile: its two slices (a, b) and n-tiles
// [c0, c0 + NTY) of a pass.
struct YSpan {
  const float4* sfa;  // score fragments of slice a, and of slice b
  const float4* sfb;
  const float* dv;    // the head's dacs
  const float* xt;    // the key tile's xdt rows (from key kt0)
  int kt0, c0, ra, rb;  // ra, rb: the slices' first rows
  float da0, da1, db0, db1;   // the slices' rows' dacs in log2 units
};

// The operands of one 8-key step at key j0: the split weights of slice b
// (and a) and the split xdt fragments of the pass's n-tiles.
template <int P, int NTY, bool BOTH>
__device__ __forceinline__ void y_operands(const YSpan& sp, int j0,
                                           unsigned (&ah)[2][4],
                                           unsigned (&al)[2][4],
                                           unsigned (&xh)[NTY][2],
                                           unsigned (&xl)[NTY][2]) {
  constexpr int LDX = P + 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float2 dj = *reinterpret_cast<const float2*>(sp.dv + j0 + 2 * t);
  weights(sp.sfb[(j0 >> 3) * 32], sp.db0, sp.db1, dj, j0 - sp.rb + 2 * t,
          ah[1], al[1]);
  if (BOTH)
    weights(sp.sfa[(j0 >> 3) * 32], sp.da0, sp.da1, dj, j0 - sp.ra + 2 * t,
            ah[0], al[0]);
  // B operand: rows j0 + 2t (k = t) and j0 + 2t + 1 (k = t + 4)
  const float* xr = sp.xt + (j0 - sp.kt0 + 2 * t) * LDX + sp.c0 * 8 + g;
#pragma unroll
  for (int nt = 0; nt < NTY; ++nt) {
    split(xr[nt * 8], xh[nt][0], xl[nt][0]);
    split(xr[LDX + nt * 8], xh[nt][1], xl[nt][1]);
  }
}

// y_diag over keys [j_begin, j_end)
template <int P, int NTY, bool BOTH>
__device__ __forceinline__ void y_span(float (&acc)[2 * NTY][4],
                                       const YSpan& sp, int j_begin,
                                       int j_end) {
  unsigned ah[2][4], al[2][4], xh[NTY][2], xl[NTY][2];
  for (int j0 = j_begin; j0 < j_end; j0 += 8) {
    y_operands<P, NTY, BOTH>(sp, j0, ah, al, xh, xl);
    y_rounds<NTY, BOTH>(acc, ah, al, xh, xl);
  }
}

// first score tile of 16-row slice r in a query tile starting at row i0:
// slice r' holds i0 / 8 + 2 (r' + 1) tiles of 8 keys
__device__ __forceinline__ int slice_tiles_before(int r, int i0) {
  return r * (i0 >> 3) + r * (r + 1);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ dacs,
                       const T* __restrict__ Bg, const T* __restrict__ Cg,
                       float* __restrict__ y, float* __restrict__ st,
                       float* __restrict__ ws, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  using SL = Slab<T>;
  constexpr bool BF = std::is_same_v<T, bf16>;
  constexpr int LDX = P + 4;  // xdt tile pitch in floats, 4 mod 32
  constexpr int NTY = P / 8 < 8 ? P / 8 : 8;  // y n-tiles of a pass
  constexpr int NYG = P / 8 / NTY;             // groups of NTY n-tiles
  const int q = pl.q, h = pl.h, n = pl.n, QT = pl.qt, R = QT / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row and column

  // block -> (query tile, chunk, head group), the last query tiles first;
  // kernels/ssd_scan.py SsdPlan.block_work mirrors this
  const int per_tile = pl.bc * pl.groups;
  const int ti = pl.tiles - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const size_t bc = rem / pl.groups;
  const int grp = rem % pl.groups;
  const int h_lo = (int)((long long)grp * h / pl.groups);
  const int h_hi = (int)((long long)(grp + 1) * h / pl.groups);
  const int i0 = ti * QT;     // this tile's first query row
  const int kend = i0 + QT;   // its rows see keys [0, kend)

  float* xs = reinterpret_cast<float*>(smem);                // [2][QT][LDX]
  const float4* ss = reinterpret_cast<const float4*>(smem + pl.off_s);
  T* bs = reinterpret_cast<T*>(smem + pl.off_b);             // [QT][SL::LD]
  float* dac = reinterpret_cast<float*>(smem + pl.off_dac);  // [2][dacn]
  float* dec = reinterpret_cast<float*>(smem + pl.off_dec);  // [QT]
  const int dacn = pl.tiles * QT + 4;  // slot tiles * QT: dacs[Q - 1]

  const float* xb = xdt + bc * q * h * P;
  const float* db = dacs + bc * q * h;
  const T* Bb = Bg + bc * q * n;
  const T* Cb = Cg + bc * q * n;
  const bool bc_vec = (n * (int)sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Bg) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Cg) % 16 == 0;
  const bool x_vec = reinterpret_cast<uintptr_t>(xdt) % 16 == 0;
  const int nslab = (n + SL::COLS - 1) / SL::COLS;

  // ---- the tile's causal scores, once for all heads of the block
  {
    T* cst = reinterpret_cast<T*>(smem);  // [QT][SL::LD] C rows (over xs)
    T* bst = cst + QT * SL::LD;           // [KB][SL::LD] B rows of a key block
    float4* sw = reinterpret_cast<float4*>(smem + pl.off_s);
    for (int kb = 0; kb * KB < kend; ++kb) {
      const int c = kb * 8 + warp;  // this warp's 8-key column
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
      for (int sl = 0; sl < nslab; ++sl) {
        const int col0 = sl * SL::COLS;
        const int cols = min(SL::COLS, n - col0);
        const int wcols = (cols + SL::KSTEP - 1) / SL::KSTEP * SL::KSTEP;
        __syncthreads();  // the last slab's readers are done
        stage<T>(cst, SL::LD, Cb, n, i0, QT, q, col0, wcols, n, bc_vec, tid,
                 THREADS);
        stage<T>(bst, SL::LD, Bb, n, kb * KB, KB, q, col0, wcols, n, bc_vec,
                 tid, THREADS);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int k0 = 0; k0 < wcols; k0 += SL::KSTEP) {
          if constexpr (BF) {
            unsigned b[2];
            ldsm_x2(b, bst + (warp * 8 + (lane & 7)) * SL::LD + k0 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (r < R && c <= (i0 >> 3) + 2 * r + 1) {
                unsigned a[4];
                ldsm_x4(a, cst + (r * 16 + (lane & 15)) * SL::LD + k0 +
                               (lane >> 4) * 8);
                mma_bf16(acc[r], a, b[0], b[1]);
              }
            }
          } else {
            const float* br = bst + (warp * 8 + g) * SL::LD + k0 + t;
            unsigned bh0, bl0, bh1, bl1;
            split(br[0], bh0, bl0);
            split(br[4], bh1, bl1);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              if (r < R && c <= (i0 >> 3) + 2 * r + 1) {
                const float* cr = cst + (r * 16 + g) * SL::LD + k0 + t;
                unsigned ah[4], al[4];
                split(cr[0], ah[0], al[0]);
                split(cr[8 * SL::LD], ah[1], al[1]);
                split(cr[4], ah[2], al[2]);
                split(cr[8 * SL::LD + 4], ah[3], al[3]);
                mma3(acc[r], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < R && c <= (i0 >> 3) + 2 * r + 1)
          sw[(slice_tiles_before(r, i0) + c) * 32 + lane] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();  // scores written; the staging area is free

  // ---- per head, warps 0-3 run y_diag and warps 4-7 the states
  const int kts = ti + 1;                 // key tiles of QT rows per head
  const int pairs = (h_hi - h_lo) * kts;  // (head, key tile) steps
  // copies of step k: its xdt tile into stage k % 2 and, on a head's first
  // key tile, the head's dacs into buffer (head index) % 2
  auto issue = [&](int k) {
    const int hl = k / kts, kt = k % kts, hd = h_lo + hl;
    stage<float>(xs + (k & 1) * QT * LDX, LDX, xb + (size_t)hd * P,
                 (size_t)h * P, kt * QT, QT, q, 0, P, P, x_vec, tid,
                 THREADS);
    if (kt == 0) {
      float* dd = dac + (hl & 1) * dacn;
      for (int j = tid; j < kend; j += THREADS)
        cp_async4(dd + j, db + (size_t)(j < q ? j : 0) * h + hd, j < q);
      if (tid == 0)
        cp_async4(dd + pl.tiles * QT, db + (size_t)(q - 1) * h + hd, true);
    }
  };
  if (nslab == 1)  // B rows of the tile, for every head's states
    stage<T>(bs, SL::LD, Bb, n, i0, QT, q, 0,
             (n + SL::KSTEP - 1) / SL::KSTEP * SL::KSTEP, n, bc_vec, tid,
             THREADS);
  issue(0);
  cp_async_commit();

  // y_diag warps: warp -> (pair of slices pr and R - 1 - pr, n-group ng);
  // a warp takes its n-group's NYG / ngy groups of NTY n-tiles one pass
  // at a time (more than one pass only with one query tile)
  const int npairs = (R + 1) / 2;
  const int ngy = min(NYG, YW / (npairs <= 1 ? 1 : npairs <= 2 ? 2 : 4));
  const int npass = NYG / ngy;
  const int pr = warp / ngy, ng = warp % ngy;
  // states warps: warp -> (RBW blocks of 16 rows of P, columns of a slab)
  constexpr int WM = P / 16 < SW ? P / 16 : SW, WN = SW / WM;
  constexpr int RBW = P / 16 / WM;
  constexpr int NTS_ALL = SL::COLS / 8 / WN;
  constexpr int SPASS = RBW * NTS_ALL > 16 ? 2 : 1;  // column passes a slab
  constexpr int NTS = NTS_ALL / SPASS;  // n-tiles of a pass
  const int sw_ = warp - YW;
  const int p0 = (sw_ % WM) * RBW * 16, wn = sw_ / WM;
  float* sdst = pl.tiles > 1 ? ws + (size_t)ti * pl.bc * h * P * n : st;

  // y_diag: acc[si * NTY + nt] for slice si (pr, R - 1 - pr) and n-tile
  // nt of a pass; the states: acc[rb * NTS + nt]
  float acc[2 * NTY][4];
  static_assert(RBW * NTS <= 2 * NTY, "the states fit the accumulators");
  for (int k = 0; k < pairs; ++k) {
    const int hl = k / kts, kt = k % kts, hd = h_lo + hl;
    const float* dv = dac + (hl & 1) * dacn;
    cp_async_wait<0>();
    __syncthreads();  // step k has landed; step k - 1's readers are done
    if (k + 1 < pairs) issue(k + 1);
    cp_async_commit();
    const float* xt = xs + (k & 1) * QT * LDX;

    if (warp < YW) {
      // ---- y_diag += M xdt over key tile kt, NTY n-tiles at a time
      if (pr >= npairs) continue;
      const int sa = pr, sb_ = R - 1 - pr;  // sa <= sb_; equal: one slice
      const int ra = i0 + 16 * sa, rb = i0 + 16 * sb_;  // first rows
      const int jend_a = min(kt * QT + QT, ra + 16);
      const int jend_b = min(kt * QT + QT, rb + 16);
      const float da0 = dv[ra + g] * LOG2E, da1 = dv[ra + g + 8] * LOG2E;
      const float db0 = dv[rb + g] * LOG2E, db1 = dv[rb + g + 8] * LOG2E;
      const float4* sfa = ss + (size_t)slice_tiles_before(sa, i0) * 32 + lane;
      const float4* sfb = ss + (size_t)slice_tiles_before(sb_, i0) * 32 + lane;
      for (int c0 = ng * npass * NTY; c0 < (ng + 1) * npass * NTY;
           c0 += NTY) {
        if (kt == 0) {
#pragma unroll
          for (int i = 0; i < 2 * NTY; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        }
        // keys both slices see, then the keys only the later slice sees
        const YSpan sp{sfa, sfb, dv, xt, kt * QT, c0, ra, rb,
                       da0, da1, db0, db1};
        if (sa != sb_) y_span<P, NTY, true>(acc, sp, kt * QT, jend_a);
        y_span<P, NTY, false>(acc, sp, sa != sb_ ? max(kt * QT, jend_a)
                                                 : kt * QT, jend_b);
        if (kt != ti) continue;
#pragma unroll
        for (int si = 0; si < 2; ++si) {
          if (si == 0 && sa == sb_) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = (si ? rb : ra) + g + 8 * half;
            if (row >= q) continue;
            float* out = y + ((bc * q + row) * h + hd) * P + c0 * 8 + 2 * t;
#pragma unroll
            for (int nt = 0; nt < NTY; ++nt)
              *reinterpret_cast<float2*>(out + nt * 8) =
                    make_float2(acc[si * NTY + nt][2 * half],
                                acc[si * NTY + nt][2 * half + 1]);
          }
        }
      }
      continue;
    }

    // ---- states (or this tile's share) = (xdt * dec)^T B, slab by slab
    if (kt != ti) continue;
    const int stid = tid - YW * 32;
    if (stid < QT) {  // decay of the tile's rows to the chunk's end
      const int qq = i0 + stid;
      dec[stid] = qq < q ? expf(dv[pl.tiles * QT] - dv[qq]) : 0.0f;
    }
    states_barrier();  // dec written
    float* sb = sdst + ((bc * h + hd) * P + p0) * n;
    for (int sl = 0; sl < nslab; ++sl) {
      const int col0 = sl * SL::COLS;
      if (nslab > 1) {
        const int cols = min(SL::COLS, n - col0);
        states_barrier();  // the last slab's readers are done
        stage<T>(bs, SL::LD, Bb, n, i0, QT, q, col0,
                 (cols + SL::KSTEP - 1) / SL::KSTEP * SL::KSTEP, n, bc_vec,
                 stid, SW * 32);
        cp_async_commit();
        cp_async_wait<0>();
        states_barrier();
      }
#pragma unroll
      for (int sp = 0; sp < SPASS; ++sp) {
        const int cw = (wn * SPASS + sp) * NTS * 8;  // first column in the slab
        if (col0 + cw >= n) continue;
#pragma unroll
        for (int i = 0; i < RBW * NTS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
        for (int r0 = 2 * t; r0 < QT; r0 += 8) {  // rows r0 (k = t), r0 + 1
          const float d0 = dec[r0], d1 = dec[r0 + 1];
          unsigned ah[RBW][4], al[RBW][4];
#pragma unroll
          for (int rb = 0; rb < RBW; ++rb) {
            const float* xr = xt + r0 * LDX + p0 + 16 * rb + g;
            split(xr[0] * d0, ah[rb][0], al[rb][0]);
            split(xr[8] * d0, ah[rb][1], al[rb][1]);
            split(xr[LDX] * d1, ah[rb][2], al[rb][2]);
            split(xr[LDX + 8] * d1, ah[rb][3], al[rb][3]);
          }
          // B's rows r0, r0 + 1 for every n-tile, then the products in
          // rounds (columns past N are computed and never stored)
          const T* br = bs + r0 * SL::LD + cw + g;
          unsigned bv[NTS][2];
#pragma unroll
          for (int nt = 0; nt < NTS; ++nt) {
            bv[nt][0] = __float_as_uint(to_f32(br[nt * 8]));
            bv[nt][1] = __float_as_uint(to_f32(br[SL::LD + nt * 8]));
          }
          if constexpr (BF) {  // bf16 is exact in TF32: lo*B, then hi*B
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
              for (int rb = 0; rb < RBW; ++rb)
                mma_tf32(acc[rb * NTS + nt], al[rb], bv[nt][0], bv[nt][1]);
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
              for (int rb = 0; rb < RBW; ++rb)
                mma_tf32(acc[rb * NTS + nt], ah[rb], bv[nt][0], bv[nt][1]);
          } else {
            unsigned bh[NTS][2], bl[NTS][2];
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt) {
              split(__uint_as_float(bv[nt][0]), bh[nt][0], bl[nt][0]);
              split(__uint_as_float(bv[nt][1]), bh[nt][1], bl[nt][1]);
            }
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
              for (int rb = 0; rb < RBW; ++rb)
                mma_tf32(acc[rb * NTS + nt], al[rb], bh[nt][0], bh[nt][1]);
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
              for (int rb = 0; rb < RBW; ++rb)
                mma_tf32(acc[rb * NTS + nt], ah[rb], bl[nt][0], bl[nt][1]);
#pragma unroll
            for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
              for (int rb = 0; rb < RBW; ++rb)
                mma_tf32(acc[rb * NTS + nt], ah[rb], bh[nt][0], bh[nt][1]);
          }
        }
#pragma unroll
        for (int rb = 0; rb < RBW; ++rb)
#pragma unroll
          for (int nt = 0; nt < NTS; ++nt) {
            const int col = col0 + cw + nt * 8 + 2 * t;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float* out = sb + (size_t)(16 * rb + g + 8 * half) * n + col;
              const float v0 = acc[rb * NTS + nt][2 * half];
              const float v1 = acc[rb * NTS + nt][2 * half + 1];
              if ((n & 1) == 0 && col + 1 < n) {
                *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
              } else {
                if (col < n) out[0] = v0;
                if (col + 1 < n) out[1] = v1;
              }
            }
          }
      }
    }
  }
}

// states = the tiles' shares summed in tile order (a chunk above 128 rows)
__global__ void reduce_tiles(const float* __restrict__ ws,
                             float* __restrict__ st, size_t total, int tiles) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int k = 1; k < tiles; ++k) s += ws[(size_t)k * total + e];
    st[e] = s;
  }
}

template <typename T, int P>
cudaError_t configure() {
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

template <typename T, int P>
int launch_p(const void* xdt, const void* dacs, const void* B, const void* C,
             void* y, void* st, void* ws, const Plan& pl, int smem,
             void* stream) {
  if (smem <= 0 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)pl.tiles * pl.bc * pl.groups;
  if (blocks > INT_MAX || (pl.tiles > 1 && ws == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = configure<T, P>();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_intra_chunk_kernel<T, P><<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(dacs),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(y), static_cast<float*>(st),
      static_cast<float*>(ws), pl);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.tiles == 1) return (int)err;
  const size_t total = (size_t)pl.bc * pl.h * P * pl.n;
  const size_t grid = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  reduce_tiles<<<(unsigned)grid, 256, 0, s>>>(static_cast<const float*>(ws),
                                               static_cast<float*>(st), total,
                                               pl.tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xdt, const void* dacs, const void* B, const void* C,
           void* y, void* st, void* ws, int bc, int q, int h, int p, int n,
           int qt, int tiles, int groups, int smem, int off_s, int off_b,
           int off_dac, int off_dec, void* stream) {
  const Plan pl{bc, q, h, n, qt, tiles, groups, off_s, off_b, off_dac,
                off_dec};
  if (qt <= 0 || qt % 16 != 0 || qt > 128 || tiles <= 0 || groups <= 0 ||
      groups > h)
    return (int)cudaErrorInvalidValue;
  switch (p) {
    case 16:
      return launch_p<T, 16>(xdt, dacs, B, C, y, st, ws, pl, smem, stream);
    case 32:
      return launch_p<T, 32>(xdt, dacs, B, C, y, st, ws, pl, smem, stream);
    case 64:
      return launch_p<T, 64>(xdt, dacs, B, C, y, st, ws, pl, smem, stream);
    case 128:
      return launch_p<T, 128>(xdt, dacs, B, C, y, st, ws, pl, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy(int p, int smem, int* blocks) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (p) {
    case 16:
      if ((err = configure<T, 16>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, ssd_intra_chunk_kernel<T, 16>, THREADS, smem);
      break;
    case 32:
      if ((err = configure<T, 32>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, ssd_intra_chunk_kernel<T, 32>, THREADS, smem);
      break;
    case 64:
      if ((err = configure<T, 64>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, ssd_intra_chunk_kernel<T, 64>, THREADS, smem);
      break;
    case 128:
      if ((err = configure<T, 128>()) == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, ssd_intra_chunk_kernel<T, 128>, THREADS, smem);
      break;
    default:
      break;
  }
  return (int)err;
}

}  // namespace

// y, st and ws must alias no input; ws holds tiles x BC x H x P x N floats
// when tiles > 1 (else it may be null). The plan's arguments are ssd_plan's
// (kernels/ssd_scan.py). Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk_f32(const void* xdt, const void* dacs,
                                   const void* B, const void* C, void* y,
                                   void* st, void* ws, int bc, int q, int h,
                                   int p, int n, int qt, int tiles, int groups,
                                   int smem, int off_s, int off_b, int off_dac,
                                   int off_dec, void* stream) {
  return launch<float>(xdt, dacs, B, C, y, st, ws, bc, q, h, p, n, qt, tiles,
                       groups, smem, off_s, off_b, off_dac, off_dec, stream);
}

extern "C" int ssd_intra_chunk_bf16(const void* xdt, const void* dacs,
                                    const void* B, const void* C, void* y,
                                    void* st, void* ws, int bc, int q, int h,
                                    int p, int n, int qt, int tiles,
                                    int groups, int smem, int off_s,
                                    int off_b, int off_dac, int off_dec,
                                    void* stream) {
  return launch<bf16>(xdt, dacs, B, C, y, st, ws, bc, q, h, p, n, qt, tiles,
                      groups, smem, off_s, off_b, off_dac, off_dec, stream);
}

// blocks of the kernel for (bf16 B and C or fp32, P) that one SM holds at
// `smem` bytes of shared memory
extern "C" int ssd_intra_chunk_occupancy(int bf16_bc, int p, int smem,
                                         int* blocks) {
  return bf16_bc ? occupancy<bf16>(p, smem, blocks)
                 : occupancy<float>(p, smem, blocks);
}
