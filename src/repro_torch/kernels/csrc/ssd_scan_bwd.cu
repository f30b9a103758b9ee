// ssd_scan_bwd: the backward of the Mamba-2 SSD intra-chunk pass on Hopper
// (sm_90a), on the tensor cores.
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
// TFLOP/s TF32, so the bytes bound it. The split products below execute
// about 43 GFLOP of TF32 (G, (S o L)^T dy and the states' share of dB 3
// products each, W 2): 0.087 ms at the tensor cores' peak, still under the
// bytes. This design moves 582.0 MB at that shape (1.70 times the bound's
// bytes, 0.1737 ms at 3.35 TB/s; the reckoning is under "Bytes").
//
// Design. The launch plan (tile rows, head groups, the shared-memory
// layout, the groups of the states' product) is kernels/ssd_scan.py
// bwd_plan, from the shapes alone; the kernels take it as arguments. What
// each point does about the kernel it replaces (fp32 FMA from shared
// memory on the CUDA cores, S recomputed per head group and written to and
// read back from device memory, an expf per staged element, each head's
// operands read by several passes):
//
// 1. Every product on the tensor cores, mma.sync with fp32 accumulation,
//    in the forward's arithmetic (csrc/ssd_scan.cu 1.): S from bf16 B and
//    C by m16n8k16 bf16 (exact products); every fp32 x fp32 product in
//    split TF32, x = hi + lo, three m16n8k8 products lo*hi + hi*lo + hi*hi
//    (G, (S o L)^T dy, the states' share of dB, S from fp32 B and C); two
//    (lo*B + hi*B) where one operand is bf16 and so exact in TF32 (W, dC
//    and dS^T C with bf16 B and C). One TF32 product misses 1e-4 of scale
//    (tests/test_torch_kernels.py emulates both). Products are issued in
//    rounds over the n-tiles (every lo*hi, then every hi*lo, then every
//    hi*hi), so no product waits on the one just issued.
// 2. S and the decays on chip. dx_pass takes a block of 8 warps per
//    (chunk, pair of a query tile and a key tile at or before it, head
//    group); a chunk up to 128 rows (64 at P = 128) is one tile, so one
//    pair. The block forms its pair's scores once, as S^T in the
//    accumulator's layout (16 keys x 8 queries a fragment, a float4 a
//    lane, lower-triangular fragments only), keeps them in shared memory
//    for all its heads, and never writes them to device memory. That one
//    layout serves both uses: G^T = xdt dy^T comes out in the same layout,
//    so R and dS are elementwise there; and the fragment is the A operand
//    of (S o L)^T dy once the k order of each 8-query step is permuted (k
//    = t is query 2t, k = t + 4 query 2t + 1), as the forward feeds M to M
//    xdt. Per head each lane forms L from one ex2 of the log2-scaled
//    difference of the pair's dacs as it reads a fragment, and e once per
//    row (dec); no expf in any staging loop.
// 3. One pass over each head's operands. Per head a block reads that
//    head's dstates, xdt and dy once, through a ring of 3 or 4 slots of
//    shared memory filled by cp.async in the order dstates, xdt, dy: W =
//    B dstates^T first (B's rows of the key tile stay in shared memory for
//    all heads when N fits one slab), which frees the dstates slot for the
//    next head's xdt; then u = rowsum(xdt o W), e o W, G^T, R's row and
//    column sums and the group's dS (in registers across the group's
//    heads), which frees the xdt slot for the next head's dy; then dxdt =
//    (S o L)^T dy + e o W, stored once. At (Q, P, N) = (128, 64, 128) the
//    slots are 34,816 bytes and four fit beside S (36,864 bytes) and B's
//    rows (34,816). The states' share of dB, sum_h (e o xdt_h) dstates_h,
//    a (Q x HP)(HP x N) product, needs a Q x N accumulator that does not
//    fit beside these, so it runs in a second pass, dbc_pass: a block of
//    16 warps (4 x 4 of 32 rows x 32 columns) per (128-row tile,
//    128-column tile, group of whole heads) reduces its heads' (h, p) in
//    steps of 32 through a 3-stage cp.async ring, the decays to the
//    chunk's end from a table made once a block; extra blocks of the same
//    launch form dC = dS B and dS^T C from the summed dS. sum_parts adds
//    the groups' shares of dS and of dB.
// 4. Every shape the wrapper takes. A chunk above the tile is cut into
//    tiles of 64 rows and their pairs: the pairs write partial dxdt (a
//    workspace per query tile) and R's partial row and column sums, which
//    dxdt_sum_pass and ddacs_pass add in tile order. N goes in slabs of up
//    to 128 bf16 or 64 fp32 columns; B's rows and the dstates slot are
//    restaged per slab and head when N takes more than one. Bases that are
//    not 16-byte aligned, or rows that are not whole 16-byte chunks, take
//    element copies. Padded rows carry the chunk's last dacs (so their
//    decays stay finite) and zero operands.
// 5. No atomics: every output and every workspace entry is written by one
//    thread, and every cross-lane, cross-warp and cross-block sum runs in a
//    fixed order; the head groups and the states' groups come from the
//    shapes alone. Two calls give the same bits (the family engine's
//    resume needs them; torch.use_deterministic_algorithms cannot see a
//    kernel loaded through ctypes).
//
// Bytes at the training shape (bf16 B/C; bwd_plan: one pair, 4 head
// groups of 20 heads, dbc_pass in 8 groups of 10 heads): dx_pass reads
// 262.7 MB (xdt, dy and dstates once, 251.7; dacs, 2.6; B and C once per
// group, 8.4) and writes 93.6 MB (dxdt, 83.9; ddacs, 1.3; 4 shares of dS,
// 8.4); sum_parts reads those shares and writes dS (2.1 MB); dbc_pass
// reads 175.4 MB (xdt and dstates again, 167.8; dacs, 1.3; dS twice, 4.2;
// B and C, 2.1) and writes 19.9 MB (9 shares of dB, 18.9; dC, 1.0);
// sum_parts reads those shares and writes dB (1.0 MB): 582.0 MB. The
// second read of xdt and dstates is the price of the states' product in
// its own pass.
//
// ptxas (nvcc -Xptxas -v, sm_90a; chip_smoke.py phase 1 prints it): no
// spills (0 bytes stack frame, 0 bytes spill stores and loads) in any
// variant; registers a thread, barriers:
//   dx_pass bf16 B/C: P = 16: 223, P = 32: 225, P = 64: 231, P = 128: 227
//   dx_pass fp32 B/C: P = 16: 224, P = 32: 225, P = 64: 232, P = 128: 229
//   dbc_pass: 128 (both types; 512 threads a block); 1 barrier each
//   sum_parts, ddacs_pass: 32; dxdt_sum_pass: 30
// Shared memory is dynamic: dx_pass bwd_layout's (220,192 bytes at (Q, P,
// N) = (128, 64, 128) with bf16 B/C, one block an SM), dbc_pass 112,640.
//
// What bounds it now (scripts/bench_torch_ssd.py --backward --ablate,
// PERF.md): neither the tensor cores nor the bytes. dx_pass takes 0.45-0.50
// ms at the training shape; with every product switched off it still takes
// 0.28 ms, and without its operand copies 0.39. Its 8 warps hold about 230
// registers each, the whole register file, so an SM runs 8 warps and the
// chains of shared-memory loads, splits, ex2 and mma.sync stall them: a
// warp's mma.sync issue is far below the tensor cores' rate, and its copies
// overlap its products only in part. More warps (12, 16) spill and run
// slower; dS in shared memory or M = S o L staged once per head gain 2-3%.
// dbc_pass (0.19 ms) runs its products alone in 0.14 ms and its copies
// alone in 0.10. A wgmma version, with TMA copies and a producer warp, is
// the next step (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;       // dx_pass: 8 warps, up to 255 registers each
constexpr int THREADS = 32 * WARPS;
constexpr int DWARPS = 16;     // dbc_pass: 16 warps, at most 128 registers
constexpr int DTHREADS = 32 * DWARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;
// dbc_pass: a DR x DN output tile, its reduction staged DK steps at a time
// through DSTAGES stages; a group holds at most DBC_HPG heads
constexpr int DR = 128, DN = 128, DK = 32, DSTAGES = 3;
constexpr int DBC_HPG = 16;
constexpr int DLA = DK + 4;   // pitch of A staged [row][k] (floats)
constexpr int DLAT = DR + 8;  // pitch of A staged [k][row] (floats)
constexpr int DLB = DN + 8;   // pitch of the staged B operand [k][n]
constexpr int DA_BYTES = DR * DLA * 4;         // >= DK * DLAT * 4
constexpr int DB_BYTES = DK * DLB * 4;         // fp32, or bf16 in half
constexpr int DSTAGE_BYTES = DA_BYTES + DB_BYTES;

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// what bwd_plan decided (kernels/ssd_scan.py BwdPlan.args, in this order)
struct Plan {
  int bc, q, h, p, n;
  int t, tiles, hg, sg, ns, slots;
  int smem, off_b, off_ring, slot, off_dac, off_dec, off_red, dbc_smem;
};
constexpr int PLAN_INTS = sizeof(Plan) / sizeof(int);

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
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// 2^x in one MUFU operation; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float shfl_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
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

// ---------------------------------------------------------------- dx_pass

// Where a warp's work lies: key slices sa <= sb of the pair's key tile (16
// rows each; sa == sb: one slice), its query columns (8 queries) c = c0 +
// part + parts * i of each slice, its p-tiles (8 columns of P) part +
// parts * i.
struct Warp {
  int sa, sb, part, parts;
  bool two;  // sb != sa
};

// The split TF32 A operand of (S o L)^T dy for key slice s and query column
// c, and L itself: l[0..3] at (key g, query 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) of the fragment, from the queries' dacs (log2 units) q0,
// q1 and the keys' dk0, dk1. A masked pair weighs exactly 0 (a select).
__device__ __forceinline__ void decays(float q0, float q1, float dk0,
                                       float dk1, int kr, int qc, bool diag,
                                       float (&l)[4]) {
  l[0] = !diag || qc >= kr ? exp2_ftz(q0 - dk0) : 0.0f;
  l[1] = !diag || qc + 1 >= kr ? exp2_ftz(q1 - dk0) : 0.0f;
  l[2] = !diag || qc >= kr + 8 ? exp2_ftz(q0 - dk1) : 0.0f;
  l[3] = !diag || qc + 1 >= kr + 8 ? exp2_ftz(q1 - dk1) : 0.0f;
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 1)
dx_pass(const float* __restrict__ xdt, const float* __restrict__ dacs,
        const T* __restrict__ Bg, const T* __restrict__ Cg,
        const float* __restrict__ dy, const float* __restrict__ dst,
        float* __restrict__ dxout, float* __restrict__ ddacs,
        float* __restrict__ dsout, float* __restrict__ rpart,
        float* __restrict__ cpart, float* __restrict__ eu, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool BF = std::is_same_v<T, bf16>;
  constexpr int TMAX = P == 128 ? 64 : 128;  // the largest tile
  constexpr int RMAX = TMAX / 16;
  constexpr int PARTS_MIN = WARPS / (RMAX / 2);
  // query columns of sa and of sb a warp, at most (an off-diagonal pair
  // has tiles of 64 rows: 8 columns a slice)
  constexpr int NGA = cdiv(2 * RMAX, PARTS_MIN);
  constexpr int NGB = cmax(cdiv(RMAX, PARTS_MIN), cdiv(8, WARPS / 2));
  constexpr int NP8 = P / 8;
  constexpr int NPT = cdiv(NP8, PARTS_MIN);  // p-tiles a warp, at most
  constexpr int LDX = P + 4;  // xdt and dy rows in a slot (floats)
  constexpr int KSTEP = BF ? 16 : 8;
  const int Q = pl.q, H = pl.h, N = pl.n, TT = pl.t, R = TT / 16;
  const int KC = TT / 8;  // query columns of a tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  // block -> (chunk, pair, head group); BwdPlan.block_work mirrors this
  const int pairs = pl.tiles * (pl.tiles + 1) / 2;
  const int grp = (int)(blockIdx.x % pl.hg);
  const int pr = (int)((blockIdx.x / pl.hg) % pairs);
  const size_t bc = blockIdx.x / pl.hg / pairs;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pr) ++qt;
  const int kt = pr - qt * (qt + 1) / 2;
  const bool diag = qt == kt;
  const int i0 = qt * TT, k0 = kt * TT;  // first query row, first key row
  const int h_lo = (int)((long long)grp * H / pl.hg);
  const int h_hi = (int)((long long)(grp + 1) * H / pl.hg);

  float4* sf = reinterpret_cast<float4*>(smem);  // S^T fragments
  T* bs = reinterpret_cast<T*>(smem + pl.off_b);  // B rows of the key tile
  unsigned char* ring = smem + pl.off_ring;
  float* dac = reinterpret_cast<float*>(smem + pl.off_dac);  // [2][2T + 4]
  float* dec = reinterpret_cast<float*>(smem + pl.off_dec);  // [T]
  const int npairs = (R + 1) / 2, parts = WARPS / npairs;
  float* qsum = reinterpret_cast<float*>(smem + pl.off_red);  // [R][T]
  float* kpart = qsum + R * TT;                                // [parts][T]
  float* upart = kpart + parts * TT;                           // [parts][T]
  float* euv = upart + parts * TT;                             // [T]

  const int NS = pl.ns;
  const int LDB = BF ? NS + 8 : NS + 4;  // B rows (elements)
  const int LDD = NS + 4;                // dstates rows (floats)
  const int nslab = (N + NS - 1) / NS;
  auto slab_w = [&](int sl) {  // staged columns of slab sl
    const int c = min(NS, N - sl * NS);
    return (c + KSTEP - 1) / KSTEP * KSTEP;
  };
  const T* Bb = Bg + bc * Q * N;
  const T* Cb = Cg + bc * Q * N;
  const bool bc_vec = (N * (int)sizeof(T)) % 16 == 0 && aligned16(Bg) &&
                      aligned16(Cg);
  const bool x_vec = aligned16(xdt), y_vec = aligned16(dy);
  const bool d_vec = N % 4 == 0 && aligned16(dst);

  // S^T fragment (s, c): key slice s, query column c (lower-triangular
  // ones only on the diagonal: c >= 2s)
  auto tile_of = [&](int s, int c) {
    return diag ? s * 2 * R - s * (s - 1) + c - 2 * s : s * 2 * R + c;
  };

  // ---- S^T = B C^T of the pair, once for all heads of the block
  {
    T* cst = reinterpret_cast<T*>(ring);  // C rows of the query tile
    const int cw0 = warp, cw1 = KC - 1 - warp;  // this warp's columns
    const bool has0 = cw0 < KC, has1 = cw1 >= WARPS;
    float acc[2][RMAX][4];
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int s = 0; s < RMAX; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ci][s][e] = 0.0f;
    for (int sl = 0; sl < nslab; ++sl) {
      const int col0 = sl * NS, w = slab_w(sl);
      __syncthreads();  // the last slab's readers are done
      stage<T>(bs, LDB, Bb, N, k0, TT, Q, col0, w, N, bc_vec, tid, THREADS);
      stage<T>(cst, LDB, Cb, N, i0, TT, Q, col0, w, N, bc_vec, tid, THREADS);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int kk = 0; kk < w; kk += KSTEP) {
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          const int c = ci ? cw1 : cw0;
          if (!(ci ? has1 : has0)) continue;
          if constexpr (BF) {
            unsigned b[2];
            ldsm_x2(b, cst + (8 * c + (lane & 7)) * LDB + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int s = 0; s < RMAX; ++s) {
              if (s < R && (!diag || c >= 2 * s)) {
                unsigned a[4];
                ldsm_x4(a, bs + (16 * s + (lane & 15)) * LDB + kk +
                               (lane >> 4) * 8);
                mma_bf16(acc[ci][s], a, b[0], b[1]);
              }
            }
          } else {
            const float* cr = cst + (8 * c + g) * LDB + kk + t4;
            unsigned bh0, bl0, bh1, bl1;
            split(cr[0], bh0, bl0);
            split(cr[4], bh1, bl1);
#pragma unroll
            for (int s = 0; s < RMAX; ++s) {
              if (s < R && (!diag || c >= 2 * s)) {
                const float* br = bs + (16 * s + g) * LDB + kk + t4;
                unsigned ah[4], al[4];
                split(br[0], ah[0], al[0]);
                split(br[8 * LDB], ah[1], al[1]);
                split(br[4], ah[2], al[2]);
                split(br[8 * LDB + 4], ah[3], al[3]);
                mma3(acc[ci][s], ah, al, bh0, bh1, bl0, bl1);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = ci ? cw1 : cw0;
      if (!(ci ? has1 : has0)) continue;
#pragma unroll
      for (int s = 0; s < RMAX; ++s)
        if (s < R && (!diag || c >= 2 * s))
          sf[tile_of(s, c) * 32 + lane] = make_float4(
              acc[ci][s][0], acc[ci][s][1], acc[ci][s][2], acc[ci][s][3]);
    }
  }
  __syncthreads();  // S^T written; the ring is free

  // ---- per head: operands 3 hl (dstates, dacs), 3 hl + 1 (xdt of the key
  // tile), 3 hl + 2 (dy of the query tile), operand j in ring slot j % slots
  const int nh = h_hi - h_lo, nops = 3 * nh;
  auto slot_of = [&](int op) {
    return reinterpret_cast<float*>(ring + (size_t)(op % pl.slots) * pl.slot);
  };
  const size_t row = (size_t)H * P;  // a row of xdt or dy
  const float* xb = xdt + bc * Q * row;
  const float* yb = dy + bc * Q * row;
  const float* db = dacs + bc * Q * H;
  const int dacn = 2 * TT + 4;
  auto issue = [&](int op) {
    if (op >= nops) return;
    const int hl = op / 3, kind = op % 3, hd = h_lo + hl;
    float* to = slot_of(op);
    if (kind == 0) {
      if (diag)
        stage<float>(to, LDD, dst + (bc * H + hd) * (size_t)P * N, N, 0, P,
                     P, 0, slab_w(0), N, d_vec, tid, THREADS);
      // the tile's queries, its keys and the chunk's last row; padded rows
      // take the last row's dacs
      float* dd = dac + (hl & 1) * dacn;
      for (int e = tid; e <= 2 * TT; e += THREADS) {
        const int r = e < TT ? i0 + e : e < 2 * TT ? k0 + e - TT : Q - 1;
        cp_async4(dd + e, db + (size_t)min(r, Q - 1) * H + hd, true);
      }
    } else {
      stage<float>(to, LDX, (kind == 1 ? xb : yb) + (size_t)hd * P, row,
                   kind == 1 ? k0 : i0, TT, Q, 0, P, P,
                   kind == 1 ? x_vec : y_vec, tid, THREADS);
    }
  };
  for (int op = 0; op < pl.slots; ++op) {
    issue(op);
    cp_async_commit();
  }

  const Warp wk{warp % npairs, R - 1 - warp % npairs, warp / npairs, parts,
                warp % npairs != R - 1 - warp % npairs};
  const bool active = wk.part < parts;
  const int ca = diag ? 2 * wk.sa : 0, cb = diag ? 2 * wk.sb : 0;
  // the group's share of dS^T in the fragments of the warp's columns
  float dsa[NGA][4], dsb[NGB][4];
#pragma unroll
  for (int i = 0; i < NGA; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsa[i][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < NGB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dsb[i][e] = 0.0f;

  for (int hl = 0; hl < nh; ++hl) {
    const int hd = h_lo + hl;
    const float* dq = dac + (hl & 1) * dacn;  // the query tile's dacs
    const float* dk = dq + TT;                // the key tile's
    float* dsl = slot_of(3 * hl);
    const float* xs = slot_of(3 * hl + 1);
    const float* ys = slot_of(3 * hl + 2);

    // dstates and dacs have landed
    if (pl.slots == 4)
      cp_async_wait<3>();
    else
      cp_async_wait<2>();
    __syncthreads();
    if (diag && tid < TT) dec[tid] = exp2_ftz((dq[2 * TT] - dk[tid]) * LOG2E);

    // dxdt tiles (key slice sa or sb, the warp's p-tiles): W first
    float acc[2][NPT][4];
#pragma unroll
    for (int si = 0; si < 2; ++si)
#pragma unroll
      for (int i = 0; i < NPT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[si][i][e] = 0.0f;
    if (diag) {
      for (int sl = 0; sl < nslab; ++sl) {
        if (nslab > 1) {  // B's rows and dstates, slab by slab
          __syncthreads();  // the last slab's readers are done
          stage<T>(bs, LDB, Bb, N, k0, TT, Q, sl * NS, slab_w(sl), N, bc_vec,
                   tid, THREADS);
          if (sl > 0)
            stage<float>(dsl, LDD, dst + (bc * H + hd) * (size_t)P * N, N, 0,
                         P, P, sl * NS, slab_w(sl), N, d_vec, tid, THREADS);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        if (!active) continue;
        // W += B dstates^T: A = B's rows (exact in TF32 when bf16)
        for (int n0 = 0; n0 < slab_w(sl); n0 += 8) {
          unsigned ah[2][4], al[2][4];
#pragma unroll
          for (int si = 0; si < 2; ++si) {
            const T* br = bs + (16 * (si ? wk.sb : wk.sa) + g) * LDB + n0 + t4;
            const float v[4] = {to_f32(br[0]), to_f32(br[8 * LDB]),
                                to_f32(br[4]), to_f32(br[8 * LDB + 4])};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (BF) {
                ah[si][e] = __float_as_uint(v[e]);
                al[si][e] = 0u;
              } else {
                split(v[e], ah[si][e], al[si][e]);
              }
            }
          }
          unsigned bh[NPT][2], bl[NPT][2];
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const int pt = min(wk.part + parts * i, NP8 - 1);
            const float* dr = dsl + (8 * pt + g) * LDD + n0 + t4;
            split(dr[0], bh[i][0], bl[i][0]);
            split(dr[4], bh[i][1], bl[i][1]);
          }
          if constexpr (!BF) {
#pragma unroll
            for (int i = 0; i < NPT; ++i)
#pragma unroll
              for (int si = 0; si < 2; ++si)
                if (wk.part + parts * i < NP8 && (si == 0 || wk.two))
                  mma_tf32(acc[si][i], al[si], bh[i][0], bh[i][1]);
          }
#pragma unroll
          for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int si = 0; si < 2; ++si)
              if (wk.part + parts * i < NP8 && (si == 0 || wk.two))
                mma_tf32(acc[si][i], ah[si], bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int si = 0; si < 2; ++si)
              if (wk.part + parts * i < NP8 && (si == 0 || wk.two))
                mma_tf32(acc[si][i], ah[si], bh[i][0], bh[i][1]);
        }
      }
    }

    // xdt and dy have landed; the dstates slot is free for the next head
    if (pl.slots == 4)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    issue(3 * hl + pl.slots);
    cp_async_commit();

    if (active) {
      // u = rowsum(xdt o W), then the dxdt tiles start from e o W
      if (diag) {
#pragma unroll
        for (int si = 0; si < 2; ++si) {
          if (si == 1 && !wk.two) continue;
          const int kr = 16 * (si ? wk.sb : wk.sa) + g;
          const float e0 = dec[kr], e1 = dec[kr + 8];
          float u0 = 0.0f, u1 = 0.0f;
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const int pt = wk.part + parts * i;
            if (pt >= NP8) continue;
            const float2 x0 = *reinterpret_cast<const float2*>(
                xs + kr * LDX + 8 * pt + 2 * t4);
            const float2 x1 = *reinterpret_cast<const float2*>(
                xs + (kr + 8) * LDX + 8 * pt + 2 * t4);
            u0 += x0.x * acc[si][i][0] + x0.y * acc[si][i][1];
            u1 += x1.x * acc[si][i][2] + x1.y * acc[si][i][3];
            acc[si][i][0] *= e0;
            acc[si][i][1] *= e0;
            acc[si][i][2] *= e1;
            acc[si][i][3] *= e1;
          }
          u0 += shfl_xor(u0, 1);
          u0 += shfl_xor(u0, 2);
          u1 += shfl_xor(u1, 1);
          u1 += shfl_xor(u1, 2);
          if (t4 == 0) {
            upart[wk.part * TT + kr] = u0;
            upart[wk.part * TT + kr + 8] = u1;
          }
        }
      }

      // ---- G^T = xdt dy^T, one key slice at a time; then R's sums and
      // the group's dS^T
      auto g_slice = [&](auto& ds, int s, int c0) {
        constexpr int NG =
            std::extent_v<std::remove_reference_t<decltype(ds)>>;
        const int kr = 16 * s + g;
        const float dk0 = dk[kr] * LOG2E, dk1 = dk[kr + 8] * LOG2E;
        float gacc[NG][4];
#pragma unroll
        for (int i = 0; i < NG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[i][e] = 0.0f;
        for (int p0 = 0; p0 < P; p0 += 8) {
          const float* xr = xs + kr * LDX + p0 + t4;
          unsigned ah[4], al[4];
          split(xr[0], ah[0], al[0]);
          split(xr[8 * LDX], ah[1], al[1]);
          split(xr[4], ah[2], al[2]);
          split(xr[8 * LDX + 4], ah[3], al[3]);
          unsigned bh[NG][2], bl[NG][2];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const int c = min(c0 + wk.part + parts * i, KC - 1);
            const float* yr = ys + (8 * c + g) * LDX + p0 + t4;
            split(yr[0], bh[i][0], bl[i][0]);
            split(yr[4], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < NG; ++i)
            if (c0 + wk.part + parts * i < KC)
              mma_tf32(gacc[i], al, bh[i][0], bh[i][1]);
#pragma unroll
          for (int i = 0; i < NG; ++i)
            if (c0 + wk.part + parts * i < KC)
              mma_tf32(gacc[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < NG; ++i)
            if (c0 + wk.part + parts * i < KC)
              mma_tf32(gacc[i], ah, bh[i][0], bh[i][1]);
        }
        float ks0 = 0.0f, ks1 = 0.0f;  // R's sums over queries, keys kr, kr + 8
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          const int c = c0 + wk.part + parts * i;
          if (c >= KC) continue;
          const float4 sv = sf[tile_of(s, c) * 32 + lane];
          const int qc = 8 * c + 2 * t4;
          const float2 dv = *reinterpret_cast<const float2*>(dq + qc);
          float l[4];
          decays(dv.x * LOG2E, dv.y * LOG2E, dk0, dk1, kr, qc, diag, l);
          const float x0 = gacc[i][0] * l[0], x1 = gacc[i][1] * l[1];
          const float x2 = gacc[i][2] * l[2], x3 = gacc[i][3] * l[3];
          ds[i][0] += x0;
          ds[i][1] += x1;
          ds[i][2] += x2;
          ds[i][3] += x3;
          const float r0 = x0 * sv.x, r1 = x1 * sv.y;
          const float r2 = x2 * sv.z, r3 = x3 * sv.w;
          ks0 += r0 + r1;
          ks1 += r2 + r3;
          float qs0 = r0 + r2, qs1 = r1 + r3;  // over keys, queries qc, qc + 1
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            qs0 += shfl_xor(qs0, m);
            qs1 += shfl_xor(qs1, m);
          }
          if (g == 0) {
            qsum[s * TT + qc] = qs0;
            qsum[s * TT + qc + 1] = qs1;
          }
        }
        ks0 += shfl_xor(ks0, 1);
        ks0 += shfl_xor(ks0, 2);
        ks1 += shfl_xor(ks1, 1);
        ks1 += shfl_xor(ks1, 2);
        if (t4 == 0) {
          kpart[wk.part * TT + kr] = ks0;
          kpart[wk.part * TT + kr + 8] = ks1;
        }
      };
      g_slice(dsa, wk.sa, ca);
      if (wk.two) g_slice(dsb, wk.sb, cb);
    }

    // every reader of xdt is done: its slot takes the next head's dy
    __syncthreads();
    issue(3 * hl + 1 + pl.slots);
    cp_async_commit();

    if (active) {

      // ---- dxdt += (S o L)^T dy over the query columns, both slices at once
      {
        const int kra = 16 * wk.sa + g, krb = 16 * wk.sb + g;
        const float dka0 = dk[kra] * LOG2E, dka1 = dk[kra + 8] * LOG2E;
        const float dkb0 = dk[krb] * LOG2E, dkb1 = dk[krb + 8] * LOG2E;
        for (int c = ca; c < KC; ++c) {
          const bool hb = wk.two && c >= cb;
          const int qc = 8 * c + 2 * t4;
          const float2 dv = *reinterpret_cast<const float2*>(dq + qc);
          const float q0 = dv.x * LOG2E, q1 = dv.y * LOG2E;
          unsigned ah[2][4], al[2][4];
#pragma unroll
          for (int si = 0; si < 2; ++si) {
            if (si == 1 && !hb) {
#pragma unroll
              for (int e = 0; e < 4; ++e) ah[1][e] = al[1][e] = 0u;
              continue;
            }
            const int s = si ? wk.sb : wk.sa, kr = si ? krb : kra;
            const float4 sv = sf[tile_of(s, c) * 32 + lane];
            float l[4];
            decays(q0, q1, si ? dkb0 : dka0, si ? dkb1 : dka1, kr, qc, diag,
                   l);
            // k = t is query 2t, k = t + 4 query 2t + 1
            split(sv.x * l[0], ah[si][0], al[si][0]);
            split(sv.z * l[2], ah[si][1], al[si][1]);
            split(sv.y * l[1], ah[si][2], al[si][2]);
            split(sv.w * l[3], ah[si][3], al[si][3]);
          }
          unsigned bh[NPT][2], bl[NPT][2];
#pragma unroll
          for (int i = 0; i < NPT; ++i) {
            const int pt = min(wk.part + parts * i, NP8 - 1);
            const float* yr = ys + qc * LDX + 8 * pt + g;
            split(yr[0], bh[i][0], bl[i][0]);
            split(yr[LDX], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int si = 0; si < 2; ++si)
              if (wk.part + parts * i < NP8 && (si == 0 || hb))
                mma_tf32(acc[si][i], al[si], bh[i][0], bh[i][1]);
#pragma unroll
          for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int si = 0; si < 2; ++si)
              if (wk.part + parts * i < NP8 && (si == 0 || hb))
                mma_tf32(acc[si][i], ah[si], bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < NPT; ++i)
#pragma unroll
            for (int si = 0; si < 2; ++si)
              if (wk.part + parts * i < NP8 && (si == 0 || hb))
                mma_tf32(acc[si][i], ah[si], bh[i][0], bh[i][1]);
        }
      }

      // ---- dxdt (or this query tile's share of it)
      float* out = dxout + (pl.tiles > 1 ? (size_t)qt * pl.bc * Q * row : 0);
#pragma unroll
      for (int si = 0; si < 2; ++si) {
        if (si == 1 && !wk.two) continue;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int pt = wk.part + parts * i;
          if (pt >= NP8) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int k = k0 + 16 * (si ? wk.sb : wk.sa) + g + 8 * half;
            if (k >= Q) continue;
            *reinterpret_cast<float2*>(out + (bc * Q + k) * row +
                                       (size_t)hd * P + 8 * pt + 2 * t4) =
                make_float2(acc[si][i][2 * half], acc[si][i][2 * half + 1]);
          }
        }
      }
    }

    // every reader of dy is done; R's and u's partial sums are in
    __syncthreads();
    issue(3 * hl + 2 + pl.slots);
    cp_async_commit();

    // ---- the head's ddacs (one tile), or the tiles' partial sums
    const size_t hbase = bc * H + hd;
    if (pl.tiles == 1) {  // rows are the queries and the keys
      float v = 0.0f;
      if (tid < TT) {
        for (int s = 0; s <= min(R - 1, tid / 16); ++s) v += qsum[s * TT + tid];
        float u = 0.0f;
        for (int pp = 0; pp < parts; ++pp) {
          v -= kpart[pp * TT + tid];
          u += upart[pp * TT + tid];
        }
        euv[tid] = dec[tid] * u;
        v -= euv[tid];
      }
      __syncthreads();
      if (warp == (Q - 1) / 32) {  // sum_k e[k] u[k], in a fixed order
        float s = 0.0f;
        for (int k = lane; k < Q; k += 32) s += euv[k];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) s += shfl_xor(s, m);
        if (tid == Q - 1) v += s;
      }
      if (tid < Q) ddacs[(bc * Q + tid) * H + hd] = v;
    } else if (tid < TT) {  // query row i0 + tid: R summed over the key tile
      float v = 0.0f;
      const int smax = diag ? min(R - 1, tid / 16) : R - 1;
      for (int s = 0; s <= smax; ++s) v += qsum[s * TT + tid];
      if (i0 + tid < Q) rpart[(hbase * pl.tiles + kt) * Q + i0 + tid] = v;
    } else if (tid < 2 * TT) {  // key row k0 + x: over the query tile
      const int x = tid - TT;
      float v = 0.0f, u = 0.0f;
      for (int pp = 0; pp < parts; ++pp) {
        v += kpart[pp * TT + x];
        u += upart[pp * TT + x];
      }
      if (k0 + x < Q) {
        cpart[(hbase * pl.tiles + qt) * Q + k0 + x] = v;
        if (diag) eu[hbase * Q + k0 + x] = dec[x] * u;
      }
    }
  }

  // ---- the group's share of dS (rows of the query tile, keys of the key
  // tile); fragments above the diagonal are never formed
  float* dsg = dsout + (pl.hg > 1 ? (size_t)grp * pl.bc * Q * Q : 0);
  auto ds_store = [&](const auto& ds, int s, int c0) {
    constexpr int NG =
        std::extent_v<std::remove_reference_t<decltype(ds)>>;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = c0 + wk.part + parts * i;
      if (c >= KC) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + 16 * s + g + 8 * (e / 2);
        const int q = i0 + 8 * c + 2 * t4 + e % 2;
        if (q < Q && k < Q) dsg[(bc * Q + q) * Q + k] = ds[i][e];
      }
    }
  };
  if (active) {
    ds_store(dsa, wk.sa, ca);
    if (wk.two) ds_store(dsb, wk.sb, cb);
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

// --------------------------------------------------------------- dbc_pass

// A DR x DN tile of A B, the reduction over [k_lo, k_hi) in steps of DK
// through a DSTAGES-stage cp.async ring. MODE 0: the states' share of dB,
// A[r][k] = e_{k / P}[r] xdt[r][k] (k = h P + p), B = dstates; MODE 1: dC,
// A = dS (k <= r), B = B; MODE 2: dS^T C, A[r][k] = dS[k][r] (k >= r), B =
// C. Rows are the chunk's rows from r0, columns its state columns from n0.
template <int MODE, typename TB>
__device__ __forceinline__ void dbc_tile(
    float (&acc)[2][4][4], unsigned char* smem, const float* A, size_t lda,
    const TB* Bm, int k_lo, int k_hi, int r0, int n0, const Plan& pl,
    const float* etab, int h_lo, int nh, bool a_vec, bool b_vec) {
  constexpr bool BEXACT = std::is_same_v<TB, bf16>;
  const int Q = pl.q, N = pl.n, P = pl.p;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 32 * (warp % 4), nn0 = 32 * (warp / 4);  // the warp's tile
  const int ncols = min(DN, N - n0), wn = (ncols + 7) / 8 * 8;
  auto a_at = [&](int st_) {
    return reinterpret_cast<float*>(smem + (size_t)st_ * DSTAGE_BYTES);
  };
  auto b_at = [&](int st_) {
    return reinterpret_cast<TB*>(smem + (size_t)st_ * DSTAGE_BYTES +
                                 DA_BYTES);
  };
  const int nk = (k_hi - k_lo + DK - 1) / DK;
  auto issue = [&](int i) {
    if (i >= nk) return;
    const int kc = k_lo + i * DK;
    if constexpr (MODE == 2)  // dS rows kc.., columns r0..: A[k][r]
      stage<float>(a_at(i % DSTAGES), DLAT, A, lda, kc, DK, k_hi, r0, DR, Q,
                   a_vec, tid, DTHREADS);
    else
      stage<float>(a_at(i % DSTAGES), DLA, A, lda, r0, DR, Q, kc, DK, k_hi,
                   a_vec, tid, DTHREADS);
    stage<TB>(b_at(i % DSTAGES), DLB, Bm, N, kc, DK, k_hi, n0, wn, N, b_vec,
              tid, DTHREADS);
  };
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][i][e] = 0.0f;
  bool slice_on[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) slice_on[s] = r0 + m0 + 16 * s < Q;
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<1>();
    __syncthreads();  // chunk i has landed; chunk i - 1's readers are done
    issue(i + 2);
    cp_async_commit();
    const float* As = a_at(i % DSTAGES);
    const TB* Bs = b_at(i % DSTAGES);
    const int kc = k_lo + i * DK;
    for (int kk = 0; kk < DK; kk += 8) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int m = m0 + 16 * s;
        float v[4];  // rows m + g, m + g + 8 at k = kk + t, kk + t + 4
        if constexpr (MODE == 2) {
          v[0] = As[(kk + t4) * DLAT + m + g];
          v[1] = As[(kk + t4) * DLAT + m + g + 8];
          v[2] = As[(kk + t4 + 4) * DLAT + m + g];
          v[3] = As[(kk + t4 + 4) * DLAT + m + g + 8];
        } else {
          v[0] = As[(m + g) * DLA + kk + t4];
          v[1] = As[(m + g + 8) * DLA + kk + t4];
          v[2] = As[(m + g) * DLA + kk + t4 + 4];
          v[3] = As[(m + g + 8) * DLA + kk + t4 + 4];
        }
        const int k = kc + kk + t4, r = r0 + m + g;
        if constexpr (MODE == 0) {  // the rows' decays of head k / P
          const float* er = etab + min(k / P - h_lo, nh - 1) * DR + m + g;
          v[0] *= er[0];
          v[1] *= er[8];
          v[2] *= er[0];
          v[3] *= er[8];
        } else if constexpr (MODE == 1) {  // dS[r][k], k <= r
          v[0] = k <= r ? v[0] : 0.0f;
          v[1] = k <= r + 8 ? v[1] : 0.0f;
          v[2] = k + 4 <= r ? v[2] : 0.0f;
          v[3] = k + 4 <= r + 8 ? v[3] : 0.0f;
        } else {  // dS[k][r], k >= r
          v[0] = k >= r ? v[0] : 0.0f;
          v[1] = k >= r + 8 ? v[1] : 0.0f;
          v[2] = k + 4 >= r ? v[2] : 0.0f;
          v[3] = k + 4 >= r + 8 ? v[3] : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ah[s][e], al[s][e]);
      }
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const TB* br = Bs + (kk + t4) * DLB + nn0 + 8 * j + g;
        const float b0 = to_f32(br[0]), b1 = to_f32(br[4 * DLB]);
        if constexpr (BEXACT) {
          bh[j][0] = __float_as_uint(b0);
          bh[j][1] = __float_as_uint(b1);
        } else {
          split(b0, bh[j][0], bl[j][0]);
          split(b1, bh[j][1], bl[j][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (slice_on[s] && nn0 + 8 * j < wn)
            mma_tf32(acc[s][j], al[s], bh[j][0], bh[j][1]);
      if constexpr (!BEXACT) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int s = 0; s < 2; ++s)
            if (slice_on[s] && nn0 + 8 * j < wn)
              mma_tf32(acc[s][j], ah[s], bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int s = 0; s < 2; ++s)
          if (slice_on[s] && nn0 + 8 * j < wn)
            mma_tf32(acc[s][j], ah[s], bh[j][0], bh[j][1]);
    }
  }
}

// a DR x DN tile (rows from r0, columns from n0) of a (BC, Q, N) output
template <typename TO>
__device__ __forceinline__ void dbc_store(const float (&acc)[2][4][4], TO* out,
                                          int r0, int n0, const Plan& pl) {
  const int Q = pl.q, N = pl.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 32 * (warp % 4), nn0 = 32 * (warp / 4);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + m0 + 16 * s + g + 8 * half;
      if (r >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + nn0 + 8 * j + 2 * t4;
        if (n < N) st(out + (size_t)r * N + n, acc[s][j][2 * half]);
        if (n + 1 < N) st(out + (size_t)r * N + n + 1, acc[s][j][2 * half + 1]);
      }
    }
}

// block (group z, chunk, row tile, column tile): z < sg the states' share of
// dB of the group's heads, z == sg dC, z == sg + 1 dS^T C
template <typename T>
__global__ void __launch_bounds__(DTHREADS, 1)
dbc_pass(const float* __restrict__ xdt, const float* __restrict__ dacs,
         const T* __restrict__ Bg, const T* __restrict__ Cg,
         const float* __restrict__ dst, const float* __restrict__ dS,
         float* __restrict__ dBpart, T* __restrict__ dC, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = pl.q, H = pl.h, P = pl.p, N = pl.n;
  const int nrt = (Q + DR - 1) / DR, nct = (N + DN - 1) / DN;
  size_t rem = blockIdx.x;
  const int ct = (int)(rem % nct);
  rem /= nct;
  const int rt = (int)(rem % nrt);
  rem /= nrt;
  const size_t bc = rem % pl.bc;
  const int z = (int)(rem / pl.bc);
  const int r0 = rt * DR, n0 = ct * DN;
  const size_t plane = (size_t)pl.bc * Q * N;
  const bool bc_vec = (N * (int)sizeof(T)) % 16 == 0 && aligned16(Bg) &&
                      aligned16(Cg);
  float acc[2][4][4];
  if (z < pl.sg) {
    const int h_lo = (int)((long long)z * H / pl.sg);
    const int h_hi = (int)((long long)(z + 1) * H / pl.sg);
    // the decays of the tile's rows to the chunk's end, per head
    float* etab = reinterpret_cast<float*>(smem + DSTAGES * DSTAGE_BYTES);
    const float* db = dacs + bc * Q * H;
    for (int e = threadIdx.x; e < (h_hi - h_lo) * DR; e += DTHREADS) {
      const int hd = h_lo + e / DR, r = r0 + e % DR;
      etab[e] = r < Q ? exp2_ftz((db[(size_t)(Q - 1) * H + hd] -
                                  db[(size_t)r * H + hd]) * LOG2E)
                      : 0.0f;
    }
    // (the first barrier of the reduction orders the table)
    dbc_tile<0, float>(acc, smem, xdt + bc * Q * H * P, (size_t)H * P,
                       dst + bc * H * P * N, h_lo * P, h_hi * P, r0, n0, pl,
                       etab, h_lo, h_hi - h_lo, aligned16(xdt),
                       N % 4 == 0 && aligned16(dst));
    dbc_store(acc, dBpart + (size_t)z * plane + bc * Q * N, r0, n0, pl);
  } else if (z == pl.sg) {
    dbc_tile<1, T>(acc, smem, dS + bc * Q * Q, Q, Bg + bc * Q * N, 0,
                   min(Q, r0 + DR), r0, n0, pl, nullptr, 0, 1, Q % 4 == 0,
                   bc_vec);
    dbc_store(acc, dC + bc * Q * N, r0, n0, pl);
  } else {
    dbc_tile<2, T>(acc, smem, dS + bc * Q * Q, Q, Cg + bc * Q * N, r0, Q,
                   r0, n0, pl, nullptr, 0, 1, Q % 4 == 0, bc_vec);
    dbc_store(acc, dBpart + (size_t)pl.sg * plane + bc * Q * N, r0, n0, pl);
  }
}

// ------------------------------------------- chunks above one tile only

// dxdt = the query tiles' shares, in tile order (from the key's own tile)
__global__ void dxdt_sum_pass(const float* __restrict__ parts,
                              float* __restrict__ dxdt, size_t total,
                              const Plan pl) {
  const size_t row = (size_t)pl.h * pl.p;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)((e / row) % pl.q);
    float v = 0.0f;
    for (int qt = k / pl.t; qt < pl.tiles; ++qt) v += parts[qt * total + e];
    dxdt[e] = v;
  }
}

// a thread per (chunk, row, head): R's partial sums in tile order, minus
// e o u, plus sum e o u at the last row
__global__ void ddacs_pass(const float* __restrict__ rpart,
                           const float* __restrict__ cpart,
                           const float* __restrict__ eu,
                           float* __restrict__ ddacs, size_t total,
                           const Plan pl) {
  const int Q = pl.q, H = pl.h;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int h = (int)(e % H);
    const int t = (int)((e / H) % Q);
    const size_t bc = e / ((size_t)H * Q);
    const size_t hb = (bc * H + h) * pl.tiles;
    const int tt = t / pl.t;
    float v = 0.0f;
    for (int kt = 0; kt <= tt; ++kt) v += rpart[(hb + kt) * Q + t];
    for (int qt = tt; qt < pl.tiles; ++qt) v -= cpart[(hb + qt) * Q + t];
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

unsigned grid_of(size_t total) {
  const size_t b = (total + 255) / 256;
  return (unsigned)(b < 65536 ? b : 65536);
}

template <typename T, int P>
cudaError_t configure() {
  static bool configured = false;  // the attributes are set once per kernel
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dx_pass<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        dbc_pass<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

struct Buffers {
  const void *xdt, *dacs, *B, *C, *dy, *dst;
  void *dxdt, *ddacs, *dB, *dC, *dS, *dSpart, *dBpart, *rpart, *cpart, *eu,
      *dxpart;
};

template <typename T, int P>
int launch_p(const Buffers& b, const Plan& pl, void* stream) {
  cudaError_t err = configure<T, P>();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = pl.tiles * (pl.tiles + 1) / 2;
  const long long blocks = (long long)pl.bc * pairs * pl.hg;
  const int nrt = (pl.q + DR - 1) / DR, nct = (pl.n + DN - 1) / DN;
  const long long dbc_blocks = (long long)(pl.sg + 2) * pl.bc * nrt * nct;
  if (blocks > INT_MAX || dbc_blocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const float* x = static_cast<const float*>(b.xdt);
  const float* a = static_cast<const float*>(b.dacs);
  const T* Bt = static_cast<const T*>(b.B);
  const T* Ct = static_cast<const T*>(b.C);
  float* dS = static_cast<float*>(b.dS);
  dx_pass<T, P><<<(unsigned)blocks, THREADS, pl.smem, s>>>(
      x, a, Bt, Ct, static_cast<const float*>(b.dy),
      static_cast<const float*>(b.dst),
      static_cast<float*>(pl.tiles > 1 ? b.dxpart : b.dxdt),
      static_cast<float*>(b.ddacs),
      pl.hg > 1 ? static_cast<float*>(b.dSpart) : dS,
      static_cast<float*>(b.rpart), static_cast<float*>(b.cpart),
      static_cast<float*>(b.eu), pl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t ds_total = (size_t)pl.bc * pl.q * pl.q;
  if (pl.hg > 1) {
    sum_parts<float><<<grid_of(ds_total), 256, 0, s>>>(
        static_cast<const float*>(b.dSpart), pl.hg, ds_total, dS);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  dbc_pass<T><<<(unsigned)dbc_blocks, DTHREADS, pl.dbc_smem, s>>>(
      x, a, Bt, Ct, static_cast<const float*>(b.dst), dS,
      static_cast<float*>(b.dBpart), static_cast<T*>(b.dC), pl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t db_total = (size_t)pl.bc * pl.q * pl.n;
  sum_parts<T><<<grid_of(db_total), 256, 0, s>>>(
      static_cast<const float*>(b.dBpart), pl.sg + 1, db_total,
      static_cast<T*>(b.dB));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (pl.tiles > 1) {
    const size_t dx_total = (size_t)pl.bc * pl.q * pl.h * P;
    dxdt_sum_pass<<<grid_of(dx_total), 256, 0, s>>>(
        static_cast<const float*>(b.dxpart), static_cast<float*>(b.dxdt),
        dx_total, pl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t total = (size_t)pl.bc * pl.q * pl.h;
    ddacs_pass<<<grid_of(total), 256, 0, s>>>(
        static_cast<const float*>(b.rpart), static_cast<const float*>(b.cpart),
        static_cast<const float*>(b.eu), static_cast<float*>(b.ddacs), total,
        pl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch(const Buffers& b, const int* plan, int nplan, void* stream) {
  if (plan == nullptr || nplan != PLAN_INTS) return (int)cudaErrorInvalidValue;
  Plan pl;
  int* f = reinterpret_cast<int*>(&pl);
  for (int i = 0; i < PLAN_INTS; ++i) f[i] = plan[i];
  constexpr int kstep = std::is_same_v<T, bf16> ? 16 : 8;
  const int tmax = pl.p == 128 ? 64 : 128;
  const bool ok =
      pl.bc > 0 && pl.q > 0 && pl.h > 0 && pl.n > 0 && pl.t > 0 &&
      pl.t % 16 == 0 && pl.t <= tmax && pl.tiles > 0 &&
      (long long)pl.t * pl.tiles >= pl.q &&
      (long long)pl.t * (pl.tiles - 1) < pl.q && pl.hg > 0 && pl.hg <= pl.h &&
      pl.sg > 0 && pl.sg <= pl.h && (pl.h + pl.sg - 1) / pl.sg <= DBC_HPG &&
      pl.ns > 0 && pl.ns % kstep == 0 && (pl.slots == 3 || pl.slots == 4) &&
      pl.smem > 0 && pl.smem <= MAX_SMEM && pl.dbc_smem > 0 &&
      pl.dbc_smem <= MAX_SMEM &&
      (pl.hg == 1 || b.dSpart != nullptr) &&
      (pl.tiles == 1 || (b.dxpart != nullptr && b.rpart != nullptr &&
                         b.cpart != nullptr && b.eu != nullptr));
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (pl.p) {
    case 16:
      return launch_p<T, 16>(b, pl, stream);
    case 32:
      return launch_p<T, 32>(b, pl, stream);
    case 64:
      return launch_p<T, 64>(b, pl, stream);
    case 128:
      return launch_p<T, 128>(b, pl, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Workspaces (fp32, allocated by the caller, aliasing nothing): dS (BC, Q,
// Q); dSpart (hg, BC, Q, Q) when hg > 1; dBpart (sg + 1, BC, Q, N); when
// the chunk takes more than one tile, dxpart (tiles, BC, Q, H, P), rpart
// and cpart (BC, H, tiles, Q) and eu (BC, H, Q) (else they may be null).
// plan holds kernels/ssd_scan.py BwdPlan.args(): nplan ints. Returns the
// first launch error of the passes as a cudaError_t.
extern "C" int ssd_intra_chunk_bwd_f32(
    const void* xdt, const void* dacs, const void* B, const void* C,
    const void* dy, const void* dst, void* dxdt, void* ddacs, void* dB,
    void* dC, void* dS, void* dSpart, void* dBpart, void* rpart, void* cpart,
    void* eu, void* dxpart, const int* plan, int nplan, void* stream) {
  return launch<float>(Buffers{xdt, dacs, B, C, dy, dst, dxdt, ddacs, dB, dC,
                               dS, dSpart, dBpart, rpart, cpart, eu, dxpart},
                       plan, nplan, stream);
}

extern "C" int ssd_intra_chunk_bwd_bf16(
    const void* xdt, const void* dacs, const void* B, const void* C,
    const void* dy, const void* dst, void* dxdt, void* ddacs, void* dB,
    void* dC, void* dS, void* dSpart, void* dBpart, void* rpart, void* cpart,
    void* eu, void* dxpart, const int* plan, int nplan, void* stream) {
  return launch<bf16>(Buffers{xdt, dacs, B, C, dy, dst, dxdt, ddacs, dB, dC,
                              dS, dSpart, dBpart, rpart, cpart, eu, dxpart},
                      plan, nplan, stream);
}
