// hessian_accum: out = X^T X, or acc + X^T X, in fp32 on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hessian_accum.py
// (hessian_accum_kernel, bodies _xtx_kernel / _xtx_acc_kernel).
//
// X is (N, D) row-major, fp32 or bf16; out and acc are (D, D) fp32.
//
// Bound: the distinct entries of the symmetric X^T X need N*D*(D+1)/2 FMA,
// N*D*(D+1) operations, and adding acc D^2 more, on the fp32 FMA pipes
// (67 TFLOP/s on an H100 SXM), against (N*D + 2*D^2) * 4 bytes plus the
// workspace below (written once, read once). At N = 4096 it is bound by
// operations at every D on the paths: 0.5773 ms at D = 3072 (38.7 GFLOP
// against 126 MB, and 118 MB of workspace). It uses no tensor cores: TF32
// keeps about three decimal digits and breaks the 1e-4*sqrt(N) tolerance
// the calibration Hessians are held to (3xTF32 is the next step, after an
// accuracy check at that tolerance).
//
// Design:
// - Tiles. Only the 128 x 128 output tiles on or above the diagonal are
//   computed; the wrapper passes their (ti, tj) list. A block of 256
//   threads owns one tile and a range of rows of X: 8 warps as 4 x 2, a
//   warp as 4 x 8 threads, a thread 8 x 8 outputs in fp32 registers (rows
//   r..r+3 and r+16..r+19, columns c..c+3 and c+32..c+35). X is row-major,
//   so a strip of rows of X holds both column panels of the tile
//   contiguously: that is the outer-product layout already, and shared
//   memory keeps it as it is. Each row of a strip costs a thread four
//   16-byte shared-memory reads (a warp reads 64 and 128 contiguous bytes:
//   one wavefront each, no bank conflict) for 64 FMA. A diagonal tile reads
//   its one panel twice.
// - Asynchronous copies. Strips of 16 rows (16 KB for the two panels) go
//   by cp.async into a ring of 3 stages (48 KB of shared memory): strip
//   k + 2 is in flight while strip k computes, with one __syncthreads per
//   strip. Rows past the range and columns past D are zero-filled. The fp32
//   entry copies 16 bytes a thread where D % 4 == 0 and X's base is 16-byte
//   aligned, else 4 bytes a thread (the wrapper picks by shape and
//   alignment). The bf16 entry (off the main path) loads through registers
//   and converts before its shared-memory store; the ring is the same.
// - A deterministic split over N. The wrapper splits the rows of X into
//   `splits` ranges of `chunk` rows (a multiple of 16) so that the last
//   wave of tiles x splits work items is at least 75% full on the card's
//   SMs at the blocks per SM this kernel reaches (hessian_accum_occupancy;
//   the split plan is kernels/hessian_accum.py split_plan). Items are
//   numbered split-major, so the blocks in flight share one range of X in
//   L2. With one split, each block adds acc and writes its tile and, off
//   the diagonal, the transposed tile (through shared memory, so both
//   stores are coalesced). With more, each block writes its partial tile
//   to a workspace the wrapper allocates, and a second kernel sums the
//   partials of each tile in split order, adds acc, and writes the tile
//   and its mirror. No atomics: the same inputs give the same bits on
//   every run on a card. acc need not be symmetric: each store adds its
//   own acc entry, so acc + X^T X is one pass.
// - A call runs one CUDA kernel (xtx_tiles) with one split, two
//   (xtx_tiles, then reduce_splits) with more.
//
// ptxas (-Xptxas -v, CUDA 12.8, sm_90a): xtx_tiles 128 registers for the
// 16-byte fp32 entry, 121 for the 4-byte one and 127 for bf16, no spills,
// 49,152 bytes of shared memory (the ring; the epilogue reuses it), so 2
// blocks an SM under __launch_bounds__(256, 2); reduce_splits 32 registers
// and 8,256 bytes. Waves on an H100 SXM (132 SMs x 2 blocks = 264 slots)
// at N = 4096: D = 768 has 21 upper tiles, 10 splits of 416 rows, 210
// items in one wave (0.795 full); D = 3072 300 tiles, 6 splits of 688
// rows, 1800 items in 7 waves (the last 0.818 full); D = 5120 820 tiles,
// 8 splits of 512 rows, 6560 items in 25 waves (the last 0.848 full).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BT = 128;      // output tile edge
constexpr int BK = 16;       // rows of X per strip
constexpr int STAGES = 3;    // strips in the ring
constexpr int THREADS = 256; // 8 warps, 8 x 8 outputs a thread
constexpr int PANEL = BK * BT;            // floats of one panel's strip
constexpr int RING = STAGES * 2 * PANEL;  // 12,288 floats, 48 KB
constexpr int PITCH = BT + 1;             // staging rows: no bank conflict
constexpr int RR = 16;                    // tile rows per reduce block

// How a strip reaches shared memory: 16-byte cp.async (fp32, D % 4 == 0,
// aligned base), 4-byte cp.async (fp32, any shape), or through registers
// (bf16, converted to fp32 before the store).
enum Load { kVec16 = 0, kScalar4 = 1, kBf16 = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

template <int L>
struct StripLayout {
  static constexpr int kWidth = L == kVec16 ? 4 : 1;      // floats a copy
  static constexpr int kLanesPerRow = BT / kWidth;         // 32 or 128
  static constexpr int kRowsPerPass = THREADS / kLanesPerRow;  // 8 or 2
  static constexpr int kPasses = BK / kRowsPerPass;        // 2 or 8
};

// One panel's strip: rows [row0, row0 + BK) of X (zeros at or past
// row_hi) and the 128 columns from the panel's first; `col_ok` says
// whether this thread's column lies inside D.
template <int L, typename T>
__device__ __forceinline__ void load_strip(float* dst, const T* x,
                                           const T* xcol, bool col_ok,
                                           int row0, int row_hi, int d) {
  using S = StripLayout<L>;
  const int r0 = threadIdx.x / S::kLanesPerRow;
  const int c = (threadIdx.x % S::kLanesPerRow) * S::kWidth;
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) {
    const int r = r0 + p * S::kRowsPerPass;
    const int row = row0 + r;
    const bool ok = col_ok && row < row_hi;
    const T* src = ok ? xcol + (size_t)row * d : x;
    float* to = dst + r * BT + c;
    if constexpr (L == kVec16) {
      cp_async16(to, reinterpret_cast<const float*>(src), ok);
    } else if constexpr (L == kScalar4) {
      cp_async4(to, reinterpret_cast<const float*>(src), ok);
    } else {
      *to = ok ? __bfloat162float(*src) : 0.0f;
    }
  }
}

// Strip k of both panels into stage k % STAGES of the ring (one panel for
// a diagonal tile).
template <int L, typename T>
__device__ __forceinline__ void issue_strip(float* ring, int k, const T* x,
                                            const T* xa, const T* xb,
                                            bool ok_a, bool ok_b, bool diag,
                                            int row_lo, int row_hi, int d) {
  float* st = ring + (k % STAGES) * 2 * PANEL;
  const int row0 = row_lo + k * BK;
  load_strip<L>(st, x, xa, ok_a, row0, row_hi, d);
  if (!diag) load_strip<L>(st + PANEL, x, xb, ok_b, row0, row_hi, d);
}

// The tile's rows and columns held by output (a, b) of this thread.
__device__ __forceinline__ int out_row(int ra, int a) {
  return ra + (a < 4 ? a : 12 + a);  // a >= 4: ra + 16 + (a - 4)
}
__device__ __forceinline__ int out_col(int cb, int b) {
  return cb + (b < 4 ? b : 28 + b);  // b >= 4: cb + 32 + (b - 4)
}

// Work item blockIdx.x = split * n_upper + tile. ws == nullptr: one split,
// write out (+ acc) directly; else write the partial tile to
// ws[blockIdx.x] (BT x BT, row-major).
template <int L, typename T>
__global__ void __launch_bounds__(THREADS, 2)
xtx_tiles(const T* __restrict__ x, const float* __restrict__ acc,
          float* __restrict__ out, float* __restrict__ ws,
          const int2* __restrict__ tiles, int n, int d, int n_upper,
          int chunk) {
  __shared__ __align__(16) float smem[RING];
  const int split = blockIdx.x / n_upper;
  const int2 tile = tiles[blockIdx.x - split * n_upper];
  const int i0 = tile.x * BT, j0 = tile.y * BT;
  const bool diag = tile.x == tile.y;
  const int row_lo = split * chunk;
  const int row_hi = min(n, row_lo + chunk);
  const int strips = row_hi > row_lo ? (row_hi - row_lo + BK - 1) / BK : 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = (warp >> 1) * 32 + (lane >> 3) * 4;  // 4 x 2 warps,
  const int cb = (warp & 1) * 64 + (lane & 7) * 4;    // 4 x 8 lanes

  using S = StripLayout<L>;
  const int lc = (threadIdx.x % S::kLanesPerRow) * S::kWidth;
  const bool ok_a = i0 + lc < d, ok_b = j0 + lc < d;
  const T* xa = x + i0 + lc;
  const T* xb = x + j0 + lc;

  float c[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) c[a][b] = 0.0f;

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < strips)
      issue_strip<L>(smem, k, x, xa, xb, ok_a, ok_b, diag, row_lo, row_hi, d);
    cp_async_commit();
  }
  for (int k = 0; k < strips; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // strip k landed; stage (k - 1) % STAGES is free
    if (k + STAGES - 1 < strips)
      issue_strip<L>(smem, k + STAGES - 1, x, xa, xb, ok_a, ok_b, diag,
                     row_lo, row_hi, d);
    cp_async_commit();
    const float* pa = smem + (k % STAGES) * 2 * PANEL;
    const float* pb = diag ? pa : pa + PANEL;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa + kk * BT + ra);
      const float4 a1 =
          *reinterpret_cast<const float4*>(pa + kk * BT + ra + 16);
      const float4 b0 = *reinterpret_cast<const float4*>(pb + kk * BT + cb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(pb + kk * BT + cb + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) c[a][b] = fmaf(av[a], bv[b], c[a][b]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  if (ws != nullptr) {  // partial tile of this split, 16-byte stores
    float* p = ws + (size_t)blockIdx.x * BT * BT;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = out_row(ra, a);
      *reinterpret_cast<float4*>(p + r * BT + cb) =
          make_float4(c[a][0], c[a][1], c[a][2], c[a][3]);
      *reinterpret_cast<float4*>(p + r * BT + cb + 32) =
          make_float4(c[a][4], c[a][5], c[a][6], c[a][7]);
    }
    return;
  }

  // One split: half the tile's rows at a time through shared memory (64
  // staged rows; staged row s is tile row (s / 16) * 32 + 16 * h + s % 16),
  // then the tile row by row and its mirror column by column.
  float* m = smem;
  const int sr = (warp >> 1) * 16 + (lane >> 3) * 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
        m[(sr + a) * PITCH + out_col(cb, b)] = c[4 * h + a][b];
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * BT; e += THREADS) {
      const int s = e / BT, col = e % BT;
      const int i = i0 + (s >> 4) * 32 + 16 * h + (s & 15), j = j0 + col;
      if (i < d && j < d) {
        const size_t o = (size_t)i * d + j;
        const float v = m[s * PITCH + col];
        out[o] = acc != nullptr ? acc[o] + v : v;
      }
    }
    if (!diag) {  // a diagonal tile is its own mirror
      for (int e = threadIdx.x; e < 64 * BT; e += THREADS) {
        const int s = e % 64, col = e / 64;
        const int i = i0 + (s >> 4) * 32 + 16 * h + (s & 15), j = j0 + col;
        if (i < d && j < d) {
          const size_t o = (size_t)j * d + i;
          const float v = m[s * PITCH + col];
          out[o] = acc != nullptr ? acc[o] + v : v;
        }
      }
    }
    __syncthreads();
  }
}

// Tile rows [part * RR, part * RR + RR) of upper tile t, blockIdx.x =
// t * (BT / RR) + part: the splits' partials summed in split order, acc
// added, written to the tile and, off the diagonal, to its mirror.
__global__ void __launch_bounds__(THREADS)
reduce_splits(const float* __restrict__ ws, const float* __restrict__ acc,
              float* __restrict__ out, const int2* __restrict__ tiles, int d,
              int n_upper, int splits) {
  __shared__ float m[RR * PITCH];
  const int t = blockIdx.x / (BT / RR), r0 = (blockIdx.x % (BT / RR)) * RR;
  const int2 tile = tiles[t];
  const int i0 = tile.x * BT + r0, j0 = tile.y * BT;
  const size_t stride = (size_t)n_upper * BT * BT;
  const float* p0 = ws + (size_t)t * BT * BT + (size_t)r0 * BT;
  for (int e = threadIdx.x; e < RR * BT; e += THREADS) {
    const int r = e / BT, col = e % BT;
    const float* p = p0 + e;
    float v = p[0];
    for (int s = 1; s < splits; ++s) v += p[s * stride];
    m[r * PITCH + col] = v;
    const int i = i0 + r, j = j0 + col;
    if (i < d && j < d) {
      const size_t o = (size_t)i * d + j;
      out[o] = acc != nullptr ? acc[o] + v : v;
    }
  }
  if (tile.x == tile.y) return;
  __syncthreads();
  for (int e = threadIdx.x; e < RR * BT; e += THREADS) {
    const int r = e % RR, col = e / RR;
    const int i = i0 + r, j = j0 + col;
    if (i < d && j < d) {
      const size_t o = (size_t)j * d + i;
      const float v = m[r * PITCH + col];
      out[o] = acc != nullptr ? acc[o] + v : v;
    }
  }
}

template <int L, typename T>
int launch(const void* x, const float* acc, float* out, float* ws,
           const void* tiles, int n, int d, int n_upper, int splits,
           int chunk, void* stream) {
  if (n_upper <= 0 || splits <= 0 || chunk <= 0 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* tl = static_cast<const int2*>(tiles);
  xtx_tiles<L, T><<<n_upper * splits, THREADS, 0, st>>>(
      static_cast<const T*>(x), acc, out, splits > 1 ? ws : nullptr, tl, n,
      d, n_upper, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  reduce_splits<<<n_upper * (BT / RR), THREADS, 0, st>>>(ws, acc, out, tl, d,
                                                        n_upper, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, D) row-major; acc (D, D) or null (out = X^T X); out (D, D), which
// aliases neither; tiles: n_upper (ti, tj) int32 pairs on the card; ws:
// splits * n_upper * 128 * 128 floats when splits > 1, else unused; chunk:
// rows of X per split. Returns the cudaError_t of the launches.
extern "C" int hessian_accum_f32(const void* x, const float* acc, float* out,
                                 float* ws, const void* tiles, int n, int d,
                                 int n_upper, int splits, int chunk,
                                 void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) != 0 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);  // 16-byte copies
  return launch<kVec16, float>(x, acc, out, ws, tiles, n, d, n_upper, splits,
                               chunk, stream);
}

extern "C" int hessian_accum_f32_unaligned(const void* x, const float* acc,
                                           float* out, float* ws,
                                           const void* tiles, int n, int d,
                                           int n_upper, int splits, int chunk,
                                           void* stream) {
  return launch<kScalar4, float>(x, acc, out, ws, tiles, n, d, n_upper,
                                 splits, chunk, stream);
}

extern "C" int hessian_accum_bf16(const void* x, const float* acc, float* out,
                                  float* ws, const void* tiles, int n, int d,
                                  int n_upper, int splits, int chunk,
                                  void* stream) {
  return launch<kBf16, __nv_bfloat16>(x, acc, out, ws, tiles, n, d, n_upper,
                                      splits, chunk, stream);
}

// Blocks of xtx_tiles an SM holds for entry 0 (f32), 1 (f32_unaligned) or
// 2 (bf16), by the registers and shared memory ptxas gave it.
extern "C" int hessian_accum_occupancy(int entry, int* blocks) {
  cudaError_t err = cudaErrorInvalidValue;
  if (entry == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, xtx_tiles<kVec16, float>, THREADS, 0);
  else if (entry == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, xtx_tiles<kScalar4, float>, THREADS, 0);
  else if (entry == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, xtx_tiles<kBf16, __nv_bfloat16>, THREADS, 0);
  return static_cast<int>(err);
}
