// Tensor-core tiles of the banded-attention kernels for Hopper (sm_90a),
// shared by csrc/banded_attention.cu (the forward) and
// csrc/banded_attention_bwd.cu (the backward's first passes).
//
// A block owns one (b, h) and TQ query rows. Its K and V context, the
// TQ + W - 1 key rows the band of those rows reaches, is padded to KC rows,
// the window to WP columns. Heads are Dh-element slices of an H * Dh row
// (229 of 916: 916 bytes at 4-byte alignment in fp32, 458 at 2-byte in
// bf16), so rows are not 16-byte aligned and neither TMA (16-byte strides)
// nor a 16-byte cp.async can address them.
//
// Every product is a run of mma.sync tiles, one warp per 16 x 16 output
// tile, with fp32 sums, and each depth-8 or depth-16 product is summed from
// zero and then added in fp32: that keeps the sums closer to the fp32 FMA
// chains of the plain versions than one accumulator run through the tensor
// cores.
//
// - bf16 operands (`mma_run`): bf16 tiles in shared memory (the head width
//   padded to D16, a multiple of 16, with a row pitch of D16 + 8), read by
//   ldmatrix into bf16 x bf16 -> fp32 mma.sync m16n8k16.
// - fp32 operands (`mma3_run`), as 3xTF32: every operand element x is split
//   as it is loaded into big = tf32(x) and small = tf32(x - big) (rounded as
//   cvt.rna rounds, by integer ops; `split_tf32x2` in
//   ops/banded_attention_kernel.py), and each m16n8k8 product is big.big +
//   (small.big + big.small); small.small (2^-22 relative) is dropped.
//   Nothing is rounded to a narrower type. The operands stay fp32 in shared
//   memory, the head width padded with zeros to D8 (a multiple of 8); tf32
//   fragments are 32-bit, so they come from plain shared loads (ldmatrix is
//   a b16 instruction), which also read band views and transposed operands
//   in place through the index map (`frag_ld`). Every fp32 tile's pitch is
//   8 (mod 32) with its columns XOR-swizzled by bit 2 of the row (`sw`), so
//   a fragment load along rows and one along columns both hit 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 32;         // query rows per tile
constexpr int NT = 512;        // threads per block (16 warps)
constexpr int NWARPS = NT / 32;
constexpr int MAX_DCHUNK = 8;  // head columns staged per row: 32 * 8 = 256
constexpr int KC = 64;         // context rows, TQ + W - 1 <= 63
constexpr int WP = 32;         // window columns
constexpr int LDP = 24;        // fp32 row pitch of a warp's store patch
// bf16 tiles: row pitches of a bf16 (TQ, KC) tile, and of the fp32 S and
// Q rel^T tiles
constexpr int LDC = KC + 8;
constexpr int LDS = KC + 4;
constexpr int LDR = WP + 4;
// fp32 tiles (swizzled): row pitches of S-like (TQ, KC) tiles and of Q rel^T
constexpr int LDS32 = KC + 8;
constexpr int LDR32 = WP + 8;

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// p of one query row from its band scores, lane j <-> window offset j (s
// is -inf and p 0 at lanes that are not `in`): max, exp and sum by warp
// shuffles
__device__ __forceinline__ float band_softmax(float s, bool in) {
  float m = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = in ? expf(s - m) : 0.f;
  float z = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
  return e / z;
}

// Element (row, col) of an fp32 tile of pitch ld, its columns XOR-swizzled
// by bit 2 of the row
__device__ __forceinline__ int sw(int row, int col, int ld) {
  return row * ld + (col ^ (row & 4));
}

// ---- bf16 tiles ----------------------------------------------------------

// Four 8 x 8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows), optionally transposed
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d = A (16 x 16) B (16 x 8), bf16 operands, fp32 result
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%10, %10, %10, %10};"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1), "f"(0.f));
}

// acc += A B for one warp's 16 x 16 output tile, over `steps` products of
// depth 16. acc[n][i] is the mma fragment of output columns 8n..8n+7:
// rows lane / 4 (i = 0, 1) and lane / 4 + 8 (i = 2, 3), columns
// 2 (lane % 4) + (i % 2). A is stored (m, k) in shared memory, or (k, m)
// for A_T; B is stored (k, n), or (n, k) for B_T; lda / ldb are the row
// pitches, a and b point at the first tile, a_step / b_step are the
// element offsets of the next tile along the depth. Each step's product
// is summed from zero and then added in fp32, so the tensor cores' own
// rounding of a sum spans 16 products, not the whole run.
template <bool A_T, bool B_T>
__device__ __forceinline__ void mma_run(float (&acc)[2][4], const bf16* a,
                                        int lda, int a_step, const bf16* b,
                                        int ldb, int b_step, int steps,
                                        int lane) {
  // lane l addresses one 16-byte row of one of the tile's four 8 x 8
  // matrices. A stored (m, k) and B stored (k, n) take them in the order
  // (rows, columns of the stored tile) (0-7, 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15): row l % 16, column 8 (l / 16). A stored (k, m) and B
  // stored (n, k) take (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15):
  // row l % 8 + 8 (l / 16), column 8 (l / 8 % 2).
  const int r_row = lane & 15, c_row = (lane >> 4) * 8;
  const int r_col = (lane & 7) + (lane >> 4) * 8, c_col = (lane >> 3 & 1) * 8;
  const unsigned pa = (unsigned)__cvta_generic_to_shared(
      a + (A_T ? r_col * lda + c_col : r_row * lda + c_row));
  const unsigned pb = (unsigned)__cvta_generic_to_shared(
      b + (B_T ? r_col * ldb + c_col : r_row * ldb + c_row));
  for (int s = 0; s < steps; ++s) {
    unsigned fa[4], fb[4];
    ldsm_x4<A_T>(fa, pa + 2 * s * a_step);
    ldsm_x4<!B_T>(fb, pb + 2 * s * b_step);
    float part[2][4];
    mma_16816(part[0], fa, fb[0], fb[1]);
    mma_16816(part[1], fa, fb[2], fb[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
  }
}

// The warp's 16 x 16 tile to fp32 shared memory (pitch ldc)
__device__ __forceinline__ void store_smem(const float (&acc)[2][4], float* c,
                                           int ldc, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float* p = c + g * ldc + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(p + 8 * ldc) = make_float2(acc[n][2], acc[n][3]);
  }
}

// The warp's 16 x 16 tile back from fp32 shared memory (pitch ldc), as
// `store_smem` stored it: a product continued over more depth
__device__ __forceinline__ void load_smem(float (&acc)[2][4], const float* c,
                                          int ldc, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float* p = c + g * ldc + n * 8 + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(p);
    const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ldc);
    acc[n][0] = lo.x;
    acc[n][1] = lo.y;
    acc[n][2] = hi.x;
    acc[n][3] = hi.y;
  }
}

// The warp's 16 x 16 tile to out (row pitch ld_out, as T), rows < rows and
// columns < cols only, through the warp's shared-memory patch (pitch LDP):
// a fragment holds pairs of columns 8 rows apart, so it is stored to the
// patch and read back a row per half warp, 64 contiguous bytes of fp32
// per store
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4],
                                           float* patch, T* out,
                                           size_t ld_out, int rows, int cols,
                                           int lane) {
  store_smem(acc, patch, LDP, lane);
  __syncwarp();
  const int r0 = lane >> 4, c = lane & 15;
  if (c < cols) {
#pragma unroll
    for (int r = r0; r < 16; r += 2)
      if (r < rows) out[r * ld_out + c] = from_f32<T>(patch[r * LDP + c]);
  }
  __syncwarp();
}

// Rows r = warp + i * NWARPS (i < ROWS) of a bf16 (rows, D) slice, row r
// at g + r * stride, into registers: zero at rows >= live and columns >= D.
// The caller issues every load of a batch before it stores any
// (`store_rows`), and may hold the registers across other work.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16 (&v)[ROWS][MAX_DCHUNK],
                                          const bf16* __restrict__ g,
                                          size_t stride, int live, int D,
                                          int warp, int lane) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      v[i][c] = r < live && d < D ? g[r * stride + d]
                                  : __float2bfloat16_rn(0.f);
    }
  }
}

// What `load_rows` read, into the tile s (pitch ld), columns < D16
template <int ROWS>
__device__ __forceinline__ void store_rows(bf16* s,
                                           const bf16 (&v)[ROWS][MAX_DCHUNK],
                                           int D16, int ld, int warp,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      if (d < D16) s[r * ld + d] = v[i][c];
    }
  }
}

// Rows r = warp + i * NWARPS (i < ROWS) of two bf16 (rows, D) slices, row
// r at ga / gb + r * stride, into sa / sb (pitch ld), zero at rows >= live
// and columns in [D, D16). A thread issues all its loads before it stores
// any, so staging waits about one memory latency, not one per row.
template <int ROWS>
__device__ __forceinline__ void stage_rows(bf16* sa, bf16* sb,
                                           const bf16* __restrict__ ga,
                                           const bf16* __restrict__ gb,
                                           size_t stride, int live, int D,
                                           int D16, int ld, int warp,
                                           int lane) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  bf16 va[ROWS][MAX_DCHUNK], vb[ROWS][MAX_DCHUNK];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      const bool in = r < live && d < D;
      va[i][c] = in ? ga[r * stride + d] : zero;
      vb[i][c] = in ? gb[r * stride + d] : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      if (d < D16) {
        sa[r * ld + d] = va[i][c];
        sb[r * ld + d] = vb[i][c];
      }
    }
  }
}

// rel[h] (D, W) fp32: thread tid's elements e = tid + i * NT as (d, j) =
// (e / WP, e % WP), zero past D and W; every load issued before any use
constexpr int REL_PER_THREAD = 32 * MAX_DCHUNK * WP / NT;

__device__ __forceinline__ void load_rel(float (&x)[REL_PER_THREAD],
                                         const float* __restrict__ relh,
                                         int D, int W, int tid) {
#pragma unroll
  for (int i = 0; i < REL_PER_THREAD; ++i) {
    const int e = tid + i * NT, d = e / WP, j = e % WP;
    x[i] = d < D && j < W ? relh[d * W + j] : 0.f;
  }
}

// rel^T as three bf16 terms, rs[i][j][d] = r_i (pitch ld, WP rows per
// term), rel = r_1 + r_2 + r_3 exactly (`split_bf16x3` in
// ops/banded_attention_kernel.py): a bf16 product of q with the three
// terms, summed in fp32, weighs q by the fp32 rel
__device__ __forceinline__ void store_rel_bf16x3(
    bf16* rs, const float (&x)[REL_PER_THREAD], int D16, int ld, int tid) {
#pragma unroll
  for (int i = 0; i < REL_PER_THREAD; ++i) {
    const int e = tid + i * NT, d = e / WP, j = e % WP;
    if (d >= D16) continue;
    const bf16 r1 = __float2bfloat16_rn(x[i]);
    const float e1 = x[i] - __bfloat162float(r1);
    const bf16 r2 = __float2bfloat16_rn(e1);
    rs[j * ld + d] = r1;
    rs[(WP + j) * ld + d] = r2;
    rs[(2 * WP + j) * ld + d] =
        __float2bfloat16_rn(e1 - __bfloat162float(r2));
  }
}

// ---- fp32 tiles, 3xTF32 --------------------------------------------------

// row pitch of an fp32 operand tile of head width D: D8 (D padded to a
// multiple of 8) raised to 8 (mod 32)
__host__ __device__ constexpr int tf32_pitch(int D) {
  return ((D + 7) & ~7) + (8 - ((D + 7) & ~7) % 32 + 32) % 32;
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for finite x), on the integer pipe: cvt issues
// at a quarter of that rate, and the fragment loads split every element
// they read
__device__ __forceinline__ unsigned rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big + small, each rounded to TF32; x - big is exact in fp32
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

// d += A (16 x 8) B (8 x 8), TF32 operands, fp32 sums
__device__ __forceinline__ void mma_1688(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// Where element (o, k) of an operand lies in its swizzled tile: o is the
// output index (m of A, n of B), k the depth. OK: stored (o, k); KO: stored
// (k, o); OBAND: stored (o, o + k), the band view of a dense tile (dS_band
// of dS_dense as A); KBAND: stored (k, k + o) (dS_band as B).
enum Lay { OK, KO, OBAND, KBAND };

template <int LAY>
__device__ __forceinline__ float frag_ld(const float* s, int ld, int o,
                                         int k) {
  if (LAY == OK) return s[sw(o, k, ld)];
  if (LAY == KO) return s[sw(k, o, ld)];
  if (LAY == OBAND) return s[sw(o, o + k, ld)];
  return s[sw(k, k + o, ld)];
}

// acc += A B for one warp's 16 x 16 output tile at (m0, n0) over `steps`
// depths of 8 from k = 0, as 3xTF32: each fragment element is split as it
// is loaded, and each depth-8 product is big.big, and big.small +
// small.big, each summed from zero and then added in fp32 (two short mma
// chains per output tile and depth, so a warp keeps several in flight).
// Fragments (PTX m16n8k8 .tf32): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B b0 (t, g), b1 (t + 4, g); g = lane / 4, t = lane %
// 4. acc as in mma_run.
template <int LA, int LB>
__device__ __forceinline__ void mma3_run(float (&acc)[2][4], const float* a,
                                         int lda, int m0, const float* b,
                                         int ldb, int n0, int steps,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    const int k = 8 * s + t;
    unsigned ab[4], as[4], bb[2][2], bs[2][2];
    split_tf32(frag_ld<LA>(a, lda, m0 + g, k), ab[0], as[0]);
    split_tf32(frag_ld<LA>(a, lda, m0 + g + 8, k), ab[1], as[1]);
    split_tf32(frag_ld<LA>(a, lda, m0 + g, k + 4), ab[2], as[2]);
    split_tf32(frag_ld<LA>(a, lda, m0 + g + 8, k + 4), ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      split_tf32(frag_ld<LB>(b, ldb, n0 + 8 * n + g, k), bb[n][0], bs[n][0]);
      split_tf32(frag_ld<LB>(b, ldb, n0 + 8 * n + g, k + 4), bb[n][1],
                 bs[n][1]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
      mma_1688(big, ab, bb[n][0], bb[n][1]);
      mma_1688(small, as, bb[n][0], bb[n][1]);
      mma_1688(small, ab, bs[n][0], bs[n][1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += big[i] + small[i];
    }
  }
}

// The warp's 16 x 16 tile into a swizzled fp32 tile at (m0, n0)
__device__ __forceinline__ void store_sw(const float (&acc)[2][4], float* c,
                                         int ldc, int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(c + sw(m0 + g, col, ldc)) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(c + sw(m0 + g + 8, col, ldc)) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// The warp's 16 x 16 tile back from a swizzled fp32 tile at (m0, n0), as
// `store_sw` stored it
__device__ __forceinline__ void load_sw(float (&acc)[2][4], const float* c,
                                        int ldc, int m0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n0 + n * 8 + 2 * t;
    const float2 lo =
        *reinterpret_cast<const float2*>(c + sw(m0 + g, col, ldc));
    const float2 hi =
        *reinterpret_cast<const float2*>(c + sw(m0 + g + 8, col, ldc));
    acc[n][0] = lo.x;
    acc[n][1] = lo.y;
    acc[n][2] = hi.x;
    acc[n][3] = hi.y;
  }
}

// Rows r = warp + i * NWARPS (i < ROWS) of two fp32 (rows, D) slices, row
// r at ga / gb + r * stride, into the swizzled tiles sa / sb (pitch ld),
// zero at rows >= live and columns in [D, ld). A thread issues all its
// loads before it stores any.
template <int ROWS>
__device__ __forceinline__ void stage_rows_f32(float* sa, float* sb,
                                               const float* __restrict__ ga,
                                               const float* __restrict__ gb,
                                               size_t stride, int live, int D,
                                               int ld, int warp, int lane) {
  float va[ROWS][MAX_DCHUNK], vb[ROWS][MAX_DCHUNK];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      const bool in = r < live && d < D;
      va[i][c] = in ? ga[r * stride + d] : 0.f;
      vb[i][c] = in ? gb[r * stride + d] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      if (d < ld) {
        sa[sw(r, d, ld)] = va[i][c];
        sb[sw(r, d, ld)] = vb[i][c];
      }
    }
  }
}

// One fp32 element from device memory to shared memory by cp.async (4
// bytes: the head slices are 4-byte aligned), or a zero where !in (src is
// then not read but must still be a device address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Rows r = warp + i * NWARPS (i < ROWS) of an fp32 (rows, D) slice, row r
// at g + r * stride, into the swizzled tile s (pitch ld) by cp.async, zero
// at rows >= live and columns in [D, ld)
template <int ROWS>
__device__ __forceinline__ void copy_rows_f32(float* s,
                                              const float* __restrict__ g,
                                              size_t stride, int live, int D,
                                              int ld, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + i * NWARPS;
#pragma unroll
    for (int c = 0; c < MAX_DCHUNK; ++c) {
      const int d = lane + 32 * c;
      const bool in = r < live && d < D;
      if (d < ld) cp_async4(s + sw(r, d, ld), in ? g + r * stride + d : g, in);
    }
  }
}

}  // namespace
