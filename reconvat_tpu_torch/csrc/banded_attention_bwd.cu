// Banded (window-W) local attention backward for Hopper (sm_90a), with fp32
// or bf16 operands.
//
// Replaces the TPU kernel `_bwd_kernel` of
// reconvat_tpu/ops/pallas_attention_bwd.py, launched by
// `pallas_banded_backward`. With the forward of csrc/banded_attention.cu
// (s[j] = q_t . (kpad[t+j] + rel[:, j]), p = softmax(s),
// out_t = sum_j p[j] vpad[t+j]) and the output gradient dO, for batch b,
// head h and query row t:
//
//   dP[j]        = dO_t . vpad[t+j]
//   dS[j]        = p[j] * (dP[j] - sum_i p[i] dP[i])
//   dq_t         = sum_j dS[j] * (kpad[t+j] + rel[:, j])
//   dkpad[t+j]  += dS[j] * q_t
//   dvpad[t+j]  += p[j] * dO_t
//   drel[:, j]  += dS[j] * q_t             (summed over batch and rows)
//
// On the TPU the grid's row-block axis runs in order on one core, and dK,
// dV and dRel accumulate in VMEM across it. Hopper blocks run in no order,
// so the work is split in two passes and stays deterministic without
// atomics:
//
//   pass 1 (`bwd_partials_tf32x3_kernel` for fp32 operands,
//     `bwd_partials_mma_kernel` for bf16 ones): a block owns one (b, h) and
//     TQ query rows. It writes dq for its rows, and per-tile partials of dk
//     and dv over its TQ + W - 1 context rows and of drel over (Dh, W).
//   pass 2 (`bwd_overlap_add_kernel`, `bwd_drel_sum_kernel`): each output
//     row of dk / dv adds the partials of the (at most two) tiles whose
//     context covers it, in tile order; drel sums its partials over batch
//     and tiles in a fixed order.
//
// Operand types. q, kpad, vpad, dO, dq, dk and dv are fp32, or
// __nv_bfloat16 for the mixed-precision model; rel, drel and the partials
// are fp32 in both. p and dS are computed in fp32 in both. With bf16
// operands dS is rounded to bf16 before the dq, dk and drel products and p
// before the dv product, the rounding points of the Pallas kernel
// (pallas_attention_bwd.py:114, 126, 129); the products accumulate in fp32,
// and dq, dk and dv are rounded to bf16 once, at their stores.
//
// What bounds it on the H100: bytes. At B=8, L=640, H=4, Dh=229, W=31 the
// function reads q, kpad, vpad, rel, dO and writes dq, dk, dv, drel, about
// 135 MB in fp32 and 68 MB with bf16 operands (0.040 / 0.020 ms at
// 3.35 TB/s), for about 2.1 GFLOP (0.031 ms at the fp32 peak).
//
// Both first passes stage the K and V context (TQ + W - 1 rows, padded to
// KC = 64), q, dO and rel[h] in shared memory once per tile, so the device
// reads every input about once; the partials they write (about 90 MB at
// the sizes above, read once more by pass 2) are the price of determinism
// without atomics. The head slices are not 16-byte aligned
// (csrc/mma_tiles.cuh), so loads are scalar, a thread issuing all its loads
// of a batch before it stores any. Both run every product on the tensor
// cores as mma.sync tiles with fp32 sums (csrc/mma_tiles.cuh), and the
// band, softmax and dS per row on the CUDA cores (lane j <-> window offset
// j, warp shuffles), as a (TQ x KC) dense tile: S = Q K^T, dP = dO V^T and
// Q rel^T go to fp32 tiles, and p and dS come back as P_dense and dS_dense
// (p and dS at [r, r + j], zero elsewhere), so that
//   dq = dS_dense K + dS_band rel^T,  dk = dS_dense^T Q,
//   dv = P_dense^T dO,  drel = Q^T dS_band     (dS_band[r, j] = dS at [r, j]).
// Output tiles leave through a per-warp shared-memory patch, so the fp32
// partials leave as 64-byte rows. The ragged last tile is masked (dS = p =
// 0). `wgmma` is not used: it wants 64-row A tiles per warpgroup and
// descriptor-swizzled shared memory, which the 32-row tile and the
// unaligned head slices do not give. What holds both back (PERF.md §6):
// one block per SM, and every SM of a wave in the same phase, so the
// staging reads and the partials' writes do not overlap with the products.
//
// The fp32 first pass (`bwd_partials_tf32x3_kernel`, about 226 KB at
// Dh = 229, so Dh <= 232) keeps fp32 accuracy on TF32 tensor cores by
// 3xTF32 (`mma3_run`); the torch TF32 flags are not read. Its fragment
// loads read the band view dS_band of dS_dense through the index map alone,
// and the transposed operands (dS_dense^T, Q^T) in place. P and dS are
// written over S and dP, and V's tile holds the store patches once dP is
// formed: that is what fits the block in the 227 KB a block may opt in to.
//
// The bf16 first pass (`bwd_partials_mma_kernel`, about 186 KB) stages q,
// dO, K and V as bf16 (Dh padded to D16) for `mma_run`. rel[h] is split
// once into three bf16 terms r1 + r2 + r3 = rel exactly
// (`store_rel_bf16x3`), so the products that read rel weigh q and dS by the
// fp32 rel; p and dS are rounded to bf16 into P_dense, dS_dense and a
// dS_band tile of their own.
#include "mma_tiles.cuh"

namespace {

constexpr int LDB = WP + 8;            // bf16 row pitch of dS_band
static_assert(NWARPS * 16 * LDP <= TQ * (2 * LDS + 3 * LDR),
              "the store patches reuse the S, dP and Q r_i^T tiles");

// Pass 1 for bf16 operands: one block per (b, h) and TQ query rows, with
// every product on the tensor cores (the file's note, "The bf16 first
// pass").
__global__ void __launch_bounds__(NT, 1)
bwd_partials_mma_kernel(const bf16* __restrict__ q,        // (B, L, H, D)
                        const bf16* __restrict__ kpad,     // (B, L+W-1, H, D)
                        const bf16* __restrict__ vpad,     // (B, L+W-1, H, D)
                        const float* __restrict__ rel,     // (H, D, W)
                        const bf16* __restrict__ dout,     // (B, L, H, D)
                        bf16* __restrict__ dq,             // (B, L, H, D)
                        float* __restrict__ dk_part,       // (B, H, nT, ctx, D)
                        float* __restrict__ dv_part,       // (B, H, nT, ctx, D)
                        float* __restrict__ drel_part,     // (B, H, nT, D, W)
                        int L, int H, int D, int W) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int D16 = (D + 15) & ~15;      // head width padded to the depth 16
  const int ld = D16 + 8;              // bf16 row pitch of the operand tiles
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (TQ, ld)
  bf16* dos = qs + TQ * ld;            // (TQ, ld)
  bf16* ks = dos + TQ * ld;            // (KC, ld)
  bf16* vs = ks + KC * ld;             // (KC, ld)
  bf16* rs = vs + KC * ld;             // 3 x (WP, ld): rel^T in three terms
  bf16* pd = rs + 3 * WP * ld;         // (TQ, LDC) P_dense
  bf16* dsd = pd + TQ * LDC;           // (TQ, LDC) dS_dense
  bf16* dsb = dsd + TQ * LDC;          // (TQ, LDB) dS_band
  float* sf = reinterpret_cast<float*>(dsb + TQ * LDB);  // (TQ, LDS) S
  float* dpf = sf + TQ * LDS;          // (TQ, LDS) dP
  float* qrf = dpf + TQ * LDS;         // 3 x (TQ, LDR): Q r_i^T

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t0 = tile * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;

  // staging: bf16 as it is, zero past the context, past L or Lk and past D
  stage_rows<KC / NWARPS>(ks, vs, kpad + ((size_t)b * Lk + t0) * row_stride
                                      + (size_t)h * D,
                          vpad + ((size_t)b * Lk + t0) * row_stride
                              + (size_t)h * D,
                          row_stride, min(ctx, Lk - t0), D, D16, ld, warp,
                          lane);
  stage_rows<TQ / NWARPS>(qs, dos, q + ((size_t)b * L + t0) * row_stride
                                       + (size_t)h * D,
                          dout + ((size_t)b * L + t0) * row_stride
                              + (size_t)h * D,
                          row_stride, min(TQ, L - t0), D, D16, ld, warp,
                          lane);
  // rel[h] (D, W) fp32 -> rs[i][j][d] = r_i, rel = r_1 + r_2 + r_3 exactly
  float x[REL_PER_THREAD];
  load_rel(x, rel + (size_t)h * D * W, D, W, tid);
  store_rel_bf16x3(rs, x, D16, ld, tid);
  __syncthreads();

  // scores and dP, 28 tiles of 16 x 16 over the depth D16, at most two per
  // warp: S = Q K^T and dP = dO V^T (TQ x KC, 16 tiles), and Q r_i^T
  // (TQ x WP, 4 tiles for each of the three rel terms, each term into its
  // own fp32 tile)
  const int ksteps = D16 / 16;
  for (int u = warp; u < 28; u += NWARPS) {
    const bf16 *a, *bt;
    float* c;
    int ldc;
    if (u < 16) {
      const bool is_dp = u >= 8;
      const int mi = (u >> 2) & 1, ni = u & 3;
      a = (is_dp ? dos : qs) + mi * 16 * ld;
      bt = (is_dp ? vs : ks) + ni * 16 * ld;
      c = (is_dp ? dpf : sf) + mi * 16 * LDS + ni * 16;
      ldc = LDS;
    } else {
      const int i = (u - 16) >> 2, mi = (u >> 1) & 1, ni = u & 1;
      a = qs + mi * 16 * ld;
      bt = rs + (i * WP + ni * 16) * ld;
      c = qrf + (i * TQ + mi * 16) * LDR + ni * 16;
      ldc = LDR;
    }
    float acc[2][4] = {};
    mma_run<false, true>(acc, a, ld, 16, bt, ld, 16, ksteps, lane);
    store_smem(acc, c, ldc, lane);
  }
  __syncthreads();

  // band, softmax and dS per query row, lane j <-> window offset j, as in
  // the fp32 pass; p and dS rounded to bf16 into P_dense,
  // dS_dense (at [r, r + j]) and dS_band (at [r, j]), zero elsewhere
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f, ds = 0.f;
    if (t < L) {
      // q.k and q.rel summed apart, then added, as the forward does
      const float* qr = qrf + r * LDR + lane;
      const float s = lane < W ? sf[r * LDS + r + lane]
                                     + (qr[0] + qr[TQ * LDR] + qr[2 * TQ * LDR])
                               : -INFINITY;
      const float dp = lane < W ? dpf[r * LDS + r + lane] : 0.f;
      p = band_softmax(s, lane < W);
      float pdp = p * dp;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) pdp += __shfl_xor_sync(0xffffffffu, pdp, o);
      ds = p * (dp - pdp);
    }
    dsb[r * LDB + lane] = __float2bfloat16_rn(ds);   // zero for lane >= W
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      const float dsj = __shfl_sync(0xffffffffu, ds, j & 31);
      const bool in = j >= 0 && j < W;
      pd[r * LDC + c] = __float2bfloat16_rn(in ? pj : 0.f);
      dsd[r * LDC + c] = __float2bfloat16_rn(in ? dsj : 0.f);
    }
  }
  __syncthreads();

  // gradients, one 16 x 16 output tile per warp at a time, S, dP and
  // Q r_i^T now dead under the warps' store patches:
  //   dq (TQ x D16)        = dS_dense K + dS_band (r_1 + r_2 + r_3)^T
  //   dk_part (KC x D16)   = dS_dense^T Q,  dv_part = P_dense^T dO
  //   drel_part (D16 x WP) = Q^T dS_band
  float* patch = sf + warp * 16 * LDP;
  const size_t part = (size_t)blockIdx.y * n_tiles + tile;
  const int n16 = D16 / 16;
  const int n_dq = 2 * n16, n_dkv = 4 * n16;
  const int n_units = n_dq + 2 * n_dkv + 2 * n16;
  for (int u = warp; u < n_units; u += NWARPS) {
    float acc[2][4] = {};
    if (u < n_dq) {
      const int mi = u / n16, ni = u % n16;
      mma_run<false, false>(acc, dsd + mi * 16 * LDC, LDC, 16, ks + ni * 16,
                            ld, 16 * ld, KC / 16, lane);
      for (int i = 0; i < 3; ++i)
        mma_run<false, false>(acc, dsb + mi * 16 * LDB, LDB, 16,
                              rs + i * WP * ld + ni * 16, ld, 16 * ld,
                              WP / 16, lane);
      const int r0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 dq + ((size_t)b * L + t0 + r0) * row_stride + (size_t)h * D
                    + d0,
                 row_stride, min(16, L - t0 - r0), min(16, D - d0), lane);
    } else if (u < n_dq + 2 * n_dkv) {
      const int v = u - n_dq;
      const bool is_dv = v >= n_dkv;
      const int mi = (v % n_dkv) / n16, ni = v % n16;
      mma_run<true, false>(acc, (is_dv ? pd : dsd) + mi * 16, LDC, 16 * LDC,
                           (is_dv ? dos : qs) + ni * 16, ld, 16 * ld,
                           TQ / 16, lane);
      const int c0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 (is_dv ? dv_part : dk_part) + (part * ctx + c0) * D + d0,
                 (size_t)D, ctx - c0, min(16, D - d0), lane);
    } else {
      const int v = u - n_dq - 2 * n_dkv;
      const int mi = v / 2, ni = v % 2;
      mma_run<true, false>(acc, qs + mi * 16, ld, 16 * ld, dsb + ni * 16,
                           LDB, 16 * LDB, TQ / 16, lane);
      const int d0 = mi * 16, j0 = ni * 16;
      store_tile(acc, patch, drel_part + (part * D + d0) * W + j0, (size_t)W,
                 min(16, D - d0), W - j0, lane);
    }
  }
}

// ---- fp32 first pass on tensor cores, 3xTF32 ----------------------------

// floats of shared memory a block takes at head width D: K, Q, dO, rel^T,
// S, dP, Q rel^T, then V, which also holds the warps' store patches once
// dP is formed
__host__ __device__ constexpr size_t tf32x3_smem_floats(int D) {
  return (size_t)(KC + 2 * TQ + WP) * tf32_pitch(D) + TQ * (2 * LDS32 + LDR32)
         + (KC * tf32_pitch(D) > NWARPS * 16 * LDP ? KC * tf32_pitch(D)
                                                   : NWARPS * 16 * LDP);
}

// Pass 1 for fp32 operands: one block per (b, h) and TQ query rows, every
// product on the tensor cores as 3xTF32 (the file's note, "The fp32 first
// pass").
__global__ void __launch_bounds__(NT, 1)
bwd_partials_tf32x3_kernel(const float* __restrict__ q,      // (B, L, H, D)
                           const float* __restrict__ kpad,   // (B, L+W-1, H, D)
                           const float* __restrict__ vpad,   // (B, L+W-1, H, D)
                           const float* __restrict__ rel,    // (H, D, W)
                           const float* __restrict__ dout,   // (B, L, H, D)
                           float* __restrict__ dq,           // (B, L, H, D)
                           float* __restrict__ dk_part,      // (B, H, nT, ctx, D)
                           float* __restrict__ dv_part,      // (B, H, nT, ctx, D)
                           float* __restrict__ drel_part,    // (B, H, nT, D, W)
                           int L, int H, int D, int W) {
  extern __shared__ __align__(128) float smem_f32[];
  const int D8 = (D + 7) & ~7;         // head width padded to the depth 8
  const int ld = tf32_pitch(D);        // row pitch of the operand tiles
  float* ks = smem_f32;                // (KC, ld) K context
  float* qs = ks + KC * ld;            // (TQ, ld)
  float* dos = qs + TQ * ld;           // (TQ, ld)
  float* rts = dos + TQ * ld;          // (WP, ld) rel[h]^T
  float* sf = rts + WP * ld;           // (TQ, LDS32) S, then P_dense
  float* dpf = sf + TQ * LDS32;        // (TQ, LDS32) dP, then dS_dense
  float* qrf = dpf + TQ * LDS32;       // (TQ, LDR32) Q rel^T
  float* vs = qrf + TQ * LDR32;        // (KC, ld) V context, then patches

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t0 = tile * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;

  // staging: fp32 as it is, zero past the context, past L or Lk, past D
  // and past W (every padded row and column a product reads is finite)
  stage_rows_f32<KC / NWARPS>(ks, vs, kpad + ((size_t)b * Lk + t0) * row_stride
                                          + (size_t)h * D,
                              vpad + ((size_t)b * Lk + t0) * row_stride
                                  + (size_t)h * D,
                              row_stride, min(ctx, Lk - t0), D, ld, warp,
                              lane);
  stage_rows_f32<TQ / NWARPS>(qs, dos, q + ((size_t)b * L + t0) * row_stride
                                           + (size_t)h * D,
                              dout + ((size_t)b * L + t0) * row_stride
                                  + (size_t)h * D,
                              row_stride, min(TQ, L - t0), D, ld, warp,
                              lane);
  // rel[h] (D, W) -> rts[j][d]; every load issued before the first store
  float x[REL_PER_THREAD];
  load_rel(x, rel + (size_t)h * D * W, D, W, tid);
#pragma unroll
  for (int i = 0; i < REL_PER_THREAD; ++i) {
    const int e = tid + i * NT, d = e / WP, j = e % WP;
    if (d < ld) rts[sw(j, d, ld)] = x[i];
  }
  __syncthreads();

  // scores: S = Q K^T and dP = dO V^T (TQ x KC; only the 16-column tiles
  // the band reads) and Q rel^T (TQ x WP), over the depth D8
  const int nc16 = (ctx + 15) / 16;
  const int n_s = 2 * nc16;
  for (int u = warp; u < 2 * n_s + 4; u += NWARPS) {
    float acc[2][4] = {};
    if (u < 2 * n_s) {
      const bool is_dp = u >= n_s;
      const int v = u % n_s, mi = v / nc16, ni = v % nc16;
      mma3_run<OK, OK>(acc, is_dp ? dos : qs, ld, mi * 16, is_dp ? vs : ks,
                       ld, ni * 16, D8 / 8, lane);
      store_sw(acc, is_dp ? dpf : sf, LDS32, mi * 16, ni * 16, lane);
    } else {
      const int v = u - 2 * n_s, mi = v >> 1, ni = v & 1;
      mma3_run<OK, OK>(acc, qs, ld, mi * 16, rts, ld, ni * 16, D8 / 8, lane);
      store_sw(acc, qrf, LDR32, mi * 16, ni * 16, lane);
    }
  }
  __syncthreads();

  // band, softmax and dS per query row, lane j <-> window offset j; p and
  // dS (not rounded) replace S and dP as P_dense and dS_dense (at [r, r +
  // j], zero elsewhere); dS_band is read from dS_dense
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f, ds = 0.f;
    if (t < L) {
      // q.k and q.rel summed apart, then added, as the forward does
      const float s = lane < W ? sf[sw(r, r + lane, LDS32)]
                                     + qrf[sw(r, lane, LDR32)]
                               : -INFINITY;
      const float dp = lane < W ? dpf[sw(r, r + lane, LDS32)] : 0.f;
      p = band_softmax(s, lane < W);
      float pdp = p * dp;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) pdp += __shfl_xor_sync(0xffffffffu, pdp, o);
      ds = p * (dp - pdp);
    }
    __syncwarp();                      // row r read before it is rewritten
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      const float dsj = __shfl_sync(0xffffffffu, ds, j & 31);
      const bool in = j >= 0 && j < W;
      sf[sw(r, c, LDS32)] = in ? pj : 0.f;
      dpf[sw(r, c, LDS32)] = in ? dsj : 0.f;
    }
  }
  __syncthreads();

  // gradients, one 16 x 16 output tile per warp at a time, V now dead
  // under the warps' store patches:
  //   dq (TQ x D8)         = dS_dense K + dS_band rel^T (one sum)
  //   dk_part (KC x D8)    = dS_dense^T Q,  dv_part = P_dense^T dO
  //   drel_part (D8 x WP)  = Q^T dS_band
  // A tile past D8 (D8 = 8 mod 16) reads finite values of the next row and
  // is not stored.
  float* patch = vs + warp * 16 * LDP;
  const size_t part = (size_t)blockIdx.y * n_tiles + tile;
  const int n16 = (D8 + 15) / 16;
  const int n_dq = 2 * n16, n_dkv = nc16 * n16;
  const int n_units = n_dq + 2 * n_dkv + n16 * ((W + 15) / 16);
  for (int u = warp; u < n_units; u += NWARPS) {
    float acc[2][4] = {};
    if (u < n_dq) {
      const int mi = u / n16, ni = u % n16;
      mma3_run<OK, KO>(acc, dpf, LDS32, mi * 16, ks, ld, ni * 16, KC / 8,
                       lane);
      mma3_run<OBAND, KO>(acc, dpf, LDS32, mi * 16, rts, ld, ni * 16,
                          WP / 8, lane);
      const int r0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 dq + ((size_t)b * L + t0 + r0) * row_stride + (size_t)h * D
                    + d0,
                 row_stride, min(16, L - t0 - r0), min(16, D - d0), lane);
    } else if (u < n_dq + 2 * n_dkv) {
      const int v = u - n_dq;
      const bool is_dv = v >= n_dkv;
      const int mi = (v % n_dkv) / n16, ni = v % n16;
      mma3_run<KO, KO>(acc, is_dv ? sf : dpf, LDS32, mi * 16,
                       is_dv ? dos : qs, ld, ni * 16, TQ / 8, lane);
      const int c0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 (is_dv ? dv_part : dk_part) + (part * ctx + c0) * D + d0,
                 (size_t)D, ctx - c0, min(16, D - d0), lane);
    } else {
      const int v = u - n_dq - 2 * n_dkv;
      const int mi = v % n16, ni = v / n16;
      mma3_run<KO, KBAND>(acc, qs, ld, mi * 16, dpf, LDS32, ni * 16, TQ / 8,
                          lane);
      const int d0 = mi * 16, j0 = ni * 16;
      store_tile(acc, patch, drel_part + (part * D + d0) * W + j0, (size_t)W,
                 min(16, D - d0), W - j0, lane);
    }
  }
}

// dk / dv row s of (b, h) = sum over the tiles i whose context
// [i*TQ, i*TQ + ctx) covers s, in increasing i, stored as T
template <typename T>
__global__ void bwd_overlap_add_kernel(const float* __restrict__ dk_part,
                                       const float* __restrict__ dv_part,
                                       T* __restrict__ dk,
                                       T* __restrict__ dv,
                                       int B, int L, int H, int D, int W,
                                       int n_tiles) {
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const size_t n = (size_t)B * Lk * H * D;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int d = idx % D;
    const int h = (idx / D) % H;
    const int s = (idx / ((size_t)D * H)) % Lk;
    const int b = idx / ((size_t)D * H * Lk);
    const int i_lo = s >= ctx ? (s - ctx) / TQ + 1 : 0;
    const int i_hi = min(n_tiles - 1, s / TQ);
    const size_t base = ((size_t)b * H + h) * n_tiles;
    float ak = 0.f, av = 0.f;
    for (int i = i_lo; i <= i_hi; ++i) {
      const size_t off = ((base + i) * ctx + (s - i * TQ)) * D + d;
      ak += dk_part[off];
      av += dv_part[off];
    }
    dk[idx] = from_f32<T>(ak);
    dv[idx] = from_f32<T>(av);
  }
}

// drel[h, d, j] = sum over b, then tiles, of the partials
__global__ void bwd_drel_sum_kernel(const float* __restrict__ drel_part,
                                    float* __restrict__ drel, int B, int H,
                                    int D, int W, int n_tiles) {
  const int DW = D * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * DW) return;
  const int h = idx / DW, e = idx % DW;
  float a = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = drel_part + ((size_t)b * H + h) * n_tiles * DW + e;
    for (int i = 0; i < n_tiles; ++i) a += p[(size_t)i * DW];
  }
  drel[idx] = a;
}

int launch_partials_tf32x3(const float* q, const float* kpad,
                           const float* vpad, const float* rel,
                           const float* dout, float* dq, float* dk_part,
                           float* dv_part, float* drel_part, int B, int L,
                           int H, int D, int W, int tq, void* stream) {
  if (tq != TQ || W < 1 || W > 32 || D > 32 * MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * tf32x3_smem_floats(D);
  // Above 48 KB a kernel has to opt in, once per device: the largest size
  // asked for so far is kept, so a launch makes no call for it again.
  static size_t opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(bwd_partials_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  dim3 grid((L + TQ - 1) / TQ, B * H);
  bwd_partials_tf32x3_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, kpad, vpad, rel, dout, dq, dk_part, dv_part, drel_part, L, H, D, W);
  return (int)cudaGetLastError();
}
int launch_partials_mma(const bf16* q, const bf16* kpad, const bf16* vpad,
                        const float* rel, const bf16* dout, bf16* dq,
                        float* dk_part, float* dv_part, float* drel_part,
                        int B, int L, int H, int D, int W, int tq,
                        void* stream) {
  if (tq != TQ || W < 1 || W > 32 || D > 32 * MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  const size_t ld = ((D + 15) & ~15) + 8;
  const size_t smem = sizeof(bf16) * ((2 * TQ + 2 * KC + 3 * WP) * ld
                                      + 2 * TQ * LDC + TQ * LDB)
                      + sizeof(float) * TQ * (2 * LDS + 3 * LDR);
  static size_t opted_in[64] = {};     // as launch_partials_tf32x3
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(bwd_partials_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  dim3 grid((L + TQ - 1) / TQ, B * H);
  bwd_partials_mma_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, kpad, vpad, rel, dout, dq, dk_part, dv_part, drel_part, L, H, D, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const float* dk_part, const float* dv_part,
                  const float* drel_part, T* dk, T* dv, float* drel, int B,
                  int L, int H, int D, int W, int tq, void* stream) {
  if (tq != TQ || W < 1 || W > 32) return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + TQ - 1) / TQ;
  const size_t n = (size_t)B * (L + W - 1) * H * D;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  bwd_overlap_add_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      dk_part, dv_part, dk, dv, B, L, H, D, W, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nr = H * D * W;
  bwd_drel_sum_kernel<<<(nr + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(drel_part, drel, B, H, D, W,
                                                n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 alone: dq, and the dk / dv / drel partials. `tq` must equal the
// tile the library was built with (the caller sizes the partials by it).
extern "C" int banded_attention_bwd_partials_launch(
    const float* q, const float* kpad, const float* vpad, const float* rel,
    const float* dout, float* dq, float* dk_part, float* dv_part,
    float* drel_part, int B, int L, int H, int D, int W, int tq,
    void* stream) {
  return launch_partials_tf32x3(q, kpad, vpad, rel, dout, dq, dk_part,
                                dv_part, drel_part, B, L, H, D, W, tq,
                                stream);
}

// Bytes of shared memory a block of the fp32 first pass takes at head
// width D, and the most a block may opt in to on the current device (-1
// if it cannot be read): the caller checks the one against the other.
extern "C" int banded_attention_bwd_partials_smem_bytes(int D) {
  return (int)(sizeof(float) * tf32x3_smem_floats(D));
}

extern "C" int banded_attention_bwd_partials_smem_limit() {
  int device = 0, limit = -1;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return limit;
}

// q, kpad, vpad, dout and dq bf16; rel and the partials fp32.
extern "C" int banded_attention_bwd_partials_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* kpad,
    const __nv_bfloat16* vpad, const float* rel, const __nv_bfloat16* dout,
    __nv_bfloat16* dq, float* dk_part, float* dv_part, float* drel_part,
    int B, int L, int H, int D, int W, int tq, void* stream) {
  return launch_partials_mma(q, kpad, vpad, rel, dout, dq, dk_part, dv_part,
                             drel_part, B, L, H, D, W, tq, stream);
}

// Pass 2: dk and dv from their partials, drel from its partials.
extern "C" int banded_attention_bwd_reduce_launch(
    const float* dk_part, const float* dv_part, const float* drel_part,
    float* dk, float* dv, float* drel, int B, int L, int H, int D, int W,
    int tq, void* stream) {
  return launch_reduce<float>(dk_part, dv_part, drel_part, dk, dv, drel, B,
                              L, H, D, W, tq, stream);
}

// dk and dv bf16; the partials and drel fp32.
extern "C" int banded_attention_bwd_reduce_bf16_launch(
    const float* dk_part, const float* dv_part, const float* drel_part,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* drel, int B, int L, int H,
    int D, int W, int tq, void* stream) {
  return launch_reduce<__nv_bfloat16>(dk_part, dv_part, drel_part, dk, dv,
                                      drel, B, L, H, D, W, tq, stream);
}
