// Banded (window-W) local attention forward for Hopper (sm_90a), with fp32
// or bf16 operands, on the tensor cores.
//
// Replaces the TPU kernel `_attention_kernel` (with `_skew_bias`) of
// reconvat_tpu/ops/pallas_attention.py, launched by `pallas_banded_forward`.
// For batch b, head h and query row t, with kpad/vpad zero-padded by
// (W-1)/2 rows on each side so that key t+j is the j-th in-band key:
//
//   s[j]   = q_t . kpad[t+j] + q_t . rel[:, j]      j = 0..W-1, no 1/sqrt(d)
//   p      = softmax(s)
//   out_t  = sum_j p[j] * vpad[t+j]
//   probs[b, t, h, :] = p
//
// Operand types. q, kpad, vpad and out are fp32
// (`banded_attention_fwd_tf32x3_kernel`), or __nv_bfloat16 for the
// mixed-precision model (`banded_attention_fwd_mma_kernel`); rel and probs
// are fp32 in both. The scores, the softmax and the PV sums are fp32 in
// both; in bf16, p is rounded to bf16 before the PV product (the Pallas
// kernel casts probs to v's dtype there) and out is rounded to bf16 once,
// at the store. probs holds p before that rounding.
//
// What bounds it on the H100: bytes. At B=8, L=640, H=4, Dh=229, W=31 the
// fp32 kernel moves ~79 MB (q, kpad, vpad, rel, out, probs), the bf16 one
// ~41 MB, for ~0.9 GFLOP; at CFP's Dh=386 (L=638) ~132 MB and ~67 MB.
//
// The design is the Pallas kernel's, in the tiles of the backward's first
// passes (csrc/mma_tiles.cuh). A block owns one (b, h) and TQ = 32 query
// rows; its K and V context (TQ + W - 1 rows) is padded to KC = 64 rows.
// The head width is walked in column chunks (`fwd_chunk_width`): the whole
// head up to 256 columns (one chunk), past it (CFP's Dh = 386; at most
// 512) two chunks of at most 256 columns, so the tiles fit the shared
// memory a block may take. Every input is still read once. Heads of one chunk take
// `banded_attention_fwd_tf32x3_kernel` and `banded_attention_fwd_mma_kernel`,
// which stage the whole head at once; wider heads take the `_wide_kernel`
// variants, which walk the two chunks (one instance for both spilled and
// ran 1.2-1.7x slower at Dh <= 256, PERF.md §6).
//   1. Q, the K context and rel[h]^T of a chunk are staged in shared
//      memory, and the loads of the V context's first chunk are issued
//      with the second chunk's, to be stored after the softmax (the Pallas
//      kernel's `copy_v`): fp32 rows by 4-byte cp.async (the head slices
//      are 4-byte aligned) in two groups, bf16 rows (2-byte aligned)
//      through registers.
//   2. S = Q K^T (TQ x KC) and Q rel^T (TQ x WP) on the tensor cores, kept
//      apart and added at the band, as the plain version adds q.k and
//      q.rel: in bf16 by ldmatrix + m16n8k16 with rel as three exact bf16
//      terms, in fp32 as 3xTF32. The second chunk's products continue the
//      sums of the first, read back from the S and Q rel^T tiles
//      into the same fragments, so the sums are those of one walk over the
//      whole depth (chunks start at multiples of 16).
//   3. The band and the softmax per query row on the CUDA cores, once,
//      lane j <-> window offset j; p goes to probs and into a dense P tile
//      (p at [r, r + j], zero elsewhere and at rows past L), rounded to
//      bf16 there for bf16 operands.
//   4. out[:, chunk] = P V[:, chunk] (TQ x chunk) on the tensor cores, one
//      V chunk at a time (fp32: the second chunk's cp.async in flight in
//      a second buffer; bf16: its loads held in registers), stored
//      through a per-warp shared-memory patch as the operand type, rounded
//      once.
// The context's rows past kpad and its padded columns are zero, so every
// product reads finite values. The CPU models of these tiles are
// `banded_attention_fwd_tf32x3_plain` and `banded_attention_fwd_mma_plain`
// in ops/banded_attention_kernel.py (one walk over the depth, as here).
#include "mma_tiles.cuh"

namespace {

constexpr int FWD_CHUNK = 32 * MAX_DCHUNK;  // head columns of one chunk
constexpr int MAX_FWD_D = 2 * FWD_CHUNK;    // head width the forward takes
static_assert(TQ + WP == KC, "the fp32 kernel's second V buffer is the Q "
                             "and rel^T tiles");

// Head columns per chunk of the forward at head width D: D itself up to
// FWD_CHUNK (one chunk); past it (up to MAX_FWD_D) the first of two
// chunks, half the head rounded up to 16, so that the second starts at a
// multiple of both product depths (8 and 16)
__host__ __device__ constexpr int fwd_chunk_width(int D) {
  return D <= FWD_CHUNK ? D : ((D + 1) / 2 + 15) & ~15;
}

// Elements of the K tile of pitch ld, `size` bytes each: KC rows, or the
// warps' fp32 store patches that replace K for the PV product, if larger
__host__ __device__ constexpr int k_tile_elems(int ld, int size) {
  return KC * ld * size > 4 * NWARPS * 16 * LDP ? KC * ld
                                                : 4 * NWARPS * 16 * LDP / size;
}

// bf16 row pitch of the bf16 kernel's operand tiles: D16 + 8
__host__ __device__ constexpr int mma_pitch(int D) {
  return ((D + 15) & ~15) + 8;
}

// bytes of shared memory the fp32 kernel takes at head width D: Q, rel^T,
// K and V chunks (fp32), S (then P) and Q rel^T
__host__ __device__ constexpr size_t fwd_tf32x3_smem_bytes(int D) {
  return sizeof(float)
         * ((size_t)(TQ + WP + KC) * tf32_pitch(fwd_chunk_width(D))
            + k_tile_elems(tf32_pitch(fwd_chunk_width(D)), sizeof(float))
            + TQ * (LDS32 + LDR32));
}

// bytes of shared memory the bf16 kernel takes at head width D: Q, K, V
// and rel^T chunks in three terms and P (bf16), then S and Q r_i^T (fp32)
__host__ __device__ constexpr size_t fwd_mma_smem_bytes(int D) {
  return sizeof(bf16)
             * ((size_t)(TQ + KC + 3 * WP) * mma_pitch(fwd_chunk_width(D))
                + k_tile_elems(mma_pitch(fwd_chunk_width(D)), sizeof(bf16))
                + TQ * LDC)
         + sizeof(float) * TQ * (LDS + 3 * LDR);
}

// The forward for fp32 operands, every product as 3xTF32 (the file's note)
__global__ void __launch_bounds__(NT, 1)
banded_attention_fwd_tf32x3_kernel(
    const float* __restrict__ q,         // (B, L, H, D)
    const float* __restrict__ kpad,      // (B, L+W-1, H, D)
    const float* __restrict__ vpad,      // (B, L+W-1, H, D)
    const float* __restrict__ rel,       // (H, D, W)
    float* __restrict__ out,             // (B, L, H, D)
    float* __restrict__ probs,           // (B, L, H, W)
    int L, int H, int D, int W) {
  extern __shared__ __align__(128) float smem_f32[];
  const int D8 = (D + 7) & ~7;         // head width padded to the depth 8
  const int ld = tf32_pitch(D);        // row pitch of the operand tiles
  float* qs = smem_f32;                // (TQ, ld)
  float* ks = qs + TQ * ld;            // (KC, ld) K context, then patches
  float* rts = ks + k_tile_elems(ld, sizeof(float));  // (WP, ld) rel[h]^T
  float* vs = rts + WP * ld;           // (KC, ld) V context
  float* sf = vs + KC * ld;            // (TQ, LDS32) S, then P_dense
  float* qrf = sf + TQ * LDS32;        // (TQ, LDR32) Q rel^T

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;
  const size_t head = (size_t)h * D;

  // staging by cp.async: Q, the K context and rel^T in one group, the V
  // context in a second one that lands during the scores; zero past the
  // context, past L or Lk, past D and past W
  copy_rows_f32<TQ / NWARPS>(qs, q + ((size_t)b * L + t0) * row_stride + head,
                             row_stride, min(TQ, L - t0), D, ld, warp, lane);
  copy_rows_f32<KC / NWARPS>(ks,
                             kpad + ((size_t)b * Lk + t0) * row_stride + head,
                             row_stride, min(ctx, Lk - t0), D, ld, warp, lane);
  const float* relh = rel + (size_t)h * D * W;
#pragma unroll
  for (int i = 0; i < REL_PER_THREAD; ++i) {
    const int e = tid + i * NT, d = e / WP, j = e % WP;
    const bool in = d < D && j < W;
    if (d < ld) cp_async4(rts + sw(j, d, ld), in ? relh + d * W + j : relh, in);
  }
  cp_async_commit();
  copy_rows_f32<KC / NWARPS>(vs,
                             vpad + ((size_t)b * Lk + t0) * row_stride + head,
                             row_stride, min(ctx, Lk - t0), D, ld, warp, lane);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // scores: S = Q K^T (TQ x KC; only the 16-column tiles the band reads)
  // and Q rel^T (TQ x WP), over the depth D8
  const int nc16 = (ctx + 15) / 16;
  const int n_s = 2 * nc16;
  for (int u = warp; u < n_s + 4; u += NWARPS) {
    float acc[2][4] = {};
    if (u < n_s) {
      const int mi = u / nc16, ni = u % nc16;
      mma3_run<OK, OK>(acc, qs, ld, mi * 16, ks, ld, ni * 16, D8 / 8, lane);
      store_sw(acc, sf, LDS32, mi * 16, ni * 16, lane);
    } else {
      const int v = u - n_s, mi = v >> 1, ni = v & 1;
      mma3_run<OK, OK>(acc, qs, ld, mi * 16, rts, ld, ni * 16, D8 / 8, lane);
      store_sw(acc, qrf, LDR32, mi * 16, ni * 16, lane);
    }
  }
  __syncthreads();

  // band and softmax per query row, lane j <-> window offset j; p (not
  // rounded) replaces S as P_dense (at [r, r + j], zero elsewhere)
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f;
    if (t < L) {
      const float s = lane < W ? sf[sw(r, r + lane, LDS32)]
                                     + qrf[sw(r, lane, LDR32)]
                               : -INFINITY;
      p = band_softmax(s, lane < W);
      if (lane < W) probs[(((size_t)b * L + t) * H + h) * W + lane] = p;
    }
    __syncwarp();                      // row r read before it is rewritten
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      sf[sw(r, c, LDS32)] = j >= 0 && j < W ? pj : 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // out (TQ x D8) = P_dense V, one 16 x 16 output tile per warp at a time,
  // K now dead under the warps' store patches. A tile past D8 (D8 = 8 mod
  // 16) reads finite values of the next row (or of S) and is not stored.
  float* patch = ks + warp * 16 * LDP;
  const int n16 = (D8 + 15) / 16;
  for (int u = warp; u < 2 * n16; u += NWARPS) {
    const int mi = u / n16, ni = u % n16;
    float acc[2][4] = {};
    mma3_run<OK, KO>(acc, sf, LDS32, mi * 16, vs, ld, ni * 16, KC / 8, lane);
    const int r0 = mi * 16, d0 = ni * 16;
    store_tile(acc, patch,
               out + ((size_t)b * L + t0 + r0) * row_stride + head + d0,
               row_stride, min(16, L - t0 - r0), min(16, D - d0), lane);
  }
}

// The forward for bf16 operands, every product by ldmatrix + mma.sync
// m16n8k16 (the file's note)
__global__ void __launch_bounds__(NT, 1)
banded_attention_fwd_mma_kernel(
    const bf16* __restrict__ q,          // (B, L, H, D)
    const bf16* __restrict__ kpad,       // (B, L+W-1, H, D)
    const bf16* __restrict__ vpad,       // (B, L+W-1, H, D)
    const float* __restrict__ rel,       // (H, D, W)
    bf16* __restrict__ out,              // (B, L, H, D)
    float* __restrict__ probs,           // (B, L, H, W)
    int L, int H, int D, int W) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int D16 = (D + 15) & ~15;      // head width padded to the depth 16
  const int ld = mma_pitch(D);         // bf16 row pitch of the operand tiles
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (TQ, ld)
  bf16* ks = qs + TQ * ld;             // (KC, ld) K context, then patches
  bf16* vs = ks + k_tile_elems(ld, sizeof(bf16));  // (KC, ld) V context
  bf16* rs = vs + KC * ld;             // 3 x (WP, ld): rel^T in three terms
  bf16* pd = rs + 3 * WP * ld;         // (TQ, LDC) P_dense
  float* sf = reinterpret_cast<float*>(pd + TQ * LDC);  // (TQ, LDS) S
  float* qrf = sf + TQ * LDS;          // 3 x (TQ, LDR): Q r_i^T

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;
  const size_t head = (size_t)h * D;
  const int live_k = min(ctx, Lk - t0);

  // staging: bf16 as it is, zero past the context, past L or Lk and past
  // D; rel[h] -> rs[i][j][d] = r_i, rel = r_1 + r_2 + r_3 exactly. The V
  // context's loads are issued once Q and K are stored, and its registers
  // are stored after the softmax.
  {
    bf16 kr[KC / NWARPS][MAX_DCHUNK], qr[TQ / NWARPS][MAX_DCHUNK];
    float x[REL_PER_THREAD];
    load_rows(kr, kpad + ((size_t)b * Lk + t0) * row_stride + head,
              row_stride, live_k, D, warp, lane);
    load_rows(qr, q + ((size_t)b * L + t0) * row_stride + head, row_stride,
              min(TQ, L - t0), D, warp, lane);
    load_rel(x, rel + (size_t)h * D * W, D, W, tid);
    store_rows(ks, kr, D16, ld, warp, lane);
    store_rows(qs, qr, D16, ld, warp, lane);
    store_rel_bf16x3(rs, x, D16, ld, tid);
  }
  bf16 vr[KC / NWARPS][MAX_DCHUNK];
  load_rows(vr, vpad + ((size_t)b * Lk + t0) * row_stride + head, row_stride,
            live_k, D, warp, lane);
  __syncthreads();

  // scores over the depth D16: S = Q K^T (TQ x KC; only the 16-column
  // tiles the band reads) and Q r_i^T (TQ x WP, 4 tiles for each of the
  // three rel terms, each term into its own fp32 tile)
  const int ksteps = D16 / 16;
  const int nc16 = (ctx + 15) / 16;
  const int n_s = 2 * nc16;
  for (int u = warp; u < n_s + 12; u += NWARPS) {
    const bf16 *a, *bt;
    float* c;
    int ldc;
    if (u < n_s) {
      const int mi = u / nc16, ni = u % nc16;
      a = qs + mi * 16 * ld;
      bt = ks + ni * 16 * ld;
      c = sf + mi * 16 * LDS + ni * 16;
      ldc = LDS;
    } else {
      const int v = u - n_s, i = v >> 2, mi = (v >> 1) & 1, ni = v & 1;
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

  // band and softmax per query row, lane j <-> window offset j; p rounded
  // to bf16 into P_dense (at [r, r + j], zero elsewhere); then V stored
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f;
    if (t < L) {
      // q.k and q.rel summed apart, then added
      const float* qr = qrf + r * LDR + lane;
      const float s = lane < W ? sf[r * LDS + r + lane]
                                     + (qr[0] + qr[TQ * LDR] + qr[2 * TQ * LDR])
                               : -INFINITY;
      p = band_softmax(s, lane < W);
      if (lane < W) probs[(((size_t)b * L + t) * H + h) * W + lane] = p;
    }
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      pd[r * LDC + c] = __float2bfloat16_rn(j >= 0 && j < W ? pj : 0.f);
    }
  }
  store_rows(vs, vr, D16, ld, warp, lane);
  __syncthreads();

  // out (TQ x D16) = P_dense V, one 16 x 16 output tile per warp at a
  // time, K now dead under the warps' store patches
  float* patch = reinterpret_cast<float*>(ks) + warp * 16 * LDP;
  const int n16 = D16 / 16;
  for (int u = warp; u < 2 * n16; u += NWARPS) {
    const int mi = u / n16, ni = u % n16;
    float acc[2][4] = {};
    mma_run<false, false>(acc, pd + mi * 16 * LDC, LDC, 16, vs + ni * 16, ld,
                          16 * ld, KC / 16, lane);
    const int r0 = mi * 16, d0 = ni * 16;
    store_tile(acc, patch,
               out + ((size_t)b * L + t0 + r0) * row_stride + head + d0,
               row_stride, min(16, L - t0 - r0), min(16, D - d0), lane);
  }
}

// The fp32 kernel's staging by cp.async, one group per call: a chunk of w
// columns of Q, the K context and rel^T (Q and K rows at qg / kg + r *
// stride, rel[h]'s rows from relc), or of the V context into dst; zero
// past the context, past L or Lk, past the chunk's columns and past W
__device__ __forceinline__ void stage_scores_f32(
    float* qs, float* ks, float* rts, const float* __restrict__ qg,
    const float* __restrict__ kg, const float* __restrict__ relc,
    size_t stride, int live_q, int live_k, int w, int ld, int W, int tid,
    int warp, int lane) {
  copy_rows_f32<TQ / NWARPS>(qs, qg, stride, live_q, w, ld, warp, lane);
  copy_rows_f32<KC / NWARPS>(ks, kg, stride, live_k, w, ld, warp, lane);
#pragma unroll
  for (int i = 0; i < REL_PER_THREAD; ++i) {
    const int e = tid + i * NT, d = e / WP, j = e % WP;
    const bool in = d < w && j < W;
    if (d < ld) cp_async4(rts + sw(j, d, ld), in ? relc + d * W + j : relc,
                          in);
  }
  cp_async_commit();
}

__device__ __forceinline__ void stage_v_f32(float* dst,
                                            const float* __restrict__ vg,
                                            size_t stride, int live_k, int w,
                                            int ld, int warp, int lane) {
  copy_rows_f32<KC / NWARPS>(dst, vg, stride, live_k, w, ld, warp, lane);
  cp_async_commit();
}

// The forward for fp32 operands at a head wider than FWD_CHUNK (up to
// MAX_FWD_D), walked in two column chunks, the first dc wide, every
// product as 3xTF32 (the file's note)
__global__ void __launch_bounds__(NT, 1)
banded_attention_fwd_tf32x3_wide_kernel(
    const float* __restrict__ q,         // (B, L, H, D)
    const float* __restrict__ kpad,      // (B, L+W-1, H, D)
    const float* __restrict__ vpad,      // (B, L+W-1, H, D)
    const float* __restrict__ rel,       // (H, D, W)
    float* __restrict__ out,             // (B, L, H, D)
    float* __restrict__ probs,           // (B, L, H, W)
    int L, int H, int D, int W) {
  extern __shared__ __align__(128) float smem_f32[];
  const int dc = fwd_chunk_width(D);   // head columns of the first chunk
  const int w1 = D - dc;               // and of the second
  const int ld = tf32_pitch(dc);       // row pitch of the operand tiles
  float* qs = smem_f32;                // (TQ, ld) Q chunk
  float* rts = qs + TQ * ld;           // (WP, ld) rel[h]^T chunk
  float* ks = rts + WP * ld;           // (KC, ld) K chunk, then patches
  float* vs = ks + k_tile_elems(ld, sizeof(float));  // (KC, ld) V chunk
  float* sf = vs + KC * ld;            // (TQ, LDS32) S, then P_dense
  float* qrf = sf + TQ * LDS32;        // (TQ, LDR32) Q rel^T

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;
  const size_t head = (size_t)h * D;
  const float* qg = q + ((size_t)b * L + t0) * row_stride + head;
  const float* kg = kpad + ((size_t)b * Lk + t0) * row_stride + head;
  const float* vg = vpad + ((size_t)b * Lk + t0) * row_stride + head;
  const float* relh = rel + (size_t)h * D * W;
  const int live_q = min(TQ, L - t0), live_k = min(ctx, Lk - t0);

  // the first chunk; with the second, the V context's first chunk, which
  // lands during the scores
  stage_scores_f32(qs, ks, rts, qg, kg, relh, row_stride, live_q, live_k,
                   dc, ld, W, tid, warp, lane);
  cp_async_wait<0>();
  __syncthreads();

  // scores: S = Q K^T (TQ x KC; only the 16-column tiles the band reads)
  // and Q rel^T (TQ x WP), over the depth D8, chunk by chunk; the second
  // chunk continues the sums stored by the first
  const int nc16 = (ctx + 15) / 16;
  const int n_s = 2 * nc16;
  for (int c = 0; c < 2; ++c) {
    if (c == 1) {
      __syncthreads();                 // the first chunk's tiles are read
      stage_scores_f32(qs, ks, rts, qg + dc, kg + dc, relh + (size_t)dc * W,
                       row_stride, live_q, live_k, w1, ld, W, tid, warp,
                       lane);
      stage_v_f32(vs, vg, row_stride, live_k, dc, ld, warp, lane);
      cp_async_wait<1>();
      __syncthreads();
    }
    const int steps = ((c == 0 ? dc : w1) + 7) / 8;
    for (int u = warp; u < n_s + 4; u += NWARPS) {
      float acc[2][4] = {};
      if (u < n_s) {
        const int mi = u / nc16, ni = u % nc16;
        if (c == 1) load_sw(acc, sf, LDS32, mi * 16, ni * 16, lane);
        mma3_run<OK, OK>(acc, qs, ld, mi * 16, ks, ld, ni * 16, steps, lane);
        store_sw(acc, sf, LDS32, mi * 16, ni * 16, lane);
      } else {
        const int v = u - n_s, mi = v >> 1, ni = v & 1;
        if (c == 1) load_sw(acc, qrf, LDR32, mi * 16, ni * 16, lane);
        mma3_run<OK, OK>(acc, qs, ld, mi * 16, rts, ld, ni * 16, steps,
                         lane);
        store_sw(acc, qrf, LDR32, mi * 16, ni * 16, lane);
      }
    }
  }
  __syncthreads();

  // the V context's second chunk into the Q and rel^T tiles, now dead;
  // band and softmax per query row, lane j <-> window offset j; p (not
  // rounded) replaces S as P_dense (at [r, r + j], zero elsewhere)
  stage_v_f32(qs, vg + dc, row_stride, live_k, w1, ld, warp, lane);
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f;
    if (t < L) {
      const float s = lane < W ? sf[sw(r, r + lane, LDS32)]
                                     + qrf[sw(r, lane, LDR32)]
                               : -INFINITY;
      p = band_softmax(s, lane < W);
      if (lane < W) probs[(((size_t)b * L + t) * H + h) * W + lane] = p;
    }
    __syncwarp();                      // row r read before it is rewritten
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      sf[sw(r, c, LDS32)] = j >= 0 && j < W ? pj : 0.f;
    }
  }
  cp_async_wait<1>();                  // V's first chunk has landed
  __syncthreads();

  // out[:, chunk] (TQ x D8 of the chunk) = P_dense V[:, chunk], one 16 x 16
  // output tile per warp at a time, K now dead under the warps' store
  // patches; V's first chunk in vs, its second in the Q tiles. A tile past
  // D8 (D8 = 8 mod 16) reads values of the next row (or of the next tile)
  // into output columns that are not stored.
  float* patch = ks + warp * 16 * LDP;
  for (int c = 0; c < 2; ++c) {
    if (c == 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const float* vc = c == 1 ? qs : vs;
    const int c0 = c * dc, w = c == 1 ? w1 : dc;
    const int n16 = (((w + 7) & ~7) + 15) / 16;
    for (int u = warp; u < 2 * n16; u += NWARPS) {
      const int mi = u / n16, ni = u % n16;
      float acc[2][4] = {};
      mma3_run<OK, KO>(acc, sf, LDS32, mi * 16, vc, ld, ni * 16, KC / 8,
                       lane);
      const int r0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 out + ((size_t)b * L + t0 + r0) * row_stride + head + c0 + d0,
                 row_stride, min(16, L - t0 - r0), min(16, w - d0), lane);
    }
  }
}

// The bf16 kernel's staging of a chunk of w columns of Q, the K context
// and rel^T: bf16 as it is, zero past the context, past L or Lk and past
// the chunk's columns; rel[h] -> rs[i][j][d] = r_i, rel = r_1 + r_2 + r_3
// exactly. Every load is issued before the block waits for the previous
// chunk's products (`after_products`) and stores.
__device__ __forceinline__ void stage_scores_bf16(
    bf16* qs, bf16* ks, bf16* rs, const bf16* __restrict__ qg,
    const bf16* __restrict__ kg, const float* __restrict__ relc,
    size_t stride, int live_q, int live_k, int w, int ld, int W,
    bool after_products, int tid, int warp, int lane) {
  const int w16 = (w + 15) & ~15;
  bf16 kr[KC / NWARPS][MAX_DCHUNK], qr[TQ / NWARPS][MAX_DCHUNK];
  float x[REL_PER_THREAD];
  load_rows(kr, kg, stride, live_k, w, warp, lane);
  load_rows(qr, qg, stride, live_q, w, warp, lane);
  load_rel(x, relc, w, W, tid);
  if (after_products) __syncthreads();
  store_rows(ks, kr, w16, ld, warp, lane);
  store_rows(qs, qr, w16, ld, warp, lane);
  store_rel_bf16x3(rs, x, w16, ld, tid);
}

// The forward for bf16 operands at a head wider than FWD_CHUNK (up to
// MAX_FWD_D), walked in two column chunks, the first dc wide, every
// product by ldmatrix + mma.sync m16n8k16 (the file's note)
__global__ void __launch_bounds__(NT, 1)
banded_attention_fwd_mma_wide_kernel(
    const bf16* __restrict__ q,          // (B, L, H, D)
    const bf16* __restrict__ kpad,       // (B, L+W-1, H, D)
    const bf16* __restrict__ vpad,       // (B, L+W-1, H, D)
    const float* __restrict__ rel,       // (H, D, W)
    bf16* __restrict__ out,              // (B, L, H, D)
    float* __restrict__ probs,           // (B, L, H, W)
    int L, int H, int D, int W) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int dc = fwd_chunk_width(D);   // head columns of the first chunk
  // 2 for every head it takes; read at run time, for with the count fixed
  // ptxas spills about three times the bytes and the kernel runs slower
  const int nch = (D + dc - 1) / dc;
  const int ld = mma_pitch(dc);        // bf16 row pitch of the operand tiles
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // (TQ, ld)
  bf16* ks = qs + TQ * ld;             // (KC, ld) K context, then patches
  bf16* vs = ks + k_tile_elems(ld, sizeof(bf16));  // (KC, ld) V context
  bf16* rs = vs + KC * ld;             // 3 x (WP, ld): rel^T in three terms
  bf16* pd = rs + 3 * WP * ld;         // (TQ, LDC) P_dense
  float* sf = reinterpret_cast<float*>(pd + TQ * LDC);  // (TQ, LDS) S
  float* qrf = sf + TQ * LDS;          // 3 x (TQ, LDR): Q r_i^T

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * TQ;
  const int ctx = TQ + W - 1;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;
  const size_t head = (size_t)h * D;
  const bf16* qg = q + ((size_t)b * L + t0) * row_stride + head;
  const bf16* kg = kpad + ((size_t)b * Lk + t0) * row_stride + head;
  const bf16* vg = vpad + ((size_t)b * Lk + t0) * row_stride + head;
  const float* relh = rel + (size_t)h * D * W;
  const int live_k = min(ctx, Lk - t0);

  bf16 vr[KC / NWARPS][MAX_DCHUNK];      // a chunk of the V context
  // the first chunk; the V context's first chunk's loads are issued with
  // the second chunk's, once its Q and K are stored, and its registers are
  // stored after the softmax
  stage_scores_bf16(qs, ks, rs, qg, kg, relh, row_stride, min(TQ, L - t0),
                    live_k, dc, ld, W, false, tid, warp, lane);
  __syncthreads();

  // scores over the depth D16, chunk by chunk: S = Q K^T (TQ x KC; only
  // the 16-column tiles the band reads) and Q r_i^T (TQ x WP, 4 tiles for
  // each of the three rel terms, each term into its own fp32 tile); the
  // second chunk continues the sums stored by the first
  const int nc16 = (ctx + 15) / 16;
  const int n_s = 2 * nc16;
  for (int c = 0; c < nch; ++c) {
    if (c > 0) {
      stage_scores_bf16(qs, ks, rs, qg + c * dc, kg + c * dc,
                        relh + (size_t)c * dc * W, row_stride,
                        min(TQ, L - t0), live_k, min(dc, D - c * dc), ld, W,
                        true, tid, warp, lane);
      if (c == nch - 1)
        load_rows(vr, vg, row_stride, live_k, min(dc, D), warp, lane);
      __syncthreads();
    }
    const int ksteps = (min(dc, D - c * dc) + 15) / 16;
    for (int u = warp; u < n_s + 12; u += NWARPS) {
      const bf16 *a, *bt;
      float* cs;
      int ldc;
      if (u < n_s) {
        const int mi = u / nc16, ni = u % nc16;
        a = qs + mi * 16 * ld;
        bt = ks + ni * 16 * ld;
        cs = sf + mi * 16 * LDS + ni * 16;
        ldc = LDS;
      } else {
        const int v = u - n_s, i = v >> 2, mi = (v >> 1) & 1, ni = v & 1;
        a = qs + mi * 16 * ld;
        bt = rs + (i * WP + ni * 16) * ld;
        cs = qrf + (i * TQ + mi * 16) * LDR + ni * 16;
        ldc = LDR;
      }
      float acc[2][4] = {};
      if (c > 0) load_smem(acc, cs, ldc, lane);
      mma_run<false, true>(acc, a, ld, 16, bt, ld, 16, ksteps, lane);
      store_smem(acc, cs, ldc, lane);
    }
  }
  __syncthreads();

  // band and softmax per query row, lane j <-> window offset j; p rounded
  // to bf16 into P_dense (at [r, r + j], zero elsewhere); then V's first
  // chunk stored
  for (int r = warp; r < TQ; r += NWARPS) {
    const int t = t0 + r;
    float p = 0.f;
    if (t < L) {
      // q.k and q.rel summed apart, then added
      const float* qr = qrf + r * LDR + lane;
      const float s = lane < W ? sf[r * LDS + r + lane]
                                     + (qr[0] + qr[TQ * LDR] + qr[2 * TQ * LDR])
                               : -INFINITY;
      p = band_softmax(s, lane < W);
      if (lane < W) probs[(((size_t)b * L + t) * H + h) * W + lane] = p;
    }
#pragma unroll
    for (int c = lane; c < KC; c += 32) {
      const int j = c - r;
      const float pj = __shfl_sync(0xffffffffu, p, j & 31);
      pd[r * LDC + c] = __float2bfloat16_rn(j >= 0 && j < W ? pj : 0.f);
    }
  }
  store_rows(vs, vr, dc, ld, warp, lane);
  __syncthreads();

  // out[:, chunk] (TQ x D16 of the chunk) = P_dense V[:, chunk], one 16 x
  // 16 output tile per warp at a time, K now dead under the warps' store
  // patches; the second V chunk's loads are in flight during the first
  // chunk's products
  float* patch = reinterpret_cast<float*>(ks) + warp * 16 * LDP;
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * dc, w = min(dc, D - c0);
    const int n16 = (w + 15) / 16;
    if (c + 1 < nch)
      load_rows(vr, vg + c0 + dc, row_stride, live_k, min(dc, D - c0 - dc),
                warp, lane);
    for (int u = warp; u < 2 * n16; u += NWARPS) {
      const int mi = u / n16, ni = u % n16;
      float acc[2][4] = {};
      mma_run<false, false>(acc, pd + mi * 16 * LDC, LDC, 16, vs + ni * 16,
                            ld, 16 * ld, KC / 16, lane);
      const int r0 = mi * 16, d0 = ni * 16;
      store_tile(acc, patch,
                 out + ((size_t)b * L + t0 + r0) * row_stride + head + c0 + d0,
                 row_stride, min(16, L - t0 - r0), min(16, w - d0), lane);
    }
    if (c + 1 < nch) {
      __syncthreads();                 // chunk c of V is read
      store_rows(vs, vr, (min(dc, D - c0 - dc) + 15) & ~15, ld, warp, lane);
      __syncthreads();
    }
  }
}

// Opt in to `smem` bytes of dynamic shared memory for `kernel` (above
// 48 KB a kernel has to), once per device: the largest size asked for so
// far is kept, so a launch makes no call for it again
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, size_t (&opted_in)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && opted_in[device] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && device < 64) opted_in[device] = smem;
  return err;
}

}  // namespace

extern "C" int banded_attention_fwd_launch(const float* q, const float* kpad,
                                           const float* vpad, const float* rel,
                                           float* out, float* probs, int B,
                                           int L, int H, int D, int W,
                                           void* stream) {
  if (W < 1 || W > 32 || D < 1 || D > MAX_FWD_D)
    return (int)cudaErrorInvalidValue;
  static size_t opted_in[2][64] = {};
  const bool wide = D > FWD_CHUNK;
  const size_t smem = fwd_tf32x3_smem_bytes(D);
  cudaError_t err =
      wide ? opt_in(banded_attention_fwd_tf32x3_wide_kernel, smem,
                    opted_in[1])
           : opt_in(banded_attention_fwd_tf32x3_kernel, smem,
                    opted_in[0]);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TQ - 1) / TQ, B * H);
  if (wide)
    banded_attention_fwd_tf32x3_wide_kernel
        <<<grid, NT, smem, (cudaStream_t)stream>>>(q, kpad, vpad, rel, out,
                                                   probs, L, H, D, W);
  else
    banded_attention_fwd_tf32x3_kernel
        <<<grid, NT, smem, (cudaStream_t)stream>>>(q, kpad, vpad, rel, out,
                                                   probs, L, H, D, W);
  return (int)cudaGetLastError();
}

// q, kpad, vpad and out bf16; rel and probs fp32.
extern "C" int banded_attention_fwd_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* kpad,
    const __nv_bfloat16* vpad, const float* rel, __nv_bfloat16* out,
    float* probs, int B, int L, int H, int D, int W, void* stream) {
  if (W < 1 || W > 32 || D < 1 || D > MAX_FWD_D)
    return (int)cudaErrorInvalidValue;
  static size_t opted_in[2][64] = {};
  const bool wide = D > FWD_CHUNK;
  const size_t smem = fwd_mma_smem_bytes(D);
  cudaError_t err =
      wide ? opt_in(banded_attention_fwd_mma_wide_kernel, smem, opted_in[1])
           : opt_in(banded_attention_fwd_mma_kernel, smem,
                    opted_in[0]);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TQ - 1) / TQ, B * H);
  if (wide)
    banded_attention_fwd_mma_wide_kernel
        <<<grid, NT, smem, (cudaStream_t)stream>>>(q, kpad, vpad, rel, out,
                                                   probs, L, H, D, W);
  else
    banded_attention_fwd_mma_kernel
        <<<grid, NT, smem, (cudaStream_t)stream>>>(q, kpad, vpad, rel, out,
                                                   probs, L, H, D, W);
  return (int)cudaGetLastError();
}
