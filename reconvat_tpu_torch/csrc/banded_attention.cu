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
// ~41 MB, for ~0.9 GFLOP.
//
// The design is the Pallas kernel's, in the tiles of the backward's first
// passes (csrc/mma_tiles.cuh). A block owns one (b, h) and TQ = 32 query
// rows; its K and V context (TQ + W - 1 rows) is padded to KC = 64 rows.
//   1. Q, the K context and rel[h]^T are staged in shared memory, and the
//      loads of the V context are issued before the score products, to be
//      stored after the softmax (the Pallas kernel's `copy_v`): fp32 rows by
//      4-byte cp.async (the head slices are 4-byte aligned) in two groups,
//      bf16 rows (2-byte aligned) through registers.
//   2. S = Q K^T (TQ x KC) and Q rel^T (TQ x WP) on the tensor cores, kept
//      apart and added at the band, as the plain version adds q.k and
//      q.rel: in bf16 by ldmatrix + m16n8k16 with rel as three exact bf16
//      terms, in fp32 as 3xTF32.
//   3. The band and the softmax per query row on the CUDA cores, lane j <->
//      window offset j; p goes to probs and into a dense P tile (p at
//      [r, r + j], zero elsewhere and at rows past L), rounded to bf16 there
//      for bf16 operands.
//   4. out = P V (TQ x Dh) on the tensor cores, stored through a per-warp
//      shared-memory patch as the operand type, rounded once.
// The context's rows past kpad and its padded columns are zero, so every
// product reads finite values. The CPU models of these tiles are
// `banded_attention_fwd_tf32x3_plain` and `banded_attention_fwd_mma_plain`
// in ops/banded_attention_kernel.py.
#include "mma_tiles.cuh"

namespace {

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

// bytes of shared memory the fp32 kernel takes at head width D: Q, K,
// rel^T and V (fp32), S (then P) and Q rel^T
__host__ __device__ constexpr size_t fwd_tf32x3_smem_bytes(int D) {
  return sizeof(float)
         * ((size_t)(TQ + WP + KC) * tf32_pitch(D)
            + k_tile_elems(tf32_pitch(D), sizeof(float))
            + TQ * (LDS32 + LDR32));
}

// bytes of shared memory the bf16 kernel takes at head width D: Q, K, V,
// rel^T in three terms and P (bf16), then S and Q r_i^T (fp32)
__host__ __device__ constexpr size_t fwd_mma_smem_bytes(int D) {
  return sizeof(bf16) * ((size_t)(TQ + KC + 3 * WP) * mma_pitch(D)
                         + k_tile_elems(mma_pitch(D), sizeof(bf16))
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
  if (W < 1 || W > 32 || D < 1 || D > 32 * MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  static size_t opted_in[64] = {};
  const size_t smem = fwd_tf32x3_smem_bytes(D);
  cudaError_t err = opt_in(banded_attention_fwd_tf32x3_kernel, smem, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TQ - 1) / TQ, B * H);
  banded_attention_fwd_tf32x3_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, kpad, vpad, rel, out, probs, L, H, D, W);
  return (int)cudaGetLastError();
}

// q, kpad, vpad and out bf16; rel and probs fp32.
extern "C" int banded_attention_fwd_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* kpad,
    const __nv_bfloat16* vpad, const float* rel, __nv_bfloat16* out,
    float* probs, int B, int L, int H, int D, int W, void* stream) {
  if (W < 1 || W > 32 || D < 1 || D > 32 * MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  static size_t opted_in[64] = {};
  const size_t smem = fwd_mma_smem_bytes(D);
  cudaError_t err = opt_in(banded_attention_fwd_mma_kernel, smem, opted_in);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TQ - 1) / TQ, B * H);
  banded_attention_fwd_mma_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, kpad, vpad, rel, out, probs, L, H, D, W);
  return (int)cudaGetLastError();
}
