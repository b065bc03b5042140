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
//   pass 1 (`bwd_partials_kernel`): a block owns one (b, h) and TQ query
//     rows. It writes dq for its rows, and per-tile partials of dk and dv
//     over its TQ + W - 1 context rows and of drel over (Dh, W).
//   pass 2 (`bwd_overlap_add_kernel`, `bwd_drel_sum_kernel`): each output
//     row of dk / dv adds the partials of the (at most two) tiles whose
//     context covers it, in tile order; drel sums its partials over batch
//     and tiles in a fixed order.
//
// Operand types. `T` is the type of q, kpad, vpad, dO, dq, dk and dv: float,
// or __nv_bfloat16 for the mixed-precision model. rel, drel and the partials
// are fp32 in both. A bf16 operand is widened to fp32 as it is staged
// (exact), so p and dS are computed in fp32 in both. In bf16, dS is rounded
// to bf16 before the dq, dk and drel products and p before the dv product,
// the rounding points of the Pallas kernel (pallas_attention_bwd.py:114,
// 126, 129); the products accumulate in fp32, and dq, dk and dv are rounded
// to bf16 once, at their stores. The fp32 instance runs the expressions it
// always ran, in the same order.
//
// What bounds it on the H100: bytes. At B=8, L=640, H=4, Dh=229, W=31 the
// function reads q, kpad, vpad, rel, dO and writes dq, dk, dv, drel, about
// 135 MB in fp32 and 68 MB with bf16 operands (0.040 / 0.020 ms at
// 3.35 TB/s), for about 2.1 GFLOP (0.031 ms at the fp32 peak).
//
// What this simple design does about it: pass 1 stages the K and V halos
// (TQ + W - 1 rows), q, dO and rel[h] in shared memory once per tile, so
// the device reads every input about once; the partials it writes (about
// 90 MB at the sizes above, read once more by pass 2) are the price of
// determinism without atomics. The band's skew and unskew are plain
// indexing. In the score phase lane j of a warp owns window offset j (the
// head width 229 is odd, so the lanes reading 31 rows of a 229-float
// stride hit distinct banks); in the gradient phases threads run over the
// feature axis, consecutive threads on consecutive addresses. Heads are
// 229-float slices of a 916-wide row, so rows are not 16-byte aligned:
// all loads are scalar. The ragged last tile is masked (dS = p = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 32;         // query rows per tile
constexpr int NT = 512;        // threads per block (16 warps)
constexpr int MAX_DCHUNK = 8;  // head width <= 32 * 8 = 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as a product of the operand type weighs it: x itself for fp32 operands,
// x rounded to bf16 for bf16 ones (the Pallas kernel's `.astype(q.dtype)`)
template <typename T>
__device__ __forceinline__ float round_if_bf16(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_partials_kernel(const T* __restrict__ q,          // (B, L, H, D)
                    const T* __restrict__ kpad,       // (B, L+W-1, H, D)
                    const T* __restrict__ vpad,       // (B, L+W-1, H, D)
                    const float* __restrict__ rel,    // (H, D, W)
                    const T* __restrict__ dout,       // (B, L, H, D)
                    T* __restrict__ dq,               // (B, L, H, D)
                    float* __restrict__ dk_part,      // (B, H, nT, ctx, D)
                    float* __restrict__ dv_part,      // (B, H, nT, ctx, D)
                    float* __restrict__ drel_part,    // (B, H, nT, D, W)
                    int L, int H, int D, int W) {
  extern __shared__ float smem[];
  const int ctx = TQ + W - 1;
  float* ks = smem;                  // (ctx, D)
  float* vs = ks + ctx * D;          // (ctx, D)
  float* qs = vs + ctx * D;          // (TQ, D)
  float* dos = qs + TQ * D;          // (TQ, D)
  float* rs = dos + TQ * D;          // (D, W)
  float* ps = rs + D * W;            // (TQ, W)
  float* dss = ps + TQ * W;          // (TQ, W)

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int t0 = tile * TQ;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;

#pragma unroll 4
  for (int e = tid; e < ctx * D; e += NT) {
    const int r = e / D, d = e % D;
    const int row = t0 + r;
    const size_t g = ((size_t)b * Lk + row) * row_stride + (size_t)h * D + d;
    ks[e] = row < Lk ? to_f32(kpad[g]) : 0.f;
    vs[e] = row < Lk ? to_f32(vpad[g]) : 0.f;
  }
#pragma unroll 4
  for (int e = tid; e < TQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int t = t0 + r;
    const size_t g = ((size_t)b * L + t) * row_stride + (size_t)h * D + d;
    qs[e] = t < L ? to_f32(q[g]) : 0.f;
    dos[e] = t < L ? to_f32(dout[g]) : 0.f;
  }
  const float* relh = rel + (size_t)h * D * W;
#pragma unroll 4
  for (int e = tid; e < D * W; e += NT) rs[e] = relh[e];
  __syncthreads();

  // phase 1: p and dS per query row; lane j <-> window offset j. They are
  // kept as the products below weigh them (rounded to bf16 for bf16
  // operands): dS feeds only dq, dk and drel, p only dv.
  for (int r = warp; r < TQ; r += NT / 32) {
    const int t = t0 + r;
    float p = 0.f, ds = 0.f;
    if (t < L) {
      const float* qr = qs + r * D;
      const float* dor = dos + r * D;
      float sk = 0.f, sr = 0.f, dp = 0.f;
      if (lane < W) {
        const float* kr = ks + (r + lane) * D;
        const float* vr = vs + (r + lane) * D;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float qd = qr[d];
          sk = fmaf(qd, kr[d], sk);
          sr = fmaf(qd, rs[d * W + lane], sr);
          dp = fmaf(dor[d], vr[d], dp);
        }
      }
      // q.k and q.rel summed apart, then added, as the forward does
      const float s = lane < W ? sk + sr : -INFINITY;
      float m = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e = lane < W ? expf(s - m) : 0.f;
      float z = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
      p = e / z;
      float pdp = p * dp;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) pdp += __shfl_xor_sync(0xffffffffu, pdp, o);
      ds = p * (dp - pdp);
    }
    if (lane < W) {
      ps[r * W + lane] = round_if_bf16<T>(p);
      dss[r * W + lane] = round_if_bf16<T>(ds);
    }
  }
  __syncthreads();

  // phase 2a: dq for the tile's rows; lanes over the feature axis
  for (int r = warp; r < TQ; r += NT / 32) {
    const int t = t0 + r;
    if (t >= L) break;
    float acc[MAX_DCHUNK];
#pragma unroll
    for (int i = 0; i < MAX_DCHUNK; ++i) acc[i] = 0.f;
    for (int j = 0; j < W; ++j) {
      const float dsj = dss[r * W + j];
      const float* kr = ks + (r + j) * D;
#pragma unroll
      for (int i = 0; i < MAX_DCHUNK; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(dsj, kr[d] + rs[d * W + j], acc[i]);
      }
    }
    T* o = dq + ((size_t)b * L + t) * row_stride + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < MAX_DCHUNK; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f32<T>(acc[i]);
    }
  }

  // phase 2b: dk / dv partials over the context rows; context row c takes
  // the tile's query rows r = c - j, j in [0, W)
  const size_t part = ((size_t)blockIdx.y * n_tiles + tile);
  float* dkp = dk_part + part * ctx * D;
  float* dvp = dv_part + part * ctx * D;
  for (int e = tid; e < ctx * D; e += NT) {
    const int c = e / D, d = e % D;
    const int j_lo = c - (TQ - 1) > 0 ? c - (TQ - 1) : 0;
    const int j_hi = c < W - 1 ? c : W - 1;
    float ak = 0.f, av = 0.f;
    for (int j = j_lo; j <= j_hi; ++j) {
      const int r = c - j;
      ak = fmaf(dss[r * W + j], qs[r * D + d], ak);
      av = fmaf(ps[r * W + j], dos[r * D + d], av);
    }
    dkp[e] = ak;
    dvp[e] = av;
  }

  // phase 2c: drel partial (D, W) over the tile's rows
  float* drp = drel_part + part * D * W;
  for (int e = tid; e < D * W; e += NT) {
    const int d = e / W, j = e % W;
    float a = 0.f;
#pragma unroll 8
    for (int r = 0; r < TQ; ++r) a = fmaf(dss[r * W + j], qs[r * D + d], a);
    drp[e] = a;
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

template <typename T>
int launch_partials(const T* q, const T* kpad, const T* vpad,
                    const float* rel, const T* dout, T* dq, float* dk_part,
                    float* dv_part, float* drel_part, int B, int L, int H,
                    int D, int W, int tq, void* stream) {
  if (tq != TQ || W < 1 || W > 32 || D > 32 * MAX_DCHUNK)
    return (int)cudaErrorInvalidValue;
  const int ctx = TQ + W - 1;
  const size_t smem = sizeof(float) * ((size_t)2 * ctx * D + (size_t)2 * TQ * D
                                       + (size_t)D * W + (size_t)2 * TQ * W);
  // Above 48 KB a kernel has to opt in, once per device and instance: the
  // largest size asked for so far is kept, so a launch makes no call for it
  // again.
  static size_t opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(bwd_partials_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  dim3 grid((L + TQ - 1) / TQ, B * H);
  bwd_partials_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
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
  return launch_partials<float>(q, kpad, vpad, rel, dout, dq, dk_part,
                                dv_part, drel_part, B, L, H, D, W, tq,
                                stream);
}

// q, kpad, vpad, dout and dq bf16; rel and the partials fp32.
extern "C" int banded_attention_bwd_partials_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* kpad,
    const __nv_bfloat16* vpad, const float* rel, const __nv_bfloat16* dout,
    __nv_bfloat16* dq, float* dk_part, float* dv_part, float* drel_part,
    int B, int L, int H, int D, int W, int tq, void* stream) {
  return launch_partials<__nv_bfloat16>(q, kpad, vpad, rel, dout, dq,
                                        dk_part, dv_part, drel_part, B, L, H,
                                        D, W, tq, stream);
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
