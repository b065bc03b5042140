// Banded (window-W) local attention forward for Hopper (sm_90a), with fp32
// or bf16 operands.
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
// On the TPU the relative bias is a skewed (strided-roll) tile and the band
// a mask over a dense (block, ctx) score tile; here both are plain indexing
// and only the W in-band scores are ever computed.
//
// Operand types. `T` is the type of q, kpad, vpad and out: float, or
// __nv_bfloat16 for the mixed-precision model. rel and probs are fp32 in
// both. A bf16 operand is widened to fp32 as it is read (exact), so the
// scores, the softmax and the PV sums are fp32 in both; in bf16, p is
// rounded to bf16 before the PV product (the JAX package casts probs to v's
// dtype there) and out is rounded to bf16 once, at the store. probs holds p
// before that rounding. The fp32 instance does the arithmetic it always did.
//
// What bounds it on the H100: bytes. At B=8, L=640, H=4, Dh=229, W=31 the
// fp32 kernel moves ~79 MB (q, kpad, vpad, out, probs), the bf16 one ~41 MB,
// for ~0.9 GFLOP.
//
// What this simple design does about it: a block owns one (b, h) and TQ
// query rows. It stages the K halo (TQ + W - 1 rows), the q tile and rel[h]
// in shared memory once, as fp32, so each key row is read from device memory
// once per tile instead of once per query. Each warp takes one query row at a
// time: lane j computes score j (reading key row t+j; the head width 229 is
// odd, so the 32 lanes fall on 32 distinct banks), the softmax is a warp
// shuffle reduction, and for the output the lanes switch to the feature axis
// and read the V rows straight from device memory (consecutive lanes,
// consecutive addresses; each V row is reused by W queries through L1/L2).
// Heads are 229-element slices of a 916-wide row, so rows are not 16-byte
// aligned in either type: all loads are scalar. The last tile is ragged and
// masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 16;      // query rows per block
constexpr int NT = 256;     // threads per block (8 warps)
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

// p as the PV product weighs V row j: p itself for fp32 operands, p rounded
// to the operand type otherwise
template <typename T>
__device__ __forceinline__ float pv_weight(float p) {
  return to_f32(from_f32<T>(p));
}

template <typename T>
__global__ void __launch_bounds__(NT)
banded_attention_fwd_kernel(const T* __restrict__ q,         // (B, L, H, D)
                            const T* __restrict__ kpad,      // (B, L+W-1, H, D)
                            const T* __restrict__ vpad,      // (B, L+W-1, H, D)
                            const float* __restrict__ rel,   // (H, D, W)
                            T* __restrict__ out,             // (B, L, H, D)
                            float* __restrict__ probs,       // (B, L, H, W)
                            int L, int H, int D, int W) {
  extern __shared__ float smem[];
  const int ctx = TQ + W - 1;
  float* ks = smem;                  // (ctx, D)
  float* qs = ks + ctx * D;          // (TQ, D)
  float* rs = qs + TQ * D;           // (D, W)

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int t0 = blockIdx.x * TQ;
  const int Lk = L + W - 1;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row_stride = (size_t)H * D;

#pragma unroll 4
  for (int e = tid; e < ctx * D; e += NT) {
    const int r = e / D, d = e % D;
    const int row = t0 + r;
    ks[e] = row < Lk
        ? to_f32(kpad[((size_t)b * Lk + row) * row_stride + (size_t)h * D + d])
        : 0.f;
  }
#pragma unroll 4
  for (int e = tid; e < TQ * D; e += NT) {
    const int r = e / D, d = e % D;
    const int t = t0 + r;
    qs[e] = t < L
        ? to_f32(q[((size_t)b * L + t) * row_stride + (size_t)h * D + d])
        : 0.f;
  }
  const float* relh = rel + (size_t)h * D * W;
#pragma unroll 4
  for (int e = tid; e < D * W; e += NT) rs[e] = relh[e];
  __syncthreads();

  for (int r = warp; r < TQ; r += NT / 32) {
    const int t = t0 + r;
    if (t >= L) break;
    const float* qr = qs + r * D;

    // scores: lane j <-> window offset j; q.k and q.rel summed apart, then
    // added, as the reference forms scores + bias
    float sk = 0.f, sr = 0.f;
    if (lane < W) {
      const float* kr = ks + (r + lane) * D;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = qr[d];
        sk = fmaf(qd, kr[d], sk);
        sr = fmaf(qd, rs[d * W + lane], sr);
      }
    }
    const float s = lane < W ? sk + sr : -INFINITY;
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = lane < W ? expf(s - m) : 0.f;
    float z = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    const float p = e / z;

    const size_t orow = (((size_t)b * L + t) * H + h);
    if (lane < W) probs[orow * W + lane] = p;

    // out: lanes over the feature axis
    float acc[MAX_DCHUNK];
#pragma unroll
    for (int i = 0; i < MAX_DCHUNK; ++i) acc[i] = 0.f;
    const T* vbase = vpad + ((size_t)b * Lk + t) * row_stride + (size_t)h * D;
#pragma unroll 4
    for (int j = 0; j < W; ++j) {  // unrolled: several V rows in flight
      const float pj = pv_weight<T>(__shfl_sync(0xffffffffu, p, j));
      const T* vr = vbase + (size_t)j * row_stride;
#pragma unroll
      for (int i = 0; i < MAX_DCHUNK; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, to_f32(__ldg(vr + d)), acc[i]);
      }
    }
    T* o = out + orow * D;
#pragma unroll
    for (int i = 0; i < MAX_DCHUNK; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[d] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T>
int launch(const T* q, const T* kpad, const T* vpad, const float* rel, T* out,
           float* probs, int B, int L, int H, int D, int W, void* stream) {
  if (W < 1 || W > 32 || D > 32 * MAX_DCHUNK) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(TQ + W - 1) * D + (size_t)TQ * D
                                       + (size_t)D * W);
  // Above 48 KB a kernel has to opt in, once per device and instance: the
  // largest size asked for so far is kept, so a launch makes no call for it
  // again.
  static size_t opted_in[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(banded_attention_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  dim3 grid((L + TQ - 1) / TQ, B * H);
  banded_attention_fwd_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      q, kpad, vpad, rel, out, probs, L, H, D, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int banded_attention_fwd_launch(const float* q, const float* kpad,
                                           const float* vpad, const float* rel,
                                           float* out, float* probs, int B,
                                           int L, int H, int D, int W,
                                           void* stream) {
  return launch<float>(q, kpad, vpad, rel, out, probs, B, L, H, D, W, stream);
}

// q, kpad, vpad and out bf16; rel and probs fp32.
extern "C" int banded_attention_fwd_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* kpad,
    const __nv_bfloat16* vpad, const float* rel, __nv_bfloat16* out,
    float* probs, int B, int L, int H, int D, int W, void* stream) {
  return launch<__nv_bfloat16>(q, kpad, vpad, rel, out, probs, B, L, H, D, W,
                               stream);
}
