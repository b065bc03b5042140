// Fused STFT power + mel projection for Hopper (sm_90a), fp32, with the
// DFT of each frame computed as a 2048-point FFT in shared memory.
//
// Replaces the TPU kernel `_mel_kernel` of reconvat_tpu/ops/pallas_mel.py
// (launched by `PallasMelSpectrogram.__call__`). It computes, for audio
// (B, N):
//
//   frame t, sample n = audio[reflect(t*hop - pad + n)]      (centre pad)
//   X[t, f] = sum_n frame[t, n] * window[n] * exp(-2 pi i f n / n_fft)
//   out[b, t, m] = sum_f |X[t, f]|^2 * mel[f, m]             (mel projection)
//
// What bounds it on the H100: the bytes it must move (audio in, mel out,
// the basis once: 16 MB at B=8 x 640 frames), since the operations are few.
// The DFT bases are constants (a window times cos/sin), so an FFT does the
// work of the (frames x 2048) by (2048 x 2*1025) GEMM of the TPU design, 43
// GFLOP at that size, in about 0.3 GFLOP; the mel filters are triangles, so
// the projection needs the 2,025 nonzeros of the 1025 x 229 basis only.
// What keeps the kernel above that bound is shared-memory traffic (every
// FFT pass reads and writes 16 KB of complex values) and the latency of
// what a block reads from global memory before and after its FFTs.
//
// What this design does about it. A block owns TF consecutive frames of one
// batch row and never leaves the SM between the audio and the mel output:
//   1. it stages the frames' audio span, (TF-1)*hop + n_fft samples (the
//      frames overlap by 75 %), and the twiddle table with asynchronous
//      copies that are all in flight at once, with reflect addressing at
//      the clip's ends: no padded or framed copy exists in global memory.
//      What only later frames need lands while the first are transformed;
//   2. two real frames per complex FFT: frame t, windowed, is the real part
//      and frame t+1 the imaginary part of the work buffer;
//   3. Stockham autosort passes between two buffers (no bit reversal, one
//      barrier per pass, reads contiguous across threads): five of radix 4,
//      two butterflies per thread, twiddles from the table that the caller
//      computed in float64 (no sincos in the kernel, no fast-math). The
//      buffers are indexed through an XOR swizzle that keeps the first two
//      passes' strided writes off each other's banks;
//   4. the last pass (radix 2, twiddle 1) is fused with the unpacking of
//      the two frames' spectra and with power re^2 + im^2 of bins
//      0..n_fft/2 into a tile P[TF][n_fft/2+1]: the spectrum never leaves
//      the SM;
//   5. thread m owns mel column m and TF accumulators and sums, in order,
//      over that column's nonzero rows [lo_m, hi_m) only, which the caller
//      computed from the basis it passes (a dense basis gives (0, n_freq)
//      and is still right, only slower).
// One block writes each output row once, in a fixed order: deterministic,
// no atomics, no partial sums in global memory, one kernel. A ragged last
// tile of frames is masked. At TF = 10 a block takes 106 KB of shared
// memory, two blocks share an SM, and B=8 x 640 frames is 512 blocks: 1.94
// waves of the card's 264 places.
#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 2048;
constexpr int HALF = N_FFT / 2;
constexpr int QUARTER = N_FFT / 4;
constexpr int N_FREQ = HALF + 1;
constexpr int NT = 256;   // threads per block
constexpr int TF = 10;    // frames per block
static_assert(TF % 2 == 0, "frames are transformed in pairs");
static_assert(QUARTER % NT == 0 && HALF % NT == 0, "whole passes per thread");

__device__ __forceinline__ int reflect_index(int i, int n) {
  // numpy/jnp 'reflect' (edge sample not repeated); needs n > pad.
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// asynchronous copy global -> shared (no register, no wait until asked)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int PENDING>   // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING));
}

// Work-buffer position of complex element i: the low four bits (the 8-byte
// bank of a half-warp's access) XORed with bits 2..5. A half-warp varies
// bits 2..5 in the first radix-4 pass's writes, bits 0,1,4,5 in the
// second's, and bits 0..3 in later writes and in every read; each of these
// lands on 16 distinct banks.
__device__ __forceinline__ int phys(int i) { return i ^ ((i >> 2) & 15); }

// Shared memory, in floats: two complex work buffers, the twiddle table,
// the power tile and the audio span.
constexpr size_t smem_bytes(int hop) {
  return sizeof(float) * (size_t)(2 * 2 * N_FFT + 2 * HALF + TF * N_FREQ +
                                  (TF - 1) * hop + N_FFT);
}

__global__ void __launch_bounds__(NT)
mel_fft_kernel(const float* __restrict__ audio,
               const float* __restrict__ window,     // (N_FFT)
               const float2* __restrict__ twiddle,   // (HALF) cos, -sin
               const float* __restrict__ melb,       // (N_FREQ, n_mels)
               const int2* __restrict__ band,        // (n_mels) lo, hi
               float* __restrict__ out,              // (B, n_frames, n_mels)
               int n_samples, int n_frames, int hop, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  float2* work0 = reinterpret_cast<float2*>(smem);
  float2* work1 = work0 + N_FFT;
  float2* tw = work1 + N_FFT;
  float* P = reinterpret_cast<float*>(tw + HALF);
  float* span = P + TF * N_FREQ;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TF;
  const int b = blockIdx.y;
  const int nt = min(TF, n_frames - t0);   // frames of this tile
  const float* x = audio + (size_t)b * n_samples;

  // Stage the twiddles and the audio span (only the clip's first and last
  // frames reach the reflection) in two groups: what the first pair of
  // frames needs, and the rest.
  const int s0 = t0 * hop - HALF;
  const int n_span = (nt - 1) * hop + N_FFT;
  const int n_first = min(n_span, hop + N_FFT);
  for (int i = tid; i < HALF; i += NT) cp_async<8>(tw + i, twiddle + i);
  for (int i = tid; i < n_first; i += NT)
    cp_async<4>(span + i, x + reflect_index(s0 + i, n_samples));
  cp_async_commit();
  for (int i = n_first + tid; i < n_span; i += NT)
    cp_async<4>(span + i, x + reflect_index(s0 + i, n_samples));
  cp_async_commit();

  for (int t = 0; t < nt; t += 2) {
    if (t == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    // Every thread's copies have landed. Behind this barrier no thread
    // still reads work1 (the previous pair's spectrum); work0 was last
    // read before the last pass's barrier.
    __syncthreads();
    // frame t in the real part, frame t + 1 (zero past the last frame) in
    // the imaginary part
    const bool pair = t + 1 < nt;
    const float* fa = span + t * hop;
    const float* fb = fa + hop;
    for (int i = tid; i < N_FFT; i += NT) {
      const float w = __ldg(window + i);
      work0[phys(i)] = make_float2(fa[i] * w, pair ? fb[i] * w : 0.f);
    }
    __syncthreads();

    float2* src = work0;
    float2* dst = work1;
#pragma unroll
    for (int pass = 0; pass < 5; ++pass) {
      const int s = 1 << (2 * pass);   // stride; sub-length n = N_FFT / s
#pragma unroll
      for (int r = 0; r < QUARTER / NT; ++r) {
        const int j = tid + r * NT;    // j = p * s + q
        const int q = j & (s - 1);
        const int ps = j - q;
        const float2 a0 = src[phys(j)];
        const float2 a1 = src[phys(j + QUARTER)];
        const float2 a2 = src[phys(j + 2 * QUARTER)];
        const float2 a3 = src[phys(j + 3 * QUARTER)];
        const float2 u0 = cadd(a0, a2);
        const float2 u1 = csub(a0, a2);
        const float2 u2 = cadd(a1, a3);
        const float2 u3 = make_float2(a1.y - a3.y, a3.x - a1.x);  // -i(a1-a3)
        const float2 w1 = tw[ps];       // w^p, w = exp(-2 pi i / n)
        const float2 w2 = tw[2 * ps];   // w^2p
        // w^3p: the table holds half the circle, the other half is minus it
        float2 w3 = tw[(3 * ps) & (HALF - 1)];
        if (3 * ps >= HALF) w3 = make_float2(-w3.x, -w3.y);
        const int o = 4 * j - 3 * q;    // q + s * 4 * p
        dst[phys(o)] = cadd(u0, u2);
        dst[phys(o + s)] = cmul(cadd(u1, u3), w1);
        dst[phys(o + 2 * s)] = cmul(csub(u0, u2), w2);
        dst[phys(o + 3 * s)] = cmul(csub(u1, u3), w3);
      }
      __syncthreads();
      float2* tmp = src;
      src = dst;
      dst = tmp;
    }
    // The last pass (radix 2, stride N/2, twiddle 1) is Z[k] = y[k] +
    // y[k + N/2], Z[k + N/2] = y[k] - y[k + N/2]. It is fused with the
    // unpacking of the two frames, X_a[k] = (Z[k] + conj Z[N-k]) / 2 and
    // X_b[k] = (Z[k] - conj Z[N-k]) / 2i, and with their power.
    float* pa = P + t * N_FREQ;
    float* pb = pa + N_FREQ;
    for (int k = tid; k < HALF; k += NT) {
      const float2 zk = cadd(src[phys(k)], src[phys(k + HALF)]);
      float2 zn = zk;   // k = 0: Z[0] is its own partner
      if (k > 0) zn = csub(src[phys(HALF - k)], src[phys(N_FFT - k)]);
      const float ar = zk.x + zn.x, ai = zk.y - zn.y;
      const float br = zk.y + zn.y, bi = zk.x - zn.x;
      pa[k] = 0.25f * (ar * ar + ai * ai);
      pb[k] = 0.25f * (br * br + bi * bi);
    }
    if (tid == 0) {     // k = N/2: Z[N/2] is its own partner
      const float2 z = csub(src[phys(0)], src[phys(HALF)]);
      pa[HALF] = z.x * z.x;
      pb[HALF] = z.y * z.y;
    }
  }
  __syncthreads();

  for (int m = tid; m < n_mels; m += NT) {
    const int2 lh = band[m];
    float acc[TF];
#pragma unroll
    for (int t = 0; t < TF; ++t) acc[t] = 0.f;
    for (int f = lh.x; f < lh.y; ++f) {
      const float w = __ldg(melb + (size_t)f * n_mels + m);
#pragma unroll
      for (int t = 0; t < TF; ++t) acc[t] = fmaf(P[t * N_FREQ + f], w, acc[t]);
    }
    float* orow = out + ((size_t)b * n_frames + t0) * n_mels + m;
#pragma unroll
    for (int t = 0; t < TF; ++t)
      if (t < nt) orow[(size_t)t * n_mels] = acc[t];
  }
}

}  // namespace

// window (n_fft), twiddle (n_fft / 2, 2) = cos, -sin of 2 pi k / n_fft,
// melb (n_fft / 2 + 1, n_mels), band (n_mels, 2) int32 = first and one past
// last nonzero row of each mel column; centre pad n_fft / 2.
extern "C" int mel_power_launch(const float* audio, const float* window,
                                const float* twiddle, const float* melb,
                                const int* band, float* out, int batch,
                                int n_samples, int n_frames, int n_fft,
                                int hop, int n_mels, void* stream) {
  if (n_fft != N_FFT || hop < 1 || n_samples <= HALF)
    return (int)cudaErrorInvalidValue;
  // Above 48 KB a kernel has to opt in, once per device: the largest size
  // asked for so far is kept, so a launch makes no call for it again. A hop
  // too large for the card's shared memory is refused here.
  static size_t opted_in[64] = {};
  const size_t smem = smem_bytes(hop);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || opted_in[device] < smem) {
    err = cudaFuncSetAttribute(
        mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) opted_in[device] = smem;
  }
  const dim3 grid((n_frames + TF - 1) / TF, batch);
  mel_fft_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      audio, window, reinterpret_cast<const float2*>(twiddle), melb,
      reinterpret_cast<const int2*>(band), out, n_samples, n_frames, hop,
      n_mels);
  return (int)cudaGetLastError();
}
