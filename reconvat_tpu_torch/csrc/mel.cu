// Fused STFT power + mel projection for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_mel_kernel` of reconvat_tpu/ops/pallas_mel.py
// (launched by `PallasMelSpectrogram.__call__`). It computes, for audio
// (B, N):
//
//   frame t, sample n = audio[reflect(t*hop - pad + n)]      (centre pad)
//   re[t, f] = sum_n frame[t, n] * wcos[n, f]                (windowed DFT)
//   im[t, f] = sum_n frame[t, n] * wsin[n, f]
//   out[b, t, m] = sum_f (re^2 + im^2)[t, f] * mel[f, m]     (mel projection)
//
// What bounds it on the H100: operations. At B=8 x 640 frames the DFT is
// 2 * 640 * 2048 * 1025 * 2 flop per item plus 640 * 1025 * 229 * 2 for the
// mel projection, about 45 GFLOP in all, against some 33 MB of traffic, so
// the fp32 CUDA cores (not memory) set the floor.
//
// What this design does about it. The DFT is a GEMM of (frames x n_fft) by
// (n_fft x 2 * bins), far too little work per batch row to fill 132 SMs if
// a block owned all bins of its frames, so a block owns TM frames of one
// batch row and ONE chunk of TF frequency bins:
//   1. a shared-memory tiled fp32 GEMM over the n_fft samples, double
//      buffered (the next tile's global loads are in flight while the
//      current tile is multiplied), with a 4 frames x 4 bins register tile
//      per thread for both re and im, fed by 16-byte shared-memory loads;
//   2. power = re^2 + im^2 into a shared-memory tile (the spectrum never
//      leaves the SM);
//   3. that chunk's share of the mel projection, written as a partial sum.
// A second small kernel adds the chunks' partials in a fixed order, so the
// result is deterministic (no atomics). Frames are read straight from the
// unpadded audio with reflect addressing: no padded or framed copy exists.
// Ragged edges (1025 bins, 229 mels, the last frame tile) are masked. No
// tensor cores: fp32 parity with the reference comes first; a wgmma or
// 3xTF32 version is later work.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // frames per block
constexpr int TF = 64;        // frequency bins per block
constexpr int TK = 16;        // DFT samples per shared-memory stage
constexpr int NT = 256;       // threads per block
constexpr int AS_LD = TM + 4; // padded row: 16-byte aligned, fewer conflicts
constexpr int MEL_COLS = 8;   // mel columns per lane: 32 * 8 = 256 >= n_mels
constexpr int MEL_ROWS = TM / (NT / 32);  // frames per warp, mel stage
constexpr int A_PER_T = TM * TK / NT;     // frame samples loaded per thread
constexpr int B_PER_T = TK * TF / NT;     // basis values (each) per thread

__device__ __forceinline__ int reflect_index(int i, int n) {
  // numpy/jnp 'reflect' (edge sample not repeated); needs n > pad.
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(NT)
mel_partial_kernel(const float* __restrict__ audio,
                   const float* __restrict__ wcos,   // (n_fft, n_freq)
                   const float* __restrict__ wsin,   // (n_fft, n_freq)
                   const float* __restrict__ melb,   // (n_freq, n_mels)
                   float* __restrict__ partial,      // (chunks, B, T, n_mels)
                   int batch, int n_samples, int n_frames, int n_fft,
                   int hop, int pad, int n_freq, int n_mels) {
  __shared__ __align__(16) float As[2][TK][AS_LD];  // frame samples, k-major
  __shared__ __align__(16) float Bc[2][TK][TF];
  __shared__ __align__(16) float Bs[2][TK][TF];
  __shared__ float P[TM][TF + 1];                   // power tile

  const int t0 = blockIdx.x * TM;
  const int b = blockIdx.y;
  const int chunk = blockIdx.z;
  const int f0 = chunk * TF;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;      // DFT: bins tx*4.., frames ty*4..
  const int lane = tid % 32, warp = tid / 32;  // mel stage
  const float* x = audio + (size_t)b * n_samples;

  float ra[A_PER_T], rc[B_PER_T], rs[B_PER_T];  // next tile, in flight

  auto load_tile = [&](int n0) {
#pragma unroll
    for (int r = 0; r < A_PER_T; ++r) {
      const int e = tid + r * NT;
      const int m = e / TK, k = e % TK;
      const int t = t0 + m;
      ra[r] = t < n_frames
                  ? x[reflect_index(t * hop - pad + n0 + k, n_samples)]
                  : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_PER_T; ++r) {
      const int e = tid + r * NT;
      const int k = e / TF, f = e % TF;
      const bool ok = f0 + f < n_freq;
      const size_t g = (size_t)(n0 + k) * n_freq + f0 + f;
      rc[r] = ok ? wcos[g] : 0.f;
      rs[r] = ok ? wsin[g] : 0.f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_PER_T; ++r) {
      const int e = tid + r * NT;
      As[buf][e % TK][e / TK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_PER_T; ++r) {
      const int e = tid + r * NT;
      Bc[buf][e / TF][e % TF] = rc[r];
      Bs[buf][e / TF][e % TF] = rs[r];
    }
  };

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  const int n_tiles = n_fft / TK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_tiles) load_tile((kt + 1) * TK);
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Bc[cur][k][tx * 4]);
      const float4 s = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(av[i], cv[j], re[i][j]);
          im[i][j] = fmaf(av[i], sv[j], im[i][j]);
        }
    }
    // the other buffer was last read in iteration kt-1, which ended in a
    // barrier, so it can be refilled now
    if (kt + 1 < n_tiles) store_tile(cur ^ 1);
    __syncthreads();
  }

  // power tile (bins past n_freq hold exactly zero: their basis was zero)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[ty * 4 + i][tx * 4 + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
  __syncthreads();

  // this chunk's mel partial: warp w owns frames w*MEL_ROWS.., lane owns mel
  // columns lane + 32*j
  float acc[MEL_ROWS][MEL_COLS];
#pragma unroll
  for (int i = 0; i < MEL_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MEL_COLS; ++j) acc[i][j] = 0.f;
  const int fn = min(TF, n_freq - f0);
  for (int f = 0; f < fn; ++f) {
    const float* mrow = melb + (size_t)(f0 + f) * n_mels;
    float mv[MEL_COLS];
#pragma unroll
    for (int j = 0; j < MEL_COLS; ++j) {
      const int col = lane + 32 * j;
      mv[j] = col < n_mels ? __ldg(mrow + col) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MEL_ROWS; ++i) {
      const float p = P[warp * MEL_ROWS + i][f];
#pragma unroll
      for (int j = 0; j < MEL_COLS; ++j) acc[i][j] = fmaf(p, mv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_ROWS; ++i) {
    const int t = t0 + warp * MEL_ROWS + i;
    if (t >= n_frames) continue;
    float* orow =
        partial + (((size_t)chunk * batch + b) * n_frames + t) * n_mels;
#pragma unroll
    for (int j = 0; j < MEL_COLS; ++j) {
      const int col = lane + 32 * j;
      if (col < n_mels) orow[col] = acc[i][j];
    }
  }
}

// out[i] = sum over chunks of partial[c][i], in chunk order
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, size_t n,
                                  int chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[(size_t)c * n + i];
    out[i] = s;
  }
}

}  // namespace

extern "C" int mel_power_chunks(int n_freq) { return (n_freq + TF - 1) / TF; }

// partial: scratch of mel_power_chunks(n_freq) * batch * n_frames * n_mels
// floats, allocated by the caller.
extern "C" int mel_power_launch(const float* audio, const float* wcos,
                                const float* wsin, const float* melb,
                                float* partial, float* out, int batch,
                                int n_samples, int n_frames, int n_fft,
                                int hop, int pad, int n_freq, int n_mels,
                                void* stream) {
  if (n_mels > 32 * MEL_COLS || n_fft % TK != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = mel_power_chunks(n_freq);
  const dim3 grid((n_frames + TM - 1) / TM, batch, chunks);
  mel_partial_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      audio, wcos, wsin, melb, partial, batch, n_samples, n_frames, n_fft,
      hop, pad, n_freq, n_mels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)batch * n_frames * n_mels;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_chunks_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(partial, out, n,
                                                              chunks);
  return (int)cudaGetLastError();
}
