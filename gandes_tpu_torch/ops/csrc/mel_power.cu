// K2: fused mel power spectrogram (frame + hann window + real DFT + power +
// mel projection) for Hopper, sm_90a.
//
// Replaces the TPU kernel gandes_tpu/ops/pallas_mel.py::_kernel, launched by
// _mel_power_pallas (pl.pallas_call at pallas_mel.py:101). Same function:
// out[m, f] = sum_b fb[m, b] * |sum_k x[f*hop + k] * w[k] * e^{-2 pi i k b / n_fft}|^2
// over the reflect-padded wave x, periodic hann window w, b < n_fft/2 + 1.
//
// What bounds it on this card: operations. At the serve shape (216 frames,
// n_fft 2048, 1025 bins) the DFT is 216*1025*2048*2*2 = 1.8 GFLOP against
// well under 1 MB of samples needed, so f32 FMA issue rate (67 TFLOP/s
// outside the tensor cores) is the roofline; the mel projection adds 57 MFLOP.
//
// Design (simple and exact in f32; no tensor cores, no TMA yet):
// * grid = (frame tiles of BM, frequency tiles of BN): enough CTAs to cover
//   the SMs at 216 frames, where one CTA per frame tile would leave most
//   SMs idle.
// * Each k-step stages BM frames x KC samples into shared memory straight
//   from the wave at frame*hop + k, reflecting at both ends in the index
//   math: the frame matrix and the padded wave are never materialised (the
//   TPU kernel needed both because Mosaic cannot load at arbitrary offsets).
// * The hann-windowed cos/-sin bases (built once per n_fft in float64 and
//   cast to f32 by the wrapper, resident on the device) are staged tile by
//   tile; each thread keeps a 2-frame x 4-bin register tile of re and im.
// * Epilogue: power = re^2 + im^2 into shared memory, then each thread
//   projects the tile's bins onto one mel row for the CTA's frames.
// * Frequency tiles write partial mel sums; a second kernel adds them in a
//   fixed order (deterministic, no atomics) and writes (n_mels, n_frames).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;       // frames per CTA
constexpr int BN = 64;       // frequency bins per CTA
constexpr int KC = 32;       // samples per k-step
constexpr int TM = 2;        // frames per thread
constexpr int TN = 4;        // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128

__device__ __forceinline__ float reflected_sample(const float* __restrict__ wave,
                                                  long long n, long long g, int pad) {
  // g indexes the wave padded by `pad` reflected samples on each side
  long long x = g - pad;
  if (x < 0) x = -x;
  if (x >= n) x = 2 * (n - 1) - x;
  return wave[x];
}

__global__ void __launch_bounds__(THREADS)
dft_power_mel_kernel(const float* __restrict__ wave, long long n_samples, int pad,
                     int hop, int n_frames, int n_fft,
                     const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                     int n_freqs_pad, const float* __restrict__ fb_t, int n_mels,
                     float* __restrict__ partial) {
  __shared__ float As[BM][KC + 1];  // +1: conflict-free column reads
  __shared__ __align__(16) float Cs[KC][BN];
  __shared__ __align__(16) float Ss[KC][BN];
  __shared__ __align__(16) float Ps[BM][BN];

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int f0 = blockIdx.x * BM;
  const int b0 = blockIdx.y * BN;

  float re[TM][TN], im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n_fft; k0 += KC) {
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int f = e / KC, k = e % KC;
      const int frame = f0 + f;
      As[f][k] = frame < n_frames
                     ? reflected_sample(wave, n_samples, (long long)frame * hop + k0 + k, pad)
                     : 0.f;
    }
    for (int e = tid; e < KC * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const size_t off = (size_t)(k0 + r) * n_freqs_pad + b0 + c;
      *reinterpret_cast<float4*>(&Cs[r][c]) = *reinterpret_cast<const float4*>(cos_b + off);
      *reinterpret_cast<float4*>(&Ss[r][c]) = *reinterpret_cast<const float4*>(sin_b + off);
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][k];
      const float4 c4 = *reinterpret_cast<const float4*>(&Cs[k][tx * TN]);
      const float4 s4 = *reinterpret_cast<const float4*>(&Ss[k][tx * TN]);
      const float c[TN] = {c4.x, c4.y, c4.z, c4.w};
      const float s[TN] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float4 p;
    p.x = re[i][0] * re[i][0] + im[i][0] * im[i][0];
    p.y = re[i][1] * re[i][1] + im[i][1] * im[i][1];
    p.z = re[i][2] * re[i][2] + im[i][2] * im[i][2];
    p.w = re[i][3] * re[i][3] + im[i][3] * im[i][3];
    *reinterpret_cast<float4*>(&Ps[ty * TM + i][tx * TN]) = p;
  }
  __syncthreads();

  // partial[tile][frame][mel]: consecutive threads write consecutive mels
  float* out_tile = partial + (size_t)blockIdx.y * n_frames * n_mels;
  for (int m = tid; m < n_mels; m += THREADS) {
    float acc[BM];
#pragma unroll
    for (int f = 0; f < BM; ++f) acc[f] = 0.f;
    for (int b = 0; b < BN; ++b) {
      const float w = fb_t[(size_t)(b0 + b) * n_mels + m];
#pragma unroll
      for (int f = 0; f < BM; ++f) acc[f] = fmaf(w, Ps[f][b], acc[f]);
    }
#pragma unroll
    for (int f = 0; f < BM; ++f) {
      if (f0 + f < n_frames) out_tile[(size_t)(f0 + f) * n_mels + m] = acc[f];
    }
  }
}

__global__ void mel_reduce_kernel(const float* __restrict__ partial, int n_tiles,
                                  int n_frames, int n_mels, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // frame * n_mels + mel
  const int total = n_frames * n_mels;
  if (idx >= total) return;
  float s = 0.f;
  for (int j = 0; j < n_tiles; ++j) s += partial[(size_t)j * total + idx];
  const int f = idx / n_mels, m = idx % n_mels;
  out[(size_t)m * n_frames + f] = s;
}

}  // namespace

extern "C" {

// Shapes the wrapper guarantees: n_fft % KC == 0, n_freqs_pad % BN == 0,
// cos_b/sin_b (n_fft, n_freqs_pad), fb_t (n_freqs_pad, n_mels) with zero rows
// past the real bins, partial (n_freqs_pad / BN, n_frames, n_mels),
// out (n_mels, n_frames), pad < n_samples. Returns a cudaError_t.
int mel_power_launch(const float* wave, long long n_samples, int pad, int hop,
                     int n_frames, int n_fft, const float* cos_b, const float* sin_b,
                     int n_freqs_pad, const float* fb_t, int n_mels, float* partial,
                     float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_freqs_pad / BN;
  const dim3 grid((n_frames + BM - 1) / BM, n_tiles);
  dft_power_mel_kernel<<<grid, THREADS, 0, st>>>(wave, n_samples, pad, hop, n_frames,
                                                 n_fft, cos_b, sin_b, n_freqs_pad, fb_t,
                                                 n_mels, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_frames * n_mels;
  mel_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(partial, n_tiles, n_frames,
                                                         n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

const char* mel_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mel_power_tile_constants(int which) {
  // 0: KC (n_fft granularity), 1: BN (frequency padding granularity)
  return which == 0 ? KC : BN;
}

}  // extern "C"
