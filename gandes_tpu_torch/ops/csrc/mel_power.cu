// K2: fused mel power spectrogram (frame + hann window + real FFT + power +
// sparse mel projection) for Hopper, sm_90a. One launch per call.
//
// Replaces the TPU kernel gandes_tpu/ops/pallas_mel.py::_kernel, launched by
// _mel_power_pallas (pl.pallas_call at pallas_mel.py:101). Same function:
// out[m, f] = sum_b fb[m, b] * |sum_k x[f*hop + k] * w[k] * e^{-2 pi i k b / n_fft}|^2
// over the reflect-padded wave x, periodic hann window w, b < n_fft/2 + 1.
//
// What bounds it on this card: latency and bytes, not operations. A real FFT
// per frame is ~12 MFLOP at the serve shape (216 frames, n_fft 2048), and the
// bound (wave read once, output written once) is ~0.56 us, below launch
// latency. The Pallas kernel evaluated the DFT as dense matmuls because the
// TPU's matrix unit makes that cheap; here that was 1.8 GFLOP and 17.8 MB of
// cos/sin bases streamed from L2 by every CTA. Nothing in an FFT is a product
// large enough to feed wgmma, and TMA has no tile to move: the resource that
// matters is shared memory, which holds the whole transform of a frame.
//
// Design:
// * grid = one CTA of 256 threads per frame; the frame's samples are read
//   from the wave at frame*hop + k - n_fft/2 with the reflection in the index
//   math (no padded copy, no frame matrix), multiplied by the window table
//   and packed as n_fft/2 complex values z[n] = x[2n] + i x[2n+1].
// * A Stockham autosort FFT of N = n_fft/2 points in shared memory (two
//   N-point complex ping-pong buffers): radix-4 passes, preceded by one
//   radix-2 pass when log2 N is odd; no bit reversal, one __syncthreads per
//   pass. Twiddles come from a table of W_{n_fft}^k, k < N, built in float64
//   on the host and cast to f32 (W^{k+N} = -W^k covers the rest).
// * Real-FFT post-processing X[k] = E[k] + W_{n_fft}^k O[k] with
//   E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj Z[N-k]) / 2, and the
//   power |X[k]|^2, only for the bins below n_bins (the filterbank's last
//   nonzero column + 1): bins above cannot reach the output.
// * Sparse mel projection: each mel row is one contiguous band of bins
//   (first bin, count, offset into the packed weights); thread m sums its
//   band in bin order and writes out[m, frame]. One writer per output
//   element, no atomics: the result is bitwise the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;  // usable without cudaFuncSetAttribute

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W_{2N}^e for 0 <= e <= 2N - 1 from the half table tw[k] = W_{2N}^k, k < N
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int e, int N) {
  if (e < N) return __ldg(tw + e);
  const float2 w = __ldg(tw + (e - N));
  return make_float2(-w.x, -w.y);
}

__device__ __forceinline__ float reflected_sample(const float* __restrict__ wave,
                                                  long long n, long long x) {
  // x indexes the wave; one reflection at each end (the wrapper keeps
  // n_fft/2 < n)
  if (x < 0) x = -x;
  if (x >= n) x = 2 * (n - 1) - x;
  return __ldg(wave + x);
}

__global__ void __launch_bounds__(THREADS)
mel_power_kernel(const float* __restrict__ wave, long long n_samples, int hop, int n_frames,
                 int log2_half, const float* __restrict__ window,
                 const float2* __restrict__ tw, int n_bins, const int* __restrict__ band,
                 const float* __restrict__ weights, int n_mels, float* __restrict__ out) {
  extern __shared__ float2 smem[];
  const int N = 1 << log2_half;  // complex points, n_fft / 2
  float2* src = smem;
  float2* dst = smem + N;
  const int tid = threadIdx.x;
  const int frame = blockIdx.x;
  const long long x0 = (long long)frame * hop - N;  // centered: pad = n_fft / 2 = N

  for (int i = tid; i < N; i += THREADS) {
    const float a = reflected_sample(wave, n_samples, x0 + 2 * i);
    const float b = reflected_sample(wave, n_samples, x0 + 2 * i + 1);
    src[i] = make_float2(a * __ldg(window + 2 * i), b * __ldg(window + 2 * i + 1));
  }
  __syncthreads();

  int ns = 1;  // length of the sub-transforms done so far
  if (log2_half & 1) {
    const int h = N / 2;
    for (int j = tid; j < h; j += THREADS) {
      const float2 u = src[j], v = src[j + h];
      dst[2 * j] = make_float2(u.x + v.x, u.y + v.y);
      dst[2 * j + 1] = make_float2(u.x - v.x, u.y - v.y);
    }
    float2* t = src; src = dst; dst = t;
    ns = 2;
    __syncthreads();
  }
  for (; ns < N; ns *= 4) {
    const int q = N / 4;
    const int step = N / (2 * ns);  // W_N^{r k N / (4 ns)} = W_{2N}^{r k step}
    for (int j = tid; j < q; j += THREADS) {
      const int k = j & (ns - 1);
      const float2 v0 = src[j];
      float2 v1 = src[j + q], v2 = src[j + 2 * q], v3 = src[j + 3 * q];
      if (k) {
        const int e = k * step;
        v1 = cmul(v1, twiddle(tw, e, N));
        v2 = cmul(v2, twiddle(tw, 2 * e, N));
        v3 = cmul(v3, twiddle(tw, 3 * e, N));
      }
      const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
      const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
      const float2 b0 = make_float2(v1.x + v3.x, v1.y + v3.y);
      const float2 b1 = make_float2(v1.x - v3.x, v1.y - v3.y);
      const int o = (j - k) * 4 + k;
      dst[o] = make_float2(a0.x + b0.x, a0.y + b0.y);
      dst[o + ns] = make_float2(a1.x + b1.y, a1.y - b1.x);      // a1 - i b1
      dst[o + 2 * ns] = make_float2(a0.x - b0.x, a0.y - b0.y);
      dst[o + 3 * ns] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
    }
    float2* t = src; src = dst; dst = t;
    __syncthreads();
  }

  // src holds Z; the power of the used bins goes to the other buffer
  float* power = reinterpret_cast<float*>(dst);
  for (int k = tid; k < n_bins; k += THREADS) {
    const float2 z = src[k & (N - 1)];
    const float2 r = src[(N - k) & (N - 1)];  // conj taken below
    const float ex = 0.5f * (z.x + r.x), ey = 0.5f * (z.y - r.y);
    const float ox = 0.5f * (z.y + r.y), oy = -0.5f * (z.x - r.x);
    const float2 w = twiddle(tw, k, N);
    const float xr = ex + (w.x * ox - w.y * oy);
    const float xi = ey + (w.x * oy + w.y * ox);
    power[k] = xr * xr + xi * xi;
  }
  __syncthreads();

  for (int m = tid; m < n_mels; m += THREADS) {
    const int first = band[m], count = band[n_mels + m], off = band[2 * n_mels + m];
    float acc = 0.f;
    for (int j = 0; j < count; ++j) acc = fmaf(__ldg(weights + off + j), power[first + j], acc);
    out[(size_t)m * n_frames + frame] = acc;
  }
}

}  // namespace

extern "C" {

// Shapes the wrapper guarantees: n_fft = 2^(log2_half + 1) in [256, 8192],
// n_fft / 2 < n_samples, window (n_fft) f32, twiddles (n_fft / 2, 2) f32,
// band (3, n_mels) int32 rows first bin / count / weight offset, every band
// inside [0, n_bins), n_bins <= n_fft / 2 + 1, out (n_mels, n_frames).
// Returns a cudaError_t.
int mel_power_launch(const float* wave, long long n_samples, int hop, int n_frames,
                     int log2_half, const float* window, const float* twiddles, int n_bins,
                     const int* band, const float* weights, int n_mels, float* out,
                     void* stream) {
  const int smem = static_cast<int>(2 * sizeof(float2)) << log2_half;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        mel_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mel_power_kernel<<<n_frames, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wave, n_samples, hop, n_frames, log2_half, window,
      reinterpret_cast<const float2*>(twiddles), n_bins, band, weights, n_mels, out);
  return static_cast<int>(cudaGetLastError());
}

const char* mel_power_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
