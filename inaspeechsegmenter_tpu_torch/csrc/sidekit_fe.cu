// Fused SIDEKIT feature kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel inaspeechsegmenter_tpu/dsp/pallas_fe.py::
// _kernel (launched from PallasSidekitFrontend._features_padded).  Same
// computation, not the same layout: per 400-sample frame on a 160 hop,
// pre-emphasis 0.97 (first sample against itself), log-energy of the
// pre-emphasised frame, Hann window, 512-point real DFT (257 bins) against
// the f32 cos/sin matrices, power spectrum, 24 triangular mel filters, logf.
// The TPU kernel's 256-lane row blocks and pltpu.roll were TPU tiling only.
//
// What bounds it on the H100: arithmetic.  The DFT is 2 * 400 * 257 FMAs per
// frame (~205k), about 200 per input byte, far above the memory roofline;
// the signal is read once and 100 bytes per frame are written.
//
// Design: one block of 288 threads per tile of 16 frames.
//   1. The tile's samples ((16-1)*160 + 400 = 2800) are read once from global
//      memory into shared memory (int16 scaled by 1/32768 on the way in).
//   2. Pre-emphasis and the window build the 16 windowed frames in shared
//      memory; one warp per frame reduces the log-energy.
//   3. Thread k owns DFT bin k for all 16 frames: per sample n it reads
//      dcos[n][k] and dsin[n][k] (coalesced across the warp, resident in L1/L2:
//      the two matrices are 822 KB for the whole grid) and the 16 frame
//      values (shared-memory broadcasts), and keeps 32 accumulators in
//      registers.  So each matrix element fetched serves 16 frames.
//   4. The power spectra overwrite the frame buffer; each thread then forms
//      one (frame, band) mel sum and takes logf.
// Accumulation is f32 throughout: no tensor cores, no TF32.  The build uses
// no --use_fast_math, so logf(0) is exactly -inf on digital silence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int NBINS = 257;
constexpr int NMEL = 24;
constexpr int TILE = 16;                        // frames per block
constexpr int THREADS = 288;                    // 9 warps; 257 DFT bins
constexpr int SPAN = (TILE - 1) * HOP + WIN;    // samples per tile
constexpr float PREFAC = 0.97f;

static_assert(TILE * NBINS <= TILE * WIN, "spectra reuse the frame buffer");
static_assert(THREADS >= NBINS, "one thread per DFT bin");

__device__ __forceinline__ float preemph(const float* xf, int n) {
  // rounded multiply then subtract, as the plain version computes it
  const float prev = n ? xf[n - 1] : xf[0];
  return __fsub_rn(xf[n], __fmul_rn(PREFAC, prev));
}

__global__ void __launch_bounds__(THREADS)
sidekit_fe_kernel(const float* __restrict__ sig_f32,
                  const int16_t* __restrict__ sig_i16, long long n_frames,
                  const float* __restrict__ window,
                  const float* __restrict__ dcos,
                  const float* __restrict__ dsin,
                  const float* __restrict__ fbank_t,
                  float* __restrict__ mspec, float* __restrict__ loge) {
  __shared__ float x[SPAN];
  __shared__ float buf[TILE * WIN];   // windowed frames, then power spectra

  const long long f0 = (long long)blockIdx.x * TILE;
  const int nf = (int)min((long long)TILE, n_frames - f0);
  const long long s0 = f0 * HOP;
  const int span = (nf - 1) * HOP + WIN;
  const int tid = threadIdx.x;

  for (int i = tid; i < span; i += THREADS) {
    x[i] = sig_i16 ? __fmul_rn((float)sig_i16[s0 + i], 1.0f / 32768.0f)
                   : sig_f32[s0 + i];
  }
  __syncthreads();

  for (int i = tid; i < TILE * WIN; i += THREADS) {
    const int f = i / WIN, n = i - f * WIN;
    buf[i] = f < nf ? __fmul_rn(preemph(x + f * HOP, n), window[n]) : 0.0f;
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int f = warp; f < nf; f += THREADS / 32) {
    float acc = 0.0f;
    for (int n = lane; n < WIN; n += 32) {
      const float p = preemph(x + f * HOP, n);
      acc = fmaf(p, p, acc);
    }
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) loge[f0 + f] = logf(acc);
  }
  __syncthreads();

  const int k = tid;
  float re[TILE], im[TILE];
#pragma unroll
  for (int f = 0; f < TILE; ++f) re[f] = im[f] = 0.0f;
  if (k < NBINS) {
    for (int n = 0; n < WIN; ++n) {
      const float c = __ldg(dcos + n * NBINS + k);
      const float s = __ldg(dsin + n * NBINS + k);
#pragma unroll
      for (int f = 0; f < TILE; ++f) {
        const float v = buf[f * WIN + n];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
  }
  __syncthreads();                    // every read of the frames is done
  if (k < NBINS) {
#pragma unroll
    for (int f = 0; f < TILE; ++f) {
      buf[f * NBINS + k] = re[f] * re[f] + im[f] * im[f];
    }
  }
  __syncthreads();

  for (int i = tid; i < nf * NMEL; i += THREADS) {
    const int f = i / NMEL, m = i - f * NMEL;
    const float* sp = buf + f * NBINS;
    float acc = 0.0f;
    for (int b = 0; b < NBINS; ++b) acc = fmaf(sp[b], __ldg(fbank_t + b * NMEL + m), acc);
    mspec[(f0 + f) * NMEL + m] = logf(acc);
  }
}

}  // namespace

// sig: n >= (n_frames-1)*160+400 samples, f32 or int16 (is_int16).
// window (400,), dcos/dsin (400,257), fbank_t (257,24) f32 row-major.
// mspec (n_frames,24) and loge (n_frames,) f32.  Returns cudaGetLastError().
extern "C" int iss_sidekit_fe(const void* sig, int is_int16, long long n_frames,
                              const float* window, const float* dcos,
                              const float* dsin, const float* fbank_t,
                              float* mspec, float* loge, void* stream) {
  if (n_frames <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_frames + TILE - 1) / TILE;
  sidekit_fe_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      is_int16 ? nullptr : (const float*)sig,
      is_int16 ? (const int16_t*)sig : nullptr, n_frames, window, dcos, dsin,
      fbank_t, mspec, loge);
  return (int)cudaGetLastError();
}
