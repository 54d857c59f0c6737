// Fused SIDEKIT feature kernel for Hopper (sm_90a), by FFT.
//
// Replaces the Pallas TPU kernel inaspeechsegmenter_tpu/dsp/pallas_fe.py::
// _kernel (launched from PallasSidekitFrontend._features_padded), and the
// port's first kernel, which took the DFT densely: 400 x 257 complex
// products per frame on the fp32 cores (about 1.1 ms for a 10 min file).
// Same computation: per 400-sample frame on a 160 hop, pre-emphasis 0.97
// (first sample against itself), log-energy of the pre-emphasised frame,
// Hann window, 512-point real DFT (257 bins), power spectrum, 24 triangular
// mel filters, logf.
//
// What bounds it on the H100: by FFT the arithmetic is about 16 kFLOP per
// frame, some 14 us for a 10 min file at 67 TFLOP/s fp32; the signal in and
// the features out are 25 MB, some 7.5 us at 3.35 TB/s.  Both are small, so
// the design keeps every intermediate in shared memory and reads the signal
// once.
//
// Design: one block of 256 threads per tile of 8 frames, about 44 KB of
// static shared memory (five blocks fit on an SM).
//   1. The tile's (8-1)*160 + 400 samples are copied from device memory
//      into shared memory once, with 16-byte cp.async (int16 is scaled by
//      1/32768 afterwards, in shared memory).
//   2. Pre-emphasis times the window fills each frame's 400 values and 112
//      zeros, packed as 256 complex values z[n] = x[2n] + i x[2n+1]; one
//      warp per frame reduces the log-energy.
//   3. A radix-2 Stockham FFT of 256 points, 8 stages ping-ponging between
//      two shared buffers, all 8 frames at once (4 butterflies a thread per
//      stage).  Twiddles exp(-2 pi i k/512) come from a table built in
//      float64 and rounded to float32, passed in by the wrapper and kept in
//      shared memory.
//   4. The split step X[k] = E[k] + W^k O[k] (E, O from Z[k] and
//      conj(Z[256-k])) gives the 257 bins; their power overwrites the spare
//      buffer.
//   5. Each (frame, band) output sums only the band's nonzero filter bins
//      (ranges precomputed with the constants), then logf.  Only exact zeros
//      are skipped, and the FFT of a silent frame is exactly zero, so
//      digital silence still gives -inf.  The build uses no
//      --use_fast_math, so logf(0) is exactly -inf.
// Accumulation is f32 throughout: no tensor cores, no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 400;
constexpr int HOP = 160;
constexpr int NFFT = 512;
constexpr int NC = NFFT / 2;                    // complex FFT points
constexpr int NBINS = NC + 1;
constexpr int NMEL = 24;
constexpr int TILE = 8;                         // frames per block
constexpr int THREADS = 256;
constexpr int SPAN = (TILE - 1) * HOP + WIN;    // samples per tile
constexpr float PREFAC = 0.97f;

static_assert(TILE * NBINS <= TILE * NC * 2, "spectra fit the spare buffer");
static_assert(THREADS / 32 >= TILE, "one warp per frame's log-energy");
static_assert(SPAN % 8 == 0 && HOP % 8 == 0, "16-byte copies of int16 spans");

__device__ __forceinline__ float preemph(const float* xf, int n) {
  // rounded multiply then subtract, as the plain version computes it
  const float prev = n ? xf[n - 1] : xf[0];
  return __fsub_rn(xf[n], __fmul_rn(PREFAC, prev));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(THREADS)
sidekit_fe_kernel(const void* __restrict__ sig, int is_int16,
                  long long n_frames, const float* __restrict__ window,
                  const float2* __restrict__ twiddle,
                  const float* __restrict__ fbank_t,
                  const int* __restrict__ band_range,
                  float* __restrict__ mspec, float* __restrict__ loge) {
  __shared__ __align__(16) float x[SPAN];
  __shared__ __align__(16) int16_t x16[SPAN];
  __shared__ __align__(16) float2 buf[2][TILE * NC];
  __shared__ float2 tw[NC];

  const long long f0 = (long long)blockIdx.x * TILE;
  const int nf = (int)min((long long)TILE, n_frames - f0);
  const long long s0 = f0 * HOP;
  const int span = (nf - 1) * HOP + WIN;
  const int tid = threadIdx.x;

  // ---- 1. the tile's samples, once; the twiddles ----------------------------
  if (is_int16) {
    const int16_t* g = (const int16_t*)sig + s0;
    for (int i = tid; i < span / 8; i += THREADS) cp_async16(x16 + 8 * i, g + 8 * i);
  } else {
    const float* g = (const float*)sig + s0;
    for (int i = tid; i < span / 4; i += THREADS) cp_async16(x + 4 * i, g + 4 * i);
  }
  for (int i = tid; i < NC; i += THREADS) tw[i] = __ldg(twiddle + i);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (is_int16) {
    for (int i = tid; i < span; i += THREADS) {
      x[i] = __fmul_rn((float)x16[i], 1.0f / 32768.0f);
    }
    __syncthreads();
  }

  // ---- 2. windowed frames as packed complex values; log-energy -------------
  float2* a = buf[0];
  float2* b = buf[1];
  for (int i = tid; i < TILE * NC; i += THREADS) {
    const int f = i / NC, j = i - f * NC, n = 2 * j;
    float2 z = make_float2(0.0f, 0.0f);
    if (f < nf && n < WIN) {   // WIN is even: both samples or neither
      const float* xf = x + f * HOP;
      z.x = __fmul_rn(preemph(xf, n), __ldg(window + n));
      z.y = __fmul_rn(preemph(xf, n + 1), __ldg(window + n + 1));
    }
    a[i] = z;
  }
  const int warp = tid / 32, lane = tid % 32;
  if (warp < nf) {
    float acc = 0.0f;
    for (int n = lane; n < WIN; n += 32) {
      const float p = preemph(x + warp * HOP, n);
      acc = fmaf(p, p, acc);
    }
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) loge[f0 + warp] = logf(acc);
  }
  __syncthreads();

  // ---- 3. 256-point Stockham FFT, 8 stages ---------------------------------
#pragma unroll 1
  for (int ls = 0, s = 1, n = NC; n > 1; ++ls, s <<= 1, n >>= 1) {
    const int m = n >> 1;
    for (int i = tid; i < TILE * NC / 2; i += THREADS) {
      const int f = i / (NC / 2), j = i - f * (NC / 2);
      const int p = j >> ls, q = j & (s - 1);
      const float2* xin = a + f * NC;
      float2* yout = b + f * NC;
      const float2 u = xin[q + s * p], v = xin[q + s * (p + m)];
      yout[q + s * 2 * p] = make_float2(u.x + v.x, u.y + v.y);
      yout[q + s * (2 * p + 1)] =
          cmul(make_float2(u.x - v.x, u.y - v.y), tw[2 * p * s]);
    }
    __syncthreads();
    float2* t = a; a = b; b = t;
  }

  // ---- 4. split to the 257 real-input bins, power spectrum -----------------
  float* spec = (float*)b;
  for (int i = tid; i < TILE * NBINS; i += THREADS) {
    const int f = i / NBINS, k = i - f * NBINS;
    const float2* Z = a + f * NC;
    const float2 zk = Z[k & (NC - 1)], zc = Z[(NC - k) & (NC - 1)];
    // E = (Z[k] + conj Z[N-k]) / 2, O = -i (Z[k] - conj Z[N-k]) / 2
    const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 w = k < NC ? tw[k] : make_float2(-1.0f, 0.0f);
    const float2 wo = cmul(w, o);
    const float re = e.x + wo.x, im = e.y + wo.y;
    spec[i] = re * re + im * im;
  }
  __syncthreads();

  // ---- 5. mel bands over their nonzero bins, log ----------------------------
  for (int i = tid; i < nf * NMEL; i += THREADS) {
    const int f = i / NMEL, m = i - f * NMEL;
    const float* sp = spec + f * NBINS;
    const int lo = __ldg(band_range + 2 * m), hi = __ldg(band_range + 2 * m + 1);
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = fmaf(sp[k], __ldg(fbank_t + k * NMEL + m), acc);
    mspec[(f0 + f) * NMEL + m] = logf(acc);
  }
}

}  // namespace

// sig: n >= (n_frames-1)*160+400 samples, f32 or int16 (is_int16), 16-byte
// aligned.  window (400,), twiddle (256, 2) = exp(-2 pi i k/512), fbank_t
// (257,24) f32 row-major, band_range (24, 2) int32 [first, last+1) of each
// band's nonzero bins.  mspec (n_frames,24) and loge (n_frames,) f32.
// Returns cudaGetLastError().
extern "C" int iss_sidekit_fe(const void* sig, int is_int16, long long n_frames,
                              const float* window, const float* twiddle,
                              const float* fbank_t, const int* band_range,
                              float* mspec, float* loge, void* stream) {
  if (n_frames <= 0 || ((uintptr_t)sig & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n_frames + TILE - 1) / TILE;
  sidekit_fe_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      sig, is_int16, n_frames, window, (const float2*)twiddle, fbank_t,
      band_range, mspec, loge);
  return (int)cudaGetLastError();
}
