// Epilogue of a patch-CNN conv block for Hopper (sm_90a): the conv's bias,
// ReLU, inference BatchNorm, a VALID max pool and the layout the next layer
// reads, in one pass over the conv's output.
//
// Replaces no Pallas kernel: in the JAX package XLA fused these pointwise
// passes and the pool behind each convolution
// (inaspeechsegmenter_tpu/models/layers.py).  The port ran them as separate
// PyTorch passes: F.pad before each SAME conv, the conv's bias, F.relu, four
// BatchNorm broadcasts, F.max_pool2d.
//
// Same computation as models/layers.py::cnn_epilogue_plain, and as the
// unfused layers, in float32 and in the same order: v = y + bias; relu;
// ((v - mean) * inv) * gamma + beta with inv = rsqrt(var + eps) made by
// torch; relu; the max over the window, a NaN winning as in F.max_pool2d.
// The _rn intrinsics keep nvcc from contracting a multiply and an add into
// an FMA, so the result equals the unfused chain's bit for bit.
//
// What bounds it on the H100: bytes.  It reads each conv output once and
// writes each pooled output once, with the zero border of the SAME conv that
// reads it next: for the smn VAD CNN (nmel 21, widths 32/64/128/128) 473 KB
// read and 210 KB written a patch over the four blocks, 0.209 ms for a
// 1,024-patch batch at 3.35 TB/s; the gender CNN (nmel 24) 547 and 241 KB,
// 0.241 ms.  About ten operations an input element, far under the fp32
// roof.
//
// Design: the output is channels-last (NHWC order), the layout the port
// hands cuDNN: in float32 with TF32 off, cuDNN's heuristics take its slow
// FFT engine for the CNN's second conv on an NCHW input (4.3 against 0.9 ms
// at 1,024 patches on an H100), and a Flatten reads NHWC as Keras does.
// A flat grid covers the outputs of the whole batch in that order, border
// included, so the stores are coalesced; on a channels-last conv output
// consecutive threads read consecutive channels of one window position,
// whose scalars come through L1.  Each thread takes ITEMS outputs THREADS
// apart and issues all their window loads before it computes (16 bytes or
// more in flight a thread for the 2x1 and 2x2 pools).  The window is a
// template parameter: 2x1 and 2x2, the patch CNNs' pools, and 1x1 for a
// block without a pool; the entry point refuses any other.  Indices are 32-bit
// with division by multiplication (a launch holds fewer than 2^31 outputs;
// the entry point splits a larger batch), and the conv output is read
// through its own strides (NCHW-contiguous is taken too, uncoalesced).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 2;    // outputs a thread

// n / d for n < 2^31 by a multiply-high and a shift (Granlund-Montgomery,
// as PyTorch's IntDivider); the magic number is made on the host.
struct FastDiv {
  unsigned d, m, s;
  FastDiv() = default;
  explicit FastDiv(unsigned div) : d(div), s(0) {
    while ((1ull << s) < d) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

struct Params {
  const float* x;                  // conv output (B, C, H, W), strides below
  long long sb, sc, sh, sw;
  const float* bias;               // (C,) each, or null: that step is absent
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  int relu1, relu2;
  int ph, pw, sph, spw;            // pool window and strides (1 1 1 1: none)
  float* out;                      // (B, Ho, Wo, C)
  unsigned pt, pl, hp, wp;         // border before; pooled size
  FastDiv fc, fw, fh;              // C, Wo, Ho
  unsigned total;                  // outputs of the launch
};

__device__ __forceinline__ float relu(float v) {
  return v < 0.0f ? 0.0f : v;      // F.relu: a NaN passes
}

__device__ __forceinline__ float epilogue(float v, const Params& p,
                                          float b, float mu, float iv,
                                          float g, float be) {
  if (p.bias) v = __fadd_rn(v, b);
  if (p.relu1) v = relu(v);
  if (p.mean) {
    v = __fmul_rn(__fsub_rn(v, mu), iv);
    if (p.gamma) v = __fmul_rn(v, g);
    if (p.beta) v = __fadd_rn(v, be);
  }
  if (p.relu2) v = relu(v);
  return v;
}

__device__ __forceinline__ void pool_max(float& m, float v) {
  if (v > m || isnan(v)) m = v;    // F.max_pool2d's comparison
}

// the channel's five scalars (0 where a step is absent)
struct Channel {
  float b, mu, iv, g, be;
  __device__ __forceinline__ Channel(const Params& p, unsigned c)
      : b(p.bias ? __ldg(p.bias + c) : 0.0f),
        mu(p.mean ? __ldg(p.mean + c) : 0.0f),
        iv(p.mean ? __ldg(p.inv + c) : 0.0f),
        g(p.gamma ? __ldg(p.gamma + c) : 0.0f),
        be(p.beta ? __ldg(p.beta + c) : 0.0f) {}
  __device__ __forceinline__ float operator()(const Params& p, float v) const {
    return epilogue(v, p, b, mu, iv, g, be);
  }
};

// PH, PW: the pool window
template <int PH, int PW>
__global__ void __launch_bounds__(THREADS) cnn_epilogue_kernel(Params p) {
  const unsigned base = blockIdx.x * (THREADS * ITEMS) + threadIdx.x;
  const float* src[ITEMS];
  unsigned ch[ITEMS];
  int state[ITEMS];                // 0: past the end, 1: border, 2: window
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const unsigned o = base + k * THREADS;
    state[k] = 0;
    src[k] = p.x;
    ch[k] = 0;
    if (o >= p.total) continue;
    // o = ((b * ho + yo) * wo + xo) * C + c
    const unsigned t0 = p.fc.div(o), t1 = p.fw.div(t0), b = p.fh.div(t1);
    const unsigned c = o - t0 * p.fc.d;
    const unsigned i = t1 - b * p.fh.d - p.pt;  // wraps past hp in the border
    const unsigned j = t0 - t1 * p.fw.d - p.pl;
    if (i >= p.hp || j >= p.wp) {
      state[k] = 1;
      continue;
    }
    state[k] = 2;
    ch[k] = c;
    src[k] = p.x + b * p.sb + c * p.sc + (long long)(i * p.sph) * p.sh +
             (long long)(j * p.spw) * p.sw;
  }
  // every window load of the thread's outputs first, then the arithmetic
  float v[ITEMS][PH * PW];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
#pragma unroll
    for (int di = 0; di < PH; ++di) {
#pragma unroll
      for (int dj = 0; dj < PW; ++dj) {
        v[k][di * PW + dj] =
            state[k] == 2 ? __ldg(src[k] + di * p.sh + dj * p.sw) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (state[k] == 0) continue;
    float m = 0.0f;
    if (state[k] == 2) {
      const Channel f(p, ch[k]);
      m = -INFINITY;
#pragma unroll
      for (int w = 0; w < PH * PW; ++w) pool_max(m, f(p, v[k][w]));
    }
    p.out[base + k * THREADS] = m;
  }
}

}  // namespace

// x: the conv output (B, C, H, W) float32, strides in elements (sb, sc, sh,
// sw >= 0).  bias, mean, inv, gamma, beta: (C,) float32 or null (mean and
// inv together).  relu1 / relu2: a ReLU before / after the affine.  ph, pw,
// sph, spw: a VALID max pool, window 2x1 or 2x2 (1 1 1 1 for none), H >= ph
// and W >= pw.
// out: (B, pt + Hp + pb, pl + Wp + pr, C) contiguous, with a zero border,
// Hp = (H - ph) / sph + 1, Wp = (W - pw) / spw + 1.  Launched on `stream`,
// with no sync.
// Returns cudaGetLastError() (cudaErrorInvalidValue for bad sizes).
extern "C" int iss_cnn_epilogue(
    const float* x, int B, int C, int H, int W, long long sb, long long sc,
    long long sh, long long sw, const float* bias, const float* mean,
    const float* inv, const float* gamma, const float* beta, int relu1,
    int relu2, int ph, int pw, int sph, int spw, float* out, int pt, int pb,
    int pl, int pr, void* stream) {
  const bool window = (ph == 2 && (pw == 1 || pw == 2)) ||
                      (ph == 1 && pw == 1);
  if (B <= 0 || C <= 0 || !window || sph <= 0 || spw <= 0 ||
      H < ph || W < pw || pt < 0 || pb < 0 || pl < 0 || pr < 0 ||
      (mean == nullptr) != (inv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long hp = (H - ph) / sph + 1, wp = (W - pw) / spw + 1;
  const long long ho = pt + hp + pb, wo = pl + wp + pr;
  const long long per_patch = C * ho * wo;
  const long long max_b = 0x7fffffffLL / per_patch;
  if (max_b < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.sb = sb; p.sc = sc; p.sh = sh; p.sw = sw;
  p.bias = bias; p.mean = mean; p.inv = inv; p.gamma = gamma; p.beta = beta;
  p.relu1 = relu1; p.relu2 = relu2;
  p.ph = ph; p.pw = pw; p.sph = sph; p.spw = spw;
  p.pt = (unsigned)pt; p.pl = (unsigned)pl;
  p.hp = (unsigned)hp; p.wp = (unsigned)wp;
  p.fc = FastDiv((unsigned)C);
  p.fw = FastDiv((unsigned)wo);
  p.fh = FastDiv((unsigned)ho);
  for (long long b0 = 0; b0 < B; b0 += max_b) {
    const long long nb = B - b0 < max_b ? B - b0 : max_b;
    p.x = x + b0 * sb;
    p.out = out + b0 * per_patch;
    p.total = (unsigned)(nb * per_patch);
    const unsigned blocks = (p.total + THREADS * ITEMS - 1) / (THREADS * ITEMS);
    cudaStream_t s = (cudaStream_t)stream;
    if (ph == 2 && pw == 1) {
      cnn_epilogue_kernel<2, 1><<<blocks, THREADS, 0, s>>>(p);
    } else if (ph == 2 && pw == 2) {
      cnn_epilogue_kernel<2, 2><<<blocks, THREADS, 0, s>>>(p);
    } else {
      cnn_epilogue_kernel<1, 1><<<blocks, THREADS, 0, s>>>(p);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
