// issaudio: native audio decode + resample for the TPU segmentation host path.
//
// The reference delegates its native audio surface to ffmpeg (subprocess) and
// libsndfile (reference io.py:61-77).  This library provides a first-party
// equivalent for the WAV container: RIFF parsing (PCM 8/16/24/32,
// float32/64), mono mixdown, and a Kaiser-windowed polyphase sinc resampler
// to 16 kHz, exposed through a minimal C ABI consumed via ctypes
// (inaspeechsegmenter_tpu/audio/native.py).  Host-side only: the output
// feeds pinned buffers into the JAX device pipeline.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct WavInfo {
  int32_t sample_rate = 0;
  int32_t channels = 0;
  int32_t bits = 0;
  int32_t format = 0;  // 1 = PCM, 3 = IEEE float
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
};

uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

bool parse_wav(const uint8_t* buf, int64_t len, WavInfo* info) {
  if (len < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return false;
  int64_t pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t size = rd32(hdr + 4);
    const uint8_t* payload = hdr + 8;
    // streamed WAVs may carry bogus chunk sizes; clamp to buffer
    int64_t avail = len - (pos + 8);
    int64_t psize = (int64_t)size;
    if (psize > avail) psize = avail;
    if (memcmp(hdr, "fmt ", 4) == 0 && psize >= 16) {
      info->format = rd16(payload);
      info->channels = rd16(payload + 2);
      info->sample_rate = (int32_t)rd32(payload + 4);
      info->bits = rd16(payload + 14);
      if (info->format == 0xFFFE && psize >= 40)  // extensible
        info->format = rd16(payload + 24);
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      info->data = payload;
      info->data_len = psize;
      if (have_fmt) return true;
    }
    pos += 8 + psize + (psize & 1);
  }
  return have_fmt && info->data != nullptr;
}

// Untrusted media: a malformed fmt chunk (e.g. bits in 1..7) would make
// bits/8 == 0 and SIGFPE the process on the frame-count division.
bool valid_wav(const WavInfo& w) {
  if (w.channels <= 0 || w.sample_rate <= 0) return false;
  if (w.format != 1 && w.format != 3) return false;
  switch (w.bits) {
    case 8: case 16: case 24:
      if (w.format != 1) return false;
      break;
    case 32:
      break;  // PCM32 or float32
    case 64:
      if (w.format != 3) return false;
      break;
    default:
      return false;
  }
  return true;
}

double sample_at(const WavInfo& w, int64_t frame, int32_t ch) {
  int64_t idx = frame * w.channels + ch;
  const uint8_t* p;
  switch (w.bits) {
    case 8:
      p = w.data + idx;
      return ((int32_t)*p - 128) / 128.0;
    case 16:
      p = w.data + idx * 2;
      return (int16_t)rd16(p) / 32768.0;
    case 24: {
      p = w.data + idx * 3;
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      // sign-extend bit 23 without shifting into the sign bit (UB pre-C++20)
      if (v & 0x800000) v -= 0x1000000;
      return v / 8388608.0;
    }
    case 32:
      p = w.data + idx * 4;
      if (w.format == 3) {
        float f;
        memcpy(&f, p, 4);
        return f;
      }
      return (int32_t)rd32(p) / 2147483648.0;
    case 64: {
      p = w.data + idx * 8;
      double d;
      memcpy(&d, p, 8);
      return d;
    }
    default:
      return 0.0;
  }
}

double bessel_i0(double x) {
  // modified Bessel function of the first kind, order 0 (series)
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

int64_t gcd64(int64_t a, int64_t b) { return b == 0 ? a : gcd64(b, a % b); }

}  // namespace

extern "C" {

// Fill (sr, channels, n_frames, bits_per_sample); returns 0 on success,
// -1 on error.
int64_t iss_wav_info(const uint8_t* data, int64_t len, int32_t* sr,
                     int32_t* channels, int64_t* n_frames, int32_t* bits) {
  WavInfo w;
  if (!parse_wav(data, len, &w) || !valid_wav(w)) return -1;
  *sr = w.sample_rate;
  *channels = w.channels;
  *bits = w.bits;
  *n_frames = w.data_len / ((int64_t)w.channels * (w.bits / 8));
  return 0;
}

// Decode + mono mixdown to float32. Returns frames written or -1.
int64_t iss_wav_decode_f32(const uint8_t* data, int64_t len, float* out,
                           int64_t out_cap) {
  WavInfo w;
  if (!parse_wav(data, len, &w) || !valid_wav(w)) return -1;
  int64_t frames = w.data_len / ((int64_t)w.channels * (w.bits / 8));
  if (frames > out_cap) frames = out_cap;
  for (int64_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int32_t c = 0; c < w.channels; ++c) acc += sample_at(w, i, c);
    out[i] = (float)(acc / w.channels);
  }
  return frames;
}

// Rational polyphase resampler (Kaiser-windowed sinc, 24 taps/phase).
// Returns output samples written, or -1 on error.
int64_t iss_resample(const float* in, int64_t n, int32_t sr_in,
                     int32_t sr_out, float* out, int64_t out_cap) {
  if (sr_in <= 0 || sr_out <= 0 || n < 0) return -1;
  if (sr_in == sr_out) {
    int64_t m = n < out_cap ? n : out_cap;
    memcpy(out, in, (size_t)m * sizeof(float));
    return m;
  }
  int64_t g = gcd64(sr_in, sr_out);
  int64_t L = sr_out / g;  // upsample factor
  int64_t M = sr_in / g;   // downsample factor

  const int kTaps = 24;  // taps per phase
  double cutoff = 0.5 * (L > M ? 1.0 / L : 1.0 / M) * 0.92;  // normalized
  double beta = 9.0;
  double i0b = bessel_i0(beta);

  // filter bank: L phases x kTaps
  std::vector<double> fb((size_t)(L * kTaps));
  int64_t half = (int64_t)kTaps * L / 2;
  for (int64_t p = 0; p < L; ++p) {
    double sum = 0.0;
    for (int t = 0; t < kTaps; ++t) {
      // tap index in the prototype filter
      int64_t k = (int64_t)t * L + p;
      double x = (double)(k - half);
      // x -> 0 limit of sin(2*pi*cutoff*x)/(pi*x) is 2*cutoff (the *L gain
      // is applied uniformly below; an extra *L here turned phase 0 into a
      // near-delta passthrough with no anti-aliasing)
      double sinc = x == 0.0 ? 2.0 * cutoff
                             : sin(2.0 * M_PI * cutoff * L * (x / L)) / (M_PI * x / L) / L;
      double r = x / (double)half;
      double w = (r <= -1.0 || r >= 1.0) ? 0.0
                 : bessel_i0(beta * sqrt(1.0 - r * r)) / i0b;
      fb[(size_t)(p * kTaps + t)] = sinc * w * L;
      sum += sinc * w * L;
    }
    (void)sum;
  }
  // normalize each phase to unit DC gain
  for (int64_t p = 0; p < L; ++p) {
    double s = 0.0;
    for (int t = 0; t < kTaps; ++t) s += fb[(size_t)(p * kTaps + t)];
    if (s != 0.0)
      for (int t = 0; t < kTaps; ++t) fb[(size_t)(p * kTaps + t)] /= s;
  }

  int64_t n_out = (n * L) / M;
  if (n_out > out_cap) n_out = out_cap;
  for (int64_t j = 0; j < n_out; ++j) {
    int64_t num = j * M;
    int64_t in_idx = num / L;          // input sample index
    int64_t phase = num % L;
    double acc = 0.0;
    const double* h = &fb[(size_t)(phase * kTaps)];
    for (int t = 0; t < kTaps; ++t) {
      int64_t idx = in_idx + (int64_t)(kTaps / 2) - t;
      double v = (idx < 0 || idx >= n) ? 0.0 : in[idx];
      acc += h[t] * v;
    }
    out[j] = (float)acc;
  }
  return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Predictive bit-packing PCM16 upload encoder (dsp/codec.py `pack_bits`).
//
// Single-pass-per-block C encoder for the lossless upload codec: per
// 320-sample block pick the cheapest fixed predictor (order 0/1/2), zigzag
// the 318 residuals, pack at the smallest sufficient bit width 0..16 (odd
// widths included) into 32-byte-sub-row-aligned, width-grouped pool slots.
// Byte-identical to the numpy reference encoder (asserted in
// tests/test_codec.py) — this exists because the numpy encode costs tens of
// ms per 2M-sample upload group on a 1-core host, which is on the order of
// the link time the packing saves; the C encode is ~5x cheaper and drops
// off the critical path.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBlock = 320;
constexpr int64_t kBytePage = 128 * 1024;

// smallest sufficient bit width for a max zigzag value (0..16, 18=invalid)
inline int bit_width(uint32_t zmax) {
  if (zmax == 0) return 0;
  return 32 - __builtin_clz(zmax);
}

inline int sub_rows(int w) { return (40 * w + 31) / 32; }

// residual at position i (i >= 2) under a predictor order
inline int32_t residual(const int16_t* xb, int i, int order) {
  if (order == 0) return xb[i];
  if (order == 1) return (int32_t)xb[i] - xb[i - 1];
  return (int32_t)xb[i] - 2 * (int32_t)xb[i - 1] + xb[i - 2];
}

}  // namespace

extern "C" {

// Pack n int16 samples (n % 320 == 0) into `out`.  Returns the packed
// length, 0 when packing would not save min_save of the raw bytes
// (caller falls back), or -1 on error / insufficient capacity.
int64_t iss_pack_bits(const int16_t* sig, int64_t n, double min_save,
                      uint8_t* out, int64_t out_cap) {
  if (n <= 0 || n % kBlock != 0) return -1;
  int64_t nb = n / kBlock;

  // pass 1: per-block predictor order + width
  std::vector<uint8_t> order(nb), width(nb);
  int64_t total_srows = 0;
  int64_t count_w[17] = {0};  // per width 0..16
  for (int64_t b = 0; b < nb; ++b) {
    const int16_t* xb = sig + b * kBlock;
    int32_t mx0 = INT32_MIN, mn0 = INT32_MAX;
    int32_t mx1 = INT32_MIN, mn1 = INT32_MAX;
    int32_t mx2 = INT32_MIN, mn2 = INT32_MAX;
    for (int i = 2; i < kBlock; ++i) {
      int32_t r0 = xb[i];
      int32_t r1 = r0 - xb[i - 1];
      int32_t r2 = r1 - ((int32_t)xb[i - 1] - xb[i - 2]);
      if (r0 > mx0) mx0 = r0;
      if (r0 < mn0) mn0 = r0;
      if (r1 > mx1) mx1 = r1;
      if (r1 < mn1) mn1 = r1;
      if (r2 > mx2) mx2 = r2;
      if (r2 < mn2) mn2 = r2;
    }
    // max zigzag value per order: max(2*max, -2*min-1)
    int64_t z0 = std::max<int64_t>(2LL * mx0, -2LL * mn0 - 1);
    int64_t z1 = std::max<int64_t>(2LL * mx1, -2LL * mn1 - 1);
    int64_t z2 = std::max<int64_t>(2LL * mx2, -2LL * mn2 - 1);
    int w0 = z0 > 65535 ? 18 : bit_width((uint32_t)z0);
    int w1 = z1 > 65535 ? 18 : bit_width((uint32_t)z1);
    int w2 = z2 > 65535 ? 18 : bit_width((uint32_t)z2);
    int o = 0, w = w0;                     // ties -> lowest order
    if (w1 < w) { o = 1; w = w1; }
    if (w2 < w) { o = 2; w = w2; }
    order[b] = (uint8_t)o;
    width[b] = (uint8_t)w;
    total_srows += sub_rows(w);
    ++count_w[w];
  }

  int64_t n_pages = (total_srows * 32 + kBytePage - 1) / kBytePage;
  if (n_pages < 1) n_pages = 1;
  int64_t pool_bytes = n_pages * kBytePage;
  int64_t out_len = pool_bytes + 5 * nb;
  int64_t raw_bytes = nb * kBlock * 2;
  if ((double)out_len >= (double)raw_bytes * (1.0 - min_save)) return 0;
  if (out_len > out_cap) return -1;
  memset(out, 0, (size_t)out_len);

  // width-grouped pool region starts (ascending width, block order within)
  int64_t region[17];  // byte offset per width
  int64_t pos = 0;
  for (int wi = 1; wi <= 16; ++wi) {
    region[wi] = pos;
    pos += count_w[wi] * 32LL * sub_rows(wi);
  }
  region[0] = 0;  // width 0 writes nothing

  // pass 2: heads + meta + packed residuals
  uint8_t* heads = out + pool_bytes;
  uint8_t* meta = out + pool_bytes + 4 * nb;
  for (int64_t b = 0; b < nb; ++b) {
    const int16_t* xb = sig + b * kBlock;
    heads[4 * b + 0] = (uint8_t)(xb[0] & 0xFF);
    heads[4 * b + 1] = (uint8_t)((uint16_t)xb[0] >> 8);
    heads[4 * b + 2] = (uint8_t)(xb[1] & 0xFF);
    heads[4 * b + 3] = (uint8_t)((uint16_t)xb[1] >> 8);
    int w = width[b];
    int o = order[b];
    meta[b] = (uint8_t)((o << 5) | w);
    if (w == 0) continue;
    uint8_t* dst = out + region[w];
    region[w] += 32LL * sub_rows(w);
    // little-endian bit stream, width w per residual slot
    uint64_t acc = 0;
    int nbits = 0;
    for (int i = 2; i < kBlock; ++i) {
      int32_t r = residual(xb, i, o);
      uint32_t z = (uint32_t)((r << 1) ^ (r >> 31));
      acc |= (uint64_t)z << nbits;
      nbits += w;
      while (nbits >= 8) {
        *dst++ = (uint8_t)acc;
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits) *dst = (uint8_t)acc;  // rest of the row is already zero
  }
  return out_len;
}

// 0.3.0: pack_bits format v2 (exact odd/even widths 0..16, 32-byte
// sub-row alignment, meta = order<<5 | width).  The Python loader gates
// iss_pack_bits on this version so a stale v1 build can never mix formats
// with a v2 decoder.
const char* iss_version() { return "issaudio-0.3.0"; }

}  // extern "C"
