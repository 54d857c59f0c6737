// Lossless PCM16 upload codec decoders for Hopper (sm_90a).
//
// Replace the XLA programs inaspeechsegmenter_tpu/dsp/codec.py::unpack_bits
// (:227) and ::unpack_zero_elide (:115), jitted there from
// SidekitFrontend._one_chunk_bits / _one_chunk_packed and from the VBx
// int16 upload.  Same results, bit for bit: the exact int16 signal the host
// packed with pack_bits / pack_zero_elide (dsp/codec.py of the port holds
// the encoders, the wrappers and the plain PyTorch version of each
// decoder).  Only valid buffers are promised the JAX program's samples.
//
// What bounds them on the H100: memory.  A 3-chunk upload group is 6,145
// blocks of 320 samples: at most ~3.9 MB in and 3.9 MB out, about 2.3 us at
// 3.35 TB/s; the arithmetic is a dozen integer operations a sample.  At
// these sizes the two launches of each decoder and the serial first pass
// cost more than the bytes; the design is simple and exact first.
//
// unpack_bits, two kernels:
//   1. bits_rank_kernel: ONE block of 1024 threads loops over the nb codec
//      blocks in tiles of 1024.  The pool is grouped by width (ascending,
//      block order within a width), so a block's pool offset is the
//      sub-rows of every lower width plus its rank among the earlier blocks
//      of its own width times its own sub-rows.  The rank: __match_any_sync
//      within a warp, an exclusive scan over the tile's 32 warps for each
//      width, and a carry for each width from the tiles before.  At the end
//      it writes the count of each width.  The offsets come from the widths
//      on the device, so the link carries exactly the JAX package's bytes.
//   2. bits_decode_kernel: one warp a codec block, 8 warps a block.  The
//      block's 40*w bytes are staged in shared memory (zeros past them);
//      lane l takes slots 10l..10l+9, extracts each at width w (LSB-first:
//      slot s is bits [s*w, s*w + w) of the stream, within 3 bytes),
//      un-zigzags, then inverts the predictor with warp-inclusive scans of
//      the lane sums: order 1 one scan, order 2 two.  Arithmetic is on
//      32-bit unsigned integers, wrapping as the XLA program's int32 does;
//      the low 16 bits are the samples.
// unpack_zero_elide, two kernels:
//   1. elide_scan_kernel: one block of 1024 threads loops over the mask,
//      an inclusive scan; minus one is each block's pool row.
//   2. elide_copy_kernel: one thread a sample, the pool row's sample times
//      the mask value (0 or 1), as the XLA program multiplies.
// Both decoders run on the caller's stream, allocate nothing (the wrapper
// passes the scratch and the output) and never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 320;             // samples a codec block
constexpr int RESIDUALS = BLOCK - 2;   // slots 0..317 carry residuals
constexpr int N_WIDTHS = 17;           // exact widths 0..16
constexpr int SCAN_THREADS = 1024;
constexpr int DEC_WARPS = 8;
constexpr int SLOTS_PER_LANE = BLOCK / 32;
constexpr int SPAN = 40 * 16 + 8;      // a block's bytes at width 16, slack
constexpr unsigned FULL = 0xffffffffu;

static_assert(SLOTS_PER_LANE * 32 == BLOCK, "10 slots a lane");

__device__ __forceinline__ int sub_rows(int w) { return (40 * w + 31) / 32; }

__device__ __forceinline__ int clamp_width(int m) {
  const int w = m & 0x1F;
  return w > 16 ? 0 : w;   // the XLA program has no candidate past 16
}

template <typename T>
__device__ __forceinline__ T warp_inclusive(T v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const T n = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(SCAN_THREADS)
bits_rank_kernel(const uint8_t* __restrict__ meta, int nb,
                 int* __restrict__ rank, int* __restrict__ totals) {
  __shared__ int warp_cnt[32][N_WIDTHS];
  __shared__ int carry[N_WIDTHS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < N_WIDTHS) carry[threadIdx.x] = 0;
  for (int base = 0; base < nb; base += SCAN_THREADS) {
    for (int i = threadIdx.x; i < 32 * N_WIDTHS; i += SCAN_THREADS) {
      (&warp_cnt[0][0])[i] = 0;
    }
    __syncthreads();
    const int b = base + threadIdx.x;
    const int w = b < nb ? clamp_width(meta[b]) : -1;
    const unsigned same = __match_any_sync(FULL, w);
    const int in_warp = __popc(same & ((1u << lane) - 1u));
    if (w >= 0 && in_warp == 0) warp_cnt[warp][w] = __popc(same);
    __syncthreads();
    if (threadIdx.x < N_WIDTHS) {
      int acc = carry[threadIdx.x];
      for (int i = 0; i < 32; ++i) {
        const int c = warp_cnt[i][threadIdx.x];
        warp_cnt[i][threadIdx.x] = acc;
        acc += c;
      }
      carry[threadIdx.x] = acc;
    }
    __syncthreads();
    if (b < nb) rank[b] = warp_cnt[warp][w] + in_warp;
    __syncthreads();
  }
  if (threadIdx.x < N_WIDTHS) totals[threadIdx.x] = carry[threadIdx.x];
}

__global__ void __launch_bounds__(DEC_WARPS * 32)
bits_decode_kernel(const uint8_t* __restrict__ buf, long long hp, int nb,
                   const int* __restrict__ rank,
                   const int* __restrict__ totals,
                   int16_t* __restrict__ out) {
  __shared__ long long base[N_WIDTHS];   // first sub-row of each width
  __shared__ uint8_t span[DEC_WARPS][SPAN];
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int w = 0; w < N_WIDTHS; ++w) {
      base[w] = acc;
      if (w > 0) acc += (long long)totals[w] * sub_rows(w);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * DEC_WARPS + warp;
  if (b >= nb) return;
  const uint8_t* heads = buf + hp + 4 * b;
  const int m = buf[hp + 4LL * nb + b];
  const int w = clamp_width(m);
  const int order = m >> 5;
  const unsigned x0 = (unsigned)(int)(int16_t)(heads[0] | (heads[1] << 8));
  const unsigned x1 = (unsigned)(int)(int16_t)(heads[2] | (heads[3] << 8));
  const long long off = (base[w] + (long long)rank[b] * sub_rows(w)) * 32;
  const int nbytes = 40 * w;
  uint8_t* s = span[warp];
  for (int i = lane; i < SPAN; i += 32) {
    s[i] = (i < nbytes && off + i < hp) ? buf[off + i] : (uint8_t)0;
  }
  __syncwarp();
  const unsigned wmask = (1u << w) - 1u;
  unsigned r[SLOTS_PER_LANE];
  unsigned sum = 0;
  for (int j = 0; j < SLOTS_PER_LANE; ++j) {
    const int slot = SLOTS_PER_LANE * lane + j;
    const int bit = slot * w;
    const int by = bit >> 3;
    const unsigned v = s[by] | ((unsigned)s[by + 1] << 8) |
                       ((unsigned)s[by + 2] << 16);
    const unsigned z = (v >> (bit & 7)) & wmask;
    const unsigned res = slot < RESIDUALS ? (z >> 1) ^ (0u - (z & 1u)) : 0u;
    r[j] = res;
    sum += res;
  }
  int16_t* o = out + b * BLOCK;
  if (lane == 0) {
    o[0] = (int16_t)(uint16_t)x0;
    o[1] = (int16_t)(uint16_t)x1;
  }
  if (order == 0) {
    for (int j = 0; j < SLOTS_PER_LANE; ++j) {
      const int slot = SLOTS_PER_LANE * lane + j;
      if (slot < RESIDUALS) o[2 + slot] = (int16_t)(uint16_t)r[j];
    }
    return;
  }
  // c1 = inclusive cumsum of the residuals
  unsigned c = warp_inclusive(sum, lane) - sum;
  unsigned sum2 = 0;
  for (int j = 0; j < SLOTS_PER_LANE; ++j) {
    c += r[j];
    r[j] = c;                        // c1 at this slot
    sum2 += (x1 - x0) + c;           // order 2 scans (x1 - x0) + c1
  }
  if (order == 1) {
    for (int j = 0; j < SLOTS_PER_LANE; ++j) {
      const int slot = SLOTS_PER_LANE * lane + j;
      if (slot < RESIDUALS) o[2 + slot] = (int16_t)(uint16_t)(x1 + r[j]);
    }
    return;
  }
  unsigned c2 = warp_inclusive(sum2, lane) - sum2;
  for (int j = 0; j < SLOTS_PER_LANE; ++j) {
    const int slot = SLOTS_PER_LANE * lane + j;
    c2 += (x1 - x0) + r[j];
    if (slot < RESIDUALS) o[2 + slot] = (int16_t)(uint16_t)(x1 + c2);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
elide_scan_kernel(const int16_t* __restrict__ mask, int nb,
                  int* __restrict__ row) {
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nb; base += SCAN_THREADS) {
    const int b = base + threadIdx.x;
    const int v = b < nb ? (int)mask[b] : 0;
    const int incl = warp_inclusive(v, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int ws = warp_sum[lane];
      warp_sum[lane] = warp_inclusive(ws, lane) - ws;
    }
    __syncthreads();
    const int total = carry + warp_sum[warp] + incl;
    if (b < nb) row[b] = total - 1;
    __syncthreads();
    if (threadIdx.x == SCAN_THREADS - 1) carry = total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(256)
elide_copy_kernel(const int16_t* __restrict__ pool, long long n_rows,
                  const int16_t* __restrict__ mask,
                  const int* __restrict__ row, int nb,
                  int16_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nb * BLOCK) return;
  const long long b = i / BLOCK;
  long long r = row[b];
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  out[i] = (int16_t)(pool[r * BLOCK + (i - b * BLOCK)] * mask[b]);
}

}  // namespace

// buf: uint8 (hp + 5*nb); rank: int32 (nb) scratch; totals: int32 (17)
// scratch; out: int16 (nb*320).  -> cudaError_t
extern "C" int iss_unpack_bits(const void* buf, long long hp, int nb,
                               int* rank, int* totals, void* out,
                               void* stream) {
  if (nb <= 0 || hp <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* b = (const uint8_t*)buf;
  cudaStream_t s = (cudaStream_t)stream;
  bits_rank_kernel<<<1, SCAN_THREADS, 0, s>>>(b + hp + 4LL * nb, nb, rank,
                                              totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((nb + DEC_WARPS - 1) / DEC_WARPS);
  bits_decode_kernel<<<blocks, DEC_WARPS * 32, 0, s>>>(b, hp, nb, rank,
                                                       totals,
                                                       (int16_t*)out);
  return (int)cudaGetLastError();
}

// buf: int16 (n_rows*320 + nb); row: int32 (nb) scratch; out: int16
// (nb*320).  -> cudaError_t
extern "C" int iss_unpack_zero_elide(const void* buf, long long n_rows,
                                     int nb, int* row, void* out,
                                     void* stream) {
  if (nb <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  const int16_t* pool = (const int16_t*)buf;
  const int16_t* mask = pool + n_rows * BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  elide_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(mask, nb, row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nb * BLOCK;
  elide_copy_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      pool, n_rows, mask, row, nb, (int16_t*)out);
  return (int)cudaGetLastError();
}
