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
// What bounds them on the H100: memory.  Each reads the bytes its data
// needs once and writes 640 bytes a codec block: a 3-chunk upload group
// (6,145 blocks) is ~4-8 MB, ~1.3-2.3 us at 3.35 TB/s, below the few us a
// kernel launch costs; a 1 h whole-file VBx slice (~180,000 blocks) is
// ~100-200 MB, ~40-66 us.  The arithmetic of the bit decoder (~20
// integer operations a sample at 64 lanes a cycle an SM) is close behind
// the bytes, so every step below counts instructions as well as bytes.
//
// Each decoder is ONE launch of a persistent grid: the SM count times the
// occupancy the kernel gets (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// cached a device), capped so that no CTA's range is shorter than
// MIN_RANGE codec blocks.  CTA c decodes the contiguous blocks [c*R,
// (c+1)*R), R = ceil(nb / grid) (a CTA past nb has nothing to do).  Nothing
// crosses CTAs: no cooperative launch, no grid barrier, no spin-wait, no
// scratch in device memory.  Each CTA finds its blocks' bytes from the meta
// bytes alone:
//
// unpack_bits.  The pool is grouped by width (ascending, block order within
// a width), so block b's first pool sub-row is
//   base[w] + rank(b) * sub(w),  base[w] = sum over w' < w of total[w'] *
//   sub(w'),  sub(w) = ceil(40 w / 32),
// where total[] counts every width in the WHOLE buffer and rank(b) counts
// the earlier blocks of b's width.  So each CTA sweeps all nb meta bytes,
// redundantly, in one pass that counts each width twice: before its range
// (its rank carry) and from there on (with the first, the totals).  The
// sweep reads nb bytes a CTA from L2 (at 180,000 blocks and 132 CTAs:
// 24 MB in all, a tenth of the HBM bytes) in 16-byte loads, and counts in
// registers, SWAR: a nibble a width for widths 1..16 in two words
// (1 << 4(w-1), PTX shl, whose shift past 31 gives 0, so widths 0 and
// 17..31 add nothing), flushed every 8 bytes into byte fields and every
// 31 flushes into shared memory; width 0 is what the others leave.  About
// 8 integer operations a meta byte: at large nb the sweep costs ~nb * 8 /
// 32 issue cycles an SM (the integer pipes take 16 lanes a cycle a
// scheduler), ~11 us at 180,000 blocks.  Then, a tile of 1,024 blocks at
// a time, the ranks within the range: a block's rank among its warp's
// blocks of its width (__match_any_sync), and a warp a width scans the
// tile's 32 warps, plus the carry.
// Then the decode, one warp a codec block: the block's 40*w bytes (never
// past the pool's end, zeros beyond it) come in 16-byte loads into
// registers one block ahead of the decode (two blocks in flight a warp),
// and go to shared memory.  Lane l takes slots 10l..10l+9 at width w
// (LSB-first: slot s is bits [s*w, s*w + w) of the stream): a switch on
// the warp-uniform width picks a copy compiled for it, which reads the
// lane's words once, funnel-shifts them to start at its first bit, and
// then finds every slot at a constant word and shift.  It un-zigzags,
// then inverts the predictor with warp-inclusive scans of the lane sums:
// order 1 one scan, order 2 two.  Arithmetic is on 32-bit unsigned
// integers, wrapping as the XLA program's int32 does; the low 16 bits are
// the samples.  They are staged in shared memory in 32-bit pairs and leave
// as 40 16-byte stores a block.  The decode is bound by integer issue as
// much as by bytes: ~200 warp instructions a block.
//
// unpack_zero_elide.  A kept block's pool row is the inclusive sum of the
// mask values up to it, minus one (the plain cumsum of the values, not a
// count of nonzeros), clamped to the pool.  Each CTA sums the mask before
// its range (16-byte loads, nb/2 values a CTA on average), then, a tile of
// 1,024 blocks at a time, scans the tile's mask values and copies: each
// thread a 16-byte piece of a block, the pool row's piece times the mask
// value (int16, wrapping, as the plain version multiplies), zeros without
// reading the pool where the value is 0.
//
// Both decoders read and write with 16-byte accesses when the buffer and
// the output start on 16 bytes (the pool's sub-rows and rows, and the
// output's blocks, are multiples of 16 bytes from there); otherwise the
// same kernel takes byte and 2-byte accesses (an output may be a slice of
// a larger buffer: dsp/codec.py::ship).  Both run on the caller's stream,
// allocate nothing (the wrapper passes the output) and never synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 320;             // samples a codec block
constexpr int RESIDUALS = BLOCK - 2;   // slots 0..317 carry residuals
constexpr int N_WIDTHS = 17;           // exact widths 0..16
constexpr int THREADS = 1024;          // a CTA, and codec blocks a tile
constexpr int WARPS = THREADS / 32;
constexpr int MIN_RANGE = 32;          // codec blocks a CTA at least
constexpr int SLOTS_PER_LANE = BLOCK / 32;
constexpr int SPAN_WORDS = 164;        // 160 words of a width-16 block, the
                                       // funnel's next word, 16-byte pad
constexpr int UNROLL = 4;              // 16-byte pieces a thread in flight
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

static_assert(SLOTS_PER_LANE * 32 == BLOCK, "10 slots a lane");
static_assert(SPAN_WORDS * 4 >= BLOCK * 2, "the span stages the samples");
static_assert(SPAN_WORDS % 4 == 0, "16-byte span rows");

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

// a << s, and 0 for a shift of 32 or more (PTX clamps the amount)
__device__ __forceinline__ unsigned shl_clamped(unsigned a, unsigned s) {
  unsigned r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(s));
  return r;
}

// --------------------------------------------------------------------------
// the width sweep of unpack_bits

struct WidthCounter {
  unsigned nib_lo = 0, nib_hi = 0;   // a nibble a width: 1..8, 9..16
  unsigned even_lo = 0, odd_lo = 0;  // byte fields: widths 1,3,5,7 / 2,4,6,8
  unsigned even_hi = 0, odd_hi = 0;  //              9,11,13,15 / 10,...,16
  int flushes = 0;

  __device__ __forceinline__ void add(unsigned w) {   // w = meta & 0x1F
    const unsigned s = 4u * w - 4u;
    nib_lo += shl_clamped(1u, s);
    nib_hi += shl_clamped(1u, s - 32u);
  }
  __device__ __forceinline__ void add_word(unsigned x) {
    x &= 0x1F1F1F1Fu;
    add(__byte_perm(x, 0, 0x4440));
    add(__byte_perm(x, 0, 0x4441));
    add(__byte_perm(x, 0, 0x4442));
    add(__byte_perm(x, 0, 0x4443));
  }
  // nibbles (at most 8 each since the last flush) into byte fields, and
  // the byte fields into shared memory before they can reach 256
  __device__ __forceinline__ void flush(int* cnt) {
    even_lo += nib_lo & 0x0F0F0F0Fu;
    odd_lo += (nib_lo >> 4) & 0x0F0F0F0Fu;
    even_hi += nib_hi & 0x0F0F0F0Fu;
    odd_hi += (nib_hi >> 4) & 0x0F0F0F0Fu;
    nib_lo = nib_hi = 0;
    if (++flushes == 31) drain(cnt);
  }
  __device__ void drain(int* cnt) {
    for (int j = 0; j < 4; ++j) {
      const int sh = 8 * j;
      const int a = (even_lo >> sh) & 0xFF, b = (odd_lo >> sh) & 0xFF;
      const int c = (even_hi >> sh) & 0xFF, d = (odd_hi >> sh) & 0xFF;
      if (a) atomicAdd(&cnt[2 * j + 1], a);
      if (b) atomicAdd(&cnt[2 * j + 2], b);
      if (c) atomicAdd(&cnt[2 * j + 9], c);
      if (d) atomicAdd(&cnt[2 * j + 10], d);
    }
    even_lo = odd_lo = even_hi = odd_hi = 0;
    flushes = 0;
  }
  // the last drain, every lane of the warp together: a warp sum a width
  // into this warp's row of part (no atomics: the rows are summed after)
  __device__ void drain_warp(int* part) {
    const int lane = threadIdx.x & 31;
    int* row = part + (threadIdx.x >> 5) * N_WIDTHS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sh = 8 * j;
      const unsigned a = __reduce_add_sync(FULL, (even_lo >> sh) & 0xFFu);
      const unsigned b = __reduce_add_sync(FULL, (odd_lo >> sh) & 0xFFu);
      const unsigned c = __reduce_add_sync(FULL, (even_hi >> sh) & 0xFFu);
      const unsigned d = __reduce_add_sync(FULL, (odd_hi >> sh) & 0xFFu);
      if (lane == 0) {
        row[2 * j + 1] = (int)a;
        row[2 * j + 2] = (int)b;
        row[2 * j + 9] = (int)c;
        row[2 * j + 10] = (int)d;
      }
    }
  }
};

// One pass over meta[0, nb) (all threads): the count of each width 1..16
// among meta[0, start) and among meta[start, nb), in before / after (the
// byte fields' early drains, atomics) plus the rows of part_before /
// part_after (a warp's row, [warp][width], written at the end).
// A 16-byte vector wholly on one side counts into that side's counter;
// the one vector across `start` (and the bytes before the first 16-byte
// boundary and after the last) count byte by byte.
__device__ void count_widths(const uint8_t* __restrict__ meta, long long nb,
                             long long start, int* before, int* after,
                             int* part_before, int* part_after) {
  WidthCounter wb, wa;
  const long long head =
      min(nb, (long long)((16 - ((uintptr_t)meta & 15)) & 15));
  const long long nvec = nb > head ? (nb - head) / 16 : 0;
  const long long tail0 = head + 16 * nvec;
  for (long long i = threadIdx.x; i < head; i += THREADS) {
    if (i < start) {
      wb.add(meta[i] & 0x1F);
      wb.flush(before);
    } else {
      wa.add(meta[i] & 0x1F);
      wa.flush(after);
    }
  }
  const uint4* v = (const uint4*)(meta + head);
  for (long long i = threadIdx.x; i < nvec; i += THREADS) {
    const uint4 x = v[i];
    const long long at = head + 16 * i;
    if (at >= start) {
      wa.add_word(x.x);
      wa.add_word(x.y);
      wa.flush(after);
      wa.add_word(x.z);
      wa.add_word(x.w);
      wa.flush(after);
    } else if (at + 16 <= start) {
      wb.add_word(x.x);
      wb.add_word(x.y);
      wb.flush(before);
      wb.add_word(x.z);
      wb.add_word(x.w);
      wb.flush(before);
    } else {
      const unsigned words[4] = {x.x & 0x1F1F1F1Fu, x.y & 0x1F1F1F1Fu,
                                 x.z & 0x1F1F1F1Fu, x.w & 0x1F1F1F1Fu};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const unsigned w = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
        if (at + k < start) {
          wb.add(w);
        } else {
          wa.add(w);
        }
        if ((k & 7) == 7) {
          wb.flush(before);
          wa.flush(after);
        }
      }
    }
  }
  for (long long i = tail0 + threadIdx.x; i < nb; i += THREADS) {
    if (i < start) {
      wb.add(meta[i] & 0x1F);
      wb.flush(before);
    } else {
      wa.add(meta[i] & 0x1F);
      wa.flush(after);
    }
  }
  wb.drain_warp(part_before);
  wa.drain_warp(part_after);
}

// --------------------------------------------------------------------------
// unpack_bits

struct Fetched {   // a lane's share of one codec block's bytes, in flight
  uint4 a, b;      // 16-byte pieces l and l + 32 of the block
  unsigned heads;  // the block's two head samples
};

__device__ __forceinline__ uint4 piece(const uint8_t* __restrict__ buf,
                                       long long hp, long long at) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16; ++i) {
    if (at + i < hp) w[i >> 2] |= (unsigned)buf[at + i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ Fetched fetch(const uint8_t* __restrict__ buf,
                                         long long hp, long long b, int m,
                                         long long off, int lane, bool vec) {
  const int n16 = (40 * clamp_width(m) + 15) / 16;   // pieces of the block
  Fetched f;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  if (vec && off + 16 * n16 <= hp) {                  // the rule
    const uint4* src = (const uint4*)(buf + off);
    f.a = lane < n16 ? src[lane] : z;
    f.b = lane + 32 < n16 ? src[lane + 32] : z;
  } else {                                            // past the pool's
    f.a = lane < n16 ? piece(buf, hp, off + 16 * lane) : z;   // end, or
    f.b = lane + 32 < n16 ? piece(buf, hp, off + 16 * (lane + 32)) : z;
  }                                                   // an odd address
  const uint8_t* h = buf + hp + 4 * b;
  f.heads = vec ? *(const unsigned*)h
                : (unsigned)h[0] | ((unsigned)h[1] << 8) |
                      ((unsigned)h[2] << 16) | ((unsigned)h[3] << 24);
  return f;
}

// Lane l's slots 10l..10l+9 at width W, un-zigzagged: the lane's 10*W
// bits start at bit 10*l*W of the staged stream; its words are read once
// and shifted to start at bit 0, after which every slot's word and shift
// are constants.
template <int W>
__device__ __forceinline__ void extract(const unsigned* __restrict__ s,
                                        int lane,
                                        unsigned (&r)[SLOTS_PER_LANE]) {
  constexpr int NV = (SLOTS_PER_LANE * W + 31) / 32;
  constexpr unsigned MASK = (1u << W) - 1u;
  const unsigned base = (unsigned)(SLOTS_PER_LANE * W) * lane;
  const unsigned* p = s + (base >> 5);
  unsigned u[NV + 1], v[NV + 1];
#pragma unroll
  for (int k = 0; k <= NV; ++k) u[k] = p[k];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = __funnelshift_r(u[k], u[k + 1], base);
  v[NV] = 0u;
#pragma unroll
  for (int q = 0; q < SLOTS_PER_LANE; ++q) {
    const int bit = q * W, k = bit >> 5, off = bit & 31;
    const unsigned z = off + W <= 32
                           ? (v[k] >> off) & MASK
                           : __funnelshift_r(v[k], v[k + 1], off) & MASK;
    r[q] = (z >> 1) ^ (0u - (z & 1u));
  }
}

__device__ __forceinline__ void extract_any(const unsigned* __restrict__ s,
                                            int w, int lane,
                                            unsigned (&r)[SLOTS_PER_LANE]) {
  switch (w) {   // warp-uniform
#define ISS_CASE(W) \
  case W:           \
    extract<W>(s, lane, r); \
    break;
    ISS_CASE(1) ISS_CASE(2) ISS_CASE(3) ISS_CASE(4) ISS_CASE(5) ISS_CASE(6)
    ISS_CASE(7) ISS_CASE(8) ISS_CASE(9) ISS_CASE(10) ISS_CASE(11)
    ISS_CASE(12) ISS_CASE(13) ISS_CASE(14) ISS_CASE(15) ISS_CASE(16)
#undef ISS_CASE
    default:
#pragma unroll
      for (int q = 0; q < SLOTS_PER_LANE; ++q) r[q] = 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
unpack_bits_kernel(const uint8_t* __restrict__ buf, long long hp, int nb,
                   int16_t* __restrict__ out, int in_vec, int out_vec) {
  __shared__ int cnt_before[N_WIDTHS], cnt_after[N_WIDTHS];
  __shared__ int part[2][WARPS][N_WIDTHS];   // the sweep's warp sums
  __shared__ long long pos[N_WIDTHS];        // next sub-row of each width
  __shared__ int warp_off[WARPS][N_WIDTHS];  // per tile: counts, then rows
  __shared__ int tile_row[THREADS];          // per tile: each block's row
  __shared__ uint8_t tile_meta[THREADS];
  __shared__ __align__(16) unsigned span[WARPS][SPAN_WORDS];

  const long long per = ((long long)nb + gridDim.x - 1) / gridDim.x;
  const long long start = min((long long)nb, blockIdx.x * per);
  const long long end = min((long long)nb, start + per);
  if (start >= end) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* meta = buf + hp + 4LL * nb;
  // the first tile's meta bytes load while the sweep runs
  int m = threadIdx.x < end - start ? meta[start + threadIdx.x] : 0;

  if (threadIdx.x < N_WIDTHS) {
    cnt_before[threadIdx.x] = 0;
    cnt_after[threadIdx.x] = 0;
  }
  __syncthreads();
  count_widths(meta, nb, start, cnt_before, cnt_after, &part[0][0][0],
               &part[1][0][0]);
  __syncthreads();
  if (warp >= 1 && warp < N_WIDTHS) {   // warp w sums width w's rows
    const int b = __reduce_add_sync(FULL, part[0][lane][warp]);
    const int a = __reduce_add_sync(FULL, part[1][lane][warp]);
    if (lane == 0) {
      cnt_before[warp] += b;
      cnt_after[warp] += a;
    }
  }
  __syncthreads();
  if (warp == 0) {   // lane w: the first sub-row of width w, and this
    const int w = lane < N_WIDTHS ? lane : 0;   // CTA's first of it
    const int nz_before = __reduce_add_sync(FULL, lane >= 1 && lane < N_WIDTHS
                                                      ? cnt_before[w] : 0);
    const int nz_after = __reduce_add_sync(FULL, lane >= 1 && lane < N_WIDTHS
                                                     ? cnt_after[w] : 0);
    const long long b0 = lane == 0 ? start - nz_before : cnt_before[w];
    const long long a0 = lane == 0 ? nb - start - nz_after : cnt_after[w];
    const long long size = lane < N_WIDTHS ? (b0 + a0) * sub_rows(w) : 0;
    const long long base = warp_inclusive(size, lane) - size;
    if (lane < N_WIDTHS) pos[lane] = base + b0 * sub_rows(w);
#ifdef ISS_CODEC_SWEEP_ONLY   // tools/torch_codec_ab.py times a copy that
    if (lane == N_WIDTHS - 1 && base < 0) out[0] = 0;   // stops here: the
#endif   // sweep's cost (the store is never made; it keeps the sweep)
  }
#ifdef ISS_CODEC_SWEEP_ONLY
  return;
#endif

  const bool vec_in = in_vec != 0, vec_out = out_vec != 0;
  unsigned* s = span[warp];
  for (long long t0 = start; t0 < end; t0 += THREADS) {
    const int tile_n = (int)min((long long)THREADS, end - t0);
    for (int i = threadIdx.x; i < WARPS * N_WIDTHS; i += THREADS) {
      (&warp_off[0][0])[i] = 0;
    }
    __syncthreads();
    // ranks within the tile: by warp, then a per-width scan over warps
    const int j = threadIdx.x;
    if (t0 != start) m = j < tile_n ? meta[t0 + j] : 0;
    const int w = j < tile_n ? clamp_width(m) : -1;
    const unsigned same = __match_any_sync(FULL, w);
    const int in_warp = __popc(same & ((1u << lane) - 1u));
    if (w >= 0 && in_warp == 0) warp_off[warp][w] = __popc(same);
    __syncthreads();
    if (warp < N_WIDTHS) {   // warp wd scans width wd over the 32 warps
      const int wd = warp, c = warp_off[lane][wd];
      const long long rows = (long long)c * sub_rows(wd);
      const long long incl = warp_inclusive(rows, lane);
      warp_off[lane][wd] = (int)(pos[wd] + incl - rows);
      __syncwarp();
      if (lane == 31) pos[wd] += incl;
    }
    __syncthreads();
    if (w >= 0) {
      tile_row[j] = warp_off[warp][w] + in_warp * sub_rows(w);
      tile_meta[j] = (uint8_t)m;
    }
    __syncthreads();

    // the decode: a warp a codec block, the next block's bytes in flight
    int k = warp;
    Fetched f;
    if (k < tile_n) {
      f = fetch(buf, hp, t0 + k, tile_meta[k], 32LL * tile_row[k], lane,
                vec_in);
    }
    for (; k < tile_n; k += WARPS) {
      const int mk = tile_meta[k];
      const long long b = t0 + k;
      ((uint4*)s)[lane] = f.a;
      if (lane + 32 < SPAN_WORDS / 4) ((uint4*)s)[lane + 32] = f.b;
      const unsigned heads = f.heads;
      __syncwarp();
      if (k + WARPS < tile_n) {
        f = fetch(buf, hp, b + WARPS, tile_meta[k + WARPS],
                  32LL * tile_row[k + WARPS], lane, vec_in);
      }
      const int order = mk >> 5;
      const unsigned x0 = (unsigned)(int)(int16_t)(heads & 0xFFFFu);
      const unsigned x1 = (unsigned)(int)(int16_t)(heads >> 16);
      // slots 318-319 (lane 31's last two) hold no residual; they decode
      // to positions 320-321 of the staging, past the block, and come
      // after every sample in the scans, so they change nothing
      unsigned r[SLOTS_PER_LANE];
      extract_any(s, clamp_width(mk), lane, r);
      if (order != 0) {                  // the plain version: 1, else 2
        unsigned sum = 0;
#pragma unroll
        for (int q = 0; q < SLOTS_PER_LANE; ++q) sum += r[q];
        // c1 = inclusive cumsum of the residuals
        unsigned c = warp_inclusive(sum, lane) - sum;
        unsigned sum2 = 0;
#pragma unroll
        for (int q = 0; q < SLOTS_PER_LANE; ++q) {
          c += r[q];
          r[q] = c;                      // c1 at this slot
          sum2 += (x1 - x0) + c;         // order 2 scans (x1 - x0) + c1
        }
        if (order == 1) {
#pragma unroll
          for (int q = 0; q < SLOTS_PER_LANE; ++q) r[q] += x1;
        } else {
          unsigned c2 = warp_inclusive(sum2, lane) - sum2;
#pragma unroll
          for (int q = 0; q < SLOTS_PER_LANE; ++q) {
            c2 += (x1 - x0) + r[q];
            r[q] = x1 + c2;
          }
        }
      }
      __syncwarp();                      // every lane has read the span
      // sample 2 + 10l + q, q even, starts a 32-bit word: pairs
      if (lane == 0) s[0] = heads;
#pragma unroll
      for (int q = 0; q < SLOTS_PER_LANE; q += 2) {
        s[1 + 5 * lane + q / 2] = __byte_perm(r[q], r[q + 1], 0x5410);
      }
      __syncwarp();
      int16_t* o = out + b * BLOCK;
      if (vec_out) {
        ((uint4*)o)[lane] = ((const uint4*)s)[lane];
        if (lane < BLOCK / 8 - 32) {
          ((uint4*)o)[lane + 32] = ((const uint4*)s)[lane + 32];
        }
      } else {
        const uint16_t* o16 = (const uint16_t*)s;
        for (int i = lane; i < BLOCK; i += 32) o[i] = (int16_t)o16[i];
      }
      __syncwarp();                      // the span is free again
    }
    __syncthreads();                     // the tile's arrays are free again
  }
}

// --------------------------------------------------------------------------
// unpack_zero_elide

// the sum of mask[0, n) over the CTA (every thread gets it)
__device__ long long mask_sum(const int16_t* __restrict__ mask, long long n,
                              long long* red) {
  long long acc = 0;
  const long long head =
      min(n, (long long)(((16 - ((uintptr_t)mask & 15)) & 15) / 2));
  const long long nvec = n > head ? (n - head) / 8 : 0;
  for (long long i = threadIdx.x; i < head; i += THREADS) acc += mask[i];
  const uint4* v = (const uint4*)(mask + head);
  for (long long i = threadIdx.x; i < nvec; i += THREADS) {
    const uint4 x = v[i];
    acc += (int)(int16_t)(x.x & 0xFFFFu) + ((int)x.x >> 16) +
           (int)(int16_t)(x.y & 0xFFFFu) + ((int)x.y >> 16) +
           (int)(int16_t)(x.z & 0xFFFFu) + ((int)x.z >> 16) +
           (int)(int16_t)(x.w & 0xFFFFu) + ((int)x.w >> 16);
  }
  for (long long i = head + 8 * nvec + threadIdx.x; i < n; i += THREADS) {
    acc += mask[i];
  }
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(FULL, acc, d);
  if (threadIdx.x == 0) *red = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    atomicAdd((unsigned long long*)red, (unsigned long long)acc);
  }
  __syncthreads();
  const long long total = *red;
  __syncthreads();
  return total;
}

__device__ __forceinline__ unsigned mul_pair(unsigned u, int m) {
  const unsigned lo = (unsigned)((int)(int16_t)(u & 0xFFFFu) * m);
  const unsigned hi = (unsigned)(((int)u >> 16) * m);
  return (lo & 0xFFFFu) | (hi << 16);
}

__global__ void __launch_bounds__(THREADS)
unpack_zero_elide_kernel(const int16_t* __restrict__ pool, long long n_rows,
                         int nb, int16_t* __restrict__ out, int vec) {
  __shared__ long long red;
  __shared__ int warp_sum[WARPS];
  __shared__ long long tile_row[THREADS];
  __shared__ int tile_m[THREADS];

  const long long per = ((long long)nb + gridDim.x - 1) / gridDim.x;
  const long long start = min((long long)nb, blockIdx.x * per);
  const long long end = min((long long)nb, start + per);
  if (start >= end) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int16_t* mask = pool + n_rows * BLOCK;
  // the first tile's mask values load while the carry is summed
  int v = threadIdx.x < end - start ? (int)mask[start + threadIdx.x] : 0;
  long long carry = mask_sum(mask, start, &red);

  for (long long t0 = start; t0 < end; t0 += THREADS) {
    const int tile_n = (int)min((long long)THREADS, end - t0);
    const int j = threadIdx.x;
    if (t0 != start) v = j < tile_n ? (int)mask[t0 + j] : 0;
    const int incl = warp_inclusive(v, lane);
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int ws = warp_sum[lane];
      warp_sum[lane] = warp_inclusive(ws, lane) - ws;
    }
    __syncthreads();
    const long long row = carry + warp_sum[warp] + incl - 1;
    if (j < tile_n) {
      tile_row[j] = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
      tile_m[j] = v;
    }
    if (threadIdx.x == THREADS - 1) red = warp_sum[WARPS - 1] + incl;
    __syncthreads();
    carry += red;                        // the tile's sum (zeros past it)
    int16_t* o = out + t0 * BLOCK;
    if (vec) {
      // UNROLL pieces a thread at a time: their loads in flight together
      const int pieces = tile_n * (BLOCK / 8);
      for (int q0 = threadIdx.x; q0 < pieces; q0 += UNROLL * THREADS) {
        uint4 x[UNROLL];
        int mv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int q = min(q0 + u * THREADS, pieces - 1);
          const int jb = q / (BLOCK / 8), c = q - jb * (BLOCK / 8);
          mv[u] = q0 + u * THREADS < pieces ? tile_m[jb] : 0;
          x[u] = mv[u] != 0
                     ? ((const uint4*)(pool + tile_row[jb] * BLOCK))[c]
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int q = q0 + u * THREADS;
          if (q >= pieces) break;
          if (mv[u] != 0 && mv[u] != 1) {
            x[u] = make_uint4(mul_pair(x[u].x, mv[u]), mul_pair(x[u].y, mv[u]),
                              mul_pair(x[u].z, mv[u]),
                              mul_pair(x[u].w, mv[u]));
          }
          ((uint4*)o)[q] = x[u];
        }
      }
    } else {
      for (int q = threadIdx.x; q < tile_n * BLOCK; q += THREADS) {
        const int jb = q / BLOCK, i = q - jb * BLOCK;
        const int mv = tile_m[jb];
        o[q] = mv == 0 ? (int16_t)0
                       : (int16_t)(pool[tile_row[jb] * BLOCK + i] * mv);
      }
    }
    __syncthreads();                     // the tile's arrays are free again
  }
}

// --------------------------------------------------------------------------
// the persistent grid

int g_grid[2][MAX_DEVICES];   // SMs x occupancy, a kernel a device (0: unread)

// -> cudaError_t; *grid: the CTAs for nb codec blocks
int pick_grid(int which, const void* kernel, int nb, int requested,
              int* grid) {
  if (requested > 0) {
    *grid = requested;
    return (int)cudaSuccess;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int full = dev < MAX_DEVICES ? g_grid[which][dev] : 0;
  if (full == 0) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    full = sms * (occ > 0 ? occ : 1);
    if (dev < MAX_DEVICES) g_grid[which][dev] = full;
  }
  const int cap = (nb + MIN_RANGE - 1) / MIN_RANGE;
  *grid = full < cap ? full : cap;
  return (int)cudaSuccess;
}

}  // namespace

// buf: uint8 (hp + 5*nb); out: int16 (nb*320); grid: CTAs, 0 for the
// persistent grid.  -> cudaError_t
extern "C" int iss_unpack_bits(const void* buf, long long hp, int nb,
                               void* out, int grid, void* stream) {
  if (nb <= 0 || hp <= 0) return (int)cudaErrorInvalidValue;
  int g = 0;
  const int err = pick_grid(0, (const void*)unpack_bits_kernel, nb, grid, &g);
  if (err != (int)cudaSuccess) return err;
  unpack_bits_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, hp, nb, (int16_t*)out,
      ((uintptr_t)buf & 15) == 0, ((uintptr_t)out & 15) == 0);
  return (int)cudaGetLastError();
}

// buf: int16 (n_rows*320 + nb); out: int16 (nb*320); grid: CTAs, 0 for the
// persistent grid.  -> cudaError_t
extern "C" int iss_unpack_zero_elide(const void* buf, long long n_rows,
                                     int nb, void* out, int grid,
                                     void* stream) {
  if (nb <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  int g = 0;
  const int err =
      pick_grid(1, (const void*)unpack_zero_elide_kernel, nb, grid, &g);
  if (err != (int)cudaSuccess) return err;
  unpack_zero_elide_kernel<<<g, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)buf, n_rows, nb, (int16_t*)out,
      (((uintptr_t)buf | (uintptr_t)out) & 15) == 0);
  return (int)cudaGetLastError();
}
