// Viterbi decode with segment resets for Hopper (sm_90a): an exact
// chunk-parallel decode on a cooperative grid.
//
// Replaces the lax.scan decode inaspeechsegmenter_tpu/decode/viterbi.py::
// _viterbi_scan (no Pallas kernel there: XLA compiled the scan), and the
// port's first kernel, which ran the whole recursion and the backtrack on
// one thread of one block: 180,000 dependent frames twice, about 24 ms.
//
// What bounds it on the H100: the dependence from frame to frame.  The work
// is K*K adds and compares per frame (K <= 3) on 4*K + 1 bytes of input, so
// the memory bound is about 1 us for a 10 min file; a single serial chain is
// four orders of magnitude slower.  So the frames are spread over threads.
//
// Design (rank convergence: Maleki, Musuvathi and Mytkowicz, "Parallelizing
// Dynamic Programming Through Rank Convergence", PPoPP 2014):
//   1. Chunks.  T frames are split into P chunks of L >= CHUNK_MIN frames;
//      thread c owns chunk c.  The chunks are spread over a cooperative grid
//      of 256-thread blocks, at most one a SM, whose passes meet at grid
//      barriers: one block holding every chunk would be issue-bound on its
//      SM (about 60 instructions a frame for each thread).
//   2. Speculative pass.  Every chunk runs the scan's exact per-frame ops
//      from an entry vector: chunk 0 from the scan's v0 = 0, the others
//      from a guess of zeros.  After each group of GROUP frames it stores
//      the renormalised v (K floats; the checks below happen there), and
//      per frame one code byte: the 2-bit back-pointer of each state in
//      bits 0-5 (0b11 in bits 0-1 marks a reset frame, whose pointers are
//      never read) and the 2-bit argmax in bits 6-7.
//   3. Fix-up passes.  A chunk whose entry bits differ from its left
//      neighbour's current exit re-runs from that exit and stops at the end
//      of the first group of GROUP frames whose last new v is bit-equal
//      (__float_as_uint, so NaN rows converge too) to the stored v of that
//      frame.  Why this is exact: the recursion is deterministic, so from a
//      frame where v equals the stored v every later frame of the chunk
//      would recompute the stored values, and the pointers of that frame
//      depend on the previous v and are written before the stop (chunks
//      start on group edges).  So a chunk's stored frames and exit are
//      always those of a run from its stored entry; chunk 0's entry is the
//      scan's, so by induction chunks 0..p are exact after pass p.  The
//      passes end when no exit that a neighbour reads changed.
//   4. The serial walk.  On input that never coalesces (a long near-tie
//      without a reset) exactness advances one chunk a pass, a grid barrier
//      of about 4 us for every 16 frames, about twice what one thread takes
//      to run them.  So after PASS_CAP passes one thread walks what is
//      left: from the first chunk whose
//      entry differs from its neighbour's exit (its block finds it, 256
//      chunks at a time), it runs on from that neighbour's exit through
//      the following chunks, writing each one's exit, until it stops on a
//      stored row; then it looks for the next such chunk.  Everything left
//      of the walker is exact by the same induction, so the walk is exact,
//      and it costs at most T frames of one thread, without a barrier.
//      A walked chunk costs about a third of a pass, but the walk takes
//      separate stretches one after another where the passes take them
//      side by side; so the cap is high: input whose stretches converge
//      within 64 chunks (1,024 frames) never walks, and on one long
//      stretch the passes add at most 64 barriers to the walk.
//   5. Backtrack by exact map composition (integers only): each chunk
//      composes its frames' K-element maps (x[t] = amax[t] at a segment end,
//      else ptr[t+1][x[t+1]]) into one summary; a reverse scan of the
//      summaries in shared memory and then over the block summaries gives
//      each chunk the state after its last frame; each thread then walks
//      its chunk backward writing states.
//   6. The float ops are those of _viterbi_scan in the same order, written
//      as __fadd_rn/__fsub_rn (there is no multiply to contract):
//      v[k] + trans[k][k'], column max with the first maximum winning, em +
//      max (em + init at a reset), minus the row max.  A NaN wins an argmax
//      and propagates through a max, as in jnp.argmax and jnp.max.  The row
//      argmax is that of the scores before the subtraction, 0 when their max
//      is NaN (then every renormalised score is NaN): the same index.
//   Emissions, resets and stored scores do not depend on the recursion: a
//   run loads the next GROUP frames' while it computes the current ones, so
//   the serial chain waits on register ops, not on memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;    // threads a block; also the most blocks,
                                // whose summaries one block scans
constexpr int CHUNK_MIN = 16;   // frames a chunk, at least (a multiple of
                                // GROUP, as every chunk length is)
constexpr int PASS_CAP = 64;    // fix-up passes before the serial walk
constexpr int GROUP = 8;        // frames whose inputs are loaded ahead

// jnp.argmax / jnp.max semantics over a running (best, arg) pair: a NaN
// candidate wins unless a NaN already won; otherwise strictly greater wins.
__device__ __forceinline__ bool takes_over(float cand, float best) {
  return best == best && !(cand <= best);
}

template <int K>
__device__ __forceinline__ bool same_row(float4 a, const float (&b)[K]) {
  const float r[3] = {a.x, a.y, a.z};
  bool same = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    same = same && __float_as_uint(r[k]) == __float_as_uint(b[k]);
  }
  return same;
}

template <int K>
__device__ __forceinline__ float4 row4(const float (&v)[K]) {
  return make_float4(v[0], K > 1 ? v[K > 1 ? 1 : 0] : 0.0f,
                     K > 2 ? v[K > 2 ? 2 : 0] : 0.0f, 0.0f);
}

template <int K>
__device__ __forceinline__ void from4(float (&v)[K], float4 a) {
  const float r[3] = {a.x, a.y, a.z};
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = r[k];
}

// The identity map on K states, 2 bits per state.
template <int K>
__host__ __device__ constexpr uint32_t identity_map() {
  return K == 1 ? 0u : K == 2 ? 0x04u : 0x24u;
}

// Every state mapped to state 1: a constant map is its value times this.
template <int K>
__host__ __device__ constexpr uint32_t ones_map() {
  return K == 1 ? 0x1u : K == 2 ? 0x5u : 0x15u;
}

// One frame of the scan: updates v, returns the frame's code byte.
template <int K>
__device__ __forceinline__ uint32_t step(float (&v)[K], const float (&e)[K],
                                         bool rst, const float (&tr)[K][K],
                                         const float (&ini)[K]) {
  float vn[K];
  uint32_t ptrs = 0;
#pragma unroll
  for (int kp = 0; kp < K; ++kp) {
    float best = __fadd_rn(v[0], tr[0][kp]);
    uint32_t arg = 0;
#pragma unroll
    for (int k = 1; k < K; ++k) {
      const float c = __fadd_rn(v[k], tr[k][kp]);
      if (takes_over(c, best)) { best = c; arg = k; }
    }
    vn[kp] = __fadd_rn(e[kp], rst ? ini[kp] : best);
    ptrs |= arg << (2 * kp);
  }
  float m = vn[0];
  uint32_t am = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (takes_over(vn[k], m)) { m = vn[k]; am = k; }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __fsub_rn(vn[k], m);
  if (m != m) am = 0;
  return (rst ? 3u : ptrs) | (am << 6);
}

struct Problem {
  const float* em;        // (T, K), 16-byte aligned
  const uint8_t* reset;   // (T,), 8-byte aligned
  const float* trans;     // (K, K)
  const float* init;      // (K,)
  int T, L, P;            // frames, frames per chunk, chunks
  float4* vbuf;           // (ceil(T / GROUP),) the renormalised scores (K
                          // of x..z) after each group's last frame
  uint8_t* code;          // (GROUP * ceil(T / GROUP),) code bytes
  float4* exits;          // (3, P): a chunk's exit v by pass parity, then
                          // its entry for the walk
  int32_t* ctl;           // [0..2] per-pass "go on" flags (pass p uses p % 3
                          // and clears (p + 1) % 3), [3] the pass count,
                          // [4] chunks walked, [5..5+gridDim) block summaries
  int32_t* states;        // (T,) out
};

// The inputs of the GROUP frames from t0 (t0 a multiple of GROUP): in
// 16-byte loads while the group lies inside the sequence, else clamped to
// its last frame.  With CHECK, the stored row of the group.
template <int K, bool CHECK>
struct Group {
  float e[GROUP][K];
  bool rst[GROUP];
  float4 old;

  __device__ __forceinline__ void load(const Problem& pr, int t0) {
    if (t0 + GROUP <= pr.T) {
      const float4* e4 = reinterpret_cast<const float4*>(pr.em) +
                         (size_t)t0 * K / 4;
      float f[GROUP * K];
#pragma unroll
      for (int i = 0; i < GROUP * K / 4; ++i) {
        const float4 x = __ldg(e4 + i);
        f[4 * i] = x.x;
        f[4 * i + 1] = x.y;
        f[4 * i + 2] = x.z;
        f[4 * i + 3] = x.w;
      }
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(pr.reset + t0));
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
#pragma unroll
        for (int k = 0; k < K; ++k) e[g][k] = f[g * K + k];
        rst[g] = (((g < 4 ? r.x : r.y) >> (8 * (g % 4))) & 0xffu) != 0;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int t = min(t0 + g, pr.T - 1);
        rst[g] = __ldg(pr.reset + t) != 0;
#pragma unroll
        for (int k = 0; k < K; ++k) e[g][k] = __ldg(pr.em + (size_t)t * K + k);
      }
    }
    rst[0] = rst[0] || t0 == 0;
    if (CHECK) old = __ldcg(pr.vbuf + min(t0, pr.T - 1) / GROUP);
  }
};

// Runs frames [a, b) from v; a is a multiple of GROUP, as every chunk's
// start is, and so is b but at the end of the sequence.  Whole groups run,
// with no branch inside one: the last group of the sequence runs on past T
// over copies of frame T - 1, and nothing reads what it computes there
// (the code bytes past T, the last chunk's exit; its check still stops
// only after every real frame of the group is written).  Writes each
// frame's code byte, and the scores after each group's last frame.  With CHECK, stops at the end of the first group
// whose new scores are bit-equal to the stored ones: from there on every
// frame would recompute its stored values.  With exits (the walk), stores
// v as the exit of every chunk it completes without stopping.  Returns the
// last frame run if it stopped, else -1.
template <int K, bool CHECK>
__device__ __forceinline__ int run_frames(const Problem& pr, float (&v)[K],
                                          int a, int b,
                                          const float (&tr)[K][K],
                                          const float (&ini)[K],
                                          float4* exits) {
  Group<K, CHECK> cur, nxt;
  cur.load(pr, a);
  for (int t0 = a; t0 < b; t0 += GROUP) {
    nxt.load(pr, t0 + GROUP);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const uint32_t cd = step<K>(v, cur.e[g], cur.rst[g], tr, ini);
      if (g < 4) {
        lo |= cd << (8 * g);
      } else {
        hi |= cd << (8 * (g - 4));
      }
    }
    *reinterpret_cast<uint2*>(pr.code + t0) = make_uint2(lo, hi);
    const int te = min(t0 + GROUP, b);
    if (CHECK && same_row<K>(cur.old, v)) return te - 1;
    pr.vbuf[t0 / GROUP] = row4<K>(v);
    if (exits != nullptr && (te % pr.L == 0 || te == pr.T)) {
      exits[(te - 1) / pr.L] = row4<K>(v);
    }
    cur = nxt;
  }
  return -1;
}

// The serial walk, by block 0 (every thread calls it; thread 0 runs the
// chunks).  exits: the last pass's exits; entries: each chunk's entry.
template <int K>
__device__ void walk(const Problem& pr, float4* exits, const float4* entries,
                     const float (&tr)[K][K], const float (&ini)[K],
                     int& s_next) {
  const int P = pr.P;
  int from = 1, walked = 0;
  for (;;) {
    // the first chunk from `from` on whose entry differs from its
    // neighbour's exit; the chunks before it are exact
    if (threadIdx.x == 0) s_next = P;
    __syncthreads();
    for (int base = from; base < P; base += THREADS) {
      const int i = base + threadIdx.x;
      float ent[K];
      bool hit = false;
      if (i < P) {
        from4<K>(ent, __ldcg(entries + i));
        hit = !same_row<K>(__ldcg(exits + i - 1), ent);
      }
      if (hit) atomicMin(&s_next, i);
      if (__syncthreads_or(hit)) break;
    }
    const int first = s_next;
    __syncthreads();
    if (first >= P) break;
    if (threadIdx.x == 0) {
      // one run through the chunks from `first` on, until it stops on a
      // stored row; the exit of the chunk where it stops stands
      float v[K];
      from4<K>(v, __ldcg(exits + first - 1));
      const int stop = run_frames<K, true>(pr, v, first * pr.L, pr.T, tr, ini,
                                           exits);
      const int last = stop < 0 ? P - 1 : stop / pr.L;
      walked += last - first + 1;
      s_next = last + 1;
    }
    __syncthreads();
    from = s_next;
    __syncthreads();
  }
  if (threadIdx.x == 0) pr.ctl[4] = walked;
}

// (a o b)(j) = a(b(j))
template <int K>
__device__ __forceinline__ uint32_t compose(uint32_t a, uint32_t b) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out |= ((a >> (2 * ((b >> (2 * j)) & 3u))) & 3u) << (2 * j);
  }
  return out;
}

// m_t o f, where m_t(j) = amax[t] if frame t ends a segment (the next code
// marks a reset), else ptr[t+1][j].
template <int K>
__device__ __forceinline__ uint32_t after_frame(uint32_t cd, uint32_t nxt,
                                                uint32_t f) {
  if ((nxt & 3u) == 3u) return (cd >> 6) * ones_map<K>();
  return compose<K>(nxt, f);
}

// s[i] <- s[i] o s[i+1] o ... o s[THREADS-1]
template <int K>
__device__ void suffix_scan(uint8_t* s) {
  const int i = threadIdx.x;
#pragma unroll 1
  for (int d = 1; d < THREADS; d <<= 1) {
    uint32_t val = s[i];
    if (i + d < THREADS) val = compose<K>(val, s[i + d]);
    __syncthreads();
    s[i] = (uint8_t)val;
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS) viterbi_kernel(const Problem pr) {
  const int T = pr.T, L = pr.L, P = pr.P;
  float4* exits = pr.exits;
  int32_t* ctl = pr.ctl;
  __shared__ uint8_t s_map[THREADS];
  __shared__ int s_next;
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool live = c < P;
  const int a = live ? c * L : T;
  const int b = live ? min(a + L, T) : T;

  float tr[K][K], ini[K], v[K], ent[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    ini[i] = pr.init[i];
    v[i] = ent[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) tr[i][j] = pr.trans[i * K + j];
  }

  // ---- pass 0: speculative forward from v = 0 ---------------------------
  if (lead) {
    ctl[1] = 0;
    ctl[4] = 0;
  }
  if (live) run_frames<K, false>(pr, v, a, b, tr, ini, nullptr);
  float4 ex = row4<K>(v);
  if (live) exits[c] = ex;
  grid.sync();

  // ---- fix-up passes -----------------------------------------------------
  int pass = 0;
  bool more = P > 1;
  while (more && pass < PASS_CAP) {
    ++pass;
    if (lead) ctl[(pass + 1) % 3] = 0;
    bool go_on = false;
    if (live && c > 0) {
      const float4 n4 = __ldcg(exits + (size_t)((pass - 1) & 1) * P + c - 1);
      if (!same_row<K>(n4, ent)) {
        from4<K>(ent, n4);
        from4<K>(v, n4);
        if (run_frames<K, true>(pr, v, a, b, tr, ini, nullptr) < 0) {
          ex = row4<K>(v);
          go_on = c < P - 1;
        }
      }
    }
    if (live) exits[(size_t)(pass & 1) * P + c] = ex;
    if (__syncthreads_or(go_on) && threadIdx.x == 0) {
      atomicOr(ctl + pass % 3, 1);
    }
    grid.sync();
    more = __ldcg(ctl + pass % 3) != 0;
  }
  if (lead) ctl[3] = pass + 1;

  // ---- the serial walk, when the passes did not converge ----------------
  if (more) {                          // the same on every thread
    if (live) exits[(size_t)2 * P + c] = row4<K>(ent);
    grid.sync();
    if (blockIdx.x == 0) {
      walk<K>(pr, exits + (size_t)(pass & 1) * P, exits + (size_t)2 * P, tr,
              ini, s_next);
    }
    grid.sync();
  }

  // ---- backtrack -----------------------------------------------------------
  // F maps the state after the chunk's last frame to the state of its first.
  const uint32_t next_code = b < T ? (uint32_t)__ldcg(pr.code + b) : 3u;
  uint32_t f = identity_map<K>();
  if (live) {
    uint32_t nxt = next_code;
    for (int t = b - 1; t >= a; --t) {
      const uint32_t cd = __ldcg(pr.code + t);
      f = after_frame<K>(cd, nxt, f);
      nxt = cd;
    }
  }
  s_map[threadIdx.x] = (uint8_t)f;
  __syncthreads();
  suffix_scan<K>(s_map);
  const uint32_t later = threadIdx.x + 1 < THREADS ? s_map[threadIdx.x + 1]
                                                   : identity_map<K>();
  if (threadIdx.x == 0) ctl[5 + blockIdx.x] = s_map[0];
  grid.sync();
  // the state after this block's last frame: later blocks' summaries applied
  // to the arbitrary state 0 after the sequence's last frame
  s_map[threadIdx.x] = (uint8_t)(
      threadIdx.x > blockIdx.x && threadIdx.x < gridDim.x
          ? (uint32_t)__ldcg(ctl + 5 + threadIdx.x) : identity_map<K>());
  __syncthreads();
  suffix_scan<K>(s_map);
  const uint32_t y = s_map[0] & 3u;
  if (live) {
    uint32_t x = (later >> (2 * y)) & 3u;
    uint32_t nxt = next_code;
    for (int t = b - 1; t >= a; --t) {
      const uint32_t cd = __ldcg(pr.code + t);
      x = (nxt & 3u) == 3u ? cd >> 6 : (nxt >> (2 * x)) & 3u;
      pr.states[t] = (int32_t)x;
      nxt = cd;
    }
  }
}

template <int K>
cudaError_t launch(int blocks, cudaStream_t s, Problem pr) {
  void* args[] = {&pr};
  return cudaLaunchCooperativeKernel((const void*)viterbi_kernel<K>,
                                     dim3(blocks), dim3(THREADS), args, 0, s);
}

}  // namespace

// emission (T,K) f32 (16-byte aligned), reset (T,) bool bytes (8-byte
// aligned), trans (K,K) f32, init (K,) f32.  The chunks are spread over at
// most max_blocks blocks of 256 threads (1 <= max_blocks <= 256; one per
// SM).  Scratch, 16-byte aligned: vbuf (ceil(T/8), 4) f32, code
// (8 * ceil(T/8),) bytes, exits (3, min(T, 256 * max_blocks), 4) f32, ctl
// (5 + max_blocks,) int32; after the run ctl[3] is the pass count and ctl[4]
// the chunks walked.  states (T,) int32 out.  Returns the launch's
// cudaError_t.
extern "C" int iss_viterbi(const float* em, const uint8_t* reset,
                           const float* trans, const float* init, long long T,
                           int K, int max_blocks, float* vbuf, uint8_t* code,
                           float* exits, int32_t* ctl, int32_t* states,
                           void* stream) {
  if (T <= 0 || T > INT_MAX / 2 || max_blocks < 1 || max_blocks > THREADS ||
      (uintptr_t)em % 16 != 0 || (uintptr_t)reset % 8 != 0 ||
      (uintptr_t)vbuf % 16 != 0 || (uintptr_t)code % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long cap = (long long)max_blocks * THREADS;
  long long L = (T + cap - 1) / cap;
  if (L < CHUNK_MIN) L = CHUNK_MIN;
  L = (L + GROUP - 1) / GROUP * GROUP;
  Problem pr{em, reset, trans, init, (int)T, (int)L, (int)((T + L - 1) / L),
             reinterpret_cast<float4*>(vbuf), code,
             reinterpret_cast<float4*>(exits), ctl, states};
  const int blocks = (pr.P + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (K) {
    case 1: err = launch<1>(blocks, s, pr); break;
    case 2: err = launch<2>(blocks, s, pr); break;
    case 3: err = launch<3>(blocks, s, pr); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The general-K decode: any number of states (1 <= K <= GK_MAX), which the
// decode above cannot take (its 2-bit back-pointers cap it at K <= 3).
// viterbi_scan routes K > 3 here: viterbi_decoding's minimum-duration
// expansion (consecutive = 10 on 3 states is K = 30) and per-frame
// constraints on many states.
//
// Replaces the same lax.scan, inaspeechsegmenter_tpu/decode/viterbi.py::
// _viterbi_scan, at any K.  A simple design that is exact first:
//   - one block for the sequence, its threads striding over the K states
//     (a warp up to K = 32); the renormalised scores v in shared memory,
//     and the transition matrix too when it fits (K <= 204), else read
//     through the cache; the emissions and reset flags of the next
//     stretch of frames (16 KB of them) staged in shared memory by the
//     whole block, so the serial chain waits on shared memory, not on
//     device memory;
//   - per frame, each state k' takes the max over k of v[k] + tr[k][k'],
//     the first index winning ties and a NaN winning as in jnp.argmax /
//     jnp.max; then em[t][k'] + max (em + init at a reset, with identity
//     pointers); a block reduction gives the max and its first index; v
//     becomes v - max;
//   - back-pointers one byte a state a frame (two bytes when K > 256), the
//     frame's argmax in an int32;
//   - a serial backtrack by one thread, from pointer rows that the block
//     stages in shared memory a stretch at a time.
// What bounds it: the dependence from frame to frame, as for the decode
// above (the bytes, T * K * 4 of emissions, take microseconds); a frame
// costs K dependent adds and compares a thread plus a reduction and one or
// two barriers.  Its first version loaded each frame's inputs from device
// memory one frame ahead, and that latency set its pace (385 ms at
// T = 180,000, K = 30 on the H100); staging them in stretches leaves the
// chain of shared-memory reads.  The chunk-parallel scheme above would
// lift the serial chain itself; it is not done here.
// The float ops are _viterbi_scan's, one rounding each (__fadd_rn,
// __fsub_rn): the states equal viterbi_scan_plain's bit for bit, NaN rows
// included (an all -inf frame gives NaN scores, argmax 0).

namespace {

constexpr int GK_MAX = 8192;          // states
constexpr int GK_PER_THREAD = 8;      // states a thread, at most
constexpr int GK_TR_SMEM_MAX = 204;   // K whose K*K transitions sit in
                                      // shared memory (166,464 bytes)
constexpr int GK_STAGE_BYTES = 16384; // inputs staged for the forward,
                                      // pointers for the backtrack

// (bv, bi) <- the winner of (bv, bi) and (cv, ci) under jnp.argmax's rule
// over indices: a NaN wins (the first one), else the greater value, ties
// to the lower index.
__device__ __forceinline__ void gk_combine(float& bv, int& bi, float cv,
                                           int ci) {
  const bool bn = bv != bv, cn = cv != cv;
  const bool take = (bn || cn) ? (cn && (!bn || ci < bi))
                               : (cv > bv || (cv == bv && ci < bi));
  if (take) {
    bv = cv;
    bi = ci;
  }
}

// up to 1024 threads: the register budget is 64 a thread (K > 992 spills
// the per-state arrays to local memory rather than fail to launch)
template <typename PtrT>
__global__ void __launch_bounds__(1024) viterbi_general_kernel(
    const float* __restrict__ em, const uint8_t* __restrict__ reset,
    const float* __restrict__ trans, const float* __restrict__ init, int T,
    int K, bool tr_smem, PtrT* ptr, int32_t* amax, int32_t* states) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);               // (K,)
  float* red_v = v + K;                                    // (32,)
  int* red_i = reinterpret_cast<int*>(red_v + 32);         // (32,)
  float* tr_s = reinterpret_cast<float*>(red_i + 32);      // (K, K) or none
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(tr_s + (tr_smem ? K * K : 0));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const float* tr = tr_smem ? tr_s : trans;
  if (tr_smem) {
    for (int i = tid; i < K * K; i += nt) tr_s[i] = trans[i];
  }
  float ini[GK_PER_THREAD], vn[GK_PER_THREAD];
#pragma unroll
  for (int s = 0; s < GK_PER_THREAD; ++s) {
    const int k = tid + s * nt;
    ini[s] = k < K ? init[k] : 0.0f;
  }

  // ---- forward: the inputs of G frames staged at a time -----------------
  // (the chain of frames waits on shared memory, not on device memory)
  int G = GK_STAGE_BYTES / (K * (int)sizeof(float) + 1);
  if (G < 1) G = 1;
  float* s_em = reinterpret_cast<float*>(stage);           // (G, K)
  uint8_t* s_rst = reinterpret_cast<uint8_t*>(s_em + (size_t)G * K);  // (G,)
  for (int t0 = 0; t0 < T; t0 += G) {
    const int g = T - t0 < G ? T - t0 : G;
    __syncthreads();                   // the previous stretch is read
    for (int i = tid; i < g * K; i += nt) s_em[i] = em[(size_t)t0 * K + i];
    for (int j = tid; j < g; j += nt) {
      s_rst[j] = t0 + j == 0 || reset[t0 + j] != 0;   // frame 0 starts
    }
    __syncthreads();
    for (int j = 0; j < g; ++j) {
      const int t = t0 + j;
      const bool rst = s_rst[j] != 0;
      const float* e = s_em + (size_t)j * K;
      float bv = __int_as_float(0xff800000);   // -inf
      int bi = INT_MAX;
#pragma unroll
      for (int s = 0; s < GK_PER_THREAD; ++s) {
        const int k2 = tid + s * nt;
        if (k2 >= K) break;
        float sc;
        int arg;
        if (rst) {
          sc = ini[s];
          arg = k2;
        } else {
          float best = __fadd_rn(v[0], tr[k2]);
          arg = 0;
          for (int k = 1; k < K; ++k) {
            const float c = __fadd_rn(v[k], tr[(size_t)k * K + k2]);
            if (best == best && !(c <= best)) {
              best = c;
              arg = k;
            }
          }
          sc = best;
        }
        vn[s] = __fadd_rn(e[k2], sc);
        ptr[(size_t)t * K + k2] = (PtrT)arg;
        gk_combine(bv, bi, vn[s], k2);
      }
      // the row's max and its first index over the block
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, d);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, d);
        gk_combine(bv, bi, ov, oi);
      }
      if (nwarps > 1) {
        if (lane == 0) {
          red_v[warp] = bv;
          red_i[warp] = bi;
        }
        __syncthreads();
        bv = red_v[0];
        bi = red_i[0];
        for (int w = 1; w < nwarps; ++w) {
          gk_combine(bv, bi, red_v[w], red_i[w]);
        }
      }
      // every v[k] was read above (with several warps, the barrier of the
      // reduction orders the writes below after those reads)
      if (nwarps == 1) __syncwarp();
#pragma unroll
      for (int s = 0; s < GK_PER_THREAD; ++s) {
        const int k2 = tid + s * nt;
        if (k2 >= K) break;
        v[k2] = __fsub_rn(vn[s], bv);
      }
      if (tid == 0) amax[t] = bv != bv ? 0 : bi;
      if (nwarps == 1) __syncwarp(); else __syncthreads();
    }
  }
  __syncthreads();

  // ---- backtrack: stretches of F frames staged in shared memory --------
  // staged row j is frame lo + j for amax, frame lo + 1 + j for the
  // pointers and the reset flag (a segment end when set)
  const int row = K * (int)sizeof(PtrT);
  int F = GK_STAGE_BYTES / (row + 5);
  if (F < 1) F = 1;
  int32_t* s_amax = reinterpret_cast<int32_t*>(stage);
  PtrT* s_ptr = reinterpret_cast<PtrT*>(s_amax + F);
  uint8_t* s_end = reinterpret_cast<uint8_t*>(s_ptr + (size_t)F * K);
  int x = 0;
  for (int hi = T; hi > 0; hi -= F) {
    const int lo = hi - F > 0 ? hi - F : 0;
    const int n = hi - lo;
    __syncthreads();                   // the previous stretch is walked
    for (int j = tid; j < n; j += nt) {
      s_amax[j] = amax[lo + j];
      s_end[j] = lo + 1 + j >= T ? 1 : reset[lo + 1 + j];
    }
    const int n_ptr = lo + n < T ? n : n - 1;   // rows that exist
    for (int i = tid; i < n_ptr * K; i += nt) {
      s_ptr[i] = ptr[(size_t)(lo + 1) * K + i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = n - 1; j >= 0; --j) {
        x = s_end[j] ? s_amax[j] : (int)s_ptr[(size_t)j * K + x];
        states[lo + j] = x;
      }
    }
  }
}

template <typename PtrT>
cudaError_t launch_general(const float* em, const uint8_t* reset,
                           const float* trans, const float* init, int T,
                           int K, void* ptr, int32_t* amax, int32_t* states,
                           cudaStream_t s) {
  int nt = (K + 31) / 32 * 32;
  if (nt > 1024) nt = 1024;
  const bool tr_smem = K <= GK_TR_SMEM_MAX;
  // the staging area serves the forward (G frames of K floats and a flag)
  // and then the backtrack (F frames of K pointers, an argmax and a flag)
  size_t stage = GK_STAGE_BYTES;
  const size_t fwd_row = (size_t)K * sizeof(float) + 1;
  const size_t bwd_row = (size_t)K * sizeof(PtrT) + 5;
  if (fwd_row > stage) stage = fwd_row;
  if (bwd_row > stage) stage = bwd_row;
  const size_t smem = ((size_t)K + 64) * sizeof(float) +
                      (tr_smem ? (size_t)K * K * sizeof(float) : 0) + stage;
  const void* fn = (const void*)viterbi_general_kernel<PtrT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  viterbi_general_kernel<PtrT><<<1, nt, smem, s>>>(
      em, reset, trans, init, T, K, tr_smem, reinterpret_cast<PtrT*>(ptr),
      amax, states);
  return cudaGetLastError();
}

}  // namespace

// emission (T,K) f32, reset (T,) bool bytes, trans (K,K) f32, init (K,)
// f32, 1 <= K <= 8192.  Scratch: ptr (T,K) uint8 when K <= 256, else
// uint16; amax (T,) int32.  states (T,) int32 out.  Returns the launch's
// cudaError_t.
extern "C" int iss_viterbi_general(const float* em, const uint8_t* reset,
                                   const float* trans, const float* init,
                                   long long T, int K, void* ptr,
                                   int32_t* amax, int32_t* states,
                                   void* stream) {
  if (T <= 0 || T > INT_MAX || K < 1 || K > GK_MAX ||
      (K + 1023) / 1024 > GK_PER_THREAD) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      K <= 256 ? launch_general<uint8_t>(em, reset, trans, init, (int)T, K,
                                         ptr, amax, states, s)
               : launch_general<uint16_t>(em, reset, trans, init, (int)T, K,
                                          ptr, amax, states, s);
  return (int)err;
}
