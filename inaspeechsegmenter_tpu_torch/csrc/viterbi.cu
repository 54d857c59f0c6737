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
// _viterbi_scan, at any K.  What bounds it: the dependence from frame to
// frame, as above; the bytes (T * K * 4 of emissions) take microseconds.
// One cooperative launch, five parts split by grid barriers (times: T =
// 180,000 on an H100 at 700 W, tools/torch_viterbi_ab.py, which reads each
// part's end from ctl[8..12]):
//   1. A values-only forward chain.  A frame computes only the next row,
//      vn[k'] = em[t][k'] + max_k fl(v[k] + tr[k][k']) (em + init at a
//      reset), its max M and v = fl(vn - M), and stores the row (T * K
//      floats).  No pointer and no argmax sits on the chain: they are
//      parts 3 and 4.  The max of a column is a tree of PTX max.NaN.f32,
//      which returns NaN when an operand is NaN, as jnp.max does (fmaxf
//      drops it); its value does not depend on the order.  The row max is
//      one redux.sync.max.u32 over an order-preserving integer map of the
//      floats with every NaN on top.  A team holds a row: for K <= 32 one
//      warp, lane k' keeping its column of the transition matrix in
//      registers and reading v[k] as float4 broadcasts from a
//      double-buffered row in shared memory (one __syncwarp a frame); for
//      K > 32 one block, a thread per state (8 states a thread above
//      1,024), the transitions in shared memory up to K = GK_TR_SMEM_MAX,
//      two barriers a frame.  A warp's frame costs about 400 cycles at K =
//      30 (0.20 us): the adds and the max tree, the row max and the shared
//      row's round trip are each on the chain (tools/viterbi_chain_bench.cu
//      times them apart), so the row stores and the bit compare of part 2
//      are taken off it: the rows go out and the compare is made once a
//      group of GROUP frames and at a chunk's last frame.
//      Signed zeros: a state depends on comparisons of real values only, so
//      the sign of a zero never changes one.  v = vn - M <= +0, and a state
//      whose vn has M's bits gives x - x = +0; a -0 can reach a row only
//      from a -0 emission added to a -0 max, and every run of the kernel
//      computes each row with the same instructions, so the bit compare
//      of part 2 sees equal bits for equal inputs.
//   2. Chunk-parallel passes where rows converge (the scheme of iss_viterbi
//      above, steps 1-4): P chunks of L frames, one team each (8 warps a
//      block of 256 threads for K <= 32, one block per SM); a speculative
//      pass from zero rows; fix-up passes from the left neighbour's exit,
//      each stopping in the first chunk frame whose new row is bit-equal
//      (__float_as_uint, so NaN rows converge too) to the stored row; after
//      PASS_CAP passes a serial walk by one team on the same values-only
//      chain.  Exact by the same induction.  Why this split: a decode whose
//      rows forget their entry within a few frames (random dense K = 30, K
//      = 8 with constraints) converges in 2 passes, 0.05 ms.  A uniform
//      `consecutive` expansion never does: every cycle of its graph has
//      length c, so the states fall into c phase classes that no path
//      crosses, and the offsets between the classes are kept for ever.
//      There the passes run to the cap and the walk takes the rest of the
//      sequence: at K = 30, 3.3 ms of passes (64 of L = 171 frames on 132
//      SMs, 1,053 chunks) and 34.4 ms of walk (988 chunks), so the cap costs
//      a tenth of the walk and there is no early switch.
//   3. Back-pointers and argmax off the chain, in parallel over (t, k'):
//      the backtrack's map of frame t, m[t][j] = argmax_k fl(v[t][k] +
//      tr[k][j]) (the next frame's pointer), or argmax v[t] for every j when
//      frame t ends a segment (the next frame resets, or t = T - 1), by
//      jnp.argmax's rule (the first index of the max; a NaN wins, the first
//      one), as a tree whose combines keep the lower indices on the left.
//      One byte a state a frame (two above 256 states); T * K * K adds
//      (0.16 G at K = 30), a warp per 16 frames: 0.075 ms at K = 30.
//   4. The backtrack by map composition, as iss_viterbi's step 5 with
//      K-element maps: each team composes its chunk's maps, staged in
//      shared memory in aligned 16-byte words, into one summary F_c (the
//      state at the chunk's first frame as a function of the state after
//      its last), 0.006 ms; then block 0 chains the P summaries from the
//      last chunk (its 8 warps each compose a range, one thread chains the
//      ranges, each warp its range), giving each chunk the state after its
//      last frame, 0.008 ms;
//   5. and each team walks its chunk backward, writing states.
// The float ops are _viterbi_scan's, one rounding each (__fadd_rn,
// __fsub_rn): the states equal viterbi_scan_plain's bit for bit, NaN rows
// included (an all -inf frame gives NaN scores, argmax 0).
// Scratch: the rows T * K * 4 bytes, the maps T * K (or 2 T * K), the exits
// and entries 3 * P * K * 4, the summaries P * K (or 2 P * K), P chunk
// states: 27.4 MB at T = 180,000, K = 30 (rows 21.6 MB, maps 5.4 MB).  At
// K = 8192, 49,152 bytes a frame beside the 32,768 of the emissions: about
// a million frames fill an 80 GB card.

namespace {

constexpr int GK_MAX = 8192;          // states
constexpr int GK_PER_THREAD = 8;      // states a thread, at most
constexpr int GK_WARPS = 8;           // warp teams a block, K <= 32
constexpr int GK_TR_SMEM_MAX = 200;   // K whose K*K transitions a block
                                      // team keeps in shared memory
constexpr int GK_WARP_STAGE = 4096;   // bytes of maps a warp team stages
constexpr int GK_STAGE = GK_WARPS * GK_WARP_STAGE;  // a block's staging
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// An order-preserving map of floats to unsigned keys, every NaN on top.
__device__ __forceinline__ uint32_t fkey(float x) {
  const uint32_t u = __float_as_uint(x);
  if (x != x) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key (a NaN for the NaN key).
__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// c[0] <- the max of c[0 .. 2W), a tree with constant indices (so that c
// stays in registers)
template <int W>
__device__ __forceinline__ void tree_max(float* c) {
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = max_nan(c[k], c[k + W]);
  if constexpr (W > 1) tree_max<W / 2>(c);
}

// (c[0], i[0]) <- the first index of the max of c[0 .. KB) and its value,
// by jnp.argmax's rule (a NaN wins, the first one): a tree whose every
// combine has the lower indices on its left, where the right wins only if
// it takes over, so ties keep the lower index as the linear scan does.
template <int S, int KB>
__device__ __forceinline__ void tree_argmax(float* c, int* i) {
#pragma unroll
  for (int k = 0; k < KB; k += 2 * S) {
    const bool r = takes_over(c[k + S], c[k]);
    c[k] = r ? c[k + S] : c[k];
    i[k] = r ? i[k + S] : i[k];
  }
  if constexpr (2 * S < KB) tree_argmax<2 * S, KB>(c, i);
}

// the device's nanosecond clock
__device__ __forceinline__ unsigned long long gk_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

struct GkProblem {
  const float* em;       // (T, K)
  const uint8_t* reset;  // (T,)
  const float* trans;    // (K, K)
  const float* init;     // (K,)
  int T, K, L, P;        // frames, states, frames a chunk, chunks
  float* rows;           // (T, K) every frame's renormalised scores
  float* exits;          // (3, P, K): exits by pass parity, then entries
  void* maps;            // (T, K) the backtrack's maps (PtrT)
  void* sums;            // (P, K) the chunks' summaries (PtrT)
  int32_t* xb;           // (P,) the state after each chunk's last frame
  int32_t* ctl;          // [0..2] go-on flags, [3] passes, [4] chunks
                         // walked, [5] P, [6] L, [8..12] the ns from the
                         // start to the end of part 2's passes, the walk,
                         // parts 3, 4's summaries, 4's chain (block 0's
                         // clock, after each grid barrier)
  int32_t* states;       // (T,) out
};

// One warp holds a row (K <= KB <= 32): lane k' keeps state k'.
template <int KB>
struct WarpTeam {
  static constexpr int S = 1;         // states a thread
  static constexpr int PER_BLOCK = GK_WARPS;
  float trc[KB];                      // trans[k][lane], -inf past K
  float ini;
  int K, lane, team;
  bool on;                            // lane < K
  float* sv;                          // 2 x 32 floats: the row, twice
  unsigned char* stage;               // GK_WARP_STAGE bytes
  int* s_next;                        // the block's walk cursor

  __device__ void setup(const GkProblem& pr, unsigned char* smem) {
    K = pr.K;
    lane = threadIdx.x & 31;
    team = threadIdx.x >> 5;
    on = lane < K;
    sv = reinterpret_cast<float*>(smem) + team * 64;
    stage = smem + GK_WARPS * 64 * sizeof(float) + team * GK_WARP_STAGE;
    s_next = reinterpret_cast<int*>(smem + GK_WARPS * 64 * sizeof(float) +
                                    GK_STAGE);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      trc[k] = k < K && on ? pr.trans[k * K + lane]
                           : __int_as_float(0xff800000);
    }
    ini = on ? pr.init[lane] : 0.0f;
  }
  __device__ unsigned char* block_stage(unsigned char* smem) const {
    return smem + GK_WARPS * 64 * sizeof(float);
  }
  __device__ int state(int) const { return lane; }
  __device__ bool has(int) const { return on; }
  __device__ bool leader() const { return lane == 0; }
  __device__ void sync() const { __syncwarp(); }
  __device__ void load_row(const float* p, float (&v)[S]) const {
    v[0] = on ? __ldcg(p + lane) : 0.0f;
  }
  __device__ void store_row(float* p, const float (&v)[S]) const {
    if (on) p[lane] = v[0];
  }
  __device__ bool same_row(const float* p, const float (&v)[S]) const {
    return __all_sync(FULL, !on || same_bits(__ldcg(p + lane), v[0]));
  }
  template <typename PtrT>
  __device__ int stage_rows() const {
    return (GK_WARP_STAGE - 16) / (K * (int)sizeof(PtrT));
  }

  // Runs frames [a, b) from the row v (the entry); v is the last row on
  // return.  Stores every row, and with exits (the walk) each completed
  // chunk's exit.  With CHECK, stops at the first check point (the last
  // frame of a group of G, of a chunk, of the run) whose new row is
  // bit-equal to the stored one and returns it; else returns -1.  A check
  // at every frame would stop in the same chunk (from the first equal row
  // on, every row of the chunk equals its stored one) and puts a vote on
  // the chain.
  template <bool CHECK>
  __device__ int run(const GkProblem& pr, float (&v)[S], int a, int b,
                     float* exits) {
    constexpr int G = GROUP;          // frames whose inputs load ahead
    const int T = pr.T;
    // the next group's inputs load while this group runs: nothing reads
    // them (not even the reset bytes) before then
    float ce[G], co[G], ne[G], no[G];
    int cr[G], nr[G];
    auto load = [&](int t0, float (&e)[G], float (&o)[G], int (&r)[G]) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int t = min(t0 + g, T - 1);
        e[g] = on ? __ldg(pr.em + (size_t)t * K + lane) : 0.0f;
        o[g] = CHECK && on ? __ldcg(pr.rows + (size_t)t * K + lane) : 0.0f;
        r[g] = __ldg(pr.reset + t);
      }
    };
    int cur = 0;
    sv[lane] = on ? v[0] : 0.0f;
    __syncwarp();
    int edge = min((a / pr.L + 1) * pr.L, T);  // the end of a's chunk
    float xs[G];                      // the group's rows, stored together
    load(a, ce, co, cr);
    for (int t0 = a; t0 < b; t0 += G) {
      load(t0 + G, ne, no, nr);
      int f0 = 0;                     // the group's first row not stored
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int t = t0 + g;
        if (t >= b) break;
        const float* row = sv + cur * 32;
        float c[KB];
#pragma unroll
        for (int k = 0; k < KB; k += 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + k);
          c[k] = __fadd_rn(x.x, trc[k]);
          c[k + 1] = __fadd_rn(x.y, trc[k + 1]);
          c[k + 2] = __fadd_rn(x.z, trc[k + 2]);
          c[k + 3] = __fadd_rn(x.w, trc[k + 3]);
        }
        tree_max<KB / 2>(c);
        const bool rst = cr[g] != 0 || t == 0;
        const float vn = __fadd_rn(ce[g], rst ? ini : c[0]);
        const float m = unkey(__reduce_max_sync(FULL, on ? fkey(vn) : 0u));
        const float x = __fsub_rn(vn, m);
        v[0] = x;
        xs[g] = x;
        cur ^= 1;
        sv[cur * 32 + lane] = on ? x : 0.0f;   // the next frame's row
        if (g == G - 1 || t + 1 == edge || t + 1 == b) {
          // a check point: the rows since the last one go out together
          // (off the chain), then the compare
#pragma unroll
          for (int h = 0; h < G; ++h) {
            if (on && h >= f0 && h <= g) {
              pr.rows[(size_t)(t0 + h) * K + lane] = xs[h];
            }
          }
          f0 = g + 1;
          if (t + 1 == edge) {
            if (exits != nullptr && on) {
              exits[(size_t)(t / pr.L) * K + lane] = x;
            }
            edge = min(edge + pr.L, T);
          }
          if (CHECK && __all_sync(FULL, !on || same_bits(x, co[g]))) {
            return t;
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ce[g] = ne[g];
        co[g] = no[g];
        cr[g] = nr[g];
      }
    }
    return -1;
  }

  // Part 3 for groups of MG consecutive frames a warp, grid-strided: the
  // group's rows load coalesced into the warp's staging area, and its
  // frames' argmax chains are independent (each lane a state).
  template <typename PtrT>
  __device__ void maps_pass(const GkProblem& pr) {
    constexpr int MG = 16;            // frames a group (MG * KB floats)
    PtrT* maps = reinterpret_cast<PtrT*>(pr.maps);
    float* buf = reinterpret_cast<float*>(stage);   // (MG, KB), -inf past K
    const int T = pr.T;
    const int total = gridDim.x * GK_WARPS;
    if (!on && lane < KB) {
#pragma unroll
      for (int g = 0; g < MG; ++g) buf[g * KB + lane] = __int_as_float(0xff800000);
    }
    for (int t0 = (blockIdx.x * GK_WARPS + team) * MG; t0 < T;
         t0 += total * MG) {
      const int n = min(MG, T - t0);
      const int next = lane < n && t0 + lane + 1 < T
                           ? __ldg(pr.reset + t0 + lane + 1) : 1;
      float x[MG];                    // all in flight
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        x[g] = on && g < n ? __ldcg(pr.rows + (size_t)(t0 + g) * K + lane)
                           : 0.0f;
      }
      const uint32_t ends = __ballot_sync(FULL, lane < n && next != 0);
      __syncwarp();                   // the previous group's reads are done
      if (on) {
#pragma unroll
        for (int g = 0; g < MG; ++g) buf[g * KB + lane] = x[g];
      }
      __syncwarp();
#pragma unroll 4
      for (int g = 0; g < MG; ++g) {
        if (g >= n) break;
        const float4* row = reinterpret_cast<const float4*>(buf + g * KB);
        float c[KB];
        int arg[KB];
        if ((ends >> g) & 1u) {       // a segment's end: argmax of the row
#pragma unroll
          for (int k = 0; k < KB; k += 4) {
            const float4 q = row[k / 4];
            c[k] = q.x;
            c[k + 1] = q.y;
            c[k + 2] = q.z;
            c[k + 3] = q.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < KB; k += 4) {
            const float4 q = row[k / 4];
            c[k] = __fadd_rn(q.x, trc[k]);
            c[k + 1] = __fadd_rn(q.y, trc[k + 1]);
            c[k + 2] = __fadd_rn(q.z, trc[k + 2]);
            c[k + 3] = __fadd_rn(q.w, trc[k + 3]);
          }
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) arg[k] = k;
        tree_argmax<1, KB>(c, arg);
        if (on) maps[(size_t)(t0 + g) * K + lane] = (PtrT)arg[0];
      }
    }
  }
};

// A block team's staging area, 16-byte aligned after its two rows and its
// 64 words of keys and cursor.
__host__ __device__ constexpr size_t block_stage_offset(int K) {
  return ((size_t)2 * K * sizeof(float) + 64 * sizeof(uint32_t) + 15) &
         ~(size_t)15;
}

// One block holds a row (K > 32): thread i keeps states i, i + nt, ...
template <int S_>
struct BlockTeam {
  static constexpr int S = S_;
  static constexpr int PER_BLOCK = 1;
  float ini[S];
  int K, nt, tid, team;
  float* sv;                          // 2 x K floats
  uint32_t* red;                      // 32 keys
  int* s_next;
  const float* tr;                    // shared copy, or device memory
  unsigned char* stage;               // GK_STAGE bytes

  __device__ void setup(const GkProblem& pr, unsigned char* smem) {
    K = pr.K;
    nt = blockDim.x;
    tid = threadIdx.x;
    team = 0;
    sv = reinterpret_cast<float*>(smem);
    red = reinterpret_cast<uint32_t*>(sv + 2 * K);
    s_next = reinterpret_cast<int*>(red + 32);
    stage = smem + block_stage_offset(K);
    float* tr_s = reinterpret_cast<float*>(stage + GK_STAGE);
    if (K <= GK_TR_SMEM_MAX) {
      for (int i = tid; i < K * K; i += nt) tr_s[i] = pr.trans[i];
      tr = tr_s;
    } else {
      tr = pr.trans;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) ini[s] = has(s) ? pr.init[state(s)] : 0.0f;
    __syncthreads();
  }
  __device__ unsigned char* block_stage(unsigned char*) const {
    return stage;
  }
  __device__ int state(int s) const { return tid + s * nt; }
  __device__ bool has(int s) const { return tid + s * nt < K; }
  __device__ bool leader() const { return tid == 0; }
  __device__ void sync() const { __syncthreads(); }
  __device__ void load_row(const float* p, float (&v)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = has(s) ? __ldcg(p + state(s)) : 0.0f;
  }
  __device__ void store_row(float* p, const float (&v)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (has(s)) p[state(s)] = v[s];
    }
  }
  __device__ bool same_row(const float* p, const float (&v)[S]) const {
    bool same = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      same = same && (!has(s) || same_bits(__ldcg(p + state(s)), v[s]));
    }
    return __syncthreads_and(same);
  }
  template <typename PtrT>
  __device__ int stage_rows() const {
    const int n = (GK_STAGE - 16) / (K * (int)sizeof(PtrT));
    return n < 1 ? 1 : n;
  }

  template <bool CHECK>
  __device__ int run(const GkProblem& pr, float (&v)[S], int a, int b,
                     float* exits) {
    const int T = pr.T;
    const int lane = tid & 31, nwarps = (nt + 31) >> 5;
    int cur = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (has(s)) sv[state(s)] = v[s];
    }
    __syncthreads();
    int edge = min((a / pr.L + 1) * pr.L, T);
    for (int t = a; t < b; ++t) {
      const bool rst = t == 0 || __ldg(pr.reset + t) != 0;
      float e[S], o[S], vn[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t i = (size_t)t * K + state(s);
        e[s] = has(s) ? __ldg(pr.em + i) : 0.0f;
        o[s] = CHECK && has(s) ? __ldcg(pr.rows + i) : 0.0f;
      }
      const float* row = sv + cur * K;
      uint32_t key = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!has(s)) continue;
        const int kp = state(s);
        float best = ini[s];
        if (!rst) {
          const float ninf = __int_as_float(0xff800000);
          float m0 = ninf, m1 = ninf, m2 = ninf, m3 = ninf;
          int k = 0;
          for (; k + 4 <= K; k += 4) {
            m0 = max_nan(m0, __fadd_rn(row[k], tr[(size_t)k * K + kp]));
            m1 = max_nan(m1, __fadd_rn(row[k + 1],
                                       tr[(size_t)(k + 1) * K + kp]));
            m2 = max_nan(m2, __fadd_rn(row[k + 2],
                                       tr[(size_t)(k + 2) * K + kp]));
            m3 = max_nan(m3, __fadd_rn(row[k + 3],
                                       tr[(size_t)(k + 3) * K + kp]));
          }
          for (; k < K; ++k) {
            m0 = max_nan(m0, __fadd_rn(row[k], tr[(size_t)k * K + kp]));
          }
          best = max_nan(max_nan(m0, m1), max_nan(m2, m3));
        }
        vn[s] = __fadd_rn(e[s], best);
        key = max(key, fkey(vn[s]));
      }
      key = __reduce_max_sync(FULL, key);
      if (lane == 0) red[tid >> 5] = key;
      __syncthreads();
      uint32_t mk = red[0];
      for (int w = 1; w < nwarps; ++w) mk = max(mk, red[w]);
      const float m = unkey(mk);
      bool same = true;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!has(s)) continue;
        v[s] = __fsub_rn(vn[s], m);
        same = same && same_bits(v[s], o[s]);
      }
      // the barrier orders this frame's reads of red and of the row before
      // the next frame's writes
      if (CHECK) {
        if (__syncthreads_and(same)) return t;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!has(s)) continue;
        const int kp = state(s);
        pr.rows[(size_t)t * K + kp] = v[s];
        if (exits != nullptr && t + 1 == edge) {
          exits[(size_t)(t / pr.L) * K + kp] = v[s];
        }
        sv[(cur ^ 1) * K + kp] = v[s];
      }
      if (t + 1 == edge) edge = min(edge + pr.L, T);
      cur ^= 1;
      __syncthreads();
    }
    return -1;
  }

  // Part 3, grid-strided over (t, k').
  template <typename PtrT>
  __device__ void maps_pass(const GkProblem& pr) {
    PtrT* maps = reinterpret_cast<PtrT*>(pr.maps);
    const size_t n = (size_t)pr.T * K;
    const size_t stride = (size_t)gridDim.x * nt;
    for (size_t i = (size_t)blockIdx.x * nt + tid; i < n; i += stride) {
      const int t = (int)(i / K), j = (int)(i % K);
      const float* row = pr.rows + (size_t)t * K;
      const bool end = t + 1 >= pr.T || __ldg(pr.reset + t + 1) != 0;
      float best = end ? __ldcg(row) : __fadd_rn(__ldcg(row), __ldg(pr.trans + j));
      int arg = 0;
      for (int k = 1; k < K; ++k) {
        const float x = __ldcg(row + k);
        const float cnd =
            end ? x : __fadd_rn(x, __ldg(pr.trans + (size_t)k * K + j));
        if (takes_over(cnd, best)) {
          best = cnd;
          arg = k;
        }
      }
      maps[i] = (PtrT)arg;
    }
  }
};

// Copies the bytes [src, src + nbytes) into dst (16-byte aligned) in
// aligned 16-byte words, 4 loads a thread in flight, by nthr threads;
// returns the offset in dst of src's first byte.  The words past either end
// lie in the same allocation (device allocations are 256-byte aligned).
__device__ __forceinline__ int copy_span(unsigned char* dst,
                                         const void* src, int nbytes,
                                         int nthr, int rank) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const int off = (int)((uintptr_t)src - a);
  const int words = (off + nbytes + 15) / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(a);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int i0 = rank; i0 < words; i0 += 4 * nthr) {
    uint4 x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * nthr;
      if (i < words) x[j] = __ldcg(s4 + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j * nthr < words) d4[i0 + j * nthr] = x[j];
    }
  }
  return off;
}

// Stages the n elements from src into the team's area -> where they are.
template <class Team, typename PtrT>
__device__ __forceinline__ const PtrT* stage_in(const Team& tm,
                                                unsigned char* area,
                                                const PtrT* src, int n,
                                                int nthr, int rank) {
  tm.sync();                          // the previous piece is read
  const int off = copy_span(area, src, n * (int)sizeof(PtrT), nthr, rank);
  tm.sync();
  return reinterpret_cast<const PtrT*>(area + off);
}

// Part 4's chain when every summary fits in block 0's staging area (K <= 32
// on H100: 1,056 chunks): each of the block's warps composes the summaries
// of its range of chunks into one map (a lane a state), one thread chains
// the warps' maps, then each warp chains its own range from its exit: two
// chains of P / 8 shared-memory reads and one of 8, where one thread would
// chain all P.  gw: (warps, 32) ints and (warps,) ints of shared memory.
template <typename PtrT>
__device__ void chain_sums_by_warps(const GkProblem& pr, PtrT* bs, int* gw,
                                    const PtrT* sums) {
  const int P = pr.P, K = pr.K;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int* in = gw + nw * 32;
  copy_span(reinterpret_cast<unsigned char*>(bs), sums,
            P * K * (int)sizeof(PtrT), blockDim.x, threadIdx.x);
  __syncthreads();
  // chunks 1 .. P-1 in nw ranges; range w maps the state after its last
  // chunk to the state before its first
  const int per = (P - 1 + nw - 1) / nw;
  const int lo = 1 + w * per, hi = min(P, lo + per);
  if (lane < K) {
    int g = lane;
    for (int c = hi - 1; c >= lo; --c) g = bs[c * K + g];
    gw[w * 32 + lane] = g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int x = 0;
    for (int r = nw - 1; r >= 0; --r) {
      in[r] = x;
      x = gw[r * 32 + x];
    }
  }
  __syncthreads();
  if (lane == 0) {
    int x = in[w];
    for (int c = hi - 1; c >= lo; --c) {
      x = bs[c * K + x];
      pr.xb[c - 1] = x;
    }
  }
}

// The serial walk (part 2's end), by block 0: from the first chunk whose
// entry differs from its neighbour's exit, one team runs on through the
// following chunks until it stops on a stored row; then the next such
// chunk.  exits: the last pass's exits; entries: each chunk's entry.
template <class Team>
__device__ void gk_walk(const GkProblem& pr, Team& tm, float* exits,
                        const float* entries) {
  constexpr int S = Team::S;
  const int P = pr.P, K = pr.K;
  int* s_next = tm.s_next;
  int from = 1, walked = 0;
  for (;;) {
    if (threadIdx.x == 0) *s_next = P;
    __syncthreads();
    for (int base = from; base < P; base += blockDim.x) {
      const int i = base + threadIdx.x;
      bool hit = false;
      if (i < P) {
        const float* x = exits + (size_t)(i - 1) * K;
        const float* y = entries + (size_t)i * K;
        for (int k = 0; k < K && !hit; ++k) {
          hit = !same_bits(__ldcg(x + k), __ldcg(y + k));
        }
      }
      if (hit) atomicMin(s_next, i);
      if (__syncthreads_or(hit)) break;
    }
    const int first = *s_next;
    __syncthreads();
    if (first >= P) break;
    if (tm.team == 0) {
      float v[S];
      tm.load_row(exits + (size_t)(first - 1) * K, v);
      const int stop = tm.template run<true>(pr, v, first * pr.L, pr.T,
                                             exits);
      const int last = stop < 0 ? P - 1 : stop / pr.L;
      walked += last - first + 1;
      if (threadIdx.x == 0) *s_next = last + 1;
    }
    __syncthreads();
    from = *s_next;
    __syncthreads();
  }
  if (threadIdx.x == 0) pr.ctl[4] = walked;
}

template <class Team, typename PtrT, int THREADS_MAX>
__global__ void __launch_bounds__(THREADS_MAX, 1)
    gk_kernel(const GkProblem pr) {
  extern __shared__ __align__(16) unsigned char gk_smem[];
  constexpr int S = Team::S;
  cg::grid_group grid = cg::this_grid();
  Team tm;
  tm.setup(pr, gk_smem);
  const int T = pr.T, K = pr.K, L = pr.L, P = pr.P;
  int32_t* ctl = pr.ctl;
  const int c = blockIdx.x * Team::PER_BLOCK + tm.team;
  const bool live = c < P;
  const int a = live ? c * L : T;
  const int b = live ? min(a + L, T) : T;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  float v[S], ent[S], ex[S];
#pragma unroll
  for (int s = 0; s < S; ++s) v[s] = ent[s] = 0.0f;
  const unsigned long long t_start = gk_clock();
  auto mark = [&](int i) {
    if (lead) ctl[8 + i] = (int32_t)(gk_clock() - t_start);
  };

  // ---- part 2, pass 0: speculative forward from zero rows ----------------
  if (lead) {
    ctl[1] = 0;
    ctl[4] = 0;
    ctl[5] = P;
    ctl[6] = L;
  }
  if (live) {
    tm.template run<false>(pr, v, a, b, nullptr);
    tm.store_row(pr.exits + (size_t)c * K, v);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) ex[s] = v[s];
  grid.sync();

  // ---- fix-up passes -----------------------------------------------------
  int pass = 0;
  bool more = P > 1;
  while (more && pass < PASS_CAP) {
    ++pass;
    if (lead) ctl[(pass + 1) % 3] = 0;
    bool go_on = false;
    if (live && c > 0) {
      const float* n =
          pr.exits + ((size_t)((pass - 1) & 1) * P + c - 1) * K;
      if (!tm.same_row(n, ent)) {
        tm.load_row(n, ent);
#pragma unroll
        for (int s = 0; s < S; ++s) v[s] = ent[s];
        if (tm.template run<true>(pr, v, a, b, nullptr) < 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) ex[s] = v[s];
          go_on = c < P - 1;
        }
      }
    }
    if (live) tm.store_row(pr.exits + ((size_t)(pass & 1) * P + c) * K, ex);
    if (__syncthreads_or(go_on) && threadIdx.x == 0) {
      atomicOr(ctl + pass % 3, 1);
    }
    grid.sync();
    more = __ldcg(ctl + pass % 3) != 0;
  }
  if (lead) ctl[3] = pass + 1;
  mark(0);

  // ---- the serial walk, when the passes did not converge ----------------
  if (more) {                          // the same on every thread
    if (live) tm.store_row(pr.exits + ((size_t)2 * P + c) * K, ent);
    grid.sync();
    if (blockIdx.x == 0) {
      gk_walk<Team>(pr, tm, pr.exits + (size_t)(pass & 1) * P * K,
                    pr.exits + (size_t)2 * P * K);
    }
  }
  grid.sync();
  mark(1);

  // ---- part 3: the maps, off the chain -----------------------------------
  tm.template maps_pass<PtrT>(pr);
  grid.sync();
  mark(2);

  // ---- part 4: chunk summaries, then the chain of summaries --------------
  const PtrT* maps = reinterpret_cast<const PtrT*>(pr.maps);
  PtrT* sums = reinterpret_cast<PtrT*>(pr.sums);
  const int rows = tm.template stage_rows<PtrT>();
  const int nthr = Team::PER_BLOCK == 1 ? (int)blockDim.x : 32;
  const int rank = Team::PER_BLOCK == 1 ? (int)threadIdx.x
                                        : (int)(threadIdx.x & 31);
  if (live) {
    int f[S];
#pragma unroll
    for (int s = 0; s < S; ++s) f[s] = tm.state(s);
    for (int hi = b; hi > a; hi -= rows) {
      const int lo = max(a, hi - rows);
      const PtrT* st = stage_in(tm, tm.stage, maps + (size_t)lo * K,
                                (hi - lo) * K, nthr, rank);
      for (int t = hi - 1; t >= lo; --t) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (tm.has(s)) f[s] = st[(size_t)(t - lo) * K + f[s]];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (tm.has(s)) sums[(size_t)c * K + tm.state(s)] = (PtrT)f[s];
    }
  }
  grid.sync();
  mark(3);
  if (blockIdx.x == 0) {
    unsigned char* stage = tm.block_stage(gk_smem);
    int n = (GK_STAGE - 16) / (K * (int)sizeof(PtrT));   // chunks a tile
    if (n < 1) n = 1;
    int x = 0;                         // after the last frame: any state
    if (threadIdx.x == 0) pr.xb[P - 1] = 0;
    const bool by_warps = Team::PER_BLOCK > 1 &&
                          P * K * (int)sizeof(PtrT) <= GK_STAGE;
    if (by_warps) {
      chain_sums_by_warps(pr, reinterpret_cast<PtrT*>(stage), tm.s_next + 4,
                          sums);
    }
    for (int hi = by_warps ? 1 : P; hi > 1; hi -= n) {
      const int lo = max(1, hi - n);
      __syncthreads();
      const PtrT* st = reinterpret_cast<const PtrT*>(
          stage + copy_span(stage, sums + (size_t)lo * K,
                            (hi - lo) * K * (int)sizeof(PtrT), blockDim.x,
                            threadIdx.x));
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int cc = hi - 1; cc >= lo; --cc) {
          x = st[(size_t)(cc - lo) * K + x];
          pr.xb[cc - 1] = x;
        }
      }
    }
  }
  grid.sync();
  mark(4);

  // ---- part 5: each chunk walks backward ----------------------------------
  if (live) {
    int x = __ldcg(pr.xb + c);
    for (int hi = b; hi > a; hi -= rows) {
      const int lo = max(a, hi - rows);
      const PtrT* st = stage_in(tm, tm.stage, maps + (size_t)lo * K,
                                (hi - lo) * K, nthr, rank);
      if (tm.leader()) {
        for (int t = hi - 1; t >= lo; --t) {
          x = st[(size_t)(t - lo) * K + x];
          pr.states[t] = x;
        }
      }
    }
  }
}

template <class Team, typename PtrT, int THREADS_MAX>
cudaError_t gk_launch(int blocks, int threads, size_t smem, cudaStream_t s,
                      GkProblem pr) {
  const void* fn = (const void*)gk_kernel<Team, PtrT, THREADS_MAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&pr};
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), args,
                                     smem, s);
}

}  // namespace

// emission (T,K) f32, reset (T,) bool bytes, trans (K,K) f32, init (K,)
// f32, 1 <= K <= 8192; L frames a chunk (the wrapper's plan: P = ceil(T /
// L) chunks, at most 8 a block for K <= 32, else one, and at most
// max_blocks blocks, one per SM).  Scratch: rows (T,K) f32, exits (3,P,K)
// f32, maps (T,K) and sums (P,K) uint8 when K <= 256, else uint16, xb (P,)
// int32, ctl (16,) int32; after the run ctl[3] is the pass count, ctl[4]
// the chunks walked, ctl[5] P, ctl[6] L, ctl[8..12] the part times (ns).  states (T,) int32 out.  Returns the
// launch's cudaError_t.
extern "C" int iss_viterbi_general(const float* em, const uint8_t* reset,
                                   const float* trans, const float* init,
                                   long long T, int K, int L, int max_blocks,
                                   float* rows, float* exits, void* maps,
                                   void* sums, int32_t* xb, int32_t* ctl,
                                   int32_t* states, void* stream) {
  if (T <= 0 || T > INT_MAX / 2 || K < 1 || K > GK_MAX || L < 1 ||
      max_blocks < 1 || max_blocks > 1024 ||
      (K + 1023) / 1024 > GK_PER_THREAD) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = (int)((T + L - 1) / L);
  const int per_block = K <= 32 ? GK_WARPS : 1;
  const int blocks = (P + per_block - 1) / per_block;
  if (blocks > max_blocks || (long long)(P - 1) * L >= T) {
    return (int)cudaErrorInvalidValue;
  }
  GkProblem pr{em, reset, trans, init, (int)T, K, L, P, rows, exits, maps,
               sums, xb, ctl, states};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (K <= 32) {
    const size_t smem = GK_WARPS * 64 * sizeof(float) + GK_STAGE + 16 +
                        GK_WARPS * 33 * sizeof(int);
    const int nt = 32 * GK_WARPS;
    if (K <= 8) {
      err = gk_launch<WarpTeam<8>, uint8_t, 256>(blocks, nt, smem, s, pr);
    } else if (K <= 16) {
      err = gk_launch<WarpTeam<16>, uint8_t, 256>(blocks, nt, smem, s, pr);
    } else {
      err = gk_launch<WarpTeam<32>, uint8_t, 256>(blocks, nt, smem, s, pr);
    }
  } else {
    int nt = (K + 31) / 32 * 32;
    if (nt > 1024) nt = 1024;
    const size_t smem = block_stage_offset(K) + GK_STAGE +
                        (K <= GK_TR_SMEM_MAX ? (size_t)K * K * sizeof(float)
                                             : 0);
    if (K <= 256) {
      err = gk_launch<BlockTeam<1>, uint8_t, 1024>(blocks, nt, smem, s, pr);
    } else if (K <= 1024) {
      err = gk_launch<BlockTeam<1>, uint16_t, 1024>(blocks, nt, smem, s, pr);
    } else {
      err = gk_launch<BlockTeam<GK_PER_THREAD>, uint16_t, 1024>(
          blocks, nt, smem, s, pr);
    }
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
