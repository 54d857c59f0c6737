// Viterbi decode with segment resets for Hopper (sm_90a).
//
// Replaces the lax.scan decode inaspeechsegmenter_tpu/decode/viterbi.py::
// _viterbi_scan (no Pallas kernel there: XLA compiled the scan).  Eager
// PyTorch has no scan, and a Python loop over frames issues several launches
// per 10 ms frame, three decodes per file.
//
// What bounds it on the H100: the serial dependence from frame to frame.
// Work is K*K adds and compares per frame (K <= 3) and 4*K + 1 bytes of
// input, so neither bandwidth nor arithmetic rate matters; latency does.
//
// Design: one block per sequence.  The frames go through shared memory in
// tiles of 2048: all 256 threads load a tile's emissions and reset flags
// with coalesced reads, thread 0 runs the recursion over the tile with the
// K scores in registers, writing int8 back-pointers and per-frame argmaxes
// to shared memory, and all threads store them.  So the serial thread only
// ever waits on shared-memory latency.  The backtrack walks the tiles in
// reverse the same way.
//
// Exactness: the float ops are those of _viterbi_scan, in the same order:
// v[k] + trans[k][k'], column max with the first maximum winning (strict >),
// em + max, em + init at a reset, then subtract the row max every frame.  A
// NaN wins an argmax and propagates through a max, as in jnp.argmax and
// jnp.max.  There is no multiply, so no FMA contraction can change a sum:
// the states are bit-equal to the scan's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 2048;
constexpr int THREADS = 256;

// jnp.argmax / jnp.max semantics over a running (best, arg) pair: a NaN
// candidate wins unless a NaN already won; otherwise strictly greater wins.
__device__ __forceinline__ bool takes_over(float cand, float best) {
  return best == best && (cand != cand || cand > best);   // x != x: NaN
}

template <int K>
__global__ void __launch_bounds__(THREADS)
viterbi_kernel(const float* __restrict__ em, const uint8_t* __restrict__ reset,
               const float* __restrict__ trans, const float* __restrict__ init,
               long long T, int8_t* __restrict__ ptrs,
               int8_t* __restrict__ amax, int32_t* __restrict__ states) {
  __shared__ float s_em[TILE * K];
  __shared__ uint8_t s_rs[TILE];
  __shared__ int8_t s_ptr[TILE * K];
  __shared__ int8_t s_am[TILE];
  __shared__ int32_t s_st[TILE];
  const int tid = threadIdx.x;

  float tr[K][K], ini[K], v[K];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    ini[a] = init[a];
    v[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < K; ++b) tr[a][b] = trans[a * K + b];
  }

  // ---- forward ----------------------------------------------------------
  for (long long t0 = 0; t0 < T; t0 += TILE) {
    const int n = (int)min((long long)TILE, T - t0);
    for (int i = tid; i < n * K; i += THREADS) s_em[i] = em[t0 * K + i];
    for (int i = tid; i < n; i += THREADS) s_rs[i] = reset[t0 + i];
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < n; ++i) {
        const bool rst = s_rs[i] || (t0 + i == 0);
        float vn[K];
#pragma unroll
        for (int kp = 0; kp < K; ++kp) {
          float best = v[0] + tr[0][kp];
          int arg = 0;
#pragma unroll
          for (int k = 1; k < K; ++k) {
            const float c = v[k] + tr[k][kp];
            if (takes_over(c, best)) { best = c; arg = k; }
          }
          const float e = s_em[i * K + kp];
          vn[kp] = rst ? e + ini[kp] : e + best;
          s_ptr[i * K + kp] = (int8_t)(rst ? kp : arg);
        }
        float m = vn[0];
#pragma unroll
        for (int k = 1; k < K; ++k) if (takes_over(vn[k], m)) m = vn[k];
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = vn[k] - m;
        float bv = v[0];
        int ba = 0;
#pragma unroll
        for (int k = 1; k < K; ++k) if (takes_over(v[k], bv)) { bv = v[k]; ba = k; }
        s_am[i] = (int8_t)ba;
      }
    }
    __syncthreads();
    for (int i = tid; i < n * K; i += THREADS) ptrs[t0 * K + i] = s_ptr[i];
    for (int i = tid; i < n; i += THREADS) amax[t0 + i] = s_am[i];
    __syncthreads();
  }

  // ---- backtrack ----------------------------------------------------------
  // x[t] = amax[t] where frame t ends a segment (t == T-1 or reset[t+1]),
  // else ptrs[t+1][x[t+1]].
  bool next_reset = true;
  int next_val = 0;
  const long long last0 = ((T - 1) / TILE) * TILE;
  for (long long t0 = last0; t0 >= 0; t0 -= TILE) {
    const int n = (int)min((long long)TILE, T - t0);
    for (int i = tid; i < n * K; i += THREADS) s_ptr[i] = ptrs[t0 * K + i];
    for (int i = tid; i < n; i += THREADS) {
      s_am[i] = amax[t0 + i];
      s_rs[i] = reset[t0 + i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = n - 1; i >= 0; --i) {
        const int x = next_reset ? s_am[i] : next_val;
        s_st[i] = x;
        next_reset = s_rs[i] != 0;
        next_val = s_ptr[i * K + x];
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) states[t0 + i] = s_st[i];
    __syncthreads();
  }
}

}  // namespace

// emission (T,K) f32, reset (T,) bool bytes, trans (K,K) f32, init (K,) f32;
// scratch ptrs (T,K) and amax (T,) int8; states (T,) int32 out.
// Returns cudaGetLastError().
extern "C" int iss_viterbi(const float* em, const uint8_t* reset,
                           const float* trans, const float* init, long long T,
                           int K, int8_t* ptrs, int8_t* amax, int32_t* states,
                           void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: viterbi_kernel<1><<<1, THREADS, 0, s>>>(em, reset, trans, init, T, ptrs, amax, states); break;
    case 2: viterbi_kernel<2><<<1, THREADS, 0, s>>>(em, reset, trans, init, T, ptrs, amax, states); break;
    case 3: viterbi_kernel<3><<<1, THREADS, 0, s>>>(em, reset, trans, init, T, ptrs, amax, states); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
