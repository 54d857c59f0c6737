// The general-K Viterbi kernel's warp chain (csrc/viterbi.cu, part 1) at K =
// 30, T = 180,000, timed in variants on one warp: the cycles a frame
// (clock64) that each piece of the chain costs.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o build/viterbi_chain_bench tools/viterbi_chain_bench.cu
//   build/viterbi_chain_bench
//
// Prints one line a variant: "MB <variant> ms=... cycles/frame=...".  The
// inputs are random (a fixed seed); nothing is checked but the launch.
#include <cstdio>
#include <cstdint>
#include <vector>
#include <random>
#include <cuda_runtime.h>

constexpr unsigned FULL = 0xffffffffu;
__device__ __forceinline__ float max_nan(float a, float b) {
  float d; asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b)); return d;
}
__device__ __forceinline__ uint32_t fkey(float x) {
  const uint32_t u = __float_as_uint(x);
  if (x != x) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
template <int W> __device__ __forceinline__ void tree_max(float* c) {
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = max_nan(c[k], c[k + W]);
  if constexpr (W > 1) tree_max<W / 2>(c);
}

// V bits: 1 the bit compare and vote (every frame, or once a group with
// 32), 2 the row max by redux.sync (else a shuffle tree), 4 the row stores
// (every frame, or once a group with 32), 8 the row through shared memory
// (else shuffle broadcasts), 16 the row max at all.
template <int V>
__global__ void chain(const float* em, const float* tr, const uint8_t* reset,
                      float* rows, int T, int K, long long* cyc) {
  constexpr int KB = 32, G = 8;
  __shared__ __align__(16) float sv[64];
  const int lane = threadIdx.x; const bool on = lane < K;
  float trc[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) trc[k] = k < K && on ? tr[k * K + lane] : __int_as_float(0xff800000);
  const float ini = -1.0f;
  float ce[G], co[G], ne[G], no[G]; int cr[G], nr[G];
  auto load = [&](int t0, float (&e)[G], float (&o)[G], int (&r)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = min(t0 + g, T - 1);
      e[g] = on ? __ldg(em + (size_t)t * K + lane) : 0.0f;
      o[g] = (V & 1) && on ? __ldcg(rows + (size_t)t * K + lane) : 0.0f;
      r[g] = __ldg(reset + t);
    }
  };
  int cur = 0; float x = 0.f; float xs[G];
  sv[lane] = 0.f; __syncwarp();
  load(0, ce, co, cr);
  long long c0 = clock64();
  for (int t0 = 0; t0 < T; t0 += G) {
    load(t0 + G, ne, no, nr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = t0 + g;
      if (t >= T) break;
      float c[KB];
      if (V & 8) {
        const float* row = sv + cur * 32;
#pragma unroll
        for (int k = 0; k < KB; k += 4) {
          const float4 q = *reinterpret_cast<const float4*>(row + k);
          c[k] = __fadd_rn(q.x, trc[k]); c[k+1] = __fadd_rn(q.y, trc[k+1]);
          c[k+2] = __fadd_rn(q.z, trc[k+2]); c[k+3] = __fadd_rn(q.w, trc[k+3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KB; ++k) c[k] = __fadd_rn(__shfl_sync(FULL, on ? x : 0.f, k), trc[k]);
      }
      tree_max<KB / 2>(c);
      const bool rst = cr[g] != 0 || t == 0;
      const float vn = __fadd_rn(ce[g], rst ? ini : c[0]);
      float m = 0.f;
      if (V & 16) {
        if (V & 2) {
          m = unkey(__reduce_max_sync(FULL, on ? fkey(vn) : 0u));
        } else {
          m = on ? vn : __int_as_float(0xff800000);
#pragma unroll
          for (int d = 16; d >= 1; d >>= 1) m = max_nan(m, __shfl_xor_sync(FULL, m, d));
        }
      }
      x = __fsub_rn(vn, m);
      if (V & 8) { cur ^= 1; sv[cur * 32 + lane] = on ? x : 0.0f; }
      xs[g] = x;
      if (!(V & 32) || g == G - 1) {
        if (V & 4) {
#pragma unroll
          for (int h = 0; h < G; ++h) {
            if (on && ((V & 32) || h == g)) rows[(size_t)(t0 + h) * K + lane] = xs[h];
          }
        }
        if ((V & 1) && __all_sync(FULL, !on || __float_as_uint(x) == __float_as_uint(co[g]))) { cyc[1] = t; }
      }
      if (V & 8) __syncwarp();
    }
#pragma unroll
    for (int g = 0; g < G; ++g) { ce[g] = ne[g]; co[g] = no[g]; cr[g] = nr[g]; }
  }
  long long c1 = clock64();
  if (lane == 0) cyc[0] = c1 - c0;
  if (lane == 0) cyc[2] = __float_as_int(x);
}

template <int V>
void run(const char* name, const float* em, const float* tr, const uint8_t* rs, float* rows, int T, int K, long long* cyc) {
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  chain<V><<<1, 32>>>(em, tr, rs, rows, T, K, cyc);
  cudaEventRecord(a);
  chain<V><<<1, 32>>>(em, tr, rs, rows, T, K, cyc);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  long long h[3]; cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  printf("MB %-34s ms=%.3f cycles/frame=%.1f err=%s\n", name, ms, (double)h[0] / T, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  const int T = 180000, K = 30;
  std::mt19937 g(1); std::normal_distribution<float> n(0.f, 1.f);
  std::vector<float> em((size_t)T * K), tr(K * K);
  for (auto& x : em) x = -std::abs(n(g));
  for (auto& x : tr) x = -std::abs(n(g)) * 3;
  std::vector<uint8_t> rs(T, 0);
  float *dem, *dtr, *drows; uint8_t* drs; long long* dcyc;
  cudaMalloc(&dem, em.size() * 4); cudaMalloc(&dtr, tr.size() * 4);
  cudaMalloc(&drows, em.size() * 4); cudaMalloc(&drs, T); cudaMalloc(&dcyc, 64);
  cudaMemcpy(dem, em.data(), em.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dtr, tr.data(), tr.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(drs, rs.data(), T, cudaMemcpyHostToDevice);
  cudaMemset(drows, 0, em.size() * 4);
  run<1 | 2 | 4 | 8 | 16 | 32>("kernel: stores+check once a group", dem, dtr, drs, drows, T, K, dcyc);
  run<1 | 2 | 4 | 8 | 16>("stores+check every frame", dem, dtr, drs, drows, T, K, dcyc);
  run<2 | 4 | 8 | 16>("stores every frame, no check", dem, dtr, drs, drows, T, K, dcyc);
  run<1 | 2 | 8 | 16>("check every frame, no stores", dem, dtr, drs, drows, T, K, dcyc);
  run<1 | 4 | 8 | 16>("every frame, shuffle-tree row max", dem, dtr, drs, drows, T, K, dcyc);
  run<1 | 2 | 4 | 16>("every frame, shuffle broadcast row", dem, dtr, drs, drows, T, K, dcyc);
  run<1 | 4 | 8>("every frame, no row max", dem, dtr, drs, drows, T, K, dcyc);
  run<2 | 8 | 16>("row max, no stores, no check", dem, dtr, drs, drows, T, K, dcyc);
  run<8>("adds, max tree and shared row only", dem, dtr, drs, drows, T, K, dcyc);
  return 0;
}
