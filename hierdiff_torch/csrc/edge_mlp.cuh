// Shared pieces of the fused EGNN edge kernels: the elementwise numerics
// (act, silu, sigmoid, pre_act, round_bf16), the limits of all of them and
// their phase clocks (their Hopper pieces are in sm90.cuh).
//
// The kernels run the same edge pipeline as hierdiff_tpu/ops/egnn_pallas.py
// `_edge_mlp` (:95): pre_ij = h_i W_src + h_j W_dst + e_ij W_e + b1 -> silu
// -> (.) W2 + b2 -> silu, with bf16 matmul operands and f32 accumulation. The
// elementwise type is a template flag: f32, or bf16 with every elementwise
// result rounded to bf16 at the points where the Pallas kernel's bf16 arrays
// round (its compute_dtype='bfloat16' mode); arithmetic itself is done in
// f32 registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace hd {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTileM = 64;                          // edges per tensor-core tile
constexpr int kMaxH = 256;                          // hidden width limit
constexpr int kMaxE = 32;                           // edge feature limit

// Phase clocks, compiled in only with -DHD_PHASE_CLOCKS (tools/kernel_phases.py):
// placed right after a barrier, HD_PHASE(k, t) has thread 0 of the block add
// the SM cycles since the previous mark to hd_phase_cycles[k].
constexpr int kPhases = 8;
#ifdef HD_PHASE_CLOCKS
__device__ unsigned long long hd_phase_cycles[kPhases];
#define HD_PHASE_START(t) long long t = clock64()
#define HD_PHASE(k, t)                                                              \
  do {                                                                              \
    if (threadIdx.x == 0) {                                                         \
      const long long now_ = clock64();                                             \
      atomicAdd(&hd_phase_cycles[k], static_cast<unsigned long long>(now_ - (t)));  \
      (t) = now_;                                                                   \
    }                                                                               \
  } while (0)
// Copy the counters to out[kPhases] and zero them.
extern "C" int hd_read_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, hd_phase_cycles, sizeof(hd_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[kPhases] = {};
  return (int)cudaMemcpyToSymbol(hd_phase_cycles, zeros, sizeof(zeros));
}
#else
#define HD_PHASE_START(t) do { } while (0)
#define HD_PHASE(k, t) do { } while (0)
#endif

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool BF16>
__device__ __forceinline__ float act(float x) {
  if constexpr (BF16) return round_bf16(x);
  else return x;
}

// sigmoid as 1 / (1 + exp(-x)) with the SFU's exp and reciprocal; in bf16
// mode each step rounds, like the Pallas kernel's manual bf16 sigmoid
// (egnn_pallas.py:45).
template <bool BF16>
__device__ __forceinline__ float sigmoid_act(float x) {
  if constexpr (BF16) {
    const float e = act<true>(__expf(-x));
    const float d = act<true>(1.0f + e);
    return act<true>(__fdividef(1.0f, d));
  } else {
    return __fdividef(1.0f, 1.0f + __expf(-x));   // 1 / inf = 0: silu(-inf side) -> -0
  }
}

template <bool BF16>
__device__ __forceinline__ float silu_act(float x) {
  return act<BF16>(x * sigmoid_act<BF16>(x));
}

// silu'(x) = s * (1 + x * (1 - s)), s = sigmoid(x), each step rounded to the
// act dtype like the Pallas backward's `_dsilu` (egnn_pallas.py:227).
template <bool BF16>
__device__ __forceinline__ float dsilu_act(float x) {
  const float s = sigmoid_act<BF16>(x);
  return act<BF16>(s * act<BF16>(1.0f + act<BF16>(x * act<BF16>(1.0f - s))));
}

// pre = ((hs_i + hd_j) + e_ij W_e) + b1, each step rounded to the act dtype
// (bias already rounded).
template <bool BF16>
__device__ __forceinline__ float pre_act(float hs, float hdst, float ep, float bias) {
  return act<BF16>(act<BF16>(act<BF16>(act<BF16>(hs) + act<BF16>(hdst)) + act<BF16>(ep)) + bias);
}

// The pre-activation builds keep the first kRegE rows of W_e in registers.
constexpr int kRegE = 4;

}  // namespace hd
