// Shared pieces of the fused EGNN edge kernels: the elementwise numerics
// (act, silu, sigmoid, pre_act, round_bf16) and limits of all of them, and
// the WMMA work decomposition of fused_gcl_bwd.cu (the forward kernels'
// Hopper pieces are in sm90.cuh).
//
// The kernels run the same edge pipeline as hierdiff_tpu/ops/egnn_pallas.py
// `_edge_mlp` (:95): pre_ij = h_i W_src + h_j W_dst + e_ij W_e + b1 -> silu
// -> (.) W2 + b2 -> silu, with bf16 matmul operands and f32 accumulation. The
// elementwise type is a template flag: f32, or bf16 with every elementwise
// result rounded to bf16 at the points where the Pallas kernel's bf16 arrays
// round (its compute_dtype='bfloat16' mode); arithmetic itself is done in
// f32 registers.
//
// Work decomposition: a work item is (batch b, up to kRows source rows; a
// molecule's N rows are split into ceil(N / kRows) equal row blocks, so that
// N = 33 gives 11 + 11 + 11 rows, not 16 + 16 + 1). Its
// rows x N edges are walked in tiles of kTileM edges. For each tile the
// pre-activation is built in shared memory as bf16, multiplied by W2 (kept
// resident in shared memory for the whole kernel) on the tensor cores with
// WMMA bf16 -> f32, and the f32 result is staged in shared memory for the
// kernel-specific epilogue. Blocks are persistent: at most one per SM, each
// walking items blockIdx.x, blockIdx.x + gridDim.x, ...
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace hd {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 64;                          // edges per tensor-core tile
constexpr int kRows = 16;                           // source rows per work item
constexpr int kMaxH = 256;                          // hidden width limit
constexpr int kMaxE = 32;                           // edge feature limit
constexpr int kColsPerLane = kMaxH / 32;            // epilogue columns per lane
constexpr int kMaxColFrags = kMaxH / 16 / kWarps;   // W2 column fragments per warp

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

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

// Shared-memory row strides and the W2 region, in elements and bytes: W2
// with a padded row stride, and the f32 tile stage (the W2 product).
__host__ __device__ inline int ldw(int H) { return H + 8; }
__host__ __device__ inline int lds(int H) { return H + 4; }
__host__ __device__ inline int w2_bytes(int H) { return align128(H * ldw(H) * 2); }

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

// P[M, NC] = bf16(A[M, K]) @ W[K, NC] (bf16, row-major), f32 out: the node
// halves of the pair linear, [h W_src | h W_dst], for every node at once.
constexpr int kProjTile = 64;
constexpr int kProjK = 32;
constexpr int kProjThreads = 128;

__global__ void __launch_bounds__(kProjThreads)
proj_kernel(const float* __restrict__ a, const bf16* __restrict__ w,
            float* __restrict__ p, int M, int K, int NC) {
  __shared__ __align__(128) bf16 as[kProjTile][kProjK + 8];
  __shared__ __align__(128) bf16 bs[kProjK][kProjTile + 8];
  __shared__ __align__(128) float cs[kProjTile][kProjTile + 4];
  const int row0 = blockIdx.x * kProjTile, col0 = blockIdx.y * kProjTile;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;   // each warp owns a 32 x 32 quadrant
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kProjK) {
    for (int idx = threadIdx.x; idx < kProjTile * kProjK; idx += kProjThreads) {
      const int r = idx / kProjK, k = idx % kProjK;
      const int gr = row0 + r, gk = k0 + k;
      as[r][k] = __float2bfloat16(gr < M && gk < K ? a[(size_t)gr * K + gk] : 0.0f);
    }
    for (int idx = threadIdx.x; idx < kProjK * kProjTile; idx += kProjThreads) {
      const int k = idx / kProjTile, c = idx % kProjTile;
      const int gk = k0 + k, gc = col0 + c;
      bs[k][c] = gk < K && gc < NC ? w[(size_t)gk * NC + gc] : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kProjK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &as[wr * 32 + i * 16][kk], kProjK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &bs[kk][wc * 32 + j * 16], kProjTile + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j],
                              kProjTile + 4, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kProjTile * kProjTile; idx += kProjThreads) {
    const int r = idx / kProjTile, c = idx % kProjTile;
    if (row0 + r < M && col0 + c < NC) p[(size_t)(row0 + r) * NC + col0 + c] = cs[r][c];
  }
}

inline cudaError_t launch_proj(const float* h, const bf16* wsd, float* proj, int M, int H,
                               cudaStream_t stream) {
  const dim3 grid((M + kProjTile - 1) / kProjTile, (2 * H + kProjTile - 1) / kProjTile);
  proj_kernel<<<grid, kProjThreads, 0, stream>>>(h, wsd, proj, M, H, 2 * H);
  return cudaGetLastError();
}

// Copy W2 (H x H bf16, row-major) into shared memory, row stride ldw(H).
__device__ __forceinline__ void load_w2(const bf16* __restrict__ w2, bf16* w2s, int H) {
  const int vecs = H / 8;   // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < H * vecs; idx += blockDim.x) {
    const int r = idx / vecs, v = idx % vecs;
    *reinterpret_cast<uint4*>(w2s + r * ldw(H) + v * 8) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)r * H + v * 8);
  }
}

// Per-tile edge metadata in shared memory: tile edge t is flat edge q0 + t of
// the work item, i.e. source row i0 + row[t] and neighbour col[t]; row[t] is
// -1 past the item's last edge. emask holds the bf16-rounded edge mask.
struct Tile {
  int b, i0, N, n_valid;   // edges t < n_valid are real
  float* emask;
  int* row;
  int* col;
  __device__ size_t edge(int t) const {   // flat (b, i, j) index
    return ((size_t)b * N + i0 + row[t]) * N + col[t];
  }
};

// Fill the tile's metadata for flat edges q0 .. q0 + TM - 1 of an item
// with n_edges edges. The caller synchronises before reading it.
template <int TM = kTileM>
__device__ __forceinline__ void load_tile(Tile& tl, int q0, int n_edges,
                                          const float* __restrict__ emask) {
  tl.n_valid = min(TM, n_edges - q0);
  for (int t = threadIdx.x; t < TM; t += blockDim.x) {
    const int q = q0 + t;
    const bool real = q < n_edges;
    tl.row[t] = real ? q / tl.N : -1;
    tl.col[t] = real ? q % tl.N : 0;
    tl.emask[t] = real ? round_bf16(emask[((size_t)tl.b * tl.N + tl.i0 + q / tl.N) * tl.N + q % tl.N])
                       : 0.0f;
  }
}

// pre = ((hs_i + hd_j) + e_ij W_e) + b1, each step rounded to the act dtype
// (bias already rounded).
template <bool BF16>
__device__ __forceinline__ float pre_act(float hs, float hdst, float ep, float bias) {
  return act<BF16>(act<BF16>(act<BF16>(act<BF16>(hs) + act<BF16>(hdst)) + act<BF16>(ep)) + bias);
}

// u[t][c] = bf16(silu(pre)) for the TM edges of a tile; proj holds
// [h W_src | h W_dst] per node. Padding edges get 0.
// Thread c keeps its column of b1 and the first kRegE rows of W_e in
// registers. Edges go in batches of kBatch: all of a batch's loads are
// issued before any of its arithmetic, so the batch waits for one memory
// round trip instead of one per edge.
constexpr int kRegE = 4;
constexpr int kBatch = 8;

template <bool BF16, int TM = kTileM>
__device__ __forceinline__ void build_pre_tile(const Tile& tl, const float* __restrict__ proj,
                               const float* __restrict__ e, const bf16* __restrict__ we,
                               const float* __restrict__ b1, bf16* u, int H, int E) {
  const int ldu = ldw(H);
  const float* node = proj + (size_t)tl.b * tl.N * 2 * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float wreg[kRegE];
#pragma unroll
    for (int k = 0; k < kRegE; ++k) wreg[k] = k < E ? __bfloat162float(we[k * H + c]) : 0.0f;
    const float bias = act<BF16>(b1[c]);
    for (int t0 = 0; t0 < TM; t0 += kBatch) {
      float hs[kBatch], hdst[kBatch], ev[kBatch][kRegE];
      const float* eij[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int t = t0 + k;
        const bool real = t < tl.n_valid;
        const int i = tl.i0 + (real ? tl.row[t] : 0), j = real ? tl.col[t] : 0;
        hs[k] = real ? node[(size_t)i * 2 * H + c] : 0.0f;
        hdst[k] = real ? node[(size_t)j * 2 * H + H + c] : 0.0f;
        eij[k] = e + (((size_t)tl.b * tl.N + i) * tl.N + j) * E;
#pragma unroll
        for (int r = 0; r < kRegE; ++r) ev[k][r] = real && r < E ? eij[k][r] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int t = t0 + k;
        float val = 0.0f;
        if (t < tl.n_valid) {
          float ep = 0.0f;
#pragma unroll
          for (int r = 0; r < kRegE; ++r)
            if (r < E) ep += round_bf16(ev[k][r]) * wreg[r];
#pragma unroll 1   // wide E (sinusoid embedding) only: keep the code small
          for (int r = kRegE; r < E; ++r)
            ep += round_bf16(eij[k][r]) * __bfloat162float(we[r * H + c]);
          val = silu_act<BF16>(pre_act<BF16>(hs[k], hdst[k], ep, bias));
        }
        u[t * ldu + c] = __float2bfloat16(val);
      }
    }
  }
}

// stage (TM x H, f32) = a (TM x H, bf16, row stride ldw) @ W, where W is
// w2s (H x H, bf16, row stride ldw) or, with TRANS_B, its transpose (w2s
// read as a column-major operand, so one resident copy serves both). Warp w
// owns column fragments w, w + kWarps; all accumulators stay in registers
// until every warp has finished reading a, because stage may alias a.
template <int TM, bool TRANS_B>
__device__ __forceinline__ void tile_mma_t(const bf16* a, const bf16* w2s, float* stage, int H) {
  const int warp = threadIdx.x / 32;
  const int n_col_frags = H / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxColFrags][TM / 16];
#pragma unroll
  for (int ci = 0; ci < kMaxColFrags; ++ci)
#pragma unroll
    for (int m = 0; m < TM / 16; ++m) wmma::fill_fragment(acc[ci][m], 0.0f);
  for (int k = 0; k < H; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[TM / 16];
#pragma unroll
    for (int m = 0; m < TM / 16; ++m)
      wmma::load_matrix_sync(fa[m], a + m * 16 * ldw(H) + k, ldw(H));
#pragma unroll
    for (int ci = 0; ci < kMaxColFrags; ++ci) {
      const int cf = warp + ci * kWarps;
      if (cf < n_col_frags) {
        if constexpr (TRANS_B) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, w2s + cf * 16 * ldw(H) + k, ldw(H));
#pragma unroll
          for (int m = 0; m < TM / 16; ++m) wmma::mma_sync(acc[ci][m], fa[m], fb, acc[ci][m]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, w2s + k * ldw(H) + cf * 16, ldw(H));
#pragma unroll
          for (int m = 0; m < TM / 16; ++m) wmma::mma_sync(acc[ci][m], fa[m], fb, acc[ci][m]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int ci = 0; ci < kMaxColFrags; ++ci) {
    const int cf = warp + ci * kWarps;
    if (cf < n_col_frags) {
#pragma unroll
      for (int m = 0; m < TM / 16; ++m)
        wmma::store_matrix_sync(stage + m * 16 * lds(H) + cf * 16, acc[ci][m], lds(H),
                                wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// Per-lane copies of a per-column vector: lane l holds columns l, l + 32, ...
// (0 past H), loaded once per kernel for the warp-per-edge epilogues.
template <bool BF16>
__device__ __forceinline__ void lane_cols(const float* __restrict__ v, int H,
                                          float (&out)[kColsPerLane]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int s = 0; s < kColsPerLane; ++s) out[s] = lane + 32 * s < H ? act<BF16>(v[lane + 32 * s]) : 0.0f;
}

__device__ __forceinline__ void lane_cols_bf16(const bf16* __restrict__ v, int H,
                                               float (&out)[kColsPerLane]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int s = 0; s < kColsPerLane; ++s)
    out[s] = lane + 32 * s < H ? __bfloat162float(v[lane + 32 * s]) : 0.0f;
}

// sum over the warp of sum_s bf16(m[s]) * w[s], in f32 (w: this lane's
// columns of a bf16 vector, 0 past H).
__device__ __forceinline__ float warp_dot_bf16(const float (&m)[kColsPerLane],
                                               const float (&w)[kColsPerLane]) {
  float dot = 0.0f;
#pragma unroll
  for (int s = 0; s < kColsPerLane; ++s) dot += round_bf16(m[s]) * w[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  return dot;
}

}  // namespace hd
