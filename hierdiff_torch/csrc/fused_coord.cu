// fused_coord_update: one coarse-stage DenseEquivariantUpdate forward on
// Hopper (sm_90a).
//
// Replaces: hierdiff_tpu/ops/egnn_pallas.py `fused_coord_update` (:492),
// whose body is `_coord_kernel` (:474) with `_edge_mlp` (:95).
//
// Computes, for h (B,N,H), edge_attr e (B,N,N,E), coord_diff (B,N,N,3),
// x (B,N,3), edge_mask (B,N,N) and node_mask (B,N):
//   m_ij  = silu(silu(h_i W_src + h_j W_dst + e_ij W_e + b1) W2 + b2)
//   s_ij  = m_ij . w_head                    (bf16 operands, f32 result)
//   s_ij  = tanh(s_ij) * coords_range        (tanh only)
//   out_i = (x_i + sum_j coord_diff_ij * s_ij * emask_ij / norm) * nmask_i
// Positions, coordinate differences and the scalar head stay f32, like
// egnn_pallas.py:510-512; the edge pipeline has bf16 matmul operands.
//
// What bounds it: the same edge pipeline as fused_gcl without the gate and
// without the node MLP: at B=64, N=32, H=256, E=2 ~8.7 GFLOP of bf16
// products (~9 us at the tensor-core peak) and ~2 silu per edge-channel
// (~4 SFU operations each, ~67 M in all, ~16 us at 16 SFU results per clock
// per SM), against ~3 MB of device memory traffic. Arithmetic bounds it.
//
// Design: as fused_gcl (see edge_mlp.cuh): proj_kernel for [h W_src | h W_dst],
// then persistent blocks over (batch, kRows source rows) items, each tile of
// kTileM edges built in shared memory as bf16, multiplied by the resident W2
// with WMMA, then the scalar head and each edge's f32 coord_diff term
// warp-per-edge, and their sum by one thread per (row, axis) in a fixed order.
#include "edge_mlp.cuh"

namespace hd {

struct CoordArgs {
  const float* e;
  const float* cdiff;
  const float* emask;
  const float* nmask;
  const float* x;
  const float* proj;
  const bf16* we;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* whead;
  float* out;
  int B, N, H, E;
  float norm, coords_range;
};

__host__ __device__ inline int coord_smem_bytes(int H) {
  return w2_bytes(H) + stage_bytes(H) + align128(kRows * 3 * 4) + 6 * kTileM * 4;
}

template <bool BF16, bool TANH>
__global__ void __launch_bounds__(kThreads, 1) coord_kernel(CoordArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  unsigned char* stage_raw = smem + w2_bytes(H);
  float* stage = reinterpret_cast<float*>(stage_raw);
  bf16* u = reinterpret_cast<bf16*>(stage_raw);
  float* agg = reinterpret_cast<float*>(stage_raw + stage_bytes(H));   // kRows x 3
  float* meta = agg + align128(kRows * 3 * 4) / 4;
  Tile tl{0, 0, a.N, 0, meta, reinterpret_cast<int*>(meta + kTileM),
          reinterpret_cast<int*>(meta + 2 * kTileM)};
  float* contrib = meta + 3 * kTileM;   // coord_diff * s * emask per tile edge (x3)

  HD_PHASE_START(clk);
  load_w2(a.w2, w2s, H);
  float b2[kColsPerLane], whead[kColsPerLane];
  lane_cols<BF16>(a.b2, H, b2);
  lane_cols_bf16(a.whead, H, whead);
  const int row_blocks = (a.N + kRows - 1) / kRows;
  const int item_rows = (a.N + row_blocks - 1) / row_blocks;   // balanced, <= kRows
  const int n_items = a.B * row_blocks;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / row_blocks, i0 = (item % row_blocks) * item_rows;
    const int rows = min(item_rows, a.N - i0);
    for (int idx = threadIdx.x; idx < kRows * 3; idx += blockDim.x) agg[idx] = 0.0f;
    tl.b = b;
    tl.i0 = i0;
    for (int q0 = 0; q0 < rows * a.N; q0 += kTileM) {
      load_tile(tl, q0, rows * a.N, a.emask);
      __syncthreads();
      HD_PHASE(0, clk);
      build_pre_tile<BF16>(tl, a.proj, a.e, a.we, a.b1, u, H, a.E);
      __syncthreads();
      HD_PHASE(1, clk);
      tile_mma(u, w2s, stage, H);
      HD_PHASE(2, clk);
      for (int t = warp; t < tl.n_valid; t += kWarps) {
        float m[kColsPerLane];
        edge_message<BF16>(stage + t * lds(H), b2, H, m);
        float s = warp_dot_bf16(m, whead);
        if (TANH) s = tanhf(s) * a.coords_range;
        if (lane < 3) contrib[t * 3 + lane] = a.cdiff[tl.edge(t) * 3 + lane] * s * tl.emask[t];
      }
      __syncthreads();
      HD_PHASE(3, clk);
      if (threadIdx.x < kRows * 3) {
        const int r = threadIdx.x / 3, d = threadIdx.x % 3;
        float sum = agg[threadIdx.x];
        for (int t = 0; t < tl.n_valid; ++t)
          if (tl.row[t] == r) sum += contrib[t * 3 + d];
        agg[threadIdx.x] = sum;
      }
      __syncthreads();
      HD_PHASE(4, clk);
    }
    if (threadIdx.x < rows * 3) {
      const size_t node = (size_t)b * a.N + i0 + threadIdx.x / 3;
      const int d = threadIdx.x % 3;
      a.out[node * 3 + d] = (a.x[node * 3 + d] + agg[threadIdx.x] / a.norm) * a.nmask[node];
    }
    __syncthreads();
    HD_PHASE(5, clk);
  }
}

template <bool BF16, bool TANH>
cudaError_t launch_coord(const CoordArgs& a, int max_blocks, cudaStream_t stream) {
  const int smem = coord_smem_bytes(a.H);
  cudaError_t err = cudaFuncSetAttribute(coord_kernel<BF16, TANH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = a.B * ((a.N + kRows - 1) / kRows);
  coord_kernel<BF16, TANH><<<(items < max_blocks ? items : max_blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace hd

extern "C" int hd_fused_coord(const float* h, const float* e, const float* cdiff,
                              const float* emask, const float* nmask, const float* x,
                              const hd::bf16* wsd, const hd::bf16* we, const float* b1,
                              const hd::bf16* w2, const float* b2, const hd::bf16* whead,
                              float* proj, float* out, int B, int N, int H, int E, float norm,
                              float coords_range, int tanh_on, int bf16_act, int max_blocks,
                              void* stream) {
  if (B * N == 0) return 0;
  if (H % 16 != 0 || H > hd::kMaxH || E > hd::kMaxE || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = hd::launch_proj(h, wsd, proj, B * N, H, st);
  if (err != cudaSuccess) return (int)err;
  const hd::CoordArgs a{e, cdiff, emask, nmask, x, proj, we, b1, w2, b2, whead, out,
                        B, N, H, E, norm, coords_range};
  if (bf16_act)
    err = tanh_on ? hd::launch_coord<true, true>(a, max_blocks, st)
                  : hd::launch_coord<true, false>(a, max_blocks, st);
  else
    err = tanh_on ? hd::launch_coord<false, true>(a, max_blocks, st)
                  : hd::launch_coord<false, false>(a, max_blocks, st);
  return (int)err;
}
