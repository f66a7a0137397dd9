// fused_gcl: one coarse-stage DenseGCL forward on Hopper (sm_90a).
//
// Replaces: hierdiff_tpu/ops/egnn_pallas.py `fused_gcl` (:141), whose body
// is `_gcl_kernel` (:117) with `_edge_mlp` (:95).
//
// Computes, for h (B,N,H), edge_attr e (B,N,N,E), edge_mask (B,N,N) and
// node_mask (B,N):
//   m_ij  = silu(silu(h_i W_src + h_j W_dst + e_ij W_e + b1) W2 + b2)
//   m_ij *= sigmoid(m_ij . w_att + b_att)                 (attention only)
//   agg_i = sum_j m_ij * emask_ij / norm                   (f32 sum)
//   out_i = (h_i + silu([h_i, agg_i] Wn1 + bn1) Wn2 + bn2) * nmask_i
// with bf16 matmul operands and f32 accumulation everywhere, like the Pallas
// kernel. The (B,N,N,H) message tensor never reaches device memory.
//
// What bounds it: at the GEOM shape (B=64, N=32, H=256, E=2) the work is
// ~10 GFLOP of bf16 products (the H x H edge product dominates) against ~3 MB
// of device memory traffic, so bytes never bound it. The limit is the
// arithmetic: 10 GFLOP is ~10 us at the bf16 tensor-core peak, while the
// ~2 silu + 1 sigmoid per edge-channel need ~4 SFU operations (exp and
// reciprocal) each, ~67 M in all, ~16 us at 16 SFU results per clock per SM.
//
// Design: two launches on the caller's stream. proj_kernel (edge_mlp.cuh)
// computes [h W_src | h W_dst] for all nodes once (the Pallas kernel
// recomputes the destination half per row chunk). gcl_kernel then walks work
// items of kRows source rows (edge_mlp.cuh); per tile of kTileM edges it
// builds the bf16 pre-activation in shared memory, runs the W2 product on the
// tensor cores (WMMA, W2 resident in shared memory for the whole kernel),
// applies bias, silu, gate and edge mask warp-per-edge, and adds the tile
// into the f32 row sums column-per-thread (a fixed order, so the result is
// deterministic). After the last tile of an item the node MLP runs on the
// tensor cores for its rows, with the node weights read from L2. This first
// version is plain WMMA with one block per SM; wgmma, TMA and warp
// specialisation are later work.
//
// For training, the caller may pass agg_out (B,N,H): the kernel then also
// writes agg_i (already divided by norm), the one residual that
// fused_gcl_bwd.cu needs besides the inputs.
#include "edge_mlp.cuh"

namespace hd {

struct GclArgs {
  const float* h;
  const float* e;
  const float* emask;
  const float* nmask;
  const float* proj;
  const bf16* we;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* watt;
  const float* batt;
  const bf16* nw1;
  const float* nb1;
  const bf16* nw2;
  const float* nb2;
  float* out;
  float* agg_out;   // may be null
  int B, N, H, E;
  float norm;
};

__host__ __device__ inline int gcl_smem_bytes(int H) {
  return w2_bytes(H) + stage_bytes(H) + align128(kRows * H * 4) + 3 * kTileM * 4;
}

// out (kRows x Nc, f32, smem) = a (kRows x K, bf16, smem) @ w (K x Nc, bf16,
// row-major, device memory); warp w owns column fragments w, w + kWarps, ...
__device__ __forceinline__ void rows_mma(const bf16* a, int lda, const bf16* __restrict__ w, int K, int Nc,
                         float* out, int ldo) {
  static_assert(kRows == 16, "one WMMA row fragment per work item");
  const int warp = threadIdx.x / 32;
  for (int cf = warp; cf < Nc / 16; cf += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 8   // several weight fragments in flight from L2
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + k, lda);
      wmma::load_matrix_sync(fb, w + (size_t)k * Nc + cf * 16, Nc);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + cf * 16, acc, ldo, wmma::mem_row_major);
  }
}

// Gate and mask one staged tile in place: warp per edge.
template <bool BF16, bool ATT>
__device__ __forceinline__ void gate_and_mask(const Tile& tl, float* stage, const float (&b2)[kColsPerLane],
                              const float (&watt)[kColsPerLane], float batt, const GclArgs& a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < tl.n_valid; t += kWarps) {
    float* row = stage + t * lds(a.H);
    float m[kColsPerLane];
    edge_message<BF16>(row, b2, a.H, m);
    float att = 1.0f;
    if (ATT) {
      const float z = act<BF16>(act<BF16>(warp_dot_bf16(m, watt)) + batt);
      att = sigmoid_act<BF16>(z);
    }
#pragma unroll
    for (int s = 0; s < kColsPerLane; ++s) {
      const int c = lane + 32 * s;
      if (c < a.H) row[c] = act<BF16>(act<BF16>(m[s] * att) * tl.emask[t]);
    }
  }
}

// The block's rows: out = (h + node_mlp([h, agg / norm])) * nmask.
__device__ __forceinline__ void node_mlp(int b, int i0, int rows, unsigned char* stage_raw, const float* agg,
                         const GclArgs& a) {
  const int H = a.H;
  const int lda1 = 2 * H + 8, lda2 = H + 8, ldo = lds(H);
  bf16* a1 = reinterpret_cast<bf16*>(stage_raw);
  float* o = reinterpret_cast<float*>(stage_raw + align128(kRows * lda1 * 2));
  bf16* a2 = reinterpret_cast<bf16*>(stage_raw + align128(kRows * lda1 * 2) +
                                     align128(kRows * ldo * 4));
  for (int idx = threadIdx.x; idx < kRows * 2 * H; idx += blockDim.x) {
    const int r = idx / (2 * H), c = idx % (2 * H);
    float v = 0.0f;
    if (r < rows) {
      const size_t node = (size_t)b * a.N + i0 + r;
      v = c < H ? a.h[node * H + c] : agg[r * H + c - H] / a.norm;
      if (c >= H && a.agg_out != nullptr) a.agg_out[node * H + c - H] = v;
    }
    a1[r * lda1 + c] = __float2bfloat16(v);
  }
  __syncthreads();
  rows_mma(a1, lda1, a.nw1, 2 * H, H, o, ldo);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    const float z = o[r * ldo + c] + a.nb1[c];
    a2[r * lda2 + c] = __float2bfloat16(z / (1.0f + expf(-z)));
  }
  __syncthreads();
  rows_mma(a2, lda2, a.nw2, H, H, o, ldo);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    const size_t node = (size_t)b * a.N + i0 + r;
    a.out[node * H + c] = (a.h[node * H + c] + (o[r * ldo + c] + a.nb2[c])) * a.nmask[node];
  }
  __syncthreads();
}

template <bool BF16, bool ATT>
__global__ void __launch_bounds__(kThreads, 1) gcl_kernel(GclArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H;
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  unsigned char* stage_raw = smem + w2_bytes(H);
  float* stage = reinterpret_cast<float*>(stage_raw);
  bf16* u = reinterpret_cast<bf16*>(stage_raw);
  float* agg = reinterpret_cast<float*>(stage_raw + stage_bytes(H));
  float* meta = reinterpret_cast<float*>(stage_raw + stage_bytes(H) + align128(kRows * H * 4));
  Tile tl{0, 0, a.N, 0, meta, reinterpret_cast<int*>(meta + kTileM),
          reinterpret_cast<int*>(meta + 2 * kTileM)};

  HD_PHASE_START(clk);
  load_w2(a.w2, w2s, H);
  float b2[kColsPerLane], watt[kColsPerLane];
  lane_cols<BF16>(a.b2, H, b2);
  lane_cols_bf16(a.watt, H, watt);   // zeros when attention is off
  const float batt = ATT ? act<BF16>(a.batt[0]) : 0.0f;
  const int row_blocks = (a.N + kRows - 1) / kRows;
  const int item_rows = (a.N + row_blocks - 1) / row_blocks;   // balanced, <= kRows
  const int n_items = a.B * row_blocks;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / row_blocks, i0 = (item % row_blocks) * item_rows;
    const int rows = min(item_rows, a.N - i0);
    for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) agg[idx] = 0.0f;
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
      gate_and_mask<BF16, ATT>(tl, stage, b2, watt, batt, a);
      __syncthreads();
      HD_PHASE(3, clk);
      // row sums, one column per thread: a register sum per run of one row
      for (int c = threadIdx.x; c < H; c += blockDim.x) {
        int cur = tl.row[0];
        float sum = 0.0f;
        for (int t = 0; t < tl.n_valid; ++t) {
          if (tl.row[t] != cur) {
            agg[cur * H + c] += sum;
            sum = 0.0f;
            cur = tl.row[t];
          }
          sum += stage[t * lds(H) + c];
        }
        agg[cur * H + c] += sum;
      }
      __syncthreads();
      HD_PHASE(4, clk);
    }
    node_mlp(b, i0, rows, stage_raw, agg, a);
    HD_PHASE(5, clk);
  }
}

template <bool BF16, bool ATT>
cudaError_t launch_gcl(const GclArgs& a, int max_blocks, cudaStream_t stream) {
  const int smem = gcl_smem_bytes(a.H);
  cudaError_t err = cudaFuncSetAttribute(gcl_kernel<BF16, ATT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int items = a.B * ((a.N + kRows - 1) / kRows);
  gcl_kernel<BF16, ATT><<<(items < max_blocks ? items : max_blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace hd

extern "C" int hd_fused_gcl(const float* h, const float* e, const float* emask,
                            const float* nmask, const hd::bf16* wsd, const hd::bf16* we,
                            const float* b1, const hd::bf16* w2, const float* b2,
                            const hd::bf16* watt, const float* batt, const hd::bf16* nw1,
                            const float* nb1, const hd::bf16* nw2, const float* nb2,
                            float* proj, float* out, float* agg_out, int B, int N, int H,
                            int E, float norm,
                            int attention, int bf16_act, int max_blocks, void* stream) {
  if (B * N == 0) return 0;
  if (H % 16 != 0 || H > hd::kMaxH || E > hd::kMaxE || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = hd::launch_proj(h, wsd, proj, B * N, H, st);
  if (err != cudaSuccess) return (int)err;
  const hd::GclArgs a{h, e, emask, nmask, proj, we, b1, w2, b2, watt, batt,
                      nw1, nb1, nw2, nb2, out, agg_out, B, N, H, E, norm};
  if (bf16_act)
    err = attention ? hd::launch_gcl<true, true>(a, max_blocks, st)
                    : hd::launch_gcl<true, false>(a, max_blocks, st);
  else
    err = attention ? hd::launch_gcl<false, true>(a, max_blocks, st)
                    : hd::launch_gcl<false, false>(a, max_blocks, st);
  return (int)err;
}
