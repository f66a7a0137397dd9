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
// Positions, coordinate differences, the scalar head and the sums stay f32,
// like egnn_pallas.py:510-512; the edge pipeline has bf16 matmul operands.
//
// What bounds it: per real edge 2 H^2 bf16 FLOPs of the W2 product against
// ~4 H SFU operations (exp and reciprocal of two silus), so at H = 256 the
// SFU, not the tensor cores or device memory, sets the bound; the output is
// 3 floats per node.
//
// Design: four launches on the caller's stream, fused_gcl's edge pipeline
// (sm90.cuh) with a 3-wide output.
//  1-2. the real-edge work list (sm90.cuh): only edges with emask != 0 are
//       computed (an edge with emask == 0 adds exactly 0), in (row,
//       neighbour) order, packed into tiles of kTileM;
//  3.   proj_sm90_kernel (sm90.cuh) with a grid of height 2: [h W_src |
//       h W_dst] for every node, on wgmma;
//  4.   coord_edge_kernel, a cooperative launch of one persistent block per
//       SM holding W2 in shared memory (K-major, 128-byte swizzle, copied by
//       cp.async from its nn.Linear-layout copy while the first tiles are
//       built) with two warpgroups that walk their own 64-edge tiles, so
//       one's pre-activation build overlaps the other's product. Per tile:
//       the bf16 silu(pre) tile, the 64 x 256 x 256 product on wgmma
//       m64n256k16 into f32 registers, then in registers b2, silu and the head s = m . w_head as
//       a row dot over the 4 lanes of a quad, tanh * coords_range, and each
//       edge's three f32 terms coord_diff * s * emask into shared memory: the
//       256-wide message never leaves registers. The terms are summed per
//       source row in edge order: a row's run that starts in the tile goes to
//       agg[row], the run that continues a row from the tile before goes to
//       heads[tile]. After a grid-wide barrier every block finishes a slice
//       of the nodes: out_i = (x_i + (agg[i] + heads of the tiles row i runs
//       into, in tile order) / norm) * nmask_i, for every node, with or
//       without real edges.
// No float atomics: two runs are bitwise equal.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>

#include "sm90.cuh"

namespace hd {

namespace cg = cooperative_groups;

struct CoordArgs {
  const float* e;
  const float* cdiff;
  const float* emask;
  const float* nmask;
  const float* x;
  const float* proj;     // (B*N, 2H): [h W_src | h W_dst]
  const bf16* we;
  const float* b1;
  const bf16* w2t;       // W2 in nn.Linear layout (out, in): wgmma's B, K-major
  const float* b2;
  const bf16* whead;
  const int* rowstart;   // work list (sm90.cuh)
  const int* edges;
  float* heads;          // (tiles, 3): the run of a row continued from the tile before
  float* agg;            // (B*N, 3): the run of a row that starts in a tile
  float* out;
  int B, N, H, E;
  float norm, coords_range;
};

// Per warpgroup, beside its TileMeta: the tile's coordinate differences
// (read a tile ahead) and its edges' terms coord_diff * s * emask.
struct CoordTile {
  float cd[kTileM][3];
  float term[kTileM][3];
};
constexpr int kCoordTileOffset = kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes) + 2 * kMaxH * 4;

__host__ __device__ constexpr int coord_smem_bytes() {
  return edge_smem_bytes() + kEdgeWGs * (int)sizeof(CoordTile);
}

// fetch_meta (sm90.cuh) plus the edge's coordinate difference.
struct CoordPrefetch {
  MetaPrefetch m;
  float cd[3];
};

__device__ __forceinline__ CoordPrefetch fetch_coord_meta(const CoordArgs& a, int tile, int n_edges,
                                                          int tid) {
  CoordPrefetch p{fetch_meta(a, tile, n_edges, tid), {0.0f, 0.0f, 0.0f}};
  if (p.m.q >= 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) p.cd[d] = a.cdiff[(size_t)p.m.q * 3 + d];
  }
  return p;
}

template <bool BF16, bool TANH>
__global__ void __launch_bounds__(kEdgeThreads, 1) coord_edge_kernel(CoordArgs a) {
  const int H = a.H, M = a.B * a.N;
  const int n_edges = a.rowstart[M];
  const int n_tiles = (n_edges + kTileM - 1) / kTileM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);   // swizzle atoms on 1 KB
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  bf16* u = reinterpret_cast<bf16*>(smem + kW2Bytes + wg * kUBytes);
  TileMeta& tm = *reinterpret_cast<TileMeta*>(smem + kW2Bytes + kEdgeWGs * kUBytes + wg * kMetaBytes);
  float* b2s = reinterpret_cast<float*>(smem + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes));
  float* wheads = b2s + kMaxH;
  CoordTile& ct = *reinterpret_cast<CoordTile*>(smem + kCoordTileOffset + wg * sizeof(CoordTile));

  HD_PHASE_START(clk);
  if (blockIdx.x * kEdgeWGs < n_tiles) {   // the same for the whole block
    load_b_async(w2s, a.w2t, H, H, H);     // lands while the first tiles are built
    for (int c = threadIdx.x; c < kMaxH; c += blockDim.x) {
      b2s[c] = c < H ? act<BF16>(a.b2[c]) : 0.0f;
      wheads[c] = c < H ? __bfloat162float(a.whead[c]) : 0.0f;
    }
    const int bar = 1 + wg;
    const int warp = tid / 32, lane = tid % 32;
    const int ra = warp * 16 + lane / 4, rb = ra + 8;   // accumulator rows of this thread
    const int stride = gridDim.x * kEdgeWGs;
    int tile = blockIdx.x * kEdgeWGs + wg;
    CoordPrefetch pf = fetch_coord_meta(a, tile, n_edges, tid);
    // tile t's metadata and bf16 pre-activation tile; the next tile's
    // metadata is read meanwhile
    auto stage = [&](int t) {
      if (tid < kTileM) {
        tm.row[tid] = pf.m.q >= 0 ? pf.m.q / a.N : -1;
        tm.col[tid] = pf.m.q >= 0 ? pf.m.q % a.N : 0;
        tm.emask[tid] = pf.m.emask;
#pragma unroll
        for (int d = 0; d < 3; ++d) ct.cd[tid][d] = pf.cd[d];
        if (tid == 0) {
          tm.cont = pf.m.cont;
          HD_COUNT_EDGES(kTileM, min(kTileM, n_edges - t * kTileM));
        }
      }
      wg_barrier(bar);
      HD_WG_PHASE(0, clk);
      build_tile<BF16>(tm, min(kTileM, n_edges - t * kTileM), a, u);
      pf = fetch_coord_meta(a, t + stride, n_edges, tid);
      fence_proxy_async();
      HD_WG_PHASE(1, clk);
    };
    if (tile < n_tiles) stage(tile);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // W2, b2, the head and each warpgroup's first tile in place
    HD_WG_PHASE(0, clk);

    for (; tile < n_tiles; tile += stride) {
      const int nv = min(kTileM, n_edges - tile * kTileM);
      wg_barrier(bar);   // the tile built by every warp of the warpgroup
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(d[i]);
      wgmma_fence();
      for (int s = 0; s < H / 16; ++s)
        wgmma_m64n256k16(d, sw128_desc(u + sw128_offset(0, 16 * s, kTileM)),
                         sw128_desc(w2s + sw128_offset(0, 16 * s, kMaxH)));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) fence_operand(d[i]);
      HD_WG_PHASE(2, clk);

      // m = silu(act(d) + b2) and the head's dot, rounded to bf16 first as a
      // bf16 matmul operand; a row's columns lie on the 4 lanes of a quad
      float dot_a = 0.0f, dot_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 bb = *reinterpret_cast<const float2*>(b2s + c);
        const float2 ww = *reinterpret_cast<const float2*>(wheads + c);
        dot_a += round_bf16(silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j]) + bb.x))) * ww.x +
                 round_bf16(silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 1]) + bb.y))) * ww.y;
        dot_b += round_bf16(silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 2]) + bb.x))) * ww.x +
                 round_bf16(silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 3]) + bb.y))) * ww.y;
      }
      dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 1);
      dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 2);
      dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 1);
      dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 2);
      if (TANH) {
        dot_a = tanhf(dot_a) * a.coords_range;
        dot_b = tanhf(dot_b) * a.coords_range;
      }
      const int axis = lane % 4;   // lanes 0-2 of the quad write the three terms
      if (axis < 3) {
        ct.term[ra][axis] = ra < nv ? ct.cd[ra][axis] * dot_a * tm.emask[ra] : 0.0f;
        ct.term[rb][axis] = rb < nv ? ct.cd[rb][axis] * dot_b * tm.emask[rb] : 0.0f;
      }
      wg_barrier(bar);
      HD_WG_PHASE(3, clk);

      // row sums in edge order, one thread per (run start, axis)
      for (int idx = tid; idx < nv * 3; idx += 128) {
        const int p = idx / 3, axis3 = idx % 3, row = tm.row[p];
        if (p > 0 && tm.row[p - 1] == row) continue;
        float sum = 0.0f;
        for (int k = p; k < nv && tm.row[k] == row; ++k) sum += ct.term[k][axis3];
        float* dst = p == 0 && tm.cont ? a.heads + (size_t)tile * 3 : a.agg + (size_t)row * 3;
        dst[axis3] = sum;
      }
      wg_barrier(bar);   // tm, ct and u free for the next tile
      HD_WG_PHASE(4, clk);
      if (tile + stride < n_tiles) stage(tile + stride);
    }
  }

  cg::this_grid().sync();   // every run written; orders the writes before the reads below
  HD_WG_PHASE(5, clk);
  for (int node = blockIdx.x * blockDim.x + threadIdx.x; node < M; node += gridDim.x * blockDim.x) {
    const int s = a.rowstart[node], e = a.rowstart[node + 1];
    float sum[3] = {0.0f, 0.0f, 0.0f};
    if (s < e) {
#pragma unroll
      for (int d = 0; d < 3; ++d) sum[d] = a.agg[(size_t)node * 3 + d];
      for (int t = s / kTileM + 1; t <= (e - 1) / kTileM; ++t) {
#pragma unroll
        for (int d = 0; d < 3; ++d) sum[d] += a.heads[(size_t)t * 3 + d];
      }
    }
    const float m = a.nmask[node];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      a.out[(size_t)node * 3 + d] = (a.x[(size_t)node * 3 + d] + sum[d] / a.norm) * m;
  }
  HD_WG_PHASE(6, clk);
}

// A cooperative launch, so that every block is resident and the grid-wide
// barrier cannot wait for a block that never starts.
template <bool BF16, bool TANH>
cudaError_t launch_coord_edges(const CoordArgs& a, int max_blocks, std::atomic<uint64_t>& smem_set,
                               cudaStream_t stream) {
  const void* kernel = (const void*)coord_edge_kernel<BF16, TANH>;
  const int smem = coord_smem_bytes();
  cudaError_t err = smem_limit_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long max_tiles = ((long long)a.B * a.N * a.N + kTileM - 1) / kTileM;
  const long long want = (max_tiles + kEdgeWGs - 1) / kEdgeWGs;
  CoordArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(kernel, dim3((int)(want < max_blocks ? want : max_blocks)),
                                     dim3(kEdgeThreads), params, smem, stream);
}

}  // namespace hd

extern "C" int hd_fused_coord(const float* h, const float* e, const float* cdiff,
                              const float* emask, const float* nmask, const float* x,
                              const hd::bf16* wsrct, const hd::bf16* wdstt, const hd::bf16* we,
                              const float* b1, const hd::bf16* w2t, const float* b2,
                              const hd::bf16* whead, float* proj, int* rowstart, int* totals,
                              int* edges, float* heads, float* agg, float* out, int B, int N, int H,
                              int E, float norm, float coords_range, int tanh_on, int bf16_act,
                              int max_blocks, void* stream) {
  if (B * N == 0) return 0;
  if (H % 16 != 0 || H > hd::kMaxH || E > hd::kMaxE || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, row_tiles = (M + hd::kRowTile - 1) / hd::kRowTile;
  cudaError_t err = hd::launch_edge_list(emask, M, N, rowstart, totals, edges, st);
  if (err != cudaSuccess) return (int)err;
  // once-flags local to this library (see smem_limit_once)
  static std::atomic<uint64_t> proj_smem_set{0}, edge_smem_set[4];
  const int proj_smem = hd::node_smem_bytes();
  err = hd::smem_limit_once((const void*)hd::proj_sm90_kernel, proj_smem, proj_smem_set);
  if (err != cudaSuccess) return (int)err;
  hd::proj_sm90_kernel<<<dim3(row_tiles, 2), hd::kNodeThreads, proj_smem, st>>>(
      h, wsrct, wdstt, nullptr, proj, nullptr, M, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const hd::CoordArgs a{e, cdiff, emask, nmask, x, proj, we, b1, w2t, b2, whead, rowstart, edges,
                        heads, agg, out, B, N, H, E, norm, coords_range};
  std::atomic<uint64_t>& edge_set = edge_smem_set[2 * (bf16_act != 0) + (tanh_on != 0)];
  if (bf16_act)
    err = tanh_on ? hd::launch_coord_edges<true, true>(a, max_blocks, edge_set, st)
                  : hd::launch_coord_edges<true, false>(a, max_blocks, edge_set, st);
  else
    err = tanh_on ? hd::launch_coord_edges<false, true>(a, max_blocks, edge_set, st)
                  : hd::launch_coord_edges<false, false>(a, max_blocks, edge_set, st);
  return (int)err;
}
