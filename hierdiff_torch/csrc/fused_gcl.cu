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
// What bounds it: per real edge 2 H^2 bf16 FLOPs of the W2 product against
// ~4 H SFU operations (exp and reciprocal of two silus), so at H = 256 the
// SFU, not the tensor cores or device memory, sets the bound.
//
// Design: five launches on the caller's stream.
//  1-2. the real-edge work list (sm90.cuh): only edges with emask != 0 are
//       computed, in (row, neighbour) order, packed into tiles of kTileM;
//  3.   proj_sm90_kernel (sm90.cuh): the products of h that need no
//       message, [h W_src | h W_dst] and z1h = h Wn1[:H], for every node,
//       64 rows per block, on wgmma with the weight copied into shared
//       memory by cp.async;
//  4.   gcl_edge_kernel: one persistent block per SM holds W2 in shared
//       memory (256 x 256 bf16, K-major, 128-byte swizzle: the layout wgmma
//       reads) and runs two warpgroups that walk their own tiles apart, so
//       one's SFU-heavy pre-activation build and epilogue overlap the
//       other's W2 product. Per 64-edge tile a warpgroup builds the bf16
//       silu(pre) tile in its own swizzled buffer (16-byte stores; the
//       build, the tile metadata and the W2 copy are in sm90.cuh), runs
//       the 64 x 256 x 256 product as wgmma m64n256k16 (f32 accumulators in
//       registers), applies b2, silu, the gate (a row's dot over the 4 lanes
//       of a quad) and the edge mask on the accumulators, and sums the f32
//       messages per source row in edge order through its buffer, 128
//       columns at a time. A row's run of edges that starts in the tile
//       goes to agg[row]; the run that continues a row from the tile before
//       goes to heads[tile];
//  5.   gcl_node_kernel: agg_i = (agg[i] + heads of the tiles the row runs
//       into, in tile order) / norm, written back to agg, then the node MLP
//       over all B*N rows, 64 per block: z1 = z1h + agg Wn1[H:] + bn1 and
//       silu(z1) Wn2 as two wgmma products.
// No float atomics: two runs are bitwise equal. agg is the caller's buffer;
// for training it is the residual that fused_gcl_bwd.cu reads.
#include <atomic>
#include <cstdint>

#include "sm90.cuh"

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
  const bf16* nw1t;      // node weights, nn.Linear layout (N x K): wgmma's B
  const float* nb1;
  const bf16* nw2t;
  const float* nb2;
  const int* rowstart;   // work list (sm90.cuh)
  const int* edges;
  const float* z1h;      // (B*N, H): h Wn1[:H], the h half of the node MLP's first layer
  float* heads;          // (tiles, H): the run of a row continued from the tile before
  float* agg;            // (B*N, H): runs that start in a tile, then agg / norm
  float* out;
  int B, N, H, E;
  float norm;
};

constexpr int kStageCols = kUBytes / (kTileM * 4);   // f32 columns staged at once (128)

// The row sums of the gated messages: write one run's sum to agg[row] or,
// for the run that continues a row from the tile before, to heads[tile].
__device__ __forceinline__ void flush_run(const GclArgs& a, const TileMeta& tm, int tile, int row,
                                          bool first, int c, float sum) {
  float* dst = first && tm.cont ? a.heads + (size_t)tile * a.H : a.agg + (size_t)row * a.H;
  dst[c] = sum;
}

template <bool BF16, bool ATT>
__global__ void __launch_bounds__(kEdgeThreads, 1) gcl_edge_kernel(GclArgs a) {
  const int H = a.H;
  const int n_edges = a.rowstart[a.B * a.N];
  const int n_tiles = (n_edges + kTileM - 1) / kTileM;
  if (blockIdx.x * kEdgeWGs >= n_tiles) return;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);   // swizzle atoms on 1 KB
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  bf16* u = reinterpret_cast<bf16*>(smem + kW2Bytes + wg * kUBytes);
  float* stage = reinterpret_cast<float*>(u);   // the f32 messages, kStageCols at a time
  TileMeta& tm = *reinterpret_cast<TileMeta*>(smem + kW2Bytes + kEdgeWGs * kUBytes + wg * kMetaBytes);
  float* b2s = reinterpret_cast<float*>(smem + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes));
  float* watts = b2s + kMaxH;

  HD_PHASE_START(clk);
  load_w2_sw128(a.w2, w2s, H);
  for (int c = threadIdx.x; c < kMaxH; c += blockDim.x) {
    b2s[c] = c < H ? act<BF16>(a.b2[c]) : 0.0f;
    watts[c] = ATT && c < H ? __bfloat162float(a.watt[c]) : 0.0f;
  }
  const float batt = ATT ? act<BF16>(a.batt[0]) : 0.0f;
  fence_proxy_async();
  __syncthreads();

  const int bar = 1 + wg;
  const int warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, rb = ra + 8;   // accumulator rows of this thread
  const int stride = gridDim.x * kEdgeWGs;
  int tile = blockIdx.x * kEdgeWGs + wg;
  MetaPrefetch pf = fetch_meta(a, tile, n_edges, tid);
  for (; tile < n_tiles; tile += stride) {
    const int q0 = tile * kTileM, nv = min(kTileM, n_edges - q0);
    if (tid < kTileM) {
      tm.row[tid] = pf.q >= 0 ? pf.q / a.N : -1;
      tm.col[tid] = pf.q >= 0 ? pf.q % a.N : 0;
      tm.emask[tid] = pf.emask;
      if (tid == 0) {
        tm.cont = pf.cont;
        HD_COUNT_EDGES(kTileM, nv);
      }
    }
    wg_barrier(bar);
    HD_WG_PHASE(0, clk);
    build_tile<BF16>(tm, nv, a, u);
    pf = fetch_meta(a, tile + stride, n_edges, tid);   // in flight during this tile
    fence_proxy_async();
    wg_barrier(bar);
    HD_WG_PHASE(1, clk);

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

    // bias, silu, gate and edge mask on the accumulators
    float dot_a = 0.0f, dot_b = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 bb = *reinterpret_cast<const float2*>(b2s + c);
      d[4 * j] = silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j]) + bb.x));
      d[4 * j + 1] = silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 1]) + bb.y));
      d[4 * j + 2] = silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 2]) + bb.x));
      d[4 * j + 3] = silu_act<BF16>(act<BF16>(act<BF16>(d[4 * j + 3]) + bb.y));
      if (ATT) {
        const float2 ww = *reinterpret_cast<const float2*>(watts + c);
        dot_a += round_bf16(d[4 * j]) * ww.x + round_bf16(d[4 * j + 1]) * ww.y;
        dot_b += round_bf16(d[4 * j + 2]) * ww.x + round_bf16(d[4 * j + 3]) * ww.y;
      }
    }
    float gate_a = 1.0f, gate_b = 1.0f;
    if (ATT) {   // the row's dot: the 4 lanes of a quad hold its columns
      dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 1);
      dot_a += __shfl_xor_sync(0xffffffffu, dot_a, 2);
      dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 1);
      dot_b += __shfl_xor_sync(0xffffffffu, dot_b, 2);
      gate_a = sigmoid_act<BF16>(act<BF16>(act<BF16>(dot_a) + batt));
      gate_b = sigmoid_act<BF16>(act<BF16>(act<BF16>(dot_b) + batt));
    }
    const float em_a = tm.emask[ra], em_b = tm.emask[rb];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      d[4 * j] = act<BF16>(act<BF16>(d[4 * j] * gate_a) * em_a);
      d[4 * j + 1] = act<BF16>(act<BF16>(d[4 * j + 1] * gate_a) * em_a);
      d[4 * j + 2] = act<BF16>(act<BF16>(d[4 * j + 2] * gate_b) * em_b);
      d[4 * j + 3] = act<BF16>(act<BF16>(d[4 * j + 3] * gate_b) * em_b);
    }
    HD_WG_PHASE(3, clk);

    // row sums: stage kStageCols columns of f32 messages in u's place, then
    // each thread walks one column over the tile's edges in order
#pragma unroll
    for (int half = 0; half < kMaxH / kStageCols; ++half) {
      wg_barrier(bar);
#pragma unroll
      for (int jj = 0; jj < kStageCols / 8; ++jj) {
        const int j = half * (kStageCols / 8) + jj, cc = 8 * jj + 2 * (lane % 4);
        *reinterpret_cast<float2*>(stage + ra * kStageCols + (cc ^ ((ra & 7) << 3))) =
            make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(stage + rb * kStageCols + (cc ^ ((rb & 7) << 3))) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
      wg_barrier(bar);
      const int c = half * kStageCols + tid;
      if (c < H) {
        int cur = tm.row[0];
        bool first = true;
        float sum = 0.0f;
        for (int p = 0; p < nv; ++p) {
          const int row = tm.row[p];
          if (row != cur) {
            flush_run(a, tm, tile, cur, first, c, sum);
            first = false;
            sum = 0.0f;
            cur = row;
          }
          sum += stage[p * kStageCols + (tid ^ ((p & 7) << 3))];
        }
        flush_run(a, tm, tile, cur, first, c, sum);
      }
    }
    wg_barrier(bar);
    HD_WG_PHASE(4, clk);
  }
}

// agg = (agg + heads of the tiles its row runs into) / norm in place, then
// out = (h + silu(z1h + agg Wn1[H:] + bn1) Wn2 + bn2) * nmask, 64 rows per block.
__global__ void __launch_bounds__(kNodeThreads, 1) gcl_node_kernel(GclArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + kMaxH * kMaxH * 2);
  float* nbs = reinterpret_cast<float*>(smem + kMaxH * kMaxH * 2 + kRowTile * kMaxH * 2);   // bn1, bn2
  const int H = a.H, M = a.B * a.N, r0 = blockIdx.x * kRowTile;
  const HalfFrag f;
  const int node_a = r0 + f.ra, node_b = r0 + f.rb;
  HD_PHASE_START(clk);
  load_b_async(bs, a.nw1t + H, 2 * H, H, H);   // Wn1^T columns H .. 2H - 1: the agg half
  for (int c = threadIdx.x; c < kMaxH; c += blockDim.x) {
    nbs[c] = c < H ? a.nb1[c] : 0.0f;
    nbs[kMaxH + c] = c < H ? a.nb2[c] : 0.0f;
  }
  // A = bf16(agg / norm) (64 x H); agg finished and written back.
  // kNodeBatch float4 columns per thread at a time, all their loads first.
  constexpr int kNodeBatch = 8;
  for (int idx0 = 0; idx0 < kRowTile * H / 4; idx0 += kNodeBatch * kNodeThreads) {
    float4 v[kNodeBatch];
    int s[kNodeBatch], e[kNodeBatch];
#pragma unroll
    for (int k = 0; k < kNodeBatch; ++k) {
      const int idx = idx0 + k * kNodeThreads + threadIdx.x;
      const int node = r0 + idx / (H / 4), c0 = 4 * (idx % (H / 4));
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      s[k] = e[k] = 0;
      if (idx < kRowTile * H / 4 && node < M) {
        v[k] = *reinterpret_cast<const float4*>(a.agg + (size_t)node * H + c0);
        s[k] = a.rowstart[node];
        e[k] = a.rowstart[node + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < kNodeBatch; ++k) {
      const int idx = idx0 + k * kNodeThreads + threadIdx.x;
      if (idx >= kRowTile * H / 4) break;
      const int r = idx / (H / 4), c0 = 4 * (idx % (H / 4)), node = r0 + r;
      if (s[k] < e[k]) {
        float4 sum = v[k];
        for (int t = s[k] / kTileM + 1; t <= (e[k] - 1) / kTileM; ++t) {
          const float4 hd = *reinterpret_cast<const float4*>(a.heads + (size_t)t * H + c0);
          sum.x += hd.x; sum.y += hd.y; sum.z += hd.z; sum.w += hd.w;
        }
        v[k] = make_float4(sum.x / a.norm, sum.y / a.norm, sum.z / a.norm, sum.w / a.norm);
      } else {
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (node < M) *reinterpret_cast<float4*>(a.agg + (size_t)node * H + c0) = v[k];
      __nv_bfloat162* av = reinterpret_cast<__nv_bfloat162*>(as + sw128_offset(r, c0, kRowTile));
      av[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
      av[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
    }
  }
  // this thread's z1h values, read while the weight arrives
  float2 zh[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = f.col(j);
    zh[j][0] = c < H && node_a < M ? *reinterpret_cast<const float2*>(a.z1h + (size_t)node_a * H + c)
                                   : make_float2(0.f, 0.f);
    zh[j][1] = c < H && node_b < M ? *reinterpret_cast<const float2*>(a.z1h + (size_t)node_b * H + c)
                                   : make_float2(0.f, 0.f);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  HD_PHASE(5, clk);
  float d[64];
  wgmma_half(d, as, bs, H / 16);
  __syncthreads();
  load_b_async(bs, a.nw2t, H, H, H);
#pragma unroll
  for (int j = 0; j < 16; ++j) {   // silu(z1) as the second product's A, in A's place
    const int c = f.col(j);
    if (c < H) {
      const float2 nb = *reinterpret_cast<const float2*>(nbs + c);
      const float z0 = zh[j][0].x + d[4 * j] + nb.x, z1 = zh[j][0].y + d[4 * j + 1] + nb.y;
      const float z2 = zh[j][1].x + d[4 * j + 2] + nb.x, z3 = zh[j][1].y + d[4 * j + 3] + nb.y;
      *reinterpret_cast<__nv_bfloat162*>(as + sw128_offset(f.ra, c, kRowTile)) =
          __floats2bfloat162_rn(z0 / (1.0f + expf(-z0)), z1 / (1.0f + expf(-z1)));
      *reinterpret_cast<__nv_bfloat162*>(as + sw128_offset(f.rb, c, kRowTile)) =
          __floats2bfloat162_rn(z2 / (1.0f + expf(-z2)), z3 / (1.0f + expf(-z3)));
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  HD_PHASE(6, clk);
  wgmma_half(d, as, bs, H / 16);
  // out = (h + z2 + bn2) * nmask; the h loads go out ahead of the stores
  const float m_a = node_a < M ? a.nmask[node_a] : 0.0f, m_b = node_b < M ? a.nmask[node_b] : 0.0f;
  float2 hv[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = f.col(j);
    hv[j][0] = c < H && node_a < M ? *reinterpret_cast<const float2*>(a.h + (size_t)node_a * H + c)
                                   : make_float2(0.f, 0.f);
    hv[j][1] = c < H && node_b < M ? *reinterpret_cast<const float2*>(a.h + (size_t)node_b * H + c)
                                   : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = f.col(j);
    if (c >= H) continue;
    const float2 nb = *reinterpret_cast<const float2*>(nbs + kMaxH + c);
    if (node_a < M)
      *reinterpret_cast<float2*>(a.out + (size_t)node_a * H + c) =
          make_float2((hv[j][0].x + (d[4 * j] + nb.x)) * m_a, (hv[j][0].y + (d[4 * j + 1] + nb.y)) * m_a);
    if (node_b < M)
      *reinterpret_cast<float2*>(a.out + (size_t)node_b * H + c) =
          make_float2((hv[j][1].x + (d[4 * j + 2] + nb.x)) * m_b, (hv[j][1].y + (d[4 * j + 3] + nb.y)) * m_b);
  }
  HD_PHASE(7, clk);
}

template <bool BF16, bool ATT>
cudaError_t launch_edges(const GclArgs& a, int max_blocks, std::atomic<uint64_t>& smem_set,
                         cudaStream_t stream) {
  const int smem = edge_smem_bytes();
  cudaError_t err = smem_limit_once((const void*)gcl_edge_kernel<BF16, ATT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long max_tiles = ((long long)a.B * a.N * a.N + kTileM - 1) / kTileM;
  const long long want = (max_tiles + kEdgeWGs - 1) / kEdgeWGs;
  gcl_edge_kernel<BF16, ATT><<<(int)(want < max_blocks ? want : max_blocks), kEdgeThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace hd

extern "C" int hd_fused_gcl(const float* h, const float* e, const float* emask,
                            const float* nmask, const hd::bf16* wsrct, const hd::bf16* wdstt,
                            const hd::bf16* we, const float* b1, const hd::bf16* w2, const float* b2,
                            const hd::bf16* watt, const float* batt, const hd::bf16* nw1t,
                            const float* nb1, const hd::bf16* nw2t, const float* nb2,
                            float* proj, float* z1h, int* rowstart, int* totals, int* edges,
                            float* heads, float* agg, float* out, int B, int N, int H, int E, float norm,
                            int attention, int bf16_act, int max_blocks, void* stream) {
  if (B * N == 0) return 0;
  if (H % 16 != 0 || H > hd::kMaxH || E > hd::kMaxE || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N, row_tiles = (M + hd::kRowTile - 1) / hd::kRowTile;
  cudaError_t err = hd::launch_edge_list(emask, M, N, rowstart, totals, edges, st);
  if (err != cudaSuccess) return (int)err;
  const int node_smem = hd::node_smem_bytes();
  // the once-flags live here, in a function that is neither inline nor a
  // template: their symbols stay local to this library, so the phase-clock
  // build of this file, loaded into the same process, keeps its own (a
  // static in a template would be one object for both libraries)
  static std::atomic<uint64_t> proj_smem_set{0}, node_smem_set{0}, edge_smem_set[4];
  err = hd::smem_limit_once((const void*)hd::proj_sm90_kernel, node_smem, proj_smem_set);
  if (err != cudaSuccess) return (int)err;
  hd::proj_sm90_kernel<<<dim3(row_tiles, 3), hd::kNodeThreads, node_smem, st>>>(h, wsrct, wdstt, nw1t, proj,
                                                                                   z1h, M, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const hd::GclArgs a{h, e, emask, nmask, proj, we, b1, w2, b2, watt, batt, nw1t, nb1, nw2t, nb2,
                      rowstart, edges, z1h, heads, agg, out, B, N, H, E, norm};
  std::atomic<uint64_t>& edge_set = edge_smem_set[2 * (bf16_act != 0) + (attention != 0)];
  if (bf16_act)
    err = attention ? hd::launch_edges<true, true>(a, max_blocks, edge_set, st)
                    : hd::launch_edges<true, false>(a, max_blocks, edge_set, st);
  else
    err = attention ? hd::launch_edges<false, true>(a, max_blocks, edge_set, st)
                    : hd::launch_edges<false, false>(a, max_blocks, edge_set, st);
  if (err != cudaSuccess) return (int)err;
  err = hd::smem_limit_once((const void*)hd::gcl_node_kernel, node_smem, node_smem_set);
  if (err != cudaSuccess) return (int)err;
  hd::gcl_node_kernel<<<row_tiles, hd::kNodeThreads, node_smem, st>>>(a);
  return (int)cudaGetLastError();
}
