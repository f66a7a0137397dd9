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
// SFU sets the least time: ~4.1k SM cycles a 64-edge tile, the tensor cores
// ~1-2k. What holds the edge kernel above that is latency and issue: the
// pre-activation build (gathers of [h W_src | h W_dst], an exp and a
// reciprocal per element), the W2 product, the epilogue and the row sums
// are chains of dependent instructions, and an SM sub-partition has only a
// few warps to hide them, since a block of W2 and three tiles fills shared
// memory and 128 accumulators a consumer thread fill the register file.
// The design runs the build and the rest side by side in different warps,
// and builds without a branch per element, so that the compiler can
// interleave a batch's independent element chains.
//
// Design: five launches on the caller's stream.
//  1-2. the real-edge work list (sm90.cuh): only edges with emask != 0 are
//       computed, in (row, neighbour) order, packed into tiles of kTileM;
//  3.   proj_sm90_kernel (sm90.cuh): the products of h that need no
//       message, [h W_src | h W_dst] and z1h = h Wn1[:H], for every node,
//       64 rows per block, on wgmma with the weight copied into shared
//       memory by cp.async;
//  4.   gcl_edge_kernel, warp-specialised: one persistent block per SM
//       holds W2 in shared memory (256 x 256 bf16, K-major, 128-byte
//       swizzle: the layout wgmma reads) and a ring of kStages bf16 tiles,
//       each with a "full" and an "empty" mbarrier. The block walks tiles
//       blockIdx.x, + gridDim.x, ... in order:
//       - a producer warpgroup builds each tile's silu(pre) into the next
//         free stage (8 columns a lane, 16 edges a warp, the gathers of a
//         batch of edges issued together, h_i W_src read once per row run,
//         padding edges and columns masked to 0 instead of branched
//         around), then arrives on the stage's "full";
//       - two consumer warpgroups take the tiles in turn: the 64 x 256 x 256
//         product as wgmma m64n256k16 (f32 accumulators in registers), b2,
//         silu, the gate (a row's dot over the 4 lanes of a quad) and the
//         edge mask on the accumulators, then the f32 messages summed per
//         source row in edge order through the stage, 128 columns at a
//         time; then they arrive on the stage's "empty". A row's run of
//         edges that starts in the tile goes to agg[row]; the run that
//         continues a row from the tile before goes to heads[tile]. The
//         tile's edge indices and mask come from the work list in global
//         memory, one tile ahead, and its runs from a ballot.
//       Each SM sub-partition has a producer and two consumer warps to
//       issue from. 384 threads leave 168 registers a thread; setmaxnreg
//       moves a few from the producer (136, which keeps a batch of gathers
//       in flight: with fewer it spills and the build slows) to the
//       consumers (184: the accumulators and the epilogue without spills);
//  5.   gcl_node_kernel: agg_i = (agg[i] + heads of the tiles the row runs
//       into, in tile order) / norm, written back to agg, then the node MLP
//       over all B*N rows, 64 per block: z1 = z1h + agg Wn1[H:] + bn1 and
//       silu(z1) Wn2 as two wgmma products.
// No float atomics: two runs are bitwise equal, and equal to the symmetric
// two-warpgroup edge kernel this design replaced (the same formulas, product
// instruction, k order and edge-order sums). agg is the caller's buffer; for
// training it is the residual that fused_gcl_bwd.cu reads.
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

// ---- the edge kernel's ring
constexpr int kConsumerWGs = 2;                      // product, epilogue, row sums; tiles in turn
constexpr int kRingThreads = 128 * (kConsumerWGs + 1);   // and one producer warpgroup
constexpr int kStages = 3;                           // bf16 tiles in the ring
constexpr int kConsumerRegs = 184, kProducerRegs = 136;   // of 168 a thread at launch
static_assert(kConsumerWGs * kConsumerRegs + kProducerRegs <= 65536 / 128,
              "setmaxnreg: the register file of one SM");
constexpr int kBuildEdges = kTileM / 4;              // edges a producer warp builds per tile (16)
constexpr int kBuildBatch = 2;                       // edges whose gathers go out together
constexpr int kBuildRegE = 2;                        // rows of W_e a producer lane keeps in registers
constexpr int kStageCols = kUBytes / (kTileM * 4);   // f32 columns staged at once (128)

// W2, the ring, b2 (f32), w_att (bf16) and the ring's mbarriers
__host__ __device__ constexpr int ring_smem_bytes() {
  return 1024 + kW2Bytes + kStages * kUBytes + kMaxH * 4 + kMaxH * 2 + 2 * kStages * 8;
}
static_assert(ring_smem_bytes() <= 232448, "shared memory of one block");

// Cycle counters of the ring, compiled in only with -DHD_PHASE_CLOCKS
// (tools/kernel_phases.py): thread 0 of each warpgroup adds its cycles per
// role and phase, and the consumers count the tiles whose stage was already
// full when they reached it.
#ifdef HD_PHASE_CLOCKS
constexpr int kRingCounters = 9;
__device__ unsigned long long hd_ring_counters[kRingCounters];
#define HD_RING_START(t) long long t = clock64()
#define HD_RING_MARK(k, t)                                                           \
  do {                                                                               \
    if (threadIdx.x % 128 == 0) {                                                    \
      const long long now_ = clock64();                                              \
      atomicAdd(&hd_ring_counters[k], static_cast<unsigned long long>(now_ - (t)));  \
      (t) = now_;                                                                    \
    }                                                                                \
  } while (0)
// Copy the counters to out[kRingCounters] and zero them.
extern "C" int hd_read_ring_counters(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, hd_ring_counters, sizeof(hd_ring_counters));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[kRingCounters] = {};
  return (int)cudaMemcpyToSymbol(hd_ring_counters, zeros, sizeof(zeros));
}
#else
#define HD_RING_START(t) long long t = 0
#define HD_RING_MARK(k, t) do { } while (0)
#endif
// 0 setup (W2, b2, w_att, barriers), 1 producer build, 2 producer wait on
// "empty", 3 consumer wait on "full", 4 product, 5 epilogue, 6 row sums;
// 7 tiles found full, 8 tiles consumed

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive (release): this thread's earlier writes are seen by the waiters.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Whether the barrier's phase of this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait (acquire) until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A consumer lane's view of a tile's edges from the work list: flat
// indices of edges lane and 32 + lane (-1 past the last real edge), and the
// edge before the tile (-1 for the first tile).
struct TileEdges {
  int lo, hi, prev;
};

__device__ __forceinline__ TileEdges tile_edges(const GclArgs& a, int tile, int n_edges, int lane) {
  TileEdges t{-1, -1, -1};
  const int q0 = tile * kTileM;
  if (q0 + lane < n_edges) t.lo = a.edges[q0 + lane];
  if (q0 + 32 + lane < n_edges) t.hi = a.edges[q0 + 32 + lane];
  if (q0 > 0 && q0 < n_edges) t.prev = a.edges[q0 - 1];
  return t;
}

// x where keep is all ones, +0 where it is 0: a select without a branch.
__device__ __forceinline__ float masked(float x, unsigned keep) {
  return __uint_as_float(__float_as_uint(x) & keep);
}

// A producer lane's edge of a tile: the flat index of the edge in slot
// `slot`, -1 past the last real edge.
__device__ __forceinline__ int tile_edge(const GclArgs& a, int tile, int slot, int n_edges) {
  const int q = tile * kTileM + slot;
  return q < n_edges ? a.edges[q] : -1;
}

// Consumer warpgroup cw: tiles i = cw, cw + kConsumerWGs, ... of the block's
// walk, each from stage i % kStages.
template <bool BF16, bool ATT>
__device__ __forceinline__ void consume(const GclArgs& a, int n_edges, int n_tiles, const bf16* w2s,
                                        bf16* ring, const float* b2s, const bf16* watts,
                                        uint64_t* full, uint64_t* empty, long long& clk) {
  const int H = a.H, N = a.N;
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bar = 1 + cw;
  const int warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, rb = ra + 8;   // accumulator rows of this thread
  const float batt = ATT ? act<BF16>(a.batt[0]) : 0.0f;
  TileEdges next = tile_edges(a, blockIdx.x + cw * gridDim.x, n_edges, lane);
  for (int i = cw;; i += kConsumerWGs) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= n_tiles) break;
    const TileEdges te = next;
    next = tile_edges(a, tile + kConsumerWGs * gridDim.x, n_edges, lane);   // in flight
    const int nv = min(kTileM, n_edges - tile * kTileM);
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    bf16* u = ring + s * (kUBytes / 2);
    float* stage = reinterpret_cast<float*>(u);   // the f32 messages, kStageCols at a time
#ifdef HD_PHASE_CLOCKS
    if (tid == 0) {
      atomicAdd(&hd_ring_counters[7], mbar_test(full + s, parity) ? 1ull : 0ull);
      atomicAdd(&hd_ring_counters[8], 1ull);
      HD_COUNT_EDGES(kTileM, nv);
    }
#endif
    mbar_wait(full + s, parity);
    HD_RING_MARK(3, clk);

    float d[128];
#pragma unroll
    for (int k = 0; k < 128; ++k) d[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 128; ++k) fence_operand(d[k]);
    wgmma_fence();
    for (int k = 0; k < H / 16; ++k)
      wgmma_m64n256k16(d, sw128_desc(u + sw128_offset(0, 16 * k, kTileM)),
                       sw128_desc(w2s + sw128_offset(0, 16 * k, kMaxH)));
    wgmma_commit();
    // while the product runs: the source rows of the tile's edges, the edge
    // mask of this thread's two rows, whether the first run continues a row
    const int row_lo = te.lo >= 0 ? te.lo / N : -1, row_hi = te.hi >= 0 ? te.hi / N : -1;
    const int qa = __shfl_sync(0xffffffffu, warp < 2 ? te.lo : te.hi, ra % 32);
    const int qb = __shfl_sync(0xffffffffu, warp < 2 ? te.lo : te.hi, rb % 32);
    const float em_a = qa >= 0 ? round_bf16(a.emask[qa]) : 0.0f;
    const float em_b = qb >= 0 ? round_bf16(a.emask[qb]) : 0.0f;
    const int row0 = __shfl_sync(0xffffffffu, row_lo, 0);
    const bool cont = te.prev >= 0 && te.prev / N == row0;
    // bit p: edge p starts a run of one source row
    const int up_lo = __shfl_up_sync(0xffffffffu, row_lo, 1), up_hi = __shfl_up_sync(0xffffffffu, row_hi, 1);
    const int last_lo = __shfl_sync(0xffffffffu, row_lo, 31);
    const uint64_t starts =
        (uint64_t)__ballot_sync(0xffffffffu, lane < nv && (lane == 0 || row_lo != up_lo)) |
        (uint64_t)__ballot_sync(0xffffffffu, 32 + lane < nv && row_hi != (lane == 0 ? last_lo : up_hi)) << 32;
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 128; ++k) fence_operand(d[k]);
    HD_RING_MARK(4, clk);

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
        const float2 ww = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(watts + c));
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
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      d[4 * j] = act<BF16>(act<BF16>(d[4 * j] * gate_a) * em_a);
      d[4 * j + 1] = act<BF16>(act<BF16>(d[4 * j + 1] * gate_a) * em_a);
      d[4 * j + 2] = act<BF16>(act<BF16>(d[4 * j + 2] * gate_b) * em_b);
      d[4 * j + 3] = act<BF16>(act<BF16>(d[4 * j + 3] * gate_b) * em_b);
    }
    HD_RING_MARK(5, clk);

    // row sums: stage kStageCols columns of f32 messages in the tile's
    // place, then each thread walks one column over the tile's runs, each
    // run's edges in order
#pragma unroll
    for (int half = 0; half < kMaxH / kStageCols; ++half) {
      if (half * kStageCols >= H) break;
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
      uint64_t rest = starts;
      bool first = true;
      while (rest != 0) {
        const int p0 = __ffsll((long long)rest) - 1;
        rest &= rest - 1;
        const int p1 = rest != 0 ? __ffsll((long long)rest) - 1 : nv;
        const int row = __shfl_sync(0xffffffffu, p0 < 32 ? row_lo : row_hi, p0 & 31);
        float sum = 0.0f;
        int p = p0;
        for (; p + 4 <= p1; p += 4) {   // four loads out at once, added in order
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = stage[(p + k) * kStageCols + (tid ^ (((p + k) & 7) << 3))];
#pragma unroll
          for (int k = 0; k < 4; ++k) sum += v[k];
        }
        for (; p < p1; ++p) sum += stage[p * kStageCols + (tid ^ ((p & 7) << 3))];
        if (c < H) {
          float* dst = first && cont ? a.heads + (size_t)tile * H : a.agg + (size_t)row * H;
          dst[c] = sum;
        }
        first = false;
      }
    }
    mbar_arrive(empty + s);
    HD_RING_MARK(6, clk);
  }
}

// The producer warpgroup: every tile of the block's walk, in order, into
// stage i % kStages; warp w builds edges 16 w .. 16 w + 15, lane l columns
// 8 l .. 8 l + 7 (one 16-byte store per edge). u = silu(pre), pre = h_i W_src
// + h_j W_dst + e_ij W_e + b1 from a.proj, a.e, a.we and a.b1, with the
// arithmetic of sm90.cuh build_tile; padding edges and columns >= H get 0.
template <bool BF16>
__device__ __forceinline__ void produce(const GclArgs& a, int n_edges, int n_tiles, bf16* ring,
                                        uint64_t* full, uint64_t* empty, long long& clk) {
  const int H = a.H, N = a.N, E = a.E;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int c0 = 8 * lane;
  const bool col_ok = c0 < H;
  const int cl = col_ok ? c0 : 0;   // lanes past H read column 0: every address is valid
  float bias[8], wreg[kBuildRegE][8];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    bias[cc] = col_ok ? act<BF16>(a.b1[c0 + cc]) : 0.0f;
#pragma unroll
    for (int r = 0; r < kBuildRegE; ++r)
      wreg[r][cc] = col_ok && r < E ? __bfloat162float(a.we[r * H + c0 + cc]) : 0.0f;
  }
  // lane l holds the flat index of the warp's edge 16 warp + l % 16 of a tile
  const int slot = kBuildEdges * warp + lane % kBuildEdges;
  int q_next = tile_edge(a, blockIdx.x, slot, n_edges);
  for (int i = 0;; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    if (tile >= n_tiles) break;
    const int q_lane = q_next;
    q_next = tile_edge(a, tile + gridDim.x, slot, n_edges);   // in flight
    // the source row and the destination node of the lane's edge
    const int row_lane = q_lane >= 0 ? q_lane / N : -1;
    const int dst_lane = q_lane >= 0 ? (row_lane / N) * N + (q_lane - row_lane * N) : 0;
    const int s = i % kStages;
    mbar_wait(empty + s, ((i / kStages) & 1) ^ 1);
    HD_RING_MARK(2, clk);
    bf16* u = ring + s * (kUBytes / 2);
    int row_prev = -1;
    float4 hs_prev[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int k0 = 0; k0 < kBuildEdges; k0 += kBuildBatch) {
      float4 hs[kBuildBatch][2], hdst[kBuildBatch][2];
      float ev[kBuildBatch][kBuildRegE];
      int q[kBuildBatch];
#pragma unroll
      for (int k = 0; k < kBuildBatch; ++k) {   // all loads of the batch first
        q[k] = __shfl_sync(0xffffffffu, q_lane, k0 + k);
        const int row = __shfl_sync(0xffffffffu, row_lane, k0 + k);
        const int dst = __shfl_sync(0xffffffffu, dst_lane, k0 + k);
        const float* sp = a.proj + (size_t)max(row, 0) * 2 * H + cl;
        const float* dp = a.proj + (size_t)dst * 2 * H + H + cl;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          hs[k][v] = k == 0 ? hs_prev[v] : hs[k > 0 ? k - 1 : 0][v];
          if (row != row_prev)   // a new source row: read h_i W_src
            hs[k][v] = *reinterpret_cast<const float4*>(sp + 4 * v);
          hdst[k][v] = *reinterpret_cast<const float4*>(dp + 4 * v);
        }
        row_prev = row;
        const size_t qe = (size_t)max(q[k], 0) * E;
#pragma unroll
        for (int r = 0; r < kBuildRegE; ++r) ev[k][r] = r < E ? a.e[qe + r] : 0.0f;
      }
      hs_prev[0] = hs[kBuildBatch - 1][0];
      hs_prev[1] = hs[kBuildBatch - 1][1];
#pragma unroll
      for (int k = 0; k < kBuildBatch; ++k) {
        const int p = kBuildEdges * warp + k0 + k;
        const unsigned keep = q[k] >= 0 && col_ok ? 0xffffffffu : 0u;   // else the store is 0
        const float hsv[8] = {hs[k][0].x, hs[k][0].y, hs[k][0].z, hs[k][0].w,
                              hs[k][1].x, hs[k][1].y, hs[k][1].z, hs[k][1].w};
        const float hdv[8] = {hdst[k][0].x, hdst[k][0].y, hdst[k][0].z, hdst[k][0].w,
                              hdst[k][1].x, hdst[k][1].y, hdst[k][1].z, hdst[k][1].w};
        float ep[8];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          ep[cc] = 0.0f;
#pragma unroll
          for (int r = 0; r < kBuildRegE; ++r)
            if (r < E) ep[cc] += round_bf16(ev[k][r]) * wreg[r][cc];
        }
        if (q[k] >= 0 && E > kBuildRegE) {   // the rest of W_e from L1
          for (int r = kBuildRegE; r < E; ++r) {
            const float er = round_bf16(a.e[(size_t)q[k] * E + r]);
            const uint4 wv = *reinterpret_cast<const uint4*>(a.we + r * H + cl);
            const bf16* w8 = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) ep[cc] += er * __bfloat162float(w8[cc]);
          }
        }
        uint4 packed;
        __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int cc = 0; cc < 8; cc += 2) {   // no branch: every lane computes, the mask zeroes
          const float v0 = masked(silu_act<BF16>(pre_act<BF16>(hsv[cc], hdv[cc], ep[cc], bias[cc])), keep);
          const float v1 =
              masked(silu_act<BF16>(pre_act<BF16>(hsv[cc + 1], hdv[cc + 1], ep[cc + 1], bias[cc + 1])), keep);
          pk[cc / 2] = __floats2bfloat162_rn(v0, v1);
        }
        *reinterpret_cast<uint4*>(u + sw128_offset(p, c0, kTileM)) = packed;
      }
    }
    fence_proxy_async();   // the generic-proxy stores, seen by the consumers' wgmma
    mbar_arrive(full + s);
    HD_RING_MARK(1, clk);
  }
}

template <bool BF16, bool ATT>
__global__ void __launch_bounds__(kRingThreads, 1) gcl_edge_kernel(GclArgs a) {
  const int n_edges = a.rowstart[a.B * a.N];
  const int n_tiles = (n_edges + kTileM - 1) / kTileM;
  if (blockIdx.x >= n_tiles) return;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);   // swizzle atoms on 1 KB
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + kW2Bytes);
  float* b2s = reinterpret_cast<float*>(smem + kW2Bytes + kStages * kUBytes);
  bf16* watts = reinterpret_cast<bf16*>(b2s + kMaxH);
  uint64_t* full = reinterpret_cast<uint64_t*>(watts + kMaxH);
  uint64_t* empty = full + kStages;

  HD_RING_START(clk);
  load_w2_sw128(a.w2, w2s, a.H);
  for (int c = threadIdx.x; c < kMaxH; c += blockDim.x) {
    b2s[c] = c < a.H ? act<BF16>(a.b2[c]) : 0.0f;
    watts[c] = ATT && c < a.H ? a.watt[c] : __float2bfloat16(0.0f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 128);
    }
    fence_mbarrier_init();
  }
  fence_proxy_async();
  __syncthreads();
  HD_RING_MARK(0, clk);
  // one branch per role to the end; the warpgroup index through a shuffle,
  // so that the compiler sees the branch uniform in each warp and leaves the
  // consumers' wgmma unserialised
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) < kConsumerWGs) {
    setmaxnreg_inc<kConsumerRegs>();
    consume<BF16, ATT>(a, n_edges, n_tiles, w2s, ring, b2s, watts, full, empty, clk);
  } else {
    setmaxnreg_dec<kProducerRegs>();
    produce<BF16>(a, n_edges, n_tiles, ring, full, empty, clk);
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
  const int smem = ring_smem_bytes();
  cudaError_t err = smem_limit_once((const void*)gcl_edge_kernel<BF16, ATT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long max_tiles = ((long long)a.B * a.N * a.N + kTileM - 1) / kTileM;
  gcl_edge_kernel<BF16, ATT><<<(int)(max_tiles < max_blocks ? max_tiles : max_blocks), kRingThreads, smem,
                               stream>>>(a);
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
