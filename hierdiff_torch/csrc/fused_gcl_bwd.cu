// fused_gcl_bwd: backward of one coarse-stage DenseGCL on Hopper (sm_90a).
//
// Replaces: hierdiff_tpu/ops/egnn_pallas.py `fused_gcl_bwd` (:346), whose body
// is `_gcl_bwd_kernel` (:235), behind the custom VJP `gcl_vjp` (:444).
//
// Given the upstream gradient g (B,N,H) of fused_gcl's output, the forward's
// inputs and its one residual agg (B,N,H, already divided by norm; written by
// fused_gcl.cu), computes dh (B,N,H), de (B,N,N,E) and every weight and bias
// gradient in f32, with the Pallas kernel's rounding points: bf16 operands and
// f32 accumulation in every product (the wgrad contractions included), the
// edge pipeline's elementwise results rounded to the act dtype (f32, or bf16
// for compute_dtype='bfloat16'), row and column sums in f32, and the node-MLP
// backward in f32 elementwise. The (B,N,N,H) edge tensors are rematerialised
// per tile and never reach device memory.
//
// What bounds it: per valid edge the least work is three H x H products on
// the tensor cores (the rematerialised u W2, du = dv W2^T and dW2 += u^T dv,
// 6 H^2 bf16 FLOPs) and two sigmoids per edge-channel on the SFU; per node
// the node-MLP backward. At the GEOM layer shape of chip_smoke.py (B=64,
// N=32, H=256, E=2, ragged counts) that is ~14 GFLOP (~14 us at the bf16
// peak) and ~30 M exp+reciprocal (~7 us), against ~13 MB of device memory
// (~4 us): bound by operations.
//
// Design (a first, simple version: correctness before speed). Several
// launches on the caller's stream behind one C entry point:
//   1. proj_kernel: [h W_src | h W_dst] for every node (as the forward).
//   2. The node-MLP backward, row-parallel: z1 = [h, agg] Wn1 + bn1 is
//      rematerialised from the saved agg, then do1 = g2 Wn2^T, dz1, dcat =
//      dz1 Wn1^T, giving dh's direct part and dagg. Products run in this
//      file's own tiled WMMA GEMM (bf16 operands, f32 accumulation).
//   3. gcl_bwd_kernel, persistent blocks over the forward's work items (a
//      molecule x up to kRows source rows; an item holds whole rows, so agg
//      and hence dagg are complete before any edge of the item is touched).
//      Per tile of kBwdTileM = 32 edges: rebuild u = silu(pre) and v = u W2
//      + b2 (W2 resident in shared memory, as in the forward), back through
//      the gate and silu to dv, du = dv W2^T (the same resident W2 read as a
//      column-major operand), dpre; row sums of dpre (dhs), column sums per
//      row block (dh_dst partials), de = dpre W_e^T warp per edge, and the
//      weight gradients. The tile is 32 edges because u, dv and the f32 stage
//      must sit beside W2 in 227 KB of shared memory (219 KB used).
//   4. Weight gradients: dW2 (256x256 f32 = 256 KB, more than a block's
//      shared memory) is a per-block f32 partial in device memory (L2),
//      updated per tile with WMMA; dW_e, db1, db2, dw_att and db_att are
//      per-block partials too. Fixed-order reductions over blocks and over row
//      blocks follow; no float atomics anywhere, so two runs on the same
//      inputs give bitwise equal gradients.
//   5. dh += dhs W_src^T + dh_dst W_dst^T, and the node-level wgrads (W_src,
//      W_dst, Wn1, Wn2: K = B*N) as split-K GEMMs with a fixed-order sum.
#include "edge_mlp.cuh"

namespace hd {

constexpr int kBwdTileM = 32;        // edges per backward tile
constexpr int kGemmTile = 64;        // output tile of the generic GEMM
constexpr int kGemmK = 32;
constexpr int kGemmThreads = 128;
constexpr int kEwThreads = 256;      // elementwise kernels
constexpr int kColChunk = 64;        // rows per partial column sum

// ---------------------------------------------------------------------------
// Generic GEMM: C[z] (+)= op(A)[:, K_z] @ B[K_z, :], bf16 operands, f32
// accumulation. op(A)[m][k] = TA ? A[k * lda + m] : A[m * lda + k] (A f32);
// B[k][n] = Bm[k * ldb + n] (f32 or bf16). Split z covers K rows
// [z * k_chunk, (z + 1) * k_chunk) and writes C + z * split_stride.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

template <bool TA, typename TB>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ A, const TB* __restrict__ Bm, float* __restrict__ C,
            int M, int Nc, int K, int lda, int ldb, int ldc, int k_chunk, size_t split_stride,
            int accumulate) {
  __shared__ __align__(128) bf16 as[kGemmTile][kGemmK + 8];
  __shared__ __align__(128) bf16 bs[kGemmK][kGemmTile + 8];
  __shared__ __align__(128) float cs[kGemmTile][kGemmTile + 4];
  const int row0 = blockIdx.x * kGemmTile, col0 = blockIdx.y * kGemmTile;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  C += blockIdx.z * split_stride;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;   // each warp owns a 32 x 32 quadrant
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = kb; k0 < ke; k0 += kGemmK) {
    for (int idx = threadIdx.x; idx < kGemmTile * kGemmK; idx += kGemmThreads) {
      int r, k;
      if (TA) { k = idx / kGemmTile; r = idx % kGemmTile; }   // neighbours read neighbours
      else { r = idx / kGemmK; k = idx % kGemmK; }
      const int gr = row0 + r, gk = k0 + k;
      float v = 0.0f;
      if (gr < M && gk < ke) v = TA ? A[(size_t)gk * lda + gr] : A[(size_t)gr * lda + gk];
      as[r][k] = __float2bfloat16(v);
    }
    for (int idx = threadIdx.x; idx < kGemmK * kGemmTile; idx += kGemmThreads) {
      const int k = idx / kGemmTile, c = idx % kGemmTile;
      const int gk = k0 + k, gc = col0 + c;
      bs[k][c] = gk < ke && gc < Nc ? to_bf16(Bm[(size_t)gk * ldb + gc]) : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &as[wr * 32 + i * 16][kk], kGemmK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &bs[kk][wc * 32 + j * 16], kGemmTile + 8);
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
      wmma::store_matrix_sync(&cs[wr * 32 + i * 16][wc * 32 + j * 16], acc[i][j], kGemmTile + 4,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kGemmTile * kGemmTile; idx += kGemmThreads) {
    const int r = idx / kGemmTile, c = idx % kGemmTile;
    if (row0 + r < M && col0 + c < Nc) {
      float* dst = C + (size_t)(row0 + r) * ldc + col0 + c;
      *dst = accumulate ? *dst + cs[r][c] : cs[r][c];
    }
  }
}

template <bool TA, typename TB>
cudaError_t gemm(const float* A, const TB* Bm, float* C, int M, int Nc, int K, int lda, int ldb,
                 int ldc, int splits, bool accumulate, cudaStream_t st) {
  const int k_chunk = (K + splits - 1) / splits;
  const dim3 grid((M + kGemmTile - 1) / kGemmTile, (Nc + kGemmTile - 1) / kGemmTile, splits);
  gemm_kernel<TA, TB><<<grid, kGemmThreads, 0, st>>>(A, Bm, C, M, Nc, K, lda, ldb, ldc, k_chunk,
                                                     (size_t)M * ldc, accumulate ? 1 : 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Elementwise and reduction kernels of the node-MLP backward (f32)
// ---------------------------------------------------------------------------

#define HD_GRID_STRIDE(idx, n) \
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < (n); \
       idx += (size_t)gridDim.x * blockDim.x)

inline int ew_blocks(size_t n) {
  const size_t blocks = (n + kEwThreads - 1) / kEwThreads;
  return (int)(blocks < 2048 ? (blocks > 0 ? blocks : 1) : 2048);
}

// cat = [h, agg] (rows x 2H); g2 = g * nmask
__global__ void node_prep_kernel(const float* __restrict__ h, const float* __restrict__ agg,
                                 const float* __restrict__ g, const float* __restrict__ nmask,
                                 float* __restrict__ cat, float* __restrict__ g2, int rows, int H) {
  HD_GRID_STRIDE(idx, (size_t)rows * H) {
    const size_t r = idx / H;
    const int c = idx % H;
    cat[r * 2 * H + c] = h[idx];
    cat[r * 2 * H + H + c] = agg[idx];
    g2[idx] = g[idx] * nmask[r];
  }
}

// z1 += bn1 (in place); o1 = silu(z1), as the forward's node MLP
__global__ void node_act_kernel(float* __restrict__ z1, const float* __restrict__ nb1,
                                float* __restrict__ o1, int rows, int H) {
  HD_GRID_STRIDE(idx, (size_t)rows * H) {
    const float z = z1[idx] + nb1[idx % H];
    z1[idx] = z;
    o1[idx] = z / (1.0f + expf(-z));
  }
}

// dz1 = do1 * silu'(z1)
__global__ void node_dz_kernel(const float* __restrict__ do1, const float* __restrict__ z1,
                               float* __restrict__ dz1, int rows, int H) {
  HD_GRID_STRIDE(idx, (size_t)rows * H) {
    const float z = z1[idx];
    const float s = 1.0f / (1.0f + expf(-z));
    dz1[idx] = do1[idx] * (s * (1.0f + z * (1.0f - s)));
  }
}

// dh = g2 + dcat[:, :H]; dagg = dcat[:, H:] / norm
__global__ void node_split_kernel(const float* __restrict__ g2, const float* __restrict__ dcat,
                                  float* __restrict__ dh, float* __restrict__ dagg, int rows,
                                  int H, float norm) {
  HD_GRID_STRIDE(idx, (size_t)rows * H) {
    const size_t r = idx / H;
    const int c = idx % H;
    dh[idx] = g2[idx] + dcat[r * 2 * H + c];
    dagg[idx] = dcat[r * 2 * H + H + c] / norm;
  }
}

// parts[chunk][c] = sum of x[r][c] over the chunk's rows, in row order
__global__ void colsum_kernel(const float* __restrict__ x, int rows, int cols,
                              float* __restrict__ parts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kColChunk, r1 = min(rows, r0 + kColChunk);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += x[(size_t)r * cols + c];
  parts[(size_t)blockIdx.y * cols + c] = s;
}

// out[i] = sum over z = 0, 1, ... of parts[z * stride + i]
__global__ void reduce_kernel(const float* __restrict__ parts, int count, size_t stride,
                              size_t size, float* __restrict__ out) {
  HD_GRID_STRIDE(i, size) {
    float s = 0.0f;
    for (int z = 0; z < count; ++z) s += parts[z * stride + i];
    out[i] = s;
  }
}

cudaError_t reduce(const float* parts, int count, size_t stride, size_t size, float* out,
                   cudaStream_t st) {
  reduce_kernel<<<ew_blocks(size), kEwThreads, 0, st>>>(parts, count, stride, size, out);
  return cudaGetLastError();
}

// out[c] = sum_r x[r][c], via fixed row chunks and a fixed-order sum
cudaError_t column_sum(const float* x, int rows, int cols, float* parts, float* out,
                       cudaStream_t st) {
  const int chunks = (rows + kColChunk - 1) / kColChunk;
  colsum_kernel<<<dim3((cols + kEwThreads - 1) / kEwThreads, chunks), kEwThreads, 0, st>>>(
      x, rows, cols, parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(parts, chunks, cols, cols, out, st);
}

// ---------------------------------------------------------------------------
// The edge backward
// ---------------------------------------------------------------------------

// Per-block partial layout (floats): dW2 (H x H, in x out), dW_e (E x H),
// db1, db2, dw_att (H each), db_att (1), padded to 8 floats so every block's
// dW2 starts 32-byte aligned for WMMA.
__host__ __device__ inline int part_floats(int H, int E) {
  return (H * H + E * H + 3 * H + 1 + 7) / 8 * 8;
}

__host__ __device__ inline int bwd_smem_bytes(int H) {
  return w2_bytes(H) + 2 * align128(kBwdTileM * ldw(H) * 2) +
         align128(kBwdTileM * lds(H) * 4) + align128(kRows * H * 4) + 3 * kBwdTileM * 4;
}

struct GclBwdArgs {
  const float* e;
  const float* emask;
  const float* proj;
  const bf16* we;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* watt;
  const float* watt32;
  const float* batt;
  const float* dagg;
  float* dhs;        // (B,N,H): sum_j dpre_ij
  float* dst_part;   // (row_blocks, B, N, H): sum over a row block's i of dpre_ij
  float* de;         // (B,N,N,E)
  float* blk;        // (gridDim.x, part_floats) per-block weight-gradient partials
  int B, N, H, E;
};

// dW2 (block partial, H x H f32 in device memory) += u^T dv over one tile:
// warp per 16 x 16 output fragment, u read as a column-major operand.
__device__ __forceinline__ void dw2_update(const bf16* us, const bf16* dvs, float* dw2, int H) {
  const int warp = threadIdx.x / 32;
  const int nf = H / 16;
  for (int f = warp; f < nf * nf; f += kWarps) {
    const int mf = f / nf, cf = f % nf;
    float* out = dw2 + (size_t)mf * 16 * H + cf * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, out, H, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < kBwdTileM; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, us + k * ldw(H) + mf * 16, ldw(H));
      wmma::load_matrix_sync(fb, dvs + k * ldw(H) + cf * 16, ldw(H));
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out, acc, H, wmma::mem_row_major);
  }
}

template <bool BF16, bool ATT>
__global__ void __launch_bounds__(kThreads, 1) gcl_bwd_kernel(GclBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, N = a.N, E = a.E;
  const int ldu = ldw(H);
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  unsigned char* p = smem + w2_bytes(H);
  bf16* us = reinterpret_cast<bf16*>(p);     // u, then dpre
  p += align128(kBwdTileM * ldu * 2);
  bf16* dvs = reinterpret_cast<bf16*>(p);    // dv
  p += align128(kBwdTileM * ldu * 2);
  float* stage = reinterpret_cast<float*>(p);   // u W2, then dv W2^T
  p += align128(kBwdTileM * lds(H) * 4);
  float* dhs_s = reinterpret_cast<float*>(p);   // the item's rows of dhs
  p += align128(kRows * H * 4);
  float* meta = reinterpret_cast<float*>(p);
  Tile tl{0, 0, N, 0, meta, reinterpret_cast<int*>(meta + kBwdTileM),
          reinterpret_cast<int*>(meta + 2 * kBwdTileM)};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* part = a.blk + (size_t)blockIdx.x * part_floats(H, E);
  float* part_we = part + H * H;
  float* part_b1 = part_we + E * H;
  float* part_b2 = part_b1 + H;
  float* part_att = part_b2 + H;

  HD_PHASE_START(clk);
  load_w2(a.w2, w2s, H);
  float b2[kColsPerLane], watt[kColsPerLane], watt_act[kColsPerLane];
  lane_cols<BF16>(a.b2, H, b2);
  lane_cols_bf16(a.watt, H, watt);       // bf16 gate weights (forward product)
  lane_cols<BF16>(a.watt32, H, watt_act);   // f32 gate weights in the act dtype (dm0 term)
  const float batt = ATT ? act<BF16>(a.batt[0]) : 0.0f;
  // warp sums over the edges it handles (lane columns): db2, dw_att, db_att
  float acc_b2[kColsPerLane] = {}, acc_att[kColsPerLane] = {};
  float acc_batt = 0.0f;
  // column c = threadIdx.x (the epilogue of dpre): db1, W_e and b1 in registers
  const int c = threadIdx.x;
  const bool col = c < H;
  float acc_b1 = 0.0f, wreg[kRegE];
#pragma unroll
  for (int k = 0; k < kRegE; ++k) wreg[k] = col && k < E ? __bfloat162float(a.we[k * H + c]) : 0.0f;
  const float bias1 = col ? act<BF16>(a.b1[c]) : 0.0f;
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) dhs_s[idx] = 0.0f;

  const int row_blocks = (N + kRows - 1) / kRows;
  const int item_rows = (N + row_blocks - 1) / row_blocks;
  const int n_items = a.B * row_blocks;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / row_blocks, rb = item % row_blocks, i0 = rb * item_rows;
    const int rows = min(item_rows, N - i0);
    const float* node = a.proj + (size_t)b * N * 2 * H;
    float* dst = a.dst_part + ((size_t)rb * a.B + b) * N * H;
    tl.b = b;
    tl.i0 = i0;
    for (int q0 = 0; q0 < rows * N; q0 += kBwdTileM) {
      load_tile<kBwdTileM>(tl, q0, rows * N, a.emask);
      __syncthreads();
      HD_PHASE(0, clk);
      build_pre_tile<BF16, kBwdTileM>(tl, a.proj, a.e, a.we, a.b1, us, H, E);
      __syncthreads();
      HD_PHASE(1, clk);
      tile_mma_t<kBwdTileM, false>(us, w2s, stage, H);
      HD_PHASE(2, clk);

      // back through silu, the gate and the mask to dv: warp per edge
      for (int t = warp; t < kBwdTileM; t += kWarps) {
        bf16* dvrow = dvs + t * ldu;
        if (t >= tl.n_valid) {
#pragma unroll
          for (int s = 0; s < kColsPerLane; ++s)
            if (lane + 32 * s < H) dvrow[lane + 32 * s] = __float2bfloat16(0.0f);
          continue;
        }
        const float* row = stage + t * lds(H);
        const float* dg = a.dagg + ((size_t)b * N + i0 + tl.row[t]) * H;
        float v[kColsPerLane], m0[kColsPerLane], dm1[kColsPerLane];
#pragma unroll
        for (int s = 0; s < kColsPerLane; ++s) {
          const int cc = lane + 32 * s;
          v[s] = cc < H ? act<BF16>(act<BF16>(row[cc]) + b2[s]) : 0.0f;
          m0[s] = cc < H ? silu_act<BF16>(v[s]) : 0.0f;
          dm1[s] = cc < H ? act<BF16>(act<BF16>(dg[cc]) * tl.emask[t]) : 0.0f;
        }
        float att = 1.0f, dza = 0.0f;
        if (ATT) {
          att = sigmoid_act<BF16>(act<BF16>(act<BF16>(warp_dot_bf16(m0, watt)) + batt));
          float dot = 0.0f;
#pragma unroll
          for (int s = 0; s < kColsPerLane; ++s) dot += act<BF16>(dm1[s] * m0[s]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const float datt = act<BF16>(dot);
          dza = act<BF16>(act<BF16>(datt * att) * act<BF16>(1.0f - att));
          acc_batt += dza;
        }
#pragma unroll
        for (int s = 0; s < kColsPerLane; ++s) {
          const int cc = lane + 32 * s;
          if (cc < H) {
            const float dm0 = ATT ? act<BF16>(act<BF16>(dm1[s] * att) + act<BF16>(dza * watt_act[s]))
                                  : dm1[s];
            const float dv = act<BF16>(dm0 * dsilu_act<BF16>(v[s]));
            acc_b2[s] += dv;
            if (ATT) acc_att[s] += round_bf16(m0[s]) * round_bf16(dza);
            dvrow[cc] = __float2bfloat16(dv);
          }
        }
      }
      __syncthreads();
      HD_PHASE(3, clk);
      tile_mma_t<kBwdTileM, true>(dvs, w2s, stage, H);   // du = dv W2^T
      dw2_update(us, dvs, part, H);                     // dW2 += u^T dv
      __syncthreads();
      HD_PHASE(4, clk);

      // dpre = du * silu'(pre), pre rebuilt: column per thread
      if (col) {
        int cur = tl.row[0];
        float run = 0.0f;
        for (int t = 0; t < tl.n_valid; ++t) {
          const int i = i0 + tl.row[t], j = tl.col[t];
          const float* eij = a.e + (((size_t)b * N + i) * N + j) * E;
          float ep = 0.0f;
#pragma unroll
          for (int r = 0; r < kRegE; ++r)
            if (r < E) ep += round_bf16(eij[r]) * wreg[r];
#pragma unroll 1
          for (int r = kRegE; r < E; ++r) ep += round_bf16(eij[r]) * __bfloat162float(a.we[r * H + c]);
          const float pre = pre_act<BF16>(node[(size_t)i * 2 * H + c],
                                          node[(size_t)j * 2 * H + H + c], ep, bias1);
          const float dpre = act<BF16>(act<BF16>(stage[t * lds(H) + c]) * dsilu_act<BF16>(pre));
          us[t * ldu + c] = __float2bfloat16(dpre);
          if (tl.row[t] != cur) {
            dhs_s[cur * H + c] += run;
            run = 0.0f;
            cur = tl.row[t];
          }
          run += dpre;
          dst[(size_t)j * H + c] += dpre;
          acc_b1 += dpre;
        }
        if (tl.n_valid > 0) dhs_s[cur * H + c] += run;
        for (int k = 0; k < E; ++k) {   // dW_e += e^T dpre over the tile
          float sum = 0.0f;
          for (int t = 0; t < tl.n_valid; ++t)
            sum += round_bf16(a.e[tl.edge(t) * E + k]) * __bfloat162float(us[t * ldu + c]);
          part_we[k * H + c] += sum;
        }
      }
      __syncthreads();
      HD_PHASE(5, clk);

      // de = dpre W_e^T: warp per edge
      for (int t = warp; t < tl.n_valid; t += kWarps) {
        const bf16* drow = us + t * ldu;
        const size_t ed = tl.edge(t);
        for (int k = 0; k < E; ++k) {
          float d = 0.0f;
#pragma unroll
          for (int s = 0; s < kColsPerLane; ++s) {
            const int cc = lane + 32 * s;
            if (cc < H) d += __bfloat162float(drow[cc]) * __bfloat162float(a.we[k * H + cc]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
          if (lane == 0) a.de[ed * E + k] = d;
        }
      }
      __syncthreads();
      HD_PHASE(6, clk);
    }
    for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x) {
      const int r = idx / H, cc = idx % H;
      a.dhs[((size_t)b * N + i0 + r) * H + cc] = dhs_s[idx];
      dhs_s[idx] = 0.0f;
    }
    __syncthreads();
  }

  // this block's bias and gate partials; warps summed in a fixed order
  if (col) part_b1[c] = acc_b1;
  float* red = stage;
#pragma unroll
  for (int s = 0; s < kColsPerLane; ++s)
    if (lane + 32 * s < H) red[warp * H + lane + 32 * s] = acc_b2[s];
  __syncthreads();
  if (col) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * H + c];
    part_b2[c] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kColsPerLane; ++s)
    if (lane + 32 * s < H) red[warp * H + lane + 32 * s] = acc_att[s];
  if (lane == 0) red[kWarps * H + warp] = acc_batt;
  __syncthreads();
  if (col) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * H + c];
    part_att[c] = sum;
  }
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red[kWarps * H + w];
    part_att[H] = sum;
  }
}

template <bool BF16, bool ATT>
cudaError_t launch_gcl_bwd(const GclBwdArgs& a, int blocks, cudaStream_t stream) {
  const int smem = bwd_smem_bytes(a.H);
  cudaError_t err = cudaFuncSetAttribute(gcl_bwd_kernel<BF16, ATT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gcl_bwd_kernel<BF16, ATT><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Split of the node-level wgrad contractions (K = B*N): ~256 rows per split.
inline int wgrad_splits(int M) {
  const int s = (M + 255) / 256;
  return s < 1 ? 1 : (s > 32 ? 32 : s);
}

inline int bwd_blocks(int B, int N, int max_blocks) {
  const int items = B * ((N + kRows - 1) / kRows);
  return items < max_blocks ? items : max_blocks;
}

}  // namespace hd

// Floats of device workspace that hd_fused_gcl_bwd needs for these sizes.
extern "C" long long hd_fused_gcl_bwd_workspace(int B, int N, int H, int E, int max_blocks) {
  const long long M = (long long)B * N;
  const long long row_blocks = (N + hd::kRows - 1) / hd::kRows;
  const long long chunks = (M + hd::kColChunk - 1) / hd::kColChunk;
  long long n = 0;
  n += 3 * M * 2 * H;                   // proj, cat, dcat
  n += 8 * M * H;                       // z1, o1, g2, do1, dz1, dagg, dhs, dhdst
  n += row_blocks * M * H;              // dh_dst partials per row block
  n += (long long)hd::bwd_blocks(B, N, max_blocks) * hd::part_floats(H, E);
  n += (long long)hd::wgrad_splits((int)M) * 2 * H * H;   // split-K partials
  n += chunks * 2 * H;                  // column-sum partials
  return n + 512;                       // alignment slack of the carving
}

// Backward of hd_fused_gcl. Weight operands are the bf16 copies the forward
// uses (wsd = [W_src | W_dst], we, w2, watt, nw1) plus the transposed bf16
// copies of the backward (nw1t = Wn1^T (H x 2H), nw2t = Wn2^T, wsrct =
// W_src^T, wdstt = W_dst^T) and the f32 gate weights watt32. Outputs: dh
// (B,N,H), de (B,N,N,E) and `grads`, laid out as
//   [dW2 (H x H, in x out) | dW_e (E x H) | db1 | db2 | dw_att | db_att (1)
//    | pad to part_floats(H, E) | dW_src (H x H) | dW_dst (H x H)
//    | dWn1 (2H x H) | dbn1 | dWn2 (H x H) | dbn2].
extern "C" int hd_fused_gcl_bwd(const float* g, const float* h, const float* e,
                                const float* emask, const float* nmask, const float* agg,
                                const hd::bf16* wsd, const hd::bf16* we, const float* b1,
                                const hd::bf16* w2, const float* b2, const hd::bf16* watt,
                                const float* watt32, const float* batt, const hd::bf16* nw1,
                                const float* nb1, const hd::bf16* nw1t, const hd::bf16* nw2t,
                                const hd::bf16* wsrct, const hd::bf16* wdstt, float* ws,
                                float* dh, float* de, float* grads, int B, int N, int H, int E,
                                float norm, int attention, int bf16_act, int max_blocks,
                                void* stream) {
  using namespace hd;
  if (B * N == 0) return 0;
  if (H % 16 != 0 || H > kMaxH || E > kMaxE || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  const int row_blocks = (N + kRows - 1) / kRows;
  const int blocks = bwd_blocks(B, N, max_blocks);
  const int P = part_floats(H, E);
  const int splits = wgrad_splits(M);
  const int chunks = (M + kColChunk - 1) / kColChunk;
  // workspace carving: 256-byte aligned start, each piece a multiple of 32 bytes
  float* cur = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(ws) + 255) & ~uintptr_t(255));
  auto take = [&cur](size_t n) { float* out = cur; cur += (n + 7) / 8 * 8; return out; };
  float* proj = take((size_t)M * 2 * H);
  float* cat = take((size_t)M * 2 * H);
  float* dcat = take((size_t)M * 2 * H);
  float* z1 = take((size_t)M * H);
  float* o1 = take((size_t)M * H);
  float* g2 = take((size_t)M * H);
  float* do1 = take((size_t)M * H);
  float* dz1 = take((size_t)M * H);
  float* dagg = take((size_t)M * H);
  float* dhs = take((size_t)M * H);
  float* dhdst = take((size_t)M * H);
  float* dst_part = take((size_t)row_blocks * M * H);
  float* blk = take((size_t)blocks * P);
  float* split_part = take((size_t)splits * 2 * H * H);
  float* col_part = take((size_t)chunks * 2 * H);
  float* g_wsrc = grads + P;
  float* g_wdst = g_wsrc + (size_t)H * H;
  float* g_nw1 = g_wdst + (size_t)H * H;
  float* g_nb1 = g_nw1 + (size_t)2 * H * H;
  float* g_nw2 = g_nb1 + H;
  float* g_nb2 = g_nw2 + (size_t)H * H;
  const size_t nh = (size_t)M * H;
  cudaError_t err;
#define HD_TRY(call) do { err = (call); if (err != cudaSuccess) return (int)err; } while (0)
#define HD_LAUNCHED() HD_TRY(cudaGetLastError())

  // 1. node projections and the node-MLP backward
  HD_TRY(launch_proj(h, wsd, proj, M, H, st));
  node_prep_kernel<<<ew_blocks(nh), kEwThreads, 0, st>>>(h, agg, g, nmask, cat, g2, M, H);
  HD_LAUNCHED();
  HD_TRY(gemm<false>(cat, nw1, z1, M, H, 2 * H, 2 * H, H, H, 1, false, st));
  node_act_kernel<<<ew_blocks(nh), kEwThreads, 0, st>>>(z1, nb1, o1, M, H);
  HD_LAUNCHED();
  HD_TRY(gemm<false>(g2, nw2t, do1, M, H, H, H, H, H, 1, false, st));
  node_dz_kernel<<<ew_blocks(nh), kEwThreads, 0, st>>>(do1, z1, dz1, M, H);
  HD_LAUNCHED();
  HD_TRY(gemm<false>(dz1, nw1t, dcat, M, 2 * H, H, H, 2 * H, 2 * H, 1, false, st));
  node_split_kernel<<<ew_blocks(nh), kEwThreads, 0, st>>>(g2, dcat, dh, dagg, M, H, norm);
  HD_LAUNCHED();

  // 2. the edge backward
  HD_TRY(cudaMemsetAsync(dst_part, 0, sizeof(float) * row_blocks * nh, st));
  HD_TRY(cudaMemsetAsync(blk, 0, sizeof(float) * blocks * P, st));
  const GclBwdArgs a{e, emask, proj, we, b1, w2, b2, watt, watt32, batt, dagg,
                     dhs, dst_part, de, blk, B, N, H, E};
  if (bf16_act)
    err = attention ? launch_gcl_bwd<true, true>(a, blocks, st) : launch_gcl_bwd<true, false>(a, blocks, st);
  else
    err = attention ? launch_gcl_bwd<false, true>(a, blocks, st) : launch_gcl_bwd<false, false>(a, blocks, st);
  if (err != cudaSuccess) return (int)err;
  HD_TRY(reduce(dst_part, row_blocks, nh, nh, dhdst, st));
  HD_TRY(reduce(blk, blocks, P, P, grads, st));

  // 3. dh += dhs W_src^T + dh_dst W_dst^T
  HD_TRY(gemm<false>(dhs, wsrct, dh, M, H, H, H, H, H, 1, true, st));
  HD_TRY(gemm<false>(dhdst, wdstt, dh, M, H, H, H, H, H, 1, true, st));

  // 4. node-level weight gradients, K = B*N, split-K with a fixed-order sum
  const size_t hh = (size_t)H * H;
  HD_TRY(gemm<true>(h, dhs, split_part, H, H, M, H, H, H, splits, false, st));
  HD_TRY(reduce(split_part, splits, hh, hh, g_wsrc, st));
  HD_TRY(gemm<true>(h, dhdst, split_part, H, H, M, H, H, H, splits, false, st));
  HD_TRY(reduce(split_part, splits, hh, hh, g_wdst, st));
  HD_TRY(gemm<true>(cat, dz1, split_part, 2 * H, H, M, 2 * H, H, H, splits, false, st));
  HD_TRY(reduce(split_part, splits, 2 * hh, 2 * hh, g_nw1, st));
  HD_TRY(gemm<true>(o1, g2, split_part, H, H, M, H, H, H, splits, false, st));
  HD_TRY(reduce(split_part, splits, hh, hh, g_nw2, st));
  HD_TRY(column_sum(dz1, M, H, col_part, g_nb1, st));
  HD_TRY(column_sum(g2, M, H, col_part, g_nb2, st));
#undef HD_LAUNCHED
#undef HD_TRY
  return 0;
}
