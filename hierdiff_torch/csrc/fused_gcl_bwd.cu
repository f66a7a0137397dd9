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
// backward in f32 elementwise.
//
// What bounds it: per real edge the least work is three H x H products on
// the tensor cores (the rematerialised u W2, du = dv W2^T and dW2 += u^T dv,
// 6 H^2 bf16 FLOPs) and two sigmoids per edge-channel on the SFU; per node
// the node-MLP backward. At the GEOM layer shape of chip_smoke.py (B=64,
// N=32, H=256, E=2, ragged counts) that is ~14 GFLOP (~14 us at the bf16
// peak) and ~30 M exp+reciprocal (~7 us), against ~13 MB of device memory
// (~4 us): bound by operations. This design adds 8 bytes per real
// edge-channel written by the edge kernel and read back by the sums (u, dv
// in bf16, dpre in f32: 59 MB for 28,840 real edges at H = 256).
//
// Design. The edge kernel computes per-edge values over the real edges only
// and holds no sum across its tiles; every sum across tiles is a
// fixed-order reduction outside it, over list positions or tiles. Launches
// on the caller's stream behind one C entry point:
//   1. proj_sm90_kernel (sm90.cuh, as fused_coord.cu launches it):
//      [h W_src | h W_dst] for every node, on wgmma.
//   2. The node-MLP backward, row-parallel: z1 = [h, agg] Wn1 + bn1 is
//      rematerialised from the saved agg, then do1 = g2 Wn2^T, dz1, dcat =
//      dz1 Wn1^T, giving dh's direct part and dagg. Products run in this
//      file's own tiled WMMA GEMM (bf16 operands, f32 accumulation).
//   3. The real-edge work list (sm90.cuh: rowstart, edges; no host sync) and
//      posmap, the list position of every real edge by its flat index (-1
//      for the others).
//   4. gcl_bwd_edge_kernel: one persistent block per SM holds W2 in shared
//      memory (256 x 256 bf16, K-major, 128-byte swizzle, as fused_gcl) and
//      runs two warpgroups that walk their own 64-edge tiles of the list.
//      Per tile: the bf16 silu(pre) tile u (sm90.cuh's build), v = u W2 on
//      wgmma m64n256k16 into f32 registers while u is copied to its list
//      positions; in registers, b2, silu, the gate and their backward (row
//      dots over the 4 lanes of a quad) to dv, which replaces u in the
//      warpgroup's buffer; du = dv W2^T on wgmma through a transposed
//      (MN-major) descriptor of the same resident W2 (W2's K-major atom is,
//      byte for byte, an MN-major atom of W2^T: no second copy) while dv is
//      copied out (in two halves of 128 columns, m64n128k16, so that 64
//      accumulators a thread leave registers for what follows); dpre =
//      du silu'(pre) with pre rebuilt in registers, written at its list
//      position; de = dpre W_e^T (row dots over the quad); and the tile's
//      own column sums in a fixed order (a butterfly
//      over each warp's rows, then the 4 warps in order): of e^T dpre and
//      dpre (dW_e, db1), of dv, m0 dza and dza (db2, dw_att, db_att), f32
//      where the Pallas kernel sums f32 values. The workspace holds B*N*N
//      positions and tiles, so the host needs no count.
//   5. Reductions, each in a fixed order: dW2 = U^T dV as a split-K GEMM
//      whose split bounds are fixed by B*N*N (splits past the real edges
//      sum nothing and are not read), partials summed in split order; dW_e, db1, db2,
//      dw_att, db_att over the tiles in order (in fixed chunks of tiles,
//      the chunks in order); dhs[b,i] = the sum of dpre over row i's list
//      segment, in list order; dh_dst[b,j] = the sum over i = 0 .. N-1 of
//      dpre at posmap[b,i,j]. No float atomics anywhere: two runs on the
//      same inputs give bitwise equal gradients.
//   6. dh += dhs W_src^T + dh_dst W_dst^T, and the node-level wgrads (W_src,
//      W_dst, Wn1, Wn2: K = B*N) as split-K GEMMs with a fixed-order sum.
#include "sm90.cuh"

namespace hd {

constexpr int kBwdSplits = 128;      // splits of the dW2 GEMM over list positions
constexpr int kGemmTile = 64;        // output tile of the generic GEMM
constexpr int kGemmK = 32;
constexpr int kGemmThreads = 128;
constexpr int kEwThreads = 256;      // elementwise kernels
constexpr int kColChunk = 64;        // rows per partial column sum

// ---------------------------------------------------------------------------
// Generic GEMM: C[z] (+)= op(A)[:, K_z] @ B[K_z, :], bf16 operands, f32
// accumulation. op(A)[m][k] = TA ? A[k * lda + m] : A[m * lda + k] (A f32 or
// bf16); B[k][n] = Bm[k * ldb + n] (f32 or bf16). Split z covers K rows
// [z * k_chunk, (z + 1) * k_chunk) and writes C + z * split_stride. With
// k_dev, K is read from the device (*k_dev): splits past it write zeros.
// Global memory is read in 16-byte vectors (A, Bm, lda, ldb and k_chunk
// aligned to them), a k-step's loads issued while the step before is on the
// tensor cores.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// The 16-byte vector of T at p + i, i < n; elements past n are zero.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int n) {
  constexpr int V = 16 / sizeof(T);
  if (n >= V) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&r);
  for (int i = 0; i < n; ++i) e[i] = p[i];
  return r;
}

template <bool TA, typename TAe, typename TB>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const TAe* __restrict__ A, const TB* __restrict__ Bm, float* __restrict__ C,
            int M, int Nc, int K, int lda, int ldb, int ldc, int k_chunk, size_t split_stride,
            int accumulate, const int* __restrict__ k_dev) {
  constexpr int VA = 16 / sizeof(TAe), VB = 16 / sizeof(TB);      // elements per vector
  constexpr int kAV = kGemmTile * kGemmK / VA / kGemmThreads;       // vectors per thread and k-step
  constexpr int kBV = kGemmK * kGemmTile / VB / kGemmThreads;
  __shared__ __align__(128) bf16 as[kGemmTile][kGemmK + 8];
  __shared__ __align__(128) bf16 bs[kGemmK][kGemmTile + 8];
  __shared__ __align__(128) float cs[kGemmTile][kGemmTile + 4];
  if (k_dev != nullptr) K = *k_dev;
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

  // vector v of the A tile: TA, k-row v / (64 / VA) and VA rows of op(A)
  // from m = VA * (v % (64 / VA)); otherwise row v / (32 / VA) and VA k's.
  // Vector v of the B tile: k-row v / (64 / VB), VB columns.
  uint4 ra[kAV], rb[kBV];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      if (TA) {
        const int gk = k0 + v / (kGemmTile / VA), gm = row0 + VA * (v % (kGemmTile / VA));
        ra[i] = load_vec(A + (size_t)gk * lda + gm, gk < ke ? min(VA, M - gm) : 0);
      } else {
        const int gm = row0 + v / (kGemmK / VA), gk = k0 + VA * (v % (kGemmK / VA));
        ra[i] = load_vec(A + (size_t)gm * lda + gk, gm < M ? min(VA, ke - gk) : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kBV; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const int gk = k0 + v / (kGemmTile / VB), gc = col0 + VB * (v % (kGemmTile / VB));
      rb[i] = load_vec(Bm + (size_t)gk * ldb + gc, gk < ke ? min(VB, Nc - gc) : 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kAV; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const TAe* e = reinterpret_cast<const TAe*>(&ra[i]);
      if (TA) {
        const int k = v / (kGemmTile / VA), m = VA * (v % (kGemmTile / VA));
#pragma unroll
        for (int j = 0; j < VA; ++j) as[m + j][k] = to_bf16(e[j]);
      } else {
        const int m = v / (kGemmK / VA), k = VA * (v % (kGemmK / VA));
#pragma unroll
        for (int j = 0; j < VA; ++j) as[m][k + j] = to_bf16(e[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBV; ++i) {
      const int v = threadIdx.x + i * kGemmThreads;
      const TB* e = reinterpret_cast<const TB*>(&rb[i]);
      const int k = v / (kGemmTile / VB), c = VB * (v % (kGemmTile / VB));
#pragma unroll
      for (int j = 0; j < VB; ++j) bs[k][c + j] = to_bf16(e[j]);
    }
  };

  if (kb < ke) load(kb);
  for (int k0 = kb; k0 < ke; k0 += kGemmK) {
    store();
    __syncthreads();
    if (k0 + kGemmK < ke) load(k0 + kGemmK);   // in flight during this step's products
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

// Rows of K per split: ceil(K / splits), rounded up to whole k-steps (so
// every split starts on a 16-byte vector).
inline int split_rows(int K, int splits) {
  const int rows = (K + splits - 1) / splits;
  return (rows + kGemmK - 1) / kGemmK * kGemmK;
}

template <bool TA, typename TAe, typename TB>
cudaError_t gemm(const TAe* A, const TB* Bm, float* C, int M, int Nc, int K, int lda, int ldb,
                 int ldc, int splits, bool accumulate, cudaStream_t st, const int* k_dev = nullptr) {
  const dim3 grid((M + kGemmTile - 1) / kGemmTile, (Nc + kGemmTile - 1) / kGemmTile, splits);
  gemm_kernel<TA, TAe, TB><<<grid, kGemmThreads, 0, st>>>(A, Bm, C, M, Nc, K, lda, ldb, ldc,
                                                          split_rows(K, splits), (size_t)M * ldc,
                                                          accumulate ? 1 : 0, k_dev);
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

// parts[chunk][c] = sum of x[r][c] over the chunk's rows, in row order. With
// count, rows = ceil(*count / per_row) (a device-held count: rows past it are
// not summed, so they need not be written).
__global__ void colsum_kernel(const float* __restrict__ x, int rows, int cols,
                              float* __restrict__ parts, const int* __restrict__ count, int per_row) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  if (count != nullptr) rows = (*count + per_row - 1) / per_row;
  const int r0 = blockIdx.y * kColChunk, r1 = min(rows, r0 + kColChunk);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += x[(size_t)r * cols + c];
  parts[(size_t)blockIdx.y * cols + c] = s;
}

// out[i] = sum over z = 0, 1, ... of parts[z * stride + i]; with count_dev,
// z only up to ceil(*count_dev / per) (the parts past it hold zeros).
__global__ void reduce_kernel(const float* __restrict__ parts, int count, size_t stride,
                              size_t size, float* __restrict__ out, const int* __restrict__ count_dev,
                              int per) {
  if (count_dev != nullptr) count = min(count, (*count_dev + per - 1) / per);
  HD_GRID_STRIDE(i, size) {
    float s = 0.0f;
    for (int z = 0; z < count; ++z) s += parts[z * stride + i];
    out[i] = s;
  }
}

cudaError_t reduce(const float* parts, int count, size_t stride, size_t size, float* out,
                   cudaStream_t st, const int* count_dev = nullptr, int per = 1) {
  reduce_kernel<<<ew_blocks(size), kEwThreads, 0, st>>>(parts, count, stride, size, out, count_dev, per);
  return cudaGetLastError();
}

inline int col_chunks(int rows) { return (rows + kColChunk - 1) / kColChunk; }

// out[c] = sum_r x[r][c], via fixed row chunks and a fixed-order sum; with
// count, only the first ceil(*count / per_row) of the rows (at most rows).
cudaError_t column_sum(const float* x, int rows, int cols, float* parts, float* out,
                       cudaStream_t st, const int* count = nullptr, int per_row = 1) {
  colsum_kernel<<<dim3((cols + kEwThreads - 1) / kEwThreads, col_chunks(rows)), kEwThreads, 0, st>>>(
      x, rows, cols, parts, count, per_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(parts, col_chunks(rows), cols, cols, out, st);
}

// ---------------------------------------------------------------------------
// The edge backward
// ---------------------------------------------------------------------------

// Floats per tile of the edge kernel's own sums, in the gradient buffer's
// order: dW_e (E x H), db1, db2, dw_att (H each), db_att.
__host__ __device__ inline int tile_part_floats(int H, int E) { return (E + 3) * H + 1; }

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
  const int* rowstart;   // work list (sm90.cuh)
  const int* edges;
  bf16* u;               // (positions, H): silu(pre), dW2's left operand
  bf16* dv;              // (positions, H): the gradient at v, dW2's right operand
  float* dpre;           // (positions, H): the gradient at pre
  float* de;             // (B,N,N,E): zero but at real edges
  float* tile_part;      // (tiles, tile_part_floats): the tile's sums
  int B, N, H, E;
};

// Per-column constants of the edge kernel, in shared memory.
struct BwdConsts {
  float b2[kMaxH];         // b2 in the act dtype
  float watt[kMaxH];       // bf16 gate weights (the forward's dot)
  float watt_act[kMaxH];   // f32 gate weights in the act dtype (the dm0 term)
  float b1[kMaxH];         // b1 in the act dtype (pre rebuilt)
  float we[kRegE][kMaxH];  // the first kRegE rows of W_e (bf16 values)
};

// Per warpgroup: two per-column sums staged per warp, and the warps' db_att.
constexpr int kRedFloats = 2 * 4 * kMaxH + 4;

__host__ __device__ constexpr int bwd_edge_smem_bytes() {
  return 1024 + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes + kRedFloats * 4) + (int)sizeof(BwdConsts);
}

// Rows 0 .. nv-1 of the warpgroup's 64 x 256 bf16 tile (K-major, 128-byte
// swizzle) to rows p0 .. of dst (row-major, H columns), 16 bytes a thread.
__device__ __forceinline__ void copy_tile_out(const bf16* tile, bf16* dst, int p0, int nv, int H, int tid) {
  for (int idx = tid; idx < kTileM * (kMaxH / 8); idx += 128) {
    const int r = idx / (kMaxH / 8), c0 = 8 * (idx % (kMaxH / 8));
    if (r < nv && c0 < H)
      *reinterpret_cast<uint4*>(dst + (size_t)(p0 + r) * H + c0) =
          *reinterpret_cast<const uint4*>(tile + sw128_offset(r, c0, kTileM));
  }
}

// One column pair's sum over the tile's rows, first step: (x0, x1) holds the
// thread's rows ra + rb for columns 8j + 2 (lane % 4) + {0, 1}; a butterfly
// over lane / 4 adds the warp's 16 rows, and lanes 0-3 stage the result for
// their warp. Then flush_colsum adds the 4 warps in order.
__device__ __forceinline__ void warp_colsum(float* red_q, int j, float x0, float x1) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    x0 += __shfl_xor_sync(0xffffffffu, x0, off);
    x1 += __shfl_xor_sync(0xffffffffu, x1, off);
  }
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  if (lane < 4) *reinterpret_cast<float2*>(red_q + warp * kMaxH + 8 * j + 2 * lane) = make_float2(x0, x1);
}

__device__ __forceinline__ void flush_colsum(const float* red_q, float* out, int H) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = 2 * tid + i;
    if (c < H) out[c] = ((red_q[c] + red_q[kMaxH + c]) + red_q[2 * kMaxH + c]) + red_q[3 * kMaxH + c];
  }
}

// The edge backward: one block per SM holds W2 in shared memory (K-major,
// 128-byte swizzle) and runs two warpgroups that walk their own 64-edge
// tiles of the work list. A thread holds the rows ra, rb of the tile and 64
// columns of each (wgmma's accumulator layout) through every step.
template <bool BF16, bool ATT>
__global__ void __launch_bounds__(kEdgeThreads, 1) gcl_bwd_edge_kernel(GclBwdArgs a) {
  const int H = a.H, N = a.N, E = a.E;
  const int n_edges = a.rowstart[a.B * N];
  const int n_tiles = (n_edges + kTileM - 1) / kTileM;
  if (blockIdx.x * kEdgeWGs >= n_tiles) return;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);   // swizzle atoms on 1 KB
  bf16* w2s = reinterpret_cast<bf16*>(smem);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  bf16* u = reinterpret_cast<bf16*>(smem + kW2Bytes + wg * kUBytes);   // u, then dv
  TileMeta& tm = *reinterpret_cast<TileMeta*>(smem + kW2Bytes + kEdgeWGs * kUBytes + wg * kMetaBytes);
  float* red = reinterpret_cast<float*>(smem + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes)) + wg * kRedFloats;
  BwdConsts& cst = *reinterpret_cast<BwdConsts*>(smem + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes) +
                                                 kEdgeWGs * kRedFloats * 4);

  HD_PHASE_START(clk);
  load_w2_sw128(a.w2, w2s, H);
  for (int c = threadIdx.x; c < kMaxH; c += blockDim.x) {
    const bool in = c < H;
    cst.b2[c] = in ? act<BF16>(a.b2[c]) : 0.0f;
    cst.watt[c] = ATT && in ? __bfloat162float(a.watt[c]) : 0.0f;
    cst.watt_act[c] = ATT && in ? act<BF16>(a.watt32[c]) : 0.0f;
    cst.b1[c] = in ? act<BF16>(a.b1[c]) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRegE; ++r) cst.we[r][c] = in && r < E ? __bfloat162float(a.we[r * H + c]) : 0.0f;
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
    const int p0 = tile * kTileM, nv = min(kTileM, n_edges - p0);
    if (tid < kTileM) {
      tm.row[tid] = pf.q >= 0 ? pf.q / N : -1;
      tm.col[tid] = pf.q >= 0 ? pf.q % N : 0;
      tm.emask[tid] = pf.emask;
      if (tid == 0) HD_COUNT_EDGES(kTileM, nv);
    }
    wg_barrier(bar);
    HD_WG_PHASE(0, clk);
    build_tile<BF16>(tm, nv, a, u);
    pf = fetch_meta(a, tile + stride, n_edges, tid);   // in flight during this tile
    fence_proxy_async();
    wg_barrier(bar);
    HD_WG_PHASE(1, clk);

    // v = u W2 (wgmma), u to its list positions meanwhile
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
    copy_tile_out(u, a.u, p0, nv, H, tid);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(d[i]);
    wg_barrier(bar);   // u copied out by every thread: its buffer takes dv
    HD_WG_PHASE(2, clk);

    // back through silu, the gate and the mask to dv, in registers
    const int row_a = tm.row[ra], row_b = tm.row[rb];
    const float em_a = tm.emask[ra], em_b = tm.emask[rb];
    const float* dg_a = a.dagg + (size_t)(row_a < 0 ? 0 : row_a) * H;
    const float* dg_b = a.dagg + (size_t)(row_b < 0 ? 0 : row_b) * H;
    float att_a = 1.0f, att_b = 1.0f, dza_a = 0.0f, dza_b = 0.0f;
    if (ATT) {   // the gate and datt: row dots over the 4 lanes of a quad
      float dot_a = 0.0f, dot_b = 0.0f, dd_a = 0.0f, dd_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const bool in = c < H;
        const float2 bb = *reinterpret_cast<const float2*>(cst.b2 + c);
        const float2 ww = *reinterpret_cast<const float2*>(cst.watt + c);
        const float2 ga = in && row_a >= 0 ? *reinterpret_cast<const float2*>(dg_a + c) : make_float2(0.f, 0.f);
        const float2 gb = in && row_b >= 0 ? *reinterpret_cast<const float2*>(dg_b + c) : make_float2(0.f, 0.f);
        d[4 * j] = act<BF16>(act<BF16>(d[4 * j]) + bb.x);
        d[4 * j + 1] = act<BF16>(act<BF16>(d[4 * j + 1]) + bb.y);
        d[4 * j + 2] = act<BF16>(act<BF16>(d[4 * j + 2]) + bb.x);
        d[4 * j + 3] = act<BF16>(act<BF16>(d[4 * j + 3]) + bb.y);
        const float m00 = silu_act<BF16>(d[4 * j]), m01 = silu_act<BF16>(d[4 * j + 1]);
        const float m10 = silu_act<BF16>(d[4 * j + 2]), m11 = silu_act<BF16>(d[4 * j + 3]);
        dot_a += round_bf16(m00) * ww.x + round_bf16(m01) * ww.y;
        dot_b += round_bf16(m10) * ww.x + round_bf16(m11) * ww.y;
        dd_a += act<BF16>(act<BF16>(act<BF16>(ga.x) * em_a) * m00) + act<BF16>(act<BF16>(act<BF16>(ga.y) * em_a) * m01);
        dd_b += act<BF16>(act<BF16>(act<BF16>(gb.x) * em_b) * m10) + act<BF16>(act<BF16>(act<BF16>(gb.y) * em_b) * m11);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dot_a += __shfl_xor_sync(0xffffffffu, dot_a, off);
        dot_b += __shfl_xor_sync(0xffffffffu, dot_b, off);
        dd_a += __shfl_xor_sync(0xffffffffu, dd_a, off);
        dd_b += __shfl_xor_sync(0xffffffffu, dd_b, off);
      }
      att_a = sigmoid_act<BF16>(act<BF16>(act<BF16>(dot_a) + batt));
      att_b = sigmoid_act<BF16>(act<BF16>(act<BF16>(dot_b) + batt));
      dza_a = act<BF16>(act<BF16>(act<BF16>(dd_a) * att_a) * act<BF16>(1.0f - att_a));
      dza_b = act<BF16>(act<BF16>(act<BF16>(dd_b) * att_b) * act<BF16>(1.0f - att_b));
    }
    float* red_b2 = red;                 // per warp: the tile's column sums of dv
    float* red_att = red + 4 * kMaxH;    // and of m0 dza
    const float dzb_a = round_bf16(dza_a), dzb_b = round_bf16(dza_b);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const bool in = c < H;
      const float2 bb = *reinterpret_cast<const float2*>(cst.b2 + c);
      const float2 wa = *reinterpret_cast<const float2*>(cst.watt_act + c);
      const float2 ga = in && row_a >= 0 ? *reinterpret_cast<const float2*>(dg_a + c) : make_float2(0.f, 0.f);
      const float2 gb = in && row_b >= 0 ? *reinterpret_cast<const float2*>(dg_b + c) : make_float2(0.f, 0.f);
      const float g4[4] = {ga.x, ga.y, gb.x, gb.y};
      const float b4[2] = {bb.x, bb.y}, w4[2] = {wa.x, wa.y};
      float m4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool row_a_half = i < 2;
        const float v = ATT ? d[4 * j + i] : act<BF16>(act<BF16>(d[4 * j + i]) + b4[i % 2]);
        const float sg = sigmoid_act<BF16>(v);
        m4[i] = act<BF16>(v * sg);   // silu(v)
        const float dsv = act<BF16>(sg * act<BF16>(1.0f + act<BF16>(v * act<BF16>(1.0f - sg))));
        const float dm1 = act<BF16>(act<BF16>(g4[i]) * (row_a_half ? em_a : em_b));
        const float dm0 = ATT ? act<BF16>(act<BF16>(dm1 * (row_a_half ? att_a : att_b)) +
                                          act<BF16>((row_a_half ? dza_a : dza_b) * w4[i % 2]))
                              : dm1;
        d[4 * j + i] = act<BF16>(dm0 * dsv);
      }
      warp_colsum(red_b2, j, d[4 * j] + d[4 * j + 2], d[4 * j + 1] + d[4 * j + 3]);
      if (ATT)
        warp_colsum(red_att, j, round_bf16(m4[0]) * dzb_a + round_bf16(m4[2]) * dzb_b,
                    round_bf16(m4[1]) * dzb_a + round_bf16(m4[3]) * dzb_b);
      *reinterpret_cast<__nv_bfloat162*>(u + sw128_offset(ra, c, kTileM)) =
          __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(u + sw128_offset(rb, c, kTileM)) =
          __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
    if (ATT) {   // db_att: the rows' dza, quad lane 0's copy
      float z = lane % 4 == 0 ? dza_a + dza_b : 0.0f;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
      if (lane == 0) red[8 * kMaxH + warp] = z;
    }
    fence_proxy_async();   // dv in u's buffer, for wgmma's reads
    wg_barrier(bar);
    HD_WG_PHASE(3, clk);

    // du = dv W2^T, through a transposed descriptor of the same resident W2,
    // and everything after it, in two halves of 128 columns: 64 accumulators
    // a thread leave registers for the loads of the rebuild. The tile's
    // sums and dv go to their places during the first half's product.
    float* out = a.tile_part + (size_t)tile * tile_part_floats(H, E);
    const int col_a = tm.col[ra], col_b = tm.col[rb];
    const size_t q_a = row_a >= 0 ? (size_t)row_a * N + col_a : 0;
    const size_t q_b = row_b >= 0 ? (size_t)row_b * N + col_b : 0;
    const float* hs_a = a.proj + (size_t)(row_a < 0 ? 0 : row_a) * 2 * H;
    const float* hs_b = a.proj + (size_t)(row_b < 0 ? 0 : row_b) * 2 * H;
    const float* hd_a = a.proj + ((size_t)(row_a < 0 ? 0 : row_a) / N * N + col_a) * 2 * H + H;
    const float* hd_b = a.proj + ((size_t)(row_b < 0 ? 0 : row_b) / N * N + col_b) * 2 * H + H;
    float ev_a[kRegE], ev_b[kRegE];
#pragma unroll
    for (int r = 0; r < kRegE; ++r) {
      ev_a[r] = row_a >= 0 && r < E ? round_bf16(a.e[q_a * E + r]) : 0.0f;
      ev_b[r] = row_b >= 0 && r < E ? round_bf16(a.e[q_b * E + r]) : 0.0f;
    }
    float* dpre_a = a.dpre + (size_t)(p0 + ra) * H;
    float* dpre_b = a.dpre + (size_t)(p0 + rb) * H;
    for (int half = 0; half < 2; ++half) {
      const int c0 = 128 * half;
      float d2[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d2[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(d2[i]);
      wgmma_fence();
      for (int s = 0; s < H / 16; ++s)
        wgmma_m64n128k16<1>(d2, sw128_desc(u + sw128_offset(0, 16 * s, kTileM)),
                            sw128_desc_mn(w2s + sw128_offset(16 * s, c0, kMaxH)));
      wgmma_commit();
      if (half == 0) {
        flush_colsum(red_b2, out + (E + 1) * H, H);
        if (ATT) {
          flush_colsum(red_att, out + (E + 2) * H, H);
        } else {
          for (int c = tid; c < H; c += 128) out[(E + 2) * H + c] = 0.0f;
        }
        if (tid == 0)
          out[(E + 3) * H] = ATT ? ((red[8 * kMaxH] + red[8 * kMaxH + 1]) + red[8 * kMaxH + 2]) + red[8 * kMaxH + 3]
                                 : 0.0f;
        copy_tile_out(u, a.dv, p0, nv, H, tid);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(d2[i]);
      if (half == 0) wg_barrier(bar);   // the sums read out of red
      HD_WG_PHASE(4, clk);

      // dpre = du * silu'(pre), pre rebuilt in registers, to its list position
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j + 2 * (lane % 4);
        const bool in = c < H;
        const float2 sa = in && row_a >= 0 ? *reinterpret_cast<const float2*>(hs_a + c) : make_float2(0.f, 0.f);
        const float2 sb = in && row_b >= 0 ? *reinterpret_cast<const float2*>(hs_b + c) : make_float2(0.f, 0.f);
        const float2 ta = in && row_a >= 0 ? *reinterpret_cast<const float2*>(hd_a + c) : make_float2(0.f, 0.f);
        const float2 tb = in && row_b >= 0 ? *reinterpret_cast<const float2*>(hd_b + c) : make_float2(0.f, 0.f);
        const float2 bias = *reinterpret_cast<const float2*>(cst.b1 + c);
        float ep[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < kRegE; ++r) {
          const float2 w = *reinterpret_cast<const float2*>(cst.we[r] + c);
          ep[0] += ev_a[r] * w.x;
          ep[1] += ev_a[r] * w.y;
          ep[2] += ev_b[r] * w.x;
          ep[3] += ev_b[r] * w.y;
        }
        if (E > kRegE && in) {   // wide E (sinusoid embedding): the rest from L1
          for (int r = kRegE; r < E; ++r) {
            const float ea = row_a >= 0 ? round_bf16(a.e[q_a * E + r]) : 0.0f;
            const float eb = row_b >= 0 ? round_bf16(a.e[q_b * E + r]) : 0.0f;
            const float w0 = __bfloat162float(a.we[r * H + c]), w1 = __bfloat162float(a.we[r * H + c + 1]);
            ep[0] += ea * w0;
            ep[1] += ea * w1;
            ep[2] += eb * w0;
            ep[3] += eb * w1;
          }
        }
        const float hs4[4] = {sa.x, sa.y, sb.x, sb.y}, hd4[4] = {ta.x, ta.y, tb.x, tb.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pre = pre_act<BF16>(hs4[i], hd4[i], ep[i], i % 2 ? bias.y : bias.x);
          d2[4 * j + i] = act<BF16>(act<BF16>(d2[4 * j + i]) * dsilu_act<BF16>(pre));
        }
        if (in && ra < nv) *reinterpret_cast<float2*>(dpre_a + c) = make_float2(d2[4 * j], d2[4 * j + 1]);
        if (in && rb < nv) *reinterpret_cast<float2*>(dpre_b + c) = make_float2(d2[4 * j + 2], d2[4 * j + 3]);
      }
      HD_WG_PHASE(5, clk);

      // the half's tile sums of dpre (db1) and of bf16(e) bf16(dpre) (dW_e
      // rows), two at a time; de = dpre W_e^T, a row dot over each quad,
      // written by the first half and completed by the second
      for (int q0 = 0; q0 <= E; q0 += 2) {
#pragma unroll
        for (int qi = 0; qi < 2; ++qi) {
          const int qn = q0 + qi;   // 0: db1, 1 + k: row k of dW_e
          if (qn > E) break;
          const float ea = qn == 0 || row_a < 0 ? 0.0f : round_bf16(a.e[q_a * E + qn - 1]);
          const float eb = qn == 0 || row_b < 0 ? 0.0f : round_bf16(a.e[q_b * E + qn - 1]);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float x0 = qn == 0 ? d2[4 * j] + d2[4 * j + 2]
                                     : ea * round_bf16(d2[4 * j]) + eb * round_bf16(d2[4 * j + 2]);
            const float x1 = qn == 0 ? d2[4 * j + 1] + d2[4 * j + 3]
                                     : ea * round_bf16(d2[4 * j + 1]) + eb * round_bf16(d2[4 * j + 3]);
            warp_colsum(red + qi * 4 * kMaxH, 16 * half + j, x0, x1);
          }
        }
        wg_barrier(bar);
#pragma unroll
        for (int qi = 0; qi < 2; ++qi) {
          const int qn = q0 + qi;
          const int c = c0 + tid;
          if (qn <= E && c < H) {
            const float* red_q = red + qi * 4 * kMaxH;
            out[(qn == 0 ? E : qn - 1) * H + c] =
                ((red_q[c] + red_q[kMaxH + c]) + red_q[2 * kMaxH + c]) + red_q[3 * kMaxH + c];
          }
        }
        wg_barrier(bar);
      }
      for (int k = 0; k < E; ++k) {
        float s_a = 0.0f, s_b = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c0 + 8 * j + 2 * (lane % 4);
          float w0, w1;
          if (k < kRegE) {
            const float2 w = *reinterpret_cast<const float2*>(cst.we[k] + c);
            w0 = w.x;
            w1 = w.y;
          } else {
            w0 = c < H ? __bfloat162float(a.we[k * H + c]) : 0.0f;
            w1 = c < H ? __bfloat162float(a.we[k * H + c + 1]) : 0.0f;
          }
          s_a += round_bf16(d2[4 * j]) * w0 + round_bf16(d2[4 * j + 1]) * w1;
          s_b += round_bf16(d2[4 * j + 2]) * w0 + round_bf16(d2[4 * j + 3]) * w1;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
          s_b += __shfl_xor_sync(0xffffffffu, s_b, off);
        }
        if (lane % 4 == 0) {   // the thread that wrote the first half reads it back
          if (row_a >= 0) a.de[q_a * E + k] = half ? a.de[q_a * E + k] + s_a : s_a;
          if (row_b >= 0) a.de[q_b * E + k] = half ? a.de[q_b * E + k] + s_b : s_b;
        }
      }
      HD_WG_PHASE(6, clk);
    }
  }
}

// posmap[edges[p]] = p for every real edge p (posmap is -1 elsewhere).
__global__ void posmap_kernel(const int* __restrict__ edges, const int* __restrict__ n_edges,
                              int* __restrict__ posmap, size_t bound) {
  const size_t n = (size_t)*n_edges;
  HD_GRID_STRIDE(pos, bound < n ? bound : n) posmap[edges[pos]] = (int)pos;
}

// Per node r = b * N + n, column c: dhs[r] = sum of dpre over row r's list
// segment in list order; dh_dst[r] = sum over i = 0 .. N-1 of dpre at
// posmap[b, i, n] (real edges only), in i order. Loads go in batches.
constexpr int kSumBatch = 8;

__global__ void node_edge_sums_kernel(const float* __restrict__ dpre, const int* __restrict__ rowstart,
                                      const int* __restrict__ posmap, float* __restrict__ dhs,
                                      float* __restrict__ dhdst, int N, int H) {
  const int r = blockIdx.x, c = threadIdx.x;
  if (c >= H) return;
  const int p0 = rowstart[r], p1 = rowstart[r + 1];
  float s = 0.0f;
  for (int pb = p0; pb < p1; pb += kSumBatch) {
    float v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) v[k] = pb + k < p1 ? dpre[(size_t)(pb + k) * H + c] : 0.0f;
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k)
      if (pb + k < p1) s += v[k];
  }
  dhs[(size_t)r * H + c] = s;
  const int* pm = posmap + (size_t)(r / N) * N * N + r % N;   // pm[i * N] = posmap[b, i, n]
  float t = 0.0f;
  for (int ib = 0; ib < N; ib += kSumBatch) {
    int q[kSumBatch];
    float v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) q[k] = ib + k < N ? pm[(size_t)(ib + k) * N] : -1;
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k) v[k] = q[k] >= 0 ? dpre[(size_t)q[k] * H + c] : 0.0f;
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k)
      if (q[k] >= 0) t += v[k];
  }
  dhdst[(size_t)r * H + c] = t;
}

template <bool BF16, bool ATT>
cudaError_t launch_bwd_edges(const GclBwdArgs& a, long long tiles, int max_blocks,
                             std::atomic<uint64_t>& smem_set, cudaStream_t stream) {
  const int smem = bwd_edge_smem_bytes();
  cudaError_t err = smem_limit_once((const void*)gcl_bwd_edge_kernel<BF16, ATT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long want = (tiles + kEdgeWGs - 1) / kEdgeWGs;
  gcl_bwd_edge_kernel<BF16, ATT><<<(int)(want < max_blocks ? want : max_blocks), kEdgeThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Split of the node-level wgrad contractions (K = B*N): ~256 rows per split.
inline int wgrad_splits(int M) {
  const int s = (M + 255) / 256;
  return s < 1 ? 1 : (s > 32 ? 32 : s);
}

// The fixed plan of the edge reductions: a pure function of (B, N). List
// positions and tiles are bounded by the dense B*N*N edges.
struct BwdPlan {
  long long positions, tiles, tile_chunks;
  __host__ BwdPlan(int B, int N) {
    positions = (long long)B * N * N;
    tiles = (positions + kTileM - 1) / kTileM;
    tile_chunks = (tiles + kColChunk - 1) / kColChunk;
  }
};

// Workspace pieces in carving order, in floats, each rounded up to
// kWsAlign floats (256 bytes); the start is aligned to 256 bytes too.
constexpr long long kWsAlign = 64;
inline long long ws_round(long long n) { return (n + kWsAlign - 1) / kWsAlign * kWsAlign; }

inline long long bwd_workspace_floats(int B, int N, int H, int E) {
  const long long M = (long long)B * N;
  const BwdPlan plan(B, N);
  const long long pieces[] = {
      M * 2 * H, M * 2 * H, M * 2 * H,                 // proj, cat, dcat
      M * H, M * H, M * H, M * H, M * H, M * H, M * H, M * H,   // z1 o1 g2 do1 dz1 dagg dhs dhdst
      plan.positions * H / 2, plan.positions * H / 2,  // u, dv (bf16)
      plan.positions * H,                              // dpre
      plan.positions,                                  // posmap (int)
      M + 1, list_blocks((int)M), plan.positions,      // rowstart, totals, edges (int)
      plan.tiles * tile_part_floats(H, E),             // tile_part
      plan.tile_chunks * tile_part_floats(H, E),       // their chunk sums
      // split-K partials: dW2's, then the node-level wgrads' (one buffer)
      (long long)kBwdSplits * H * H > (long long)wgrad_splits((int)M) * 2 * H * H
          ? (long long)kBwdSplits * H * H : (long long)wgrad_splits((int)M) * 2 * H * H,
      (long long)col_chunks((int)M) * 2 * H,           // column-sum partials
  };
  long long n = kWsAlign;   // alignment slack of the start
  for (long long piece : pieces) n += ws_round(piece);
  return n;
}

}  // namespace hd

// Floats of device workspace that hd_fused_gcl_bwd needs for these sizes.
extern "C" long long hd_fused_gcl_bwd_workspace(int B, int N, int H, int E) {
  return hd::bwd_workspace_floats(B, N, H, E);
}

// Backward of hd_fused_gcl. Weight operands are the bf16 copies the forward
// uses (we, w2, watt, nw1; nw1t = Wn1^T (H x 2H), nw2t = Wn2^T, wsrct =
// W_src^T, wdstt = W_dst^T) and the f32 gate weights watt32. h must be
// 16-byte aligned (the GEMMs read it in vectors). ws holds
// hd_fused_gcl_bwd_workspace(B, N, H, E) floats. Outputs: dh (B,N,H), de
// (B,N,N,E) and `grads`, laid out as
//   [dW2 (H x H, in x out) | dW_e (E x H) | db1 | db2 | dw_att | db_att (1)
//    | pad to a multiple of 8 floats | dW_src (H x H) | dW_dst (H x H)
//    | dWn1 (2H x H) | dbn1 | dWn2 (H x H) | dbn2].
extern "C" int hd_fused_gcl_bwd(const float* g, const float* h, const float* e,
                                const float* emask, const float* nmask, const float* agg,
                                const hd::bf16* we, const float* b1,
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
  const BwdPlan plan(B, N);
  const int splits = wgrad_splits(M);
  // workspace carving, in bwd_workspace_floats' order
  float* cur = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(ws) + 255) & ~uintptr_t(255));
  auto take = [&cur](long long n) { float* out = cur; cur += ws_round(n); return out; };
  float* proj = take((long long)M * 2 * H);
  float* cat = take((long long)M * 2 * H);
  float* dcat = take((long long)M * 2 * H);
  float* z1 = take((long long)M * H);
  float* o1 = take((long long)M * H);
  float* g2 = take((long long)M * H);
  float* do1 = take((long long)M * H);
  float* dz1 = take((long long)M * H);
  float* dagg = take((long long)M * H);
  float* dhs = take((long long)M * H);
  float* dhdst = take((long long)M * H);
  bf16* u = reinterpret_cast<bf16*>(take(plan.positions * H / 2));
  bf16* dv = reinterpret_cast<bf16*>(take(plan.positions * H / 2));
  float* dpre = take(plan.positions * H);
  int* posmap = reinterpret_cast<int*>(take(plan.positions));
  int* rowstart = reinterpret_cast<int*>(take(M + 1));
  int* totals = reinterpret_cast<int*>(take(list_blocks(M)));
  int* edges = reinterpret_cast<int*>(take(plan.positions));
  float* tile_part = take(plan.tiles * tile_part_floats(H, E));
  float* tile_chunk_part = take(plan.tile_chunks * tile_part_floats(H, E));
  float* split_part = cur;   // the rest: split-K partials, then column-sum partials
  float* col_part = split_part + ws_round((long long)kBwdSplits * H * H > (long long)splits * 2 * H * H
                                              ? (long long)kBwdSplits * H * H
                                              : (long long)splits * 2 * H * H);
  const int* n_edges = rowstart + M;
  float* g_w2 = grads;
  float* g_we = g_w2 + (size_t)H * H;   // dW_e, db1, db2, dw_att, db_att: the tile sums' layout
  float* g_wsrc = grads + (H * H + E * H + 3 * H + 1 + 7) / 8 * 8;
  float* g_wdst = g_wsrc + (size_t)H * H;
  float* g_nw1 = g_wdst + (size_t)H * H;
  float* g_nb1 = g_nw1 + (size_t)2 * H * H;
  float* g_nw2 = g_nb1 + H;
  float* g_nb2 = g_nw2 + (size_t)H * H;
  const size_t nh = (size_t)M * H;
  cudaError_t err;
#define HD_TRY(call) do { err = (call); if (err != cudaSuccess) return (int)err; } while (0)
#define HD_LAUNCHED() HD_TRY(cudaGetLastError())

  // 1-2. node projections and the node-MLP backward; the once-flags live
  // here, local to this library (see smem_limit_once)
  static std::atomic<uint64_t> proj_smem_set{0}, edge_smem_set[4];
  HD_TRY(smem_limit_once((const void*)proj_sm90_kernel, node_smem_bytes(), proj_smem_set));
  proj_sm90_kernel<<<dim3((M + kRowTile - 1) / kRowTile, 2), kNodeThreads, node_smem_bytes(), st>>>(
      h, wsrct, wdstt, nullptr, proj, nullptr, M, H);
  HD_LAUNCHED();
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

  // 3. the real-edge list and every real edge's list position
  HD_TRY(launch_edge_list(emask, M, N, rowstart, totals, edges, st));
  HD_TRY(cudaMemsetAsync(posmap, 0xFF, sizeof(int) * plan.positions, st));
  posmap_kernel<<<ew_blocks(plan.positions), kEwThreads, 0, st>>>(edges, n_edges, posmap,
                                                                  (size_t)plan.positions);
  HD_LAUNCHED();

  // 4. the edge backward: per-edge values at list positions, per-tile sums
  HD_TRY(cudaMemsetAsync(de, 0, sizeof(float) * plan.positions * E, st));
  const GclBwdArgs a{e, emask, proj, we, b1, w2, b2, watt, watt32, batt, dagg, rowstart, edges,
                     u, dv, dpre, de, tile_part, B, N, H, E};
  std::atomic<uint64_t>& set = edge_smem_set[2 * (bf16_act != 0) + (attention != 0)];
  if (bf16_act)
    err = attention ? launch_bwd_edges<true, true>(a, plan.tiles, max_blocks, set, st)
                    : launch_bwd_edges<true, false>(a, plan.tiles, max_blocks, set, st);
  else
    err = attention ? launch_bwd_edges<false, true>(a, plan.tiles, max_blocks, set, st)
                    : launch_bwd_edges<false, false>(a, plan.tiles, max_blocks, set, st);
  if (err != cudaSuccess) return (int)err;

  // 5. the sums across edges, each in a fixed order
  const size_t hh = (size_t)H * H;
  HD_TRY(gemm<true>(u, dv, split_part, H, H, (int)plan.positions, H, H, H, kBwdSplits, false, st,
                    n_edges));                                              // dW2 = U^T dV
  HD_TRY(reduce(split_part, kBwdSplits, hh, hh, g_w2, st, n_edges,
                split_rows((int)plan.positions, kBwdSplits)));
  HD_TRY(column_sum(tile_part, (int)plan.tiles, tile_part_floats(H, E), tile_chunk_part, g_we, st,
                    n_edges, kTileM));                                   // dW_e .. db_att
  node_edge_sums_kernel<<<M, kEwThreads, 0, st>>>(dpre, rowstart, posmap, dhs, dhdst, N, H);
  HD_LAUNCHED();

  // 6. dh += dhs W_src^T + dh_dst W_dst^T
  HD_TRY(gemm<false>(dhs, wsrct, dh, M, H, H, H, H, H, 1, true, st));
  HD_TRY(gemm<false>(dhdst, wdstt, dh, M, H, H, H, H, H, 1, true, st));

  // node-level weight gradients, K = B*N, split-K with a fixed-order sum
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
