// Hopper pieces shared by the edge kernels (fused_gcl.cu, fused_coord.cu,
// fused_gcl_bwd.cu): the real-edge work list, wgmma on 128-byte-swizzled
// shared memory (W2 read as is, or transposed through an MN-major
// descriptor), the W2 copy, and the node-level projection kernel; and, for
// the two edge kernels whose warpgroups each build and consume their own
// tiles (fused_coord.cu, fused_gcl_bwd.cu), the tile's metadata and
// pre-activation build.
//
// The work list. The dense layers carry (B, N, N) edges, most of them
// padding: at the GEOM sampler's batches only ~30% of them have
// edge_mask != 0. The work list holds the real ones, so an edge kernel
// computes nothing else:
//   rowstart[r]  first list position of source row r = b * N + i (B*N + 1
//                entries, the last one the number of real edges);
//   edges[p]     flat index r * N + j of the p-th real edge, in (r, j) order,
//                so the edges of one source row are consecutive.
// Two launches build it from the edge mask itself (any mask, not only
// prefix masks), on the device, with no host synchronisation: a count pass
// (warp per row, ballots over the mask) that also writes each block's total,
// and a fill pass in which every block sums the totals of the blocks before
// it, scans its own rows and writes their edges. Integer sums only, so the
// list is the same on every run.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "edge_mlp.cuh"

namespace hd {

// Raises a kernel's dynamic shared-memory limit once per device and process
// (`done` holds one bit per device index), not on every call: the attribute
// call is host time that every one of the sampler's calls would pay. The
// flags belong in a library's C entry point, a function that is neither
// inline nor a template: their symbols then stay local to that library, so
// the phase-clock build, loaded into the same process, keeps its own.
inline cudaError_t smem_limit_once(const void* kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;   // devices past 64: every call
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

constexpr int kListRows = 32;                        // source rows per list block
constexpr int kListThreads = 256;
constexpr int kListWarps = kListThreads / 32;
constexpr int kRowsPerWarp = kListRows / kListWarps;

__host__ __device__ inline int list_blocks(int rows) { return (rows + kListRows - 1) / kListRows; }

// counts[r] = nnz(emask[r, :]) for the block's rows (written into rowstart,
// which edge_fill_kernel turns into starts in place); totals[block] = their sum.
__global__ void __launch_bounds__(kListThreads)
edge_count_kernel(const float* __restrict__ emask, int rows, int N, int* __restrict__ rowstart,
                  int* __restrict__ totals) {
  __shared__ int part[kListWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kListRows + warp * kRowsPerWarp;
  int cnt[kRowsPerWarp] = {};
  for (int j0 = 0; j0 < N; j0 += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)   // all loads first: one memory round trip
      v[k] = r0 + k < rows && j0 + lane < N ? emask[(size_t)(r0 + k) * N + j0 + lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) cnt[k] += __popc(__ballot_sync(0xffffffffu, v[k] != 0.0f));
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    if (lane == 0 && r0 + k < rows) rowstart[r0 + k] = cnt[k];
    sum += cnt[k];
  }
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kListWarps; ++w) total += part[w];
    totals[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kListThreads)
edge_fill_kernel(const float* __restrict__ emask, int rows, int N, int* __restrict__ rowstart,
                 const int* __restrict__ totals, int* __restrict__ edges) {
  static_assert(kListRows == 32, "one lane per row in the block scan");
  __shared__ int part[kListWarps];
  __shared__ int start[kListRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int before = 0;   // real edges in the blocks before this one
  for (int g = threadIdx.x; g < blockIdx.x; g += blockDim.x) before += totals[g];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xffffffffu, before, off);
  if (lane == 0) part[warp] = before;
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int w = 0; w < kListWarps; ++w) base += part[w];
    const int r = blockIdx.x * kListRows + lane;
    const int cnt = r < rows ? rowstart[r] : 0;
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    start[lane] = base + incl - cnt;
    if (r < rows) rowstart[r] = base + incl - cnt;
    if (r == rows - 1) rowstart[rows] = base + incl;
  }
  __syncthreads();
  const int rr0 = warp * kRowsPerWarp, r0 = blockIdx.x * kListRows + rr0;
  int pos[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) pos[k] = start[rr0 + k];
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = 0; j0 < N; j0 += 32) {
    float v[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
      v[k] = r0 + k < rows && j0 + lane < N ? emask[(size_t)(r0 + k) * N + j0 + lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const unsigned real = __ballot_sync(0xffffffffu, v[k] != 0.0f);
      if (v[k] != 0.0f) edges[pos[k] + __popc(real & below)] = (r0 + k) * N + j0 + lane;
      pos[k] += __popc(real);
    }
  }
}

inline cudaError_t launch_edge_list(const float* emask, int rows, int N, int* rowstart, int* totals,
                                    int* edges, cudaStream_t stream) {
  edge_count_kernel<<<list_blocks(rows), kListThreads, 0, stream>>>(emask, rows, N, rowstart, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  edge_fill_kernel<<<list_blocks(rows), kListThreads, 0, stream>>>(emask, rows, N, rowstart, totals,
                                                                   edges);
  return cudaGetLastError();
}

// ---- wgmma (sm_90a)
// Operands in shared memory are K-major with the 128-byte swizzle, the layout
// TMA's SWIZZLE_128B writes: a tile of R rows (M rows of A, N rows of B) and
// K columns is K / 64 blocks of R x 64 bf16; a row of a block is 128 bytes,
// and its 16-byte chunk c is stored at chunk c ^ (row % 8). Blocks start on
// 1024-byte boundaries, so the swizzle the hardware applies to address bits
// [4, 7) from bits [7, 10) is the one written here.
__host__ __device__ constexpr int sw128_offset(int r, int k, int R) {   // in elements
  return (k >> 6) * R * 64 + r * 64 + ((((k >> 3) & 7) ^ (r & 7)) << 3) + (k & 7);
}

// Descriptor of a K-major SWIZZLE_128B operand whose row 0 at the wanted k
// starts at p: stride 1024 bytes between 8-row groups, leading offset unused.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Descriptor of the same buffer read as B^T: a K-major SWIZZLE_128B tile of
// kMaxH rows (blocks of kMaxH x 64 elements) is, atom for atom, an MN-major
// one of its transpose: 64 contiguous MN elements per 128-byte row, 8-row
// groups 1024 bytes apart (stride offset), 64-element MN blocks kMaxH * 128
// bytes apart (leading offset). p: row 0 of the wanted k, i.e. the first of
// the 16 rows of B^T's k-step, at MN column 0.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((kMaxH * 128) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier of the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
// 16-byte copy from device to shared memory that does not wait for the data.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
// Waits for every cp.async of this thread.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Keeps the compiler from moving accumulator reads and writes across wgmma.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (64 x 256 f32, the warpgroup's registers) += A (64 x 16) @ B (16 x 256),
// both bf16 from shared memory; TRANS_B reads B through an MN-major
// descriptor (sw128_desc_mn). Thread t of the warpgroup holds, for
// j = 0 .. 31, d[4j + {0, 1}] = row 16 (t / 32) + (t % 32) / 4, columns
// 8j + 2 (t % 4) + {0, 1}; d[4j + {2, 3}] the same columns 8 rows lower.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 128 f32) += A (64 x 16) @ B (16 x 128), both bf16 from shared
// memory (TRANS_B as for m64n256k16); d[4j + ...] as for m64n256k16 with
// j = 0 .. 15.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// Edge counts, compiled in only with -DHD_PHASE_CLOCKS: an edge kernel adds
// the edge slots it computes and the real edges among them, so
// tools/kernel_phases.py can set them beside nnz(edge_mask).
#ifdef HD_PHASE_CLOCKS
__device__ unsigned long long hd_edge_counts[2];
#define HD_COUNT_EDGES(slots, real)                                  \
  do {                                                               \
    atomicAdd(&hd_edge_counts[0], static_cast<unsigned long long>(slots)); \
    atomicAdd(&hd_edge_counts[1], static_cast<unsigned long long>(real));  \
  } while (0)
// Copy the counts to out[2] and zero them.
extern "C" int hd_read_edge_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, hd_edge_counts, sizeof(hd_edge_counts));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[2] = {};
  return (int)cudaMemcpyToSymbol(hd_edge_counts, zeros, sizeof(zeros));
}
#else
#define HD_COUNT_EDGES(slots, real) do { } while (0)
#endif

// ---- the edge kernels' pieces: one block per SM, two warpgroups walking
// their own 64-edge tiles (see fused_coord.cu, fused_gcl_bwd.cu)

// Phase clocks per warpgroup: thread 0 of each warpgroup adds its cycles.
#ifdef HD_PHASE_CLOCKS
#define HD_WG_PHASE(k, t)                                                            \
  do {                                                                               \
    if (threadIdx.x % 128 == 0) {                                                    \
      const long long now_ = clock64();                                              \
      atomicAdd(&hd_phase_cycles[k], static_cast<unsigned long long>(now_ - (t)));   \
      (t) = now_;                                                                    \
    }                                                                                \
  } while (0)
#else
#define HD_WG_PHASE(k, t) do { } while (0)
#endif

// The edge kernel: kEdgeWGs warpgroups per block, one block per SM, each
// warpgroup walking its own tiles with its own pre-activation buffer.
constexpr int kEdgeWGs = 2;
constexpr int kEdgeThreads = 128 * kEdgeWGs;
constexpr int kW2Bytes = kMaxH * kMaxH * 2;          // W2, K-major, zero-padded to 256 x 256
constexpr int kUBytes = kTileM * kMaxH * 2;          // one bf16 pre-activation tile
constexpr int kMetaBytes = 1024;                     // per warpgroup: rows, cols, mask, flag

struct TileMeta {
  int row[kTileM];     // global source row b * N + i, -1 past the last real edge
  int col[kTileM];     // neighbour j
  float emask[kTileM]; // bf16-rounded edge mask
  int cont;            // the tile's first run continues a row from the tile before
};
static_assert(sizeof(TileMeta) <= kMetaBytes, "tile metadata");

__host__ __device__ constexpr int edge_smem_bytes() {
  return 1024 + kW2Bytes + kEdgeWGs * (kUBytes + kMetaBytes) + 2 * kMaxH * 4;
}

// u (64 x 256 bf16, K-major SWIZZLE_128B) = silu(pre) for the tile's edges,
// pre = h_i W_src + h_j W_dst + e_ij W_e + b1 from a.proj ([h W_src | h W_dst]
// per node), a.e, a.we and a.b1;
// warp w of the warpgroup builds edges w, w + 4, ..., lane l columns 8l .. 8l + 7,
// written as one 16-byte vector. Padding edges and columns >= H get 0.
template <bool BF16, class Args>
__device__ __forceinline__ void build_tile(const TileMeta& tm, int nv, const Args& a, bf16* u) {
  constexpr int kEdgesPerWarp = kTileM / 4, kB = 4;
  const int warp = (threadIdx.x % 128) / 32, c0 = 8 * (threadIdx.x % 32);
  const int H = a.H, N = a.N, E = a.E;
  const bool col_ok = c0 < H;
  float bias[8], wreg[kRegE][8];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    bias[cc] = col_ok ? act<BF16>(a.b1[c0 + cc]) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRegE; ++r) wreg[r][cc] = col_ok && r < E ? __bfloat162float(a.we[r * H + c0 + cc]) : 0.0f;
  }
  for (int i0 = 0; i0 < kEdgesPerWarp; i0 += kB) {
    float4 hs[kB][2], hdst[kB][2];
    float ev[kB][kRegE];
    int q[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {   // all loads of the batch first
      const int p = warp + 4 * (i0 + k);
      const bool real = p < nv && col_ok;
      const int row = real ? tm.row[p] : 0, col = real ? tm.col[p] : 0;
      q[k] = row * N + col;
      const float* s = a.proj + (size_t)row * 2 * H + c0;
      const float* d = a.proj + ((size_t)(row / N) * N + col) * 2 * H + H + c0;
      hs[k][0] = real ? *reinterpret_cast<const float4*>(s) : make_float4(0.f, 0.f, 0.f, 0.f);
      hs[k][1] = real ? *reinterpret_cast<const float4*>(s + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
      hdst[k][0] = real ? *reinterpret_cast<const float4*>(d) : make_float4(0.f, 0.f, 0.f, 0.f);
      hdst[k][1] = real ? *reinterpret_cast<const float4*>(d + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kRegE; ++r) ev[k][r] = real && r < E ? a.e[(size_t)q[k] * E + r] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int p = warp + 4 * (i0 + k);
      const bool real = p < nv && col_ok;
      const float hsv[8] = {hs[k][0].x, hs[k][0].y, hs[k][0].z, hs[k][0].w,
                            hs[k][1].x, hs[k][1].y, hs[k][1].z, hs[k][1].w};
      const float hdv[8] = {hdst[k][0].x, hdst[k][0].y, hdst[k][0].z, hdst[k][0].w,
                            hdst[k][1].x, hdst[k][1].y, hdst[k][1].z, hdst[k][1].w};
      float ep[8];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        ep[cc] = 0.0f;
#pragma unroll
        for (int r = 0; r < kRegE; ++r)
          if (r < E) ep[cc] += round_bf16(ev[k][r]) * wreg[r][cc];
      }
      if (real && E > kRegE) {   // wide E (sinusoid embedding): the rest from L1
        for (int r = kRegE; r < E; ++r) {
          const float er = round_bf16(a.e[(size_t)q[k] * E + r]);
          const uint4 wv = *reinterpret_cast<const uint4*>(a.we + r * H + c0);
          const bf16* w8 = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) ep[cc] += er * __bfloat162float(w8[cc]);
        }
      }
      uint4 packed;
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int cc = 0; cc < 8; cc += 2) {
        const float v0 = real ? silu_act<BF16>(pre_act<BF16>(hsv[cc], hdv[cc], ep[cc], bias[cc])) : 0.0f;
        const float v1 =
            real ? silu_act<BF16>(pre_act<BF16>(hsv[cc + 1], hdv[cc + 1], ep[cc + 1], bias[cc + 1])) : 0.0f;
        pk[cc / 2] = __floats2bfloat162_rn(v0, v1);
      }
      *reinterpret_cast<uint4*>(u + sw128_offset(p, c0, kTileM)) = packed;
    }
  }
}

// A tile's metadata, read one tile ahead: thread t < kTileM holds edge t's
// flat index (-1 past the last real edge) and bf16-rounded mask, thread 0
// also whether the tile's first run continues a row from the tile before.
struct MetaPrefetch {
  int q;
  float emask;
  int cont;
};

template <class Args>
__device__ __forceinline__ MetaPrefetch fetch_meta(const Args& a, int tile, int n_edges, int tid) {
  MetaPrefetch m{-1, 0.0f, 0};
  const int q0 = tile * kTileM;
  if (tid < kTileM && q0 + tid < n_edges) {
    m.q = a.edges[q0 + tid];
    m.emask = round_bf16(a.emask[m.q]);
    if (tid == 0) m.cont = q0 > 0 && a.edges[q0 - 1] / a.N == m.q / a.N;
  }
  return m;
}

// W2 (K x H bf16, row-major) into shared memory as wgmma's B operand: N x K,
// K-major, 128-byte swizzle, zero-padded to 256 x 256. A thread reads 8
// columns of rows k and k + 1 (two 16-byte loads) and writes 8 (k, k + 1)
// pairs; a warp's 32 consecutive k pairs fill whole 128-byte rows, so the
// 4-byte stores meet no bank conflict.
__device__ __forceinline__ void load_w2_sw128(const bf16* __restrict__ w2, bf16* w2s, int H) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < (kMaxH / 2) * (kMaxH / 8); idx += blockDim.x) {
    const int k = 2 * (idx % (kMaxH / 2)), n0 = 8 * (idx / (kMaxH / 2));
    uint4 r0 = make_uint4(0, 0, 0, 0), r1 = r0;
    if (k < H && n0 < H) {
      r0 = *reinterpret_cast<const uint4*>(w2 + (size_t)k * H + n0);
      r1 = *reinterpret_cast<const uint4*>(w2 + (size_t)(k + 1) * H + n0);
    }
    const bf16* v0 = reinterpret_cast<const bf16*>(&r0);
    const bf16* v1 = reinterpret_cast<const bf16*>(&r1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat162 pair;
      pair.x = v0[i];
      pair.y = v1[i];
      *reinterpret_cast<__nv_bfloat162*>(w2s + sw128_offset(n0 + i, k, kMaxH)) = pair;
    }
  }
}

// ---- node-level products on wgmma: 64 rows per block and two warpgroups,
// each owning 128 of the 256 output columns (m64n128k16); B (a weight, N x K,
// K-major: nn.Linear's own layout, cached in bf16) copied into shared memory
// with cp.async, A built from f32 rows.
constexpr int kRowTile = 64;
constexpr int kNodeThreads = 256;

__host__ __device__ constexpr int node_smem_bytes() {   // B, A, bn1 and bn2
  return 1024 + kMaxH * kMaxH * 2 + kRowTile * kMaxH * 2 + 2 * kMaxH * 4;
}

// B (256 x K, SWIZZLE_128B) = rows 0 .. H - 1 of w (N x K row-major, row
// stride ld, bf16), asynchronously; rows >= H are zeroed.
__device__ __forceinline__ void load_b_async(bf16* bs, const bf16* __restrict__ w, int ld, int H, int K) {
  const int chunks = K / 8;
  for (int idx = threadIdx.x; idx < kMaxH * chunks; idx += blockDim.x) {
    const int n = idx / chunks, c = idx % chunks;
    bf16* dst = bs + sw128_offset(n, 8 * c, kMaxH);
    if (n < H) cp_async16(dst, w + (size_t)n * ld + 8 * c);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// d (64 x 128) = A (64 x 16 k_steps, SWIZZLE_128B with 64 rows) @ the 128
// columns of B^T that this thread's warpgroup owns.
__device__ __forceinline__ void wgmma_half(float (&d)[64], const bf16* as, const bf16* bs, int k_steps) {
  const int n0 = 128 * (threadIdx.x / 128);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(d[i]);
  wgmma_fence();
  for (int s = 0; s < k_steps; ++s)
    wgmma_m64n128k16(d, sw128_desc(as + sw128_offset(0, 16 * s, kRowTile)),
                     sw128_desc(bs + sw128_offset(n0, 16 * s, kMaxH)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_operand(d[i]);
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  return raw + ((1024 - (base & 1023)) & 1023);
}

// A thread's accumulator rows (of the block's 64) and its columns: for
// j = 0 .. 15, d[4j + {0, 1}] is row ra, columns col(j) + {0, 1}, and
// d[4j + {2, 3}] the same columns of row rb.
struct HalfFrag {
  int ra, rb, c0;
  __device__ HalfFrag() {
    const int t = threadIdx.x % 128, lane = t % 32;
    ra = (t / 32) * 16 + lane / 4;
    rb = ra + 8;
    c0 = 128 * (threadIdx.x / 128) + 2 * (lane % 4);
  }
  __device__ int col(int j) const { return c0 + 8 * j; }
};

// The products of h that need no message: blockIdx.y 0 and 1 give
// proj = [h W_src | h W_dst], 2 gives z1h = h Wn1[:H] (the h half of the node
// MLP's first layer), for 64 rows per block. The weights are the cached
// nn.Linear-layout copies: wsrct, wdstt, and nw1t's first H columns. A grid
// of height 2 computes proj only (nw1t and z1h unused).
__global__ void __launch_bounds__(kNodeThreads, 1)
proj_sm90_kernel(const float* __restrict__ h, const bf16* __restrict__ wsrct, const bf16* __restrict__ wdstt,
                 const bf16* __restrict__ nw1t, float* __restrict__ proj, float* __restrict__ z1h, int M,
                 int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* as = reinterpret_cast<bf16*>(smem + kMaxH * kMaxH * 2);
  const int r0 = blockIdx.x * kRowTile, which = blockIdx.y;
  if (which == 2) load_b_async(bs, nw1t, 2 * H, H, H);
  else load_b_async(bs, which ? wdstt : wsrct, H, H, H);
  constexpr int kProjBatch = 8;   // 8-column chunks per thread whose loads go together
  for (int idx0 = 0; idx0 < kRowTile * H / 8; idx0 += kProjBatch * kNodeThreads) {
    float4 x[kProjBatch][2];
#pragma unroll
    for (int k = 0; k < kProjBatch; ++k) {
      const int idx = idx0 + k * kNodeThreads + threadIdx.x;
      const int r = idx / (H / 8), c0 = 8 * (idx % (H / 8));
      x[k][0] = x[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < kRowTile * H / 8 && r0 + r < M) {
        x[k][0] = *reinterpret_cast<const float4*>(h + (size_t)(r0 + r) * H + c0);
        x[k][1] = *reinterpret_cast<const float4*>(h + (size_t)(r0 + r) * H + c0 + 4);
      }
    }
#pragma unroll
    for (int k = 0; k < kProjBatch; ++k) {
      const int idx = idx0 + k * kNodeThreads + threadIdx.x;
      if (idx >= kRowTile * H / 8) break;
      const int r = idx / (H / 8), c0 = 8 * (idx % (H / 8));
      uint4 packed;
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
      pk[0] = __floats2bfloat162_rn(x[k][0].x, x[k][0].y);
      pk[1] = __floats2bfloat162_rn(x[k][0].z, x[k][0].w);
      pk[2] = __floats2bfloat162_rn(x[k][1].x, x[k][1].y);
      pk[3] = __floats2bfloat162_rn(x[k][1].z, x[k][1].w);
      *reinterpret_cast<uint4*>(as + sw128_offset(r, c0, kRowTile)) = packed;
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  float d[64];
  wgmma_half(d, as, bs, H / 16);
  const HalfFrag f;
  float* dst = which == 2 ? z1h : proj + which * H;
  const int ld = which == 2 ? H : 2 * H;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = f.col(j);
    if (c < H) {
      if (r0 + f.ra < M)
        *reinterpret_cast<float2*>(dst + (size_t)(r0 + f.ra) * ld + c) = make_float2(d[4 * j], d[4 * j + 1]);
      if (r0 + f.rb < M)
        *reinterpret_cast<float2*>(dst + (size_t)(r0 + f.rb) * ld + c) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace hd
