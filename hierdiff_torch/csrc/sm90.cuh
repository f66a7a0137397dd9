// Hopper pieces of the redesigned edge kernels: the real-edge work list.
//
// The dense layers carry (B, N, N) edges, most of them padding: at the GEOM
// sampler's batches only ~30% of them have edge_mask != 0. The work list
// holds the real ones, so an edge kernel computes nothing else:
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

namespace hd {

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
// both bf16 from shared memory. Thread t of the warpgroup holds, for
// j = 0 .. 31, d[4j + {0, 1}] = row 16 (t / 32) + (t % 32) / 4, columns
// 8j + 2 (t % 4) + {0, 1}; d[4j + {2, 3}] the same columns 8 rows lower.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16) @ B (16 x 128), both bf16 from shared
// memory; d[4j + ...] as for m64n256k16 with j = 0 .. 15.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
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

}  // namespace hd
