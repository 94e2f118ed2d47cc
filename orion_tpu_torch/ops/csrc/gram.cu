// Fused kernel matrix out[i, j] = amp * phi(r2(a_i, b_j)) for Hopper (sm_90a).
//
// Replaces the Pallas kernel orion_tpu/ops/gram.py:68 (fused_gram, body
// _gram_kernel/_epilogue).  Same function: r2 = max(|a_i|^2 + |b_j|^2 -
// 2 a_i.b_j, 0) on the lengthscale-scaled rows a = xa * inv_ls and
// b = xb * inv_ls, then the Matern-5/2 or RBF epilogue, written once.  The
// (m, n) distance matrix never reaches device memory.
//
// Bound on an H100 by bytes: at the main path's 16384 x 256 x 6 the kernel
// reads 0.4 MB and writes 16.8 MB, 5.1 us at 3.35 TB/s.  The cross term has
// depth d and must be IEEE f32 -- TF32 makes the gram indefinite, as in the
// reference -- so tensor cores do not apply and plain FMAs do the product.
// The IEEE sqrtf/expf epilogue is ~30 instructions an output (no
// fast-math), so at d = 6 executing the kernel's instructions takes about
// as long as the store, and the design keeps every other instruction and
// wait off the SMs.
//
// The design, one launch per call:
// * Scaling in the kernel.  The wrapper passes xa, xb, inv_ls and amp as
//   device pointers; each element is multiplied by inv_ls[k] as it is
//   staged into shared memory, the same f32 product two torch launches
//   used to make before the kernel ran.
// * Persistent blocks, b staged once per SM (resident path).  One block of
//   kGroups x 256 threads per SM (the grid is the SM count, read once per
//   device and cached below, capped at the work).  When the scaled b, its
//   norms and two a tiles per group fit kSmemBudget, the block stages b
//   into shared memory once -- one set of loads per SM, not per tile -- and
//   each 256-thread group then walks row tiles (16 rows x all n columns)
//   with a grid stride, synchronising on its own named barrier.  While a
//   tile's epilogue and stores run, the next tile's a elements are already
//   loading into registers; they are scaled into the group's second a
//   buffer after the stores, so that load's latency hides behind the
//   epilogue.  Otherwise (large n * d) the chunked path stages a and b
//   kChunk features at a time into 64 x 64 tiles, as a tiled GEMM does,
//   with a grid of SMs x resident blocks walking the tiles.
// * 16-byte stores.  On the resident path 64 threads cover a row of a
//   tile, so at n = 256 a tile is one contiguous 16 KB span.  On the float4
//   path (n % 4 == 0, 16-byte-aligned out) each thread owns 4 consecutive
//   columns and writes them with one st.global.v4.f32, so a warp writes 512
//   contiguous bytes; otherwise a thread's c-th column is tx + 64 c (tx +
//   16 c on the chunked path) and a warp's scalar store covers 128 (64)
//   contiguous bytes.  Ragged edges are masked in the kernel: no padding
//   copies.  Stores are plain (no streaming hint): the caller reads the
//   output straight back and it fits the 50 MB L2.
//
// The host-side launch plan (path, tile, shared bytes) comes from
// orion_tpu_torch/ops/gram.py::_launch_plan; the entry point checks it
// against the rule here and refuses a plan that disagrees.  Plain C entry
// point, loaded with ctypes; launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;   // one group: a tile's threads
constexpr int kGroups = 4;      // groups of a resident block, one block per SM
constexpr int kMinBlocks = 4;   // chunked blocks per SM the register budget is cut for
constexpr int kMicroRows = 4;   // consecutive rows per thread, 4 columns each
constexpr int kChunk = 16;      // features per pass, chunked path
constexpr int kPrefetch = 3;    // a elements in flight per thread, resident path
constexpr int kStageBatch = 8;  // b elements in flight per thread while staging
// Shared memory of one block: 48 KB, the most a launch takes without
// cudaFuncAttributeMaxDynamicSharedMemorySize.  The main path's resident
// block needs 10.1 KB; at 16384 x 1024 x 6, 31.1 KB.
constexpr int kSmemBudget = 48 * 1024;
// Shared rows are 4 floats longer than the tile, so a warp staging
// (row, feature) pairs spreads over the banks and float4 reads stay
// 16-byte aligned.
constexpr int kRowPad = 4;

// A 256-thread group's output tile: ColThreads threads across 4 * ColThreads
// columns, kThreads / ColThreads sets of kMicroRows rows down it.
template <int ColThreads>
struct Tile {
  static constexpr int kColThreads = ColThreads;
  static constexpr int kRows = kThreads / ColThreads * kMicroRows;
  static constexpr int kCols = 4 * ColThreads;
};
using Wide = Tile<64>;    // resident path: 16 x 256, whole rows at n = 256
using Square = Tile<16>;  // chunked path: 64 x 64, the least b staged per output
static_assert(kMicroRows % 4 == 0, "a thread reads its rows as float4");
static_assert(kThreads % kChunk == 0 && Square::kRows % (kThreads / kChunk) == 0 &&
                  Square::kCols % (kThreads / kChunk) == 0,
              "chunk staging gives each thread whole rows");

constexpr int kMatern52 = 0;
constexpr int kRbf = 1;

struct Args {
  const float* xa;
  const float* xb;
  const float* ils;
  const float* amp;
  float* out;
  int m, n, d;
};

// Row stride of b (and length of its norms) in shared memory, resident path.
__host__ __device__ inline int resident_ldb(int n) {
  return (n + Wide::kCols - 1) / Wide::kCols * Wide::kCols + kRowPad;
}

__host__ __device__ inline int resident_smem(int n, int d) {
  const int ldb = resident_ldb(n);
  return 4 * (d * ldb + ldb + kGroups * 2 * d * Wide::kRows);
}

// The budget keeps a resident tile's a elements within the prefetch
// registers: d <= 31 at the narrowest b (one tile of columns).
static_assert((kSmemBudget / 4 - (Wide::kCols + kRowPad)) /
                      (Wide::kCols + kRowPad + kGroups * 2 * Wide::kRows) * Wide::kRows <=
                  kPrefetch * kThreads,
              "a resident a tile must fit the prefetch registers");

constexpr int kChunkLda = Square::kRows + kRowPad;
constexpr int kChunkLdb = Square::kCols + kRowPad;
constexpr int kChunkSmem = 4 * kChunk * (kChunkLda + kChunkLdb);

// amp * phi(r2), given r = sqrt(r2) for Matern-5/2 (unused for RBF).
template <int Kind>
__device__ __forceinline__ float profile(float r2, float r, float amp) {
  if constexpr (Kind == kRbf) {
    return amp * expf(-0.5f * r2);
  } else {
    const float sqrt5_r = 2.2360679774997896f * r;
    return amp * (1.0f + sqrt5_r + (5.0f / 3.0f) * r2) * expf(-sqrt5_r);
  }
}

// Column of a thread's c-th output within its tile.
template <class T, bool Vec>
__device__ __forceinline__ int tile_col(int tx, int c) {
  return Vec ? 4 * tx + c : tx + T::kColThreads * c;
}

struct Acc {
  float cross[kMicroRows][4];
  float aa[kMicroRows];
  float bb[4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r) {
    acc.aa[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc.cross[r][c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) acc.bb[c] = 0.0f;
}

// One feature: a_k points at this thread's kMicroRows scaled a values of
// feature k, b_k at its first scaled b value of feature k.  The sums run in
// feature order, one fmaf each, as in the reference.
template <class T, bool Vec, bool Norms>
__device__ __forceinline__ void step(Acc& acc, const float* a_k, const float* b_k) {
  // A warp's threads share one or two sets of rows: the a reads are broadcasts.
  float av[kMicroRows];
#pragma unroll
  for (int h = 0; h < kMicroRows; h += 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(a_k + h);
    av[h] = a4.x;
    av[h + 1] = a4.y;
    av[h + 2] = a4.z;
    av[h + 3] = a4.w;
  }
  float bv[4];
  if constexpr (Vec) {
    const float4 b4 = *reinterpret_cast<const float4*>(b_k);
    bv[0] = b4.x;
    bv[1] = b4.y;
    bv[2] = b4.z;
    bv[3] = b4.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b_k[T::kColThreads * c];
  }
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r) acc.aa[r] = fmaf(av[r], av[r], acc.aa[r]);
  if constexpr (Norms) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc.bb[c] = fmaf(bv[c], bv[c], acc.bb[c]);
  }
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc.cross[r][c] = fmaf(av[r], bv[c], acc.cross[r][c]);
  }
}

// The epilogue of a thread's outputs and their stores.  The arithmetic runs
// for every output, masked rows and columns included, and a row's four
// roots come before the rest of its epilogue, so the compiler interleaves
// the outputs; only the stores are predicated.
template <int Kind, class T, bool Vec>
__device__ __forceinline__ void store_tile(const Acc& acc, const Args& p, float amp, int row0,
                                           int col0, int tx, int ty) {
  const int i0 = row0 + ty * kMicroRows;
  const int j0 = col0 + tile_col<T, Vec>(tx, 0);
  float* row = p.out + (int64_t)i0 * p.n + j0;
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r, row += p.n) {
    float r2[4], root[4], v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // Same expansion and association as the reference, (aa + bb) - 2 ab:
      // 2 ab is exact, so one fmaf rounds the difference once, as it does.
      r2[c] = fmaxf(fmaf(-2.0f, acc.cross[r][c], acc.aa[r] + acc.bb[c]), 0.0f);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) root[c] = Kind == kMatern52 ? sqrtf(r2[c]) : 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = profile<Kind>(r2[c], root[c], amp);
    if (i0 + r >= p.m) continue;
    if constexpr (Vec) {
      // n % 4 == 0, so a thread's 4 columns are all in range or all out.
      if (j0 < p.n) *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j0 + T::kColThreads * c < p.n) row[T::kColThreads * c] = v[c];
      }
    }
  }
}

// Resident path, one block of kGroups groups per SM: b and its norms staged
// once per block; each group walks row tiles (16 rows x all n columns) with
// a grid stride, the next row tile's a elements loading into registers
// while this one's epilogue runs, and waits only on its own barrier.
template <int Kind, bool Vec>
__device__ void resident_rows(const Args& p, float amp, float* smem) {
  const int group = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const int tx = tid % Wide::kColThreads;  // a warp: 32 neighbouring tx, one ty
  const int ty = tid / Wide::kColThreads;
  const int d = p.d;
  const int ldb = resident_ldb(p.n);
  const int row_tiles = (p.m + Wide::kRows - 1) / Wide::kRows;
  const int tile_elems = Wide::kRows * d;
  float* bs = smem;                                // [d][ldb], scaled b, zero past n
  float* bbs = bs + d * ldb;                       // [ldb], |b_j|^2
  float* as = bbs + ldb + group * 2 * tile_elems;  // [2][d][Wide::kRows], this group's a
  // Group-major, so a grid of few tiles spreads over every SM first.
  const int first = group * gridDim.x + blockIdx.x;
  const int stride = gridDim.x * kGroups;

  // The a elements this thread stages: the same slots of every row tile.
  int slot[kPrefetch];
  float scale[kPrefetch];
  float pre[kPrefetch];
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int e = tid + q * kThreads;
    slot[q] = -1;
    scale[q] = 0.0f;
    if (e < tile_elems) {
      const int row = e / d;
      const int k = e - row * d;
      slot[q] = k * Wide::kRows + row;
      scale[q] = __ldg(p.ils + k);
    }
  }
  auto load_a = [&](int rt) {
    const int row0 = rt * Wide::kRows;
    const int valid = min(Wide::kRows, p.m - row0) * d;
    const float* src = p.xa + (int64_t)row0 * d;
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int e = tid + q * kThreads;
      pre[q] = e < valid ? __ldg(src + e) : 0.0f;
    }
  };
  auto stage_a = [&](float* dst) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      if (slot[q] >= 0) dst[slot[q]] = pre[q] * scale[q];
    }
  };

  if (first < row_tiles) load_a(first);
  // b column by column, kStageBatch features at a time with all their
  // loads in flight before any is used; the norm sums in feature order.
  for (int j = threadIdx.x; j < ldb; j += kThreads * kGroups) {
    const float* src = p.xb + (int64_t)j * d;
    const bool in = j < p.n;
    float norm = 0.0f;
    for (int k0 = 0; k0 < d; k0 += kStageBatch) {
      float v[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int k = k0 + u;
        v[u] = in && k < d ? __ldg(src + k) * __ldg(p.ils + k) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        if (k0 + u < d) {
          bs[(k0 + u) * ldb + j] = v[u];
          norm = fmaf(v[u], v[u], norm);
        }
      }
    }
    bbs[j] = norm;
  }
  if (first < row_tiles) stage_a(as);
  __syncthreads();  // b, its norms and the first a tiles staged

  int buf = 0;
  for (int rt = first; rt < row_tiles; rt += stride) {
    const int next = rt + stride;
    if (next < row_tiles) load_a(next);
    const float* at = as + buf * tile_elems + ty * kMicroRows;
    const int row0 = rt * Wide::kRows;
    for (int col0 = 0; col0 < p.n; col0 += Wide::kCols) {
      Acc acc;
      zero(acc);
      const float* a_k = at;
      const float* b_k = bs + col0 + tile_col<Wide, Vec>(tx, 0);
#pragma unroll 2
      for (int k = 0; k < d; ++k, a_k += Wide::kRows, b_k += ldb) {
        step<Wide, Vec, false>(acc, a_k, b_k);
      }
      if constexpr (Vec) {
        const float4 b4 = *reinterpret_cast<const float4*>(bbs + col0 + 4 * tx);
        acc.bb[0] = b4.x;
        acc.bb[1] = b4.y;
        acc.bb[2] = b4.z;
        acc.bb[3] = b4.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc.bb[c] = bbs[col0 + tile_col<Wide, false>(tx, c)];
      }
      store_tile<Kind, Wide, Vec>(acc, p, amp, row0, col0, tx, ty);
    }
    if (next < row_tiles) stage_a(as + (buf ^ 1) * tile_elems);
    // This group's next tile staged and its current buffer free.
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(kThreads) : "memory");
    buf ^= 1;
  }
}

// Chunked path, any n and d: 64 x 64 tiles, each staging kChunk features of
// a and b at a time (a thread's loads for a chunk all in flight together),
// summing only the features below d.
template <int Kind, bool Vec>
__device__ void chunked_tiles(const Args& p, float amp, float* smem) {
  constexpr int kRowsPerPass = kThreads / kChunk;
  constexpr int kPerA = Square::kRows / kRowsPerPass;
  constexpr int kPerB = Square::kCols / kRowsPerPass;
  const int tid = threadIdx.x;
  const int tx = tid % Square::kColThreads;
  const int ty = tid / Square::kColThreads;
  const int d = p.d;
  const int col_tiles = (p.n + Square::kCols - 1) / Square::kCols;
  const int tiles = (p.m + Square::kRows - 1) / Square::kRows * col_tiles;
  float* as = smem;                     // [kChunk][kChunkLda]
  float* bs = as + kChunk * kChunkLda;  // [kChunk][kChunkLdb]
  // This thread stages feature sk of rows (columns) sr + u * kRowsPerPass.
  const int sk = tid % kChunk;
  const int sr = tid / kChunk;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t / col_tiles;
    const int row0 = rt * Square::kRows;
    const int col0 = (t - rt * col_tiles) * Square::kCols;
    Acc acc;
    zero(acc);
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int gk = k0 + sk;
      const bool kin = gk < d;
      const float s = kin ? __ldg(p.ils + gk) : 0.0f;
      float va[kPerA];
      float vb[kPerB];
#pragma unroll
      for (int u = 0; u < kPerA; ++u) {
        const int gi = row0 + sr + u * kRowsPerPass;
        va[u] = kin && gi < p.m ? __ldg(p.xa + (int64_t)gi * d + gk) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPerB; ++u) {
        const int gj = col0 + sr + u * kRowsPerPass;
        vb[u] = kin && gj < p.n ? __ldg(p.xb + (int64_t)gj * d + gk) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPerA; ++u) as[sk * kChunkLda + sr + u * kRowsPerPass] = va[u] * s;
#pragma unroll
      for (int u = 0; u < kPerB; ++u) bs[sk * kChunkLdb + sr + u * kRowsPerPass] = vb[u] * s;
      __syncthreads();
      const int kn = min(kChunk, d - k0);
      const float* a_k = as + ty * kMicroRows;
      const float* b_k = bs + tile_col<Square, Vec>(tx, 0);
#pragma unroll 4
      for (int k = 0; k < kn; ++k, a_k += kChunkLda, b_k += kChunkLdb) {
        step<Square, Vec, true>(acc, a_k, b_k);
      }
      __syncthreads();
    }
    store_tile<Kind, Square, Vec>(acc, p, amp, row0, col0, tx, ty);
  }
}

template <int Kind, bool Resident, bool Vec>
__global__ void __launch_bounds__(Resident ? kThreads * kGroups : kThreads,
                                  Resident ? 1 : kMinBlocks) gram_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const float amp = __ldg(p.amp);
  if constexpr (Resident) {
    resident_rows<Kind, Vec>(p, amp, smem);
  } else {
    chunked_tiles<Kind, Vec>(p, amp, smem);
  }
}

using Kernel = void (*)(Args);

template <int Kind>
Kernel pick(bool resident, bool vec) {
  if (resident) return vec ? gram_kernel<Kind, true, true> : gram_kernel<Kind, true, false>;
  return vec ? gram_kernel<Kind, false, true> : gram_kernel<Kind, false, false>;
}

// SM count per device and resident blocks per SM per (device, kernel,
// shared bytes), each queried once.
constexpr int kMaxDevices = 64;
constexpr int kMaxCached = 256;
struct Occupancy {
  int device;
  Kernel kernel;
  int smem;
  int blocks;
};
std::mutex cache_mutex;
int sm_counts[kMaxDevices];
Occupancy occupancy[kMaxCached];
int n_occupancy = 0;

cudaError_t grid_size(Kernel kernel, int threads, int smem, int items, int* grid) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache_mutex);
  if (sm_counts[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_counts[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  for (int i = 0; i < n_occupancy; ++i) {
    const Occupancy& o = occupancy[i];
    if (o.device == device && o.kernel == kernel && o.smem == smem) blocks = o.blocks;
  }
  if (blocks == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    if (n_occupancy < kMaxCached) occupancy[n_occupancy++] = {device, kernel, smem, blocks};
  }
  const int64_t resident = (int64_t)sm_counts[device] * blocks;
  *grid = (int)(items < resident ? items : resident);
  return cudaSuccess;
}

}  // namespace

// The plan (resident, vec, tile_rows, tile_cols, smem_bytes) must be the
// one this file's rule gives for (m, n, d) and out's alignment; anything
// else returns cudaErrorInvalidValue and launches nothing.
extern "C" int orion_fused_gram_f32(const void* xa, const void* xb, const void* ils,
                                    const void* amp, void* out, int m, int n, int d, int kind,
                                    int resident, int vec, int tile_rows, int tile_cols,
                                    int smem_bytes, void* stream) {
  if (m <= 0 || n <= 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool fits = resident_smem(n, d) <= kSmemBudget;
  const int want_rows = fits ? Wide::kRows : Square::kRows;
  const int want_cols = fits ? Wide::kCols : Square::kCols;
  const int want_smem = fits ? resident_smem(n, d) : kChunkSmem;
  if ((resident != 0) != fits || (vec != 0) != (n % 4 == 0 && aligned) ||
      tile_rows != want_rows || tile_cols != want_cols || smem_bytes != want_smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Kernel kernel;
  if (kind == kRbf) {
    kernel = pick<kRbf>(fits, vec != 0);
  } else if (kind == kMatern52) {
    kernel = pick<kMatern52>(fits, vec != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Blocks with work: a resident block's first group takes a row tile (all
  // n columns), a chunked block one tile.
  const int row_tiles = (m + tile_rows - 1) / tile_rows;
  const int items = fits ? row_tiles : row_tiles * ((n + tile_cols - 1) / tile_cols);
  const int threads = fits ? kThreads * kGroups : kThreads;
  int grid = 0;
  const cudaError_t err = grid_size(kernel, threads, smem_bytes, items, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args args{static_cast<const float*>(xa), static_cast<const float*>(xb),
                  static_cast<const float*>(ils), static_cast<const float*>(amp),
                  static_cast<float*>(out), m, n, d};
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* orion_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
