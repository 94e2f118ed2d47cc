// Fused kernel matrix out[i, j] = amp * phi(r2(a_i, b_j)) for Hopper (sm_90a).
//
// Replaces the Pallas kernel orion_tpu/ops/gram.py:68 (fused_gram, body
// _gram_kernel/_epilogue).  Same function: r2 = max(|a_i|^2 + |b_j|^2 -
// 2 a_i.b_j, 0) on lengthscale-scaled rows (the wrapper scales), then the
// Matern-5/2 or RBF epilogue, written once.  The (m, n) distance matrix
// never reaches device memory.
//
// Bound on an H100: writing the output.  At the main path's 16384 x 256 x 6
// the kernel reads 0.4 MB and writes 16.8 MB (about 5 us at 3.35 TB/s); its
// arithmetic is ~4.2 M x (d FMAs + sqrt + exp), far under the f32 rate.  The
// cross term has depth d (6 on the main path) and must be IEEE f32 -- TF32
// makes the gram indefinite, as in the reference -- so tensor cores do not
// apply and plain FMAs do the product.  The design therefore spends its care
// on the store: one 64 x 64 output tile per block, 256 threads, each thread a
// 4 x 4 micro-tile whose columns are strided by 16 so that neighbouring
// threads write neighbouring j (coalesced 64-byte segments), the epilogue in
// registers, ragged edges masked in the kernel (no padding copies).  Rows of
// a and b are staged through shared memory in chunks of kChunk features, so
// any d works.
//
// Plain C entry point, loaded with ctypes; launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output tile side (rows of a, rows of b)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread owns 4 x 4 outputs
constexpr int kStride = 16;    // micro-tile stride within the tile
constexpr int kChunk = 8;      // features staged per shared-memory pass

constexpr int kMatern52 = 0;
constexpr int kRbf = 1;

template <int Kind>
__device__ __forceinline__ float epilogue(float r2, float amp) {
  if (Kind == kRbf) {
    return amp * expf(-0.5f * r2);
  } else {
    const float r = sqrtf(r2);
    const float sqrt5_r = 2.2360679774997896f * r;
    return amp * (1.0f + sqrt5_r + (5.0f / 3.0f) * r2) * expf(-sqrt5_r);
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ amp_ptr, float* __restrict__ out,
            int m, int n, int d) {
  // Transposed staging ([feature][row]), padded by one column so the
  // row-major global loads scatter into distinct banks.
  __shared__ float as[kChunk][kTile + 1];
  __shared__ float bs[kChunk][kTile + 1];

  const int tid = threadIdx.x;
  const int tx = tid % kStride;  // column lane: neighbouring threads, neighbouring j
  const int ty = tid / kStride;
  const int row0 = blockIdx.x * kTile;
  const int col0 = blockIdx.y * kTile;

  float cross[kMicro][kMicro];
  float aa[kMicro];
  float bb[kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    aa[r] = 0.0f;
    bb[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) cross[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    // 64 rows x kChunk features of each operand; zero past the edges, so the
    // padded lanes add nothing to any sum.
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk;
      const int k = e % kChunk;
      const int gk = k0 + k;
      const int ga = row0 + row;
      const int gb = col0 + row;
      as[k][row] = (ga < m && gk < d) ? a[(int64_t)ga * d + gk] : 0.0f;
      bs[k][row] = (gb < n && gk < d) ? b[(int64_t)gb * d + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      float av[kMicro];
      float bv[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) av[r] = as[k][ty + kStride * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) bv[c] = bs[k][tx + kStride * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) aa[r] = fmaf(av[r], av[r], aa[r]);
#pragma unroll
      for (int c = 0; c < kMicro; ++c) bb[c] = fmaf(bv[c], bv[c], bb[c]);
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) cross[r][c] = fmaf(av[r], bv[c], cross[r][c]);
      }
    }
    __syncthreads();
  }

  const float amp = *amp_ptr;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = row0 + ty + kStride * r;
    if (i >= m) continue;
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int j = col0 + tx + kStride * c;
      if (j >= n) continue;
      // Same expansion and association as the reference: (aa + bb) - 2 ab.
      const float r2 = fmaxf(aa[r] + bb[c] - 2.0f * cross[r][c], 0.0f);
      out[(int64_t)i * n + j] = epilogue<Kind>(r2, amp);
    }
  }
}

}  // namespace

extern "C" int orion_fused_gram_f32(const void* a, const void* b, const void* amp, void* out,
                                    int m, int n, int d, int kind, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pamp = static_cast<const float*>(amp);
  float* pout = static_cast<float*>(out);
  if (kind == kRbf) {
    gram_kernel<kRbf><<<grid, block, 0, s>>>(pa, pb, pamp, pout, m, n, d);
  } else if (kind == kMatern52) {
    gram_kernel<kMatern52><<<grid, block, 0, s>>>(pa, pb, pamp, pout, m, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* orion_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
