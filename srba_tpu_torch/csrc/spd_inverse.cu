// Batched inverse of small symmetric positive-definite blocks, for Hopper
// (sm_90a).  [B, D, D] row-major f32 in, [B, D, D] row-major f32 out,
// D in {1, 2, 3, 6}.
//
// Replaces the TPU kernel srba_tpu/ops/block_linalg.py::_spd_inverse_kernel
// (launched by _spd_inverse_pallas_impl): the same arithmetic, an unrolled
// Cholesky A = L L^T, then L^-1 by forward substitution, then
// A^-1 = L^-T L^-1, in the operation order of the plain version
// srba_tpu_torch/ops/block_linalg.py::spd_inverse_unrolled.  The TPU kernel
// transposes the batch to a streams-major [D*D, B] layout so that each
// scalar step is one 2048-lane vector op; here each thread inverts one block
// in registers (invert_block, unrolled on the template D), and what the
// design is about is how the blocks reach the threads and leave them.
//
// Bound.  A block is D*D*4 bytes in and D*D*4 bytes out against ~D^3 flops
// (48 B / ~10 flops at D = 2, 288 B / ~150 flops at D = 6), far below the
// card's flop/byte balance: the kernel is bound by HBM, D*D*8*B bytes over
// 3.35 TB/s (11.27 us at [131072, 6, 6], 2.82 us at [32768, 6, 6]), and at
// the keyframe path's [64, d, d] stacks by launch latency.
//
// On an H100 SXM at 700 W the first design (one thread per block reading
// its D*D floats with scalar loads) ran [131072, 6, 6] in ~90 us per call,
// 12% of the bound; this one in ~14 us cold, ~80% (PERF.md).  What held the
// first back, and what this design does about it:
// 1. Uncoalesced loads and stores: the 32 lanes of a warp sat D*D*4 bytes
//    apart (144 B at D = 6), so every scalar access touched 32 sectors.
//    Here (D = 3, 6) a CTA of T threads owns a tile of T consecutive blocks,
//    one contiguous span of T*D*D*4 bytes, and stages it into shared memory
//    with 16-byte cp.async copies, neighbouring threads on neighbouring
//    addresses; each thread then reads its own block from shared memory,
//    writes the inverse back in place, and the CTA stores the tile with
//    16-byte stores.  The per-thread reads and writes are bank-conflict
//    free: at D = 6 a block is 36 words = 9 float4 (lanes 0-7 of a quarter
//    warp start 36 t = 4 t mod 32 apart, eight disjoint 4-bank groups); at
//    D = 3 the stride of 9 words is odd, so 32 scalar accesses hit 32 banks.
// 2. Unused vector width: at D = 2 a block is one float4, loaded and
//    stored as such, in registers, no staging; at D = 1 a thread inverts
//    four blocks from one float4, with a scalar tail.
// 3. Timing warm in L2: the first design's times were taken on one stack
//    of <= 37.7 MB, inside the 50 MB L2; chip_smoke.py now times the
//    kernel cold (a rotation of stacks over twice the L2, flushed before
//    each run) as well as warm.
// 4. Launch-bound small stacks ([64, d, d]: ~1.3-1.7 us of device time,
//    ~9-16 us of host time per call): nothing here adds host work, and
//    nothing on the device can remove much.
// Load latency is hidden by several CTAs per SM: one CTA per tile, T = 64
// at D = 6 and T = 128 at D = 3 (9,216 and 4,608 bytes of shared memory),
// chosen by measurement on the H100; a persistent grid that double-buffered
// the next tile was slower at every large stack and was not kept.
// The ragged tail (B not a multiple of T; tail bytes not a multiple of 16 at
// D = 3 with B odd) is copied with 4-byte copies; an input or output pointer
// that is not 16-byte aligned (a view at an odd block offset at D = 3) takes
// the same kernel with 4-byte copies throughout.  Every path runs the same
// invert_block, so all give bitwise-equal blocks.
//
// Arithmetic unchanged from the first design: no fast math, IEEE sqrtf and
// division, the same operation order (and so the same FMA contractions).
//
// nvcc -Xptxas -v for sm_90a (CUDA 12.8; chip_smoke.py phase 2 prints it):
// D = 6 41-42 registers and 9,216 B of shared memory, D = 3 26-28 and
// 4,608 B, D = 2 19, D = 1 20-23; no spills.
//
// Plain C interface, bound from Python with ctypes: srba_spd_inverse_f32
// takes the input and output device pointers, B, D and the CUDA stream,
// launches on that stream, allocates nothing, does not synchronise, and
// returns the cudaGetLastError() code (0 = launched).
// srba_spd_inverse_tile gives the blocks each CTA takes at D.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRegThreads = 256;  // threads per CTA at D = 1 and D = 2

// Blocks per CTA: a tile at D = 3 and 6 (one thread per block), 256 threads
// of one block each at D = 2 and of four at D = 1; 0 for any other D.
__host__ __device__ constexpr int tile_blocks(int d) {
  return d == 6 ? 64
       : d == 3 ? 128
       : d == 2 ? kRegThreads
       : d == 1 ? 4 * kRegThreads
       : 0;
}

// Inverse of one SPD block, m and o row-major in registers.
template <int D>
__device__ __forceinline__ void invert_block(const float (&m)[D * D],
                                             float (&o)[D * D]) {
  // Cholesky factor (lower triangle only is read from m and written to L).
  float L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = m[i * D + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = (i == j) ? sqrtf(s) : s / L[j][j];
    }
  }

  // Inverse of the triangular factor, forward substitution.
  float Li[D][D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    Li[j][j] = 1.0f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = j; k < i; ++k) s = s + L[i][k] * Li[k][j];
      Li[i][j] = -s / L[i][i];
    }
  }

  // A^-1 = L^-T L^-1 (symmetric; every entry written).
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = (i > j ? i : j); k < D; ++k) s = s + Li[k][i] * Li[k][j];
      o[i * D + j] = s;
    }
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Commits this thread's copies and waits until they have landed.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The CTA copies n consecutive floats from global src to shared dst:
// 16 bytes a thread where both are 16-byte aligned (kVec), then 4 bytes.
template <bool kVec>
__device__ __forceinline__ void stage_in(float* dst, const float* src,
                                         int n) {
  int done = 0;
  if constexpr (kVec) {
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += blockDim.x)
      cp_async16(dst + 4 * j, src + 4 * j);
    done = n4 << 2;
  }
  for (int j = done + threadIdx.x; j < n; j += blockDim.x)
    cp_async4(dst + j, src + j);
}

// The CTA stores n consecutive floats from shared src to global dst.
template <bool kVec>
__device__ __forceinline__ void stage_out(float* dst, const float* src,
                                          int n) {
  int done = 0;
  if constexpr (kVec) {
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += blockDim.x)
      reinterpret_cast<float4*>(dst)[j] =
          reinterpret_cast<const float4*>(src)[j];
    done = n4 << 2;
  }
  for (int j = done + threadIdx.x; j < n; j += blockDim.x) dst[j] = src[j];
}

// D = 3, 6: CTA c stages blocks [c*T, (c+1)*T) through shared memory, one
// thread per block.
template <int D, bool kVec>
__global__ void __launch_bounds__(tile_blocks(D))
    spd_inverse_staged(const float* __restrict__ in, float* __restrict__ out,
                       long long B) {
  constexpr int T = tile_blocks(D);
  constexpr int kBlock = D * D;
  __shared__ __align__(16) float tile[T * kBlock];
  const long long first = static_cast<long long>(blockIdx.x) * T;
  const int nblocks = static_cast<int>(B - first < T ? B - first : T);
  const long long offset = first * kBlock;

  stage_in<kVec>(tile, in + offset, nblocks * kBlock);
  cp_async_wait();
  __syncthreads();

  if (static_cast<int>(threadIdx.x) < nblocks) {
    float* blk = tile + threadIdx.x * kBlock;
    float m[kBlock], o[kBlock];
    if constexpr (kBlock % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kBlock / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(blk)[q];
        m[4 * q] = v.x;
        m[4 * q + 1] = v.y;
        m[4 * q + 2] = v.z;
        m[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBlock; ++k) m[k] = blk[k];
    }
    invert_block<D>(m, o);
    if constexpr (kBlock % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kBlock / 4; ++q)
        reinterpret_cast<float4*>(blk)[q] =
            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < kBlock; ++k) blk[k] = o[k];
    }
  }
  __syncthreads();
  stage_out<kVec>(out + offset, tile, nblocks * kBlock);
}

// D = 2: one float4 block per thread, in registers.
template <bool kVec>
__global__ void __launch_bounds__(kRegThreads)
    spd_inverse_d2(const float* __restrict__ in, float* __restrict__ out,
                   long long B) {
  const long long b =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float m[4], o[4];
  if constexpr (kVec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(in) + b);
    m[0] = v.x;
    m[1] = v.y;
    m[2] = v.z;
    m[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = __ldg(in + 4 * b + k);
  }
  invert_block<2>(m, o);
  if constexpr (kVec) {
    reinterpret_cast<float4*>(out)[b] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * b + k] = o[k];
  }
}

// D = 1: the plain version's 1 / m, four blocks per thread, one float4
// where all four exist, else scalar.
template <bool kVec>
__global__ void __launch_bounds__(kRegThreads)
    spd_inverse_d1(const float* __restrict__ in, float* __restrict__ out,
                   long long B) {
  const long long first =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if constexpr (kVec) {
    if (first + 4 <= B) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(in + first));
      reinterpret_cast<float4*>(out + first)[0] =
          make_float4(1.0f / v.x, 1.0f / v.y, 1.0f / v.z, 1.0f / v.w);
      return;
    }
  }
  for (long long i = first; i < B && i < first + 4; ++i)
    out[i] = 1.0f / __ldg(in + i);
}

using Kernel = void (*)(const float*, float*, long long);

}  // namespace

extern "C" int srba_spd_inverse_tile(int d) { return tile_blocks(d); }

extern "C" int srba_spd_inverse_f32(const void* in, void* out, long long B,
                                    int d, void* stream) {
  if (B <= 0) return 0;
  const int tile = tile_blocks(d);
  if (tile == 0 || (B + tile - 1) / tile > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>((B + tile - 1) / tile);
  const bool vec = ((reinterpret_cast<std::uintptr_t>(in) |
                     reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  Kernel kernel = nullptr;
  int threads = kRegThreads;
  switch (d) {
    case 1: kernel = vec ? spd_inverse_d1<true> : spd_inverse_d1<false>;
      break;
    case 2: kernel = vec ? spd_inverse_d2<true> : spd_inverse_d2<false>;
      break;
    case 3:
      kernel = vec ? spd_inverse_staged<3, true> : spd_inverse_staged<3, false>;
      threads = tile;
      break;
    default:
      kernel = vec ? spd_inverse_staged<6, true> : spd_inverse_staged<6, false>;
      threads = tile;
      break;
  }
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
