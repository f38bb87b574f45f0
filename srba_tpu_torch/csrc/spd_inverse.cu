// Batched inverse of small symmetric positive-definite blocks, for Hopper
// (sm_90a).  [B, D, D] row-major f32 in, [B, D, D] row-major f32 out.
//
// Replaces the TPU kernel srba_tpu/ops/block_linalg.py::_spd_inverse_kernel
// (launched by _spd_inverse_pallas_impl): the same arithmetic, an unrolled
// Cholesky A = L L^T, then L^-1 by forward substitution, then
// A^-1 = L^-T L^-1, in the operation order of the plain version
// srba_tpu_torch/ops/block_linalg.py::spd_inverse_unrolled.
//
// Design.  The TPU kernel transposes the batch to a streams-major [D*D, B]
// layout so that every scalar step is one 2048-lane vector op, and pads B
// to whole tiles with identity blocks.  Here each thread owns one block:
// the D*D input values, L and L^-1 live in registers (fully unrolled, D is
// a template constant), and the kernel reads and writes the natural
// [B, D, D] layout in place, with no transpose, no padding and the ragged
// tail masked by index.
//
// Bound.  A block is D*D*4 bytes in and D*D*4 bytes out (D*D*8 bytes)
// against roughly D^3 flops (48 bytes / ~10 flops at D = 2, 288 bytes /
// ~150 flops at D = 6): far below the card's flop/byte balance, so the
// kernel is bound by memory bandwidth, and at the main path's sizes
// (B = 64..4096 blocks of 2x2) by launch latency.  Each thread reads D*D
// consecutive floats, so neighbouring threads touch addresses D*D*4 bytes
// apart and the loads are not coalesced; staging a block's tile through
// shared memory to coalesce them is later work.
//
// Plain C interface, bound from Python with ctypes: the launcher takes the
// input and output device pointers, B, D and the CUDA stream, launches on
// that stream, allocates nothing, does not synchronise, and returns the
// cudaGetLastError() code (0 = launched).

#include <cuda_runtime.h>

namespace {

template <int D>
__global__ void spd_inverse_kernel(const float* __restrict__ in,
                                   float* __restrict__ out, long long B) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const float* m = in + b * (D * D);
  float* o = out + b * (D * D);

  // Cholesky factor (lower triangle only is read from m and written to L).
  float L[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = __ldg(m + i * D + j);
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

// D = 1: the plain version's 1 / m.
template <>
__global__ void spd_inverse_kernel<1>(const float* __restrict__ in,
                                      float* __restrict__ out, long long B) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  out[b] = 1.0f / __ldg(in + b);
}

template <int D>
int launch(const float* in, float* out, long long B, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks = (B + kThreads - 1) / kThreads;
  spd_inverse_kernel<D><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(in, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int srba_spd_inverse_f32(const void* in, void* out, long long B,
                                    int d, void* stream) {
  if (B <= 0) return 0;
  if (B > 2147483647LL * 256LL) return static_cast<int>(cudaErrorInvalidValue);
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch<1>(src, dst, B, s);
    case 2: return launch<2>(src, dst, B, s);
    case 3: return launch<3>(src, dst, B, s);
    case 6: return launch<6>(src, dst, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* srba_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
