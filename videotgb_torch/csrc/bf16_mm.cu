// Kernel H, bf16 body: C (M, N) bf16 = A (M, K) bf16 . B (N, K)^T bf16 with
// an f32 accumulator, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/int8pallas_probe.py::mm_kernel_bf16
// (driven by pallas_bf16_mm, inside the probe's main): x (M, K) bf16 times
// w (K, N) bf16, summed in f32 over K blocks, written as bf16 (round to
// nearest even). The probe uses it as the bf16 rate beside the int8 one.
//
// The products run on the tensor cores through
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, over the same main
// loop as the int8 body (mma_gemm.cuh: 16 bf16 values are the 32 bytes of K
// an s8 mma takes, with the same register layout). B comes as (N, K) with K
// contiguous, as the int8 body takes it, so the ldmatrix loads are the same
// non-transposed ones; the tools transpose the probe's (K, N) w once. K must
// be a multiple of 8 (16-byte copies).
//
// Bound on the H100: at 8192^3 the work is 1.1e12 FLOPs (1.11 ms at 989
// TFLOP/s dense) against 384 MB (0.115 ms at 3.35 TB/s): operations. As in
// the int8 body, mma.sync and its ldmatrix loads are this version's limit.
#include "mma_gemm.cuh"

namespace {

struct Bf16 {
  using Acc = float;

  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_util::mma_bf16_16816(c, a, b);
  }

  static __device__ __forceinline__ void store(void* C, int row, int col,
                                               float x, float y, int M, int N,
                                               int /*out_kind*/) {
    mma_gemm::store_pair(C, row, col, __float2bfloat16_rn(x),
                         __float2bfloat16_rn(y), M, N);
  }
};

}  // namespace

// a: device (M, K) bf16, b: device (N, K) bf16, both row-major and
// contiguous; c: device (M, N) bf16. tile: the block tiling
// (mma_gemm.cuh::dispatch). Returns the launch's cudaError_t; the kernel
// does not synchronise.
extern "C" int bf16_mm(const void* a, const void* b, void* c, int M, int N,
                       int K, int tile, void* stream) {
  if (K <= 0 || K > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma_gemm::dispatch<Bf16>(
      tile, a, b, c, M, N, 2 * K, 1, static_cast<cudaStream_t>(stream)));
}
