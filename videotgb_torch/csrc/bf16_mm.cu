// Kernel H, bf16 body: C (M, N) bf16 = A (M, K) bf16 . B (N, K)^T bf16 with
// an f32 accumulator, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/int8pallas_probe.py::mm_kernel_bf16
// (driven by pallas_bf16_mm, inside the probe's main): x (M, K) bf16 times
// w (K, N) bf16, summed in f32 over K blocks, written as bf16 (round to
// nearest even). The probe uses it as the bf16 rate beside the int8 one.
//
// The products run on the tensor cores through
// wgmma.mma_async.sync.aligned.m64n{128,256}k16.f32.bf16.bf16, both
// operands K-major from shared memory, over the same warp-specialised main
// loop as the int8 body (wgmma_gemm.cuh: a 128-byte stage of K is 64 bf16
// here, four k16 steps, where it is 128 int8 and four k32 steps there). B
// comes as (N, K) with K contiguous, as the int8 body takes it; the tools
// transpose the probe's (K, N) w once. K must be a multiple of 8 (TMA's
// 16-byte row pitch). The f32 sums run in another order than the plain
// version's, so a result may differ from it by one bf16 rounding plus that
// order's f32 difference.
//
// Bound on the H100: at 8192^3 the work is 1.1e12 FLOPs (1.11 ms at 989
// TFLOP/s dense) against 384 MB (0.115 ms at 3.35 TB/s): operations.
#include "wgmma_gemm.cuh"

namespace {

struct Bf16 {
  using Acc = float;

  template <int BN>
  static __device__ __forceinline__ void mma(float (&c)[BN / 2], uint64_t a,
                                             uint64_t b, int accumulate) {
    mma_util::Wgmma<BN>::bf16(c, a, b, accumulate);
  }

  static __device__ __forceinline__ void store(void* C, int row, int col,
                                               float x, float y, int M, int N,
                                               int /*out_kind*/) {
    wgmma_gemm::store_pair(C, row, col, __float2bfloat16_rn(x),
                           __float2bfloat16_rn(y), M, N);
  }
};

}  // namespace

// a: device (M, K) bf16, b: device (N, K) bf16, both row-major and
// contiguous, 16-byte aligned; c: device (M, N) bf16. tile: the block tiling
// (wgmma_gemm.cuh::dispatch). encode_ns: where the host time of the two TMA
// descriptor encodes is written (may be null). Returns the launch's
// cudaError_t, or 10000 + the CUresult of a failed encode; the kernel does
// not synchronise.
extern "C" int bf16_mm(const void* a, const void* b, void* c, int M, int N,
                       int K, int tile, long long* encode_ns, void* stream) {
  if (K <= 0 || K > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  return wgmma_gemm::dispatch<Bf16>(tile, a, b, c, M, N, 2 * K, 1, encode_ns,
                                    static_cast<cudaStream_t>(stream));
}
