// PTX helpers of the tensor-core kernels:
//   * for mma.sync (flash_mma.cuh, flash_bwd_mma.cuh): 16-byte cp.async
//     copies into shared memory with zero fill, ldmatrix (plain and
//     transposed) of b16 8 x 8 matrices, bf16 packing of fragment pairs,
//     and the bf16 m16n8k16 mma.sync with f32 accumulators;
//   * for Hopper's asynchronous path (wgmma_gemm.cuh, corr_lookup_tile.cuh):
//     mbarriers, 2-D TMA loads, bulk stores from shared memory, the host's
//     cuTensorMapEncodeTiled, setmaxnreg, and wgmma (fence, commit, wait,
//     shared-memory descriptors of 128-byte-swizzled K-major tiles, and the
//     m64n{128,256} products on bf16 and s8).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_util {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// each lane receives rows 2t and 2t + 1 of column g of every matrix
// (g = lane / 4, t = lane % 4): the B operand of an mma from a row-major
// (k, n) tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two f32 values rounded to bf16 and packed into one 32-bit register, lo in
// the low half: a pair of an mma fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d += a . b on bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 10 s of the global timer traps (a launch error the caller sees)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) start = now;
    if (now - start > 10000000000ull) __trap();
  }
}

// ------------------------------------------------------------------ TMA
// copy the box at (c0, c1) (innermost first, in elements) of the tensor map
// at `tmap` (a __grid_constant__ kernel parameter) into shared memory at
// `dst`; completion counts the box's bytes on the mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// make this thread's writes to shared memory visible to the async proxy (a
// bulk store that reads them after a barrier)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// shared memory at `src` to global memory at `dst`, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until every bulk store of this thread has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// barrier `id` (1-15; 0 is __syncthreads's) over `count` threads, a
// multiple of 32
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// a C entry's return code for a failed descriptor encode: this + CUresult
constexpr int kEncodeError = 10000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (so
// that the libraries need no -lcuda); null where libcuda has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// ----------------------------------------------------------- setmaxnreg
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// this point (between a wgmma and its wait they belong to the tensor cores)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory descriptor of a K-major operand tile laid out as TMA's
// 128-byte swizzle writes it: rows of 128 bytes, 8-row groups 1024 bytes
// apart (the stride byte offset), the tile base 1024-byte aligned so the
// swizzle's phase is 0. Adding 2 to the descriptor moves the start 32
// bytes along K inside the swizzle atom: the next k-step.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // leading (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // stride: 8 rows
         (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

#define WG_REGS_0_64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"
#define WG_REGS_64_128 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, " \
  "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, " \
  "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"
#define WG_ACC8(C, d, i)                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),             \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define WG_ACC64(C, d, i)                                                 \
  WG_ACC8(C, d, i), WG_ACC8(C, d, i + 8), WG_ACC8(C, d, i + 16),           \
      WG_ACC8(C, d, i + 24), WG_ACC8(C, d, i + 32), WG_ACC8(C, d, i + 40), \
      WG_ACC8(C, d, i + 48), WG_ACC8(C, d, i + 56)
#define WG_F(x) "+f"(x)
#define WG_R(x) "+r"(x)

// d (64 x N of the warpgroup, N / 2 values a thread) = a . b^T (+ d where
// accumulate != 0): a 64 x 16 bf16 (f32 sums) or 64 x 32 s8 (s32 sums) tile
// of A and an N x 16 / N x 32 tile of B, both K-major in shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_REGS_0_64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC64(WG_F, d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void s8(int (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_REGS_0_64
        "}, %64, %65, p;\n}\n"
        : WG_ACC64(WG_R, d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void bf16(float (&d)[128], uint64_t a,
                                              uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS_0_64
        ", " WG_REGS_64_128 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC64(WG_F, d, 0), WG_ACC64(WG_F, d, 64)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void s8(int (&d)[128], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_REGS_0_64
        ", " WG_REGS_64_128 "}, %128, %129, p;\n}\n"
        : WG_ACC64(WG_R, d, 0), WG_ACC64(WG_R, d, 64)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

#undef WG_REGS_0_64
#undef WG_REGS_64_128
#undef WG_ACC8
#undef WG_ACC64
#undef WG_F
#undef WG_R

}  // namespace mma_util
