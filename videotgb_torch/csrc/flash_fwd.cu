// Kernel A: the flash-attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel videotgb_tpu/ops/attention.py::_flash_kernel
// (driven by _flash_forward). Same function: out = softmax(q k^T * scale +
// bias) v with products of bf16 (or f32) operands accumulated in f32, the
// bias added in f32 after scaling, running max / sum / acc in f32, P rounded
// to v's dtype before the PV product, out = acc / max(l, 1e-30) in q's dtype.
// A row whose keys all carry NEG_INF (-1e30) bias gives the uniform average
// that the plain softmax gives, never NaN.
//
// Bound on the H100: on the serving path (ViT-g, 16 images x 16 heads x 264
// x 88, bf16, a (1,1,1,264) pad bias) the work is ~6.3 GFLOP (~6 us at 989
// TFLOP/s) against ~48 MB of q/k/v/o (~14 us at 3.35 TB/s): memory. The
// T5-xl encoder's (8, 32, 160, 64) with its (B,H,S,S) f32 bias is memory
// too, the bias's 26 MB the larger half.
//
// Two bodies, chosen by the caller (videotgb_torch/ops/attention.py::
// flash_body) and passed as `body`:
//   * the tensor-core body (flash_mma.cuh), for bf16 inputs with 16-byte
//     rows, every shape the port's paths hand this kernel: mma.sync for
//     both products, two 16-row m-tiles per warp where the registers allow,
//     double-buffered cp.async K/V tiles, P kept in registers. Its own limit
//     is mma.sync issue and the exp and max work between the two products;
//   * the CUDA-core body (flash_fma.cuh), for f32 inputs (a tensor-core f32
//     product would be TF32) and bf16 rows that are not 16-byte aligned:
//     plain FMAs, a lane per key, P through shared memory.
// Both address q/k/v/out through (batch, head, seq) strides, so the (B, S,
// H, D) projections are read without a transpose copy, and the bias through
// 4 strides, 0 on broadcast dims.
#include "flash_mma.cuh"

// dtype: 0 = float32, 1 = bfloat16; body: 0 = CUDA cores, 1 = tensor cores
// (bf16 with D % 8 == 0, 16-byte aligned pointers and strides that are
// multiples of 8 elements; anything else is refused with
// cudaErrorInvalidValue). bias may be null (then its strides are ignored).
// Returns the launch's cudaError_t; the kernel does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, int B, int H, int Sq,
                         int Skv, int D, long long q_sb, long long q_sh,
                         long long q_ss, long long k_sb, long long k_sh,
                         long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, long long o_sb, long long o_sh,
                         long long o_ss, long long b_sb, long long b_sh,
                         long long b_sq, long long b_sk, float scale,
                         int dtype, int body, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  flash::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = out;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_sq = b_sq; p.b_sk = b_sk;
  p.scale = scale;
  return static_cast<int>(flash::forward(p, B * H, dtype, body,
                                         static_cast<cudaStream_t>(stream)));
}
