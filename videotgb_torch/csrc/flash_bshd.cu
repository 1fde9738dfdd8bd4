// Kernel G: flash-attention forward on (B, S, H, D) tensors for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/attnlayoutprobe.py::_kern (driven by
// flash_bshd). Same function: out = softmax(q k^T * scale) v per (frame,
// head), no bias, keys over the whole sequence; products of bf16 (or f32)
// operands accumulated in f32, the online softmax in f32, P rounded to v's
// dtype before the PV product, out = acc / max(l, 1e-30) in q's dtype. q, k,
// v and out are (B, S, H, D), addressed by (batch, seq, head) strides with
// the last dim contiguous: there is no transpose before or after.
//
// Bound on the H100: at the probe's shape (128 frames x 264 x 16 x 88,
// bf16) q, k, v and out are 4 x 95 MB (~0.11 ms at 3.35 TB/s) against ~50
// GFLOP of products (~0.05 ms at 989 TFLOP/s): memory.
//
// This is a thin entry over kernel A's bodies (flash_mma.cuh, flash_fma.cuh):
// (B, S, H, D) is the (B, H, S, D) view with head stride D and seq stride
// H*D, which those bodies read through their strides. bf16 with 16-byte rows
// runs on the tensor cores, f32 on the CUDA cores, by the rule the caller
// applies (videotgb_torch/ops/attention.py::flash_body). The TPU kernel's
// blocking of several heads per program is not carried over: it worked
// around Mosaic's lack of a dot_general with a batch dim other than the
// leading one, a limit the card does not have, and on the card the
// (B, S, H, D) layout costs nothing (a block per (frame, head, 128 queries)
// reads each key row's 176 contiguous bytes).
#include "flash_mma.cuh"

// q, k, v, out: device (B, S, H, D) with (batch, seq, head) strides in
// elements and the last dim contiguous. dtype: 0 = float32, 1 = bfloat16;
// body: 0 = CUDA cores, 1 = tensor cores (bf16 with 16-byte rows only).
// Returns the launch's cudaError_t; the kernel does not synchronise.
extern "C" int flash_bshd(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int H, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          float scale, int dtype, int body, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  flash::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = nullptr;
  p.o = out;
  p.H = H;
  p.Sq = S;
  p.Skv = S;
  p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.b_sb = p.b_sh = p.b_sq = p.b_sk = 0;
  p.scale = scale;
  return static_cast<int>(flash::forward(p, B * H, dtype, body,
                                         static_cast<cudaStream_t>(stream)));
}
