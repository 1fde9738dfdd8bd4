// Query-blocked RAFT correlation-pyramid lookup for Hopper (sm_90a), plain
// C interface: kernel E.
//
// Replaces the Pallas TPU kernel tools/lookupprobe.py::_blocked_kernel
// (driven by blocked_lookup). It computes the same function as
// corr_lookup.cu (the windowed bilinear lookup, r <= 4, zero padding, f32
// sums, output (P, Q, L*(2r+1)^2) in the pyramid's dtype, channel
// l*(2r+1)^2 + (x offset)*(2r+1) + (y offset)) by streaming whole scanlines
// of a block of qb queries, contiguous along the queries, through shared
// memory, where kernel B's gather body reads each query's taps Q elements
// apart.
//
// It is a thin entry over the tile body that kernel B also runs
// (corr_lookup_tile.cuh: TMA-fed scanlines in an mbarrier ring, the 2-tap
// form from shared memory, one bulk store of the block's outputs). What the
// probe varies are the body's block and window: qb, the queries of a block,
// and skip, which streams only the scanlines the block's queries reach
// (the TPU probe's "qskip") where without it every scanline of each level
// is streamed (its "qblock").
//
// Bound on the H100: memory (corr_lookup_tile.cuh).
#include "corr_lookup_tile.cuh"

// levels: host array of n_levels device pointers, each (P, hl*wl, Q);
// hl / wl: host arrays of the level sizes; coords: device (P, Q, 2) f32;
// out: device (P, Q, n_levels*(2r+1)^2). qb: queries per block, a multiple
// of 32 up to 128; skip: stream only the scanlines the block's queries
// reach; stage_bytes: bytes of each of the two ring stages
// (ops/correlation_pallas.py::lookup_tile). dtype: 0 = float32, 1 =
// bfloat16. Returns the launch's cudaError_t, or 10000 + the CUresult of a
// failed TMA encode; the kernel does not synchronise.
extern "C" int corr_lookup_blocked(const void* const* levels, const int* hl,
                                   const int* wl, int n_levels,
                                   const void* coords, void* out, int P,
                                   int Q, int radius, int qb, int skip,
                                   int stage_bytes, int dtype,
                                   void* stream) {
  return corr_tile::run(levels, hl, wl, n_levels, coords, out, P, Q, radius,
                        qb, skip, stage_bytes, dtype, nullptr,
                        static_cast<cudaStream_t>(stream));
}
