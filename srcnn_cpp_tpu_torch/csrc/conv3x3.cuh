// The 64->64 3x3 conv kernel of vdsr_conv.cu, as the other networks launch
// it: its epilogues and loaders (template parameters of the one kernel
// body), RCAN's channel attention as the loader computes it, and the
// launcher of RCAN's instantiations (rcan.cu).
//
// Activations are NHWC float32 [H][W][64]; a layer's packed weights are
// ops/cuda_vdsr.py::pack_layer's.  The epilogue acts on the fp32 sum of a
// pixel and channel, bias included, before its store:
//   EPI_RELU     max(v, 0)             VDSR's layers, an RCAB's first conv;
//   EPI_POOL     v, grouped by 8 channels ([8][H][W][8], as the apply
//                loaders read t), and the sums of v per channel over the
//                frame, in a fixed order: each block's consumer c writes
//                its units' sums to pool[(block * POOL_PARTS + c) * 64 +
//                channel] (no atomics; an RCAB's second conv, for channel
//                attention);
//   EPI_SKIP     v + skip at the same pixel and channel (RCAN's group and
//                long skips; skip is never the output map);
//   EPI_SHUFFLE  v stored at (2y + dy, 2x + dx) of a 2H x 2W x 64 map (the
//                upsampler: one launch for each of the four (dy, dx), with
//                the weights of output channels 4c + 2dy + dx).
// The loader forms the conv's input as it stages it:
//   LOAD_PLAIN       the input map as it is;
//   LOAD_APPLY       x = in + s * t, the previous RCAB's result, with s its
//                    channel attention (ca_finish below, from the pool sums
//                    of the conv that wrote t); each block stores the x of
//                    its units' own pixels to a separate map, grouped by
//                    8 channels (LoadArgs), so that every pixel and channel
//                    is written once (the next RCAB's x_prev);
//   LOAD_APPLY_LAST  the same without the store (a group's last conv, whose
//                    x nothing reads after it).

#pragma once

#include <cuda_runtime.h>

#include "probe.cuh"

namespace srcnn_hopper {

enum Epilogue : int { EPI_RELU = 0, EPI_POOL = 1, EPI_SKIP = 2,
                      EPI_SHUFFLE = 3 };
enum Loader : int { LOAD_PLAIN = 0, LOAD_APPLY = 1, LOAD_APPLY_LAST = 2 };

struct EpiArgs {
  const float* skip;   // EPI_SKIP
  float* pool;         // EPI_POOL
  int dy, dx;          // EPI_SHUFFLE
};

// LOAD_APPLY, LOAD_APPLY_LAST: x = in + s * t, s from `parts` pool slots of
// 64 sums over npx pixels and the RCAB's CA weights.  in is NHWC, or
// grouped where in_grouped: [8][H][W][8], channels 8q .. 8q + 7 of every
// pixel together, as LOAD_APPLY stores x; t is grouped, as EPI_POOL
// stores it.
struct LoadArgs {
  const float* t;
  const float* pool;
  const float* ca;     // CA_FLOATS
  float* x;            // LOAD_APPLY: where x is stored, grouped
  float* s;            // when not null, block 0 stores s here (tests)
  int parts;
  float npx;
  int in_grouped;
};

constexpr int CONV3X3_C = 64;
// pool partial sums of a block (one a consumer warpgroup)
constexpr int POOL_PARTS = 2;
// floats of one packed layer, and the kernel's dynamic shared memory
constexpr int CONV3X3_LAYER_FLOATS = 73792;
constexpr int CONV3X3_SMEM_BYTES = 211968 + 48;

// one RCAB's CA weights (floats): W1 [4][64], b1 [4], W2 [64][4], b2 [64]
constexpr int CA_HIDDEN = 4;                  // C / reduction 16
constexpr int CA_W1 = 0, CA_B1 = CA_HIDDEN * CONV3X3_C,
              CA_W2 = CA_B1 + CA_HIDDEN,
              CA_B2 = CA_W2 + CONV3X3_C * CA_HIDDEN,
              CA_FLOATS = CA_B2 + CONV3X3_C;
static_assert(CA_FLOATS == 580, "ops/cuda_rcan.py::CA_FLOATS");

// CA's finish: z[c] = (the sum of pool[p * 64 + c] over the `parts` slots
// p, in order) / npx; s = sigmoid(W2 relu(W1 z + b1) + b2).  Run by the
// threads i = 0 .. n - 1 (n >= 64) of a group that `sync()` holds
// together; z, hid: 64 and CA_HIDDEN floats of shared memory.
template <class Sync>
__device__ __forceinline__ void ca_finish(const float* pool, int parts,
                                          float npx,
                                          const float* __restrict__ w,
                                          float* z, float* hid, float* s,
                                          int i, Sync sync) {
  constexpr int C = CONV3X3_C;
  if (i < C) {
    float sum = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) sum += pool[(size_t)p * C + i];
    z[i] = __fdiv_rn(sum, npx);
  }
  sync();
  if (i < CA_HIDDEN) {
    float h = __ldg(w + CA_B1 + i);
    for (int k = 0; k < C; ++k)
      h = fmaf(__ldg(w + CA_W1 + i * C + k), z[k], h);
    hid[i] = fmaxf(h, 0.f);
  }
  sync();
  if (i < C) {
    float v = __ldg(w + CA_B2 + i);
#pragma unroll
    for (int j = 0; j < CA_HIDDEN; ++j)
      v = fmaf(__ldg(w + CA_W2 + i * CA_HIDDEN + j), hid[j], v);
    s[i] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
  }
  sync();
}

// The most pool slots a LOAD_APPLY* launch reads (grid x POOL_PARTS of the
// conv that wrote them): it stages them in two stages of its shared memory.
constexpr int CA_PARTS_MAX = 550;

// Opt every RCAN instantiation into its shared memory, and the probed ones
// too where `probed`; once per call.
int rcan_conv3x3_prepare(bool probed);

// Enqueue one 64->64 layer with epilogue `epi` and loader `load` on `s`:
// the persistent grid of `grid` blocks (ops/cuda_vdsr.py::vdsr_plan) over
// an H x W frame.  `probes`: the counter records (probe.cuh), whose record
// of the instance's kind the probed instance adds to, or null.
cudaError_t rcan_conv3x3(Epilogue epi, Loader load, const float* in,
                         float* out, const float* wl, int H, int W,
                         EpiArgs ea, LoadArgs la, int grid, cudaStream_t s,
                         Probe* probes);

}  // namespace srcnn_hopper
