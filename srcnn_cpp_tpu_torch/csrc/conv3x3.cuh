// The 64->64 3x3 conv kernel of vdsr_conv.cu, as the other networks launch
// it: its epilogues (a template parameter of the one kernel body) and the
// launcher of RCAN's instantiations (rcan.cu).
//
// Activations are NHWC float32 [H][W][64]; a layer's packed weights are
// ops/cuda_vdsr.py::pack_layer's.  The epilogue acts on the fp32 sum of a
// pixel and channel, bias included, before its store:
//   EPI_RELU     max(v, 0)             VDSR's layers, an RCAB's first conv;
//   EPI_POOL     v, and the sums of v per channel over the frame, in a fixed
//                order: each block's consumer c writes its units' sums to
//                pool[(block * POOL_PARTS + c) * 64 + channel] (no atomics;
//                an RCAB's second conv, for channel attention);
//   EPI_SKIP     v + skip at the same pixel and channel (RCAN's group and
//                long skips; skip is never the output map);
//   EPI_SHUFFLE  v stored at (2y + dy, 2x + dx) of a 2H x 2W x 64 map (the
//                upsampler: one launch for each of the four (dy, dx), with
//                the weights of output channels 4c + 2dy + dx).

#pragma once

#include <cuda_runtime.h>

namespace srcnn_hopper {

enum Epilogue : int { EPI_RELU = 0, EPI_POOL = 1, EPI_SKIP = 2,
                      EPI_SHUFFLE = 3 };

struct EpiArgs {
  const float* skip;   // EPI_SKIP
  float* pool;         // EPI_POOL
  int dy, dx;          // EPI_SHUFFLE
};

constexpr int CONV3X3_C = 64;
// pool partial sums of a block (one a consumer warpgroup)
constexpr int POOL_PARTS = 2;
// floats of one packed layer, and the kernel's dynamic shared memory
constexpr int CONV3X3_LAYER_FLOATS = 73792;
constexpr int CONV3X3_SMEM_BYTES = 211968 + 48;

// Opt every RCAN instantiation into its shared memory; once per call.
int rcan_conv3x3_prepare();

// Enqueue one 64->64 layer with epilogue `epi` on `s`: the persistent grid
// of `grid` blocks (ops/cuda_vdsr.py::vdsr_plan) over an H x W frame.
cudaError_t rcan_conv3x3(Epilogue epi, const float* in, float* out,
                         const float* wl, int H, int W, EpiArgs ea, int grid,
                         cudaStream_t s);

}  // namespace srcnn_hopper
