// K3 — floor-1 render + inverse coupling + floor x residue from
// precomputed brackets (Hopper, sm_90a).
//
// Replaces lewton_tpu/ops/synth_kernel.py::fused_floor_couple/_kernel. For
// every packet row and bin w, for all C channels: the exact Bresenham index
// from the bracketing posts (lo_x, lo_y, hi_x, hi_y), inverse dB masked by
// f_used, static inverse coupling of the f32 residue, and spectra =
// (curve * used) * coupled residue, written [rows, C, W]. Those steps are
// K1's epilogue (floor_epilogue.cuh); K3 takes the brackets from device
// memory where K1 contracts them from the telescopes.
//
// Any channel count a stream can have (1..255), as the reference takes: up
// to kMaxC channels the bin's residues stay in registers; past that the
// thread couples its own bin column in the output buffer (the wide kernel),
// which costs two more passes over that column through L1/L2.
//
// Bound: memory. Per output element the kernel reads 16 bytes of brackets
// and 4 of residue and writes 4 (1.41 GB per chunk at the flagship S=256,
// T=128, C=2, w_eff=896: ~0.42 ms at 3.35 TB/s). The arithmetic is a
// handful of flops per element; one thread per (row, bin) with neighbouring
// threads on neighbouring bins keeps every load and store coalesced.
//
// Rounded exactly as the plain torch version
// (lewton_tpu_torch/ops/synth_kernel.py::fused_floor_couple_ref):
// --fmad=false and explicit __f*_rn intrinsics.

#include <cuda_runtime.h>

#include "floor_epilogue.cuh"

namespace {

using lt_floor::kMaxC;
using lt_floor::kMaxChannels;
using lt_floor::kMaxSteps;
using lt_floor::Params;
constexpr int kBlockW = 128;
constexpr int kBlockRows = 2;

// Channel c's masked curve at bin wf; b points at its lo_x bracket, cw is
// the stride between the four brackets.
__device__ __forceinline__ float curve_at(const float* b, size_t cw, float wf,
                                          float used, const Params& prm) {
  const float idx =
      lt_floor::bresenham_idx(b[0], b[cw], b[2 * cw], b[3 * cw], wf);
  return __fmul_rn(lt_floor::db_value(idx, prm.db), used);
}

// brackets [rows, 4, C, W] (lo_x, lo_y, hi_x, hi_y), residue [rows, C, W],
// used [rows, C] (0/1), out [rows, C, W]; C <= kMaxC.
__global__ void __launch_bounds__(kBlockW * kBlockRows)
fused_floor_couple_kernel(const float* __restrict__ br,
                          const float* __restrict__ residue,
                          const float* __restrict__ used,
                          float* __restrict__ out, int rows, int C, int W,
                          const __grid_constant__ Params prm) {
  const int row = blockIdx.x * kBlockRows + threadIdx.y;
  const int w = blockIdx.y * kBlockW + threadIdx.x;
  if (row >= rows || w >= W) return;
  const size_t cw = static_cast<size_t>(C) * W;
  const float* brow = br + static_cast<size_t>(row) * 4 * cw + w;
  const float* rrow = residue + static_cast<size_t>(row) * cw + w;
  const float* urow = used + static_cast<size_t>(row) * C;
  const float wf = static_cast<float>(w);

  float curve[kMaxC];
  float res[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      curve[c] = curve_at(brow + static_cast<size_t>(c) * W, cw, wf, urow[c],
                          prm);
      res[c] = rrow[static_cast<size_t>(c) * W];
    } else {
      curve[c] = 0.0f;
      res[c] = 0.0f;
    }
  }

  lt_floor::inverse_coupling(res, prm);

  float* orow = out + static_cast<size_t>(row) * cw + w;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) orow[static_cast<size_t>(c) * W] = __fmul_rn(curve[c], res[c]);
  }
}

// The same for C > kMaxC: the thread's bin column of out holds the residue
// while it is coupled, then the product.
__global__ void __launch_bounds__(kBlockW * kBlockRows)
fused_floor_couple_wide_kernel(const float* __restrict__ br,
                               const float* __restrict__ residue,
                               const float* __restrict__ used,
                               float* __restrict__ out, int rows, int C,
                               int W, const __grid_constant__ Params prm) {
  const int row = blockIdx.x * kBlockRows + threadIdx.y;
  const int w = blockIdx.y * kBlockW + threadIdx.x;
  if (row >= rows || w >= W) return;
  const size_t cw = static_cast<size_t>(C) * W;
  const float* brow = br + static_cast<size_t>(row) * 4 * cw + w;
  const float* rrow = residue + static_cast<size_t>(row) * cw + w;
  const float* urow = used + static_cast<size_t>(row) * C;
  float* ocol = out + static_cast<size_t>(row) * cw + w;
  const float wf = static_cast<float>(w);

  for (int c = 0; c < C; ++c) {
    ocol[static_cast<size_t>(c) * W] = rrow[static_cast<size_t>(c) * W];
  }
  lt_floor::inverse_coupling_strided(ocol, W, prm);
  for (int c = 0; c < C; ++c) {
    float* o = ocol + static_cast<size_t>(c) * W;
    *o = __fmul_rn(
        curve_at(brow + static_cast<size_t>(c) * W, cw, wf, urow[c], prm), *o);
  }
}

}  // namespace

// C interface (loaded with ctypes). Pointers are device pointers except
// `steps` (host, 2 * n_steps ints: mag0, ang0, mag1, ...) and `db` (host, 16
// floats). Returns cudaGetLastError() after the launch (0 = success).
extern "C" int lt_fused_floor_couple(const void* brackets, const void* residue,
                                     const void* used, void* out, int rows,
                                     int C, int W, int n_steps,
                                     const int* steps, const float* db,
                                     void* stream) {
  if (C < 1 || C > kMaxChannels || n_steps < 0 || n_steps > kMaxSteps ||
      rows < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  lt_floor::fill_params(&prm, n_steps, steps, db);
  const dim3 block(kBlockW, kBlockRows);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows,
                  (W + kBlockW - 1) / kBlockW);
  auto kernel = C <= kMaxC ? fused_floor_couple_kernel
                           : fused_floor_couple_wide_kernel;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(brackets), static_cast<const float*>(residue),
      static_cast<const float*>(used), static_cast<float*>(out), rows, C, W,
      prm);
  return static_cast<int>(cudaGetLastError());
}
