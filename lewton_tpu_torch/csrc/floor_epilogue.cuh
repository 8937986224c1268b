// The floor-1 epilogue shared by K1 (floor_kernel.cu) and K3
// (synth_kernel.cu): exact Bresenham index from the bracketing posts,
// inverse dB as a 4-factor product, static inverse coupling.
//
// Arithmetic is rounded exactly as the plain torch versions round it
// (lewton_tpu_torch/ops/floor_curve.py, ops/coupling.py): the library is
// built with --fmad=false, and every product or sum that is not an exact
// integer is an explicit __f*_rn intrinsic.

#pragma once

#include <cuda_runtime.h>

namespace lt_floor {

constexpr int kMaxC = 8;  // channels held in registers
constexpr int kMaxChannels = 255;  // a Vorbis stream's channel count is 8 bits
constexpr int kMaxSteps = 256;  // Vorbis allows 1..256 coupling steps

struct Params {
  int n_steps;
  int mag[kMaxSteps];
  int ang[kMaxSteps];
  float db[16];  // H1[4], H0[4], L1[4], L0[4]
};

// Host: fill the kernel parameters from the C interface's arguments
// (steps: 2 * n_steps ints mag0, ang0, mag1, ...; db: 16 floats).
inline void fill_params(Params* prm, int n_steps, const int* steps,
                        const float* db) {
  prm->n_steps = n_steps;
  for (int i = 0; i < n_steps; ++i) {
    prm->mag[i] = steps[2 * i];
    prm->ang[i] = steps[2 * i + 1];
  }
  for (int i = 0; i < 16; ++i) prm->db[i] = db[i];
}

__device__ __forceinline__ float floorq(float x, float adx) {
  float q = floorf(__fdiv_rn(x, adx));
  const float r = __fsub_rn(x, __fmul_rn(q, adx));
  if (r >= adx) q = __fadd_rn(q, 1.0f);
  if (r < 0.0f) q = __fsub_rn(q, 1.0f);
  return q;
}

// Single-quotient Bresenham index, clipped to [0, 255]; all operands are
// f32 integers (lewton_tpu/ops/floor_curve.bresenham_idx has the proof).
__device__ __forceinline__ float bresenham_idx(float lo_x, float lo_y,
                                               float hi_x, float hi_y,
                                               float binx) {
  const float dy = __fsub_rn(hi_y, lo_y);
  const float adx = fmaxf(__fsub_rn(hi_x, lo_x), 1.0f);
  const float sgn = dy > 0.0f ? 1.0f : (dy < 0.0f ? -1.0f : 0.0f);
  const float ady = fabsf(dy);
  const float x = __fmul_rn(__fsub_rn(binx, lo_x), ady);
  const float y = __fadd_rn(lo_y, __fmul_rn(sgn, floorq(x, adx)));
  return fminf(fmaxf(y, 0.0f), 255.0f);
}

__device__ __forceinline__ float db_value(float idx, const float* db) {
  const int i = static_cast<int>(idx);  // integer-valued, in [0, 255]
  const float hi = __fmul_rn(db[i >> 6], db[4 + ((i >> 4) & 3)]);
  const float lo = __fmul_rn(db[8 + ((i >> 2) & 3)], db[12 + (i & 3)]);
  return __fmul_rn(hi, lo);
}

// One inverse coupling step on a (magnitude, angle) pair.
__device__ __forceinline__ void couple_step(float m, float a, float& new_m,
                                            float& new_a) {
  if (m > 0.0f) {
    if (a > 0.0f) { new_m = m; new_a = __fsub_rn(m, a); }
    else          { new_m = __fadd_rn(m, a); new_a = m; }
  } else {
    if (a > 0.0f) { new_m = m; new_a = __fadd_rn(m, a); }
    else          { new_m = __fsub_rn(m, a); new_a = m; }
  }
}

// Static inverse coupling of one bin's channels, steps in reverse order.
// The channel slots are selected by unrolled compares so that res stays
// in registers.
__device__ __forceinline__ void inverse_coupling(float (&res)[kMaxC],
                                                 const Params& prm) {
  for (int i = prm.n_steps - 1; i >= 0; --i) {
    const int mi = prm.mag[i], ai = prm.ang[i];
    float m = 0.0f, a = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c == mi) m = res[c];
      if (c == ai) a = res[c];
    }
    float new_m, new_a;
    couple_step(m, a, new_m, new_a);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c == mi) res[c] = new_m;
      if (c == ai) res[c] = new_a;
    }
  }
}

// The same coupling for any channel count: channel c of the bin lies at
// col[c * stride] in memory that only the calling thread touches.
__device__ __forceinline__ void inverse_coupling_strided(float* col,
                                                         size_t stride,
                                                         const Params& prm) {
  for (int i = prm.n_steps - 1; i >= 0; --i) {
    float* pm = col + static_cast<size_t>(prm.mag[i]) * stride;
    float* pa = col + static_cast<size_t>(prm.ang[i]) * stride;
    float new_m, new_a;
    couple_step(*pm, *pa, new_m, new_a);
    *pm = new_m;
    *pa = new_a;
  }
}

}  // namespace lt_floor
