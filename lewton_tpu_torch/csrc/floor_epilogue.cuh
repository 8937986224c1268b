// The floor-1 epilogue shared by K1 (floor_kernel.cu) and K3
// (synth_kernel.cu): exact Bresenham index from the bracketing posts,
// inverse dB as a 4-factor product, static inverse coupling.
//
// Arithmetic is rounded exactly as the plain torch versions round it
// (lewton_tpu_torch/ops/floor_curve.py, ops/coupling.py): the library is
// built with --fmad=false, and every product or sum that is not an exact
// integer is an explicit __f*_rn intrinsic.
//
// Inverse dB comes in two forms with the same value: db_value evaluates
// the 4-factor product per element from the 16 factors (K3), and
// fill_db_table stores the product for all 256 indices in shared memory
// once per block (K1), where a per-thread index into the 16 factors of a
// __grid_constant__ parameter would serialise in the constant cache. Both
// round through db_entry, so the table equals db_value bit for bit.

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

// The terms of bresenham_idx that are constant between two posts, formed
// once per segment: a = (lo_x, lo_y, adx, 1/adx), b = (ady, sgn), rounded
// as bresenham_idx rounds them (1/adx once, IEEE).
__device__ __forceinline__ void segment_terms(float lo_x, float lo_y,
                                              float hi_x, float hi_y,
                                              float4& a, float2& b) {
  const float dy = __fsub_rn(hi_y, lo_y);
  const float adx = fmaxf(__fsub_rn(hi_x, lo_x), 1.0f);
  a = make_float4(lo_x, lo_y, adx, __frcp_rn(adx));
  b = make_float2(fabsf(dy), dy > 0.0f ? 1.0f : (dy < 0.0f ? -1.0f : 0.0f));
}

// bresenham_idx from a segment's terms, the same value: floor(x / adx) is
// taken from the candidate floor(x * (1/adx)) with floorq's +-1 remainder
// correction. x = (binx - lo_x) * ady < 2^22 (bins < 2^12, ady < 2^10):
// for adx = 1 the candidate is exact, for adx >= 2 it is within
// (x / adx) * 2^-23 < 1/2 of x / adx, and the correction recovers the
// exact integer floor, as it does from the IEEE quotient (the reference's
// shared-reciprocal argument, lewton_tpu/ops/floor_curve.bresenham_idx);
// q * adx <= x + adx < 2^24 keeps the remainder exact.
__device__ __forceinline__ float bresenham_idx_seg(const float4& a,
                                                   const float2& b,
                                                   float binx) {
  const float x = __fmul_rn(__fsub_rn(binx, a.x), b.x);
  float q = floorf(__fmul_rn(x, a.w));
  const float r = __fsub_rn(x, __fmul_rn(q, a.z));
  if (r >= a.z) q = __fadd_rn(q, 1.0f);
  if (r < 0.0f) q = __fsub_rn(q, 1.0f);
  const float y = __fadd_rn(a.y, __fmul_rn(b.y, q));
  return fminf(fmaxf(y, 0.0f), 255.0f);
}

// (H1[i>>6] * H0[(i>>4)&3]) * (L1[(i>>2)&3] * L0[i&3]) for i in [0, 255].
__device__ __forceinline__ float db_entry(int i, const float* db) {
  const float hi = __fmul_rn(db[i >> 6], db[4 + ((i >> 4) & 3)]);
  const float lo = __fmul_rn(db[8 + ((i >> 2) & 3)], db[12 + (i & 3)]);
  return __fmul_rn(hi, lo);
}

__device__ __forceinline__ float db_value(float idx, const float* db) {
  return db_entry(static_cast<int>(idx), db);  // integer-valued, in [0, 255]
}

// The 256-entry inverse-dB table, filled by the calling block's threads;
// the caller synchronises before reading it.
__device__ __forceinline__ void fill_db_table(float* table, const float* db) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    table[i] = db_entry(i, db);
  }
}

// One inverse coupling step on a (magnitude, angle) pair, without
// branches: the spec's four cases are
//   m > 0, a > 0: (m, m - a)     m > 0, a <= 0: (m + a, m)
//   m <= 0, a > 0: (m, m + a)    m <= 0, a <= 0: (m - a, m),
// so the changed value is m - a when the signs' tests agree, else m + a,
// and it replaces the angle when a > 0, else the magnitude.
__device__ __forceinline__ void couple_step(float m, float a, float& new_m,
                                            float& new_a) {
  const bool a_pos = a > 0.0f;
  const float d = (m > 0.0f) == a_pos ? __fsub_rn(m, a) : __fadd_rn(m, a);
  new_m = a_pos ? m : d;
  new_a = a_pos ? d : m;
}

// Static inverse coupling of one bin's N channels, steps in reverse order.
// The channel slots are selected by unrolled compares so that res stays
// in registers.
template <int N>
__device__ __forceinline__ void inverse_coupling(float (&res)[N],
                                                 const Params& prm) {
  for (int i = prm.n_steps - 1; i >= 0; --i) {
    const int mi = prm.mag[i], ai = prm.ang[i];
    float m = 0.0f, a = 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c == mi) m = res[c];
      if (c == ai) a = res[c];
    }
    float new_m, new_a;
    couple_step(m, a, new_m, new_a);
#pragma unroll
    for (int c = 0; c < N; ++c) {
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
