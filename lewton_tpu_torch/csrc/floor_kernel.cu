// K1 — floor-1 spectra (Hopper, sm_90a).
//
// Replaces lewton_tpu/ops/floor_kernel.py::floor_spectra_pallas/_kernel in
// all three of its forms: ct_out [C, rows, W] (the i16 path), flat
// [rows, C*W] (the f32 path; the same kernel, only the store index
// differs), and cd_n (the Wang-split i16 path, floor_kernel.py:167-204;
// floor_cd_kernel below). For every packet row and bin w, for all C
// channels:
//
//   1. bracket contraction: lo = sum_p e_p [x_p <= w], hi = sum_p g_p -
//      sum_p g_p [x_p <= w] over the packet's mode segment of P+1 posts;
//   2. exact single-quotient Bresenham index (IEEE division, floor, +-1
//      remainder correction), clipped to [0, 255];
//   3. inverse dB as the 4-factor product (H1*H0)*(L1*L0), masked by f_used;
//   4. static inverse coupling over the (mag, ang) steps in reverse order;
//   5. spectra = (curve * used) * coupled residue, written [C, rows, W]
//      or [rows, C, W];
//   6. (cd_n only) the split's twiddle rotation of each bin pair
//      (k, N-1-k), N = n1/2, written [C, rows, N] = (c || d). On the TPU
//      the mirrored operand came from a lane-reversal network
//      (_rev_lanes); here a thread computes both bins of its pair, so the
//      mirror is an index. The rotation's products and sums are rounded
//      separately (__fmul_rn/__fadd_rn/__fsub_rn) as the plain version's
//      torch ops round them. Its bound is the same as K1's: 2 bytes read
//      and 4 written per element, plus the N - W zero bins it writes.
//
// Bound: memory by design. Per output element the kernel reads 2 bytes of
// i16 residue and writes 4 bytes of f32 spectra (352 MB per chunk at the
// headline, ~0.1 ms at 3.35 TB/s); the telescopes (4 (P+1) floats per row
// and channel), the [M, C, P] post table and the scalars are small and
// shared by all bins of a row, so they come from L1/L2. Measured on an
// H100 (PERF.md), the P+1-step contraction loop below, not memory, sets
// the time today: 3.39 ms per headline chunk. Cheaper contraction (prefix
// sums over the sorted posts, rows staged in shared memory) is the lever.
//
// Why the contraction is a register loop and not a tensor-core product: the
// depth is K = M (P+1) = 54 in the flagship setup, and only the P+1 = 27
// terms of the packet's own mode are nonzero. A tensor-core product would
// stream the [C, M (P+1), W] 0/1 step matrix and a mode-folded operand at
// 2x the depth that matters, for an output that an in-register loop over
// the sorted post table produces with no extra device-memory traffic. The
// step entry [x_p <= w] is evaluated from the post table itself (the same
// function as the step matrix). Every partial sum is an integer below 2^24,
// so any summation order is exact and the result is bit-identical to the
// plain version's matmul.
//
// Steps 2-4 are the epilogue shared with K3 (floor_epilogue.cuh), rounded
// exactly as the plain torch version rounds them
// (lewton_tpu_torch/ops/floor_kernel.py::floor_spectra_ref).

#include <cuda_runtime.h>
#include <stdint.h>

#include "floor_epilogue.cuh"

namespace {

using lt_floor::kMaxC;
using lt_floor::kMaxSteps;
using lt_floor::Params;
constexpr int kBlockW = 128;
constexpr int kBlockRows = 2;

// Coupled spectra x[c] = curve * residue of bin w of one packet row, all
// channels (coupling mixes channels of the same packet); zero for w >= W.
template <typename Res>
__device__ __forceinline__ void bin_spectra(
    const float* __restrict__ trow, const Res* __restrict__ rrow,
    const float* __restrict__ srow, const int* __restrict__ xs, int C, int W,
    int P, int M, int w, const Params& prm, float (&x)[kMaxC]) {
  if (w >= W) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) x[c] = 0.0f;
    return;
  }
  const int P1 = P + 1;
  const int mode = static_cast<int>(srow[0]);
  const bool mode_ok = mode >= 0 && mode < M;
  const float wf = static_cast<float>(w);

  float curve[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const float* ex = trow + c * 4 * P1;
      const float* ey = ex + P1;
      const float* gx = ey + P1;
      const float* gy = gx + P1;
      const int* xrow = xs + (static_cast<size_t>(mode_ok ? mode : 0) * C + c) * P;
      float lo_x = 0.0f, lo_y = 0.0f, gxc = 0.0f, gyc = 0.0f;
      float gx_full = 0.0f, gy_full = 0.0f;
      for (int p = 0; p < P1; ++p) {
        const float gxp = __ldg(gx + p), gyp = __ldg(gy + p);
        gx_full = __fadd_rn(gx_full, gxp);
        gy_full = __fadd_rn(gy_full, gyp);
        // the virtual tail post (p == P) has no x: its step row is zero
        if (mode_ok && p < P && __ldg(xrow + p) <= w) {
          lo_x = __fadd_rn(lo_x, __ldg(ex + p));
          lo_y = __fadd_rn(lo_y, __ldg(ey + p));
          gxc = __fadd_rn(gxc, gxp);
          gyc = __fadd_rn(gyc, gyp);
        }
      }
      const float idx = lt_floor::bresenham_idx(
          lo_x, lo_y, __fsub_rn(gx_full, gxc), __fsub_rn(gy_full, gyc), wf);
      curve[c] = __fmul_rn(lt_floor::db_value(idx, prm.db), srow[1 + c]);
      x[c] = static_cast<float>(rrow[static_cast<size_t>(c) * W + w]);
    } else {
      curve[c] = 0.0f;
      x[c] = 0.0f;
    }
  }

  lt_floor::inverse_coupling(x, prm);

#pragma unroll
  for (int c = 0; c < kMaxC; ++c) x[c] = __fmul_rn(curve[c], x[c]);
}

// One thread = one (row, bin) for all channels. Rows are the flattened
// (stream, packet) axis.
template <typename Res>
__global__ void __launch_bounds__(kBlockW * kBlockRows)
floor_spectra_kernel(const float* __restrict__ tele,
                     const Res* __restrict__ residue,
                     const float* __restrict__ scal,
                     const int* __restrict__ xs,
                     float* __restrict__ out, int rows, int C, int W, int P,
                     int M, int ct_out,
                     const __grid_constant__ Params prm) {
  const int row = blockIdx.x * kBlockRows + threadIdx.y;
  const int w = blockIdx.y * kBlockW + threadIdx.x;
  if (row >= rows || w >= W) return;
  float x[kMaxC];
  bin_spectra(tele + static_cast<size_t>(row) * C * 4 * (P + 1),
              residue + static_cast<size_t>(row) * C * W,
              scal + static_cast<size_t>(row) * (1 + C), xs, C, W, P, M, w,
              prm, x);
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      const size_t o = ct_out ? static_cast<size_t>(c) * rows + row
                              : static_cast<size_t>(row) * C + c;
      out[o * W + w] = x[c];
    }
  }
}

// The cd_n form: one thread = one (row, k < H) for all channels. It owns
// the bin pair (k, N-1-k) -- every bin of [0, N) belongs to exactly one
// pair, so each is computed once -- and writes the Wang-split rotation
//   c_k = cos_k x_k + sin_k x_{N-1-k},  d_k = cos_k x_{N-1-k} - sin_k x_k
// to [C, rows, N] = (c || d), x zero at and past W.
template <typename Res>
__global__ void __launch_bounds__(kBlockW * kBlockRows)
floor_cd_kernel(const float* __restrict__ tele,
                const Res* __restrict__ residue,
                const float* __restrict__ scal, const int* __restrict__ xs,
                const float* __restrict__ tw, float* __restrict__ out,
                int rows, int C, int W, int P, int M, int N,
                const __grid_constant__ Params prm) {
  const int row = blockIdx.x * kBlockRows + threadIdx.y;
  const int k = blockIdx.y * kBlockW + threadIdx.x;
  const int H = N / 2;
  if (row >= rows || k >= H) return;
  const float* trow = tele + static_cast<size_t>(row) * C * 4 * (P + 1);
  const Res* rrow = residue + static_cast<size_t>(row) * C * W;
  const float* srow = scal + static_cast<size_t>(row) * (1 + C);
  float a[kMaxC], b[kMaxC];
  bin_spectra(trow, rrow, srow, xs, C, W, P, M, k, prm, a);
  bin_spectra(trow, rrow, srow, xs, C, W, P, M, N - 1 - k, prm, b);
  const float ct = tw[k], st = tw[H + k];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c < C) {
      float* o = out + (static_cast<size_t>(c) * rows + row) * N;
      o[k] = __fadd_rn(__fmul_rn(ct, a[c]), __fmul_rn(st, b[c]));
      o[H + k] = __fsub_rn(__fmul_rn(ct, b[c]), __fmul_rn(st, a[c]));
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). Pointers are device pointers except
// `steps` (host, 2 * n_steps ints: mag0, ang0, mag1, ...) and `db` (host, 16
// floats). out is [C, rows, W] when ct_out is nonzero, else [rows, C, W].
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int lt_floor_spectra(const void* tele, const void* residue,
                                int residue_is_i16, const void* scal,
                                const void* xs, void* out, int rows, int C,
                                int W, int P, int M, int n_steps,
                                const int* steps, const float* db,
                                int ct_out, void* stream) {
  if (C < 1 || C > kMaxC || n_steps < 0 || n_steps > kMaxSteps || rows < 1 ||
      W < 1 || P < 1 || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  lt_floor::fill_params(&prm, n_steps, steps, db);
  const dim3 block(kBlockW, kBlockRows);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, (W + kBlockW - 1) / kBlockW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tele);
  const float* sc = static_cast<const float*>(scal);
  const int* x = static_cast<const int*>(xs);
  float* o = static_cast<float*>(out);
  if (residue_is_i16) {
    floor_spectra_kernel<int16_t><<<grid, block, 0, s>>>(
        t, static_cast<const int16_t*>(residue), sc, x, o, rows, C, W, P, M,
        ct_out, prm);
  } else {
    floor_spectra_kernel<float><<<grid, block, 0, s>>>(
        t, static_cast<const float*>(residue), sc, x, o, rows, C, W, P, M,
        ct_out, prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// The cd_n form: tw is a device pointer to [2, N/2] f32 (cos, sin of the
// twiddle angles); out [C, rows, N] = (c || d). Needs W <= N, N even.
extern "C" int lt_floor_spectra_cd(const void* tele, const void* residue,
                                   int residue_is_i16, const void* scal,
                                   const void* xs, const void* tw, void* out,
                                   int rows, int C, int W, int P, int M,
                                   int N, int n_steps, const int* steps,
                                   const float* db, void* stream) {
  if (C < 1 || C > kMaxC || n_steps < 0 || n_steps > kMaxSteps || rows < 1 ||
      W < 1 || P < 1 || M < 1 || N < 2 || N % 2 != 0 || W > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  lt_floor::fill_params(&prm, n_steps, steps, db);
  const int H = N / 2;
  const dim3 block(kBlockW, kBlockRows);
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, (H + kBlockW - 1) / kBlockW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tele);
  const float* sc = static_cast<const float*>(scal);
  const int* x = static_cast<const int*>(xs);
  const float* w = static_cast<const float*>(tw);
  float* o = static_cast<float*>(out);
  if (residue_is_i16) {
    floor_cd_kernel<int16_t><<<grid, block, 0, s>>>(
        t, static_cast<const int16_t*>(residue), sc, x, w, o, rows, C, W, P,
        M, N, prm);
  } else {
    floor_cd_kernel<float><<<grid, block, 0, s>>>(
        t, static_cast<const float*>(residue), sc, x, w, o, rows, C, W, P, M,
        N, prm);
  }
  return static_cast<int>(cudaGetLastError());
}
