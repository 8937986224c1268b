// K1 — floor-1 spectra (Hopper, sm_90a).
//
// Replaces lewton_tpu/ops/floor_kernel.py::floor_spectra_pallas/_kernel in
// all three of its forms: ct_out [C, rows, W] (the i16 path), flat
// [rows, C*W] (the f32 path; the same kernel, only the store index
// differs), and cd_n (the Wang-split i16 path, floor_kernel.py:167-204;
// floor_cd_kernel below). For every packet row and bin w, for all C
// channels:
//
//   1. brackets: lo = sum_p e_p [x_p <= w], hi = sum_p g_p -
//      sum_p g_p [x_p <= w] over the packet's mode segment of P+1 posts;
//   2. exact single-quotient Bresenham index (floor, +-1 remainder
//      correction), clipped to [0, 255];
//   3. inverse dB as the 4-factor product (H1*H0)*(L1*L0), masked by f_used;
//   4. static inverse coupling over the (mag, ang) steps in reverse order;
//   5. spectra = (curve * used) * coupled residue, written [C, rows, W]
//      or [rows, C, W];
//   6. (cd_n only) the split's twiddle rotation of each bin pair
//      (k, N-1-k), N = n1/2, written [C, rows, N] = (c || d). A thread
//      computes both bins of its pairs, so the mirror is a descending
//      index; the rotation's products and sums are rounded separately
//      (__fmul_rn/__fadd_rn/__fsub_rn) as the plain version's torch ops
//      round them. Bins at and past W are zero.
//
// Brackets by prefix sums. The posts of every (mode, channel) are sorted
// (CompiledSetup.f1_xs, pad BIG_X), so [x_p <= w] holds for a prefix of p:
// p < seg(w) = #{p < P : x_p <= w}. The conditional sums over p are then
// the row's prefix sums at seg, PEx[seg] etc., with PEx[k] = sum_{p<k} e_p
// accumulated in p order from 0. A block stages the telescopes of a tile
// of rows in shared memory once; one thread per (row, channel, telescope)
// forms the prefix sums in that order, and hi = G - PG[seg] with G the
// sequential total of all P+1 terms -- the additions of a per-bin loop
// over the posts, in its order, so the brackets are the same bits by
// construction (every partial sum is also an integer below 2^24, which
// makes them equal to the plain version's matmul over the step matrix).
// seg comes from a [M, C, W] uint8 table that the block fills from the
// sorted posts (seg = p on the bins [x_{p-1}, x_p)); a row whose mode is
// outside [0, M) takes seg = 0, as the plain version's one-hot gives. A
// setup whose table exceeds kSegTableBytes falls back to a binary search
// over the row's posts staged in shared memory, once per group of bins,
// then a forward walk (tools/torch_ab_floor_seg.py measures the two).
//
// Per segment, not per bin: the Bresenham terms that are constant between
// two posts (dy, adx = max(hi_x - lo_x, 1), sgn, |dy| and 1/adx) are
// formed once per (row, channel, seg) in the prologue, and a bin takes
// floor(x / adx) from x * (1/adx) with the +-1 remainder correction
// (bresenham_idx_seg, floor_epilogue.cuh: the same integer as the IEEE
// quotient's, so the same bits).
//
// Each thread owns kBins = 4 consecutive bins of one row, all channels:
// the residue is read as one 8-byte (i16) or 16-byte (f32) load per
// channel and the spectra are stored as 16-byte stores, coalesced along w,
// where the row start and W allow; otherwise (W not a multiple of 4, an
// unaligned pointer, a ragged end) scalar, masked accesses. The channel
// count is a template parameter (1..8), so the register arrays have C
// slots and nothing spills. The inverse-dB table lives in shared memory
// (fill_db_table), where a per-thread index does not serialise.
//
// Bound: memory by design. Per output element the kernel reads 2 bytes of
// i16 residue and writes 4 bytes of f32 spectra (352 MB per chunk at the
// headline, ~0.1 ms at 3.35 TB/s); the telescopes add 4 (P+1) floats per
// row and channel (28 MB). What remains between the kernel and that bound
// is instruction issue, not memory: per element the Bresenham index, the
// inverse dB, the coupling and the masked product (PERF.md).
//
// Steps 2-4 are the epilogue shared with K3 (floor_epilogue.cuh), rounded
// exactly as the plain torch version rounds them
// (lewton_tpu_torch/ops/floor_kernel.py::floor_spectra_ref).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "floor_epilogue.cuh"

namespace {

using lt_floor::kMaxC;
using lt_floor::kMaxSteps;
using lt_floor::Params;

constexpr int kThreads = 256;
constexpr int kBins = 4;  // consecutive bins a thread owns
constexpr int kMaxTileRows = 32;
constexpr int kTileItems = 2048;  // (row, bin group) items a block aims at
constexpr size_t kTileBytes = 32 * 1024;  // shared memory a tile aims at
constexpr size_t kSegTableBytes = 16 * 1024;  // largest seg table a block builds
constexpr int kNever = INT_MAX;  // staged x of a post that no bin reaches

// A tile of R rows in shared memory (C channels, P posts, P1 = P + 1):
// sa [R, C, P1] by seg, first the brackets (lo_x, lo_y, hi_x, hi_y), then
// the segment's terms (lo_x, lo_y, adx, 1/adx); tele [R, C, 4, P1] the
// rows' telescopes, whose space then holds sb [R, C, P1] the terms
// (ady, sgn); xs [R, C, P] the row mode's posts (staged only without a
// seg table); used [R, C]; mode [R] (-1 outside [0, M)); seg [M, C, W] the
// setup's seg of every bin, or null: then a bin searches xs.
struct Tile {
  float4* sa;
  float2* sb;
  float* tele;
  int* xs;
  float* used;
  int* mode;
  uint8_t* seg;
};

size_t tile_bytes(int R, int C, int P) {
  const size_t P1 = static_cast<size_t>(P) + 1;
  return static_cast<size_t>(R) * (C * (16 * P1 + 16 * P1 + 4 * P + 4) + 4);
}

// Bytes of the [M, C, W] seg table, 0 when it does not fit kSegTableBytes
// (or a seg does not fit 8 bits): then the kernel searches the posts.
size_t seg_table_bytes(int M, int C, int W, int P) {
  const size_t n = static_cast<size_t>(M) * C * W;
  return P <= 255 && n <= kSegTableBytes ? n : 0;
}

__device__ inline Tile tile_at(float4* smem, int R, int C, int P,
                               bool has_seg) {
  const size_t n = static_cast<size_t>(R) * C * (P + 1);
  Tile t;
  t.sa = smem;
  t.tele = reinterpret_cast<float*>(smem + n);
  t.sb = reinterpret_cast<float2*>(t.tele);
  t.xs = reinterpret_cast<int*>(t.tele + 4 * n);
  t.used = reinterpret_cast<float*>(t.xs + static_cast<size_t>(R) * C * P);
  t.mode = reinterpret_cast<int*>(t.used + static_cast<size_t>(R) * C);
  t.seg = has_seg ? reinterpret_cast<uint8_t*>(t.mode + R) : nullptr;
  return t;
}

// Stage rows [row0, row0 + nrows), the inverse-dB table and the seg
// table (or the rows' posts); form the brackets of every seg, then each
// segment's Bresenham terms. Ends with the block synchronised.
template <int C>
__device__ void stage_tile(const Tile& t, float* db_table,
                           const float* __restrict__ tele,
                           const float* __restrict__ scal,
                           const int* __restrict__ xs, int row0, int nrows,
                           int W, int P, int M, const Params& prm) {
  const int P1 = P + 1;
  lt_floor::fill_db_table(db_table, prm.db);
  // the tile's telescopes are contiguous in tele
  const float* src = tele + static_cast<size_t>(row0) * C * 4 * P1;
  for (int i = threadIdx.x; i < nrows * C * 4 * P1; i += kThreads) {
    t.tele[i] = src[i];
  }
  for (int i = threadIdx.x; i < nrows * C; i += kThreads) {
    const int r = i / C;
    t.used[i] = scal[static_cast<size_t>(row0 + r) * (1 + C) + 1 + i - r * C];
  }
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int mode =
        static_cast<int>(scal[static_cast<size_t>(row0 + r) * (1 + C)]);
    t.mode[r] = mode >= 0 && mode < M ? mode : -1;
  }
  if (t.seg == nullptr) {
    for (int i = threadIdx.x; i < nrows * C * P; i += kThreads) {
      const int r = i / (C * P);
      const int cp = i - r * C * P;  // c * P + p
      const int mode =
          static_cast<int>(scal[static_cast<size_t>(row0 + r) * (1 + C)]);
      t.xs[i] = mode >= 0 && mode < M
                    ? xs[static_cast<size_t>(mode) * C * P + cp]
                    : kNever;
    }
  }
  __syncthreads();
  // prefix sums in p order, one thread per (row, channel, telescope); then
  // the seg table, one thread per (mode, channel, p): seg = p on the bins
  // [x_{p-1}, x_p) between two sorted posts
  const int n_scan = nrows * C * 4;
  const int n_fill = t.seg == nullptr ? 0 : M * C * P1;
  for (int i = threadIdx.x; i < n_scan + n_fill; i += kThreads) {
    if (i >= n_scan) {
      const int mc = (i - n_scan) / P1;
      const int p = i - n_scan - mc * P1;
      const int* x = xs + static_cast<size_t>(mc) * P;
      const int lo = p == 0 ? 0 : min(x[p - 1], W);
      const int hi = p == P ? W : min(x[p], W);
      uint8_t* seg = t.seg + static_cast<size_t>(mc) * W;
      for (int w = lo; w < hi; ++w) seg[w] = static_cast<uint8_t>(p);
      continue;
    }
    const int rc = i >> 2, q = i & 3;
    const float* v = t.tele + static_cast<size_t>(rc) * 4 * P1 + q * P1;
    float* b = reinterpret_cast<float*>(t.sa + static_cast<size_t>(rc) * P1) + q;
    float acc = 0.0f;
    if (q < 2) {  // lo_x, lo_y = sum_{p < seg} e_p
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        b[4 * k] = acc;
        acc = __fadd_rn(acc, v[k]);
      }
      b[4 * P] = acc;
    } else {  // hi_x, hi_y = sum_{p <= P} g_p - sum_{p < seg} g_p
      float total = 0.0f;
#pragma unroll 4
      for (int k = 0; k < P1; ++k) total = __fadd_rn(total, v[k]);
#pragma unroll 4
      for (int k = 0; k < P1; ++k) {
        b[4 * k] = __fsub_rn(total, acc);
        acc = __fadd_rn(acc, v[k]);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nrows * C * P1; k += kThreads) {
    const float4 br = t.sa[k];
    lt_floor::segment_terms(br.x, br.y, br.z, br.w, t.sa[k], t.sb[k]);
  }
  __syncthreads();
}

// #{p < P : xs[p] <= w} for sorted xs.
__device__ __forceinline__ int upper_bound(const int* xs, int P, int w) {
  int lo = 0, n = P;
  while (n > 0) {
    const int half = n >> 1;
    if (xs[lo + half] <= w) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

__device__ __forceinline__ void load_bins(const int16_t* p, float (&v)[kBins]) {
  const short4 q = __ldg(reinterpret_cast<const short4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_bins(const float* p, float (&v)[kBins]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Store v to row[w0 + j] for w0 + j < lim: one 16-byte store when vec
// (row + w0 16-byte aligned) and the group is whole.
__device__ __forceinline__ void store_bins(float* row, int w0, int lim,
                                           bool vec, const float (&v)[kBins]) {
  if (vec && w0 + kBins <= lim) {
    *reinterpret_cast<float4*>(row + w0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      if (w0 + j < lim) row[w0 + j] = v[j];
    }
  }
}

// seg of bins w0 .. w0 + kBins - 1 of tile row r, channel c: read from
// the seg table (one 4-byte read for a whole, aligned group), or by a
// binary search over the row's posts and a forward walk. 0 outside
// [0, W) and for a mode outside [0, M).
template <int C>
__device__ __forceinline__ void group_segs(const Tile& t, int r, int c,
                                           int W, int P, int w0,
                                           int (&seg)[kBins]) {
  if (t.seg != nullptr) {
    const int mode = t.mode[r];
    const uint8_t* tab =
        t.seg + static_cast<size_t>(mode < 0 ? 0 : mode * C + c) * W;
    if (mode >= 0 && ((W | w0) & (kBins - 1)) == 0 && w0 >= 0 &&
        w0 + kBins <= W) {
      const uint32_t q = *reinterpret_cast<const uint32_t*>(tab + w0);
#pragma unroll
      for (int j = 0; j < kBins; ++j) seg[j] = (q >> (8 * j)) & 0xFF;
    } else {
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const int w = w0 + j;
        seg[j] = mode >= 0 && w >= 0 && w < W ? tab[w] : 0;
      }
    }
    return;
  }
  const int* xs = t.xs + (r * C + c) * P;
  int k = upper_bound(xs, P, w0);
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    if (j > 0) {
      while (k < P && xs[k] <= w0 + j) ++k;
    }
    seg[j] = k;
  }
}

// Spectra of bins w0 .. w0 + kBins - 1 of tile row r, all channels:
// s[j][c] for bin w0 + j, exactly +0 outside [0, W). rrow is the row's
// residue [C, W]; vec: 8/16-byte residue loads where the group is whole
// and w0 % 4 == 0 (rows start aligned).
template <int C, typename Res>
__device__ __forceinline__ void group_spectra(
    const Tile& t, const float* db_table, int r, const Res* __restrict__ rrow,
    int W, int P, int w0, bool vec, const Params& prm,
    float (&s)[kBins][C]) {
  if (w0 >= W) {
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) s[j][c] = 0.0f;
    }
    return;
  }
  const bool whole = vec && w0 >= 0 && (w0 & (kBins - 1)) == 0 &&
                     w0 + kBins <= W;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const Res* p = rrow + static_cast<size_t>(c) * W;
    float v[kBins];
    if (whole) {
      load_bins(p + w0, v);
    } else {
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const int w = w0 + j;
        v[j] = w >= 0 && w < W ? static_cast<float>(p[w]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBins; ++j) s[j][c] = v[j];
  }
#pragma unroll
  for (int j = 0; j < kBins; ++j) lt_floor::inverse_coupling(s[j], prm);

  const float* used = t.used + r * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float4* sa = t.sa + (r * C + c) * (P + 1);
    const float2* sb = t.sb + (r * C + c) * (P + 1);
    int seg[kBins];
    group_segs<C>(t, r, c, W, P, w0, seg);
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int w = w0 + j;
      const float idx = lt_floor::bresenham_idx_seg(sa[seg[j]], sb[seg[j]],
                                                    static_cast<float>(w));
      const float curve =
          __fmul_rn(db_table[static_cast<int>(idx)], used[c]);
      s[j][c] = w >= 0 && w < W ? __fmul_rn(curve, s[j][c]) : 0.0f;
    }
  }
}

// ct_out / flat: a block owns R consecutive rows and all their bins; one
// thread = kBins bins of one row, all channels. Rows are the flattened
// (stream, packet) axis.
template <int C, typename Res>
__global__ void __launch_bounds__(kThreads)
floor_spectra_kernel(const float* __restrict__ tele,
                     const Res* __restrict__ residue,
                     const float* __restrict__ scal,
                     const int* __restrict__ xs, float* __restrict__ out,
                     int rows, int W, int P, int M, int R, int has_seg,
                     int ct_out, int vec_in, int vec_out,
                     const __grid_constant__ Params prm) {
  extern __shared__ float4 smem[];
  __shared__ float db_table[256];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const Tile t = tile_at(smem, R, C, P, has_seg);
  stage_tile<C>(t, db_table, tele, scal, xs, row0, nrows, W, P, M, prm);

  const int G = (W + kBins - 1) / kBins;
  for (int i = threadIdx.x; i < nrows * G; i += kThreads) {
    const int r = i / G;
    const int w0 = (i - r * G) * kBins;
    const int row = row0 + r;
    float s[kBins][C];
    group_spectra<C>(t, db_table, r,
                     residue + static_cast<size_t>(row) * C * W, W, P, w0,
                     vec_in, prm, s);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t o = ct_out ? static_cast<size_t>(c) * rows + row
                              : static_cast<size_t>(row) * C + c;
      const float v[kBins] = {s[0][c], s[1][c], s[2][c], s[3][c]};
      store_bins(out + o * W, w0, W, vec_out, v);
    }
  }
}

// The cd_n form: one thread = the kBins pairs (k, N-1-k) for k in
// [k0, k0 + kBins), k < H = N/2, all channels -- every bin of [0, N)
// belongs to exactly one pair, so each is computed once -- writing the
// Wang-split rotation
//   c_k = cos_k x_k + sin_k x_{N-1-k},  d_k = cos_k x_{N-1-k} - sin_k x_k
// to [C, rows, N] = (c || d), x zero at and past W. The mirrored bins
// N-1-k are the ascending group N-kBins-k0 .. N-1-k0, read reversed.
template <int C, typename Res>
__global__ void __launch_bounds__(kThreads)
floor_cd_kernel(const float* __restrict__ tele,
                const Res* __restrict__ residue,
                const float* __restrict__ scal, const int* __restrict__ xs,
                const float* __restrict__ tw, float* __restrict__ out,
                int rows, int W, int P, int M, int N, int R, int has_seg,
                int vec_in, int vec_out, const __grid_constant__ Params prm) {
  extern __shared__ float4 smem[];
  __shared__ float db_table[256];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const Tile t = tile_at(smem, R, C, P, has_seg);
  stage_tile<C>(t, db_table, tele, scal, xs, row0, nrows, W, P, M, prm);

  const int H = N / 2;
  const int G = (H + kBins - 1) / kBins;
  for (int i = threadIdx.x; i < nrows * G; i += kThreads) {
    const int r = i / G;
    const int k0 = (i - r * G) * kBins;
    const int row = row0 + r;
    const Res* rrow = residue + static_cast<size_t>(row) * C * W;
    float a[kBins][C], b[kBins][C];
    group_spectra<C>(t, db_table, r, rrow, W, P, k0, vec_in, prm, a);
    group_spectra<C>(t, db_table, r, rrow, W, P, N - kBins - k0, vec_in, prm,
                     b);
    float ct[kBins], st[kBins];
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int k = min(k0 + j, H - 1);
      ct[j] = __ldg(tw + k);
      st[j] = __ldg(tw + H + k);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float cv[kBins], dv[kBins];
#pragma unroll
      for (int j = 0; j < kBins; ++j) {
        const float x = a[j][c], y = b[kBins - 1 - j][c];
        cv[j] = __fadd_rn(__fmul_rn(ct[j], x), __fmul_rn(st[j], y));
        dv[j] = __fsub_rn(__fmul_rn(ct[j], y), __fmul_rn(st[j], x));
      }
      float* o = out + (static_cast<size_t>(c) * rows + row) * N;
      store_bins(o, k0, H, vec_out, cv);
      store_bins(o + H, k0, H, vec_out, dv);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A launch's tile: R rows (about kTileItems items of G bin groups a row,
// at most kMaxTileRows, within kTileBytes of shared memory with the seg
// table, one row at least whatever it needs) and its dynamic shared bytes.
struct Plan {
  int R;
  size_t seg;  // seg table bytes, 0: search the posts
  size_t smem;
};

Plan plan(int C, int P, int M, int W, int G) {
  Plan pl;
  pl.seg = seg_table_bytes(M, C, W, P);
  int R = (kTileItems + G - 1) / G;
  R = R < 1 ? 1 : (R > kMaxTileRows ? kMaxTileRows : R);
  while (R > 1 && tile_bytes(R, C, P) + pl.seg > kTileBytes) --R;
  pl.R = R;
  pl.smem = tile_bytes(R, C, P) + pl.seg;
  return pl;
}

// Calls f(std::integral_constant<int, C>) for C in 1..kMaxC.
template <class F>
int with_channels(int C, F&& f) {
  switch (C) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Allow `bytes` of dynamic shared memory for kernel k (above the 48 KB a
// launch gets without asking).
cudaError_t allow_smem(const void* k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The kernel of one (form, C, residue type).
template <int C, typename Res>
const void* kernel_of(int cd) {
  return cd ? reinterpret_cast<const void*>(floor_cd_kernel<C, Res>)
            : reinterpret_cast<const void*>(floor_spectra_kernel<C, Res>);
}

bool bad_args(int rows, int C, int W, int P, int M, int n_steps) {
  return C < 1 || C > kMaxC || n_steps < 0 || n_steps > kMaxSteps ||
         rows < 1 || W < 1 || P < 1 || M < 1;
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
  if (bad_args(rows, C, W, P, M, n_steps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  lt_floor::fill_params(&prm, n_steps, steps, db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tele);
  const float* sc = static_cast<const float*>(scal);
  const int* x = static_cast<const int*>(xs);
  float* o = static_cast<float*>(out);
  const int G = (W + kBins - 1) / kBins;
  const int vec_in = W % kBins == 0 && aligned16(residue) ? 1 : 0;
  const int vec_out = W % kBins == 0 && aligned16(out) ? 1 : 0;
  return with_channels(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    const Plan pl = plan(kC, P, M, W, G);
    const dim3 grid((rows + pl.R - 1) / pl.R);
    auto launch = [&](auto kernel, const auto* res) {
      cudaError_t e =
          allow_smem(reinterpret_cast<const void*>(kernel), pl.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, kThreads, pl.smem, s>>>(t, res, sc, x, o, rows, W, P, M,
                                             pl.R, pl.seg != 0, ct_out,
                                             vec_in, vec_out, prm);
      return static_cast<int>(cudaGetLastError());
    };
    return residue_is_i16
               ? launch(floor_spectra_kernel<kC, int16_t>,
                        static_cast<const int16_t*>(residue))
               : launch(floor_spectra_kernel<kC, float>,
                        static_cast<const float*>(residue));
  });
}

// The cd_n form: tw is a device pointer to [2, N/2] f32 (cos, sin of the
// twiddle angles); out [C, rows, N] = (c || d). Needs W <= N, N even.
extern "C" int lt_floor_spectra_cd(const void* tele, const void* residue,
                                   int residue_is_i16, const void* scal,
                                   const void* xs, const void* tw, void* out,
                                   int rows, int C, int W, int P, int M,
                                   int N, int n_steps, const int* steps,
                                   const float* db, void* stream) {
  if (bad_args(rows, C, W, P, M, n_steps) || N < 2 || N % 2 != 0 || W > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  lt_floor::fill_params(&prm, n_steps, steps, db);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tele);
  const float* sc = static_cast<const float*>(scal);
  const int* x = static_cast<const int*>(xs);
  const float* w = static_cast<const float*>(tw);
  float* o = static_cast<float*>(out);
  const int H = N / 2;
  const int G = (H + kBins - 1) / kBins;
  const int vec_in = W % kBins == 0 && aligned16(residue) ? 1 : 0;
  const int vec_out = H % kBins == 0 && aligned16(out) ? 1 : 0;
  return with_channels(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    const Plan pl = plan(kC, P, M, W, G);
    const dim3 grid((rows + pl.R - 1) / pl.R);
    auto launch = [&](auto kernel, const auto* res) {
      cudaError_t e =
          allow_smem(reinterpret_cast<const void*>(kernel), pl.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, kThreads, pl.smem, s>>>(t, res, sc, x, w, o, rows, W, P,
                                             M, N, pl.R, pl.seg != 0, vec_in,
                                             vec_out, prm);
      return static_cast<int>(cudaGetLastError());
    };
    return residue_is_i16
               ? launch(floor_cd_kernel<kC, int16_t>,
                        static_cast<const int16_t*>(residue))
               : launch(floor_cd_kernel<kC, float>,
                        static_cast<const float*>(residue));
  });
}

// What the compiler made of one instantiation, launched on rows of W bins
// (N for the cd_n form; ignored otherwise), P posts and M modes: out[0..7]
// = registers a thread, local (spill) bytes a thread, max threads a block,
// static shared bytes, resident blocks a multiprocessor at the launch's
// dynamic shared memory, that dynamic shared memory in bytes, tile rows,
// seg table bytes (0: the kernel searches the posts). Returns a
// cudaError_t.
extern "C" int lt_floor_kernel_attrs(int cd, int C, int residue_is_i16,
                                     int W, int N, int P, int M, int* out) {
  if (W < 1 || P < 1 || M < 1 || (cd && N < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return with_channels(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    const void* k = residue_is_i16 ? kernel_of<kC, int16_t>(cd)
                                   : kernel_of<kC, float>(cd);
    const int G = cd ? (N / 2 + kBins - 1) / kBins : (W + kBins - 1) / kBins;
    const Plan pl = plan(kC, P, M, W, G);
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess) e = allow_smem(k, pl.smem);
    int blocks = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                        pl.smem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = a.maxThreadsPerBlock;
    out[3] = static_cast<int>(a.sharedSizeBytes);
    out[4] = blocks;
    out[5] = static_cast<int>(pl.smem);
    out[6] = pl.R;
    out[7] = static_cast<int>(pl.seg);
    return 0;
  });
}
