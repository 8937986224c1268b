// K2 — windowed overlap-add + i16 conversion for the i16 synthesis paths
// (Hopper, sm_90a).
//
// Replaces lewton_tpu/ops/overlap_kernel.py::overlap_i16_pallas in its
// three input forms, each a source of IMDCT output rows below:
//
//   - X form (_kernel_x with ct_in, the main path): the half-width DCT-IV
//     X (length M = n/2) per blocksize, channel-major [C, rows, M]; the
//     IMDCT output is audio[0:M/2] = X[M/2:], audio[M/2:3M/2] = -rev(X),
//     audio[3M/2:2M] = -X[:M/2] -- rev(X) is a mirrored index here;
//   - split form (_kernel_x with split_in, the Wang-split path): the long
//     X arrives as the split halves U, V [C, rows, M/2] and each X_i is
//     rebuilt where it is read: X_0 = U_0, X_{2j-1} = U_j - V_{j-1},
//     X_{2j} = U_j + V_{j-1}, X_{M-1} = -V_{M/2-1}; the short X as above;
//   - audio form (_kernel, a caller-supplied IMDCT): the IMDCT output
//     itself, [C, rows, n] (ct_in) or [rows, C, n], either un-selected
//     (long rows of n1 and short rows of n0) or pre-selected (one [.., n1]
//     input whose short rows hold their n0 samples first).
//
// Per packet row of each stream and channel:
//
//   1. select long or short per blockflag, with the lapped-start shift for
//      a long block after a short one;
//   2. take the previous packet's right region (long&next, the short window
//      centred in a long block, or short), read from row t-1 of the same
//      stream in device memory; row 0 of the chunk uses the carried pwr0;
//   3. mix a*lhs + pwr*rhs over the overlap length, zero past out_len,
//      x32768, clamp to [-32768, 32767], truncate toward zero, i16;
//   4. carry: the right region of the stream's last valid packet (valid
//      packets are a chunk prefix), or pwr0 when the chunk has none.
//
// Bound: memory. Per output sample it reads the input once for the current
// row and once more as the next row's "previous" row (mostly an L2 hit),
// and writes 2 bytes of i16; the arithmetic is two products and a sum (one
// more add per X value in the split form). At the headline the X form
// moves ~0.5 GB per chunk, ~0.15 ms at 3.35 TB/s; measured 0.66 ms on an
// H100 (PERF.md), so there is room in the access pattern. The Mosaic
// workarounds of the TPU kernel (the roll-network and MXU lane reversals,
// _shuffle_zip/_combine_split, the XLA-side flip) are not used: the
// mirrored regions and the split's interleave are index arithmetic in the
// sources' at().
//
// No state crosses blocks: a block owns (stream, channel, rows) and reads
// the previous row straight from its input, so blocks run in any order.
//
// Rounding matches the plain torch versions
// (lewton_tpu_torch/ops/overlap_kernel.py): the split combine is one add or
// sub per X value, the mix's products and sum are separately rounded
// (__fmul_rn/__fadd_rn, --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kScal = 13;  // per-packet scalar columns (windowing.py map)

// Element i in [0, 2h) of the IMDCT output rebuilt from a DCT-IV row x of
// length h (x(j) its element j).
template <class XRow>
__device__ __forceinline__ float mirror_at(const XRow& x, int h, int i) {
  const int q = h / 2;
  if (i < q) return x(q + i);
  if (i < 3 * q) return -x(3 * q - 1 - i);
  return -x(i - 3 * q);
}

// X form: DCT-IV rows [C, rows, h].
struct XSource {
  const float* x;
  int h;
  size_t rows;
  struct Row {
    const float* p;
    int h;
    __device__ float operator()(int j) const { return p[j]; }
    __device__ float at(int i) const { return mirror_at(*this, h, i); }
  };
  __device__ Row row(int c, size_t r) const {
    return Row{x + (static_cast<size_t>(c) * rows + r) * h, h};
  }
};

// Split form: the Wang-split halves U, V [C, rows, h/2] of the long X.
struct SplitSource {
  const float* u;
  const float* v;
  int h;  // the X length M; U and V hold M/2 values per row
  size_t rows;
  struct Row {
    const float* u;
    const float* v;
    int h;
    __device__ float operator()(int j) const {
      if (j == 0) return u[0];
      const int q = (j + 1) >> 1;  // j = 2q - 1 (odd) or 2q (even)
      if (j & 1) {
        return q == h / 2 ? -v[q - 1] : __fsub_rn(u[q], v[q - 1]);
      }
      return __fadd_rn(u[q], v[q - 1]);
    }
    __device__ float at(int i) const { return mirror_at(*this, h, i); }
  };
  __device__ Row row(int c, size_t r) const {
    const size_t o = (static_cast<size_t>(c) * rows + r) * (h / 2);
    return Row{u + o, v + o, h};
  }
};

// Audio form: IMDCT output rows, element (r, c, i) at
// a[r * row_stride + c * chan_stride + i].
struct AudioSource {
  const float* a;
  size_t row_stride;
  size_t chan_stride;
  struct Row {
    const float* p;
    __device__ float at(int i) const { return p[i]; }
  };
  __device__ Row row(int c, size_t r) const {
    return Row{a + r * row_stride + static_cast<size_t>(c) * chan_stride};
  }
};

// Right region element j (j < M) of a packet of class (is_l, is_m):
// long&next [M, 2M) of the long output; long&!next the short window
// centred in the long output; short [m, 2m) of the short output (of the
// pre-selected row when there is no short input). Zero past the short
// width for the last two.
template <class LRow, class SRow>
__device__ __forceinline__ float right_region(const LRow& l, const SRow& s,
                                              bool has_short, bool is_l,
                                              bool is_m, int M, int m,
                                              int m_start, int j) {
  if (is_l) return l.at(M + j);
  if (j >= m) return 0.0f;
  if (is_m) return l.at(m_start + j);
  if (!has_short) return l.at(m + j);
  return s.at(m + j);
}

template <class LongSrc, class ShortSrc>
__global__ void __launch_bounds__(kThreads)
overlap_i16_kernel(const LongSrc src_l, const ShortSrc src_s, bool has_short,
                   const float* __restrict__ scal,
                   const float* __restrict__ slopes,
                   const float* __restrict__ pwr0, int16_t* __restrict__ out,
                   float* __restrict__ pwr_out, int S, int T, int C, int n0,
                   int n1) {
  const int s = blockIdx.z;
  const int c = blockIdx.y;
  const int M = n1 / 2;  // long DCT-IV length == W, the overlap width
  const int m = n0 / 2;  // short DCT-IV length
  const int outw = 3 * n1 / 4;
  const int ls = (n1 - n0) / 4;
  const int m_start = (3 * n1 - n0) / 4;
  const float* slope0 = slopes;
  const float* slope1 = slopes + M;
  const float* rev0 = slopes + 2 * M;
  const float* rev1 = slopes + 3 * M;
  const float* p0 = pwr0 + (static_cast<size_t>(s) * C + c) * M;
  float* pout = pwr_out + (static_cast<size_t>(s) * C + c) * M;

  for (int r = 0; r < kRows; ++r) {
    const int t = blockIdx.x * kRows + r;
    if (t >= T) break;
    const size_t row = static_cast<size_t>(s) * T + t;
    const float* sc = scal + row * kScal;
    const bool use_s1 = sc[0] > 0.0f, use_r1 = sc[1] > 0.0f;
    const bool ls_on = sc[2] > 0.0f;
    const bool pl_is_l = sc[3] > 0.0f, pl_is_m = sc[4] > 0.0f;
    const bool first = t == 0 || sc[5] > 0.0f;
    const float ov_len = sc[6], out_len = sc[7];
    const bool long_blk = sc[8] > 0.0f;
    // previous packet of the same stream (never read for the chunk's row 0)
    const size_t prev = first ? row : row - 1;
    const auto lr = src_l.row(c, row);
    const auto lp = src_l.row(c, prev);
    using SRow = typename ShortSrc::Row;
    const SRow sr = has_short ? src_s.row(c, row) : SRow{};
    const SRow sp = has_short ? src_s.row(c, prev) : SRow{};
    int16_t* orow = out + row * (static_cast<size_t>(C) * outw) +
                    static_cast<size_t>(c) * outw;

    for (int j = threadIdx.x; j < outw; j += kThreads) {
      float a;
      if (long_blk || !has_short) {
        a = lr.at(ls_on ? j + ls : j);
      } else {
        a = j < 2 * m ? sr.at(j) : 0.0f;
      }
      float v = a;
      if (j < M && static_cast<float>(j) < ov_len) {
        const float lhs = use_s1 ? slope1[j] : slope0[j];
        const float rhs = use_r1 ? rev1[j] : rev0[j];
        const float pwr =
            first ? p0[j]
                  : right_region(lp, sp, has_short, pl_is_l, pl_is_m, M, m,
                                 m_start, j);
        v = __fadd_rn(__fmul_rn(a, lhs), __fmul_rn(pwr, rhs));
      }
      if (!(static_cast<float>(j) < out_len)) v = 0.0f;
      const float scaled =
          fminf(fmaxf(__fmul_rn(v, 32768.0f), -32768.0f), 32767.0f);
      orow[j] = static_cast<int16_t>(truncf(scaled));
    }

    // carry: this row is the stream's last valid packet, or the chunk has
    // no valid packet at all (then row 0 passes pwr0 through)
    const bool valid = sc[9] > 0.0f;
    const bool next_valid = t + 1 < T && sc[kScal + 9] > 0.0f;
    if (valid && !next_valid) {
      const bool cur_is_l = sc[10] > 0.0f, cur_is_m = sc[11] > 0.0f;
      for (int j = threadIdx.x; j < M; j += kThreads) {
        pout[j] = right_region(lr, sr, has_short, cur_is_l, cur_is_m, M, m,
                               m_start, j);
      }
    } else if (t == 0 && !valid) {
      for (int j = threadIdx.x; j < M; j += kThreads) pout[j] = p0[j];
    }
  }
}

bool bad_geometry(int S, int T, int C, int n0, int n1) {
  return S < 1 || T < 1 || C < 1 || C > 65535 || S > 65535 || n0 < 4 ||
         n1 < n0 || n0 % 4 != 0 || n1 % 4 != 0;
}

template <class LongSrc, class ShortSrc>
int launch(const LongSrc& l, const ShortSrc& s, bool has_short,
           const void* scal, const void* slopes, const void* pwr0, void* out,
           void* pwr_out, int S, int T, int C, int n0, int n1, void* stream) {
  const dim3 grid((T + kRows - 1) / kRows, C, S);
  overlap_i16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      l, s, has_short, static_cast<const float*>(scal),
      static_cast<const float*>(slopes), static_cast<const float*>(pwr0),
      static_cast<int16_t*>(out), static_cast<float*>(pwr_out), S, T, C, n0,
      n1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes); all pointers are device pointers. The
// short input may be null: n0 == n1 in the X and split forms, pre-selected
// audio in the audio form. Common shapes: scal [S*T, 13], slopes
// [4, n1/2], pwr0 [S, C, n1/2]; out i16 [S*T, C*3n1/4], pwr_out
// [S, C, n1/2]. Each returns cudaGetLastError() after the launch
// (0 = success).

// X form: x_long [C, S*T, n1/2], x_short [C, S*T, n0/2].
extern "C" int lt_overlap_i16(const void* x_long, const void* x_short,
                              const void* scal, const void* slopes,
                              const void* pwr0, void* out, void* pwr_out,
                              int S, int T, int C, int n0, int n1,
                              void* stream) {
  if (bad_geometry(S, T, C, n0, n1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t rows = static_cast<size_t>(S) * T;
  return launch(XSource{static_cast<const float*>(x_long), n1 / 2, rows},
                XSource{static_cast<const float*>(x_short), n0 / 2, rows},
                x_short != nullptr, scal, slopes, pwr0, out, pwr_out, S, T, C,
                n0, n1, stream);
}

// Split form: u, v [C, S*T, n1/4], x_short [C, S*T, n0/2].
extern "C" int lt_overlap_i16_split(const void* u, const void* v,
                                    const void* x_short, const void* scal,
                                    const void* slopes, const void* pwr0,
                                    void* out, void* pwr_out, int S, int T,
                                    int C, int n0, int n1, void* stream) {
  if (bad_geometry(S, T, C, n0, n1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t rows = static_cast<size_t>(S) * T;
  return launch(SplitSource{static_cast<const float*>(u),
                            static_cast<const float*>(v), n1 / 2, rows},
                XSource{static_cast<const float*>(x_short), n0 / 2, rows},
                x_short != nullptr, scal, slopes, pwr0, out, pwr_out, S, T, C,
                n0, n1, stream);
}

// Audio form: long [C, S*T, n1] (ct_in) or [S*T, C, n1], short the same
// with n0 columns, or null when long is pre-selected.
extern "C" int lt_overlap_i16_audio(const void* long_a, const void* short_a,
                                    const void* scal, const void* slopes,
                                    const void* pwr0, void* out,
                                    void* pwr_out, int S, int T, int C,
                                    int n0, int n1, int ct_in, void* stream) {
  if (bad_geometry(S, T, C, n0, n1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t rows = static_cast<size_t>(S) * T;
  auto src = [&](const void* p, int n) {
    const size_t nn = static_cast<size_t>(n);
    return ct_in ? AudioSource{static_cast<const float*>(p), nn, rows * nn}
                 : AudioSource{static_cast<const float*>(p), C * nn, nn};
  };
  return launch(src(long_a, n1), src(short_a, n0), short_a != nullptr, scal,
                slopes, pwr0, out, pwr_out, S, T, C, n0, n1, stream);
}
