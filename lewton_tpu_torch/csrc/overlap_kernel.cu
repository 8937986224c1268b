// K2 — windowed overlap-add + i16 conversion for the i16 synthesis paths
// (Hopper, sm_90a).
//
// Replaces lewton_tpu/ops/overlap_kernel.py::overlap_i16_pallas in its
// three input forms, each a source of IMDCT output rows below:
//
//   - X form (_kernel_x with ct_in, the main path): the half-width DCT-IV
//     X (length M = n/2) per blocksize, channel-major [C, rows, M]; the
//     IMDCT output is audio[0:M/2] = X[M/2:], audio[M/2:3M/2] = -rev(X),
//     audio[3M/2:2M] = -X[:M/2] -- rev(X) is a descending index here;
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
// Design. A block owns a tile of R rows of one (stream, channel) -- R
// chosen so that a tile holds about 3 groups a thread -- and reads row
// t-1 as the "previous" row straight from its input (for all but the
// tile's first row the block has just read it, so it comes from L1/L2);
// no state crosses blocks, so blocks run in any order. The 13 per-packet
// scalars of each tile row are decoded once into shared memory. A thread
// produces 8 consecutive output samples and stores them as one 16-byte
// i16 store. Vorbis blocksizes are powers of two, at least 64; the kernel
// needs n0 and n1 to be multiples of 32 (the geometry check below), which
// makes every region boundary -- M/2, 3M/2, m/2, 3m/2, m, 2m, M, the
// lapped start ls and the centred short window m_start -- a multiple of
// 8. So a group of 8 never straddles two regions: the region is decided
// once per group, the 8 X values are read as two 16-byte loads (reversed
// and negated in registers in the mirrored region), and the split form
// rebuilds its 8 X values from two 16-byte loads of U and of V and two
// neighbours. Where a row is not 16-byte aligned (an offset view, which
// the audio form may get) the same groups are read with scalar loads.
// __launch_bounds__(256, 4) caps a thread at 64 registers, so 4 blocks,
// 32 warps, are resident on a multiprocessor.
//
// Bound: memory. Per output sample it reads the input once for the current
// row and once more as the next row's "previous" row (mostly an L2 hit),
// and writes 2 bytes of i16; the arithmetic is two products and a sum (one
// more add per X value in the split form). At the headline the X form
// moves ~0.5 GB per chunk, ~0.15 ms at 3.35 TB/s (PERF.md). The Mosaic
// workarounds of the TPU kernel (the roll-network and MXU lane reversals,
// _shuffle_zip/_combine_split, the XLA-side flip) are not used.
//
// Rounding matches the plain torch versions
// (lewton_tpu_torch/ops/overlap_kernel.py): the split combine is one add or
// sub per X value, the mix's products and sum are separately rounded
// (__fmul_rn/__fadd_rn, --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // resident blocks a multiprocessor: 32 warps
constexpr int kGroup = 8;  // consecutive output samples a thread owns
constexpr int kMaxTileRows = 64;
constexpr int kTileItems = 3 * kThreads;  // (row, group) items a tile aims at
constexpr int kScal = 13;  // per-packet scalar columns (windowing.py map)

// the per-packet flags of scal, decoded once per tile row
enum : int {
  kUseS1 = 1 << 0,     // col 0: left slope of the long window
  kUseR1 = 1 << 1,     // col 1: right slope of the long window
  kLsOn = 1 << 2,      // col 2: lapped-start shift
  kPrevIsL = 1 << 3,   // col 3: previous right region long&next
  kPrevIsM = 1 << 4,   // col 4: previous right region short-in-long
  kFirst = 1 << 5,     // row 0 or col 5: mix against the carried pwr0
  kLong = 1 << 6,      // col 8: long block
  kValid = 1 << 7,     // col 9
  kNextValid = 1 << 8, // col 9 of row t+1
  kCurIsL = 1 << 9,    // col 10: own right region long&next
  kCurIsM = 1 << 10,   // col 11: own right region short-in-long
};

// v = p[0 .. 8): two 16-byte loads when vec (p 16-byte aligned).
__device__ __forceinline__ void load_group(const float* p, bool vec,
                                           float (&v)[kGroup]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int t = 0; t < kGroup; ++t) v[t] = __ldg(p + t);
  }
}

__device__ __forceinline__ void zero8(float (&v)[kGroup]) {
#pragma unroll
  for (int t = 0; t < kGroup; ++t) v[t] = 0.0f;
}

// v[t] = element i0 + t of the IMDCT output rebuilt from a DCT-IV row of
// length h (x.load8(k, w): its elements k .. k+7); i0 % 8 == 0 and
// h/2 % 8 == 0, so the group lies in one region.
template <class XRow>
__device__ __forceinline__ void imdct8(const XRow& x, int h, int i0,
                                       float (&v)[kGroup]) {
  const int q = h / 2;
  if (i0 < q) {
    x.load8(q + i0, v);
  } else if (i0 < 3 * q) {  // -x(3q-1-i): the group 3q-8-i0 .. reversed
    float w[kGroup];
    x.load8(3 * q - kGroup - i0, w);
#pragma unroll
    for (int t = 0; t < kGroup; ++t) v[t] = -w[kGroup - 1 - t];
  } else {
    x.load8(i0 - 3 * q, v);
#pragma unroll
    for (int t = 0; t < kGroup; ++t) v[t] = -v[t];
  }
}

// X form: DCT-IV rows [C, rows, h].
struct XSource {
  const float* x;
  int h;
  size_t rows;
  bool vec;
  struct Row {
    const float* p;
    int h;
    bool vec;
    __device__ void load8(int k, float (&v)[kGroup]) const {
      load_group(p + k, vec, v);
    }
    __device__ void at8(int i0, float (&v)[kGroup]) const {
      imdct8(*this, h, i0, v);
    }
  };
  __device__ Row row(int c, size_t r) const {
    return Row{x + (static_cast<size_t>(c) * rows + r) * h, h, vec};
  }
};

// Split form: the Wang-split halves U, V [C, rows, h/2] of the long X.
struct SplitSource {
  const float* u;
  const float* v;
  int h;  // the X length M; U and V hold M/2 values per row
  size_t rows;
  bool vec;
  struct Row {
    const float* u;
    const float* v;
    int h;
    bool vec;
    // X_k .. X_{k+7} for k % 8 == 0, b = k/2: from U_b .. U_{b+4} and
    // V_{b-1} .. V_{b+3}
    __device__ void load8(int k, float (&x)[kGroup]) const {
      const int b = k / 2, half = h / 2;
      float uu[5], vv[5];  // uu[j] = U_{b+j}, vv[j] = V_{b-1+j}
      const bool last = b + 4 == half;
      if (vec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(u + b));
        const float4 c = __ldg(reinterpret_cast<const float4*>(v + b));
        uu[0] = a.x; uu[1] = a.y; uu[2] = a.z; uu[3] = a.w;
        vv[1] = c.x; vv[2] = c.y; vv[3] = c.z; vv[4] = c.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uu[j] = __ldg(u + b + j);
          vv[j + 1] = __ldg(v + b + j);
        }
      }
      uu[4] = last ? 0.0f : __ldg(u + b + 4);
      vv[0] = b > 0 ? __ldg(v + b - 1) : 0.0f;
      x[0] = b == 0 ? uu[0] : __fadd_rn(uu[0], vv[0]);
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        x[2 * j - 1] = __fsub_rn(uu[j], vv[j]);
        x[2 * j] = __fadd_rn(uu[j], vv[j]);
      }
      x[7] = last ? -vv[4] : __fsub_rn(uu[4], vv[4]);
    }
    __device__ void at8(int i0, float (&v8)[kGroup]) const {
      imdct8(*this, h, i0, v8);
    }
  };
  __device__ Row row(int c, size_t r) const {
    const size_t o = (static_cast<size_t>(c) * rows + r) * (h / 2);
    return Row{u + o, v + o, h, vec};
  }
};

// Audio form: IMDCT output rows, element (r, c, i) at
// a[r * row_stride + c * chan_stride + i].
struct AudioSource {
  const float* a;
  size_t row_stride;
  size_t chan_stride;
  bool vec;
  struct Row {
    const float* p;
    bool vec;
    __device__ void at8(int i0, float (&v)[kGroup]) const {
      load_group(p + i0, vec, v);
    }
  };
  __device__ Row row(int c, size_t r) const {
    return Row{a + r * row_stride + static_cast<size_t>(c) * chan_stride,
               vec};
  }
};

// Right region elements j0 .. j0+7 (j0 < M, j0 % 8 == 0) of a packet of
// class (is_l, is_m): long&next [M, 2M) of the long output; long&!next the
// short window centred in the long output; short [m, 2m) of the short
// output (of the pre-selected row when there is no short input). Zero past
// the short width for the last two.
template <class LRow, class SRow>
__device__ __forceinline__ void right_region8(const LRow& l, const SRow& s,
                                              bool has_short, bool is_l,
                                              bool is_m, int M, int m,
                                              int m_start, int j0,
                                              float (&v)[kGroup]) {
  if (is_l) {
    l.at8(M + j0, v);
  } else if (j0 >= m) {
    zero8(v);
  } else if (is_m) {
    l.at8(m_start + j0, v);
  } else if (!has_short) {
    l.at8(m + j0, v);
  } else {
    s.at8(m + j0, v);
  }
}

template <class LongSrc, class ShortSrc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
overlap_i16_kernel(const LongSrc src_l, const ShortSrc src_s, bool has_short,
                   const float* __restrict__ scal,
                   const float* __restrict__ slopes,
                   const float* __restrict__ pwr0, int16_t* __restrict__ out,
                   float* __restrict__ pwr_out, int T, int C, int n0, int n1,
                   int R, bool vec_io) {
  __shared__ int s_flags[kMaxTileRows];
  __shared__ float s_ov[kMaxTileRows];
  __shared__ float s_len[kMaxTileRows];
  const int s = blockIdx.z;
  const int c = blockIdx.y;
  const int t0 = blockIdx.x * R;
  const int nrows = min(R, T - t0);
  const int M = n1 / 2;  // long DCT-IV length == W, the overlap width
  const int m = n0 / 2;  // short DCT-IV length
  const int outw = 3 * n1 / 4;
  const int ls = (n1 - n0) / 4;
  const int m_start = (3 * n1 - n0) / 4;
  const float* p0 = pwr0 + (static_cast<size_t>(s) * C + c) * M;
  float* pout = pwr_out + (static_cast<size_t>(s) * C + c) * M;
  using LRow = typename LongSrc::Row;
  using SRow = typename ShortSrc::Row;

  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int t = t0 + r;
    const float* sc = scal + (static_cast<size_t>(s) * T + t) * kScal;
    int f = 0;
    f |= sc[0] > 0.0f ? kUseS1 : 0;
    f |= sc[1] > 0.0f ? kUseR1 : 0;
    f |= sc[2] > 0.0f ? kLsOn : 0;
    f |= sc[3] > 0.0f ? kPrevIsL : 0;
    f |= sc[4] > 0.0f ? kPrevIsM : 0;
    f |= t == 0 || sc[5] > 0.0f ? kFirst : 0;
    f |= sc[8] > 0.0f ? kLong : 0;
    f |= sc[9] > 0.0f ? kValid : 0;
    f |= t + 1 < T && sc[kScal + 9] > 0.0f ? kNextValid : 0;
    f |= sc[10] > 0.0f ? kCurIsL : 0;
    f |= sc[11] > 0.0f ? kCurIsM : 0;
    s_flags[r] = f;
    s_ov[r] = sc[6];
    s_len[r] = sc[7];
  }
  __syncthreads();

  const int G = outw / kGroup;
  for (int i = threadIdx.x; i < nrows * G; i += kThreads) {
    const int r = i / G;
    const int j0 = (i - r * G) * kGroup;
    const size_t row = static_cast<size_t>(s) * T + t0 + r;
    const int f = s_flags[r];
    const float ov_len = s_ov[r], out_len = s_len[r];
    float a[kGroup];
    if ((f & kLong) || !has_short) {
      src_l.row(c, row).at8((f & kLsOn) ? j0 + ls : j0, a);
    } else if (j0 < 2 * m) {
      src_s.row(c, row).at8(j0, a);
    } else {
      zero8(a);
    }
    if (j0 < M && static_cast<float>(j0) < ov_len) {
      float pwr[kGroup], lhs[kGroup], rhs[kGroup];
      if (f & kFirst) {
        load_group(p0 + j0, vec_io, pwr);
      } else {  // previous packet of the same stream
        right_region8(src_l.row(c, row - 1),
                      has_short ? src_s.row(c, row - 1) : SRow{}, has_short,
                      f & kPrevIsL, f & kPrevIsM, M, m, m_start, j0, pwr);
      }
      load_group(slopes + ((f & kUseS1) ? M : 0) + j0, vec_io, lhs);
      load_group(slopes + ((f & kUseR1) ? 3 * M : 2 * M) + j0, vec_io, rhs);
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        if (static_cast<float>(j0 + t) < ov_len) {
          a[t] = __fadd_rn(__fmul_rn(a[t], lhs[t]), __fmul_rn(pwr[t], rhs[t]));
        }
      }
    }
    uint32_t packed[kGroup / 2];
#pragma unroll
    for (int t = 0; t < kGroup; t += 2) {
      uint32_t h[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v =
            static_cast<float>(j0 + t + u) < out_len ? a[t + u] : 0.0f;
        const float scaled =
            fminf(fmaxf(__fmul_rn(v, 32768.0f), -32768.0f), 32767.0f);
        h[u] = static_cast<uint16_t>(static_cast<int16_t>(truncf(scaled)));
      }
      packed[t / 2] = h[0] | (h[1] << 16);
    }
    int16_t* o = out + row * (static_cast<size_t>(C) * outw) +
                 static_cast<size_t>(c) * outw + j0;
    if (vec_io) {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    } else {
#pragma unroll
      for (int t = 0; t < kGroup; ++t) {
        o[t] = static_cast<int16_t>(packed[t / 2] >> (16 * (t & 1)));
      }
    }
  }

  // carry: a tile row that is the stream's last valid packet, or row 0 of
  // a chunk with no valid packet at all (then pwr0 passes through)
  for (int r = 0; r < nrows; ++r) {
    const int f = s_flags[r];
    const int t = t0 + r;
    const bool valid = f & kValid;
    if (valid && !(f & kNextValid)) {
      const size_t row = static_cast<size_t>(s) * T + t;
      const LRow lr = src_l.row(c, row);
      const SRow sr = has_short ? src_s.row(c, row) : SRow{};
      for (int j0 = threadIdx.x * kGroup; j0 < M; j0 += kThreads * kGroup) {
        float v[kGroup];
        right_region8(lr, sr, has_short, f & kCurIsL, f & kCurIsM, M, m,
                      m_start, j0, v);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) pout[j0 + u] = v[u];
      }
    } else if (t == 0 && !valid) {
      for (int j = threadIdx.x; j < M; j += kThreads) pout[j] = p0[j];
    }
  }
}

// Besides the launch limits: n0 and n1 multiples of 32, so that no group
// of 8 samples straddles two regions (every Vorbis blocksize is).
bool bad_geometry(int S, int T, int C, int n0, int n1) {
  return S < 1 || T < 1 || C < 1 || C > 65535 || S > 65535 || n0 < 32 ||
         n1 < n0 || n0 % 32 != 0 || n1 % 32 != 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Tile rows for a row of n1 samples: about kTileItems groups a block.
int tile_rows(int n1) {
  const int G = 3 * n1 / 4 / kGroup;
  const int R = kTileItems / G;
  return R < 1 ? 1 : (R > kMaxTileRows ? kMaxTileRows : R);
}

template <class LongSrc, class ShortSrc>
int launch(const LongSrc& l, const ShortSrc& s, bool has_short,
           const void* scal, const void* slopes, const void* pwr0, void* out,
           void* pwr_out, int S, int T, int C, int n0, int n1, void* stream) {
  const int R = tile_rows(n1);
  const dim3 grid((T + R - 1) / R, C, S);
  const bool vec_io = aligned16(slopes) && aligned16(pwr0) &&
                      aligned16(out) && aligned16(pwr_out);
  overlap_i16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      l, s, has_short, static_cast<const float*>(scal),
      static_cast<const float*>(slopes), static_cast<const float*>(pwr0),
      static_cast<int16_t*>(out), static_cast<float*>(pwr_out), T, C, n0, n1,
      R, vec_io);
  return static_cast<int>(cudaGetLastError());
}

XSource x_source(const void* x, int h, size_t rows) {
  return XSource{static_cast<const float*>(x), h, rows, aligned16(x)};
}

}  // namespace

// C interface (loaded with ctypes); all pointers are device pointers. The
// short input may be null: n0 == n1 in the X and split forms, pre-selected
// audio in the audio form. Common shapes: scal [S*T, 13], slopes
// [4, n1/2], pwr0 [S, C, n1/2]; out i16 [S*T, C*3n1/4], pwr_out
// [S, C, n1/2]. n0 and n1 must be multiples of 32. Each returns
// cudaGetLastError() after the launch (0 = success).

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
  return launch(x_source(x_long, n1 / 2, rows),
                x_source(x_short, n0 / 2, rows), x_short != nullptr, scal,
                slopes, pwr0, out, pwr_out, S, T, C, n0, n1, stream);
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
  const SplitSource src{static_cast<const float*>(u),
                        static_cast<const float*>(v), n1 / 2, rows,
                        aligned16(u) && aligned16(v)};
  return launch(src, x_source(x_short, n0 / 2, rows), x_short != nullptr,
                scal, slopes, pwr0, out, pwr_out, S, T, C, n0, n1, stream);
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
    const float* a = static_cast<const float*>(p);
    return ct_in ? AudioSource{a, nn, rows * nn, aligned16(p)}
                 : AudioSource{a, C * nn, nn, aligned16(p)};
  };
  return launch(src(long_a, n1), src(short_a, n0), short_a != nullptr, scal,
                slopes, pwr0, out, pwr_out, S, T, C, n0, n1, stream);
}

// What the compiler made of each form (0 X, 1 split, 2 audio): out[0..4]
// = registers a thread, local (spill) bytes a thread, max threads a block,
// static shared bytes, resident blocks a multiprocessor. Returns a
// cudaError_t.
extern "C" int lt_overlap_kernel_attrs(int form, int* out) {
  const void* k;
  if (form == 0) {
    k = reinterpret_cast<const void*>(overlap_i16_kernel<XSource, XSource>);
  } else if (form == 1) {
    k = reinterpret_cast<const void*>(
        overlap_i16_kernel<SplitSource, XSource>);
  } else if (form == 2) {
    k = reinterpret_cast<const void*>(
        overlap_i16_kernel<AudioSource, AudioSource>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = blocks;
  return 0;
}
