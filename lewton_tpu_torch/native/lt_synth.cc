// CPU synthesis half: floor curves, coupling, IMDCT, windowing/overlap-add.
//
// Serves the C ABI (lt_capi.cc), the whole-file decode (lt_file.cc) and the
// reader's "native" backend (native.NativeDecoder). The device pipeline
// (models/decoder.py, the "torch" backend) is the production synthesis; this
// is the CPU decoder with the same numerics (f32, +/-2 i16 LSB vs
// libvorbis). IMDCT runs as DCT-IV via an M/4-point complex FFT:
//
//   v[p] = (x[2p] + i x[M-1-2p]) * e^{-i pi (4p+1)/(4M)}, P = M/2
//   T = FFT_P(v) * e^{-i pi k / M}
//   d[2k] = Re T[k], d[M-1-2k] = -Im T[k]
//   y[0:M/2]      =  d[M/2:]            (IMDCT symmetry extension)
//   y[M/2:3M/2]   = -d[M-1::-1]
//   y[3M/2:2M]    = -d[0:M/2]
//
// (identity validated against the direct transform and the framework's
// stb-derived IMDCT golden vectors; tests/test_torch_capi.py holds this
// copy's decode to the libvorbis goldens).
#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <memory>
#include <thread>
#include <vector>

#include "lt_decode.h"

#include "lt_inverse_db.inc"

namespace lt {
namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------- iterative radix-2 complex FFT (double twiddles) --------

struct Fft {
  explicit Fft(uint32_t n) : n(n) {
    tw.resize(n / 2);
    for (uint32_t i = 0; i < n / 2; ++i) {
      double a = -2.0 * kPi * i / n;
      tw[i] = {(float)std::cos(a), (float)std::sin(a)};
    }
    rev.resize(n);
    uint32_t bits = 0;
    while ((1u << bits) < n) ++bits;
    for (uint32_t i = 0; i < n; ++i) {
      uint32_t r = 0;
      for (uint32_t b = 0; b < bits; ++b)
        if (i & (1u << b)) r |= 1u << (bits - 1 - b);
      rev[i] = r;
    }
  }

  void run(float* re, float* im) const {
    for (uint32_t i = 0; i < n; ++i) {
      uint32_t j = rev[i];
      if (j > i) {
        std::swap(re[i], re[j]);
        std::swap(im[i], im[j]);
      }
    }
    for (uint32_t len = 2; len <= n; len <<= 1) {
      uint32_t half = len >> 1, step = n / len;
      for (uint32_t i = 0; i < n; i += len) {
        for (uint32_t j = 0; j < half; ++j) {
          auto [wr, wi] = tw[j * step];
          uint32_t a = i + j, b = a + half;
          float xr = re[b] * wr - im[b] * wi;
          float xi = re[b] * wi + im[b] * wr;
          re[b] = re[a] - xr;
          im[b] = im[a] - xi;
          re[a] += xr;
          im[a] += xi;
        }
      }
    }
  }

  uint32_t n;
  std::vector<std::pair<float, float>> tw;
  std::vector<uint32_t> rev;
};

// per-blocksize cached constants
struct BsCache {
  std::unique_ptr<Fft> fft;  // size M/2, M = n/2
  std::vector<std::pair<float, float>> pre;   // e^{-i pi(4p+1)/(4M)}
  std::vector<std::pair<float, float>> post;  // e^{-i pi k/M}
  std::vector<float> slope;                   // window slope, len n/2
};

BsCache* bs_cache(std::map<uint32_t, BsCache>& m, uint32_t n) {
  auto it = m.find(n);
  if (it != m.end()) return &it->second;
  BsCache& c = m[n];
  uint32_t M = n / 2, half = n / 2, P = M / 2;
  c.fft = std::make_unique<Fft>(P);
  c.pre.resize(P);
  c.post.resize(P);
  for (uint32_t p = 0; p < P; ++p) {
    double a = -kPi * (4.0 * p + 1.0) / (4.0 * M);
    c.pre[p] = {(float)std::cos(a), (float)std::sin(a)};
    double b = -kPi * p / M;
    c.post[p] = {(float)std::cos(b), (float)std::sin(b)};
  }
  c.slope.resize(half);
  for (uint32_t i = 0; i < half; ++i) {
    double v = std::sin(0.5 * kPi * (i + 0.5) / half);
    c.slope[i] = (float)std::sin(0.5 * kPi * v * v);
  }
  return &c;
}

struct ImdctScratch {
  std::vector<float> vr, vi, d;
};

// IMDCT: X[M] spectral -> y[n], n = 2M (in caller buffers)
void imdct(const BsCache& c, const float* X, uint32_t M, float* y,
           ImdctScratch& s) {
  uint32_t P = M / 2, Mh = M / 2;
  s.vr.resize(P);
  s.vi.resize(P);
  s.d.resize(M);
  std::vector<float>&vr = s.vr, &vi = s.vi, &d = s.d;
  for (uint32_t p = 0; p < P; ++p) {
    float xr = X[2 * p];
    float xi = X[M - 1 - 2 * p];
    auto [wr, wi] = c.pre[p];
    vr[p] = xr * wr - xi * wi;
    vi[p] = xr * wi + xi * wr;
  }
  c.fft->run(vr.data(), vi.data());
  for (uint32_t k = 0; k < P; ++k) {
    auto [wr, wi] = c.post[k];
    float tr = vr[k] * wr - vi[k] * wi;
    float ti = vr[k] * wi + vi[k] * wr;
    d[2 * k] = tr;
    d[M - 1 - 2 * k] = -ti;
  }
  for (uint32_t i = 0; i < Mh; ++i) y[i] = d[Mh + i];
  for (uint32_t i = 0; i < M; ++i) y[Mh + i] = -d[M - 1 - i];
  for (uint32_t i = 0; i < Mh; ++i) y[Mh + M + i] = -d[i];
}

}  // namespace

// ------------------------------------------------------------------------
// Full CPU decoder context (entropy + synthesis + window carry)
// ------------------------------------------------------------------------

struct Decoder {
  Stream st;
  std::map<uint32_t, BsCache> bs;
  // floor0 bark map cache per (floor index, blockflag)
  std::map<uint64_t, std::vector<float>> bark;
  // window carry
  std::vector<float> pwr;  // [C * plen]
  std::vector<float> pwr_next;  // swap partner (no per-packet alloc)
  uint32_t plen = 0;
  bool started = false;
  // scratch frame buffers
  std::vector<int32_t> mode;
  std::vector<float> residue, f0_cosc, f0_amp, curve, audio, out;
  std::vector<uint8_t> f_used, f1_flags;
  std::vector<int32_t> f1_ys;
  ImdctScratch imdct_scratch;
  DecodeScratch entropy_scratch;
  // lazily-built parallel workers for decode_many (own scratch + a copy of
  // the read-only setup tables)
  std::vector<std::unique_ptr<Decoder>> workers;

  void reset() {
    plen = 0;
    started = false;
    pwr.clear();
  }

  const std::vector<float>& bark_map(uint32_t floor_idx, uint32_t n2) {
    uint64_t key = ((uint64_t)floor_idx << 32) | n2;
    auto it = bark.find(key);
    if (it != bark.end()) return it->second;
    const Floor0& f = st.setup.floors[floor_idx].f0;
    auto barkf = [](float x) {
      return 13.1f * std::atan(0.00074f * x) +
             2.24f * std::atan(1.85e-8f * x * x) + 0.0001f * x;
    };
    std::vector<float>& v = bark[key];
    v.resize(n2);
    float hfl = (float)f.rate / 2.0f;
    float hfl_dn = hfl / (float)n2;
    float scale = (float)f.bark_map_size / barkf(hfl);
    for (uint32_t i = 0; i < n2; ++i) {
      float foobar = std::floor(barkf(hfl_dn * (float)i) * scale);
      float m = std::min(foobar, (float)(f.bark_map_size - 1));
      v[i] = std::cos(m * ((float)kPi / (float)f.bark_map_size));
    }
    return v;
  }
};

namespace {

// floor1 curve synthesis over sorted posts (Bresenham closed form; same
// integer math as the reference's render_line, spec 9.2.7)
void render_line(int32_t lx, int32_t ly, int32_t nx, int32_t ny, uint32_t n2,
                 float* out) {
  // Incremental Bresenham over [lx, nx) clipped to [0, n2) (spec 9.2.7).
  // Identical outputs to the closed form y(dd) = ly + base*dd +
  // sgn*floor(dd*ady_r/adx) — ady_r < adx, so the floor term advances by
  // exactly sgn each time the error accumulator wraps. The closed form's
  // 64-bit multiply + divide PER BIN was ~48 cycles/bin and the single
  // hottest cost of the whole CPU decode (measured: the floor stage was
  // 98.7k cycles/packet of a 270k-cycle q3 packet).
  int32_t dy = ny - ly, adx = nx - lx;
  if (adx <= 0) return;
  int32_t ady = dy < 0 ? -dy : dy;
  int32_t base = dy / adx;  // trunc toward zero
  int32_t ady_r = ady - (base < 0 ? -base : base) * adx;
  int32_t sgn = dy < 0 ? -1 : 1;
  int32_t end = nx < (int32_t)n2 ? nx : (int32_t)n2;
  int32_t y = ly, err = 0;
  for (int32_t x = lx; x < end; ++x) {
    int32_t idx = y < 0 ? 0 : (y > 255 ? 255 : y);
    out[x] = kInverseDb[idx];
    y += base;
    err += ady_r;
    // branchless carry: the wrap probability is ady_r/adx — data-
    // dependent and mispredict-prone as an if
    int32_t c = -(int32_t)(err >= adx);
    err -= adx & c;
    y += sgn & c;
  }
}

void floor1_curve(const Stream& st, const Floor1& f, const int32_t* ys,
                  const uint8_t* flags, uint32_t n2, float* out) {
  // posts arrive in sorted-x order carrying INDEX-SPACE values (already
  // *multiplier, clamped 0..255 — see lt_entropy.cc emission); lines run
  // between flagged posts with a horizontal tail to n2, libvorbis
  // floor1_inverse2 semantics
  size_t P = f.x_list.size();
  int32_t lx = 0, ly = ys[0];
  for (size_t i = 1; i < P; ++i) {
    if (!flags[i]) continue;
    int32_t nx = (int32_t)f.x_list[f.sort_order[i]];
    int32_t ny = ys[i];
    render_line(lx, ly, nx, ny, n2, out);
    lx = nx;
    ly = ny;
  }
  if ((uint32_t)lx < n2) render_line(lx, ly, (int32_t)n2, ly, n2, out);
}

void floor0_curve(Decoder* dec, uint32_t floor_idx, const float* cosc,
                  float amplitude, uint32_t n2, float* out) {
  const Floor0& f = dec->st.setup.floors[floor_idx].f0;
  const std::vector<float>& cw = dec->bark_map(floor_idx, n2);
  uint32_t order = f.order;
  float lfv_common = amplitude * (float)f.amplitude_offset /
                     (float)((1ull << f.amplitude_bits) - 1);
  int ord = (int)order;
  for (uint32_t i = 0; i < n2; ++i) {
    float c = cw[i];
    float p, q;
    if (ord & 1) {
      p = 1.0f - c * c;
      q = 0.25f;
      for (int j = 0; j <= (ord - 3) / 2; ++j) {  // empty for ord==1
        float pm = cosc[2 * j + 1] - c;
        p *= 4.0f * pm * pm;
      }
      for (int j = 0; j <= (ord - 1) / 2; ++j) {
        float qm = cosc[2 * j] - c;
        q *= 4.0f * qm * qm;
      }
    } else {
      p = (1.0f - c) / 2.0f;
      q = (1.0f + c) / 2.0f;
      for (int j = 0; j <= (ord - 2) / 2; ++j) {
        float pm = cosc[2 * j + 1] - c;
        p *= 4.0f * pm * pm;
        float qm = cosc[2 * j] - c;
        q *= 4.0f * qm * qm;
      }
    }
    // saturate just inside the f32 exp overflow edge (~88.72) instead of
    // inf (then NaN via 0 residue); matches libvorbis's f32-rounded value
    // for any arg below the edge — see floor.floor0_curve for the full
    // divergence-window note (libvorbis computes exp in double)
    float arg = 0.11512925f *
                (lfv_common / std::sqrt(p + q) - (float)f.amplitude_offset);
    out[i] = std::exp(std::min(arg, 88.7f));
  }
}

}  // namespace

}  // namespace lt

// ------------------------------------------------------------------------
// C API: full CPU decode (entropy + synthesis)
// ------------------------------------------------------------------------

using lt::Decoder;

extern "C" {

lt::Stream* lt_stream_new(const uint8_t*, size_t, const uint8_t*, size_t,
                          char*, size_t);  // from lt_entropy.cc

Decoder* lt_decoder_new(const uint8_t* ident_pck, size_t ident_len,
                        const uint8_t* setup_pck, size_t setup_len, char* err,
                        size_t err_len) try {
  lt::Stream* st = lt_stream_new(ident_pck, ident_len, setup_pck, setup_len,
                                 err, err_len);
  if (!st) return nullptr;
  auto dec = std::make_unique<Decoder>();
  dec->st = std::move(*st);
  delete st;
  return dec.release();
} catch (const std::exception& ex) {
  if (err && err_len) {
    strncpy(err, ex.what(), err_len - 1);
    err[err_len - 1] = 0;
  }
  return nullptr;
}

void lt_decoder_free(Decoder* d) { delete d; }
void lt_decoder_reset(Decoder* d) { d->reset(); }
int lt_decoder_channels(const Decoder* d) { return (int)d->st.channels; }
int lt_decoder_rate(const Decoder* d) { return (int)d->st.ident.sample_rate; }
int lt_decoder_n1(const Decoder* d) { return (int)d->st.n1; }

// Entropy + floors + coupling + IMDCT for one packet, into `audio`
// ([C, n1] blocks, current block in [0, n)). No shared mutable state
// beyond scratch in `d`, so distinct Decoder instances run in parallel.
static int decode_packet_to_audio(Decoder* d, const uint8_t* pck, size_t len,
                                  float* audio_out, uint8_t* bf_out,
                                  uint8_t* pf_out, uint8_t* nf_out) {
  lt::Stream& st = d->st;
  const uint32_t C = st.channels, W = st.W, P = st.P;
  const uint32_t Om = st.Omax ? st.Omax : 1;
  d->residue.assign((size_t)C * W, 0.0f);
  d->f_used.assign(C, 0);
  d->f1_ys.assign((size_t)C * P, 0);
  d->f1_flags.assign((size_t)C * P, 0);
  d->f0_cosc.assign((size_t)C * Om, 0.0f);
  d->f0_amp.assign(C, 0.0f);
  int32_t mode_num = 0;
  uint8_t prevf = 0, nextf = 0;
  int status = lt::decode_packet(
      &st, pck, len, &mode_num, &prevf, &nextf, d->residue.data(),
      d->f_used.data(), d->f1_ys.data(), d->f1_flags.data(),
      d->f0_cosc.data(), d->f0_amp.data(), st.W, &d->entropy_scratch);
  if (status != lt::LT_OK) return status;

  const lt::Mode& mode = st.setup.modes[mode_num];
  const lt::Mapping& mapping = st.setup.mappings[mode.mapping];
  uint32_t n = mode.blockflag ? st.n1 : st.n0;
  uint32_t n2 = n / 2;
  *bf_out = mode.blockflag;
  *pf_out = prevf;
  *nf_out = nextf;

  // inverse coupling (reverse order)
  for (size_t s = mapping.coupling_magnitude.size(); s-- > 0;) {
    float* m = d->residue.data() + (size_t)mapping.coupling_magnitude[s] * W;
    float* a = d->residue.data() + (size_t)mapping.coupling_angle[s] * W;
    for (uint32_t i = 0; i < n2; ++i) {
      float mv = m[i], av = a[i];
      float nm, na;
      if (mv > 0) {
        if (av > 0) { nm = mv; na = mv - av; }
        else { nm = mv + av; na = mv; }
      } else {
        if (av > 0) { nm = mv; na = mv + av; }
        else { nm = mv - av; na = mv; }
      }
      m[i] = nm;
      a[i] = na;
    }
  }

  // floor curve x residue -> spectra; IMDCT into caller [C, n1] blocks
  lt::BsCache* bc = lt::bs_cache(d->bs, n);
  d->curve.assign(n2, 0.0f);
  for (uint32_t ch = 0; ch < C; ++ch) {
    float* spec = d->residue.data() + (size_t)ch * W;
    if (!d->f_used[ch]) {
      memset(spec, 0, sizeof(float) * n2);
    } else {
      const lt::Floor& fl =
          st.setup.floors[mapping.submap_floor[mapping.mux[ch]]];
      if (fl.type == 1) {
        lt::floor1_curve(st, fl.f1, d->f1_ys.data() + (size_t)ch * P,
                         d->f1_flags.data() + (size_t)ch * P, n2,
                         d->curve.data());
      } else {
        lt::floor0_curve(d, mapping.submap_floor[mapping.mux[ch]],
                         d->f0_cosc.data() + (size_t)ch * Om,
                         d->f0_amp[ch], n2, d->curve.data());
      }
      for (uint32_t i = 0; i < n2; ++i) spec[i] *= d->curve.data()[i];
    }
    lt::imdct(*bc, spec, n2, audio_out + (size_t)ch * st.n1,
              d->imdct_scratch);
  }
  return lt::LT_OK;
}

// Sequential half: lap `audio` ([C, n1] blocks) against the carried right
// half, emit PCM, save the new right region. Returns out_len or -1.
static int overlap_add_block(Decoder* d, const float* audio, uint8_t bf,
                             uint8_t prevf, uint8_t nextf, float* pcm_out) {
  const lt::Stream& st = d->st;
  const uint32_t C = st.channels;
  uint32_t n1 = st.n1, n0 = st.n0;
  uint32_t n = bf ? n1 : n0;
  bool long_blk = bf != 0;
  uint32_t left_start = (long_blk && !prevf) ? (n1 - n0) >> 2 : 0;
  uint32_t right_start = (long_blk && !nextf) ? (3 * n1 - n0) >> 2 : n >> 1;
  uint32_t right_end = (long_blk && !nextf) ? (3 * n1 + n0) >> 2 : n;
  const std::vector<float>& lslope =
      (long_blk && prevf) ? lt::bs_cache(d->bs, n1)->slope
                          : lt::bs_cache(d->bs, n0)->slope;

  int out_len = 0;
  if (d->started) {
    uint32_t plen = d->plen;
    if (plen > lslope.size()) return -1;  // malformed (slope too short)
    out_len = (int)(right_start - left_start);
    for (uint32_t ch = 0; ch < C; ++ch) {
      const float* a = audio + (size_t)ch * n1;
      const float* pw = d->pwr.data() + (size_t)ch * plen;
      float* o = pcm_out + (size_t)ch * out_len;
      for (uint32_t i = 0; i < (uint32_t)out_len; ++i) {
        float v = a[left_start + i];
        if (i < plen) v = v * lslope[i] + pw[i] * lslope[plen - 1 - i];
        o[i] = v;
      }
    }
  }
  // save right region
  // save into the swap partner (a fresh vector per packet costs a
  // malloc/free pair on the hot loop; the two buffers just trade roles)
  uint32_t nplen = right_end - right_start;
  std::vector<float>& np = d->pwr_next;
  np.resize((size_t)C * nplen);
  for (uint32_t ch = 0; ch < C; ++ch)
    memcpy(np.data() + (size_t)ch * nplen,
           audio + (size_t)ch * n1 + right_start,
           sizeof(float) * nplen);
  d->pwr.swap(np);
  d->plen = nplen;
  d->started = true;
  return out_len;
}

// Decode one packet to planar f32 PCM. `pcm_out` must hold C * (3*n1/4)
// floats. Returns sample count per channel (>=0), or -1 (bad packet),
// -2 (header packet).
int lt_decoder_decode(Decoder* d, const uint8_t* pck, size_t len,
                      float* pcm_out) try {
  const uint32_t C = d->st.channels, n1 = d->st.n1;
  d->audio.assign((size_t)C * n1, 0.0f);
  uint8_t bf = 0, pf = 0, nf = 0;
  int status =
      decode_packet_to_audio(d, pck, len, d->audio.data(), &bf, &pf, &nf);
  if (status == lt::LT_IS_HEADER) return -2;
  if (status != lt::LT_OK) return -1;
  return overlap_add_block(d, d->audio.data(), bf, pf, nf, pcm_out);
} catch (const std::exception&) {
  return -1;  // never let C++ exceptions cross the C ABI
}

// ---- decode-state checkpoint (the reference's resumable state is exactly
// PreviousWindowRight + granule bookkeeping, lewton src/inside_ogg.rs:67-76)
int lt_decoder_state_plen(const Decoder* d) { return (int)d->plen; }
int lt_decoder_state_started(const Decoder* d) { return d->started ? 1 : 0; }
void lt_decoder_save_state(const Decoder* d, float* pwr_out) {
  memcpy(pwr_out, d->pwr.data(), d->pwr.size() * sizeof(float));
}
void lt_decoder_load_state(Decoder* d, const float* pwr, int plen,
                           int started) {
  d->plen = (uint32_t)plen;
  d->started = started != 0;
  d->pwr.assign(pwr, pwr + (size_t)d->st.channels * plen);
}

// Decode n packets in one call. pcm_out is [n][C * stride] with
// stride = 3*n1/4 (max per-channel output); out_lens[i] receives the
// per-channel sample count, or -1/-2 for bad/header packets (window state
// is unaffected by bad packets, matching per-packet semantics).
//
// Packets parallelize across threads for everything except the final
// overlap-add: Vorbis' only inter-packet dependency is the lapped window
// (the same structure the device pipeline exploits), so each worker decodes
// entropy + floor + coupling + IMDCT for its packets into per-packet
// audio blocks, and one sequential pass laps them together.
void lt_decoder_decode_many(Decoder* d, const uint8_t* buf,
                            const uint64_t* offs, const uint64_t* lens,
                            int n, float* pcm_out,
                            int32_t* out_lens) try {
  const size_t stride =
      (size_t)d->st.channels * (3 * (size_t)d->st.n1 / 4);
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)std::min<unsigned>(hw ? hw : 1, 8);
  if (n < 8 || nthreads <= 1) {
    for (int i = 0; i < n; ++i) {
      out_lens[i] = lt_decoder_decode(d, buf + offs[i], lens[i],
                                      pcm_out + (size_t)i * stride);
    }
    return;
  }
  const lt::Stream& st = d->st;
  const uint32_t C = st.channels, n1 = st.n1;
  // per-packet decoded blocks (audio pre-overlap) + geometry
  std::vector<float> audio((size_t)n * C * n1);
  struct Geo {
    int status;
    uint8_t bf, pf, nf;
  };
  std::vector<Geo> geo(n);
  auto worker = [&](int lo, int hi, Decoder* wd) {
    for (int i = lo; i < hi; ++i) {
      try {
        geo[i].status = decode_packet_to_audio(
            wd, buf + offs[i], lens[i], audio.data() + (size_t)i * C * n1,
            &geo[i].bf, &geo[i].pf, &geo[i].nf);
      } catch (const std::exception&) {
        geo[i].status = lt::LT_BAD;  // exceptions may not escape the thread
      }
    }
  };
  while ((int)d->workers.size() < nthreads) {
    auto wd = std::make_unique<Decoder>();
    wd->st = d->st;  // copies the parsed setup once (tables are read-only)
    d->workers.push_back(std::move(wd));
  }
  std::vector<std::thread> threads;
  int per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi, d->workers[t].get());
  }
  for (auto& t : threads) t.join();
  // sequential overlap-add using the shared window carry
  for (int i = 0; i < n; ++i) {
    if (geo[i].status != lt::LT_OK) {
      out_lens[i] = geo[i].status == lt::LT_IS_HEADER ? -2 : -1;
      continue;
    }
    out_lens[i] = overlap_add_block(
        d, audio.data() + (size_t)i * C * n1, geo[i].bf, geo[i].pf,
        geo[i].nf, pcm_out + (size_t)i * stride);
  }
} catch (const std::exception&) {
  // exceptions (bad_alloc on the staging buffer, thread spawn failure)
  // must never cross the C ABI into ctypes — mark every packet bad
  for (int i = 0; i < n; ++i) out_lens[i] = -1;
}

}  // extern "C"
