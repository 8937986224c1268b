// Per-packet entropy decode -> dense frame tensors (native host half).
//
// Mirrors lewton_tpu/audio.py decode_packet_entropy + floor.py + residue.py
// (behavioral parity with lewton src/audio.rs:919-1005, independently
// implemented from Vorbis I spec §4.3, §6, §7, §8.6). End-of-packet inside
// floors/residues is data, not error.
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include "lt_decode.h"

namespace lt {

namespace {

uint32_t ilog(uint64_t x) {
  uint32_t r = 0;
  while (x) {
    ++r;
    x >>= 1;
  }
  return r;
}

constexpr int kFloor1Ranges[4] = {256, 128, 86, 64};

// Sequential VQ accumulate (residue types 1/2 inner body): row[0..dim) +=
// vec[0..dim). dim-specialized so the compiler emits straight-line SIMD for
// the common small dims instead of a scalar trip-counted loop.
inline void vq_add(float* __restrict row, const float* __restrict vec,
                   uint32_t dim) {
  switch (dim) {
    case 8:
      for (int d = 0; d < 8; ++d) row[d] += vec[d];
      break;
    case 4:
      for (int d = 0; d < 4; ++d) row[d] += vec[d];
      break;
    case 2:
      row[0] += vec[0];
      row[1] += vec[1];
      break;
    case 1:
      row[0] += vec[0];
      break;
    default:
      for (uint32_t d = 0; d < dim; ++d) row[d] += vec[d];
  }
}

// Fused Huffman-decode + VQ-accumulate over one full residue partition.
// The cursor state lives in REGISTERS for the whole run: BitCursor's
// fields are pinned to stack memory inside decode_packet because
// decode_slow takes the cursor's address (GCC then re-loads acc/nbits
// per symbol — measured ~2x on the partition loop).
//
// Long codes (> lut_bits) and EOP fall back to the generic cursor path
// per symbol. (A burst variant — one refill check per floor(nbits/16)
// guaranteed hits — measured no better than this form on the bench
// corpus; the branch predictor already eats the per-symbol checks.)
// Caller guarantees: !huff.single(), every accumulate target in range.
// Bit-cursor registers for section-resident hot loops: the residue
// section keeps (acc, nbits, pos) in locals across ALL its partitions and
// classwords — syncing through the BitCursor object per partition pinned
// the fields to stack memory and measured ~2x on the partition loop.
struct BitRegs {
  uint64_t acc;
  uint32_t nbits;
  size_t pos;
};

static inline void regs_refill(BitRegs& rg, const uint8_t* __restrict data,
                               size_t len) {
  if (len - rg.pos >= 8) {  // bulk refill (little-endian hosts)
    uint64_t w;
    memcpy(&w, data + rg.pos, 8);
    rg.acc |= w << rg.nbits;
    uint32_t bytes = (63 - rg.nbits) >> 3;
    rg.pos += bytes;
    rg.nbits += bytes << 3;
  } else {
    while (rg.nbits <= 56 && rg.pos < len) {
      rg.acc |= (uint64_t)data[rg.pos++] << rg.nbits;
      rg.nbits += 8;
    }
  }
}

// One huffman scalar on registers; lut == nullptr (single-entry books)
// or a LUT miss falls back to the generic cursor path. Returns false on
// EOP (terminal for the packet's residue section).
static inline bool huff_decode_r(BitRegs& rg, const uint8_t* data,
                                 size_t len, const int32_t* lut,
                                 uint32_t lbits, uint32_t lmask,
                                 const Huffman* huf, uint32_t* val) {
  if (rg.nbits < lbits) regs_refill(rg, data, len);
  if (lut) {
    const int32_t e = lut[(uint32_t)rg.acc & lmask];
    const uint32_t L = (uint32_t)e & 31u;
    if (__builtin_expect(e >= 0 && L <= rg.nbits, 1)) {
      rg.acc >>= L;
      rg.nbits -= L;
      *val = (uint32_t)e >> 5;
      return true;
    }
  }
  BitCursor cur(data, len);
  cur.sync_in(rg.acc, rg.nbits, rg.pos);
  bool ok = huf->decode(&cur, val);
  cur.sync_out(&rg.acc, &rg.nbits, &rg.pos);
  return ok;
}

// Raw n-bit read on registers (n in 1..32). False on end-of-packet.
static inline bool read_r(BitRegs& rg, const uint8_t* data, size_t len,
                          uint32_t n, uint32_t* out) {
  if (rg.nbits < n) {
    regs_refill(rg, data, len);
    if (rg.nbits < n) return false;
  }
  *out = (uint32_t)(rg.acc & ((1ull << n) - 1));
  rg.acc >>= n;
  rg.nbits -= n;
  return true;
}

// One huffman scalar on registers straight from a Codebook (floor decode:
// books rotate per symbol, so the lut/bits fetch happens per call).
static inline bool huff_decode_cb_r(BitRegs& rg, const uint8_t* data,
                                    size_t len, const Codebook& cb,
                                    uint32_t* val) {
  const Huffman& h = cb.huff;
  if (h.single()) return huff_decode_r(rg, data, len, nullptr, 0, 0, &h, val);
  const uint32_t lbits = h.lut_bits();
  return huff_decode_r(rg, data, len, h.lut_data(), lbits,
                       (1u << lbits) - 1, &h, val);
}

template <uint32_t DIM, class Accum>
static inline bool vq_core_r(BitRegs& rg, const uint8_t* __restrict data,
                             size_t len, const int32_t* __restrict lut,
                             uint32_t lbits, const float* __restrict vq,
                             const Huffman* h, uint32_t nsym,
                             Accum&& accum) {
  const uint32_t lmask = (1u << lbits) - 1;
  uint64_t acc = rg.acc;
  uint32_t nbits = rg.nbits;
  size_t pos = rg.pos;
  for (uint32_t k = 0; k < nsym; ++k) {
    // Refill EVERY symbol: the "do I need bits" test was the loop's only
    // data-dependent branch (it fires quasi-periodically at a
    // code-length-dependent rate the predictor can't learn); topping the
    // accumulator up unconditionally replaces it with an
    // almost-always-true bounds check (+3% A/B on cpu-time, PERF.md r4).
    // nbits can be 64 right after a bulk cursor refill: skip (no room).
    // Bytes of w above the advanced count OR over bits already present
    // uncounted — same stream bytes, so the OR is idempotent.
    if (__builtin_expect((len - pos >= 8) & (nbits < 64), 1)) {
      uint64_t w;
      memcpy(&w, data + pos, 8);
      acc |= w << nbits;
      uint32_t bytes = (63 - nbits) >> 3;
      pos += bytes;
      nbits |= 56;
    } else if (nbits < lbits) {
      while (nbits <= 56 && pos < len) {
        acc |= (uint64_t)data[pos++] << nbits;
        nbits += 8;
      }
    }
    const int32_t e = lut[(uint32_t)acc & lmask];
    const uint32_t L = (uint32_t)e & 31u;
    if (__builtin_expect(e < 0 || L > nbits, 0)) {
      // long code, or out of bits (nbits < lbits only at EOP after the
      // refill above, so a miss here is EOP or a > lut_bits codeword)
      rg = {acc, nbits, pos};
      uint32_t val;
      BitCursor cur(data, len);
      cur.sync_in(acc, nbits, pos);
      bool ok = h->decode(&cur, &val);
      cur.sync_out(&rg.acc, &rg.nbits, &rg.pos);
      if (!ok) return false;  // EOP: caller stops cleanly
      acc = rg.acc;
      nbits = rg.nbits;
      pos = rg.pos;
      accum(vq + (size_t)val * DIM, k);
      continue;
    }
    acc >>= L;
    nbits -= L;
    accum(vq + (size_t)((uint32_t)e >> 5) * DIM, k);
  }
  rg = {acc, nbits, pos};
  return true;
}

template <uint32_t DIM, class Accum>
static inline bool vq_core(BitCursor* cur, const Codebook& book,
                           uint32_t nsym, Accum&& accum) {
  const Huffman& h = book.huff;
  BitRegs rg;
  cur->sync_out(&rg.acc, &rg.nbits, &rg.pos);
  bool ok = vq_core_r<DIM>(rg, cur->data(), cur->size(), h.lut_data(),
                           h.lut_bits(), book.vq.data(), &h, nsym,
                           static_cast<Accum&&>(accum));
  cur->sync_in(rg.acc, rg.nbits, rg.pos);
  return ok;
}

// Contiguous accumulate (types 0/1 rows, and type-2 via `inter`).
template <uint32_t DIM>
static inline bool vq_run(BitCursor* cur, const Codebook& book,
                          float* __restrict out, uint32_t nsym) {
  return vq_core<DIM>(cur, book, nsym,
                      [&](const float* __restrict ve, uint32_t k) {
                        float* __restrict o = out + (size_t)k * DIM;
                        for (uint32_t d = 0; d < DIM; ++d) o[d] += ve[d];
                      });
}

// Stereo type-2 direct-write: interleaved position p of the joint
// pseudo-channel maps to channel p&1, bin p>>1 — accumulating straight
// into the two channel rows skips the [n*C/2] `inter` buffer, its
// memset, AND the strided deinterleave pass (measured ~15% of front-end
// time). Parity-split inner loops keep the accumulate select-free (and
// a ternary-indexed lvalue here made gcc's sanitizer instrumentation
// check a speculated address, aborting fuzz runs). Caller guarantees
// every touched p has p>>1 < rw (per partition: span <= 2*rw).
template <uint32_t DIM>
static inline bool vq_run2(BitCursor* cur, const Codebook& book,
                           float* __restrict r0, float* __restrict r1,
                           uint32_t offs,  // absolute interleaved start
                           uint32_t nsym) {
  return vq_core<DIM>(
      cur, book, nsym, [&](const float* __restrict ve, uint32_t k) {
        const uint32_t base = offs + k * DIM;
        float* __restrict ra = (base & 1) ? r1 : r0;
        float* __restrict rb = (base & 1) ? r0 : r1;
        const uint32_t qa = base >> 1, qb = (base + 1) >> 1;
        for (uint32_t j = 0; 2 * j < DIM; ++j) ra[qa + j] += ve[2 * j];
        for (uint32_t j = 0; 2 * j + 1 < DIM; ++j)
          rb[qb + j] += ve[2 * j + 1];
      });
}

// Dim dispatch for vq_run. Callers must check vq_run_supported(dim)
// FIRST: vq_run_dim's false return means EOP (bits already consumed), so
// it cannot double as an "unsupported dim" probe — re-running the generic
// loop after a partial run would double-accumulate.
static inline bool vq_run_supported(uint32_t dim) {
  return dim == 1 || dim == 2 || dim == 3 || dim == 4 || dim == 6 ||
         dim == 8;
}

static inline bool vq_run_dim(BitCursor* cur, const Codebook& book,
                              float* out, uint32_t nsym, uint32_t dim) {
  switch (dim) {
    case 1:
      return vq_run<1>(cur, book, out, nsym);
    case 2:
      return vq_run<2>(cur, book, out, nsym);
    case 3:
      return vq_run<3>(cur, book, out, nsym);
    case 4:
      return vq_run<4>(cur, book, out, nsym);
    case 6:
      return vq_run<6>(cur, book, out, nsym);
    default:
      return vq_run<8>(cur, book, out, nsym);
  }
}

static inline bool vq_run2_dim(BitCursor* cur, const Codebook& book,
                               float* r0, float* r1, uint32_t offs,
                               uint32_t nsym, uint32_t dim) {
  switch (dim) {
    case 1:
      return vq_run2<1>(cur, book, r0, r1, offs, nsym);
    case 2:
      return vq_run2<2>(cur, book, r0, r1, offs, nsym);
    case 3:
      return vq_run2<3>(cur, book, r0, r1, offs, nsym);
    case 4:
      return vq_run2<4>(cur, book, r0, r1, offs, nsym);
    case 6:
      return vq_run2<6>(cur, book, r0, r1, offs, nsym);
    default:
      return vq_run2<8>(cur, book, r0, r1, offs, nsym);
  }
}

// Register/descriptor variants: one BookDesc load replaces the
// Codebook -> Huffman -> lut/vq pointer chase at every partition
// transition, and the cursor state stays in the caller's registers for
// the whole residue section.
template <uint32_t DIM>
static inline bool vq_run_r(BitRegs& rg, const uint8_t* data, size_t len,
                            const Stream::BookDesc& bd,
                            float* __restrict out, uint32_t nsym) {
  return vq_core_r<DIM>(rg, data, len, bd.lut, bd.lbits, bd.vq,
                        (const Huffman*)bd.huf, nsym,
                        [&](const float* __restrict ve, uint32_t k) {
                          float* __restrict o = out + (size_t)k * DIM;
                          for (uint32_t d = 0; d < DIM; ++d) o[d] += ve[d];
                        });
}

template <uint32_t DIM>
static inline bool vq_run2_r(BitRegs& rg, const uint8_t* data, size_t len,
                             const Stream::BookDesc& bd,
                             float* __restrict r0, float* __restrict r1,
                             uint32_t offs, uint32_t nsym) {
  return vq_core_r<DIM>(
      rg, data, len, bd.lut, bd.lbits, bd.vq, (const Huffman*)bd.huf, nsym,
      [&](const float* __restrict ve, uint32_t k) {
        const uint32_t base = offs + k * DIM;
        float* __restrict ra = (base & 1) ? r1 : r0;
        float* __restrict rb = (base & 1) ? r0 : r1;
        const uint32_t qa = base >> 1, qb = (base + 1) >> 1;
        for (uint32_t j = 0; 2 * j < DIM; ++j) ra[qa + j] += ve[2 * j];
        for (uint32_t j = 0; 2 * j + 1 < DIM; ++j)
          rb[qb + j] += ve[2 * j + 1];
      });
}

static inline bool vq_run_dim_r(BitRegs& rg, const uint8_t* data,
                                size_t len, const Stream::BookDesc& bd,
                                float* out, uint32_t nsym) {
  switch (bd.dim) {
    case 1:
      return vq_run_r<1>(rg, data, len, bd, out, nsym);
    case 2:
      return vq_run_r<2>(rg, data, len, bd, out, nsym);
    case 3:
      return vq_run_r<3>(rg, data, len, bd, out, nsym);
    case 4:
      return vq_run_r<4>(rg, data, len, bd, out, nsym);
    case 6:
      return vq_run_r<6>(rg, data, len, bd, out, nsym);
    default:
      return vq_run_r<8>(rg, data, len, bd, out, nsym);
  }
}

static inline bool vq_run2_dim_r(BitRegs& rg, const uint8_t* data,
                                 size_t len, const Stream::BookDesc& bd,
                                 float* r0, float* r1, uint32_t offs,
                                 uint32_t nsym) {
  switch (bd.dim) {
    case 1:
      return vq_run2_r<1>(rg, data, len, bd, r0, r1, offs, nsym);
    case 2:
      return vq_run2_r<2>(rg, data, len, bd, r0, r1, offs, nsym);
    case 3:
      return vq_run2_r<3>(rg, data, len, bd, r0, r1, offs, nsym);
    case 4:
      return vq_run2_r<4>(rg, data, len, bd, r0, r1, offs, nsym);
    case 6:
      return vq_run2_r<6>(rg, data, len, bd, r0, r1, offs, nsym);
    default:
      return vq_run2_r<8>(rg, data, len, bd, r0, r1, offs, nsym);
  }
}

// Integer line prediction (spec 9.2.6), signed like libvorbis's
// render_point (the reference wraps in u32 instead; the semantics only
// differ for out-of-range posts no encoder emits).
int32_t render_point(int32_t x0, int32_t y0, int32_t x1, int32_t y1,
                     int32_t x) {
  int32_t dy = y1 - y0;
  int32_t adx = x1 - x0;
  int32_t ady = dy < 0 ? -dy : dy;
  int32_t off = (int32_t)(((int64_t)ady * (x - x0)) / adx);
  return dy < 0 ? y0 - off : y0 + off;
}


}  // namespace

// Cursor + mode state captured between the packet head (mode/window bits,
// floors, no_residue propagation) and the residue section.
struct HeadState {
  uint64_t acc;
  uint32_t nbits;
  size_t pos;
  uint8_t mapping_idx;
  uint32_t n;
};

// Mode/window bits + floors + no_residue coupling propagation (everything
// before the residue section). Fills all non-residue outputs, zeroes the
// residue rows, leaves the cursor state in *hs. sc.no_residue is live for
// the caller's residue decode.
static int decode_packet_head(Stream* st, const uint8_t* pck, size_t len,
                              int32_t* mode_out, uint8_t* prev_out,
                              uint8_t* next_out, float* residue,
                              uint8_t* f_kind, int32_t* f1_ys,
                              uint8_t* f1_flags, float* f0_cosc,
                              float* f0_amp, uint32_t rw, DecodeScratch& sc,
                              HeadState* hs) {
  const uint32_t C = st->channels, P = st->P, Omax = st->Omax;
  memset(residue, 0, sizeof(float) * C * rw);
  memset(f_kind, 0, C);
  memset(f1_ys, 0, sizeof(int32_t) * C * P);
  memset(f1_flags, 0, C * P);
  if (Omax) memset(f0_cosc, 0, sizeof(float) * C * Omax);
  memset(f0_amp, 0, sizeof(float) * C);

  BitCursor cur(pck, len);
  uint32_t v;
  if (!cur.read(1, &v)) return LT_BAD;
  if (v) return LT_IS_HEADER;
  uint32_t mode_number;
  if (!cur.read(ilog(st->setup.modes.size() - 1), &mode_number)) return LT_BAD;
  if (mode_number >= st->setup.modes.size()) return LT_BAD;
  const Mode& mode = st->setup.modes[mode_number];
  const Mapping& mapping = st->setup.mappings[mode.mapping];
  uint32_t n = mode.blockflag ? st->n1 : st->n0;
  bool prev_flag = true, next_flag = true;
  if (mode.blockflag) {
    if (!cur.read_flag(&prev_flag) || !cur.read_flag(&next_flag))
      return LT_BAD;
  }
  *mode_out = (int32_t)mode_number;
  *prev_out = prev_flag;
  *next_out = next_flag;

  // ---- floors (EOP => channel unused; bad data => whole packet bad) ----
  // Register-resident across every channel's floor: raw reads and huffman
  // symbols run on BitRegs (read_r / huff_decode_cb_r), synced back to the
  // cursor once at the end — the per-symbol cursor-object round trip was
  // ~20% of packet time (PERF.md r4).
  sc.no_residue.assign(C, 0);
  std::vector<uint8_t>& no_residue = sc.no_residue;
  const uint8_t* fdata = cur.data();
  const size_t flen = cur.size();
  BitRegs frg;
  cur.sync_out(&frg.acc, &frg.nbits, &frg.pos);
  for (uint32_t ch = 0; ch < C; ++ch) {
    const Floor& fl = st->setup.floors[mapping.submap_floor[mapping.mux[ch]]];
    if (fl.type == 0) {
      const Floor0& f = fl.f0;
      // amplitude can be up to 64 bits wide (header-validated)
      uint64_t amplitude = 0;
      {
        uint32_t lo_bits = f.amplitude_bits > 32 ? 32 : f.amplitude_bits;
        uint32_t lo;
        if (!read_r(frg, fdata, flen, lo_bits, &lo)) {
          no_residue[ch] = true;
          continue;
        }
        amplitude = lo;
        if (f.amplitude_bits > 32) {
          uint32_t hi;
          if (!read_r(frg, fdata, flen, f.amplitude_bits - 32, &hi)) {
            no_residue[ch] = true;
            continue;
          }
          amplitude |= (uint64_t)hi << 32;
        }
      }
      if (amplitude == 0) {
        no_residue[ch] = true;
        continue;
      }
      uint32_t booknumber;
      if (!read_r(frg, fdata, flen, ilog(f.books.size()), &booknumber)) {
        no_residue[ch] = true;
        continue;
      }
      if (booknumber >= f.books.size()) return LT_BAD;
      const Codebook& cb = st->setup.codebooks[f.books[booknumber]];
      if (!cb.has_vq) return LT_BAD;
      float* cosc = f0_cosc + (size_t)ch * Omax;
      uint32_t got = 0;
      float last = 0.0f;
      bool eop = false;
      while (got < f.order) {
        uint32_t e;
        if (!huff_decode_cb_r(frg, fdata, flen, cb, &e)) {
          eop = true;
          break;
        }
        const float* vec = cb.vq.data() + (size_t)e * cb.dimensions;
        for (uint16_t j = 0; j < cb.dimensions && got < f.order; ++j)
          cosc[got++] = (float)cos((double)(last + vec[j]));
        if (got < f.order)
          last = last + vec[cb.dimensions - 1];  // ref accumulation
      }
      if (eop) {
        no_residue[ch] = true;
        continue;
      }
      f_kind[ch] = 1;  // "floor used" flag; floor type is static per setup
      f0_amp[ch] = (float)amplitude;
    } else {
      const Floor1& f = fl.f1;
      uint32_t nonzero;
      if (!read_r(frg, fdata, flen, 1, &nonzero) || !nonzero) {
        no_residue[ch] = true;
        continue;
      }
      int rng = kFloor1Ranges[f.multiplier - 1];
      uint32_t b = ilog((uint32_t)rng - 1);
      size_t values = f.x_list.size();
      sc.y.assign(values, 0);
      std::vector<uint32_t>& y = sc.y;
      bool eop = false;
      if (!read_r(frg, fdata, flen, b, &y[0]) ||
          !read_r(frg, fdata, flen, b, &y[1])) {
        no_residue[ch] = true;
        continue;
      }
      size_t yi = 2;
      for (size_t p = 0; p < f.partition_class.size() && !eop; ++p) {
        uint8_t cls = f.partition_class[p];
        uint8_t cdim = f.class_dims[cls];
        uint8_t cbits = f.class_subclasses[cls];
        uint32_t csub = (1u << cbits) - 1;
        uint32_t cval = 0;
        if (cbits > 0) {
          const Codebook& mb =
              st->setup.codebooks[f.class_masterbooks[cls]];
          if (!huff_decode_cb_r(frg, fdata, flen, mb, &cval)) {
            eop = true;
            break;
          }
        }
        for (uint8_t d = 0; d < cdim; ++d) {
          int16_t book = f.subclass_books[cls][cval & csub];
          cval >>= cbits;
          if (book >= 0) {
            uint32_t t;
            if (!huff_decode_cb_r(frg, fdata, flen,
                                  st->setup.codebooks[book], &t)) {
              eop = true;
              break;
            }
            y[yi++] = t;
          } else {
            y[yi++] = 0;
          }
        }
      }
      if (eop) {
        no_residue[ch] = true;
        continue;
      }
      // amplitude reconstruction (spec 7.2.4 part 1), libvorbis-exact
      // (verified against libvorbis 1.3.7 floor1_inverse1 by disassembly;
      // see lewton_tpu/floor.py floor1_amplitudes for the semantics —
      // the reference's u32-wrap quirk diverges on escape-heavy posts):
      // fit values evolve as signed ints, neighbors read masked &0x7fff,
      // nonzero vals store (escape+predicted)&0x7fff and clear neighbor
      // flags, zero vals store predicted|0x8000.
      sc.fit.resize(values);
      std::vector<int32_t>& fit = sc.fit;
      fit[0] = (int32_t)y[0];
      fit[1] = (int32_t)y[1];
      for (size_t i = 2; i < values; ++i) {
        size_t lo = f.low_neighbors[i], hi = f.high_neighbors[i];
        int32_t predicted =
            render_point((int32_t)f.x_list[lo], fit[lo] & 0x7fff,
                         (int32_t)f.x_list[hi], fit[hi] & 0x7fff,
                         (int32_t)f.x_list[i]);
        int32_t val = (int32_t)y[i];
        int32_t highroom = rng - predicted;
        int32_t lowroom = predicted;
        int32_t room = 2 * (highroom < lowroom ? highroom : lowroom);
        if (val) {
          int32_t v;
          if (val >= room) {
            v = highroom > lowroom ? val - lowroom : -1 - (val - highroom);
          } else {
            v = (val & 1) ? -((val + 1) >> 1) : val >> 1;
          }
          fit[i] = (v + predicted) & 0x7fff;
          fit[lo] &= 0x7fff;
          fit[hi] &= 0x7fff;
        } else {
          fit[i] = predicted | 0x8000;
        }
      }
      // emit INDEX-SPACE values (fit*multiplier clamped to 0..255) in
      // sorted-x order — libvorbis's floor1_inverse2 render endpoints
      int32_t* ys = f1_ys + (size_t)ch * P;
      uint8_t* fs = f1_flags + (size_t)ch * P;
      for (size_t i = 0; i < values; ++i) {
        uint16_t si = f.sort_order[i];
        int32_t fv = fit[si];
        int32_t idx = (fv & 0x7fff) * (int32_t)f.multiplier;
        ys[i] = idx > 255 ? 255 : idx;
        fs[i] = (fv & ~0x7fff) == 0;
      }
      f_kind[ch] = 1;
    }
  }
  cur.sync_in(frg.acc, frg.nbits, frg.pos);

  // ---- no_residue propagation via coupling (spec 4.3.4) ----
  for (size_t s = 0; s < mapping.coupling_magnitude.size(); ++s) {
    uint8_t mag = mapping.coupling_magnitude[s];
    uint8_t ang = mapping.coupling_angle[s];
    if (!(no_residue[mag] && no_residue[ang])) {
      no_residue[mag] = false;
      no_residue[ang] = false;
    }
  }

  cur.sync_out(&hs->acc, &hs->nbits, &hs->pos);
  hs->mapping_idx = mode.mapping;
  hs->n = n;
  return LT_OK;
}

// The calling worker's row of stage slots (LT_NS_*): for_streams points
// it at the worker's row of the caller's block when one is given, else it
// stays null and no clock is read.
thread_local uint64_t* tl_stage_ns = nullptr;

// The calling worker's slot of stage k, or null.
static inline uint64_t* stage_slot(int k) {
  return tl_stage_ns ? tl_stage_ns + k : nullptr;
}

static inline uint64_t steady_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Adds the nanoseconds of its scope to *slot; a null slot reads no clock.
struct StageClock {
  uint64_t* const slot;
  const uint64_t a;
  explicit StageClock(uint64_t* s) : slot(s), a(s ? steady_ns() : 0) {}
  ~StageClock() {
    if (slot) *slot += steady_ns() - a;
  }
};

// Residue section: decodes into the (already zeroed) residue rows.
// sc.no_residue must hold the head's propagated flags.
static int decode_packet_residues(Stream* st, BitCursor& cur,
                                  const Mapping& mapping, uint32_t n,
                                  float* residue, uint32_t rw,
                                  DecodeScratch& sc) {
  const uint32_t C = st->channels;
  std::vector<uint8_t>& no_residue = sc.no_residue;
  size_t n_submaps = mapping.submap_floor.size();
  std::vector<float>& inter = sc.inter;  // type-2 interleave scratch
  for (size_t sm = 0; sm < n_submaps; ++sm) {
    uint32_t chans[256];  // channel count is 8 bits (header-validated)
    uint32_t ch_cnt = 0;
    for (uint32_t j = 0; j < C; ++j)
      if (mapping.mux[j] == sm) chans[ch_cnt++] = j;
    const uint32_t res_idx = mapping.submap_residue[sm];
    const Residue& r = st->setup.residues[res_idx];
    const std::vector<uint8_t>& class_lut = st->class_luts[res_idx];
    const uint8_t pass_used = st->pass_used[res_idx];
    if (ch_cnt == 0) continue;

    // channel vectors: pointers into the output residue slices
    if (r.residue_type == 2) {
      bool all_dnd = true;
      for (uint32_t k = 0; k < ch_cnt; ++k)
        all_dnd &= (bool)no_residue[chans[k]];
      if (all_dnd) continue;
      const uint32_t blocksize = n * ch_cnt;
      uint32_t actual = blocksize / 2;
      uint32_t actual_size = actual;
      uint32_t begin = r.begin < actual_size ? r.begin : actual_size;
      uint32_t end = r.end < actual_size ? r.end : actual_size;
      // Stereo direct-write mode: every interleaved position p < end has
      // p>>1 < rw, so partitions accumulate straight into the two channel
      // rows (vq_run2) — no inter buffer, no memset, no deinterleave.
      const bool direct2 = ch_cnt == 2 && (uint64_t)end <= 2 * (uint64_t)rw;
      float* __restrict dr0 = residue + (size_t)chans[0] * rw;
      float* __restrict dr1 =
          residue + (size_t)chans[ch_cnt > 1 ? 1 : 0] * rw;
      // time clearing and deinterleaving `inter` (frontend.deinterleave_ns)
      uint64_t* const deint_ns =
          direct2 ? nullptr : stage_slot(LT_NS_DEINTERLEAVE);
      if (!direct2) {
        const StageClock clock(deint_ns);
        inter.assign(actual, 0.0f);
      }
      const Codebook& classbook = st->setup.codebooks[r.classbook];
      uint32_t cpc = classbook.dimensions;
      uint32_t n_to_read = end - begin;
      if (n_to_read) {
        if (cpc == 0) return LT_BAD;
        uint32_t partitions_to_read = n_to_read / r.partition_size;
        sc.cl.assign(partitions_to_read + cpc, 0);
        std::vector<uint32_t>& cl = sc.cl;
        // Section-resident decode: the cursor lives in registers across
        // ALL partitions/classwords/passes; book transitions are one
        // BookDesc load; adjacent same-book partitions fuse into a single
        // vq run (the hot loop averages ~2.5 symbols per partition visit,
        // so transitions dominate — see PERF.md r4).
        const Stream::BookDesc* descs = st->res_descs[res_idx].data();
        const int32_t* ctab =
            classbook.huff.single() ? nullptr : classbook.huff.lut_data();
        const uint32_t clbits = ctab ? classbook.huff.lut_bits() : 0;
        const uint32_t clmask = ctab ? (1u << clbits) - 1 : 0;
        const uint8_t* data = cur.data();
        const size_t dlen = cur.size();
        BitRegs rg;
        cur.sync_out(&rg.acc, &rg.nbits, &rg.pos);
        bool eop = false;
        for (int pass = 0; pass < 8 && !eop; ++pass) {
          if (pass > 0 && !(pass_used & (1u << pass))) continue;
          uint32_t pc = 0;
          while (pc < partitions_to_read && !eop) {
            // pass 0 reads one classword per cpc partitions and may not
            // fuse runs across the group boundary; later passes reuse the
            // stored classes and fuse across the whole extent
            uint32_t group_end = partitions_to_read;
            if (pass == 0) {
              uint32_t temp;
              if (!huff_decode_r(rg, data, dlen, ctab, clbits, clmask,
                                 &classbook.huff, &temp)) {
                eop = true;
                break;
              }
              if (!class_lut.empty()) {
                const uint8_t* src = class_lut.data() + (size_t)temp * cpc;
                for (uint32_t i = 0; i < cpc; ++i) cl[i + pc] = src[i];
              } else {
                for (int i = (int)cpc - 1; i >= 0; --i) {
                  cl[i + pc] = temp % r.classifications;
                  temp /= r.classifications;
                }
              }
              group_end = pc + cpc < partitions_to_read
                              ? pc + cpc
                              : partitions_to_read;
            }
            while (pc < group_end) {
              const Stream::BookDesc& bd = descs[(size_t)cl[pc] * 8 + pass];
              if (bd.book < 0) {
                ++pc;
                continue;
              }
              const uint32_t offs = begin + pc * r.partition_size;
              if (bd.lut) {
                // Exact-tile fast path (nsym*dim == partition_size): when
                // dim does not divide partition_size, the last vector's
                // tail components are READ but DISCARDED at the partition
                // boundary — libvorbis-oracle semantics (codebook.c
                // vorbis_book_decodev_add clips at n=samples_per_partition;
                // lewton src/audio.rs:601-614 instead adds across the
                // boundary — we follow the oracle, see residue.py). The
                // exact-tile condition also bounds every write: offs +
                // partition_size <= end (<= 2*rw under direct2, <= rw via
                // w_eff otherwise).
                uint32_t run = 1;
                while (pc + run < group_end &&
                       descs[(size_t)cl[pc + run] * 8 + pass].book ==
                           bd.book)
                  ++run;
                const uint32_t nsym = bd.nsym * run;
                const bool ok =
                    direct2 ? vq_run2_dim_r(rg, data, dlen, bd, dr0, dr1,
                                            offs, nsym)
                            : vq_run_dim_r(rg, data, dlen, bd,
                                           inter.data() + offs, nsym);
                if (!ok) {
                  eop = true;
                  break;
                }
                pc += run;
                continue;
              }
              // generic partition (odd dims, single-entry books,
              // partition-crossing vectors): clip writes at the partition
              // boundary, keep reading to ceil(psize/dim)
              const Codebook& book = st->setup.codebooks[bd.book];
              const uint32_t dim = book.dimensions;
              const float* __restrict vqt = book.vq.data();
              cur.sync_in(rg.acc, rg.nbits, rg.pos);
              uint32_t i = 0;
              while (i < r.partition_size) {
                uint32_t e;
                if (!book.huff.decode(&cur, &e)) {
                  eop = true;
                  break;
                }
                const float* ve = vqt + (size_t)e * dim;
                const uint32_t lim = dim < r.partition_size - i
                                         ? dim
                                         : r.partition_size - i;
                if (direct2) {
                  const uint32_t base = offs + i;
                  float* ra = (base & 1) ? dr1 : dr0;
                  float* rb = (base & 1) ? dr0 : dr1;
                  const uint32_t qa = base >> 1, qb = (base + 1) >> 1;
                  for (uint32_t j = 0; 2 * j < lim; ++j)
                    ra[qa + j] += ve[2 * j];
                  for (uint32_t j = 0; 2 * j + 1 < lim; ++j)
                    rb[qb + j] += ve[2 * j + 1];
                } else {
                  vq_add(inter.data() + offs + i, ve, lim);
                }
                i += dim;
              }
              cur.sync_out(&rg.acc, &rg.nbits, &rg.pos);
              if (eop) break;
              ++pc;
            }
          }
        }
        cur.sync_in(rg.acc, rg.nbits, rg.pos);
      }
      if (!direct2) {
        const StageClock clock(deint_ns);
        // deinterleave: channel j takes every ch-th value starting at j
        for (uint32_t k = 0; k < ch_cnt; ++k) {
          float* dst = residue + (size_t)chans[k] * rw;
          for (uint32_t i = k, o = 0; i < actual && o < rw; i += ch_cnt, ++o)
            dst[o] = inter[i];
        }
      }
    } else {
      // types 0/1: per-channel (frontend.residue01_ns)
      const StageClock clock(stage_slot(LT_NS_RESIDUE01));
      uint32_t actual_size = n / 2;
      uint32_t begin = r.begin < actual_size ? r.begin : actual_size;
      uint32_t end = r.end < actual_size ? r.end : actual_size;
      const Codebook& classbook = st->setup.codebooks[r.classbook];
      uint32_t cpc = classbook.dimensions;
      uint32_t n_to_read = end - begin;
      if (n_to_read == 0) continue;
      if (cpc == 0) return LT_BAD;
      uint32_t partitions_to_read = n_to_read / r.partition_size;
      sc.cl.assign((size_t)(partitions_to_read + cpc) * ch_cnt, 0);
      std::vector<uint32_t>& cl = sc.cl;
      bool eop = false;
      for (int pass = 0; pass < 8 && !eop; ++pass) {
        if (pass > 0 && !(pass_used & (1u << pass))) continue;
        uint32_t pc = 0;
        while (pc < partitions_to_read && !eop) {
          if (pass == 0) {
            for (uint32_t j = 0; j < ch_cnt; ++j) {
              if (no_residue[chans[j]]) continue;
              uint32_t temp;
              if (!classbook.huff.decode(&cur, &temp)) {
                eop = true;
                break;
              }
              if (!class_lut.empty()) {
                const uint8_t* src = class_lut.data() + (size_t)temp * cpc;
                uint32_t* dst = cl.data() +
                                (size_t)j * (partitions_to_read + cpc) + pc;
                for (uint32_t i = 0; i < cpc; ++i) dst[i] = src[i];
              } else {
                for (int i = (int)cpc - 1; i >= 0; --i) {
                  cl[j * (partitions_to_read + cpc) + i + pc] =
                      temp % r.classifications;
                  temp /= r.classifications;
                }
              }
            }
            if (eop) break;
          }
          for (uint32_t ci = 0; ci < cpc && pc < partitions_to_read;
               ++ci, ++pc) {
            for (uint32_t j = 0; j < ch_cnt; ++j) {
              if (no_residue[chans[j]]) continue;
              uint32_t offs = begin + pc * r.partition_size;
              int16_t book_idx =
                  r.books[cl[j * (partitions_to_read + cpc) + pc]][pass];
              if (book_idx < 0) continue;
              const Codebook& book = st->setup.codebooks[book_idx];
              uint32_t dim = book.dimensions;
              float* row = residue + (size_t)chans[j] * rw;
              if (r.residue_type == 0) {
                uint32_t step = r.partition_size / dim;
                for (uint32_t i = 0; i < step; ++i) {
                  uint32_t e;
                  if (!book.huff.decode(&cur, &e)) {
                    eop = true;
                    break;
                  }
                  const float* vec = book.vq.data() + (size_t)e * dim;
                  for (uint32_t d = 0; d < dim; ++d) {
                    uint32_t pos = offs + i + d * step;
                    if (pos < rw) row[pos] += vec[d];
                  }
                }
              } else {
                uint32_t nsym =
                    dim ? (r.partition_size + dim - 1) / dim : 0;
                // exact-tile fast path only (see the type-2 comment:
                // crossing vectors clip at the partition boundary per the
                // libvorbis oracle); offs + partition_size <= end <= rw
                // via w_eff, so tiled writes need no rw guard
                if (nsym && vq_run_supported(dim) && !book.huff.single() &&
                    nsym * dim == r.partition_size &&
                    offs + (uint64_t)r.partition_size <= rw) {
                  if (!vq_run_dim(&cur, book, row + offs, nsym, dim))
                    eop = true;  // false == EOP
                } else {
                  const float* __restrict vq = book.vq.data();
                  uint32_t i = 0;
                  while (i < r.partition_size) {
                    uint32_t e;
                    if (!book.huff.decode(&cur, &e)) {
                      eop = true;
                      break;
                    }
                    uint32_t lim = dim < r.partition_size - i
                                       ? dim
                                       : r.partition_size - i;
                    if (offs + i + lim > rw)
                      lim = offs + i < rw ? rw - (offs + i) : 0;
                    if (lim)
                      vq_add(row + offs + i, vq + (size_t)e * dim, lim);
                    i += dim;
                  }
                }
              }
              if (eop) break;
            }
            if (eop) break;
          }
        }
      }
    }
  }
  return LT_OK;
}

// Decode floors + residues for one packet into the dense per-packet slices.
// Returns a status code.
int decode_packet(Stream* st, const uint8_t* pck, size_t len,
                  int32_t* mode_out, uint8_t* prev_out,
                  uint8_t* next_out, float* residue,  // [C, rw]
                  uint8_t* f_kind,                    // [C]
                  int32_t* f1_ys, uint8_t* f1_flags,  // [C, P] sorted
                  float* f0_cosc, float* f0_amp,      // [C,Omax],[C]
                  uint32_t rw,    // residue row width (<= n1/2); writes past
                                  // it drop, bit consumption is unchanged
                  DecodeScratch* scratch) {
  DecodeScratch local;
  DecodeScratch& sc = scratch ? *scratch : local;
  HeadState hs;
  int s = decode_packet_head(st, pck, len, mode_out, prev_out, next_out,
                             residue, f_kind, f1_ys, f1_flags, f0_cosc,
                             f0_amp, rw, sc, &hs);
  if (s != LT_OK) return s;
  BitCursor cur(pck, len);
  cur.sync_in(hs.acc, hs.nbits, hs.pos);
  return decode_packet_residues(st, cur,
                                st->setup.mappings[hs.mapping_idx], hs.n,
                                residue, rw, sc);
}

}  // namespace lt

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

using lt::Stream;

extern "C" {

Stream* lt_stream_new(const uint8_t* ident_pck, size_t ident_len,
                      const uint8_t* setup_pck, size_t setup_len, char* err,
                      size_t err_len) try {
  auto st = std::make_unique<Stream>();
  std::string e = lt::read_header_ident(ident_pck, ident_len, &st->ident);
  if (e.empty())
    e = lt::read_header_setup(setup_pck, setup_len, st->ident, &st->setup);
  if (!e.empty()) {
    if (err && err_len) {
      strncpy(err, e.c_str(), err_len - 1);
      err[err_len - 1] = 0;
    }
    return nullptr;
  }
  st->channels = st->ident.channels;
  st->n0 = st->ident.bs0();
  st->n1 = st->ident.bs1();
  st->W = st->n1 / 2;
  uint32_t P = 2, Omax = 0;
  for (const lt::Floor& f : st->setup.floors) {
    if (f.type == 1 && f.f1.x_list.size() > P)
      P = (uint32_t)f.f1.x_list.size();
    if (f.type == 0 && f.f0.order > Omax) Omax = f.f0.order;
  }
  st->P = P;
  st->Omax = Omax;
  st->class_luts.resize(st->setup.residues.size());
  st->pass_used.resize(st->setup.residues.size());
  for (size_t ri = 0; ri < st->setup.residues.size(); ++ri) {
    const lt::Residue& r = st->setup.residues[ri];
    uint8_t pmask = 0;
    for (const auto& row : r.books)
      for (int p = 0; p < 8; ++p)
        if (row[p] >= 0) pmask |= (uint8_t)(1u << p);
    st->pass_used[ri] = pmask;
    if (r.classbook >= st->setup.codebooks.size()) continue;
    const lt::Codebook& cb = st->setup.codebooks[r.classbook];
    uint32_t cpc = cb.dimensions, entries = cb.entries;
    if (!cpc || !r.classifications) continue;
    if ((uint64_t)entries * cpc > (1u << 20)) continue;  // hostile setups
    std::vector<uint8_t>& lut = st->class_luts[ri];
    lut.resize((size_t)entries * cpc);
    for (uint32_t e = 0; e < entries; ++e) {
      uint32_t temp = e;
      for (int i = (int)cpc - 1; i >= 0; --i) {
        lut[(size_t)e * cpc + i] = (uint8_t)(temp % r.classifications);
        temp /= r.classifications;
      }
    }
  }
  // Per-residue flattened book descriptors ([class*8 + pass], one load at
  // every partition transition).
  st->res_descs.resize(st->setup.residues.size());
  for (size_t ri = 0; ri < st->setup.residues.size(); ++ri) {
    const lt::Residue& r = st->setup.residues[ri];
    std::vector<lt::Stream::BookDesc>& descs = st->res_descs[ri];
    descs.assign((size_t)r.classifications * 8, lt::Stream::BookDesc{});
    for (size_t c = 0; c < r.books.size() && c < r.classifications; ++c) {
      for (int p = 0; p < 8; ++p) {
        int16_t bi = r.books[c][p];
        if (bi < 0 || (size_t)bi >= st->setup.codebooks.size()) continue;
        lt::Stream::BookDesc& d = descs[c * 8 + p];
        const lt::Codebook& bk = st->setup.codebooks[bi];
        d.book = bi;
        d.huf = &bk.huff;
        d.dim = (uint16_t)bk.dimensions;
        const uint32_t dim = bk.dimensions;
        const bool tile =
            bk.has_vq && dim >= 1 && dim <= 8 && dim != 5 && dim != 7 &&
            !bk.huff.single() && !bk.huff.empty() && r.partition_size > 0 &&
            r.partition_size % dim == 0;
        if (tile) {
          d.lut = bk.huff.lut_data();
          d.lbits = (uint16_t)bk.huff.lut_bits();
          d.lmask = (1u << d.lbits) - 1;
          d.vq = bk.vq.data();
          d.nsym = r.partition_size / dim;
        }
      }
    }
  }
  return st.release();
} catch (const std::exception& ex) {
  // C++ exceptions (e.g. bad_alloc on a hostile setup) must never cross the
  // C ABI into ctypes — that aborts the whole process.
  if (err && err_len) {
    strncpy(err, ex.what(), err_len - 1);
    err[err_len - 1] = 0;
  }
  return nullptr;
}

void lt_stream_free(Stream* st) { delete st; }

// geometry accessors for the Python side
int lt_stream_channels(const Stream* st) { return (int)st->channels; }
int lt_stream_n0(const Stream* st) { return (int)st->n0; }
int lt_stream_n1(const Stream* st) { return (int)st->n1; }
int lt_stream_rate(const Stream* st) { return (int)st->ident.sample_rate; }
int lt_stream_max_posts(const Stream* st) { return (int)st->P; }
int lt_stream_f0_order_max(const Stream* st) { return (int)st->Omax; }
int lt_stream_n_modes(const Stream* st) {
  return (int)st->setup.modes.size();
}
int lt_stream_mode_blockflag(const Stream* st, int m) {
  return st->setup.modes[m].blockflag;
}

}  // extern "C"

namespace {

// Where decode_packet's f32 residue row [C, rw] goes, one class per emit.
// F32Rows: the row IS the packet's output row. I16Rows / P12Rows: the
// packet decodes into one hot f32 scratch row, then store() writes it out
// (the multi-MB chunk buffer is written once and never re-read cold).
struct F32Rows {
  float* out;
  size_t n;  // C * rw
  float* row(int t) { return out + (size_t)t * n; }
  void store(int, const float*) {}
};

// int16 emit: exact when the setup's residue codebooks are statically
// integer-valued with a worst-case |sum| < 32768 (see
// models/decoder.residue_i16_bound); the frame tensor, the H2D payload,
// halves. The clamp only guards stale scratch on exception paths (status
// != 0 frames are masked downstream; clamping keeps the cast UB-free).
struct I16Rows {
  int16_t* out;
  size_t n;
  std::vector<float> scratch;
  I16Rows(int16_t* o, size_t n_) : out(o), n(n_), scratch(n_) {}
  float* row(int) { return scratch.data(); }
  void store(int t, const float* __restrict src) {
    int16_t* __restrict dst = out + (size_t)t * n;
    for (size_t i = 0; i < n; ++i) {
      float v = src[i];
      v = v < -32768.0f ? -32768.0f : (v > 32767.0f ? 32767.0f : v);
      dst[i] = (int16_t)v;
    }
  }
};

// 12-bit emit: the row packed into the p12 planes (layout documented at
// lt_pack12 / parallel/pack12.py), 3/8 of the i16 bytes. Exact when the
// setup passes pack12_supported (static |residue| bound < 2048, row width
// divisible by 8); the clamp is I16Rows'.
struct P12Rows {
  uint32_t* out;
  size_t K;  // n / 8: a packet's row is 3 * K words
  std::vector<float> scratch;
  P12Rows(uint32_t* o, size_t n) : out(o), K(n / 8), scratch(n) {}
  float* row(int) { return scratch.data(); }
  void store(int t, const float* __restrict src) {
    uint32_t* __restrict dst = out + (size_t)t * 3 * K;
    for (size_t g = 0; g < K; ++g) {
      uint32_t u[8];
      for (int j = 0; j < 8; ++j) {
        float v = src[j * K + g];
        v = v < -2048.0f ? -2048.0f : (v > 2047.0f ? 2047.0f : v);
        u[j] = (uint32_t)(int32_t)v & 0xFFFu;
      }
      dst[0 * K + g] = u[0] | (u[1] << 12) | ((u[2] & 0xFFu) << 24);
      dst[1 * K + g] =
          (u[2] >> 8) | (u[3] << 4) | (u[4] << 16) | ((u[5] & 0xFu) << 28);
      dst[2 * K + g] = (u[5] >> 4) | (u[6] << 8) | (u[7] << 20);
    }
  }
};

// One stream's T packets (packet t at buf + offs[t], lens[t] bytes) into
// its dense [T, ...] frames, in order, one scratch reused across them.
template <class Rows>
void decode_stream(Stream* st, const uint8_t* buf, const uint64_t* offs,
                   const uint64_t* lens, int T, int32_t* mode,
                   uint8_t* prevf, uint8_t* nextf, uint8_t* status,
                   Rows&& rows, uint8_t* f_kind, int32_t* f1_ys,
                   uint8_t* f1_flags, float* f0_cosc, float* f0_amp,
                   int rw) {
  const size_t C = st->channels, P = st->P, Om = st->Omax;
  lt::DecodeScratch scratch;
  for (int t = 0; t < T; ++t) {
    float* row = rows.row(t);
    try {
      status[t] = (uint8_t)lt::decode_packet(
          st, buf + offs[t], lens[t], mode + t, prevf + t, nextf + t, row,
          f_kind + (size_t)t * C, f1_ys + (size_t)t * C * P,
          f1_flags + (size_t)t * C * P, f0_cosc + (size_t)t * C * Om,
          f0_amp + (size_t)t * C, (uint32_t)rw, &scratch);
    } catch (const std::exception&) {
      status[t] = lt::LT_BAD;  // never let C++ exceptions cross the C ABI
    }
    rows.store(t, row);
  }
}

using Clock = std::chrono::steady_clock;

uint64_t ns_of(Clock::duration d) {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(d)
      .count();
}

// One call's work for the pool: the streams to decode in claim order, a
// shared index into it, and each worker's clocks.
struct Job {
  void (*run)(const void* ctx, int s);
  const void* ctx;
  const int* order;  // streams with packets, the most bytes first
  int n;             // their count
  int workers;       // the caller is worker 0
  Clock::time_point t0;
  uint64_t* busy_ns;   // [workers] or null
  uint64_t* stage_ns;  // [workers][LT_NS_SLOTS] or null
  std::vector<int64_t> end_ns;  // [workers]: from t0, -1 for a worker that
                                // never joined
  std::atomic<int> next{0};
  int active = 0;  // pool threads inside the job (under Pool::mu_)
};

// Worker k's part of a job: claim the next stream of the order until it
// runs out. A worker's end is the moment it finds the order exhausted.
void work(Job& j, int k) {
  const auto a = Clock::now();
  lt::tl_stage_ns =
      j.stage_ns ? j.stage_ns + (size_t)k * lt::LT_NS_SLOTS : nullptr;
  for (int i; (i = j.next.fetch_add(1, std::memory_order_relaxed)) < j.n;)
    j.run(j.ctx, j.order[i]);
  lt::tl_stage_ns = nullptr;
  const auto e = Clock::now();
  if (j.busy_ns) j.busy_ns[k] = ns_of(e - a);
  j.end_ns[k] = (int64_t)ns_of(e - j.t0);
}

// The chunk entry's workers, shared by every stream of the process: made
// at the first call that asks for more than one, grown to the most a call
// asks for (n_threads - 1: the caller is the other worker), never joined.
// Between calls they sleep on a condition variable. One call at a time: a
// second caller waits for the first.
class Pool {
 public:
  explicit Pool(pid_t p) : pid(p) {}
  const pid_t pid;  // a forked child makes its own pool

  // Runs the job with j.workers workers, the caller as worker 0, once the
  // pool holds `size` threads, and returns the threads started for it. A
  // thread that cannot be started leaves its share to the others.
  int run(Job& j, int size) {
    std::lock_guard<std::mutex> one_call(call_mu_);
    int spawned = 0;
    {
      std::lock_guard<std::mutex> lk(mu_);
      while ((int)threads_.size() < size) {
        try {
          threads_.emplace_back(&Pool::loop, this,
                                (int)threads_.size() + 1, gen_);
        } catch (...) {
          break;
        }
        ++spawned;
      }
      job_ = &j;
      ++gen_;
    }
    wake_.notify_all();
    work(j, 0);
    std::unique_lock<std::mutex> lk(mu_);
    job_ = nullptr;  // the order is exhausted: a late waker stays out
    done_.wait(lk, [&] { return j.active == 0; });
    return spawned;
  }

 private:
  // Pool thread k (worker k of a job), first waiting for a job after
  // generation `seen`.
  void loop(int k, uint64_t seen) {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      wake_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      Job* j = job_;
      if (!j || k >= j->workers) continue;
      ++j->active;
      lk.unlock();
      work(*j, k);
      lk.lock();
      if (--j->active == 0) done_.notify_all();
    }
  }

  std::mutex call_mu_;
  std::mutex mu_;
  std::condition_variable wake_, done_;
  std::vector<std::thread> threads_;
  Job* job_ = nullptr;
  uint64_t gen_ = 0;
};

// This process's pool, or null when it cannot be made. A pool inherited
// through fork() has no threads in the child: the child leaves it (and its
// locks, whatever state they were copied in) alone and makes its own.
Pool* process_pool() {
  static std::atomic<Pool*> pool{nullptr};
  const pid_t me = getpid();
  for (;;) {
    Pool* p = pool.load(std::memory_order_acquire);
    if (p && p->pid == me) return p;
    Pool* mine = new (std::nothrow) Pool(me);
    if (!mine) return nullptr;
    if (pool.compare_exchange_strong(p, mine)) return mine;
    delete mine;  // another thread installed one first
  }
}

// The last chunk call's pool counters, on the thread that made it.
struct PoolStats {
  uint64_t spawned = 0, tail_ns = 0;
};
thread_local PoolStats tl_pool_stats;

// Runs run(s) for each stream s in [0, S) with packets (lens [S, T],
// counts [S]). With n_threads > 1 and S > 1, min(n_threads, S) workers, the
// caller and the pool's threads, take the streams one at a time from one
// shared index, the most packet bytes first (a stable order: ties keep
// index order); else the caller runs them all in index order. Every stream
// writes only its own frames, so the output does not depend on the split.
//
// busy_ns, wall_ns and stage_ns may be null. When given, busy_ns[k]
// receives worker k's time from its start in the call to its last
// stream's end, one slot per worker (0 for a worker that never joined),
// and *wall_ns the call's wall time, from entry to the last worker's end,
// times its worker count, both from steady_clock: their ratio is the
// workers' fill. stage_ns is a block of [workers][LT_NS_SLOTS]: worker k
// adds to row k its time in each stage of decode_packet_residues that an
// LT_NS_* constant names. tl_pool_stats gets the threads started for the
// call and its tail: from the first worker finding the order exhausted
// to the last worker's end.
template <typename Run>
void for_streams(int S, int T, const uint64_t* lens, const int32_t* counts,
                 int n_threads, uint64_t* busy_ns, uint64_t* wall_ns,
                 uint64_t* stage_ns, const Run& run) {
  const auto t0 = Clock::now();
  tl_pool_stats = PoolStats{};
  const int nt =
      (n_threads <= 1 || S <= 1) ? 1 : (n_threads < S ? n_threads : S);
  Pool* pool = nt > 1 ? process_pool() : nullptr;
  if (!pool) {
    lt::tl_stage_ns = stage_ns;
    for (int s = 0; s < S; ++s) run(s);
    lt::tl_stage_ns = nullptr;
    const uint64_t wall = ns_of(Clock::now() - t0);
    if (busy_ns) {
      busy_ns[0] = wall;
      for (int k = 1; k < nt; ++k) busy_ns[k] = 0;
    }
    if (wall_ns) *wall_ns = wall * (uint64_t)nt;
    return;
  }
  std::vector<int> order;
  std::vector<uint64_t> bytes(S, 0);
  order.reserve(S);
  for (int s = 0; s < S; ++s) {
    if (counts[s] <= 0) continue;
    const uint64_t* l = lens + (size_t)s * T;
    for (int t = 0; t < counts[s]; ++t) bytes[s] += l[t];
    order.push_back(s);
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return bytes[a] > bytes[b]; });
  Job j;
  j.run = [](const void* ctx, int s) { (*static_cast<const Run*>(ctx))(s); };
  j.ctx = &run;
  j.order = order.data();
  j.n = (int)order.size();
  j.workers = nt;
  j.t0 = t0;
  j.busy_ns = busy_ns;
  j.stage_ns = stage_ns;
  j.end_ns.assign(nt, -1);
  if (busy_ns) std::fill(busy_ns, busy_ns + nt, 0);
  tl_pool_stats.spawned = (uint64_t)pool->run(j, n_threads - 1);
  int64_t first = j.end_ns[0], last = j.end_ns[0];
  for (int64_t e : j.end_ns) {
    if (e < 0) continue;
    first = std::min(first, e);
    last = std::max(last, e);
  }
  tl_pool_stats.tail_ns = (uint64_t)(last - first);
  if (wall_ns) *wall_ns = (uint64_t)last * (uint64_t)nt;
}

}  // namespace

extern "C" {

// The front-end's one chunk entry: S streams x up to T packets each into
// the [S, T, ...] frame block, in ONE call (per-stream ctypes marshaling
// measured ~25% of front-end wall time at production chunk shapes). Packet
// i of stream s is at bufs[s] + offs[s*T + i], lens[s*T + i] bytes; each
// stream's base may be its own demux blob, or one blob shared by all;
// counts[s] packets are decoded per stream, and slots past them are left
// as they are. emit selects the residue frames' type (LT_EMIT_*): f32 and
// i16 rows of C*rw elements, or p12 rows of 3*(C*rw)/8 u32 words (C*rw
// divisible by 8). n_threads and the counters: for_streams. Returns S,
// or -1 (nothing decoded) on an emit it does not know or a p12 row width
// not divisible by 8.
int lt_decode_chunk(Stream* st, const uint8_t* const* bufs,
                    const uint64_t* offs, const uint64_t* lens,
                    const int32_t* counts, int S, int T, int32_t* mode,
                    uint8_t* prevf, uint8_t* nextf, uint8_t* status,
                    int emit, void* residue, uint8_t* f_kind, int32_t* f1_ys,
                    uint8_t* f1_flags, float* f0_cosc, float* f0_amp, int rw,
                    int n_threads, uint64_t* busy_ns, uint64_t* wall_ns,
                    uint64_t* stage_ns) {
  const size_t C = st->channels, P = st->P, Om = st->Omax;
  const size_t n = C * (size_t)rw;
  if (emit != lt::LT_EMIT_F32 && emit != lt::LT_EMIT_I16 &&
      !(emit == lt::LT_EMIT_P12 && n % 8 == 0))
    return -1;
  for_streams(S, T, lens, counts, n_threads, busy_ns, wall_ns, stage_ns,
              [&](int s) {
    const size_t b = (size_t)s * T;
    auto run = [&](auto&& rows) {
      decode_stream(st, bufs[s], offs + b, lens + b, counts[s], mode + b,
                    prevf + b, nextf + b, status + b, rows, f_kind + b * C,
                    f1_ys + b * C * P, f1_flags + b * C * P,
                    f0_cosc + b * C * Om, f0_amp + b * C, rw);
    };
    if (emit == lt::LT_EMIT_F32)
      run(F32Rows{(float*)residue + b * n, n});
    else if (emit == lt::LT_EMIT_I16)
      run(I16Rows((int16_t*)residue + b * n, n));
    else
      run(P12Rows((uint32_t*)residue + b * 3 * (n / 8), n));
  });
  return S;
}

// The pool counters of this thread's last lt_decode_chunk call: the
// worker threads started for it (0 once the pool has grown to the call's
// workers) and its tail, ns from the first worker finding no stream left
// to claim to the last worker's end (0 for a call on the caller alone).
void lt_chunk_pool_stats(uint64_t* spawned, uint64_t* tail_ns) {
  *spawned = tl_pool_stats.spawned;
  *tail_ns = tl_pool_stats.tail_ns;
}

// 12-bit residue transport pack (parallel/pack12.py documents the
// layout): each row of n = 8K i16 values in [-2048, 2047] is viewed as 8
// blocked planes u_j[g] = row[j*K + g] and packed into three contiguous
// K-wide u32 planes. The numpy pack measures ~60 MB/s on this host —
// this loop runs at memory speed and keeps the host off the e2e
// critical path.
//
// Returns 0 on success, 1 if any value fell outside [-2048, 2047]: the
// 12-bit mask would otherwise corrupt residues SILENTLY if the static
// residue_i16_bound gate were ever wrong (ADVICE r4). The check is a
// branchless OR-accumulate of (v + 2048) — in-range values stay within
// 12 bits — verified once at the end, so the hot loop stays memory-speed.
int64_t lt_pack12(const int16_t* src, uint32_t* dst, int64_t rows,
                  int64_t n) {
  const int64_t K = n / 8;
  uint32_t range_acc = 0;
  for (int64_t r = 0; r < rows; ++r) {
    const int16_t* row = src + r * n;
    uint32_t* out = dst + r * 3 * K;
    for (int64_t g = 0; g < K; ++g) {
      for (int j = 0; j < 8; ++j)
        range_acc |= (uint32_t)(int32_t)row[j * K + g] + 2048u;
      uint32_t u0 = (uint32_t)row[0 * K + g] & 0xFFFu;
      uint32_t u1 = (uint32_t)row[1 * K + g] & 0xFFFu;
      uint32_t u2 = (uint32_t)row[2 * K + g] & 0xFFFu;
      uint32_t u3 = (uint32_t)row[3 * K + g] & 0xFFFu;
      uint32_t u4 = (uint32_t)row[4 * K + g] & 0xFFFu;
      uint32_t u5 = (uint32_t)row[5 * K + g] & 0xFFFu;
      uint32_t u6 = (uint32_t)row[6 * K + g] & 0xFFFu;
      uint32_t u7 = (uint32_t)row[7 * K + g] & 0xFFFu;
      out[0 * K + g] = u0 | (u1 << 12) | ((u2 & 0xFFu) << 24);
      out[1 * K + g] = (u2 >> 8) | (u3 << 4) | (u4 << 16) | ((u5 & 0xFu) << 28);
      out[2 * K + g] = (u5 >> 4) | (u6 << 8) | (u7 << 20);
    }
  }
  return (range_acc >> 12) ? 1 : 0;
}

}  // extern "C"
