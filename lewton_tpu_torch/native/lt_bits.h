// Bit-level primitives: LSb-first bit cursor + canonical Huffman decode.
//
// Host half of the TPU framework (SURVEY.md §7): entropy decode is
// inherently bit-serial, so it runs native and emits dense tensors.
// Independent implementation from the Vorbis I spec §2 (bit packing) and
// §3.2.1 (codebook codeword assignment); behavioral parity with the
// reference reader (lewton src/bitpacking.rs, src/huffman_tree.rs).
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace lt {

// End-of-packet is *data* in Vorbis (floors/residues stop cleanly), so the
// cursor reports EOP via return codes, never exceptions.
//
// Implementation: 64-bit accumulator holding the next <=64 unread bits
// LSb-first; reads/peeks/advances are O(1) shift+mask (no per-byte loop —
// this cursor sits under every Huffman codeword of the entropy front-end).
class BitCursor {
 public:
  BitCursor(const uint8_t* data, size_t len) : data_(data), len_(len) {
    refill();
  }

  // Read n<=32 bits LSb-first. Returns false on end-of-packet (cursor
  // position then undefined for further reads, matching the reference's
  // "EOP is terminal" use).
  inline bool read(uint32_t n, uint32_t* out) {
    if (n > nbits_) {
      refill();
      if (n > nbits_) return false;
    }
    *out = (uint32_t)(acc_ & mask64(n));
    acc_ >>= n;
    nbits_ -= n;
    return true;
  }

  bool read_flag(bool* out) {
    uint32_t v;
    if (!read(1, &v)) return false;
    *out = v != 0;
    return true;
  }

  bool read_i32(uint32_t n, int32_t* out) {  // sign-extend an n-bit field
    uint32_t v;
    if (!read(n, &v)) return false;
    if (n < 32 && (v & (1u << (n - 1)))) v |= ~((1u << n) - 1u);
    *out = (int32_t)v;
    return true;
  }

  // Vorbis float32 unpack (spec §2.1.9): 1 sign, 10-bit exponent biased
  // 788, 21-bit mantissa.
  bool read_vorbis_float(float* out) {
    uint32_t x;
    if (!read(32, &x)) return false;
    double mant = (double)(x & 0x1fffff);
    if (x & 0x80000000u) mant = -mant;
    int32_t exp = (int32_t)((x >> 21) & 0x3ff) - 788;
    *out = (float)ldexp(mant, exp);
    return true;
  }

  // Peek up to n<=32 bits without consuming (zero-padded past EOP: the
  // accumulator holds zeros above nbits_).
  inline uint32_t peek(uint32_t n) {
    if (n > nbits_) refill();
    return (uint32_t)(acc_ & mask64(n));
  }

  // Caller guarantees n <= bits_remaining() (decode() checks).
  inline void advance(uint32_t n) {
    if (n <= nbits_) {
      acc_ >>= n;
      nbits_ -= n;
    } else {  // only reachable right at EOP with a short accumulator
      uint32_t extra = n - nbits_;
      acc_ = 0;
      nbits_ = 0;
      pos_ += extra >> 3;
      refill();
      acc_ >>= (extra & 7);
      nbits_ -= (extra & 7);
    }
  }

  inline uint64_t bits_remaining() const {
    return (uint64_t)(len_ - pos_) * 8 + nbits_;
  }

  // bits currently in the accumulator (lower bound on bits_remaining)
  inline uint32_t navail() const { return nbits_; }

  // State sync for register-resident hot loops (lt_entropy.cc vq_run):
  // the compiler cannot keep these fields in registers across decode_slow
  // calls (the cursor's address escapes), so partition loops copy them
  // out, run on locals, and copy back.
  inline void sync_out(uint64_t* acc, uint32_t* nbits, size_t* pos) const {
    *acc = acc_;
    *nbits = nbits_;
    *pos = pos_;
  }
  inline void sync_in(uint64_t acc, uint32_t nbits, size_t pos) {
    acc_ = acc;
    nbits_ = nbits;
    pos_ = pos;
  }
  inline const uint8_t* data() const { return data_; }
  inline size_t size() const { return len_; }

  // advance n <= navail() bits
  inline void advance_fast(uint32_t n) {
    acc_ >>= n;
    nbits_ -= n;
  }

 private:
  static inline uint64_t mask64(uint32_t n) {
    return n >= 64 ? ~0ull : ((1ull << n) - 1);
  }

  inline void refill() {
    // bulk path: load 8 bytes at once when they fit
    if (nbits_ == 0 && len_ - pos_ >= 8) {
      uint64_t w;
      memcpy(&w, data_ + pos_, 8);  // x86/TPU hosts are little-endian
      acc_ = w;
      nbits_ = 64;
      pos_ += 8;
      return;
    }
    while (nbits_ <= 56 && pos_ < len_) {
      acc_ |= (uint64_t)data_[pos_++] << nbits_;
      nbits_ += 8;
    }
  }

  const uint8_t* data_;
  size_t len_;
  size_t pos_ = 0;     // next unread byte
  uint64_t acc_ = 0;   // next nbits_ unread bits, LSb-first
  uint32_t nbits_ = 0;
};

// Canonical Huffman decoder. Codewords are assigned in spec §3.2.1 order
// (first-fit left-aligned); decode uses a primary lookup table over the
// next lut_bits() bits (in read order, i.e. reversed codeword bits) with a
// bit-by-bit fallback for longer codes. The LUT is sized per book:
// min(LUT_MAX, longest codeword) — residue decode rotates several books
// through L1, and right-sizing the tables measured +9% front-end
// throughput vs a fixed 12-bit LUT (fixed 8 bits lost 27% to the slow
// path; adaptive keeps full coverage for short books).
class Huffman {
 public:
  static constexpr uint32_t LUT_MAX = 12;

  // lengths[i] == 0 means entry i is unused. Returns false (and sets *err)
  // on over/under-specified trees. Single-entry codebooks follow the
  // reference quirk: one 1-bit codeword, any bit decodes to that entry.
  bool build(const std::vector<uint8_t>& lengths, std::string* err);

  bool empty() const { return n_codes_ == 0; }

  // Decode one scalar; false on EOP or (impossible for valid trees)
  // unmatched prefix.
  inline bool decode(BitCursor* cur, uint32_t* out) const {
    if (single_entry_) {  // any 1-bit input decodes to the entry (ref quirk)
      uint32_t b;
      if (!cur->read(1, &b)) return false;
      *out = single_value_;
      return true;
    }
    uint32_t p = cur->peek(lut_bits_);
    int32_t e = lut_[p];
    if (e >= 0) {
      uint32_t len = (uint32_t)(e & 31);
      // common case: the accumulator holds the whole codeword (peek just
      // refilled), so the EOP check is one register compare
      if (len <= cur->navail()) {
        cur->advance_fast(len);
        *out = (uint32_t)(e >> 5);
        return true;
      }
      if (cur->bits_remaining() < len) return false;  // EOP mid-codeword
      cur->advance(len);
      *out = (uint32_t)(e >> 5);
      return true;
    }
    // overflow path: codes longer than LUT_BITS, walk from scratch
    return decode_slow(cur, out);
  }

  // hot-loop accessors (lt_entropy.cc vq_run keeps the cursor state in
  // registers and indexes the LUT directly; decode_slow's address-escape
  // otherwise pins the cursor fields to stack memory for the whole packet)
  inline const int32_t* lut_data() const { return lut_.data(); }
  inline uint32_t lut_bits() const { return lut_bits_; }
  inline bool single() const { return single_entry_; }

  bool decode_slow(BitCursor* cur, uint32_t* out) const;

 private:
  // primary table: >=0 -> (value << 5) | length; -1 -> long-code fallback
  std::vector<int32_t> lut_;
  uint32_t lut_bits_ = LUT_MAX;
  // sorted (codeword aligned to 32 bits, length, value) for the slow path
  struct Code {
    uint32_t word;  // MSB-aligned codeword
    uint8_t len;
    uint32_t value;
  };
  std::vector<Code> codes_;  // sorted by word
  uint32_t n_codes_ = 0;
  bool single_entry_ = false;
  uint32_t single_value_ = 0;
};

}  // namespace lt
