// Canonical Huffman build + slow decode path (see lt_bits.h).
#include "lt_bits.h"

#include <algorithm>

namespace lt {

bool Huffman::build(const std::vector<uint8_t>& lengths, std::string* err) {
  // safe defaults: empty/single-entry books keep a 1-entry miss LUT so
  // decode() can index it unconditionally
  lut_bits_ = 0;
  lut_.assign(1, -1);
  codes_.clear();
  n_codes_ = 0;
  single_entry_ = false;

  std::vector<uint32_t> used;
  for (uint32_t i = 0; i < lengths.size(); ++i) {
    if (lengths[i] > 0) {
      if (lengths[i] > 32) {
        *err = "codeword length out of range";
        return false;
      }
      used.push_back(i);
    }
  }
  if (used.empty()) return true;  // empty codebook: decode() always fails
  if (used.size() == 1) {
    // Single-entry codebook (spec errata): one dummy bit, any value.
    if (lengths[used[0]] != 1) {
      *err = "single-entry codebook with length != 1";
      return false;
    }
    single_entry_ = true;
    single_value_ = used[0];
    n_codes_ = 1;
    return true;
  }

  // Left-aligned available-prefix assignment (spec 3.2.1 order). avail[d]
  // holds the left-aligned unused prefix of depth d in a 64-bit domain
  // (top bit margin avoids 32-bit overflow at depth 32), or 0.
  constexpr int TOP = 64;
  uint64_t avail[33] = {0};
  uint32_t first = used[0];
  uint32_t l0 = lengths[first];
  codes_.push_back({0u, (uint8_t)l0, first});
  for (uint32_t d = 1; d <= l0; ++d) avail[d] = 1ull << (TOP - 1 - d);

  for (size_t u = 1; u < used.size(); ++u) {
    uint32_t i = used[u];
    uint32_t l = lengths[i];
    uint32_t z = l;
    while (z > 0 && avail[z] == 0) --z;
    if (z == 0) {
      *err = "over-specified codebook";
      return false;
    }
    uint64_t prefix = avail[z];
    avail[z] = 0;
    // prefix occupies bits [TOP-1-l, TOP-1); MSB-align its top l bits into
    // 32: shift right by (TOP-1-l) - (32-l) = TOP-33 = 31.
    codes_.push_back({(uint32_t)(prefix >> 31), (uint8_t)l, i});
    for (uint32_t d = z + 1; d <= l; ++d)
      avail[d] = prefix | (1ull << (TOP - 1 - d));
  }
  for (int d = 1; d <= 32; ++d) {
    if (avail[d]) {
      *err = "under-populated codebook";
      return false;
    }
  }
  n_codes_ = (uint32_t)codes_.size();

  // Primary LUT over the next lut_bits_ stream bits (first-read bit in
  // the index LSB; codeword bits are read MSB-first), right-sized to the
  // book's longest codeword (L1 footprint: see class comment).
  uint32_t maxlen = 0;
  for (const Code& c : codes_) maxlen = c.len > maxlen ? c.len : maxlen;
  lut_bits_ = maxlen < LUT_MAX ? maxlen : LUT_MAX;
  lut_.assign(1u << lut_bits_, -1);
  for (const Code& c : codes_) {
    if (c.len > lut_bits_) continue;
    uint32_t pat = 0;
    for (uint32_t i = 0; i < c.len; ++i) {
      uint32_t bit = (c.word >> (31 - i)) & 1u;  // i-th read bit
      pat |= bit << i;
    }
    int32_t entry = (int32_t)((c.value << 5) | c.len);
    for (uint32_t t = pat; t < lut_.size(); t += (1u << c.len)) lut_[t] = entry;
  }
  std::sort(codes_.begin(), codes_.end(),
            [](const Code& a, const Code& b) { return a.word < b.word; });
  return true;
}

bool Huffman::decode_slow(BitCursor* cur, uint32_t* out) const {
  uint32_t word = 0;
  for (uint32_t depth = 1; depth <= 32; ++depth) {
    uint32_t b;
    if (!cur->read(1, &b)) return false;  // EOP mid-codeword
    word |= b << (32 - depth);
    // binary search for an exact (word, depth) code
    auto it = std::lower_bound(
        codes_.begin(), codes_.end(), word,
        [](const Code& c, uint32_t w) { return c.word < w; });
    if (it != codes_.end() && it->word == word && it->len == depth) {
      *out = it->value;
      return true;
    }
  }
  return false;  // corrupt tree (unreachable for validated codebooks)
}

}  // namespace lt
