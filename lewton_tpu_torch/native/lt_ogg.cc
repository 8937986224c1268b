// Ogg container demux (native host half).
//
// Pages -> packets with CRC verification, lacing reassembly across pages,
// multiplexed serials, BOS/EOS flags and granule bookkeeping. Semantics
// mirror lewton_tpu/ogg/demux.py (the executable specification); the
// reference delegates this to the external `ogg` crate (SURVEY.md L5).
//
// One pass over the bytes: each page's CRC is checked 16 bytes a step, and
// each packet's bytes are written once, from the page body into the
// reader's one blob, its length, serial, flags and granules into flat
// arrays. Only a packet that began on an earlier page is held, per serial,
// until the page that ends it.
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <new>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace lt {

namespace {

constexpr uint8_t CONTINUED = 0x01, BOS = 0x02, EOS = 0x04;
constexpr uint64_t NO_GRANULE = ~0ull;

// packet flags (lt_ogg_packet_meta)
constexpr uint8_t F_FIRST_IN_STREAM = 1, F_LAST_IN_STREAM = 2,
                  F_FIRST_IN_PAGE = 4, F_LAST_IN_PAGE = 8, F_HAS_ABSGP = 16,
                  F_HAS_PAGE_GRANULE = 32, F_SPANS_PAGES = 64;

// Ogg CRC32: poly 0x04c11db7 MSB-first, init 0, no final xor: the CRC of
// a message M is M(x) * x^32 mod P. t[0] is the byte table; t[k][b] is the
// CRC of byte b followed by k zero bytes, so one step folds 16 bytes
// through 16 independent lookups (slicing-by-16). k192 and k128 are x^192
// and x^128 mod P, the constants of the carry-less fold below.
struct CrcTable {
  uint32_t t[16][256];
  uint64_t k192, k128;
  bool clmul = false;  // the CPU multiplies carry-less (crc_fold)
  static uint64_t x_pow_mod(int n) {
    uint64_t r = 1;
    for (int i = 0; i < n; ++i) {
      r <<= 1;
      if (r >> 32) r ^= 0x104C11DB7ull;
    }
    return r;
  }
  CrcTable() : k192(x_pow_mod(192)), k128(x_pow_mod(128)) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i << 24;
      for (int j = 0; j < 8; ++j)
        r = (r & 0x80000000u) ? (r << 1) ^ 0x04C11DB7u : (r << 1);
      t[0][i] = r;
    }
    for (int k = 1; k < 16; ++k)
      for (uint32_t i = 0; i < 256; ++i)
        t[k][i] = (t[k - 1][i] << 8) ^ t[0][t[k - 1][i] >> 24];
#if defined(__x86_64__)
    // this runs in a static constructor, which may come before the
    // compiler runtime's own CPU probe
    __builtin_cpu_init();
    clmul = __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("ssse3");
#endif
  }
};
const CrcTable kCrc;

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

uint32_t crc_slice(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = kCrc.t;
  for (; n >= 16; p += 16, n -= 16) {
    uint32_t a = crc ^ be32(p), b = be32(p + 4), c = be32(p + 8),
             d = be32(p + 12);
    crc = t[15][a >> 24] ^ t[14][(a >> 16) & 0xff] ^ t[13][(a >> 8) & 0xff] ^
          t[12][a & 0xff] ^ t[11][b >> 24] ^ t[10][(b >> 16) & 0xff] ^
          t[9][(b >> 8) & 0xff] ^ t[8][b & 0xff] ^ t[7][c >> 24] ^
          t[6][(c >> 16) & 0xff] ^ t[5][(c >> 8) & 0xff] ^ t[4][c & 0xff] ^
          t[3][d >> 24] ^ t[2][(d >> 16) & 0xff] ^ t[1][(d >> 8) & 0xff] ^
          t[0][d & 0xff];
  }
  for (; n; ++p, --n) crc = (crc << 8) ^ t[0][(crc >> 24) ^ *p];
  return crc;
}

#if defined(__x86_64__)
// The same CRC 16 bytes a step by carry-less multiplication (folding, as in
// Intel's "Fast CRC Computation for Generic Polynomials Using PCLMULQDQ"),
// n >= 16. X holds 128 bits of message, byte-reversed so that bit i is the
// coefficient of x^i, the incoming CRC added to its top 32 bits. Folding X
// over the next block B keeps X * x^128 + B mod P in 128 bits:
// X_hi * (x^192 mod P) ^ X_lo * (x^128 mod P) ^ B. At the end X's CRC,
// X * x^32 mod P, is a slicing step over X's 16 bytes from 0.
__attribute__((target("pclmul,ssse3"))) uint32_t crc_fold(uint32_t crc,
                                                          const uint8_t* p,
                                                          size_t n) {
  const __m128i rev =
      _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  const __m128i k = _mm_set_epi64x((long long)kCrc.k192, (long long)kCrc.k128);
  __m128i x = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)p), rev);
  x = _mm_xor_si128(x, _mm_set_epi32((int)crc, 0, 0, 0));
  for (p += 16, n -= 16; n >= 16; p += 16, n -= 16) {
    __m128i b = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)p), rev);
    x = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x11),
                                    _mm_clmulepi64_si128(x, k, 0x00)),
                      b);
  }
  uint8_t be[16];
  _mm_storeu_si128((__m128i*)be, _mm_shuffle_epi8(x, rev));
  return crc_slice(crc_slice(0, be, 16), p, n);
}
#endif

// Short runs (a page's header, its zeroed CRC field, a short page) take the
// tables; a page's lacing and body the carry-less fold where the CPU has it.
uint32_t crc_update(uint32_t crc, const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  if (n >= 64 && kCrc.clmul) return crc_fold(crc, p, n);
#endif
  return crc_slice(crc, p, n);
}

uint64_t le64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}
uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

}  // namespace

// The packets of a demux: their bytes back to back in one blob, the rest in
// flat arrays. The blob is the caller's buffer (lt_ogg_new_into: the whole
// input's length, which a demux's packets never exceed, since accepted
// pages do not overlap) or one the reader owns and grows.
struct Packets {
  uint8_t* blob = nullptr;
  size_t bytes = 0, cap = 0;
  std::unique_ptr<uint8_t[]> own;
  bool external = false;
  std::vector<uint64_t> lens, absgp, page_granule;
  std::vector<uint32_t> serials;
  std::vector<uint8_t> flags;

  size_t count() const { return lens.size(); }
  void clear() {
    bytes = 0;
    lens.clear();
    absgp.clear();
    page_granule.clear();
    serials.clear();
    flags.clear();
  }
  // room for n more bytes at blob + bytes
  uint8_t* room(size_t n) {
    if (bytes + n > cap) {
      if (external) throw std::bad_alloc();  // cannot happen (see above)
      size_t c = cap * 2 > bytes + n ? cap * 2 : bytes + n;
      std::unique_ptr<uint8_t[]> b(new uint8_t[c]);
      if (bytes) memcpy(b.get(), blob, bytes);
      own = std::move(b);
      blob = own.get();
      cap = c;
    }
    return blob + bytes;
  }
  // a packet's bytes: a held head (or none), then its last piece
  void append(const uint8_t* head, size_t head_len, const uint8_t* tail,
              size_t tail_len) {
    uint8_t* w = room(head_len + tail_len);
    if (head_len) memcpy(w, head, head_len);
    if (tail_len) memcpy(w + head_len, tail, tail_len);
    bytes += head_len + tail_len;
  }
  // the rest of the packet just appended (absgp is set on a page's last)
  void add(uint64_t len, uint32_t serial, uint8_t f, uint64_t granule) {
    lens.push_back(len);
    serials.push_back(serial);
    flags.push_back(f);
    absgp.push_back(0);
    page_granule.push_back(granule);
  }
};

// Per-serial state of the page loop, kept across calls while a stream's
// bytes arrive in pieces.
struct SerialState {
  // the last page sequence number: a gap (lost/corrupt page skipped by CRC
  // resync) means any pending continued data lost its tail and must be
  // dropped, never spliced onto the next page's data
  uint32_t last_seq = 0;
  bool seen = false;
  // the head of a packet that continues on a later page, and whether its
  // first bytes came on a BOS page
  bool has_partial = false, started_on_bos = false;
  std::vector<uint8_t> partial;
};

struct PageState {
  std::map<uint32_t, SerialState> serials;
  // the entry of the last page's serial (map nodes do not move): a
  // stream's pages almost always share one
  SerialState* last = nullptr;
  uint32_t last_serial = 0;
  int64_t pages = 0;  // CRC-checked pages delivered

  SerialState& of(uint32_t serial) {
    if (!last || serial != last_serial) {
      last = &serials[serial];
      last_serial = serial;
    }
    return *last;
  }
};

// The page loop: appends the packets of every complete page of
// data[0, len) to `out` and returns the bytes it consumed. It stops where
// no capture pattern is left (the last 3 bytes kept: a capture may
// straddle the end) or at a found page that is still incomplete (kept from
// its capture): where the Python reader returns None and leaves the tail
// buffered for a later feed.
size_t demux_pages(const uint8_t* data, size_t len, PageState& st,
                   Packets& out) {
  size_t off = 0;
  while (off + 27 <= len) {
    // resync: scan for capture pattern
    const uint8_t* found =
        (const uint8_t*)memmem(data + off, len - off, "OggS", 4);
    if (!found) return len - 3;
    size_t start = (size_t)(found - data);
    if (start + 27 > len) return start;
    const uint8_t* h = data + start;
    if (h[4] != 0) {  // unsupported version: skip this capture
      off = start + 4;
      continue;
    }
    uint8_t header_type = h[5];
    uint64_t granule = le64(h + 6);
    uint32_t serial = le32(h + 14);
    uint32_t seq = le32(h + 18);
    uint32_t crc = le32(h + 22);
    uint8_t nsegs = h[26];
    if (start + 27 + nsegs > len) return start;
    const uint8_t* lacing = h + 27;
    size_t body_len = 0;
    for (uint8_t i = 0; i < nsegs; ++i) body_len += lacing[i];
    if (start + 27 + nsegs + body_len > len) return start;
    const uint8_t* body = lacing + nsegs;
    // CRC with the CRC field zeroed
    static const uint8_t zeros[4] = {0, 0, 0, 0};
    uint32_t c = crc_update(0, h, 22);
    c = crc_update(c, zeros, 4);
    c = crc_update(c, h + 26, 1 + nsegs + body_len);
    if (c != crc) {  // corrupt page: skip capture, rescan
      off = start + 4;
      continue;
    }
    ++st.pages;

    bool is_bos = header_type & BOS, is_eos = header_type & EOS;
    bool continued = header_type & CONTINUED;
    bool unterminated = nsegs > 0 && lacing[nsegs - 1] == 255;
    SerialState& ss = st.of(serial);
    if (ss.seen && seq != ss.last_seq + 1) {
      ss.has_partial = false;  // sequence hole: head lost its tail
      ss.started_on_bos = false;
    }
    ss.seen = true;
    ss.last_seq = seq;
    bool has_granule = granule != NO_GRANULE;
    uint8_t pg = has_granule ? F_HAS_PAGE_GRANULE : 0;
    uint64_t pgv = has_granule ? granule : 0;

    // walk the lacing in place: a value under 255 ends a packet; the
    // page's first piece continues the serial's held head on a continued
    // page; an unterminated last piece is held for a later page
    size_t first = out.count();
    size_t pos = 0, seg_start = 0;
    bool first_piece = true;
    for (unsigned i = 0; i < nsegs; ++i) {
      pos += lacing[i];
      bool ends = lacing[i] < 255;
      if (!ends && i + 1 < nsegs) continue;
      const uint8_t* seg = body + seg_start;
      size_t seg_len = pos - seg_start;
      seg_start = pos;
      bool spans = false, from_bos = is_bos;
      size_t pkt_len = seg_len;
      if (first_piece && continued) {
        first_piece = false;
        if (!ss.has_partial) {
          // continuation of a packet whose head was never seen (sequence
          // hole): drop the tail -- never seed it as a packet head (a
          // later page would splice onto it and deliver a garbage packet)
          continue;
        }
        from_bos = ss.started_on_bos;
        if (!ends) {  // the head grows and stays held
          ss.partial.insert(ss.partial.end(), seg, seg + seg_len);
          continue;
        }
        out.append(ss.partial.data(), ss.partial.size(), seg, seg_len);
        pkt_len += ss.partial.size();
        ss.has_partial = false;
        ss.started_on_bos = false;
        spans = true;
      } else {
        first_piece = false;
        if (!ends) {
          ss.partial.assign(seg, seg + seg_len);
          ss.has_partial = true;
          ss.started_on_bos = from_bos;
          continue;
        }
        out.append(nullptr, 0, seg, seg_len);
      }
      uint8_t f = pg | (spans ? F_SPANS_PAGES : 0);
      if (out.count() == first)
        f |= F_FIRST_IN_PAGE | (from_bos ? F_FIRST_IN_STREAM : 0);
      out.add(pkt_len, serial, f, pgv);
    }
    if (out.count() > first) {  // the page's last completed packet
      size_t k = out.count() - 1;
      out.flags[k] |= F_LAST_IN_PAGE;
      if (is_eos && !unterminated) out.flags[k] |= F_LAST_IN_STREAM;
      if (has_granule) {
        out.flags[k] |= F_HAS_ABSGP;
        out.absgp[k] = granule;
      }
    }
    off = start + 27 + nsegs + body_len;
  }
  return off;
}

// A demuxed byte stream. lt_ogg_new runs the page loop once on a whole
// buffer it borrows; a fed stream (lt_ogg_stream_new) runs it on each feed
// and holds only the bytes it did not consume: at most one partial page
// and a few bytes. `packets` are the whole buffer's, or those a fed
// stream's last feed completed.
struct OggReader {
  Packets packets;
  PageState state;
  std::vector<uint8_t> held;
};

}  // namespace lt

extern "C" {

lt::OggReader* lt_ogg_new(const uint8_t* data, size_t len) try {
  auto r = std::make_unique<lt::OggReader>();
  r->packets.room(len);  // a whole buffer's packets fit in its length
  lt::demux_pages(data, len, r->state, r->packets);
  return r.release();
} catch (const std::exception&) {
  return nullptr;  // never let C++ exceptions cross the C ABI into ctypes
}

// lt_ogg_new writing the packets' bytes straight into `out`, which holds
// `len` bytes: they lie there back to back (lt_ogg_packet_meta gives their
// lengths), and lt_ogg_packet_data need not be called.
lt::OggReader* lt_ogg_new_into(const uint8_t* data, size_t len,
                               uint8_t* out) try {
  auto r = std::make_unique<lt::OggReader>();
  r->packets.blob = out;
  r->packets.cap = len;
  r->packets.external = true;
  lt::demux_pages(data, len, r->state, r->packets);
  return r.release();
} catch (const std::exception&) {
  return nullptr;
}

lt::OggReader* lt_ogg_stream_new() try {
  return new lt::OggReader();
} catch (const std::exception&) {
  return nullptr;
}

// Append `len` bytes to a fed stream and parse every page they complete.
// Returns the packets completed (lt_ogg_packet_* read them until the next
// feed), or -1 when memory ran out (the stream is then unusable).
int64_t lt_ogg_stream_feed(lt::OggReader* r, const uint8_t* data,
                           size_t len) try {
  r->packets.clear();
  r->held.insert(r->held.end(), data, data + len);
  size_t used = lt::demux_pages(r->held.data(), r->held.size(), r->state,
                                r->packets);
  r->held.erase(r->held.begin(), r->held.begin() + used);
  return (int64_t)r->packets.count();
} catch (const std::exception&) {
  return -1;
}

// CRC-checked pages parsed so far
int64_t lt_ogg_pages(const lt::OggReader* r) { return r->state.pages; }

// bytes a fed stream holds for a later feed
int64_t lt_ogg_held_bytes(const lt::OggReader* r) {
  return (int64_t)r->held.size();
}

void lt_ogg_free(lt::OggReader* r) { delete r; }

int64_t lt_ogg_packet_count(const lt::OggReader* r) {
  return (int64_t)r->packets.count();
}

// flags: bit0 first_in_stream, 1 last_in_stream, 2 first_in_page,
// 3 last_in_page, 4 has_absgp, 5 has_page_granule, 6 spans_pages
void lt_ogg_packet_meta(const lt::OggReader* r, uint64_t* lens,
                        uint32_t* serials, uint8_t* flags, uint64_t* absgp,
                        uint64_t* page_granule) {
  const lt::Packets& p = r->packets;
  size_t n = p.count();
  if (!n) return;
  memcpy(lens, p.lens.data(), n * sizeof(uint64_t));
  memcpy(serials, p.serials.data(), n * sizeof(uint32_t));
  memcpy(flags, p.flags.data(), n);
  memcpy(absgp, p.absgp.data(), n * sizeof(uint64_t));
  memcpy(page_granule, p.page_granule.data(), n * sizeof(uint64_t));
}

void lt_ogg_packet_data(const lt::OggReader* r, uint8_t* out) {
  const lt::Packets& p = r->packets;
  if (p.bytes && out != p.blob) memcpy(out, p.blob, p.bytes);
}

}  // extern "C"
