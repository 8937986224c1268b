// Ogg container demux (native host half).
//
// Pages -> packets with CRC verification, lacing reassembly across pages,
// multiplexed serials, BOS/EOS flags and granule bookkeeping. Semantics
// mirror lewton_tpu/ogg/demux.py (the executable specification); the
// reference delegates this to the external `ogg` crate (SURVEY.md L5).
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <vector>

namespace lt {

namespace {

constexpr uint8_t CONTINUED = 0x01, BOS = 0x02, EOS = 0x04;
constexpr uint64_t NO_GRANULE = ~0ull;

// Ogg CRC32: poly 0x04c11db7 MSB-first, init 0, no final xor.
struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t r = i << 24;
      for (int j = 0; j < 8; ++j)
        r = (r & 0x80000000u) ? (r << 1) ^ 0x04C11DB7u : (r << 1);
      t[i] = r;
    }
  }
};
const CrcTable kCrc;

uint32_t crc_update(uint32_t crc, const uint8_t* p, size_t n) {
  for (size_t i = 0; i < n; ++i)
    crc = (crc << 8) ^ kCrc.t[((crc >> 24) & 0xff) ^ p[i]];
  return crc;
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

struct OggPacket {
  std::vector<uint8_t> data;
  uint32_t serial;
  bool first_in_stream, last_in_stream, first_in_page, last_in_page;
  bool has_absgp, has_page_granule;
  //: the packet's data BEGAN on an earlier page than where it completed
  //: (page-granular seek must not deliver it: a streaming reader
  //: positioned at the completion page cannot reassemble it)
  bool spans_pages = false;
  uint64_t absgp, page_granule;
};

// Per-serial reassembly state of the page loop, kept across calls while a
// stream's bytes arrive in pieces.
struct PageState {
  std::map<uint32_t, std::vector<uint8_t>> partial;
  std::map<uint32_t, bool> started_on_bos;
  // per-serial last page sequence number: a gap (lost/corrupt page
  // skipped by CRC resync) means any pending continued data lost its
  // tail and must be dropped, never spliced onto the next page's data
  std::map<uint32_t, uint32_t> last_seq;
  int64_t pages = 0;  // CRC-checked pages delivered
};

// The page loop: appends the packets of every complete page of
// data[0, len) to `out` and returns the bytes it consumed. It stops where
// no capture pattern is left (the last 3 bytes kept: a capture may
// straddle the end) or at a found page that is still incomplete (kept from
// its capture): where the Python reader returns None and leaves the tail
// buffered for a later feed.
size_t demux_pages(const uint8_t* data, size_t len, PageState& st,
                   std::vector<OggPacket>& out) {
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
    uint32_t c = crc_update(0, h, 22);
    uint8_t zeros[4] = {0, 0, 0, 0};
    c = crc_update(c, zeros, 4);
    c = crc_update(c, h + 26, 1 + nsegs);
    c = crc_update(c, body, body_len);
    if (c != crc) {  // corrupt page: skip capture, rescan
      off = start + 4;
      continue;
    }
    size_t page_end = start + 27 + nsegs + body_len;
    ++st.pages;

    // lacing -> segments
    std::vector<std::pair<const uint8_t*, size_t>> segs;  // (ptr, len)
    size_t pos = 0, seg_start = 0;
    for (uint8_t i = 0; i < nsegs; ++i) {
      pos += lacing[i];
      if (lacing[i] < 255) {
        segs.emplace_back(body + seg_start, pos - seg_start);
        seg_start = pos;
      }
    }
    bool unterminated = nsegs > 0 && lacing[nsegs - 1] == 255;
    if (unterminated) segs.emplace_back(body + seg_start, pos - seg_start);

    bool is_bos = header_type & BOS, is_eos = header_type & EOS;
    bool continued = header_type & CONTINUED;
    auto lsq = st.last_seq.find(serial);
    if (lsq != st.last_seq.end() && seq != lsq->second + 1) {
      st.partial.erase(serial);  // sequence hole: head lost its tail
      st.started_on_bos.erase(serial);
    }
    st.last_seq[serial] = seq;
    struct Pending {
      std::vector<uint8_t> data;
      bool first;
      bool spans = false;
    };
    std::vector<Pending> here;
    size_t nseg_pkts = segs.size();
    for (size_t i = 0; i < nseg_pkts; ++i) {
      bool last_unterminated = unterminated && i == nseg_pkts - 1;
      std::vector<uint8_t> pkt;
      bool first;
      bool spans = false;
      if (i == 0 && continued) {
        auto it = st.partial.find(serial);
        if (it == st.partial.end()) {
          // continuation of a packet whose head was never seen
          // (sequence hole): drop the tail — never seed it as a packet
          // head (a later page would splice onto it and deliver a
          // garbage packet)
          continue;
        }
        pkt = std::move(it->second);
        st.partial.erase(it);
        spans = true;
        pkt.insert(pkt.end(), segs[i].first, segs[i].first + segs[i].second);
        auto sb = st.started_on_bos.find(serial);
        first = sb != st.started_on_bos.end() && sb->second;
        st.started_on_bos.erase(serial);
      } else {
        pkt.assign(segs[i].first, segs[i].first + segs[i].second);
        first = is_bos;
      }
      if (last_unterminated) {
        st.partial[serial] = std::move(pkt);
        st.started_on_bos[serial] = first;
      } else {
        here.push_back({std::move(pkt), first, spans});
      }
    }
    size_t m = here.size();
    for (size_t i = 0; i < m; ++i) {
      bool ends_page = i == m - 1;
      OggPacket p;
      p.data = std::move(here[i].data);
      p.serial = serial;
      p.first_in_stream = here[i].first && i == 0;
      p.last_in_stream = is_eos && ends_page && !unterminated;
      p.has_absgp = ends_page && granule != NO_GRANULE;
      p.absgp = p.has_absgp ? granule : 0;
      p.first_in_page = i == 0;
      p.last_in_page = ends_page;
      p.spans_pages = here[i].spans;
      p.has_page_granule = granule != NO_GRANULE;
      p.page_granule = p.has_page_granule ? granule : 0;
      out.push_back(std::move(p));
    }
    off = page_end;
  }
  return off;
}

// A demuxed byte stream. lt_ogg_new runs the page loop once on a whole
// buffer it borrows; a fed stream (lt_ogg_stream_new) runs it on each feed
// and holds only the bytes it did not consume: at most one partial page
// and a few bytes. `packets` are the whole buffer's, or those a fed
// stream's last feed completed.
struct OggReader {
  std::vector<OggPacket> packets;
  PageState state;
  std::vector<uint8_t> held;
};

}  // namespace lt

extern "C" {

lt::OggReader* lt_ogg_new(const uint8_t* data, size_t len) try {
  auto r = std::make_unique<lt::OggReader>();
  lt::demux_pages(data, len, r->state, r->packets);
  return r.release();
} catch (const std::exception&) {
  return nullptr;  // never let C++ exceptions cross the C ABI into ctypes
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
  return (int64_t)r->packets.size();
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
  return (int64_t)r->packets.size();
}

// flags: bit0 first_in_stream, 1 last_in_stream, 2 first_in_page,
// 3 last_in_page, 4 has_absgp, 5 has_page_granule, 6 spans_pages
void lt_ogg_packet_meta(const lt::OggReader* r, uint64_t* lens,
                        uint32_t* serials, uint8_t* flags, uint64_t* absgp,
                        uint64_t* page_granule) {
  for (size_t i = 0; i < r->packets.size(); ++i) {
    const lt::OggPacket& p = r->packets[i];
    lens[i] = p.data.size();
    serials[i] = p.serial;
    flags[i] = (uint8_t)(p.first_in_stream | (p.last_in_stream << 1) |
                         (p.first_in_page << 2) | (p.last_in_page << 3) |
                         (p.has_absgp << 4) | (p.has_page_granule << 5) |
                         (p.spans_pages << 6));
    absgp[i] = p.absgp;
    page_granule[i] = p.page_granule;
  }
}

void lt_ogg_packet_data(const lt::OggReader* r, uint8_t* out) {
  for (const lt::OggPacket& p : r->packets) {
    memcpy(out, p.data.data(), p.data.size());
    out += p.data.size();
  }
}

}  // extern "C"
