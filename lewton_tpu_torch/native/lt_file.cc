// Whole-file decode: Ogg bytes -> planar i16 PCM in ONE C call (the
// libvorbisfile-shaped entry point).
//
// Rationale: the per-packet Python loop around lt_decoder_decode spends
// more wall time in the interpreter (Packet objects, absgp bookkeeping,
// numpy slicing, list appends — ~40us/packet) than the C++ decode itself
// spends on the packet, which is exactly the overhead libvorbisfile's C
// read loop does not pay in the `tools/cmp.py bench` comparison. This
// entry walks the native demuxer's packet list directly and mirrors the
// Python/reference semantics:
//   - the stream is the serial of the first packet (an ident header —
//     the caller has already validated the headers); packets of other
//     serials are skipped (multiplexed streams) unless they open a NEW
//     logical stream (BOS), which triggers chained re-init (ref: lewton
//     src/inside_ogg.rs:114-158): 3 headers re-read, decode state reset,
//     granule tracking restarted at 0
//   - end-of-stream truncation to the page absgp, with granule tracking
//     from 0 (see inside_ogg.py `cur_absgp` note: matches libvorbis on
//     single-page streams where the reference would emit padding)
//   - i16 conversion = x*32768, clamp [-32768, 32767], truncate toward
//     zero (ref src/samples.rs:91-103; samples.py to_i16)
//
// Returns total samples per channel (PCM is planar: channel c at
// pcm[c*cap .. c*cap+total)), or:
//   -1  undecodable audio packet        (caller raises AudioBadFormat)
//   -2  chained-link header parse error (caller falls back to its loop)
//   -3  cap too small                   (caller falls back)
//   -4  channel count changed across chain links (caller falls back —
//       the reader's loop pads to the widest channel count)
#include <cmath>
#include <cstring>
#include <memory>
#include <vector>

#include "lt_decode.h"
#include "lt_header.h"

namespace lt {
struct OggReader;
struct Decoder;
}  // namespace lt

extern "C" {
// from lt_ogg.cc
int64_t lt_ogg_packet_count(const lt::OggReader*);
void lt_ogg_packet_meta(const lt::OggReader*, uint64_t*, uint32_t*, uint8_t*,
                        uint64_t*, uint64_t*);
void lt_ogg_packet_data(const lt::OggReader*, uint8_t*);
// from lt_synth.cc
lt::Decoder* lt_decoder_new(const uint8_t*, size_t, const uint8_t*, size_t,
                            char*, size_t);
void lt_decoder_free(lt::Decoder*);
int lt_decoder_channels(const lt::Decoder*);
int lt_decoder_n1(const lt::Decoder*);
int lt_decoder_decode(lt::Decoder*, const uint8_t*, size_t, float*);

int64_t lt_decode_ogg_i16(const lt::OggReader* ogg, int16_t* pcm,
                          int64_t cap, int64_t* absgp_out) try {
  const int64_t np = lt_ogg_packet_count(ogg);
  if (np < 3) return 0;
  std::vector<uint64_t> lens(np), absgp(np), pgran(np);
  std::vector<uint32_t> serials(np);
  std::vector<uint8_t> flags(np);
  lt_ogg_packet_meta(ogg, lens.data(), serials.data(), flags.data(),
                     absgp.data(), pgran.data());
  uint64_t total_bytes = 0;
  for (int64_t i = 0; i < np; ++i) total_bytes += lens[i];
  std::vector<uint8_t> blob(total_bytes ? total_bytes : 1);
  lt_ogg_packet_data(ogg, blob.data());
  std::vector<uint64_t> offs(np, 0);
  for (int64_t i = 1; i < np; ++i) offs[i] = offs[i - 1] + lens[i - 1];

  struct DecDel {
    void operator()(lt::Decoder* d) const { lt_decoder_free(d); }
  };
  std::unique_ptr<lt::Decoder, DecDel> dec;
  uint32_t serial = serials[0];
  int channels = 0;
  std::vector<float> fbuf;  // per-packet planar f32 [C, 3*n1/4]
  int64_t pos = 0;          // samples written per channel
  int64_t cur_absgp = 0;    // granule tracking (restarts per chain link)
  char err[256];

  // headers of the first link (already validated by the caller)
  int64_t i = 0;
  const auto read_link_headers = [&](int64_t at) -> int64_t {
    // packets `at` (ident), then the next two of the same serial
    // (comment — skipped, setup); returns the first audio index or -2
    int64_t ident = at, setup = -1, seen = 0;
    for (int64_t j = at + 1; j < np && seen < 2; ++j) {
      if (serials[j] != serial) continue;
      if (++seen == 2) setup = j;
    }
    if (setup < 0) return -2;
    dec.reset(lt_decoder_new(blob.data() + offs[ident], lens[ident],
                             blob.data() + offs[setup], lens[setup], err,
                             sizeof(err)));
    if (!dec) return -2;
    const int ch = lt_decoder_channels(dec.get());
    if (channels && ch != channels) return -4;
    channels = ch;
    const uint32_t n1 = (uint32_t)lt_decoder_n1(dec.get());
    fbuf.assign((size_t)ch * (3 * n1 / 4), 0.0f);
    return setup + 1;
  };
  i = read_link_headers(0);
  if (i < 0) return i;

  for (; i < np; ++i) {
    if (serials[i] != serial) {
      if (flags[i] & 1) {  // BOS of a new serial: chained re-init
        serial = serials[i];
        cur_absgp = 0;
        i = read_link_headers(i);
        if (i < 0) return i;
        --i;  // loop ++
        continue;
      }
      continue;  // unrelated multiplexed stream
    }
    int n = lt_decoder_decode(dec.get(), blob.data() + offs[i], lens[i],
                              fbuf.data());
    if (n < 0) return -1;
    int64_t keep = n;
    if (flags[i] & 2) {  // last_in_stream: truncate to the page absgp
      uint64_t ap = (flags[i] & 16) ? absgp[i] : 0;
      int64_t target = (int64_t)ap - cur_absgp;
      if (target < 0) target = 0;
      if (target < keep) keep = target;
    }
    if ((flags[i] & 8) && (flags[i] & 16))  // last_in_page with absgp
      cur_absgp = (int64_t)absgp[i];
    else
      cur_absgp += keep;
    if (pos + keep > cap) return -3;
    for (int c = 0; c < channels; ++c) {
      const float* src = fbuf.data() + (size_t)c * n;
      int16_t* dst = pcm + (size_t)c * cap + pos;
      for (int64_t t = 0; t < keep; ++t) {
        float v = src[t] * 32768.0f;
        v = v < -32768.0f ? -32768.0f : (v > 32767.0f ? 32767.0f : v);
        dst[t] = (int16_t)v;  // C cast truncates toward zero
      }
    }
    pos += keep;
  }
  if (absgp_out) *absgp_out = cur_absgp;
  return pos;
} catch (const std::exception&) {
  return -2;  // allocation failure etc: caller falls back to its loop
}

}  // extern "C"
