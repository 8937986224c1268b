// Sanitizer fuzzer for the native host library.
//
// The reference's robustness mechanism is a pinned fuzzer-crash corpus
// (lewton dev/cmp/tests/fuzzed.rs); its memory safety comes from rustc.
// The C++ half gets the equivalent guarantee from this program built with
// -fsanitize=address,undefined (_build.build_fuzzer() compiles it with
// the library's sources; it lies in native/tools/, which the library's own
// build, of native/*.cc, does not read, so its main() stays out): it
// demuxes and fully decodes seed .ogg files plus deterministic mutations
// (truncations, bit flips, region scrambles) — any overflow/UB aborts.
//
// Each variant's packets also come through lt_ogg_new_into (written into a
// buffer of the input's length) and through a fed stream (lt_ogg_stream_*,
// in pieces of 1 to 4096 bytes); a packet, length, serial, flag or granule
// that differs from lt_ogg_new's aborts as a finding does.
//
// Usage: lt_fuzz FILE.ogg [FILE2.ogg ...]
//   LT_FUZZ_SEED=N   mutation RNG seed (default 0x1234567) — multi-seed
//                    campaigns sweep different flip/scramble sites
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <vector>

#include "lt_decode.h"

extern "C" {
struct OggReaderOpaque;
OggReaderOpaque* lt_ogg_new(const uint8_t*, size_t);
void lt_ogg_free(OggReaderOpaque*);
int64_t lt_ogg_packet_count(const OggReaderOpaque*);
void lt_ogg_packet_meta(const OggReaderOpaque*, uint64_t*, uint32_t*,
                        uint8_t*, uint64_t*, uint64_t*);
void lt_ogg_packet_data(const OggReaderOpaque*, uint8_t*);
OggReaderOpaque* lt_ogg_new_into(const uint8_t*, size_t, uint8_t*);
OggReaderOpaque* lt_ogg_stream_new();
int64_t lt_ogg_stream_feed(OggReaderOpaque*, const uint8_t*, size_t);
struct DecoderOpaque;
DecoderOpaque* lt_decoder_new(const uint8_t*, size_t, const uint8_t*, size_t,
                              char*, size_t);
void lt_decoder_free(DecoderOpaque*);
int lt_decoder_decode(DecoderOpaque*, const uint8_t*, size_t, float*);
int64_t lt_decode_ogg_i16(const OggReaderOpaque*, int16_t*, int64_t,
                          int64_t*);
struct StreamOpaque;
StreamOpaque* lt_stream_new(const uint8_t*, size_t, const uint8_t*, size_t,
                            char*, size_t);
void lt_stream_free(StreamOpaque*);
int lt_stream_channels(const StreamOpaque*);
int lt_stream_n1(const StreamOpaque*);
int lt_stream_max_posts(const StreamOpaque*);
int lt_stream_f0_order_max(const StreamOpaque*);
int lt_decode_chunk(StreamOpaque*, const uint8_t* const*, const uint64_t*,
                    const uint64_t*, const int32_t*, int, int, int32_t*,
                    uint8_t*, uint8_t*, uint8_t*, int, void*, uint8_t*,
                    int32_t*, uint8_t*, float*, float*, int, int, uint64_t*,
                    uint64_t*, uint64_t*);
}

static uint32_t rng_state = 0x1234567;
static uint32_t rng() {
  rng_state = rng_state * 1664525u + 1013904223u;
  return rng_state;
}

// The packets of a demux handle, appended to `out`: per packet its length,
// serial, flags, absgp and page granule, then its bytes, read from `blob`
// (lt_ogg_new_into's buffer) or copied out by lt_ogg_packet_data.
static void append_packets(const OggReaderOpaque* ogg,
                           std::vector<uint64_t>& out,
                           const uint8_t* blob = nullptr) {
  int64_t n = lt_ogg_packet_count(ogg);
  if (n <= 0) return;
  std::vector<uint64_t> lens(n), absgp(n), pgran(n);
  std::vector<uint32_t> serials(n);
  std::vector<uint8_t> flags(n);
  lt_ogg_packet_meta(ogg, lens.data(), serials.data(), flags.data(),
                     absgp.data(), pgran.data());
  uint64_t total = 0;
  for (auto l : lens) total += l;
  std::vector<uint8_t> copy;
  if (!blob) {
    copy.resize(total ? total : 1);
    lt_ogg_packet_data(ogg, copy.data());
    blob = copy.data();
  }
  for (int64_t i = 0; i < n; ++i) {
    out.insert(out.end(), {lens[i], serials[i], flags[i], absgp[i], pgran[i]});
    for (uint64_t j = 0; j < lens[i]; ++j) out.push_back(*blob++);
  }
}

// lt_ogg_new_into and a fed stream against lt_ogg_new on one input.
static void check_demux_routes(const std::vector<uint8_t>& data) {
  std::vector<uint64_t> want, into, fed;
  OggReaderOpaque* ogg = lt_ogg_new(data.data(), data.size());
  append_packets(ogg, want);
  lt_ogg_free(ogg);
  std::vector<uint8_t> out(data.size() ? data.size() : 1);
  ogg = lt_ogg_new_into(data.data(), data.size(), out.data());
  if (!ogg) abort();
  append_packets(ogg, into, out.data());
  lt_ogg_free(ogg);
  // piece sizes from an LCG of their own: the mutations stay those of the
  // seed
  uint32_t piece = (uint32_t)data.size() | 1u;
  OggReaderOpaque* st = lt_ogg_stream_new();
  for (size_t off = 0; off < data.size();) {
    piece = piece * 1664525u + 1013904223u;
    size_t step = 1 + (piece >> 8) % 4096;
    if (step > data.size() - off) step = data.size() - off;
    if (lt_ogg_stream_feed(st, data.data() + off, step) < 0) abort();
    append_packets(st, fed);
    off += step;
  }
  lt_ogg_free(st);
  if (into != want || fed != want) {
    fprintf(stderr, "lt_fuzz: demux routes differ on a %zu-byte input\n",
            data.size());
    abort();
  }
}

static int decode_all(const std::vector<uint8_t>& data) {
  check_demux_routes(data);
  OggReaderOpaque* ogg = lt_ogg_new(data.data(), data.size());
  int64_t n = lt_ogg_packet_count(ogg);
  if (n < 3) {
    lt_ogg_free(ogg);
    return 0;
  }
  {
    // whole-file one-call path (lt_file.cc): chained re-init, absgp
    // truncation and the i16 conversion all parse hostile input too.
    // Deliberately small cap: the cap-exceeded (-3) exit must be clean.
    // The API contract is "pcm holds channels*cap" and a hostile ident
    // can declare up to 255 channels, so size for the maximum.
    std::vector<int16_t> pcm((size_t)256 * 4096);
    int64_t absgp = 0;
    (void)lt_decode_ogg_i16(ogg, pcm.data(), 4096, &absgp);
  }
  std::vector<uint64_t> lens(n), absgp(n), pgran(n);
  std::vector<uint32_t> serials(n);
  std::vector<uint8_t> flags(n);
  lt_ogg_packet_meta(ogg, lens.data(), serials.data(), flags.data(),
                     absgp.data(), pgran.data());
  uint64_t total = 0;
  for (auto l : lens) total += l;
  std::vector<uint8_t> blob(total ? total : 1);
  lt_ogg_packet_data(ogg, blob.data());
  lt_ogg_free(ogg);

  // find first serial's first three packets = headers
  uint32_t serial = serials[0];
  std::vector<std::pair<const uint8_t*, size_t>> mine;
  uint64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (serials[i] == serial) mine.push_back({blob.data() + off, lens[i]});
    off += lens[i];
  }
  if (mine.size() < 4) return 0;
  char err[128];
  DecoderOpaque* dec = lt_decoder_new(mine[0].first, mine[0].second,
                                      mine[2].first, mine[2].second, err,
                                      sizeof(err));
  if (!dec) return 0;
  std::vector<float> pcm(16 * 8192 * 3 / 4);
  int decoded = 0;
  for (size_t i = 3; i < mine.size(); ++i) {
    int r = lt_decoder_decode(dec, mine[i].first, mine[i].second, pcm.data());
    if (r > 0) decoded += r;
  }
  lt_decoder_free(dec);

  // The chunk entry with deliberately TIGHT residue row widths, in every
  // residue emit: the rw-clipped accumulate paths (stereo type-2
  // direct-write, type-0/1 tails) are exactly where a bounds bug corrupts
  // the adjacent channel row or the next packet's frame — and the
  // lt_decoder path above never exercises them (it always uses rw = n1/2).
  StreamOpaque* stm = lt_stream_new(mine[0].first, mine[0].second,
                                    mine[2].first, mine[2].second, err,
                                    sizeof(err));
  if (stm) {
    const size_t C = (size_t)lt_stream_channels(stm);
    const size_t P = (size_t)lt_stream_max_posts(stm);
    const size_t Om = (size_t)lt_stream_f0_order_max(stm);
    const int W = lt_stream_n1(stm) / 2;
    int T = (int)mine.size() - 3;
    if (T > 8) T = 8;
    if (T > 0 && C <= 16) {
      std::vector<uint8_t> buf;
      std::vector<uint64_t> offs(T), lens(T);
      for (int t = 0; t < T; ++t) {
        offs[t] = buf.size();
        lens[t] = mine[3 + t].second;
        buf.insert(buf.end(), mine[3 + t].first,
                   mine[3 + t].first + mine[3 + t].second);
      }
      const int widths[5] = {1, 127, 128, 129, W};
      for (int rw : widths) {
        if (rw < 1 || rw > W) continue;
        const uint8_t* base = buf.data();
        std::vector<int32_t> mode(T);
        std::vector<uint8_t> prevf(T), nextf(T), status(T);
        std::vector<uint8_t> f_kind((size_t)T * C);
        std::vector<int32_t> f1_ys((size_t)T * C * P);
        std::vector<uint8_t> f1_flags((size_t)T * C * P);
        std::vector<float> f0_cosc((size_t)T * C * (Om ? Om : 1));
        std::vector<float> f0_amp((size_t)T * C);
        // f32 and i16 rows of C*rw elements; the 12-bit planes where the
        // row width allows them
        std::vector<float> res_f32((size_t)T * C * rw);
        std::vector<int16_t> res_i16((size_t)T * C * rw);
        std::vector<uint32_t> res_p12((size_t)T * 3 * (C * rw) / 8);
        void* residues[3] = {res_f32.data(), res_i16.data(), res_p12.data()};
        for (int emit = lt::LT_EMIT_F32; emit <= lt::LT_EMIT_P12; ++emit) {
          if (emit == lt::LT_EMIT_P12 && (C * (size_t)rw) % 8) continue;
          // the i16 emit also times its stages into one worker's row
          uint64_t busy = 0, wall = 0, stages[lt::LT_NS_SLOTS] = {};
          const bool timed = emit == lt::LT_EMIT_I16;
          lt_decode_chunk(stm, &base, offs.data(), lens.data(), &T, 1, T,
                          mode.data(), prevf.data(), nextf.data(),
                          status.data(), emit, residues[emit], f_kind.data(),
                          f1_ys.data(), f1_flags.data(), f0_cosc.data(),
                          f0_amp.data(), rw, 1, timed ? &busy : nullptr,
                          timed ? &wall : nullptr, timed ? stages : nullptr);
        }
      }
    }
    lt_stream_free(stm);
  }
  return decoded;
}

int main(int argc, char** argv) {
  if (const char* seed = std::getenv("LT_FUZZ_SEED"))
    rng_state = (uint32_t)strtoul(seed, nullptr, 0) | 1u;
  int total_variants = 0;
  for (int a = 1; a < argc; ++a) {
    std::ifstream f(argv[a], std::ios::binary);
    std::vector<uint8_t> data{std::istreambuf_iterator<char>(f), {}};
    if (data.empty()) continue;
    decode_all(data);
    ++total_variants;
    // truncations
    for (int i = 1; i <= 16; ++i) {
      std::vector<uint8_t> v(data.begin(),
                             data.begin() + (data.size() * i) / 17);
      decode_all(v);
      ++total_variants;
    }
    // bit flips
    for (int i = 0; i < 200; ++i) {
      std::vector<uint8_t> v = data;
      v[rng() % v.size()] ^= (uint8_t)(1u << (rng() & 7));
      decode_all(v);
      ++total_variants;
    }
    // region scrambles
    for (int i = 0; i < 32; ++i) {
      std::vector<uint8_t> v = data;
      size_t start = rng() % v.size();
      size_t len = 1 + rng() % 64;
      for (size_t j = start; j < v.size() && j < start + len; ++j)
        v[j] = (uint8_t)rng();
      decode_all(v);
      ++total_variants;
    }
  }
  printf("lt_fuzz: %d variants decoded without sanitizer findings\n",
         total_variants);
  return 0;
}
