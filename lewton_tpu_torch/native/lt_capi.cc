// lewton-compatible C ABI over the native CPU decoder.
//
// Surface parity with the reference's capi (lewton src/capi.rs:79-147):
// a LewtonContext built from Matroska/xiph-laced extradata, per-packet
// decode to planar f32 LewtonSamples, reset for seek support. Implemented
// over lt_decoder_* (lt_synth.cc).
#include <cstdint>
#include <cstring>
#include <vector>

namespace lt {
struct Decoder;
}

extern "C" {

lt::Decoder* lt_decoder_new(const uint8_t*, size_t, const uint8_t*, size_t,
                            char*, size_t);
void lt_decoder_free(lt::Decoder*);
void lt_decoder_reset(lt::Decoder*);
int lt_decoder_channels(const lt::Decoder*);
int lt_decoder_decode(lt::Decoder*, const uint8_t*, size_t, float*);

struct LewtonContext {
  lt::Decoder* dec;
  int channels;
};

struct LewtonSamples {
  std::vector<std::vector<float>> chans;
};

// xiph lacing length: sum of bytes until one < 255
static bool read_xiph_lacing(const uint8_t** p, const uint8_t* end,
                             size_t* out) {
  size_t r = 0;
  while (*p < end) {
    uint8_t v = **p;
    ++*p;
    r += v;
    if (v < 255) {
      *out = r;
      return true;
    }
  }
  return false;
}

LewtonContext* lewton_context_from_extradata(const uint8_t* data, size_t len) {
  if (!data || len == 0 || data[0] != 2) return nullptr;  // matroska: 3 pkts
  const uint8_t* p = data + 1;
  const uint8_t* end = data + len;
  size_t ident_len, comment_len;
  if (!read_xiph_lacing(&p, end, &ident_len)) return nullptr;
  if (!read_xiph_lacing(&p, end, &comment_len)) return nullptr;
  if ((size_t)(end - p) < ident_len + comment_len) return nullptr;
  const uint8_t* ident = p;
  const uint8_t* setup = p + ident_len + comment_len;  // comment skipped
  size_t setup_len = (size_t)(end - setup);
  char err[128];
  lt::Decoder* dec =
      lt_decoder_new(ident, ident_len, setup, setup_len, err, sizeof(err));
  if (!dec) return nullptr;
  return new LewtonContext{dec, lt_decoder_channels(dec)};
}

void lewton_context_reset(LewtonContext* ctx) {
  if (ctx) lt_decoder_reset(ctx->dec);
}

// 0 on success, non-zero if no samples can be produced (ref parity)
int lewton_decode_packet(LewtonContext* ctx, const uint8_t* pkt, size_t len,
                         LewtonSamples** sample_out) {
  if (!ctx || !pkt || !sample_out) return 1;
  // 3*n1/4 is the max per-channel output of one packet
  std::vector<float> pcm((size_t)ctx->channels * 8192 * 3 / 4);
  int n = lt_decoder_decode(ctx->dec, pkt, len, pcm.data());
  if (n < 0) return 2;
  auto* s = new LewtonSamples;
  s->chans.resize(ctx->channels);
  for (int c = 0; c < ctx->channels; ++c)
    s->chans[c].assign(pcm.begin() + (size_t)c * n,
                       pcm.begin() + (size_t)c * n + n);
  *sample_out = s;
  return 0;
}

size_t lewton_samples_count(const LewtonSamples* s) {
  return s && !s->chans.empty() ? s->chans[0].size() : 0;
}

size_t lewton_samples_channels(const LewtonSamples* s) {
  return s ? s->chans.size() : 0;
}

const float* lewton_samples_f32(const LewtonSamples* s, size_t channel) {
  return s && channel < s->chans.size() ? s->chans[channel].data() : nullptr;
}

void lewton_samples_drop(LewtonSamples* s) { delete s; }

void lewton_context_drop(LewtonContext* ctx) {
  if (ctx) {
    lt_decoder_free(ctx->dec);
    delete ctx;
  }
}

}  // extern "C"
