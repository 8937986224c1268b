/* lewton_tpu C API — surface parity with lewton's capi (cbindgen output
 * of lewton src/capi.rs), served by lewton_tpu_torch's host library.
 *
 *   python -c "from lewton_tpu_torch import _build; print(_build.capi_library())"
 *   cc app.c -I lewton_tpu_torch/native -L build/lewton_tpu_torch -llewton_host
 *
 * (capi_library() builds the library if needed and points the stable link
 * build/lewton_tpu_torch/liblewton_host.so at it.) The same library also
 * exports the frame-level entropy front-end used by the Python/device
 * pipeline (lt_stream_*, lt_ogg_*, lt_decoder_*); this header covers the
 * stable lewton-compatible subset.
 */
#ifndef LEWTON_TPU_H
#define LEWTON_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Opaque decoder state, created from Matroska/xiph-laced extradata
 * (first byte 2, xiph lacing for ident+comment lengths, three headers).
 * Returns NULL on malformed extradata. */
typedef struct LewtonContext LewtonContext;

/* One decoded packet: planar f32 samples per channel. */
typedef struct LewtonSamples LewtonSamples;

LewtonContext *lewton_context_from_extradata(const uint8_t *data, size_t len);

/* Reset the window state to support seeking. */
void lewton_context_reset(LewtonContext *ctx);

/* Decode one Vorbis packet. Returns 0 on success and stores a new
 * LewtonSamples in *sample_out; non-zero if no samples can be produced. */
int lewton_decode_packet(LewtonContext *ctx, const uint8_t *pkt, size_t len,
                         LewtonSamples **sample_out);

/* Samples per channel in this packet (0 for the stream-priming packet). */
size_t lewton_samples_count(const LewtonSamples *samples);

/* Number of channels. */
size_t lewton_samples_channels(const LewtonSamples *samples);

/* Borrowed pointer to one channel's f32 data (valid until _drop). */
const float *lewton_samples_f32(const LewtonSamples *samples, size_t channel);

void lewton_samples_drop(LewtonSamples *samples);
void lewton_context_drop(LewtonContext *ctx);

#ifdef __cplusplus
}
#endif

#endif /* LEWTON_TPU_H */
