// A part of BatchDecoder's compaction (parallel/batch.py, _compact_part):
// the streams [lo, hi) of one device-compacted chunk, each stream's first
// totals[s] rows of `width` i16 samples, read from src + s * stride and
// written to dst[s] + starts[s] * width. One call copies a whole part, so
// the part's copies run without the interpreter's lock between them. The
// caller holds every row it names inside src and dst.

#include <cstdint>
#include <cstring>

extern "C" {

void lt_compact_rows(const int16_t* src, int64_t stride, int64_t width,
                     int16_t* const* dst, const int64_t* starts,
                     const int64_t* totals, int64_t lo, int64_t hi) {
  for (int64_t s = lo; s < hi; ++s)
    if (totals[s] > 0)
      std::memcpy(dst[s] + starts[s] * width, src + s * stride,
                  static_cast<size_t>(totals[s] * width) * sizeof(int16_t));
}

}  // extern "C"
