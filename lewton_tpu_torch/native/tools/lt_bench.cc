// Standalone entropy front-end benchmark: packets/s for lt_decode_chunk.
//
// The host entropy decode is bit-serial CPU work that feeds the card's
// synthesis, so it is measured here in isolation, on the same code path as
// the production ctypes call (lt_decode_chunk on one stream, f32 emit, in
// chunks of 128 packets into reused frame buffers), so that a change to it
// can be attributed:
//   lt_bench file.ogg [repeat]
// Prints the packet count, packets/s and MB/s of bitstream by the wall
// clock, and packets/s by the process's CPU time; on stderr, the share of
// the wall in each of the entry's timed stages (its stage slots, LT_NS_*
// of lt_decode.h: one clock pair a packet and submap). _build.build_bench()
// builds it with the host library's sources and flags (plus -g, a
// profiler's target); it lies in native/tools/, which the library's own
// build does not read.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "lt_decode.h"

namespace lt {
struct OggReader;
}

extern "C" {
lt::Stream* lt_stream_new(const uint8_t*, size_t, const uint8_t*, size_t,
                          char*, size_t);
void lt_stream_free(lt::Stream*);
int lt_stream_channels(const lt::Stream*);
int lt_stream_n1(const lt::Stream*);
int lt_stream_max_posts(const lt::Stream*);
int lt_stream_f0_order_max(const lt::Stream*);
int lt_decode_chunk(lt::Stream*, const uint8_t* const*, const uint64_t*,
                    const uint64_t*, const int32_t*, int, int, int32_t*,
                    uint8_t*, uint8_t*, uint8_t*, int, void*, uint8_t*,
                    int32_t*, uint8_t*, float*, float*, int, int, uint64_t*,
                    uint64_t*, uint64_t*);
lt::OggReader* lt_ogg_new(const uint8_t*, size_t);
void lt_ogg_free(lt::OggReader*);
int64_t lt_ogg_packet_count(const lt::OggReader*);
void lt_ogg_packet_meta(const lt::OggReader*, uint64_t*, uint32_t*, uint8_t*,
                        uint64_t*, uint64_t*);
void lt_ogg_packet_data(const lt::OggReader*, uint8_t*);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s file.ogg [repeat]\n", argv[0]);
    return 2;
  }
  int repeat = argc > 2 ? atoi(argv[2]) : 40;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(sz);
  if (fread(data.data(), 1, sz, f) != (size_t)sz) return 2;
  fclose(f);

  lt::OggReader* ogg = lt_ogg_new(data.data(), data.size());
  int64_t np = lt_ogg_packet_count(ogg);
  std::vector<uint64_t> lens(np), absgp(np), pgran(np);
  std::vector<uint32_t> serials(np);
  std::vector<uint8_t> flags(np);
  lt_ogg_packet_meta(ogg, lens.data(), serials.data(), flags.data(),
                     absgp.data(), pgran.data());
  uint64_t total = 0;
  for (auto l : lens) total += l;
  std::vector<uint8_t> buf(total);
  lt_ogg_packet_data(ogg, buf.data());
  lt_ogg_free(ogg);
  std::vector<uint64_t> offs(np);
  for (int64_t i = 1; i < np; ++i) offs[i] = offs[i - 1] + lens[i - 1];

  char err[256];
  lt::Stream* st = lt_stream_new(buf.data() + offs[0], lens[0],
                                 buf.data() + offs[2], lens[2], err,
                                 sizeof(err));
  if (!st) {
    fprintf(stderr, "header parse failed: %s\n", err);
    return 2;
  }
  // replicate the audio packets `repeat` times
  int n_audio = (int)(np - 3);
  std::vector<uint64_t> aoffs, alens;
  uint64_t abytes = 0;
  for (int r = 0; r < repeat; ++r)
    for (int i = 3; i < np; ++i) {
      aoffs.push_back(offs[i]);
      alens.push_back(lens[i]);
      abytes += lens[i];
    }
  int N = (int)aoffs.size();
  // production shape: chunks of T packets into reused frame buffers
  const int T = 128;
  const int C = lt_stream_channels(st);
  const int W = lt_stream_n1(st) / 2;
  const int P = lt_stream_max_posts(st);
  const int Om = lt_stream_f0_order_max(st) > 0 ? lt_stream_f0_order_max(st)
                                                : 1;
  std::vector<int32_t> mode(T), f1_ys((size_t)T * C * P);
  std::vector<uint8_t> prevf(T), nextf(T), status(T), f_used((size_t)T * C),
      f1_flags((size_t)T * C * P);
  std::vector<float> residue((size_t)T * C * W), f0_cosc((size_t)T * C * Om),
      f0_amp((size_t)T * C);

  int bad = 0;
  uint64_t stages[lt::LT_NS_SLOTS] = {};
  timespec c0, c1;
  clock_gettime(CLOCK_PROCESS_CPUTIME_ID, &c0);
  auto t0 = std::chrono::steady_clock::now();
  const uint8_t* base_ptr = buf.data();
  for (int base = 0; base < N; base += T) {
    int n = N - base < T ? N - base : T;
    lt_decode_chunk(st, &base_ptr, aoffs.data() + base, alens.data() + base,
                    &n, 1, T, mode.data(), prevf.data(), nextf.data(),
                    status.data(), lt::LT_EMIT_F32, residue.data(),
                    f_used.data(), f1_ys.data(), f1_flags.data(),
                    f0_cosc.data(), f0_amp.data(), W, 1, nullptr, nullptr,
                    stages);
    for (int t = 0; t < n; ++t) bad += status[t] != 0;
  }
  auto t1 = std::chrono::steady_clock::now();
  clock_gettime(CLOCK_PROCESS_CPUTIME_ID, &c1);
  double dt = std::chrono::duration<double>(t1 - t0).count();
  // process CPU time: immune to noisy-neighbor steal (this vCPU's wall
  // clock swings +-20% minute to minute; A/B on cpu-time instead)
  double dc = (c1.tv_sec - c0.tv_sec) + (c1.tv_nsec - c0.tv_nsec) * 1e-9;
  printf("packets %d (x%d of %d), bad %d\n", N, repeat, n_audio, bad);
  printf("%.0f packets/s, %.1f MB/s bitstream, %.2f ms\n", N / dt,
         abytes / dt / 1e6, dt * 1e3);
  printf("cpu: %.0f packets/s, %.2f ms\n", N / dc, dc * 1e3);
  fprintf(stderr, "stages: deinterleave %.1f%%, residue01 %.1f%% of the wall\n",
          stages[lt::LT_NS_DEINTERLEAVE] / dt / 1e7,
          stages[lt::LT_NS_RESIDUE01] / dt / 1e7);
  lt_stream_free(st);
  return 0;
}
