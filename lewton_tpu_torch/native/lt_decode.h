// Shared native decode context: parsed stream + per-packet entropy decode.
#pragma once

#include "lt_header.h"

namespace lt {

struct Stream {
  IdentHeader ident;
  SetupHeader setup;
  // frame geometry
  uint32_t channels, n0, n1, W, P, Omax;
  // Per-residue classword expansion LUT: classword entry e ->
  // cpc class indices (e % cls^i ordering per spec 8.6.2), precomputed at
  // stream build so the hot pass-0 loop replaces cpc integer div/mods per
  // classword with one row copy. Empty when entries*cpc exceeds the cap
  // (adversarial setups) — decode falls back to the div loop.
  std::vector<std::vector<uint8_t>> class_luts;  // [residue][entries*cpc]
  // Bit p set => some class has a book in pass p. Passes with every book
  // -1 consume no bits and write nothing, so the decode loop skips them
  // outright (typical setups use 1-3 of the 8 cascade passes; pass 0
  // always runs — it carries the classwords).
  std::vector<uint8_t> pass_used;  // [residue]
  // Flattened per-residue book descriptors, indexed [class * 8 + pass].
  // One cache line replaces the Codebook -> Huffman -> lut/vq pointer
  // chase at every partition transition (the hot loop visits a partition
  // every ~2.5 symbols on real streams — the transitions, not the symbol
  // chain, are where the cycles go; see PERF.md r4).
  struct BookDesc {
    const int32_t* lut = nullptr;  // non-null => exact-tile fast path
    const float* vq = nullptr;
    const void* huf = nullptr;  // const Huffman* (slow path / generic)
    uint32_t lmask = 0;
    uint32_t nsym = 0;  // psize / dim (exact tile; psize is up to 2^24)
    uint16_t lbits = 0;
    uint16_t dim = 0;
    int16_t book = -1;  // >= 0 when a book exists for this (class, pass)
  };
  std::vector<std::vector<BookDesc>> res_descs;  // [residue][cls*8]
};

enum { LT_OK = 0, LT_IS_HEADER = 1, LT_BAD = 2 };

// lt_decode_chunk's residue emit: f32 rows, i16 rows or 12-bit planes
enum { LT_EMIT_F32 = 0, LT_EMIT_I16 = 1, LT_EMIT_P12 = 2 };

// lt_decode_chunk's stage slots: each worker's row of the optional
// [n_threads][LT_NS_SLOTS] block of nanoseconds spent in a stage of
// decode_packet_residues: clearing and deinterleaving the type-2 scratch of
// submaps off the stereo direct write; the per-channel residue (formats 0
// and 1)
enum { LT_NS_DEINTERLEAVE = 0, LT_NS_RESIDUE01 = 1, LT_NS_SLOTS = 2 };

// Reusable per-call scratch: decode_packet is called ~1M times/s per core,
// so its working vectors live across packets (assign() on a warm vector is
// a memset, not an allocation). One scratch per thread; Stream stays
// read-only during decode (thread-safe sharing).
struct DecodeScratch {
  std::vector<uint8_t> no_residue;        // [C]
  std::vector<uint32_t> y;                // floor1 raw posts
  std::vector<int32_t> fit;               // floor1 fit values (signed)
  std::vector<float> inter;               // residue type-2 interleave
  std::vector<uint32_t> cl;               // residue classifications
};

// Entropy half: one packet -> dense frame slices (see lt_entropy.cc).
int decode_packet(Stream* st, const uint8_t* pck, size_t len,
                  int32_t* mode_out, uint8_t* prev_out, uint8_t* next_out,
                  float* residue,                     // [C, rw]
                  uint8_t* f_used,                    // [C]
                  int32_t* f1_ys, uint8_t* f1_flags,  // [C, P] sorted-x order
                  float* f0_cosc, float* f0_amp,      // [C, Omax], [C]
                  uint32_t rw,  // residue row width (writes clamped)
                  DecodeScratch* scratch = nullptr);

}  // namespace lt
