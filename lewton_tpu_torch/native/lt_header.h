// Vorbis header decode -> compiled setup tables (native host half).
//
// Mirrors the framework's Python reference (lewton_tpu/header.py) and the
// behavior of the reference decoder (lewton src/header.rs), implemented
// independently from Vorbis I spec §4.2.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

#include "lt_bits.h"

namespace lt {

struct IdentHeader {
  uint8_t channels = 0;
  uint32_t sample_rate = 0;
  int32_t bitrate_maximum = 0, bitrate_nominal = 0, bitrate_minimum = 0;
  uint8_t blocksize_0 = 0, blocksize_1 = 0;  // exponents
  uint32_t bs0() const { return 1u << blocksize_0; }
  uint32_t bs1() const { return 1u << blocksize_1; }
};

struct Codebook {
  uint16_t dimensions = 0;
  uint32_t entries = 0;
  Huffman huff;
  // VQ table, entries x dimensions (empty if lookup type 0)
  std::vector<float> vq;  // row-major [entries][dimensions]
  bool has_vq = false;
};

struct Floor0 {
  uint8_t order;
  uint16_t rate;
  uint16_t bark_map_size;
  uint8_t amplitude_bits;
  uint8_t amplitude_offset;
  std::vector<uint8_t> books;
};

struct Floor1 {
  std::vector<uint8_t> partition_class;
  std::vector<uint8_t> class_dims;
  std::vector<uint8_t> class_subclasses;
  std::vector<int16_t> class_masterbooks;            // -1 absent
  std::vector<std::vector<int16_t>> subclass_books;  // -1 absent
  uint8_t multiplier;  // 1..4
  std::vector<uint32_t> x_list;
  // derived
  std::vector<uint16_t> sort_order;  // argsort of x_list (stable)
  std::vector<uint16_t> low_neighbors, high_neighbors;
};

struct Floor {
  int type;  // 0 or 1
  Floor0 f0;
  Floor1 f1;
};

struct Residue {
  uint8_t residue_type;
  uint32_t begin, end;
  uint32_t partition_size;
  uint8_t classifications;
  uint8_t classbook;
  std::vector<std::vector<int16_t>> books;  // [classifications][8], -1 absent
};

struct Mapping {
  std::vector<uint8_t> coupling_magnitude, coupling_angle;
  std::vector<uint8_t> mux;
  std::vector<uint8_t> submap_floor, submap_residue;
};

struct Mode {
  uint8_t blockflag;
  uint8_t mapping;
};

struct SetupHeader {
  std::vector<Codebook> codebooks;
  std::vector<Floor> floors;
  std::vector<Residue> residues;
  std::vector<Mapping> mappings;
  std::vector<Mode> modes;
};

// Parse results: empty string = success.
std::string read_header_ident(const uint8_t* p, size_t n, IdentHeader* out);
std::string read_header_setup(const uint8_t* p, size_t n,
                              const IdentHeader& ident, SetupHeader* out);

}  // namespace lt
