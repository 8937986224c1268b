// Vorbis header parsing (see lt_header.h). Spec §4.2 + §3.2.
#include "lt_header.h"

#include <algorithm>
#include <cmath>
#include <set>

namespace lt {

static uint32_t ilog(uint32_t x) {
  uint32_t r = 0;
  while (x) {
    ++r;
    x >>= 1;
  }
  return r;
}

// Largest l with l^dim <= entries (spec 9.2.3).
static uint32_t lookup1_values(uint32_t entries, uint32_t dim) {
  uint32_t l = (uint32_t)std::pow((double)entries, 1.0 / dim);
  auto powok = [&](uint64_t b) {
    uint64_t v = 1;
    for (uint32_t i = 0; i < dim; ++i) {
      v *= b;
      if (v > entries) return false;
    }
    return v <= entries;
  };
  while (powok(l + 1)) ++l;
  while (l > 0 && !powok(l)) --l;
  return l;
}

static std::string check_capture(const uint8_t* p, size_t n, int expected,
                                 BitCursor* cur) {
  if (n < 7) return "packet shorter than capture pattern";
  if (memcmp(p + 1, "vorbis", 6) != 0) return "capture pattern mismatch";
  if ((p[0] & 1) == 0) return "audio packet passed to header reader";
  if (p[0] != expected) return "unexpected header type";
  cur->advance(7 * 8);
  return "";
}

std::string read_header_ident(const uint8_t* p, size_t n, IdentHeader* out) {
  BitCursor cur(p, n);
  std::string e = check_capture(p, n, 1, &cur);
  if (!e.empty()) return e;
  uint32_t version, channels, rate, b0, b1, framing;
  int32_t brmax, brnom, brmin;
  if (!cur.read(32, &version) || version != 0) return "bad version";
  if (!cur.read(8, &channels) || !cur.read(32, &rate) ||
      !cur.read_i32(32, &brmax) || !cur.read_i32(32, &brnom) ||
      !cur.read_i32(32, &brmin) || !cur.read(4, &b0) || !cur.read(4, &b1) ||
      !cur.read(1, &framing))
    return "truncated ident header";
  if (channels == 0) return "zero channels";
  if (rate == 0) return "zero sample rate";
  if (b0 < 6 || b0 > 13 || b1 < 6 || b1 > 13 || b0 > b1)
    return "blocksize exponents out of range";
  if (framing != 1) return "ident framing bit unset";
  out->channels = (uint8_t)channels;
  out->sample_rate = rate;
  out->bitrate_maximum = brmax;
  out->bitrate_nominal = brnom;
  out->bitrate_minimum = brmin;
  out->blocksize_0 = (uint8_t)b0;
  out->blocksize_1 = (uint8_t)b1;
  return "";
}

static std::string read_codebook(BitCursor* cur, Codebook* cb) {
  uint32_t sync;
  if (!cur->read(24, &sync) || sync != 0x564342) return "codebook sync";
  uint32_t dims, entries, v;
  if (!cur->read(16, &dims) || !cur->read(24, &entries))
    return "truncated codebook";
  cb->dimensions = (uint16_t)dims;
  cb->entries = entries;
  bool ordered;
  if (!cur->read_flag(&ordered)) return "truncated codebook";
  // each entry costs >= 1 bit below; don't let a tiny crafted packet
  // allocate a 2^24-element list first (mirrors header.py)
  if (!ordered && entries > cur->bits_remaining())
    return "truncated codebook";
  std::vector<uint8_t> lengths(entries, 0);
  if (!ordered) {
    bool sparse;
    if (!cur->read_flag(&sparse)) return "truncated codebook";
    for (uint32_t i = 0; i < entries; ++i) {
      if (sparse) {
        bool present;
        if (!cur->read_flag(&present)) return "truncated codebook";
        if (!present) continue;
      }
      if (!cur->read(5, &v)) return "truncated codebook";
      lengths[i] = (uint8_t)(v + 1);
    }
  } else {
    uint32_t cur_entry = 0, cur_len;
    if (!cur->read(5, &cur_len)) return "truncated codebook";
    ++cur_len;
    while (cur_entry < entries) {
      uint32_t number;
      if (!cur->read(ilog(entries - cur_entry), &number))
        return "truncated codebook";
      if (cur_entry + number > entries)
        return "ordered codebook length list overflow";
      for (uint32_t i = cur_entry; i < cur_entry + number; ++i)
        lengths[i] = (uint8_t)cur_len;
      cur_entry += number;
      ++cur_len;
      if (cur_len > 32 && cur_entry < entries)
        return "ordered codebook length > 32";
    }
  }
  std::string herr;
  if (!cb->huff.build(lengths, &herr)) return herr;

  uint32_t lookup_type;
  if (!cur->read(4, &lookup_type)) return "truncated codebook";
  if (lookup_type == 0) return "";
  if (lookup_type > 2) return "codebook lookup type";
  float minv, delv;
  uint32_t value_bits;
  bool sequence_p;
  if (!cur->read_vorbis_float(&minv) || !cur->read_vorbis_float(&delv) ||
      !cur->read(4, &value_bits) || !cur->read_flag(&sequence_p))
    return "truncated codebook";
  ++value_bits;
  // A VQ book (lookup 1/2) must map entries to >= 1 scalar: libvorbis
  // rejects dim < 1 at unpack, and a dim-0 book reaching residue/floor0
  // decode divides by zero / reads vec[-1] (heap OOB). Scalar dim-0
  // books (lookup 0) stay accepted.
  if (dims == 0) return "VQ codebook with zero dimensions";
  uint64_t lookup_values = lookup_type == 1
                               ? lookup1_values(entries, dims)
                               : (uint64_t)entries * dims;
  // Bound allocations by what the packet can actually back: every lookup
  // value costs value_bits (>=1) bits, so a count beyond the remaining
  // packet bits is necessarily truncated. Without this a 33-byte crafted
  // setup packet (ordered lengths + lookup type 2) can request a ~4TB
  // allocation (entries<=2^24-1 x dims<=65535) before any read fails.
  if (lookup_values * value_bits > cur->bits_remaining())
    return "truncated codebook";
  // The expanded VQ table (entries x dims floats) has no packet backing for
  // lookup type 1; cap it at a bound generously above any real stream's
  // books (64MB) so malformed streams get a clean error, not bad_alloc.
  if ((uint64_t)entries * dims > (1ull << 24))
    return "codebook VQ table too large";
  std::vector<float> mults(lookup_values);
  for (uint64_t i = 0; i < lookup_values; ++i) {
    if (!cur->read(value_bits, &v)) return "truncated codebook";
    mults[i] = (float)v;
  }
  cb->has_vq = true;
  cb->vq.assign((size_t)entries * dims, 0.0f);
  if (entries && dims) {
    if (lookup_type == 1) {
      if (lookup_values == 0) return "lookup1 with zero lookup values";
      for (uint32_t e = 0; e < entries; ++e) {
        uint64_t div = 1;
        float last = 0.0f;
        for (uint32_t j = 0; j < dims; ++j) {
          uint64_t off = (e / div) % lookup_values;
          float val = mults[off] * delv + minv;
          if (sequence_p) {
            val += last;
            last = val;
          }
          cb->vq[(size_t)e * dims + j] = val;
          div *= lookup_values;
        }
      }
    } else {
      for (uint32_t e = 0; e < entries; ++e) {
        float last = 0.0f;
        for (uint32_t j = 0; j < dims; ++j) {
          float val = mults[(size_t)e * dims + j] * delv + minv;
          if (sequence_p) {
            val += last;
            last = val;
          }
          cb->vq[(size_t)e * dims + j] = val;
        }
      }
    }
  }
  return "";
}

static std::string read_floor(BitCursor* cur, uint32_t codebook_count,
                              Floor* fl) {
  uint32_t floor_type, v;
  if (!cur->read(16, &floor_type)) return "truncated floor";
  fl->type = (int)floor_type;
  if (floor_type == 0) {
    Floor0& f = fl->f0;
    uint32_t order, rate, bms, ab, ao, nbooks;
    if (!cur->read(8, &order) || !cur->read(16, &rate) ||
        !cur->read(16, &bms) || !cur->read(6, &ab) || !cur->read(8, &ao) ||
        !cur->read(4, &nbooks))
      return "truncated floor0";
    ++nbooks;
    if (order == 0 || rate == 0 || bms == 0)
      return "floor0 zero order/rate/bark_map_size";
    if (ab > 64) return "floor0 amplitude_bits > 64";
    f.order = (uint8_t)order;
    f.rate = (uint16_t)rate;
    f.bark_map_size = (uint16_t)bms;
    f.amplitude_bits = (uint8_t)ab;
    f.amplitude_offset = (uint8_t)ao;
    for (uint32_t i = 0; i < nbooks; ++i) {
      if (!cur->read(8, &v)) return "truncated floor0";
      if (v >= codebook_count) return "floor0 book out of range";
      f.books.push_back((uint8_t)v);
    }
    return "";
  }
  if (floor_type != 1) return "floor type";
  Floor1& f = fl->f1;
  uint32_t partitions;
  if (!cur->read(5, &partitions)) return "truncated floor1";
  int max_class = -1;
  for (uint32_t i = 0; i < partitions; ++i) {
    if (!cur->read(4, &v)) return "truncated floor1";
    f.partition_class.push_back((uint8_t)v);
    if ((int)v > max_class) max_class = (int)v;
  }
  for (int c = 0; c <= max_class; ++c) {
    uint32_t dims, subclasses;
    if (!cur->read(3, &dims) || !cur->read(2, &subclasses))
      return "truncated floor1";
    ++dims;
    int mb = -1;
    if (subclasses) {
      if (!cur->read(8, &v)) return "truncated floor1";
      if (v >= codebook_count) return "floor1 masterbook out of range";
      mb = (int)v;
    }
    std::vector<int16_t> books;
    for (uint32_t s = 0; s < (1u << subclasses); ++s) {
      if (!cur->read(8, &v)) return "truncated floor1";
      int b = (int)v - 1;
      if (b >= (int)codebook_count) return "floor1 subclass book out of range";
      books.push_back((int16_t)b);
    }
    f.class_dims.push_back((uint8_t)dims);
    f.class_subclasses.push_back((uint8_t)subclasses);
    f.class_masterbooks.push_back((int16_t)mb);
    f.subclass_books.push_back(std::move(books));
  }
  uint32_t mult, rangebits;
  if (!cur->read(2, &mult) || !cur->read(4, &rangebits))
    return "truncated floor1";
  f.multiplier = (uint8_t)(mult + 1);
  f.x_list = {0, 1u << rangebits};
  for (uint32_t p = 0; p < partitions; ++p) {
    uint8_t cls = f.partition_class[p];
    for (uint32_t d = 0; d < f.class_dims[cls]; ++d) {
      if (!cur->read(rangebits, &v)) return "truncated floor1";
      f.x_list.push_back(v);
    }
  }
  if (f.x_list.size() > 65) return "floor1 x_list longer than 65";
  std::set<uint32_t> uniq(f.x_list.begin(), f.x_list.end());
  if (uniq.size() != f.x_list.size()) return "floor1 x_list values not unique";
  // derived: stable argsort + low/high neighbors (spec 9.2.4/9.2.5)
  size_t n = f.x_list.size();
  f.sort_order.resize(n);
  for (size_t i = 0; i < n; ++i) f.sort_order[i] = (uint16_t)i;
  std::stable_sort(f.sort_order.begin(), f.sort_order.end(),
                   [&](uint16_t a, uint16_t b) {
                     return f.x_list[a] < f.x_list[b];
                   });
  f.low_neighbors.assign(n, 0);
  f.high_neighbors.assign(n, 0);
  for (size_t i = 2; i < n; ++i) {
    size_t lo = 0, hi = 1;
    for (size_t j = 0; j < i; ++j) {
      if (f.x_list[j] < f.x_list[i] && f.x_list[j] >= f.x_list[lo]) lo = j;
      if (f.x_list[j] > f.x_list[i] && f.x_list[j] <= f.x_list[hi]) hi = j;
    }
    f.low_neighbors[i] = (uint16_t)lo;
    f.high_neighbors[i] = (uint16_t)hi;
  }
  return "";
}

static std::string read_residue(BitCursor* cur,
                                const std::vector<Codebook>& codebooks,
                                Residue* r) {
  uint32_t rtype, v;
  if (!cur->read(16, &rtype)) return "truncated residue";
  if (rtype > 2) return "residue type";
  r->residue_type = (uint8_t)rtype;
  uint32_t begin, end, psize, classifications, classbook;
  if (!cur->read(24, &begin) || !cur->read(24, &end) ||
      !cur->read(24, &psize) || !cur->read(6, &classifications) ||
      !cur->read(8, &classbook))
    return "truncated residue";
  if (begin > end) return "residue begin > end";
  r->begin = begin;
  r->end = end;
  r->partition_size = psize + 1;
  r->classifications = (uint8_t)(classifications + 1);
  if (classbook >= codebooks.size()) return "residue classbook out of range";
  if (codebooks[classbook].dimensions == 0)
    return "residue classbook with zero dimensions";
  r->classbook = (uint8_t)classbook;
  std::vector<uint8_t> cascades;
  for (uint32_t c = 0; c < r->classifications; ++c) {
    uint32_t low, high = 0;
    bool bitflag;
    if (!cur->read(3, &low) || !cur->read_flag(&bitflag))
      return "truncated residue";
    if (bitflag && !cur->read(5, &high)) return "truncated residue";
    cascades.push_back((uint8_t)((high << 3) | low));
  }
  for (uint32_t c = 0; c < r->classifications; ++c) {
    std::vector<int16_t> row;
    for (int p = 0; p < 8; ++p) {
      if (cascades[c] & (1u << p)) {
        if (!cur->read(8, &v)) return "truncated residue";
        if (v >= codebooks.size()) return "residue book out of range";
        if (!codebooks[v].has_vq) return "residue book without VQ table";
        row.push_back((int16_t)v);
      } else {
        row.push_back(-1);
      }
    }
    r->books.push_back(std::move(row));
  }
  return "";
}

static std::string read_mapping(BitCursor* cur, uint32_t channels,
                                uint32_t floor_count, uint32_t residue_count,
                                Mapping* m) {
  uint32_t mtype, v;
  if (!cur->read(16, &mtype)) return "truncated mapping";
  if (mtype != 0) return "mapping type";
  bool flag;
  uint32_t submaps = 1;
  if (!cur->read_flag(&flag)) return "truncated mapping";
  if (flag) {
    if (!cur->read(4, &v)) return "truncated mapping";
    submaps = v + 1;
  }
  if (!cur->read_flag(&flag)) return "truncated mapping";
  if (flag) {
    uint32_t steps;
    if (!cur->read(8, &steps)) return "truncated mapping";
    ++steps;
    uint32_t bits = ilog(channels - 1);
    for (uint32_t s = 0; s < steps; ++s) {
      uint32_t mag, ang;
      if (!cur->read(bits, &mag) || !cur->read(bits, &ang))
        return "truncated mapping";
      if (mag == ang || mag >= channels || ang >= channels)
        return "invalid coupling channel pair";
      m->coupling_magnitude.push_back((uint8_t)mag);
      m->coupling_angle.push_back((uint8_t)ang);
    }
  }
  if (!cur->read(2, &v)) return "truncated mapping";
  if (v != 0) return "mapping reserved bits set";
  if (submaps > 1) {
    for (uint32_t c = 0; c < channels; ++c) {
      if (!cur->read(4, &v)) return "truncated mapping";
      if (v >= submaps) return "mapping mux out of range";
      m->mux.push_back((uint8_t)v);
    }
  } else {
    m->mux.assign(channels, 0);
  }
  for (uint32_t s = 0; s < submaps; ++s) {
    if (!cur->read(8, &v)) return "truncated mapping";  // time placeholder
    if (!cur->read(8, &v)) return "truncated mapping";
    if (v >= floor_count) return "mapping floor out of range";
    m->submap_floor.push_back((uint8_t)v);
    if (!cur->read(8, &v)) return "truncated mapping";
    if (v >= residue_count) return "mapping residue out of range";
    m->submap_residue.push_back((uint8_t)v);
  }
  return "";
}

static std::string read_mode(BitCursor* cur, uint32_t mapping_count, Mode* m) {
  uint32_t blockflag, windowtype, transformtype, mapping;
  if (!cur->read(1, &blockflag) || !cur->read(16, &windowtype) ||
      !cur->read(16, &transformtype) || !cur->read(8, &mapping))
    return "truncated mode";
  if (windowtype != 0) return "window type";
  if (transformtype != 0) return "transform type";
  if (mapping >= mapping_count) return "mode mapping out of range";
  m->blockflag = (uint8_t)blockflag;
  m->mapping = (uint8_t)mapping;
  return "";
}

std::string read_header_setup(const uint8_t* p, size_t n,
                              const IdentHeader& ident, SetupHeader* out) {
  BitCursor cur(p, n);
  std::string e = check_capture(p, n, 5, &cur);
  if (!e.empty()) return e;
  uint32_t v;
  if (!cur.read(8, &v)) return "truncated setup";
  uint32_t codebook_count = v + 1;
  out->codebooks.resize(codebook_count);
  for (uint32_t i = 0; i < codebook_count; ++i) {
    e = read_codebook(&cur, &out->codebooks[i]);
    if (!e.empty()) return e;
  }
  if (!cur.read(6, &v)) return "truncated setup";
  for (uint32_t i = 0; i < v + 1; ++i) {
    uint32_t t;
    if (!cur.read(16, &t)) return "truncated setup";
    if (t != 0) return "nonzero time transform";
  }
  if (!cur.read(6, &v)) return "truncated setup";
  uint32_t floor_count = v + 1;
  out->floors.resize(floor_count);
  for (uint32_t i = 0; i < floor_count; ++i) {
    e = read_floor(&cur, codebook_count, &out->floors[i]);
    if (!e.empty()) return e;
  }
  if (!cur.read(6, &v)) return "truncated setup";
  uint32_t residue_count = v + 1;
  out->residues.resize(residue_count);
  for (uint32_t i = 0; i < residue_count; ++i) {
    e = read_residue(&cur, out->codebooks, &out->residues[i]);
    if (!e.empty()) return e;
  }
  if (!cur.read(6, &v)) return "truncated setup";
  uint32_t mapping_count = v + 1;
  out->mappings.resize(mapping_count);
  for (uint32_t i = 0; i < mapping_count; ++i) {
    e = read_mapping(&cur, ident.channels, floor_count, residue_count,
                     &out->mappings[i]);
    if (!e.empty()) return e;
  }
  if (!cur.read(6, &v)) return "truncated setup";
  uint32_t mode_count = v + 1;
  out->modes.resize(mode_count);
  for (uint32_t i = 0; i < mode_count; ++i) {
    e = read_mode(&cur, mapping_count, &out->modes[i]);
    if (!e.empty()) return e;
  }
  if (!cur.read(1, &v) || v != 1) return "setup framing bit unset";
  return "";
}

}  // namespace lt
