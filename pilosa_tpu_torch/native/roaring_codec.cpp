// Native roaring codec: the host-side hot path for ingest and snapshot.
//
// C++ mirror of pilosa_tpu_torch/roaring/codec.py (format spec derived from the
// reference's roaring/roaring.go:30-65,812-974,3353-3420 and the official
// roaring interchange format :3819-3925).  The reference's equivalent of
// this component is Go with unsafe mmap casts; here decode/encode of
// fragment files runs native so bulk import and snapshot never bottleneck
// on the Python interpreter.
//
// C ABI: rc_serialize takes two passes (out=nullptr to size, then fill);
// rc_deserialize decodes once into a buffer that rc_decoded_bound sized
// from the headers.  Each returns the element/byte count, or a negative
// error code.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint16_t kMagic = 12348;
constexpr uint32_t kOfficialNoRun = 12346;
constexpr uint16_t kOfficial = 12347;

constexpr uint16_t kArray = 1;
constexpr uint16_t kBitmap = 2;
constexpr uint16_t kRun = 3;

constexpr size_t kArrayMaxSize = 4096;
constexpr size_t kRunMaxSize = 2048;
constexpr size_t kOpSize = 13;

constexpr int64_t kErrBadData = -1;
constexpr int64_t kErrChecksum = -2;

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline void wr16(std::vector<uint8_t>& b, uint16_t v) {
  b.insert(b.end(), reinterpret_cast<uint8_t*>(&v),
           reinterpret_cast<uint8_t*>(&v) + 2);
}
inline void wr32(std::vector<uint8_t>& b, uint32_t v) {
  b.insert(b.end(), reinterpret_cast<uint8_t*>(&v),
           reinterpret_cast<uint8_t*>(&v) + 4);
}
inline void wr64(std::vector<uint8_t>& b, uint64_t v) {
  b.insert(b.end(), reinterpret_cast<uint8_t*>(&v),
           reinterpret_cast<uint8_t*>(&v) + 8);
}

uint32_t fnv1a32(const uint8_t* data, size_t n) {
  uint32_t h = 2166136261u;
  for (size_t i = 0; i < n; i++) {
    h ^= data[i];
    h *= 16777619u;
  }
  return h;
}

// The caller's buffer, filled in order; writing past its capacity is bad
// data (rc_decoded_bound sizes it from the headers).
struct Out {
  uint64_t* data;
  size_t size, cap;
  bool room(size_t n) const { return n <= cap - size; }
};

// Decode one container's low-16 values appended (with key) into out.
int64_t decode_container(const uint8_t* data, size_t len, size_t offset,
                         uint16_t ctype, size_t n, uint64_t keybase,
                         bool run_is_len, Out& out, size_t* end_offset) {
  if (ctype == kRun) {
    if (offset + 2 > len) return kErrBadData;
    size_t run_count = rd16(data + offset);
    if (offset + 2 + run_count * 4 > len) return kErrBadData;
    const uint8_t* p = data + offset + 2;
    for (size_t r = 0; r < run_count; r++) {
      uint32_t start = rd16(p + r * 4);
      uint32_t last = rd16(p + r * 4 + 2);
      if (run_is_len) last = start + last;  // official: (start, length)
      if (last < start) continue;
      if (!out.room(last - start + 1)) return kErrBadData;
      for (uint32_t v = start; v <= last; v++) out.data[out.size++] = keybase | v;
    }
    *end_offset = offset + 2 + run_count * 4;
  } else if (ctype == kArray) {
    if (offset + n * 2 > len) return kErrBadData;
    const uint8_t* p = data + offset;
    if (!out.room(n)) return kErrBadData;
    for (size_t i = 0; i < n; i++) out.data[out.size++] = keybase | rd16(p + i * 2);
    *end_offset = offset + n * 2;
  } else if (ctype == kBitmap) {
    if (offset + 8192 > len) return kErrBadData;
    const uint8_t* p = data + offset;
    for (size_t w = 0; w < 1024; w++) {
      uint64_t word = rd64(p + w * 8);
      if (!out.room(__builtin_popcountll(word))) return kErrBadData;
      while (word) {
        int bit = __builtin_ctzll(word);
        out.data[out.size++] = keybase | (w * 64 + bit);
        word &= word - 1;
      }
    }
    *end_offset = offset + 8192;
  } else {
    return kErrBadData;
  }
  return 0;
}

int64_t decode_pilosa(const uint8_t* data, size_t len,
                      Out& values, int64_t* op_n) {
  size_t key_n = rd32(data + 4);
  size_t hdr = 8;
  if (hdr + key_n * 16 > len) return kErrBadData;
  size_t ops_offset = hdr + key_n * 16;
  for (size_t i = 0; i < key_n; i++) {
    const uint8_t* h = data + hdr + i * 12;
    uint64_t key = rd64(h);
    uint16_t ctype = rd16(h + 8);
    size_t n = static_cast<size_t>(rd16(h + 10)) + 1;
    uint32_t offset = rd32(data + hdr + key_n * 12 + i * 4);
    if (offset >= len) return kErrBadData;
    size_t end = 0;
    int64_t rc = decode_container(data, len, offset, ctype, n, key << 16,
                                  false, values, &end);
    if (rc < 0) return rc;
    if (end > ops_offset) ops_offset = end;
  }
  // Op-log replay (roaring.go:3353-3420).
  *op_n = 0;
  if (ops_offset < len) {
    std::unordered_set<uint64_t> set(values.data, values.data + values.size);
    size_t pos = ops_offset;
    while (pos < len) {
      if (pos + kOpSize > len) return kErrBadData;
      const uint8_t* op = data + pos;
      if (rd32(op + 9) != fnv1a32(op, 9)) return kErrChecksum;
      uint8_t typ = op[0];
      uint64_t value = rd64(op + 1);
      if (typ == 0)
        set.insert(value);
      else if (typ == 1)
        set.erase(value);
      else
        return kErrBadData;
      (*op_n)++;
      pos += kOpSize;
    }
    if (set.size() > values.cap) return kErrBadData;
    values.size = set.size();
    std::copy(set.begin(), set.end(), values.data);
    std::sort(values.data, values.data + values.size);
  }
  return 0;
}

int64_t decode_official(const uint8_t* data, size_t len,
                        Out& values) {
  uint32_t cookie = rd32(data);
  size_t pos = 4;
  size_t key_n;
  std::vector<bool> is_run;
  bool have_runs;
  if (cookie == kOfficialNoRun) {
    if (pos + 4 > len) return kErrBadData;
    key_n = rd32(data + pos);
    pos += 4;
    is_run.assign(key_n, false);
    have_runs = false;
  } else if ((cookie & 0xFFFF) == kOfficial) {
    key_n = (cookie >> 16) + 1;
    size_t nbytes = (key_n + 7) / 8;
    if (pos + nbytes > len) return kErrBadData;
    is_run.resize(key_n);
    for (size_t i = 0; i < key_n; i++)
      is_run[i] = (data[pos + i / 8] >> (i % 8)) & 1;
    pos += nbytes;
    have_runs = true;
  } else {
    return kErrBadData;
  }
  if (pos + key_n * 4 > len) return kErrBadData;
  struct Hdr {
    uint16_t key;
    uint16_t ctype;
    size_t n;
  };
  std::vector<Hdr> headers(key_n);
  for (size_t i = 0; i < key_n; i++) {
    uint16_t key = rd16(data + pos);
    size_t n = static_cast<size_t>(rd16(data + pos + 2)) + 1;
    uint16_t ctype = is_run[i] ? kRun : (n < kArrayMaxSize ? kArray : kBitmap);
    headers[i] = {key, ctype, n};
    pos += 4;
  }
  std::vector<uint32_t> offsets;
  if (!have_runs) {
    if (pos + key_n * 4 > len) return kErrBadData;
    for (size_t i = 0; i < key_n; i++) offsets.push_back(rd32(data + pos + i * 4));
    pos += key_n * 4;
  }
  for (size_t i = 0; i < key_n; i++) {
    size_t offset = have_runs ? pos : offsets[i];
    size_t end = 0;
    int64_t rc =
        decode_container(data, len, offset, headers[i].ctype, headers[i].n,
                         static_cast<uint64_t>(headers[i].key) << 16,
                         /*run_is_len=*/true, values, &end);
    if (rc < 0) return rc;
    if (have_runs) pos = end;
  }
  return 0;
}

}  // namespace

extern "C" {

int32_t rc_abi_version() { return 2; }

// An upper bound of the values rc_deserialize gives for these bytes, from
// the headers alone: the containers' cardinalities, plus, in the pilosa
// format, one value a record of the op log that may follow the last
// container.  Negative for bad data.
int64_t rc_decoded_bound(const uint8_t* data, size_t len) {
  if (len < 8) return kErrBadData;
  const bool pilosa = rd16(data) == kMagic;
  const uint32_t cookie = rd32(data);
  size_t key_n, hdr, stride;
  if (pilosa) {
    key_n = rd32(data + 4), hdr = 8, stride = 12;  // [key u64][type u16][n-1 u16]
  } else if (cookie == kOfficialNoRun) {
    key_n = rd32(data + 4), hdr = 8, stride = 4;  // [key u16][n-1 u16]
  } else if ((cookie & 0xFFFF) == kOfficial) {
    key_n = (cookie >> 16) + 1, hdr = 4 + (key_n + 7) / 8, stride = 4;
  } else {
    return kErrBadData;
  }
  if (hdr + key_n * (stride + (pilosa ? 4 : 0)) > len) return kErrBadData;
  size_t total = 0;
  for (size_t i = 0; i < key_n; i++)
    total += static_cast<size_t>(rd16(data + hdr + i * stride + stride - 2)) + 1;
  if (pilosa) {
    // The op log starts at or after the last container's offset.
    size_t last = hdr + key_n * 16;
    for (size_t i = 0; i < key_n; i++)
      last = std::max<size_t>(last, rd32(data + hdr + key_n * 12 + i * 4));
    total += (len - std::min(last, len)) / kOpSize;
  }
  return static_cast<int64_t>(total);
}

// Decode roaring bytes -> sorted unique u64 values into out (out_cap from
// rc_decoded_bound; a smaller buffer is bad data).  op_n (optional)
// receives the replayed op count.
int64_t rc_deserialize(const uint8_t* data, size_t len, uint64_t* out,
                       size_t out_cap, int64_t* op_n) {
  if (len < 8) return kErrBadData;
  Out values{out, 0, out_cap};
  int64_t ops = 0;
  int64_t rc;
  if (rd16(data) == kMagic) {
    if (rd16(data + 2) != 0) return kErrBadData;  // version
    rc = decode_pilosa(data, len, values, &ops);
  } else {
    rc = decode_official(data, len, values);
  }
  if (rc < 0) return rc;
  if (op_n) *op_n = ops;
  return static_cast<int64_t>(values.size);
}

// Serialize sorted unique u64 values -> pilosa-roaring bytes.  Two-pass.
int64_t rc_serialize(const uint64_t* values, size_t n, uint8_t* out,
                     size_t out_cap) {
  // Group into containers by high-48 key.
  struct Container {
    uint64_t key;
    size_t start, end;  // [start, end) into values
    uint16_t ctype;
  };
  std::vector<Container> cs;
  size_t i = 0;
  while (i < n) {
    uint64_t key = values[i] >> 16;
    size_t j = i;
    size_t runs = 1;
    while (j + 1 < n && (values[j + 1] >> 16) == key) {
      if (values[j + 1] != values[j] + 1) runs++;
      j++;
    }
    size_t count = j - i + 1;
    uint16_t ctype;
    if (runs <= kRunMaxSize && runs <= count / 2)
      ctype = kRun;
    else if (count < kArrayMaxSize)
      ctype = kArray;
    else
      ctype = kBitmap;
    cs.push_back({key, i, j + 1, ctype});
    i = j + 1;
  }

  std::vector<uint8_t> buf;
  buf.reserve(64 + n * 2);
  wr32(buf, kMagic);  // cookie: magic | version(0)<<16
  wr32(buf, static_cast<uint32_t>(cs.size()));
  for (const auto& c : cs) {
    wr64(buf, c.key);
    wr16(buf, c.ctype);
    wr16(buf, static_cast<uint16_t>(c.end - c.start - 1));
  }
  // Offset table placeholder.
  size_t offset_table = buf.size();
  buf.resize(buf.size() + cs.size() * 4);
  for (size_t ci = 0; ci < cs.size(); ci++) {
    const auto& c = cs[ci];
    uint32_t off = static_cast<uint32_t>(buf.size());
    std::memcpy(buf.data() + offset_table + ci * 4, &off, 4);
    if (c.ctype == kRun) {
      // Count then emit inclusive [start, last] pairs.
      std::vector<std::pair<uint16_t, uint16_t>> runs;
      uint16_t start = static_cast<uint16_t>(values[c.start]);
      uint16_t prev = start;
      for (size_t k = c.start + 1; k < c.end; k++) {
        uint16_t v = static_cast<uint16_t>(values[k]);
        if (v != prev + 1) {
          runs.push_back({start, prev});
          start = v;
        }
        prev = v;
      }
      runs.push_back({start, prev});
      wr16(buf, static_cast<uint16_t>(runs.size()));
      for (auto& r : runs) {
        wr16(buf, r.first);
        wr16(buf, r.second);
      }
    } else if (c.ctype == kArray) {
      for (size_t k = c.start; k < c.end; k++)
        wr16(buf, static_cast<uint16_t>(values[k]));
    } else {
      uint64_t words[1024] = {0};
      for (size_t k = c.start; k < c.end; k++) {
        uint16_t low = static_cast<uint16_t>(values[k]);
        words[low >> 6] |= 1ULL << (low & 63);
      }
      const uint8_t* p = reinterpret_cast<const uint8_t*>(words);
      buf.insert(buf.end(), p, p + 8192);
    }
  }
  if (out != nullptr) {
    if (out_cap < buf.size()) return kErrBadData;
    std::memcpy(out, buf.data(), buf.size());
  }
  return static_cast<int64_t>(buf.size());
}

}  // extern "C"
