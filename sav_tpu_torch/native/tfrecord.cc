// sav_tpu_torch native TFRecord support: CRC32C (Castagnoli), the checksum
// of TFRecord framing. Each record is a u64 length, the masked CRC32C of
// those 8 bytes, the payload and the masked CRC32C of the payload; the
// reader (sav_tpu_torch/data/tfrecord.py) checks both and the writer makes
// them.
//
// Slicing-by-8 over the reflected polynomial 0x82F63B78. Built with
// loader.cc and records.cc into one library
// (sav_tpu_torch/data/_native_build.py).

#include <cstdint>
#include <cstring>

namespace {

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const Crc32cTables& tables() {
  static const Crc32cTables instance;  // thread-safe initialisation (C++11)
  return instance;
}

inline uint32_t load_le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

// CRC32C of n bytes (unmasked; the caller masks it as TFRecord does).
uint32_t sav_crc32c(const uint8_t* data, int64_t n) {
  const auto& t = tables().t;
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    const uint32_t lo = crc ^ load_le32(data);
    const uint32_t hi = load_le32(data + 4);
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
