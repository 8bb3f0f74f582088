// sav_tpu_torch native record IO: the port's own copy of sav_tpu's
// native/records.cc, reading the same on-disk format ("SavRecord v1").
//
// A mmap'd fixed-shape image/label container with an offsets table, read
// by threaded batch gathers straight into caller-owned numpy buffers.
// Host-sharded epoch iteration is orchestrated in Python
// (sav_tpu_torch/data/records.py); all byte movement happens here with the
// GIL released.
//
// Layout (little-endian):
//   0x00  magic  "SAVREC01"                     (8 bytes)
//   0x08  u32 version (=1), u32 reserved
//   0x10  u64 num_records
//   0x18  u32 height, u32 width, u32 channels, u32 label_bytes (=4)
//   0x28  u64 offsets[num_records + 1]   // payload-relative byte offsets
//   ...   payload: per record, image bytes (h*w*c u8) then label (i32)
//
// Built with loader.cc into one library (sav_tpu_torch/data/_native_build.py).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>

#include "parallel_for.h"

namespace {

constexpr char kMagic[8] = {'S', 'A', 'V', 'R', 'E', 'C', '0', '1'};

struct SavRecFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  uint64_t num_records = 0;
  uint32_t height = 0, width = 0, channels = 0, label_bytes = 0;
  const uint64_t* offsets = nullptr;  // [num_records + 1]
  const uint8_t* payload = nullptr;
};

}  // namespace

extern "C" {

// Open + validate + mmap. Returns an opaque handle, or null on any error
// (missing file, bad magic/version, truncated header or payload).
void* sav_rec_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < 0x28) {
    ::close(fd);
    return nullptr;
  }
  size_t len = static_cast<size_t>(st.st_size);
  void* map = ::mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(map);
  auto fail = [&]() {
    ::munmap(map, len);
    ::close(fd);
    return nullptr;
  };
  if (std::memcmp(base, kMagic, sizeof(kMagic)) != 0) return fail();
  uint32_t version;
  std::memcpy(&version, base + 0x08, 4);
  if (version != 1) return fail();
  auto* f = new SavRecFile;
  f->fd = fd;
  f->map = base;
  f->map_len = len;
  std::memcpy(&f->num_records, base + 0x10, 8);
  std::memcpy(&f->height, base + 0x18, 4);
  std::memcpy(&f->width, base + 0x1C, 4);
  std::memcpy(&f->channels, base + 0x20, 4);
  std::memcpy(&f->label_bytes, base + 0x24, 4);
  // Overflow-safe truncation check: divide, never multiply a corrupt count.
  // `avail` is how many u64 slots fit after the header; the offsets table
  // needs num_records + 1 of them, so a header-only file (avail == 0) must
  // fail before the subtraction, not wrap it around.
  const size_t avail = (len - 0x28) / sizeof(uint64_t);
  if (avail == 0 || f->num_records > avail - 1) {
    delete f;
    return fail();
  }
  const size_t offsets_bytes = (f->num_records + 1) * sizeof(uint64_t);
  f->offsets = reinterpret_cast<const uint64_t*>(base + 0x28);
  f->payload = base + 0x28 + offsets_bytes;
  const size_t payload_len = len - 0x28 - offsets_bytes;
  // Validate the whole offsets table once at open so read_batch can trust
  // it: monotonic, in-bounds, and every record exactly image+label bytes.
  const uint64_t rec_bytes =
      static_cast<uint64_t>(f->height) * f->width * f->channels +
      f->label_bytes;
  if (f->offsets[f->num_records] > payload_len || rec_bytes == 0) {
    delete f;
    return fail();
  }
  for (uint64_t i = 0; i < f->num_records; ++i) {
    if (f->offsets[i + 1] < f->offsets[i] ||
        f->offsets[i + 1] - f->offsets[i] != rec_bytes) {
      delete f;
      return fail();
    }
  }
  return f;
}

int64_t sav_rec_count(const void* handle) {
  return static_cast<const SavRecFile*>(handle)->num_records;
}

// meta_out: [height, width, channels, label_bytes]
void sav_rec_meta(const void* handle, int64_t* meta_out) {
  const auto* f = static_cast<const SavRecFile*>(handle);
  meta_out[0] = f->height;
  meta_out[1] = f->width;
  meta_out[2] = f->channels;
  meta_out[3] = f->label_bytes;
}

// Gather `n` records by index into images_out [n, h*w*c] u8 and
// labels_out [n] i32. Returns 0 on success, -1 on any out-of-range index.
int sav_rec_read_batch(const void* handle, const int64_t* indices, int64_t n,
                       uint8_t* images_out, int32_t* labels_out, int threads) {
  const auto* f = static_cast<const SavRecFile*>(handle);
  const int64_t image_bytes =
      static_cast<int64_t>(f->height) * f->width * f->channels;
  std::atomic<int> bad(0);
  sav::parallel_for(n, threads, [&](int64_t i) {
    const int64_t idx = indices[i];
    if (idx < 0 || static_cast<uint64_t>(idx) >= f->num_records) {
      bad.store(1);
      return;
    }
    const uint8_t* rec = f->payload + f->offsets[idx];
    std::memcpy(images_out + i * image_bytes, rec, image_bytes);
    std::memcpy(labels_out + i, rec + image_bytes, sizeof(int32_t));
  });
  return bad.load() ? -1 : 0;
}

void sav_rec_close(void* handle) {
  auto* f = static_cast<SavRecFile*>(handle);
  ::munmap(const_cast<uint8_t*>(f->map), f->map_len);
  ::close(f->fd);
  delete f;
}

}  // extern "C"
