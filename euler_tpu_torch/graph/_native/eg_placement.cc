#include "eg_placement.h"

#include <dirent.h>

#include <cstring>
#include <fstream>
#include <sstream>

namespace eg {

namespace {

// Next power of two >= n (n >= 1).
uint64_t Pow2AtLeast(uint64_t n) {
  uint64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

void PlacementMap::Clear() {
  slots_.clear();
  size_ = 0;
  num_partitions_ = 0;
}

bool PlacementMap::Parse(const std::string& bytes, std::string* err) {
  Clear();
  constexpr size_t kHeader = 4 + 4 + 8;
  if (bytes.size() < kHeader) {
    *err = "placement artifact truncated (no header)";
    return false;
  }
  uint32_t magic;
  int32_t nparts;
  int64_t count;
  std::memcpy(&magic, bytes.data(), 4);
  std::memcpy(&nparts, bytes.data() + 4, 4);
  std::memcpy(&count, bytes.data() + 8, 8);
  if (magic != kPlacementMagic) {
    *err = "placement artifact has bad magic (not an EGP1 file)";
    return false;
  }
  if (nparts <= 0) {
    *err = "placement artifact declares num_partitions <= 0";
    return false;
  }
  // Bound the declared count by what the blob can actually carry (12
  // bytes per entry) BEFORE sizing the table — a hostile count must not
  // turn a short blob into a multi-GB allocation (eg-lint rule
  // wire-count-alloc applies to file-derived counts too).
  if (count < 0 ||
      static_cast<uint64_t>(count) > (bytes.size() - kHeader) / 12) {
    *err = "placement artifact count exceeds its payload";
    return false;
  }
  if (bytes.size() != kHeader + static_cast<size_t>(count) * 12) {
    *err = "placement artifact payload size mismatch";
    return false;
  }
  if (count == 0) {
    *err = "placement artifact is empty (zero mapped ids)";
    return false;
  }
  const char* ids_p = bytes.data() + kHeader;
  const char* parts_p = ids_p + static_cast<size_t>(count) * 8;
  // <= 50% load keeps the probe chains short on the routing hot path
  slots_.assign(Pow2AtLeast(static_cast<uint64_t>(count) * 2), Slot{});
  uint64_t mask = static_cast<uint64_t>(slots_.size()) - 1;
  for (int64_t k = 0; k < count; ++k) {
    uint64_t id;
    int32_t part;
    std::memcpy(&id, ids_p + k * 8, 8);
    std::memcpy(&part, parts_p + k * 4, 4);
    if (part < 0 || part >= nparts) {
      std::ostringstream os;
      os << "placement artifact maps id " << id
         << " to out-of-range partition " << part << " (num_partitions "
         << nparts << ")";
      *err = os.str();
      Clear();
      return false;
    }
    uint64_t i = Hash(id) & mask;
    while (slots_[i].part >= 0) {
      if (slots_[i].id == id) {
        std::ostringstream os;
        os << "placement artifact maps id " << id
           << " twice — ambiguous routing";
        *err = os.str();
        Clear();
        return false;
      }
      i = (i + 1) & mask;
    }
    slots_[i].id = id;
    slots_[i].part = part;
  }
  size_ = count;
  num_partitions_ = nparts;
  return true;
}

bool ReadPlacementDir(const std::string& dir, std::string* blob,
                      std::string* err) {
  blob->clear();
  DIR* d = opendir(dir.c_str());
  if (!d) {
    *err = "cannot open data dir " + dir;
    return false;
  }
  std::string found;
  bool dup = false;
  constexpr const char* kSuffix = ".placement";
  constexpr size_t kSuffixLen = 10;
  while (dirent* ent = readdir(d)) {
    std::string name = ent->d_name;
    if (name.size() <= kSuffixLen ||
        name.compare(name.size() - kSuffixLen, kSuffixLen, kSuffix) != 0)
      continue;
    if (!found.empty()) dup = true;
    found = name;
  }
  closedir(d);
  if (dup) {
    *err = "multiple *.placement artifacts in " + dir +
           " — ambiguous routing, remove all but one";
    return false;
  }
  if (found.empty()) return true;  // hash-sharded data: no artifact
  std::ifstream f(dir + "/" + found, std::ios::binary);
  std::ostringstream os;
  os << f.rdbuf();
  if (!f) {
    *err = "cannot read placement artifact " + dir + "/" + found;
    return false;
  }
  *blob = os.str();
  return true;
}

}  // namespace eg
