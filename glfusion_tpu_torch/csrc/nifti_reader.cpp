// Native NIfTI-1 decoder + parallel batch reader for the data pipeline.
//
// A copy of the JAX package's decoder (glfusion_tpu/native/nifti_reader.cpp)
// with its comments brought to the port; the code is the same. gzip inflate
// and voxel decode run in C++ (zlib), with a std::thread fan-out for
// batches.
//
// C API (ctypes-friendly, no C++ types across the boundary):
//   gl_nifti_query_v2(path, dims_out[8], &dtype, &numel, &slope, &inter)
//   gl_nifti_read_raw(path, out, nbytes)                    -> 0 on success
//   gl_nifti_read_many_raw(paths, n, out, offsets, nbytes, threads)
//   gl_nifti_read_f32(path, out, numel)                     -> 0 on success
//   gl_nifti_read_many_f32(paths, n, out_flat, offsets, numels, threads)
//
// Voxels are written in file order (Fortran order); the Python wrapper
// (glfusion_tpu_torch/native/loader.py) reshapes with order='F' exactly like
// the pure-Python reader (glfusion_tpu_torch/data/nifti.py).
// scl_slope/scl_inter are applied when set: f * slope + inter, rounded
// twice as numpy rounds it, when built with -ffp-contract=off.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Header {
  int ndim = 0;
  int64_t shape[7] = {0};
  int dtype = 0;
  int64_t vox_offset = 352;
  float scl_slope = 1.0f;
  float scl_inter = 0.0f;
  bool big_endian = false;
  int64_t numel = 0;
};

// Read a whole file, inflating if it is gzip-compressed (.gz magic).
bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 2) { std::fclose(f); return false; }
  std::vector<uint8_t> raw(static_cast<size_t>(fsize));
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) return false;

  if (raw[0] == 0x1f && raw[1] == 0x8b) {  // gzip
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
    out.clear();
    // gzip footer ISIZE = uncompressed size mod 2^32: exact preallocation
    // for any volume < 4 GiB (all echo data), avoiding resize copies.
    // Capped at 1 GiB — a corrupt/truncated footer must not request a
    // multi-GiB allocation; the doubling loop below grows if genuine.
    uint32_t isize;
    std::memcpy(&isize, raw.data() + raw.size() - 4, 4);
    size_t prealloc = isize ? isize : raw.size() * 4 + (1 << 16);
    out.resize(std::min<size_t>(prealloc, size_t{1} << 30));
    zs.next_in = raw.data();
    zs.avail_in = static_cast<uInt>(raw.size());
    size_t total = 0;
    int ret = Z_OK;
    while (ret != Z_STREAM_END) {
      if (total == out.size()) out.resize(out.size() * 2);
      zs.next_out = out.data() + total;
      zs.avail_out = static_cast<uInt>(out.size() - total);
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs);
        return false;
      }
      total = out.size() - zs.avail_out;
    }
    inflateEnd(&zs);
    out.resize(total);
    return true;
  }
  out = std::move(raw);
  return true;
}

// Inflate (or copy) only the first `limit` output bytes — enough for the
// 348-byte header. Keeps gl_nifti_query O(header) instead of O(volume).
bool read_file_prefix(const char* path, std::vector<uint8_t>& out,
                      size_t limit) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> raw(1 << 16);
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  raw.resize(got);
  if (got < 2) { std::fclose(f); return false; }

  if (raw[0] == 0x1f && raw[1] == 0x8b) {  // gzip: stream until limit
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {
      std::fclose(f);
      return false;
    }
    out.resize(limit);
    size_t total = 0;
    int ret = Z_OK;
    zs.next_in = raw.data();
    zs.avail_in = static_cast<uInt>(raw.size());
    while (total < limit && ret != Z_STREAM_END) {
      if (zs.avail_in == 0) {
        got = std::fread(raw.data(), 1, raw.capacity(), f);
        if (got == 0) break;
        raw.resize(got);
        zs.next_in = raw.data();
        zs.avail_in = static_cast<uInt>(got);
      }
      zs.next_out = out.data() + total;
      zs.avail_out = static_cast<uInt>(limit - total);
      ret = inflate(&zs, Z_NO_FLUSH);
      if (ret != Z_OK && ret != Z_STREAM_END) {
        inflateEnd(&zs);
        std::fclose(f);
        return false;
      }
      total = limit - zs.avail_out;
    }
    inflateEnd(&zs);
    std::fclose(f);
    out.resize(total);
    return total >= 348;
  }
  // plain file: first bytes are the header
  out.assign(raw.begin(),
             raw.begin() + std::min(raw.size(), limit));
  std::fclose(f);
  return out.size() >= 348;
}

template <typename T>
T load_scalar(const uint8_t* p, bool swap) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  if (swap) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    for (size_t i = 0; i < sizeof(T) / 2; ++i)
      std::swap(b[i], b[sizeof(T) - 1 - i]);
  }
  return v;
}

bool parse_header(const std::vector<uint8_t>& buf, Header& h) {
  if (buf.size() < 348) return false;
  int32_t sizeof_hdr = load_scalar<int32_t>(buf.data(), false);
  bool swap = false;
  if (sizeof_hdr != 348) {
    swap = true;
    if (load_scalar<int32_t>(buf.data(), true) != 348) return false;
  }
  h.big_endian = swap;
  const char* magic = reinterpret_cast<const char*>(buf.data() + 344);
  if (std::strncmp(magic, "n+1", 3) != 0 &&
      std::strncmp(magic, "ni1", 3) != 0)
    return false;
  int16_t nd = load_scalar<int16_t>(buf.data() + 40, swap);
  if (nd < 1 || nd > 7) return false;
  h.ndim = nd;
  h.numel = 1;
  for (int i = 0; i < nd; ++i) {
    int16_t d = load_scalar<int16_t>(buf.data() + 42 + 2 * i, swap);
    h.shape[i] = d;
    h.numel *= d;
  }
  h.dtype = load_scalar<int16_t>(buf.data() + 70, swap);
  float off = load_scalar<float>(buf.data() + 108, swap);
  h.vox_offset = off > 0 ? static_cast<int64_t>(off) : 352;
  h.scl_slope = load_scalar<float>(buf.data() + 112, swap);
  h.scl_inter = load_scalar<float>(buf.data() + 116, swap);
  return true;
}

// NIfTI-1 scaling semantics: scl_slope == 0 means "no scaling" (scl_inter
// is ignored too); non-finite slope/inter are treated as unset.  Mirrors
// needs_scaling() in glfusion_tpu_torch/data/nifti.py — keep the two in
// sync.
bool needs_scaling(float slope, float inter) {
  return std::isfinite(slope) && std::isfinite(inter) && slope != 0.0f &&
         !(slope == 1.0f && inter == 0.0f);
}

template <typename T>
void convert(const uint8_t* src, float* dst, int64_t n, bool swap,
             float slope, float inter) {
  bool scale = needs_scaling(slope, inter);
  for (int64_t i = 0; i < n; ++i) {
    T v = load_scalar<T>(src + i * sizeof(T), swap);
    float f = static_cast<float>(v);
    dst[i] = scale ? f * slope + inter : f;
  }
}

bool decode(const std::vector<uint8_t>& buf, const Header& h, float* out) {
  const uint8_t* vox = buf.data() + h.vox_offset;
  int64_t avail = static_cast<int64_t>(buf.size()) - h.vox_offset;
  auto need = [&](size_t itemsize) {
    return avail >= h.numel * static_cast<int64_t>(itemsize);
  };
  switch (h.dtype) {
    case 2:   if (!need(1)) return false;
              convert<uint8_t>(vox, out, h.numel, false, h.scl_slope,
                               h.scl_inter); return true;
    case 256: if (!need(1)) return false;
              convert<int8_t>(vox, out, h.numel, false, h.scl_slope,
                              h.scl_inter); return true;
    case 4:   if (!need(2)) return false;
              convert<int16_t>(vox, out, h.numel, h.big_endian, h.scl_slope,
                               h.scl_inter); return true;
    case 512: if (!need(2)) return false;
              convert<uint16_t>(vox, out, h.numel, h.big_endian, h.scl_slope,
                                h.scl_inter); return true;
    case 8:   if (!need(4)) return false;
              convert<int32_t>(vox, out, h.numel, h.big_endian, h.scl_slope,
                               h.scl_inter); return true;
    case 768: if (!need(4)) return false;
              convert<uint32_t>(vox, out, h.numel, h.big_endian, h.scl_slope,
                                h.scl_inter); return true;
    case 16:  if (!need(4)) return false;
              convert<float>(vox, out, h.numel, h.big_endian, h.scl_slope,
                             h.scl_inter); return true;
    case 64:  if (!need(8)) return false;
              convert<double>(vox, out, h.numel, h.big_endian, h.scl_slope,
                              h.scl_inter); return true;
    default:  return false;
  }
}

}  // namespace

extern "C" {

// dims_out: int64[8] -> [ndim, d1..d7]; numel_out: total voxel count.
int gl_nifti_query(const char* path, int64_t* dims_out, int* dtype_out,
                   int64_t* numel_out) try {
  std::vector<uint8_t> buf;
  if (!read_file_prefix(path, buf, 352)) return 1;
  Header h;
  if (!parse_header(buf, h)) return 2;
  dims_out[0] = h.ndim;
  for (int i = 0; i < 7; ++i) dims_out[1 + i] = i < h.ndim ? h.shape[i] : 1;
  *dtype_out = h.dtype;
  *numel_out = h.numel;
  return 0;
} catch (...) {
  return 8;
}

// v2: also reports scl_slope/scl_inter so the Python wrapper can decide
// whether the f32-decoded voxels round-trip to the on-disk dtype exactly
// (scaling applied => values are floats; casting back would truncate).
int gl_nifti_query_v2(const char* path, int64_t* dims_out, int* dtype_out,
                      int64_t* numel_out, float* slope_out,
                      float* inter_out) try {
  std::vector<uint8_t> buf;
  if (!read_file_prefix(path, buf, 352)) return 1;
  Header h;
  if (!parse_header(buf, h)) return 2;
  dims_out[0] = h.ndim;
  for (int i = 0; i < 7; ++i) dims_out[1 + i] = i < h.ndim ? h.shape[i] : 1;
  *dtype_out = h.dtype;
  *numel_out = h.numel;
  *slope_out = h.scl_slope;
  *inter_out = h.scl_inter;
  return 0;
} catch (...) {
  return 8;
}

// Raw voxel bytes (no f32 round trip) — the fast path for UNSCALED
// volumes: exact for every dtype (it is the on-disk representation).
// Returns 5 for big-endian files (caller byte-swaps via the Python
// reader) and 6 when scl_slope/scl_inter apply (values must be scaled,
// use the f32 path).
int gl_nifti_read_raw(const char* path, uint8_t* out, int64_t nbytes) {
  // try/catch: a corrupt gzip footer can provoke a huge allocation; the
  // exception must not unwind across the C ABI (std::terminate) — return
  // an rc so the caller falls back to the Python reader's clean error.
  try {
    std::vector<uint8_t> buf;
    if (!read_file(path, buf)) return 1;
    Header h;
    if (!parse_header(buf, h)) return 2;
    if (h.big_endian) return 5;
    if (needs_scaling(h.scl_slope, h.scl_inter)) return 6;
    if (static_cast<int64_t>(buf.size()) - h.vox_offset < nbytes) return 3;
    std::memcpy(out, buf.data() + h.vox_offset, nbytes);
    return 0;
  } catch (...) {
    return 8;
  }
}

// Parallel batch raw read: paths[i] copies into out + byte_offsets[i].
int gl_nifti_read_many_raw(const char* const* paths, int n, uint8_t* out,
                           const int64_t* byte_offsets,
                           const int64_t* nbytes, int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = n;
  std::vector<int> failures(n, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += num_threads) {
        failures[i] =
            gl_nifti_read_raw(paths[i], out + byte_offsets[i], nbytes[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
  int failed = 0;
  for (int i = 0; i < n; ++i) failed += failures[i] != 0;
  return failed;
}

// out must have room for numel floats (file/Fortran order).
int gl_nifti_read_f32(const char* path, float* out, int64_t numel) {
  try {
    std::vector<uint8_t> buf;
    if (!read_file(path, buf)) return 1;
    Header h;
    if (!parse_header(buf, h)) return 2;
    if (h.numel != numel) return 3;
    return decode(buf, h, out) ? 0 : 4;
  } catch (...) {
    return 8;
  }
}

// Parallel batch read: paths[i] decodes into out_flat + offsets[i], which
// must hold numel(paths[i]) floats. Returns the number of failed reads.
int gl_nifti_read_many_f32(const char* const* paths, int n, float* out_flat,
                           const int64_t* offsets, const int64_t* numels,
                           int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  if (num_threads > n) num_threads = n;
  std::vector<int> failures(n, 0);
  std::vector<std::thread> pool;
  // static round-robin partition: thread t takes items t, t+T, t+2T, ...
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += num_threads) {
        failures[i] =
            gl_nifti_read_f32(paths[i], out_flat + offsets[i], numels[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
  int failed = 0;
  for (int i = 0; i < n; ++i) failed += failures[i] != 0;
  return failed;
}

}  // extern "C"
