// fastnifti: native NIfTI-1 (.nii/.nii.gz) decoder + preprocessing
// (the port's copy of fast_cwdm_tpu/data/native/fastnifti.cpp).
//
// inflate → dtype-convert → quantile clip → min-max normalize in C++ with
// one temporary, called through ctypes: the call releases the GIL, so the
// Python ThreadedLoader decodes cases on every core. The arithmetic of
// convert() and fastnifti_clip_normalize() is the JAX package's, line for
// line, so both decoders give the same float32 bits.
//
// Built by data/native/__init__.py: g++ -O3 -shared -fPIC fastnifti.cpp -lz

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

constexpr int HDR_SIZE = 348;

struct Header {
  int16_t dim[8];
  int16_t datatype;
  float vox_offset;
  float scl_slope;
  float scl_inter;
  int16_t sform_code;
  float srow[12];
};

bool parse_header(const unsigned char* buf, Header* h) {
  int32_t size;
  std::memcpy(&size, buf, 4);
  if (size != HDR_SIZE) return false;  // big-endian unsupported natively
  std::memcpy(h->dim, buf + 40, 16);
  std::memcpy(&h->datatype, buf + 70, 2);
  std::memcpy(&h->vox_offset, buf + 108, 4);
  std::memcpy(&h->scl_slope, buf + 112, 4);
  std::memcpy(&h->scl_inter, buf + 116, 4);
  std::memcpy(&h->sform_code, buf + 254, 2);
  std::memcpy(h->srow, buf + 280, 48);
  const unsigned char* magic = buf + 344;
  return std::memcmp(magic, "n+1", 3) == 0 || std::memcmp(magic, "ni1", 3) == 0;
}

// Read a file, or its first `limit` bytes (limit < 0: all of it);
// transparently inflates gzip (zlib's gzopen handles both plain and gzip
// streams).
bool read_file(const char* path, long limit, std::vector<unsigned char>* out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  gzbuffer(f, 1 << 20);
  out->clear();
  out->reserve(limit >= 0 ? limit : 1 << 22);
  std::vector<unsigned char> chunk(1 << 20);
  int n = 0;
  while (limit < 0 || static_cast<long>(out->size()) < limit) {
    long want = static_cast<long>(chunk.size());
    if (limit >= 0) want = std::min(want, limit - static_cast<long>(out->size()));
    n = gzread(f, chunk.data(), static_cast<unsigned>(want));
    if (n <= 0) break;
    out->insert(out->end(), chunk.data(), chunk.data() + n);
  }
  gzclose(f);
  return n >= 0;
}

template <typename T>
void convert(const unsigned char* src, float* dst, long n, float slope,
             float inter) {
  const T* s = reinterpret_cast<const T*>(src);
  // NIfTI-1: scl_slope of 0 OR NaN means "no scaling" (nibabel and the
  // Python reader in ../nifti.py both skip it); a NaN scl_inter is
  // likewise ignored. Without this a NaN slope would NaN every voxel.
  if (std::isnan(slope)) slope = 0.0f;
  if (std::isnan(inter)) inter = 0.0f;
  if (slope != 0.0f && (slope != 1.0f || inter != 0.0f)) {
    for (long i = 0; i < n; ++i)
      dst[i] = static_cast<float>(s[i]) * slope + inter;
  } else {
    for (long i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
  }
}

// numpy-compatible linear-interpolated quantile of a scratch copy.
float quantile(std::vector<float>* scratch, double q) {
  const long n = static_cast<long>(scratch->size());
  if (n == 0) return 0.0f;
  const double pos = q * (n - 1);
  const long lo = static_cast<long>(pos);
  const long hi = std::min(lo + 1, n - 1);
  std::nth_element(scratch->begin(), scratch->begin() + lo, scratch->end());
  const float vlo = (*scratch)[lo];
  float vhi = vlo;
  if (hi != lo) {
    vhi = *std::min_element(scratch->begin() + lo + 1, scratch->end());
  }
  const double frac = pos - lo;
  return static_cast<float>(vlo + frac * (vhi - vlo));
}

// Decode an inflated file image into a caller-provided float32 buffer
// (C-order of the Fortran file = caller sees Fortran-strided data; Python
// wraps with order='F'). Returns voxel count, or negative on error.
// affine: 12 floats (3 srows), meaningful where *has_sform.
long load_mem(const unsigned char* blob, long size, float* out,
              long capacity, int* dims, float* affine, int* has_sform) {
  if (size < HDR_SIZE) return -1;
  Header h;
  if (!parse_header(blob, &h)) return -2;
  long n = 1;
  const int nd = h.dim[0];
  for (int i = 0; i < 8; ++i) dims[i] = h.dim[i];
  for (int i = 1; i <= nd; ++i) n *= h.dim[i];
  if (n > capacity) return -3;
  const long off = h.vox_offset > 0 ? static_cast<long>(h.vox_offset) : 352;
  const unsigned char* data = blob + off;
  const long avail = size - off;
  const float slope = h.scl_slope, inter = h.scl_inter;

  long need;
  switch (h.datatype) {
    case 2:    need = n * 1; break;  // uint8
    case 256:  need = n * 1; break;  // int8
    case 4:    need = n * 2; break;  // int16
    case 512:  need = n * 2; break;  // uint16
    case 8:    need = n * 4; break;  // int32
    case 768:  need = n * 4; break;  // uint32
    case 16:   need = n * 4; break;  // float32
    case 64:   need = n * 8; break;  // float64
    default:   return -4;
  }
  if (avail < need) return -5;

  switch (h.datatype) {
    case 2:   convert<uint8_t>(data, out, n, slope, inter); break;
    case 256: convert<int8_t>(data, out, n, slope, inter); break;
    case 4:   convert<int16_t>(data, out, n, slope, inter); break;
    case 512: convert<uint16_t>(data, out, n, slope, inter); break;
    case 8:   convert<int32_t>(data, out, n, slope, inter); break;
    case 768: convert<uint32_t>(data, out, n, slope, inter); break;
    case 16:  convert<float>(data, out, n, slope, inter); break;
    case 64:  convert<double>(data, out, n, slope, inter); break;
  }
  *has_sform = h.sform_code > 0 ? 1 : 0;
  std::memcpy(affine, h.srow, 48);
  return n;
}

}  // namespace

extern "C" {

// Probe a file (inflating its header only): returns ndim (>0) and fills
// dims[0..7]; negative on error. Used by Python to size the output buffer.
int fastnifti_probe(const char* path, int* dims) {
  std::vector<unsigned char> blob;
  if (!read_file(path, HDR_SIZE, &blob) || blob.size() < HDR_SIZE) return -1;
  Header h;
  if (!parse_header(blob.data(), &h)) return -2;
  for (int i = 0; i < 8; ++i) dims[i] = h.dim[i];
  return h.dim[0];
}

// load_mem of a file.
long fastnifti_load(const char* path, float* out, long capacity, int* dims,
                    float* affine, int* has_sform) {
  std::vector<unsigned char> blob;
  if (!read_file(path, -1, &blob)) return -1;
  return load_mem(blob.data(), static_cast<long>(blob.size()), out, capacity,
                  dims, affine, has_sform);
}

// In-place quantile clip + min-max normalize
// (clip to [Q(qlo), Q(qhi)], then (x - min) / (max - min)).
void fastnifti_clip_normalize(float* data, long n, double qlo, double qhi) {
  if (n <= 0) return;
  // quantile() only permutes scratch (nth_element/min_element), never
  // changes its multiset — one copy serves both quantile calls.
  std::vector<float> scratch(data, data + n);
  const float lo = quantile(&scratch, qlo);
  const float hi = quantile(&scratch, qhi);
  float mn = 3.4e38f, mx = -3.4e38f;
  for (long i = 0; i < n; ++i) {
    float v = data[i];
    v = v < lo ? lo : (v > hi ? hi : v);
    data[i] = v;
    mn = v < mn ? v : mn;
    mx = v > mx ? v : mx;
  }
  const float range = mx - mn;
  if (range > 0) {
    const float inv = 1.0f / range;
    for (long i = 0; i < n; ++i) data[i] = (data[i] - mn) * inv;
  } else {
    for (long i = 0; i < n; ++i) data[i] = 0.0f;
  }
}

}  // extern "C"
