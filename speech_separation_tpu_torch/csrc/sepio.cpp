// sepio — native data-loading runtime for speech_separation_tpu_torch (the
// port's own copy of native/sepio.cpp, built by ops/_build.py with g++).
//
// The reference delegates all I/O to Python (np.load / librosa.load inside
// the DataLoader worker, archs/uPIT.py:66-73, steps/extract_feats.py:74).
// The input pipeline competes with the training step's own host work for the
// CPU, so the hot loaders live here:
//
//   - a minimal npz (ZIP + DEFLATE + npy) reader that decompresses a member
//     and writes it TRANSPOSED directly into the caller's padded batch
//     buffer (the (freq, time) -> (time, freq) flip plus zero-padding that
//     the Python pipeline would otherwise do with two extra copies);
//   - magnitude mode for complex64 members (test features store the complex
//     mixture spectrum; inference consumes |mix|);
//   - a PCM16/PCM32/float32 WAV decoder with librosa-style normalization.
//
// Zero third-party dependencies beyond zlib. Exposed as a plain C ABI for
// ctypes (speech_separation_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
  bool ok = false;
};

Buffer read_file(const char* path) {
  Buffer b;
  FILE* f = std::fopen(path, "rb");
  if (!f) return b;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  b.data.resize(static_cast<size_t>(n));
  b.ok = (std::fread(b.data.data(), 1, b.data.size(), f) == b.data.size());
  std::fclose(f);
  return b;
}

uint16_t rd16(const uint8_t* p) { uint16_t v; std::memcpy(&v, p, 2); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

struct ZipMember {
  std::string name;
  uint32_t comp_size = 0;
  uint32_t uncomp_size = 0;
  uint16_t method = 0;   // 0 = stored, 8 = deflate
  uint32_t local_off = 0;
};

// Parse the central directory (local headers may carry zero sizes when the
// writer streamed with data descriptors — numpy's savez does).
bool zip_members(const Buffer& buf, std::vector<ZipMember>* out) {
  const auto& d = buf.data;
  if (d.size() < 22) return false;
  // find EOCD (PK\x05\x06) scanning backwards over the comment area
  size_t eocd = std::string::npos;
  size_t start = d.size() >= (1 << 16) + 22 ? d.size() - ((1 << 16) + 22) : 0;
  for (size_t i = d.size() - 22 + 1; i-- > start;) {
    if (d[i] == 0x50 && d[i + 1] == 0x4b && d[i + 2] == 0x05 && d[i + 3] == 0x06) {
      eocd = i;
      break;
    }
  }
  if (eocd == std::string::npos) return false;
  uint16_t n_entries = rd16(&d[eocd + 10]);
  uint32_t cd_off = rd32(&d[eocd + 16]);
  size_t p = cd_off;
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (p + 46 > d.size() || rd32(&d[p]) != 0x02014b50) return false;
    ZipMember m;
    m.method = rd16(&d[p + 10]);
    m.comp_size = rd32(&d[p + 20]);
    m.uncomp_size = rd32(&d[p + 24]);
    uint16_t name_len = rd16(&d[p + 28]);
    uint16_t extra_len = rd16(&d[p + 30]);
    uint16_t comment_len = rd16(&d[p + 32]);
    m.local_off = rd32(&d[p + 42]);
    m.name.assign(reinterpret_cast<const char*>(&d[p + 46]), name_len);
    out->push_back(std::move(m));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Inflate (or copy) a member's payload.
bool zip_extract(const Buffer& buf, const ZipMember& m, std::vector<uint8_t>* out) {
  const auto& d = buf.data;
  size_t p = m.local_off;
  if (p + 30 > d.size() || rd32(&d[p]) != 0x04034b50) return false;
  uint16_t name_len = rd16(&d[p + 26]);
  uint16_t extra_len = rd16(&d[p + 28]);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + m.comp_size > d.size()) return false;
  out->resize(m.uncomp_size);
  if (m.method == 0) {
    if (m.comp_size != m.uncomp_size) return false;
    std::memcpy(out->data(), &d[data_off], m.uncomp_size);
    return true;
  }
  if (m.method != 8) return false;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<uint8_t*>(&d[data_off]);
  zs.avail_in = m.comp_size;
  zs.next_out = out->data();
  zs.avail_out = m.uncomp_size;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == m.uncomp_size;
}

// Parse an npy payload: returns dtype string, shape, and data pointer.
struct NpyInfo {
  std::string descr;
  bool fortran = false;
  long shape[4] = {0, 0, 0, 0};
  int ndim = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
};

bool parse_npy(const std::vector<uint8_t>& raw, NpyInfo* info) {
  if (raw.size() < 10 || std::memcmp(raw.data(), "\x93NUMPY", 6) != 0) return false;
  uint8_t major = raw[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(&raw[8]);
    hoff = 10;
  } else {
    hlen = rd32(&raw[8]);
    hoff = 12;
  }
  if (hoff + hlen > raw.size()) return false;
  std::string header(reinterpret_cast<const char*>(&raw[hoff]), hlen);

  auto find_value = [&](const char* key) -> std::string {
    size_t k = header.find(key);
    if (k == std::string::npos) return "";
    size_t c = header.find(':', k);
    size_t e = header.find_first_of(",}", c);
    // tuples contain commas; handle 'shape' separately
    return header.substr(c + 1, e - c - 1);
  };

  size_t dq = header.find("'descr':");
  if (dq == std::string::npos) return false;
  size_t q1 = header.find('\'', dq + 8);
  size_t q2 = header.find('\'', q1 + 1);
  info->descr = header.substr(q1 + 1, q2 - q1 - 1);

  info->fortran = find_value("'fortran_order'").find("True") != std::string::npos;

  size_t sk = header.find("'shape':");
  size_t p1 = header.find('(', sk);
  size_t p2 = header.find(')', p1);
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  info->ndim = 0;
  const char* s = shape_s.c_str();
  while (*s && info->ndim < 4) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    info->shape[info->ndim++] = std::strtol(s, const_cast<char**>(&s), 10);
  }
  info->data = raw.data() + hoff + hlen;
  info->data_len = raw.size() - hoff - hlen;
  return true;
}

}  // namespace

extern "C" {

// Load npz member `member` (a 2-D array stored (rows_in, cols_in)) into
// `out`, TRANSPOSED, as float32 row-major (out_rows, out_cols) with zero
// padding: out[t, f] = value[f, t].
//
// mode 0: member must be float32 ('<f4') — copied transposed.
// mode 1: member may be float32 or complex64 ('<c8') — magnitude, transposed.
// mode 2: member must be complex64 — real/imag planes written to out
//         (re) and out2 (im), both transposed.
//
// Returns 0 on success and writes the source dims to *true_rows (= cols_in,
// the time axis after transpose) / *true_cols. Negative error codes:
// -1 file, -2 zip, -3 member missing, -4 inflate, -5 npy parse,
// -6 dtype/shape mismatch, -7 output too small.
int sepio_load_npz_2d_transposed(const char* path, const char* member,
                                 int mode, float* out, float* out2,
                                 long out_rows, long out_cols,
                                 long* true_rows, long* true_cols) {
  Buffer buf = read_file(path);
  if (!buf.ok) return -1;
  std::vector<ZipMember> members;
  if (!zip_members(buf, &members)) return -2;
  std::string want = std::string(member) + ".npy";
  const ZipMember* m = nullptr;
  for (const auto& c : members)
    if (c.name == want) { m = &c; break; }
  if (!m) return -3;
  std::vector<uint8_t> raw;
  if (!zip_extract(buf, *m, &raw)) return -4;
  NpyInfo info;
  if (!parse_npy(raw, &info)) return -5;
  if (info.ndim != 2) return -6;
  long rows_in = info.shape[0], cols_in = info.shape[1];
  *true_rows = cols_in;
  *true_cols = rows_in;
  if (cols_in > out_rows || rows_in > out_cols) return -7;

  bool is_c8 = info.descr == "<c8";
  bool is_f4 = info.descr == "<f4";
  if (mode == 0 && !is_f4) return -6;
  if (mode == 2 && !is_c8) return -6;
  if (!is_f4 && !is_c8) return -6;
  size_t itemsize = is_c8 ? 8 : 4;
  if (info.data_len < itemsize * rows_in * cols_in) return -6;
  const float* src = reinterpret_cast<const float*>(info.data);

  // fortran-ordered (rows_in, cols_in) is laid out exactly like a C-order
  // (cols_in, rows_in) array — i.e. already transposed: plain row copies.
  if (info.fortran) {
    for (long c = 0; c < cols_in; ++c) {
      if (is_c8) {
        const float* col = src + 2 * c * rows_in;
        if (mode == 1) {
          for (long r = 0; r < rows_in; ++r) {
            float re = col[2 * r], im = col[2 * r + 1];
            out[c * out_cols + r] = std::sqrt(re * re + im * im);
          }
        } else {
          for (long r = 0; r < rows_in; ++r) {
            out[c * out_cols + r] = col[2 * r];
            out2[c * out_cols + r] = col[2 * r + 1];
          }
        }
      } else {
        std::memcpy(out + c * out_cols, src + c * rows_in,
                    sizeof(float) * rows_in);
      }
    }
    return 0;
  }

  // out is (out_rows, out_cols) zeroed by the caller; write transposed
  for (long r = 0; r < rows_in; ++r) {
    if (is_c8) {
      const float* row = src + 2 * r * cols_in;
      if (mode == 1) {
        for (long c = 0; c < cols_in; ++c) {
          float re = row[2 * c], im = row[2 * c + 1];
          out[c * out_cols + r] = std::sqrt(re * re + im * im);
        }
      } else {  // mode 2
        for (long c = 0; c < cols_in; ++c) {
          out[c * out_cols + r] = row[2 * c];
          out2[c * out_cols + r] = row[2 * c + 1];
        }
      }
    } else {
      const float* row = src + r * cols_in;
      for (long c = 0; c < cols_in; ++c)
        out[c * out_cols + r] = row[c];
    }
  }
  return 0;
}

// List the member names of an npz as a newline-joined string written into
// `out` (capacity `cap`, truncated if needed). Returns the member count,
// or a negative error code.
int sepio_npz_members(const char* path, char* out, long cap) {
  Buffer buf = read_file(path);
  if (!buf.ok) return -1;
  std::vector<ZipMember> members;
  if (!zip_members(buf, &members)) return -2;
  long pos = 0;
  for (const auto& m : members) {
    std::string name = m.name;
    if (name.size() > 4 && name.compare(name.size() - 4, 4, ".npy") == 0)
      name.resize(name.size() - 4);
    if (pos + static_cast<long>(name.size()) + 1 < cap) {
      std::memcpy(out + pos, name.data(), name.size());
      pos += name.size();
      out[pos++] = '\n';
    }
  }
  if (pos < cap) out[pos] = '\0';
  return static_cast<int>(members.size());
}

// Decode a wav file to float32 (librosa normalization: int16/32768,
// int32/2^31, float passthrough; multi-channel averaged to mono).
// Two-phase: call with out == nullptr to get the frame count.
// Returns frames on success, negative error code otherwise.
long sepio_read_wav_f32(const char* path, float* out, long cap,
                        int* sample_rate) {
  Buffer buf = read_file(path);
  if (!buf.ok) return -1;
  const auto& d = buf.data;
  if (d.size() < 44 || std::memcmp(d.data(), "RIFF", 4) != 0 ||
      std::memcmp(&d[8], "WAVE", 4) != 0)
    return -2;
  size_t p = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  uint32_t pcm_len = 0;
  while (p + 8 <= d.size()) {
    uint32_t chunk_len = rd32(&d[p + 4]);
    if (std::memcmp(&d[p], "fmt ", 4) == 0 && p + 8 + 16 <= d.size()) {
      fmt = rd16(&d[p + 8]);
      channels = rd16(&d[p + 10]);
      rate = rd32(&d[p + 12]);
      bits = rd16(&d[p + 22]);
    } else if (std::memcmp(&d[p], "data", 4) == 0) {
      pcm = &d[p + 8];
      pcm_len = chunk_len;
      if (p + 8 + pcm_len > d.size()) pcm_len = d.size() - p - 8;
      break;
    }
    p += 8 + chunk_len + (chunk_len & 1);
  }
  if (!pcm || channels == 0) return -3;
  if (sample_rate) *sample_rate = static_cast<int>(rate);
  long frames = pcm_len / (channels * (bits / 8));
  if (!out) return frames;
  if (frames > cap) frames = cap;

  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int ch = 0; ch < channels; ++ch) {
      long idx = i * channels + ch;
      if (fmt == 1 && bits == 16) {
        int16_t v;
        std::memcpy(&v, pcm + 2 * idx, 2);
        acc += v / 32768.0;
      } else if (fmt == 1 && bits == 32) {
        int32_t v;
        std::memcpy(&v, pcm + 4 * idx, 4);
        acc += v / 2147483648.0;
      } else if (fmt == 3 && bits == 32) {
        float v;
        std::memcpy(&v, pcm + 4 * idx, 4);
        acc += v;
      } else {
        return -4;
      }
    }
    out[i] = static_cast<float>(acc / channels);
  }
  return frames;
}

}  // extern "C"
