// FLAC decoder (native data-loader backend).
//
// The port's copy of native/flac_decoder.cpp, built with the host compiler
// at first use by reconvat_tpu_torch/kernels/_build.py.
//
// The reference loads flac corpora through libsndfile (SoundFile wheel,
// reference model/dataset.py:110). Neither is available in this image, so
// this is a from-scratch decoder for the FLAC bitstream format
// (https://xiph.org/flac/format.html): STREAMINFO metadata, frame headers
// with UTF-8 coded numbers, constant/verbatim/fixed/LPC subframes, Rice
// residual partitions, wasted bits, and stereo decorrelation.
//
// Exposed C ABI (ctypes):
//   long long flac_decode_file(const char* path, int16_t** out,
//                              int* sample_rate, int* channels);
//     returns number of frames (samples per channel), interleaved output;
//     negative on error. Caller frees with flac_free().
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size)
      : data_(data), size_(size), pos_(0), bit_(0) {}

  bool eof() const { return pos_ >= size_; }
  size_t byte_pos() const { return pos_; }

  void align() {
    if (bit_ != 0) {
      bit_ = 0;
      ++pos_;
    }
  }

  // read up to 32 bits, MSB first
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) {
      v <<= 1;
      if (pos_ < size_) {
        v |= (data_[pos_] >> (7 - bit_)) & 1;
        if (++bit_ == 8) {
          bit_ = 0;
          ++pos_;
        }
      } else {
        ok_ = false;
      }
    }
    return v;
  }

  uint64_t read64(int nbits) {
    uint64_t v = 0;
    while (nbits > 32) {
      v = (v << 32) | read(32);
      nbits -= 32;
    }
    return (v << nbits) | read(nbits);
  }

  int32_t read_signed(int nbits) {
    uint32_t v = read(nbits);
    if (nbits == 0) return 0;
    if (v & (1u << (nbits - 1))) {
      return (int32_t)(v | (~0u << nbits));
    }
    return (int32_t)v;
  }

  // unary-coded value: count of 0 bits before the terminating 1
  uint32_t read_unary() {
    uint32_t n = 0;
    while (ok_ && !eof()) {
      if (read(1)) return n;
      ++n;
      if (n > 1u << 24) {  // corrupt stream guard
        ok_ = false;
        break;
      }
    }
    ok_ = false;
    return n;
  }

  int32_t read_rice(int param) {
    uint32_t q = read_unary();
    uint32_t r = param ? read(param) : 0;
    uint32_t v = (q << param) | r;
    // zigzag decode
    return (v >> 1) ^ -(int32_t)(v & 1);
  }

  bool ok() const { return ok_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_;
  int bit_;
  bool ok_ = true;
};

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bits_per_sample = 0;
  uint64_t total_samples = 0;
};

// frame-header UTF-8 style coded number (up to 36 bits)
bool read_utf8_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.read(8);
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0) == 0xC0) {
    extra = 1;
    v = b0 & 0x1F;
  } else if ((b0 & 0xF0) == 0xE0) {
    extra = 2;
    v = b0 & 0x0F;
  } else if ((b0 & 0xF8) == 0xF0) {
    extra = 3;
    v = b0 & 0x07;
  } else if ((b0 & 0xFC) == 0xF8) {
    extra = 4;
    v = b0 & 0x03;
  } else if ((b0 & 0xFE) == 0xFC) {
    extra = 5;
    v = b0 & 0x01;
  } else if (b0 == 0xFE) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = br.read(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

const int kFixedOrders[5][4] = {
    {},               // order 0: e = x
    {1},              // e[i] = x[i] - x[i-1]
    {2, -1},          // e[i] = x[i] - 2x[i-1] + x[i-2]
    {3, -3, 1},       // ...
    {4, -6, 4, -1},
};

bool decode_residual(BitReader& br, int order, uint32_t block_size,
                     std::vector<int64_t>* res) {
  uint32_t method = br.read(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t porder = br.read(4);
  uint32_t nparts = 1u << porder;
  if (block_size % nparts != 0) return false;
  uint32_t part_len = block_size >> porder;
  if (part_len <= (uint32_t)order && porder == 0) return false;

  res->resize(block_size - order);
  size_t idx = 0;
  for (uint32_t p = 0; p < nparts; ++p) {
    uint32_t count = part_len - (p == 0 ? order : 0);
    uint32_t param = br.read(plen);
    if (param == escape) {
      int nbits = br.read(5);
      for (uint32_t i = 0; i < count; ++i)
        (*res)[idx++] = nbits ? br.read_signed(nbits) : 0;
    } else {
      for (uint32_t i = 0; i < count; ++i)
        (*res)[idx++] = br.read_rice((int)param);
    }
    if (!br.ok()) return false;
  }
  return idx == res->size();
}

bool decode_subframe(BitReader& br, uint32_t block_size, int bps,
                     std::vector<int64_t>* out) {
  if (br.read(1) != 0) return false;  // reserved pad bit
  uint32_t type = br.read(6);
  int wasted = 0;
  if (br.read(1)) {  // wasted bits flag: unary count-1
    wasted = 1 + (int)br.read_unary();
  }
  bps -= wasted;

  out->assign(block_size, 0);
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (uint32_t i = 0; i < block_size; ++i) (*out)[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i)
      (*out)[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0..4
    int order = type - 8;
    for (int i = 0; i < order; ++i) (*out)[i] = br.read_signed(bps);
    std::vector<int64_t> res;
    if (!decode_residual(br, order, block_size, &res)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (int64_t)kFixedOrders[order][j] * (*out)[i - 1 - j];
      (*out)[i] = res[i - order] + pred;
    }
  } else if (type >= 32) {  // LPC order 1..32
    int order = (int)(type - 31);
    for (int i = 0; i < order; ++i) (*out)[i] = br.read_signed(bps);
    int precision = (int)br.read(4) + 1;
    if (precision == 16) return false;  // 0b1111 invalid
    int shift = br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    if (!decode_residual(br, order, block_size, &res)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * (*out)[i - 1 - j];
      (*out)[i] = res[i - order] + (pred >> shift);
    }
  } else {
    return false;
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i) (*out)[i] <<= wasted;
  }
  return br.ok();
}

const uint32_t kBlockSizes[16] = {0,   192, 576,  1152, 2304, 4608, 0, 0,
                                  256, 512, 1024, 2048, 4096, 8192,
                                  16384, 32768};
const uint32_t kSampleRates[12] = {0,     88200, 176400, 192000,
                                   8000,  16000, 22050,  24000,
                                   32000, 44100, 48000,  96000};

}  // namespace

extern "C" {

long long flac_decode_file(const char* path, int16_t** out_samples,
                           int* out_sample_rate, int* out_channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(fsize);
  if (fread(data.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return -2;
  }
  fclose(f);

  if (fsize < 8 || memcmp(data.data(), "fLaC", 4) != 0) return -3;

  // metadata blocks
  StreamInfo info;
  size_t pos = 4;
  bool last = false;
  bool have_info = false;
  while (!last && pos + 4 <= (size_t)fsize) {
    uint8_t header = data[pos];
    last = header & 0x80;
    uint8_t type = header & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) |
                   data[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      BitReader br(data.data() + pos, len);
      br.read(16);  // min block size
      br.read(16);  // max block size
      br.read(24);  // min frame size
      br.read(24);  // max frame size
      info.sample_rate = br.read(20);
      info.channels = br.read(3) + 1;
      info.bits_per_sample = br.read(5) + 1;
      info.total_samples = br.read64(36);
      have_info = true;
    }
    pos += len;
  }
  if (!have_info || info.channels == 0 || info.channels > 8) return -4;

  std::vector<int16_t> pcm;
  if (info.total_samples)
    pcm.reserve((size_t)info.total_samples * info.channels);

  BitReader br(data.data() + pos, fsize - pos);
  std::vector<std::vector<int64_t>> chans(info.channels);

  while (true) {
    br.align();
    if (br.eof()) break;
    // frame sync 0b11111111111110..
    uint32_t sync = br.read(14);
    if (br.eof()) break;
    if (sync != 0x3FFE) return -5;
    br.read(1);                       // reserved
    br.read(1);                       // blocking strategy
    uint32_t bs_code = br.read(4);
    uint32_t sr_code = br.read(4);
    uint32_t ch_code = br.read(4);
    uint32_t ss_code = br.read(3);
    br.read(1);                       // reserved
    uint64_t frame_number;
    if (!read_utf8_number(br, &frame_number)) return -6;

    uint32_t block_size;
    if (bs_code == 6)
      block_size = br.read(8) + 1;
    else if (bs_code == 7)
      block_size = br.read(16) + 1;
    else
      block_size = kBlockSizes[bs_code];
    if (block_size == 0) return -7;

    if (sr_code == 12)
      br.read(8);
    else if (sr_code == 13 || sr_code == 14)
      br.read(16);
    else if (sr_code == 15)
      return -8;

    br.read(8);  // CRC-8 (not verified)

    int bps = (int)info.bits_per_sample;
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      default: break;
    }

    uint32_t nch;
    int mode;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code < 8) {
      nch = ch_code + 1;
      mode = 0;
    } else if (ch_code == 8) {
      nch = 2;
      mode = 1;
    } else if (ch_code == 9) {
      nch = 2;
      mode = 2;
    } else if (ch_code == 10) {
      nch = 2;
      mode = 3;
    } else {
      return -9;
    }
    if (nch != info.channels) return -10;

    for (uint32_t c = 0; c < nch; ++c) {
      int sub_bps = bps;
      // the side channel carries one extra bit
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
          (mode == 3 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, &chans[c])) return -11;
    }
    br.align();
    br.read(16);  // CRC-16 (not verified)
    if (!br.ok()) return -12;

    // stereo decorrelation
    if (mode == 1) {  // left/side: right = left - side
      for (uint32_t i = 0; i < block_size; ++i)
        chans[1][i] = chans[0][i] - chans[1][i];
    } else if (mode == 2) {  // right/side: left = side + right
      for (uint32_t i = 0; i < block_size; ++i)
        chans[0][i] = chans[0][i] + chans[1][i];
    } else if (mode == 3) {  // mid/side
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t side = chans[1][i];
        int64_t mid = (chans[0][i] << 1) | (side & 1);
        chans[0][i] = (mid + side) >> 1;
        chans[1][i] = (mid - side) >> 1;
      }
    }

    int shift = bps - 16;  // convert to int16
    for (uint32_t i = 0; i < block_size; ++i) {
      for (uint32_t c = 0; c < info.channels; ++c) {
        int64_t v = chans[c][i];
        if (shift > 0)
          v >>= shift;
        else if (shift < 0)
          v <<= -shift;
        if (v > 32767) v = 32767;
        if (v < -32768) v = -32768;
        pcm.push_back((int16_t)v);
      }
    }
    if (info.total_samples &&
        pcm.size() >= info.total_samples * info.channels)
      break;
  }

  long long n_frames = (long long)(pcm.size() / info.channels);
  if (info.total_samples && (uint64_t)n_frames > info.total_samples) {
    n_frames = (long long)info.total_samples;  // trim block padding
  }
  int16_t* out = (int16_t*)malloc(n_frames * info.channels * sizeof(int16_t));
  if (!out) return -13;
  memcpy(out, pcm.data(), n_frames * info.channels * sizeof(int16_t));
  *out_samples = out;
  *out_sample_rate = (int)info.sample_rate;
  *out_channels = (int)info.channels;
  return n_frames;
}

void flac_free(int16_t* p) { free(p); }

}  // extern "C"
