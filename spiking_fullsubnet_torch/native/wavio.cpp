// Native WAV decode/encode + threaded batch reader for the host input
// pipeline (the port's own copy of spiking_fullsubnet_tpu/native/wavio.cpp).
//
// Role in the port: a training step on the card consumes large batches of
// f32 audio crops; decoding and cropping run on the host CPU, overlapped
// with the device's work. The reference relies on libsndfile through Python
// (soundfile/librosa, audiozen/acoustics/io.py); this is a minimal
// RIFF/WAVE codec (PCM16/24/32 + IEEE float32) with random-access window
// reads (fseek to the crop, never decode the whole file) and a std::thread
// pool that fills a whole training batch in one call.
//
// Exposed as a plain C ABI consumed via ctypes (native/wavio.py). No Python
// headers required, so the build is a single g++ -shared invocation.
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrSeek = -3;
constexpr int kErrRead = -4;
constexpr int kErrWrite = -5;
constexpr int kErrArgs = -6;

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits_per_sample = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0; // byte offset of sample data
  long data_bytes = 0;  // length of the data chunk
  long frames = 0;
};

uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

int parse_header(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return kErrFormat;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return kErrFormat;

  bool have_fmt = false;
  // Walk chunks until the data chunk; tolerate extra chunks (LIST, fact, ...).
  for (;;) {
    unsigned char ch[8];
    if (fread(ch, 1, 8, f) != 8) return kErrFormat;
    uint32_t size = rd_u32(ch + 4);
    if (memcmp(ch, "fmt ", 4) == 0) {
      unsigned char fmt[40];
      uint32_t n = size < sizeof(fmt) ? size : (uint32_t)sizeof(fmt);
      if (fread(fmt, 1, n, f) != n) return kErrFormat;
      if (size > n && fseek(f, (long)(size - n), SEEK_CUR) != 0) return kErrSeek;
      info->format = rd_u16(fmt + 0);
      info->channels = rd_u16(fmt + 2);
      info->sample_rate = rd_u32(fmt + 4);
      info->bits_per_sample = rd_u16(fmt + 14);
      if (info->format == 0xFFFE && size >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: true format lives in the GUID's first u16
        info->format = rd_u16(fmt + 24);
      }
      have_fmt = true;
    } else if (memcmp(ch, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = (long)size;
      break;
    } else {
      if (fseek(f, (long)(size + (size & 1)), SEEK_CUR) != 0) return kErrSeek;
    }
    if (size & 1 && memcmp(ch, "fmt ", 4) == 0) fseek(f, 1, SEEK_CUR);
  }
  if (!have_fmt || info->channels == 0 || info->bits_per_sample == 0)
    return kErrFormat;
  bool pcm_ok = info->format == 1 && (info->bits_per_sample == 16 ||
                                      info->bits_per_sample == 24 ||
                                      info->bits_per_sample == 32 ||
                                      info->bits_per_sample == 8);
  bool flt_ok = info->format == 3 && info->bits_per_sample == 32;
  if (!pcm_ok && !flt_ok) return kErrFormat;
  long frame_bytes = (long)info->channels * (info->bits_per_sample / 8);
  info->frames = info->data_bytes / frame_bytes;
  return 0;
}

// Decode `count` interleaved samples from raw bytes into f32, matching the
// Python path's scaling (dsp/io.py::_to_float / scipy.io.wavfile):
//   PCM16 -> /2^15, PCM24 -> (s<<8)/2^31, PCM32 -> /2^31, u8 -> (x-128)/128.
void decode(const unsigned char* src, float* dst, long count, uint16_t bits,
            uint16_t format) {
  if (format == 3) {  // IEEE float32
    memcpy(dst, src, (size_t)count * 4);
    return;
  }
  switch (bits) {
    case 16: {
      const int16_t* s = (const int16_t*)src;
      for (long i = 0; i < count; ++i) dst[i] = (float)s[i] / 32768.0f;
      break;
    }
    case 24: {
      for (long i = 0; i < count; ++i) {
        const unsigned char* p = src + i * 3;
        int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                              (uint32_t)p[2] << 24);
        dst[i] = (float)v / 2147483648.0f;
      }
      break;
    }
    case 32: {
      const int32_t* s = (const int32_t*)src;
      for (long i = 0; i < count; ++i) dst[i] = (float)s[i] / 2147483648.0f;
      break;
    }
    case 8: {
      for (long i = 0; i < count; ++i)
        dst[i] = ((float)src[i] - 128.0f) / 128.0f;
      break;
    }
  }
}

int read_window(const char* path, long offset_frames, long num_frames,
                float* out, int* sr, int* channels, long* frames_read,
                long* total_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (sr) *sr = (int)info.sample_rate;
  if (channels) *channels = (int)info.channels;
  if (total_frames) *total_frames = info.frames;

  if (offset_frames < 0) offset_frames = 0;
  long avail = info.frames - offset_frames;
  if (avail < 0) avail = 0;
  long want = num_frames < 0 ? avail : (num_frames < avail ? num_frames : avail);
  if (frames_read) *frames_read = want;
  if (want == 0) {
    fclose(f);
    return 0;
  }

  long frame_bytes = (long)info.channels * (info.bits_per_sample / 8);
  if (fseek(f, info.data_offset + offset_frames * frame_bytes, SEEK_SET) != 0) {
    fclose(f);
    return kErrSeek;
  }
  long count = want * info.channels;
  std::vector<unsigned char> raw((size_t)(count * (info.bits_per_sample / 8)));
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return kErrRead;
  }
  fclose(f);
  decode(raw.data(), out, count, info.bits_per_sample, info.format);
  return 0;
}

}  // namespace

extern "C" {

int sfs_wav_info(const char* path, int* sr, long* frames, int* channels,
                 int* bits, int* format) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  WavInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  if (sr) *sr = (int)info.sample_rate;
  if (frames) *frames = info.frames;
  if (channels) *channels = (int)info.channels;
  if (bits) *bits = (int)info.bits_per_sample;
  if (format) *format = (int)info.format;
  return 0;
}

// Read a window of `num_frames` frames starting at `offset_frames` into
// `out` (interleaved f32, caller-allocated num_frames*channels floats;
// tail beyond EOF is left untouched — callers pre-zero for zero-padding).
// num_frames < 0 reads to EOF.
int sfs_wav_read(const char* path, long offset_frames, long num_frames,
                 float* out, int* sr, int* channels, long* frames_read,
                 long* total_frames) {
  return read_window(path, offset_frames, num_frames, out, sr, channels,
                     frames_read, total_frames);
}

// Batched threaded read: n files, per-file frame offsets, one shared window
// length (the training crop). out is [n, num_frames * max_channels] f32,
// pre-zeroed by the caller. Files must share `expect_channels` (1 for the
// speech-enhancement corpora) — mismatches report an error code in rcs[i].
int sfs_wav_read_batch(const char** paths, int n, const long* offsets,
                       long num_frames, int expect_channels, float* out,
                       int num_threads, int* rcs) {
  if (n <= 0 || num_frames < 0 || expect_channels <= 0) return kErrArgs;
  if (num_threads <= 0) num_threads = 1;
  if (num_threads > n) num_threads = n;
  long stride = num_frames * expect_channels;

  auto worker = [&](int start, int step) {
    for (int i = start; i < n; i += step) {
      int sr = 0, ch = 0;
      long got = 0, total = 0;
      int rc = read_window(paths[i], offsets[i], num_frames, out + (long)i * stride,
                           &sr, &ch, &got, &total);
      if (rc == 0 && ch != expect_channels) rc = kErrFormat;
      rcs[i] = rc;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve((size_t)num_threads);
  for (int t = 0; t < num_threads; ++t) pool.emplace_back(worker, t, num_threads);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

// Write interleaved samples as PCM16 (the tools' output format) or IEEE
// float32 when `as_float` != 0.
int sfs_wav_write(const char* path, const float* data, long frames,
                  int channels, int sr, int as_float) {
  if (frames < 0 || channels <= 0 || sr <= 0) return kErrArgs;
  FILE* f = fopen(path, "wb");
  if (!f) return kErrOpen;
  long count = frames * channels;
  uint16_t bits = as_float ? 32 : 16;
  uint16_t fmt = as_float ? 3 : 1;
  uint32_t data_bytes = (uint32_t)(count * (bits / 8));
  uint32_t byte_rate = (uint32_t)sr * channels * (bits / 8);
  uint16_t block_align = (uint16_t)(channels * (bits / 8));

  unsigned char hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(hdr + 16, &fmt_size, 4);
  memcpy(hdr + 20, &fmt, 2);
  uint16_t ch16 = (uint16_t)channels;
  memcpy(hdr + 22, &ch16, 2);
  uint32_t sr32 = (uint32_t)sr;
  memcpy(hdr + 24, &sr32, 4);
  memcpy(hdr + 28, &byte_rate, 4);
  memcpy(hdr + 32, &block_align, 2);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  memcpy(hdr + 40, &data_bytes, 4);
  if (fwrite(hdr, 1, 44, f) != 44) {
    fclose(f);
    return kErrWrite;
  }

  int rc = 0;
  if (as_float) {
    if (fwrite(data, 4, (size_t)count, f) != (size_t)count) rc = kErrWrite;
  } else {
    std::vector<int16_t> buf((size_t)count);
    for (long i = 0; i < count; ++i) {
      float v = data[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      float s = v * 32767.0f;
      buf[(size_t)i] = (int16_t)(s >= 0.0f ? s + 0.5f : s - 0.5f);
    }
    if (fwrite(buf.data(), 2, (size_t)count, f) != (size_t)count) rc = kErrWrite;
  }
  fclose(f);
  return rc;
}

}  // extern "C"
