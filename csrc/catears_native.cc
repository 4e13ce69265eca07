// Native runtime components for catears_tpu.
//
// The reference implements its entire runtime in C++; here the device compute
// path is JAX/XLA, and the host-side runtime pieces that benefit from native
// code live in this library, called via ctypes:
//
//   - RIFF/WAVE header parsing + PCM byte->float conversion
//   - multi-threaded batch WAV loader (the data-loading path for batched
//     decoding of .scp lists)
//   - OpenFST ConstFst binary parsing into flat arrays
//   - backpointer-trace backtrace (transcript assembly)
//   - Levenshtein distance (WER/CER scoring hot loop)
//
// Exported with a plain C ABI; every entry returns 0 on success and a
// negative error code otherwise.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- wav ----

// Parses a canonical 44-byte RIFF/WAVE header (PCM, subchunk1 size 16).
// Returns 0 and fills num_channels/sample_rate/bits_per_sample on success.
int ce_parse_wav_header(const uint8_t *data, int64_t size,
                        int32_t *num_channels, int32_t *sample_rate,
                        int32_t *bits_per_sample, int64_t *data_offset) {
  if (size < 44) return -1;
  if (memcmp(data, "RIFF", 4) != 0) return -2;
  if (memcmp(data + 8, "WAVE", 4) != 0) return -3;
  if (memcmp(data + 12, "fmt ", 4) != 0) return -4;
  int32_t subchunk1_size;
  memcpy(&subchunk1_size, data + 16, 4);
  if (subchunk1_size != 16) return -5;
  int16_t audio_format;
  memcpy(&audio_format, data + 20, 2);
  if (audio_format != 1) return -6;
  int16_t channels, bits, block_align;
  int32_t rate, bytes_rate;
  memcpy(&channels, data + 22, 2);
  memcpy(&rate, data + 24, 4);
  memcpy(&bytes_rate, data + 28, 4);
  memcpy(&block_align, data + 32, 2);
  memcpy(&bits, data + 34, 2);
  if (bytes_rate != rate * bits / 8) return -7;
  if (block_align != bits / 8) return -8;
  if (memcmp(data + 36, "data", 4) != 0) return -9;
  *num_channels = channels;
  *sample_rate = rate;
  *bits_per_sample = bits;
  *data_offset = 44;
  return 0;
}

// Converts PCM payload bytes to float32 (raw integer amplitudes).
int ce_pcm_to_float(const uint8_t *data, int64_t size,
                    int32_t bits_per_sample, float *out,
                    int64_t *num_samples) {
  int bytes = bits_per_sample / 8;
  if (bytes != 1 && bytes != 2 && bytes != 4) return -1;
  int64_t n = size / bytes;
  switch (bytes) {
    case 1: {
      const int8_t *p = reinterpret_cast<const int8_t *>(data);
      for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(p[i]);
      break;
    }
    case 2: {
      const int16_t *p = reinterpret_cast<const int16_t *>(data);
      for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(p[i]);
      break;
    }
    case 4: {
      const int32_t *p = reinterpret_cast<const int32_t *>(data);
      for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(p[i]);
      break;
    }
  }
  *num_samples = n;
  return 0;
}

// Threaded batch loader: reads `count` wav files, converts each payload to
// float32 into out + offsets[i] (caller sizes the buffer from st_size).
// lengths[i] receives the sample count, or a negative error code.
int ce_load_wav_batch(const char **paths, int32_t count, float *out,
                      const int64_t *offsets, int64_t *lengths,
                      int32_t num_threads) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  if (num_threads <= 0) num_threads = 4;
  std::vector<std::thread> workers;
  auto load_one = [&](int32_t i) {
    FILE *fd = fopen(paths[i], "rb");
    if (!fd) {
      lengths[i] = -1;
      return;
    }
    fseek(fd, 0, SEEK_END);
    int64_t size = ftell(fd);
    fseek(fd, 0, SEEK_SET);
    std::vector<uint8_t> buf(size);
    if (fread(buf.data(), 1, size, fd) != static_cast<size_t>(size)) {
      fclose(fd);
      lengths[i] = -2;
      return;
    }
    fclose(fd);
    int32_t ch, rate, bits;
    int64_t off;
    int rc = ce_parse_wav_header(buf.data(), size, &ch, &rate, &bits, &off);
    if (rc != 0) {
      lengths[i] = -100 + rc;
      return;
    }
    int64_t n;
    ce_pcm_to_float(buf.data() + off, size - off, bits, out + offsets[i], &n);
    lengths[i] = n;
  };
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= count) return;
      load_one(i);
    }
  };
  for (int t = 0; t < num_threads && t < count; ++t)
    workers.emplace_back(worker);
  for (auto &w : workers) w.join();
  return 0;
}

// ----------------------------------------------------------- constfst ----

// Parses an OpenFST ConstFst<StdArc> image.  Two-phase: call with
// arcs_out == nullptr to get counts, then with buffers allocated.
// states_out: [S, 2] f32-bits final weight + u32 narcs is split into
// final_out f32[S] and pos/narcs via arc arrays sorted by state already.
int ce_parse_const_fst(const uint8_t *data, int64_t size, int64_t *start,
                       int64_t *num_states, int64_t *num_arcs,
                       float *final_out, int64_t *arc_pos_out,
                       int32_t *arc_count_out, int32_t *arcs_out /*[A,4]*/) {
  const uint8_t *p = data;
  const uint8_t *end = data + size;
  auto read_i32 = [&](int32_t *v) -> bool {
    if (p + 4 > end) return false;
    memcpy(v, p, 4);
    p += 4;
    return true;
  };
  auto read_i64 = [&](int64_t *v) -> bool {
    if (p + 8 > end) return false;
    memcpy(v, p, 8);
    p += 8;
    return true;
  };
  auto read_string = [&](std::string *s) -> bool {
    int32_t n;
    if (!read_i32(&n) || n < 0 || p + n > end) return false;
    s->assign(reinterpret_cast<const char *>(p), n);
    p += n;
    return true;
  };
  int32_t magic;
  if (!read_i32(&magic) || magic != 2125659606) return -1;
  std::string fsttype, arctype;
  if (!read_string(&fsttype) || fsttype != "const") return -2;
  if (!read_string(&arctype) || arctype != "standard") return -3;
  int32_t version, flags;
  if (!read_i32(&version) || !read_i32(&flags)) return -4;
  uint64_t properties;
  if (p + 8 > end) return -4;
  memcpy(&properties, p, 8);
  p += 8;
  int64_t st, ns, na;
  if (!read_i64(&st) || !read_i64(&ns) || !read_i64(&na)) return -5;
  auto skip_symbols = [&]() -> bool {
    int32_t sym_magic;
    if (!read_i32(&sym_magic) || sym_magic != 2125658996) return false;
    std::string name;
    if (!read_string(&name)) return false;
    int64_t avail, count;
    if (!read_i64(&avail) || !read_i64(&count)) return false;
    for (int64_t i = 0; i < count; ++i) {
      std::string sym;
      int64_t key;
      if (!read_string(&sym) || !read_i64(&key)) return false;
    }
    return true;
  };
  if ((flags & 0x1) && !skip_symbols()) return -6;
  if ((flags & 0x2) && !skip_symbols()) return -6;
  bool aligned = (version == 1) || (flags & 0x4);
  auto align16 = [&]() {
    int64_t off = p - data;
    p += (16 - (off % 16)) % 16;
  };
  *start = st;
  *num_states = ns;
  *num_arcs = na;
  if (arcs_out == nullptr) return 0;  // size query only
  if (aligned) align16();
  // ConstState: f32 weight, u32 pos, u32 narcs, u32 nieps, u32 noeps
  if (p + ns * 20 > end) return -7;
  for (int64_t s = 0; s < ns; ++s) {
    memcpy(&final_out[s], p, 4);
    uint32_t pos, narcs;
    memcpy(&pos, p + 4, 4);
    memcpy(&narcs, p + 8, 4);
    arc_pos_out[s] = pos;
    arc_count_out[s] = narcs;
    p += 20;
  }
  if (aligned) align16();
  // StdArc: i32 ilabel, i32 olabel, f32 weight, i32 nextstate
  if (p + na * 16 > end) return -8;
  memcpy(arcs_out, p, na * 16);
  return 0;
}

// ----------------------------------------------------------- backtrace ----

// Walks compact traces backwards: prev_slot [T, K], words [T, K, W].
// Emits the transcript (forward order) into out; returns word count.
int ce_backtrace(const int32_t *prev_slot, const int32_t *words, int32_t t,
                 int32_t k, int32_t w, int32_t start_slot, int32_t *out,
                 int32_t max_out) {
  std::vector<int32_t> rev;
  int32_t slot = start_slot;
  for (int32_t f = t - 1; f >= 0 && slot >= 0; --f) {
    const int32_t *row = words + (static_cast<int64_t>(f) * k + slot) * w;
    for (int32_t i = 0; i < w; ++i) {
      if (row[i] > 0) rev.push_back(row[i]);
    }
    slot = prev_slot[static_cast<int64_t>(f) * k + slot];
  }
  int32_t n = static_cast<int32_t>(rev.size());
  if (n > max_out) return -1;
  for (int32_t i = 0; i < n; ++i) out[i] = rev[n - 1 - i];
  return n;
}

// ------------------------------------------------------------- scoring ----

// Levenshtein distance between two int32 token sequences.
int ce_edit_distance(const int32_t *ref, int32_t n, const int32_t *hyp,
                     int32_t m) {
  std::vector<int32_t> prev(m + 1), cur(m + 1);
  for (int32_t j = 0; j <= m; ++j) prev[j] = j;
  for (int32_t i = 1; i <= n; ++i) {
    cur[0] = i;
    for (int32_t j = 1; j <= m; ++j) {
      int32_t sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1] ? 1 : 0);
      int32_t del = prev[j] + 1;
      int32_t ins = cur[j - 1] + 1;
      cur[j] = sub < del ? (sub < ins ? sub : ins) : (del < ins ? del : ins);
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"
