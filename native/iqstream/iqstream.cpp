// iqstream — native IQ sample ingest for the GNSS tracking framework.
//
// The reference generates synthetic signals on-device and has no IO path at
// all (SURVEY.md §1: no data loader anywhere in /root/reference/src). A
// production receiver front-end, however, delivers interleaved fixed-point
// IQ at tens of MS/s; decoding and de-interleaving that stream in Python is
// orders of magnitude too slow to feed the correlator. This library is the
// framework's native data-loader: it decodes front-end sample formats
// (interleaved int8 / int16 / float32 complex) into the structure-of-arrays
// float32 planes the kernels consume (the SoA layout decision of
// /root/reference/src/gen_signal.jl:181-184, kept here), with a lock-free
// single-producer/single-consumer ring buffer for real-time streaming.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Block decoding: interleaved complex -> SoA float planes
// ---------------------------------------------------------------------------

// Formats: 0 = int8, 1 = int16, 2 = float32 (all interleaved I,Q,I,Q,...)
int iq_decode(const void* src, int format, int64_t num_samples, float scale,
              float* out_re, float* out_im) {
  if (!src || !out_re || !out_im || num_samples < 0) return -1;
  switch (format) {
    case 0: {
      const int8_t* s = static_cast<const int8_t*>(src);
      for (int64_t n = 0; n < num_samples; ++n) {
        out_re[n] = scale * static_cast<float>(s[2 * n]);
        out_im[n] = scale * static_cast<float>(s[2 * n + 1]);
      }
      return 0;
    }
    case 1: {
      const int16_t* s = static_cast<const int16_t*>(src);
      for (int64_t n = 0; n < num_samples; ++n) {
        out_re[n] = scale * static_cast<float>(s[2 * n]);
        out_im[n] = scale * static_cast<float>(s[2 * n + 1]);
      }
      return 0;
    }
    case 2: {
      const float* s = static_cast<const float*>(src);
      for (int64_t n = 0; n < num_samples; ++n) {
        out_re[n] = scale * s[2 * n];
        out_im[n] = scale * s[2 * n + 1];
      }
      return 0;
    }
    default:
      return -2;
  }
}

// ---------------------------------------------------------------------------
// File reader
// ---------------------------------------------------------------------------

struct IqFile {
  FILE* f;
  int format;        // 0/1/2 as above
  int bytes_per_iq;  // bytes per complex sample
};

void* iqfile_open(const char* path, int format) {
  int bytes;
  switch (format) {
    case 0: bytes = 2; break;
    case 1: bytes = 4; break;
    case 2: bytes = 8; break;
    default: return nullptr;
  }
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  IqFile* h = new IqFile{f, format, bytes};
  return h;
}

// Reads up to num_samples complex samples into SoA planes; returns the
// number of samples actually read (short at EOF), or -1 on error.
int64_t iqfile_read(void* handle, int64_t num_samples, float scale,
                    float* out_re, float* out_im) {
  IqFile* h = static_cast<IqFile*>(handle);
  if (!h || num_samples < 0) return -1;
  const int64_t buf_samples = 1 << 16;
  int64_t done = 0;
  char* buf = static_cast<char*>(
      std::malloc(static_cast<size_t>(buf_samples) * h->bytes_per_iq));
  if (!buf) return -1;
  while (done < num_samples) {
    int64_t want = num_samples - done;
    if (want > buf_samples) want = buf_samples;
    size_t got = std::fread(buf, h->bytes_per_iq, static_cast<size_t>(want),
                            h->f);
    if (got == 0) break;
    iq_decode(buf, h->format, static_cast<int64_t>(got), scale,
              out_re + done, out_im + done);
    done += static_cast<int64_t>(got);
  }
  std::free(buf);
  return done;
}

int64_t iqfile_num_samples(void* handle) {
  IqFile* h = static_cast<IqFile*>(handle);
  if (!h) return -1;
  long pos = std::ftell(h->f);
  if (std::fseek(h->f, 0, SEEK_END) != 0) return -1;
  long end = std::ftell(h->f);
  std::fseek(h->f, pos, SEEK_SET);
  return end / h->bytes_per_iq;
}

void iqfile_close(void* handle) {
  IqFile* h = static_cast<IqFile*>(handle);
  if (!h) return;
  std::fclose(h->f);
  delete h;
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer of SoA float sample pairs (streaming front-end)
// ---------------------------------------------------------------------------

struct IqRing {
  float* re;
  float* im;
  int64_t capacity;                 // in samples
  std::atomic<int64_t> head;        // write position (monotonic)
  std::atomic<int64_t> tail;        // read position (monotonic)
};

void* iqring_create(int64_t capacity) {
  if (capacity <= 0) return nullptr;
  IqRing* r = new IqRing;
  r->re = static_cast<float*>(std::malloc(sizeof(float) * capacity));
  r->im = static_cast<float*>(std::malloc(sizeof(float) * capacity));
  if (!r->re || !r->im) {
    std::free(r->re);
    std::free(r->im);
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

int64_t iqring_size(void* handle) {
  IqRing* r = static_cast<IqRing*>(handle);
  if (!r) return -1;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// Producer: push decoded samples; returns pushed count (< num if full).
int64_t iqring_push(void* handle, const float* re, const float* im,
                    int64_t num) {
  IqRing* r = static_cast<IqRing*>(handle);
  if (!r || num < 0) return -1;
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  int64_t space = r->capacity - (head - tail);
  if (num > space) num = space;
  for (int64_t n = 0; n < num; ++n) {
    int64_t idx = (head + n) % r->capacity;
    r->re[idx] = re[n];
    r->im[idx] = im[n];
  }
  r->head.store(head + num, std::memory_order_release);
  return num;
}

// Consumer: pop exactly num samples into contiguous SoA planes, or 0 if not
// enough buffered yet (all-or-nothing: a correlator block must be complete).
int64_t iqring_pop_block(void* handle, float* out_re, float* out_im,
                         int64_t num) {
  IqRing* r = static_cast<IqRing*>(handle);
  if (!r || num < 0) return -1;
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  if (head - tail < num) return 0;
  for (int64_t n = 0; n < num; ++n) {
    int64_t idx = (tail + n) % r->capacity;
    out_re[n] = r->re[idx];
    out_im[n] = r->im[idx];
  }
  r->tail.store(tail + num, std::memory_order_release);
  return num;
}

void iqring_destroy(void* handle) {
  IqRing* r = static_cast<IqRing*>(handle);
  if (!r) return;
  std::free(r->re);
  std::free(r->im);
  delete r;
}

// ---------------------------------------------------------------------------
// Polyphase rational resampler (streaming, complex SoA)
//
// Front ends deliver IQ at whatever their reference clock divides to (10.000,
// 16.368, 25.000 MS/s ...); the correlator kernels want power-of-two samples
// per 1 ms block (8.192, 32.768 MS/s) so the time axis tiles the 8x128 vregs
// without padding waste. This converts by a rational factor up/down with a
// Kaiser-windowed-sinc anti-aliasing prototype evaluated polyphase: each
// output taps only `taps_per_phase` history samples, so cost is
// O(taps_per_phase) per output sample regardless of up/down magnitude.
// Streaming: carries filter history across calls, so arbitrary chunking of
// the input (file reads, ring pops) yields bit-identical output.
// ---------------------------------------------------------------------------

namespace {

double bessel_i0(double x) {
  // Modified Bessel I0 by power series (converges fast for |x| <= ~20).
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

struct Resampler {
  int64_t up, down;
  int taps_per_phase;     // history samples each output consumes
  float* h;               // [up * taps_per_phase] polyphase filter bank
  float* hist_re;         // [hist_cap] input history (absolute indexing)
  float* hist_im;
  int64_t hist_cap;       // power-of-two ring capacity >= taps_per_phase
  int64_t n_in;           // total inputs consumed (absolute)
  int64_t next_out;       // next output index m (absolute)
};

// up/down: rational rate ratio fs_out = fs_in * up / down (callers should
// divide out the gcd). taps_per_phase: history length per output (16-32 is
// transparent for GNSS work); kaiser_beta ~ 8 gives ~80 dB stopband.
void* resampler_create(int64_t up, int64_t down, int taps_per_phase,
                       double kaiser_beta) {
  if (up <= 0 || down <= 0 || taps_per_phase < 2) return nullptr;
  Resampler* r = new Resampler;
  r->up = up;
  r->down = down;
  r->taps_per_phase = taps_per_phase;
  const int64_t ntaps = up * taps_per_phase;
  r->h = static_cast<float*>(std::malloc(sizeof(float) * ntaps));
  r->hist_cap = 1;
  while (r->hist_cap < 2 * taps_per_phase) r->hist_cap <<= 1;
  r->hist_re = static_cast<float*>(std::calloc(r->hist_cap, sizeof(float)));
  r->hist_im = static_cast<float*>(std::calloc(r->hist_cap, sizeof(float)));
  if (!r->h || !r->hist_re || !r->hist_im) {
    std::free(r->h); std::free(r->hist_re); std::free(r->hist_im);
    delete r;
    return nullptr;
  }
  // Kaiser-windowed sinc at the up-sampled rate; cutoff at the narrower of
  // the input/output Nyquist frequencies: fc = 1/max(up, down) (normalized
  // to the upsampled Nyquist), gain `up` to preserve amplitude.
  const double fc = 1.0 / static_cast<double>(up > down ? up : down);
  const double center = 0.5 * static_cast<double>(ntaps - 1);
  const double i0b = bessel_i0(kaiser_beta);
  for (int64_t i = 0; i < ntaps; ++i) {
    const double t = static_cast<double>(i) - center;
    const double x = fc * t;
    const double sinc =
        (t == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    const double w_arg = 2.0 * static_cast<double>(i) / (ntaps - 1) - 1.0;
    const double window =
        bessel_i0(kaiser_beta * std::sqrt(1.0 - w_arg * w_arg)) / i0b;
    r->h[i] = static_cast<float>(fc * sinc * window * up);
  }
  r->n_in = 0;
  r->next_out = 0;
  return r;
}

// Number of outputs producible once `n_more` further inputs arrive.
int64_t resampler_out_count(void* handle, int64_t n_more) {
  Resampler* r = static_cast<Resampler*>(handle);
  if (!r || n_more < 0) return -1;
  const int64_t avail = r->n_in + n_more;
  // Output m needs input index floor(m*down/up) + 1 samples (plus history
  // already carried): count m with floor(m*down/up) < avail.
  const int64_t hi = (avail * r->up + r->up - 1) / r->down;
  return hi > r->next_out ? hi - r->next_out : 0;
}

// Streaming convert: consumes all n_in inputs, writes up to max_out outputs;
// returns outputs produced (or -1). Output is delayed by the filter's group
// delay (taps_per_phase/2 input samples), like any FIR resampler.
int64_t resampler_process(void* handle, const float* in_re,
                          const float* in_im, int64_t n, float* out_re,
                          float* out_im, int64_t max_out) {
  Resampler* r = static_cast<Resampler*>(handle);
  if (!r || n < 0) return -1;
  const int64_t mask = r->hist_cap - 1;
  int64_t produced = 0;
  int64_t consumed = 0;
  while (true) {
    // Produce every output whose newest needed input is already in history.
    while (produced < max_out) {
      const int64_t m = r->next_out;
      const int64_t num = m * r->down;           // position = num / up
      const int64_t k = num / r->up;             // newest input index needed
      if (k >= r->n_in) break;
      const int64_t phase = num % r->up;
      const float* hp = r->h + phase;            // h[phase + j*up]
      float acc_re = 0.0f, acc_im = 0.0f;
      for (int j = 0; j < r->taps_per_phase; ++j) {
        const int64_t idx = k - j;
        if (idx < 0) break;                      // zero history before start
        const int64_t slot = idx & mask;
        const float c = hp[static_cast<int64_t>(j) * r->up];
        acc_re += c * r->hist_re[slot];
        acc_im += c * r->hist_im[slot];
      }
      out_re[produced] = acc_re;
      out_im[produced] = acc_im;
      ++produced;
      ++r->next_out;
    }
    if (consumed >= n || produced >= max_out) break;
    // Feed one more input sample into the history ring.
    const int64_t slot = r->n_in & mask;
    r->hist_re[slot] = in_re[consumed];
    r->hist_im[slot] = in_im[consumed];
    ++consumed;
    ++r->n_in;
  }
  // Feed any remaining input even when max_out is reached, so the stream
  // never drops samples (callers size max_out via resampler_out_count).
  while (consumed < n) {
    const int64_t slot = r->n_in & mask;
    r->hist_re[slot] = in_re[consumed];
    r->hist_im[slot] = in_im[consumed];
    ++consumed;
    ++r->n_in;
  }
  return produced;
}

void resampler_destroy(void* handle) {
  Resampler* r = static_cast<Resampler*>(handle);
  if (!r) return;
  std::free(r->h);
  std::free(r->hist_re);
  std::free(r->hist_im);
  delete r;
}

}  // extern "C"
