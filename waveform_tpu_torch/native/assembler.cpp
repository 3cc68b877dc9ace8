// Waveform-TPU native runtime: multi-stream audio frame assembler.
//
// The TPU-native counterpart of the reference plugin's host machinery — the
// per-source CircularBuffer feeding (reference src/circular_buffer.hpp),
// the audio-callback timestamp/sync bookkeeping (src/source.cpp:1817-1888)
// and the pop-to-sync-point + peek frame assembly
// (src/source_generic.cpp:50-61) — generalized to S concurrent streams and
// batched: one call assembles every stream's window (or serving-mode hop)
// into a contiguous [S, C, N] array ready for host→device transfer.
//
// Design notes:
//  * sample-granular float rings (the plugin only ever moves float32
//    samples); capacity grows in 4096-sample steps with compaction
//  * per-stream timed mutex with a 10 ms try-lock on the feed side,
//    dropping the packet on contention — the reference's real-time-safe
//    backpressure (src/source.cpp:1822-1823)
//  * bogus-timestamp clamp at 16 s, A/V sync reserve, mute zero-fill —
//    byte-for-byte the Python runtime's semantics (runtime/source.py),
//    which the test suite cross-checks against this implementation
//
// C ABI only; bound from Python with ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kMaxTsDeltaNs = 16LL * 1000000000LL;   // source.hpp:291
constexpr int64_t kCaptureTimeoutNs = 500LL * 1000000LL; // source.hpp:290
constexpr size_t kGrowStep = 4096;

inline int64_t ns_to_frames(int64_t rate, int64_t ns) {
  return (ns * rate) / 1000000000LL;
}
inline int64_t frames_to_ns(int64_t rate, int64_t frames) {
  return (frames * 1000000000LL) / rate;
}

// Sample-granular ring buffer.
class Ring {
 public:
  void reset() { pos_ = used_ = 0; }
  size_t size() const { return used_; }

  void push(const float* src, size_t n) {
    if (n == 0) return;
    reserve(used_ + n);
    size_t cap = data_.size();
    size_t w = (pos_ + used_) % cap;
    size_t first = std::min(n, cap - w);
    if (src) {
      std::memcpy(data_.data() + w, src, first * sizeof(float));
      std::memcpy(data_.data(), src + first, (n - first) * sizeof(float));
    } else {
      std::memset(data_.data() + w, 0, first * sizeof(float));
      std::memset(data_.data(), 0, (n - first) * sizeof(float));
    }
    used_ += n;
  }

  // Drop (dest==nullptr) or copy out up to n front samples.
  size_t pop(float* dest, size_t n) {
    n = std::min(n, used_);
    if (n == 0) return 0;
    if (dest) peek(dest, n);
    pos_ = (pos_ + n) % data_.size();
    used_ -= n;
    return n;
  }

  void peek(float* dest, size_t n) const {
    n = std::min(n, used_);
    size_t first = std::min(n, data_.size() - pos_);
    std::memcpy(dest, data_.data() + pos_, first * sizeof(float));
    std::memcpy(dest + first, data_.data(), (n - first) * sizeof(float));
  }

 private:
  void reserve(size_t n) {
    if (data_.size() >= n) return;
    size_t new_size = (n + kGrowStep) & ~(kGrowStep - 1);
    std::vector<float> fresh(new_size);
    if (used_) peek(fresh.data(), used_);
    data_.swap(fresh);
    pos_ = 0;
  }

  std::vector<float> data_ = std::vector<float>(kGrowStep);
  size_t pos_ = 0;
  size_t used_ = 0;
};

struct Stream {
  std::timed_mutex mtx;
  std::vector<Ring> rings;  // one per channel
  Ring rms_ring;            // per-timepoint max-channel squares (raw,
                            // pre-mute: src/source.cpp:1843-1871 computes the
                            // normalization RMS before the mute zero-fill)
  int64_t capture_ts = 0;
  int64_t audio_ts = 0;
  // waveform-mode scroll state (runtime/waveform_device.py _WfStream:
  // the per-stream resample cursor and the reference ring's post-trim
  // size, src/source_generic.cpp:299-334); unused by spectrum/meter
  int64_t waveform_ts = 0;
  int64_t wf_total = 0;
  uint8_t show = 1;
};

struct Engine {
  int num_streams;
  int channels;
  int64_t window;      // fft_size (or waveform_samples) in samples
  int64_t sample_rate;
  int64_t ts_offset_ns;
  int rms_enabled = 0;
  // waveform mode trims the queue with a FLAT cap (keep the newest
  // trim_cap samples; the device ring holds exactly that much history)
  // instead of the spectrum-mode sync-reserve + window rule; 0 = off
  int64_t trim_cap = 0;
  std::vector<Stream> streams;
  std::vector<float> rms_scratch;  // one packet of squared peaks
};

// Python-semantics floor division for signed int64 (the host waveform
// timestamp math is specified in numpy int64 // terms).
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

inline int64_t audio_sync(const Engine& e, const Stream& s, int64_t ts) {
  int64_t audio_ts = s.audio_ts + e.ts_offset_ns;
  int64_t delta = std::min<int64_t>(std::llabs(audio_ts - ts), kMaxTsDeltaNs);
  return (audio_ts < ts) ? -delta : delta;
}

}  // namespace

extern "C" {

Engine* wf_create2(int num_streams, int channels, long long window,
                   long long sample_rate, long long ts_offset_ns,
                   int prefill, int rms_enabled) {
  auto* e = new Engine();
  e->num_streams = num_streams;
  e->channels = channels;
  e->window = window;
  e->sample_rate = sample_rate;
  e->ts_offset_ns = ts_offset_ns;
  e->rms_enabled = rms_enabled;
  e->streams = std::vector<Stream>(num_streams);
  for (auto& s : e->streams) {
    s.rings.resize(channels);
    if (prefill) {  // startup silence prefill (src/source.cpp:1243-1248)
      for (auto& r : s.rings) r.push(nullptr, (size_t)window);
      // the RMS-squares queue drains in lockstep with the sample queue
      // (runtime/waveform_device.py prefills both), so it must prefill too
      if (rms_enabled) s.rms_ring.push(nullptr, (size_t)window);
    }
  }
  return e;
}

// Waveform-mode queue policy: keep the newest ``cap`` samples flat
// (the device ring's capacity L; runtime/waveform_device.py feed trim).
void wf_set_trim_cap(Engine* e, long long cap) { e->trim_cap = cap; }

Engine* wf_create(int num_streams, int channels, long long window,
                  long long sample_rate, long long ts_offset_ns,
                  int prefill) {
  return wf_create2(num_streams, channels, window, sample_rate, ts_offset_ns,
                    prefill, /*rms_enabled=*/0);
}

void wf_destroy(Engine* e) { delete e; }

// Feed one packet for one stream. data is planar [channels, frames]
// (contiguous), or nullptr for silence. Returns 0 if dropped on contention.
int wf_feed(Engine* e, int stream, const float* data, int frames,
            long long timestamp_ns, long long now_ns, int muted) {
  Stream& s = e->streams[stream];
  // Bounded backpressure: drop the packet only after genuinely waiting out
  // the 10 ms budget (src/source.cpp:1822-1823).  try_lock_for alone is NOT
  // enough — the standard allows it to fail spuriously with no contention,
  // which intermittently dropped packets and desynced the ring.
  if (!s.mtx.try_lock()) {
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::milliseconds(10);
    for (;;) {
      if (s.mtx.try_lock()) break;
      if (std::chrono::steady_clock::now() >= deadline) return 0;
      std::this_thread::yield();
    }
  }
  std::lock_guard<std::timed_mutex> lk(s.mtx, std::adopt_lock);
  if (frames <= 0) return 1;

  s.capture_ts = now_ns;
  int64_t audio_len = frames_to_ns(e->sample_rate, frames);
  if (std::llabs(timestamp_ns - now_ns) > kMaxTsDeltaNs)
    s.audio_ts = now_ns;  // bogus timestamp (src/source.cpp:1833-1837)
  else
    s.audio_ts = timestamp_ns + audio_len;

  int64_t dtaudio = audio_sync(*e, s, s.capture_ts);
  int64_t dtsamples = dtaudio > 0 ? ns_to_frames(e->sample_rate, dtaudio) : 0;
  size_t max_size = e->trim_cap > 0 ? (size_t)e->trim_cap
                                    : (size_t)(dtsamples + e->window);

  if (e->rms_enabled) {
    // per-timepoint max-channel squares from the RAW (pre-mute) samples
    if (e->rms_scratch.size() < (size_t)frames)
      e->rms_scratch.resize((size_t)frames);
    for (int i = 0; i < frames; ++i) {
      float v = 0.0f;
      if (data)
        for (int c = 0; c < e->channels; ++c) {
          float a = std::fabs(data[(size_t)c * frames + i]);
          if (a > v) v = a;
        }
      e->rms_scratch[(size_t)i] = v * v;
    }
    s.rms_ring.push(e->rms_scratch.data(), (size_t)frames);
    size_t sz = s.rms_ring.size();
    if (sz > max_size) s.rms_ring.pop(nullptr, sz - max_size);
  }

  for (int c = 0; c < e->channels; ++c) {
    const float* src = (muted || !data) ? nullptr : data + (size_t)c * frames;
    s.rings[c].push(src, (size_t)frames);
    size_t sz = s.rings[c].size();
    if (sz > max_size) s.rings[c].pop(nullptr, sz - max_size);
  }
  return 1;
}

// Batched feed: one packet for every stream, planar [S, C, frames].
int wf_feed_batch(Engine* e, const float* data, int frames,
                  long long timestamp_ns, long long now_ns, int muted) {
  int ok = 0;
  for (int i = 0; i < e->num_streams; ++i) {
    const float* p =
        data ? data + (size_t)i * e->channels * frames : nullptr;
    ok += wf_feed(e, i, p, frames, timestamp_ns, now_ns, muted);
  }
  return ok;
}

// Spectrum-mode assembly: pop-to-sync + peek one full window per channel
// (src/source_generic.cpp:50-61). out is [S, C, window]; valid is [S, C];
// active is [S] (show && capture fresh).
void wf_assemble(Engine* e, long long now_ns, float* out, unsigned char* valid,
                 unsigned char* active) {
  const int64_t W = e->window;
  for (int i = 0; i < e->num_streams; ++i) {
    Stream& s = e->streams[i];
    std::lock_guard<std::timed_mutex> lk(s.mtx);
    active[i] =
        (s.show && (now_ns - s.capture_ts) <= kCaptureTimeoutNs) ? 1 : 0;
    int64_t dtaudio = audio_sync(*e, s, now_ns);
    int64_t dtsize =
        W + (dtaudio > 0 ? ns_to_frames(e->sample_rate, dtaudio) : 0);
    for (int c = 0; c < e->channels; ++c) {
      Ring& r = s.rings[c];
      float* dst = out + ((size_t)i * e->channels + c) * W;
      if ((int64_t)r.size() >= dtsize) {
        r.pop(nullptr, r.size() - (size_t)dtsize);
        r.peek(dst, (size_t)W);
        valid[i * e->channels + c] = 1;
      } else {
        std::memset(dst, 0, (size_t)W * sizeof(float));
        valid[i * e->channels + c] = 0;
      }
    }
  }
}

// Serving-mode assembly: consume up to H new samples per stream past the
// sync reserve (device-ring push path, runtime/serving.py). out [S, C, H]
// zero-padded; counts [S]; active [S].
void wf_assemble_hop(Engine* e, long long now_ns, int H, float* out,
                     int* counts, unsigned char* active) {
  for (int i = 0; i < e->num_streams; ++i) {
    Stream& s = e->streams[i];
    std::lock_guard<std::timed_mutex> lk(s.mtx);
    active[i] =
        (s.show && (now_ns - s.capture_ts) <= kCaptureTimeoutNs) ? 1 : 0;
    int64_t dtaudio = audio_sync(*e, s, now_ns);
    int64_t reserve = dtaudio > 0 ? ns_to_frames(e->sample_rate, dtaudio) : 0;
    int64_t avail = (int64_t)s.rings[0].size() - reserve;
    int64_t take = std::clamp(avail, (int64_t)0, (int64_t)H);
    counts[i] = (int)take;
    for (int c = 0; c < e->channels; ++c) {
      float* dst = out + ((size_t)i * e->channels + c) * H;
      size_t got = s.rings[c].pop(dst, (size_t)take);
      std::memset(dst + got, 0, ((size_t)H - got) * sizeof(float));
    }
  }
}

// Like wf_assemble_hop, but also drains the raw-squares RMS ring in sync:
// rms_out is [S, H] zero-padded.
void wf_assemble_hop_rms(Engine* e, long long now_ns, int H, float* out,
                         float* rms_out, int* counts, unsigned char* active) {
  wf_assemble_hop(e, now_ns, H, out, counts, active);
  for (int i = 0; i < e->num_streams; ++i) {
    Stream& s = e->streams[i];
    std::lock_guard<std::timed_mutex> lk(s.mtx);
    float* dst = rms_out + (size_t)i * H;
    size_t got = s.rms_ring.pop(dst, (size_t)counts[i]);
    std::memset(dst + got, 0, ((size_t)H - got) * sizeof(float));
  }
}

// Packed serving-mode assembly for the single-upload tick
// (runtime/serving.py _in_buf): each stream writes one row of a
// [S, row_stride] float buffer — C*H samples, then (only when with_rms)
// H raw RMS squares, then counts and active as floats.  Rows without the
// RMS block are 1/3 narrower at C=2 — the per-tick upload is the live
// path's dominant cost over thin links, so bytes only ride when the
// config needs them.  One lock pass per stream, zero Python repacking.
//
// split_active: meter-mode rows carry (counts, fresh, show) instead of
// (counts, show&&fresh) — the reference's tick_meter gates the two
// separately (timeout zeroes the sample ring, hide only the levels,
// src/source_generic.cpp:184-232).
void wf_assemble_hop_packed2(Engine* e, long long now_ns, int H, float* flat,
                             long long row_stride, int with_rms,
                             int split_active) {
  const int C = e->channels;
  const size_t meta = (size_t)C * H + (with_rms ? (size_t)H : 0);
  for (int i = 0; i < e->num_streams; ++i) {
    Stream& s = e->streams[i];
    std::lock_guard<std::timed_mutex> lk(s.mtx);
    float* row = flat + (size_t)i * (size_t)row_stride;
    uint8_t fresh = ((now_ns - s.capture_ts) <= kCaptureTimeoutNs) ? 1 : 0;
    int64_t dtaudio = audio_sync(*e, s, now_ns);
    int64_t reserve = dtaudio > 0 ? ns_to_frames(e->sample_rate, dtaudio) : 0;
    int64_t avail = (int64_t)s.rings[0].size() - reserve;
    int64_t take = std::clamp(avail, (int64_t)0, (int64_t)H);
    for (int c = 0; c < C; ++c) {
      float* dst = row + (size_t)c * H;
      size_t got = s.rings[c].pop(dst, (size_t)take);
      std::memset(dst + got, 0, ((size_t)H - got) * sizeof(float));
    }
    if (with_rms) {
      float* dst = row + (size_t)C * H;
      size_t got = s.rms_ring.pop(dst, (size_t)take);
      std::memset(dst + got, 0, ((size_t)H - got) * sizeof(float));
    }
    row[meta] = (float)take;
    if (split_active) {
      row[meta + 1] = (float)fresh;
      row[meta + 2] = (float)(s.show ? 1 : 0);
    } else {
      row[meta + 1] = (float)((s.show && fresh) ? 1 : 0);
    }
  }
}

void wf_assemble_hop_packed(Engine* e, long long now_ns, int H, float* flat,
                            long long row_stride, int with_rms) {
  wf_assemble_hop_packed2(e, now_ns, H, flat, row_stride, with_rms, 0);
}

// Waveform-mode packed assembly: the host half of the oscilloscope tick
// (runtime/waveform_device.py::_assemble — itself the batched form of the
// reference's per-source resample loop, src/source_generic.cpp:271-390).
// Each stream's row of the [S, row_stride] packed upload gets:
//   C*H drained samples | H raw RMS squares (with_rms) | W gather indices |
//   5 meta columns (counts, fresh-pixels ni, run, timeout, reserve).
// All timestamp math is int64 with Python floor-division semantics — the
// jitted device step consumes the row bit-for-bit like the NumPy assembly,
// so the two host paths are interchangeable (tests pin display equality).
//
// H = hop budget; W = display width (pixels); step_ns = ns per pixel;
// wf_window = cfg.waveform_samples; ring_cap = the device ring length L;
// reserve_limit = the static ring's sync-reserve budget (leads clamp).
void wf_assemble_waveform(Engine* e, long long now_ns, int H, int W,
                          long long step_ns, long long wf_window,
                          long long ring_cap, long long reserve_limit,
                          float* flat, long long row_stride, int with_rms) {
  const int C = e->channels;
  const size_t idx0 = (size_t)C * H + (with_rms ? (size_t)H : 0);
  const size_t meta = idx0 + (size_t)W;
  constexpr int64_t NSC = 1000000000LL;
  const int64_t sr = e->sample_rate;
  for (int i = 0; i < e->num_streams; ++i) {
    Stream& s = e->streams[i];
    std::lock_guard<std::timed_mutex> lk(s.mtx);
    float* row = flat + (size_t)i * (size_t)row_stride;
    const bool hidden =
        !s.show || (now_ns - s.capture_ts) > kCaptureTimeoutNs;
    // drain up to the hop budget — UNCONDITIONALLY, hidden or not: the
    // device ring is the capture ring and must keep filling, or a resume
    // would gather garbled stale samples across the gap.
    //
    // No zero-pad past ``take``: the device push consumes only the first
    // counts[s] columns (devring.push slices (ring ++ new)[c : c+L]), so
    // bytes beyond the drained samples are never read — skipping the
    // [take, H) memsets (and the stale gather-index fill below) is most
    // of this function's bandwidth at steady state (take ≈ hop ≪ H only
    // after backlog; idx ni ≪ W always).
    const int64_t queued = (int64_t)s.rings[0].size();
    const int64_t take = std::min<int64_t>(queued, H);
    for (int c = 0; c < C; ++c) {
      float* dst = row + (size_t)c * H;
      size_t got = s.rings[c].pop(dst, (size_t)take);
      if ((int64_t)got < take)  // defensive: rings advance in lockstep
        std::memset(dst + got, 0, ((size_t)take - got) * sizeof(float));
    }
    if (with_rms) {
      float* dst = row + (size_t)C * H;
      size_t got = s.rms_ring.pop(dst, (size_t)take);
      if ((int64_t)got < take)
        std::memset(dst + got, 0, ((size_t)take - got) * sizeof(float));
    }
    // timestamp → reserve → gather-index math; the effective "newest
    // sample" timestamp excludes the backlog still queued past the hop
    const int64_t left = queued - take;
    const int64_t audio_eff = s.audio_ts - floordiv(left * NSC, sr);
    const int64_t delta = audio_eff + e->ts_offset_ns - now_ns;
    const int64_t lag = std::min<int64_t>(std::llabs(delta), kMaxTsDeltaNs);
    int64_t reserve = delta > 0 ? floordiv(lag * sr, NSC) : 0;
    reserve = std::min<int64_t>(reserve, reserve_limit);  // lead clamp
    // reference ring size this tick: last tick's post-consume size plus
    // arrivals, feed-trimmed to reserve + waveform window (ring cap max)
    const int64_t total = std::min<int64_t>(
        s.wf_total + take, std::min<int64_t>(wf_window + reserve, ring_cap));
    bool run = !hidden && total > reserve;
    const int64_t start_ts = audio_eff - floordiv(total * NSC, sr);
    const int64_t stop_ts = audio_eff - floordiv(reserve * NSC, sr);
    run = run && start_ts < audio_eff && stop_ts <= audio_eff;  // rollover
    const int64_t wts0 = s.waveform_ts;
    int64_t wts = wts0 < start_ts ? start_ts : wts0;
    if (wts > stop_ts && wts - stop_ts > step_ns) wts = start_ts;
    // fresh-pixel count in closed form: ceil((stop - wts) / step), in [0, W]
    int64_t ni = floordiv(stop_ts - wts + step_ns - 1, step_ns);
    ni = std::clamp<int64_t>(ni, 0, W);
    if (!run) ni = 0;
    float* idx = row + idx0;
    for (int64_t p = 0; p < ni; ++p) {
      const int64_t tsn = wts + p * step_ns;
      const int64_t frames = floordiv((audio_eff - tsn) * sr, NSC);
      // gather depth clamps to (reserve, total]; < L < 2^24 ⇒ exact float
      idx[p] = (float)std::clamp(frames, reserve + 1, total);
    }
    // columns >= ni stay stale: the device scroll consumes gathered[:n]
    // only, and every past write here (or the zero init) is a valid
    // in-range gather index, so no per-tick fill is needed
    row[meta + 0] = (float)take;
    row[meta + 1] = (float)ni;
    row[meta + 2] = run ? 1.0f : 0.0f;
    row[meta + 3] = hidden ? 1.0f : 0.0f;
    row[meta + 4] = (float)reserve;
    s.waveform_ts = run ? wts + ni * step_ns : wts0;
    s.wf_total = run ? reserve : total;  // consumed down to the reserve
  }
}

// Waveform scroll-state migration (live resize: the resample cursor and
// the reference ring's post-trim size move with their stream row).
void wf_get_wf_state(Engine* e, int stream, long long* waveform_ts,
                     long long* total) {
  Stream& s = e->streams[stream];
  std::lock_guard<std::timed_mutex> lk(s.mtx);
  *waveform_ts = s.waveform_ts;
  *total = s.wf_total;
}

void wf_set_wf_state(Engine* e, int stream, long long waveform_ts,
                     long long total) {
  Stream& s = e->streams[stream];
  std::lock_guard<std::timed_mutex> lk(s.mtx);
  s.waveform_ts = waveform_ts;
  s.wf_total = total;
}

// Sync-state migration for live engine resizes (runtime/serving.py
// ServingEngine.resized): timestamps and visibility move to the new
// assembler so surviving streams stay "active" across the swap; ring
// backlog intentionally does not move (sub-hop gap, see resized()).
void wf_get_sync(Engine* e, int stream, long long* capture_ts,
                 long long* audio_ts, int* show) {
  Stream& s = e->streams[stream];
  std::lock_guard<std::timed_mutex> lk(s.mtx);
  *capture_ts = s.capture_ts;
  *audio_ts = s.audio_ts;
  *show = s.show;
}

void wf_set_sync(Engine* e, int stream, long long capture_ts,
                 long long audio_ts, int show) {
  Stream& s = e->streams[stream];
  std::lock_guard<std::timed_mutex> lk(s.mtx);
  s.capture_ts = capture_ts;
  s.audio_ts = audio_ts;
  s.show = show ? 1 : 0;
}

void wf_set_show(Engine* e, int stream, int show) {
  e->streams[stream].show = (uint8_t)show;
}

void wf_detach(Engine* e, int stream) {  // source lost (src/source.cpp:722-749)
  Stream& s = e->streams[stream];
  std::lock_guard<std::timed_mutex> lk(s.mtx);
  for (auto& r : s.rings) r.reset();
  s.rms_ring.reset();
  s.capture_ts = 0;
  s.audio_ts = 0;
}

long long wf_ring_size(Engine* e, int stream, int channel) {
  return (long long)e->streams[stream].rings[channel].size();
}

}  // extern "C"
