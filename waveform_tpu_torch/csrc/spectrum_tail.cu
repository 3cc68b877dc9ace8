// The spectrum tail: everything the spectrum step does after the |rFFT|, as
// one pair of launches.
//
// Replaces no Pallas kernel.  The JAX package's tail
// (waveform_tpu/dsp/spectrum.py, make_spectrum_step) is plain jnp code that
// XLA fuses into a few loops; run op by op in PyTorch
// (dsp/spectrum.py: spectrum_tail_ref) it is about 95 elementwise kernels
// a tick, each reading and writing whole [S, C, N/2] arrays.  This pair
// computes the same function, in the same order, with one rounding per
// torch op:
//
//   for each stream s, channel c < C and bin k < nbins:
//     m        = mag * coeff (* slope[k])                    (_mag_tail)
//     ms       = g * max?(m, ts_old) + g2 * m                 (EMA; g, g2 of dt)
//     gating   = the channel-ordered silence latch, the mono mid-tick scan,
//                skip / counted / latch, frozen, timeout, run (scalar, per
//                stream, in the step's order)
//     ts_new   = ms, or ts_old (skipped, latched timeout, not run), or 0
//                (fresh timeout)
//     work     = ms, or the old m_decibels value (skipped); O > C copies
//                channel 0
//     folded   = dbfs(work) (stereo, or one channel), or in mono C = 2
//                dbfs((w0 + w1) * 0.5) into channel 0 with channel 1 linear
//     display  = + clamp_max(volume_target - dbfs(rms), max_gain), then
//                clamp_min(. - rolloff[k], DB_MIN) on bins >= 1 of the
//                display channels
//     db_new   = folded, or db_old (frozen, latched timeout, not run), or
//                DB_MIN on the display channels of a fresh timeout
//
// dbfs is _db_from_positive's df32 arithmetic (frexp range reduction, the
// atanh series, Dekker products of Veltkamp halves, TwoSum, the same
// association order), with DB_MIN where mag <= 0.  Built with -fmad=false,
// IEEE division and the library frexpf, every operation rounds once, as the
// torch op does, so both give the same bits.
//
// Bound on this card: device-memory bytes.  At (N, S) = (65536, 32), mono
// C = 2, the tail must read mag and the old tsmooth (16.8 MB) and write the
// new tsmooth and m_decibels (16.8 MB); the gate needs the old display
// channel (4.2 MB) and a skipped, frozen or timed-out stream its old
// m_decibels (up to 8.4 MB): 33.6-46.1 MB, 10.0-13.8 us at 3.35 TB/s.
// The gate is a reduction over a whole channel that every bin's result
// depends on, and blocks cannot wait on each other, so the work is split in
// two launches:
//
//   gate (spectrum_tail_gate): S x B blocks, each tests one slice of the old
//     display channel (channel 0 in mono) for <= floor - 10 and writes one
//     flag; a stream none of whose channels is silent reads nothing, since
//     no gating outcome depends on the test there;
//   fuse (spectrum_tail_fuse): S x B' blocks over bin ranges, B' such that
//     all blocks are resident at once (one wave); thread 0 folds the stream's
//     flags and small inputs into its per-channel modes (uniform across the
//     block) while every thread's first loads are in flight, then each
//     thread streams 16-byte vectors of bins (one float per thread where
//     nbins % 4 != 0 or a row is not 16-byte aligned), the next vector's
//     loads issued before the current one computes, reading the old
//     m_decibels only where a mode asks for it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 2;        // capture channels (core/config: at most 2)
constexpr int kMaxO = 2;        // output channels (1 or 2)

// dsp/spectrum.py's float32 constants: _C_E_HI, _C_E_LO (20*log10(2) as a
// df32 pair), _C_M_HI, _C_M_LO (20/ln(10)), _INV (1/3, 1/5, 1/7, 1/9),
// _SQRT_HALF, and DB_MIN (core/config.py) as f32
constexpr float kCeHi = 0x1.815182p+2f;
constexpr float kCeLo = 0x1.31d62p-24f;
constexpr float kCmHi = 0x1.15f2cep+3f;
constexpr float kCmLo = 0x1.a709e4p-22f;
constexpr float kInv3 = 0x1.555556p-2f;
constexpr float kInv5 = 0x1.99999ap-3f;
constexpr float kInv7 = 0x1.24924ap-3f;
constexpr float kInv9 = 0x1.c71c72p-4f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;
constexpr float kDbMin = -0x1.7b4c3cp+9f;

// flag bits of the C entry point
constexpr int kStereo = 1, kSmooth = 2, kFastPeaks = 4, kNormalize = 8;

// a channel's state this tick: the new value, the old one, or the cleared
// one (0 for tsmooth, DB_MIN on a display channel of m_decibels)
enum Mode : unsigned char { kNew = 0, kOld = 1, kClear = 2 };

struct Args {
  const float* mag;             // [S, C, nbins]
  const unsigned char* nz_k;    // [S, C] bool
  const unsigned char* valid;   // [S, C] bool, or null (all valid)
  const float* ts_old;          // [S, C, nbins]
  const float* db_old;          // [S, O, nbins]
  const unsigned char* ls_old;  // [S] bool
  const float* gravity;         // [2] (g, 1 - g), or null: g, g2 below
  const unsigned char* active;  // [S] bool
  const float* input_rms;       // [S] (normalize)
  const unsigned char* run;     // [S] bool, or null (all run)
  const float* slope;           // [nbins], or null
  const float* rolloff;         // [nbins], or null
  unsigned char* partial;       // [S, G, B] the gate's flags, G = C or 1
  float* ts_new;                // [S, C, nbins]
  float* db_new;                // [S, O, nbins]
  unsigned char* ls_new;        // [S] bool
  int nbins, channels, outputs, display, flags;
  int gate_blocks;               // blocks a stream of the gate (the partials)
  int fuse_blocks;               // blocks a stream of the fused tail
  float g, g2, coeff, floor_gate, volume_target, max_gain;
};

// ---------------------------------------------------------------------------
// the torch ops, one rounding each
// ---------------------------------------------------------------------------

__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  const float t = 4097.0f * a;
  hi = t - (t - a);
  lo = a - hi;
}

// exactfft.two_prod: a * b = p + e (Dekker)
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = a * b;
  float ah, al, bh, bl;
  veltkamp(a, ah, al);
  veltkamp(b, bh, bl);
  e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl;
}

// exactfft.two_sum: a + b = s + e (Knuth)
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

// spectrum._db_from_positive: 20*log10(mag) for mag > 0
__device__ __forceinline__ float db_from_positive(float mag) {
  int ei;
  float f = frexpf(mag, &ei);              // mag = f * 2^e, f in [.5, 1)
  const bool small = f < kSqrtHalf;
  if (small) f = f * 2.0f;
  const float e = static_cast<float>(ei - (small ? 1 : 0));
  const float z = (f - 1.0f) / (f + 1.0f);
  const float w = z * z;
  const float poly = 1.0f + w * (kInv3 + w * (kInv5 + w * (kInv7 + w * kInv9)));
  const float lnf = 2.0f * z * poly;
  float p, pe, q, qe, hi, err;
  two_prod(e, kCeHi, p, pe);
  two_prod(lnf, kCmHi, q, qe);
  two_sum(p, q, hi, err);
  return hi + ((((err + pe) + qe) + e * kCeLo) + lnf * kCmLo);
}

// spectrum.dbfs: DB_MIN for mag <= 0 (and NaN)
__device__ __forceinline__ float dbfs(float mag) {
  return mag > 0.0f ? db_from_positive(mag) : kDbMin;
}

// torch.maximum: NaN propagates, the first argument's first
__device__ __forceinline__ float tmaximum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// torch.clamp_max / clamp_min with a scalar: NaN passes through
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ---------------------------------------------------------------------------
// vectors of V bins
// ---------------------------------------------------------------------------

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2],
                                                r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// ---------------------------------------------------------------------------
// the gate: one flag per (stream, tested channel, bin slice)
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads) spectrum_tail_gate(const Args a) {
  const int s = blockIdx.x / a.gate_blocks, b = blockIdx.x % a.gate_blocks;
  const int C = a.channels, O = a.outputs;
  const bool stereo = a.flags & kStereo;
  const int tested = stereo ? C : 1;        // disp_ch: c, or 0 in mono
  const int nvec = a.nbins / V;
  for (int d = 0; d < tested; ++d) {
    // the test matters only to a valid channel with no nonzero sample that
    // reads it (mono: every channel reads channel 0's)
    bool need = false;
    for (int c = 0; c < C; ++c) {
      const bool valid = a.valid == nullptr || a.valid[s * C + c];
      if ((!stereo || c == d) && valid && !a.nz_k[s * C + c]) need = true;
    }
    bool all = true;
    if (need) {
      const float* row = a.db_old + (static_cast<size_t>(s) * O + d) * a.nbins;
      for (int i = b * kThreads + threadIdx.x; i < nvec;
           i += a.gate_blocks * kThreads) {
        const Vec<V> x = load<V>(row + i * V);
#pragma unroll
        for (int l = 0; l < V; ++l) all = all && x.v[l] <= a.floor_gate;
      }
    }
    all = __syncthreads_and(all);
    if (threadIdx.x == 0)
      a.partial[(s * tested + d) * a.gate_blocks + b] = all ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// the fused tail
// ---------------------------------------------------------------------------

struct Flags {
  unsigned char ts_mode[kMaxC];
  unsigned char db_mode[kMaxO];
  bool skip[kMaxC];       // work takes the old m_decibels value
  bool smoothed[kMaxC];   // the channel's smoothed magnitude is used
  bool read_ts[kMaxC];
  bool read_db[kMaxO];
  bool fold;              // the outputs take the folded values
  bool last_silent;
  float g, g2, comp;
};

// One stream's gating, in the step's order (dsp/spectrum.py,
// spectrum_tail_ref: silence gating, the latch, frozen, timeout, run).
__device__ Flags stream_flags(const Args& a, int s) {
  const int C = a.channels, O = a.outputs, D = a.display;
  const bool stereo = a.flags & kStereo;
  const int tested = stereo ? C : 1;
  bool valid[kMaxC], nz[kMaxC], silent[kMaxC], ls_seen[kMaxC],
      out_silent[kMaxC];
  const bool ls0 = a.ls_old[s];
  for (int c = 0; c < C; ++c) {
    valid[c] = a.valid == nullptr || a.valid[s * C + c];
    nz[c] = a.nz_k[s * C + c] && valid[c];
    silent[c] = !nz[c];
    ls_seen[c] = c == 0 ? ls0 : ls_seen[c - 1] && !nz[c - 1];
    const unsigned char* p =
        a.partial + (s * tested + (stereo ? c : 0)) * a.gate_blocks;
    unsigned char all = 1;
    for (int b = 0; b < a.gate_blocks; ++b) all &= p[b];
    out_silent[c] = all != 0;
  }
  if (!stereo && C > 1) {
    // the reference scans m_decibels[0] mid-tick: once an earlier channel
    // processed, a later silent channel cannot read outsilent
    bool proc = valid[0] && !(silent[0] && (ls_seen[0] || out_silent[0]));
    for (int c = 1; c < C; ++c) {
      out_silent[c] = out_silent[c] && !proc;
      proc = proc || (valid[c]
                      && !(silent[c] && (ls_seen[c] || out_silent[c])));
    }
  }
  Flags f;
  bool survives = ls0, latch_set = true;
  for (int c = 0; c < C; ++c) {
    f.skip[c] = !valid[c] || (silent[c] && (ls_seen[c] || out_silent[c]));
    latch_set = latch_set
                && (valid[c] && silent[c] && !ls_seen[c] && out_silent[c]);
    survives = survives && !nz[c];
  }
  const bool latched = survives || latch_set;     // frozen
  const bool timed_out = !a.active[s];
  const bool runs = a.run == nullptr || a.run[s];
  f.last_silent = runs ? (timed_out || latched) : ls0;
  // the old value wins, in the step's order: not run, then the timeout
  // (fresh: cleared), then frozen (decibels) or skipped (tsmooth)
  const bool live = runs && !timed_out;
  const bool fresh = runs && timed_out && !ls0;
  f.fold = live && !latched;
  for (int c = 0; c < C; ++c) {
    f.smoothed[c] = live && !f.skip[c];
    f.ts_mode[c] = f.smoothed[c] ? kNew : fresh ? kClear : kOld;
    f.read_ts[c] = f.ts_mode[c] == kOld
                   || (f.smoothed[c] && (a.flags & kSmooth));
  }
  for (int o = 0; o < O; ++o) {
    f.db_mode[o] = f.fold ? kNew : (fresh && o < D) ? kClear : kOld;
    f.read_db[o] = f.db_mode[o] == kOld || (f.fold && o < C && f.skip[o]);
  }
  f.g = a.gravity != nullptr ? a.gravity[0] : a.g;
  f.g2 = a.gravity != nullptr ? a.gravity[1] : a.g2;
  f.comp = 0.0f;
  if (a.flags & kNormalize)
    f.comp = clamp_max(a.volume_target - dbfs(a.input_rms[s]), a.max_gain);
  return f;
}

// mag and (smoothing on) the old tsmooth of every channel at bin k0
template <int V>
__device__ __forceinline__ void fetch(const Args& a, size_t row, int k0,
                                      bool smooth, Vec<V>* m, Vec<V>* t) {
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= a.channels) break;
    const size_t at = row + static_cast<size_t>(c) * a.nbins + k0;
    m[c] = load<V>(a.mag + at);
    if (smooth) t[c] = load<V>(a.ts_old + at);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) spectrum_tail_fuse(const Args a) {
  const int s = blockIdx.x / a.fuse_blocks, b = blockIdx.x % a.fuse_blocks;
  const int C = a.channels, O = a.outputs, D = a.display, n = a.nbins;
  const bool stereo = a.flags & kStereo;
  const bool smooth = a.flags & kSmooth;
  const bool peaks = a.flags & kFastPeaks;
  const bool norm = a.flags & kNormalize;
  const size_t ts_row = static_cast<size_t>(s) * C * n;
  const size_t db_row = static_cast<size_t>(s) * O * n;
  const int nvec = n / V, step = a.fuse_blocks * kThreads;
  // the first vectors' loads are in flight while thread 0 reads the
  // stream's flags, and each later vector's while the one before computes
  int i = b * kThreads + threadIdx.x;
  Vec<V> m[kMaxC], tso[kMaxC];
  if (i < nvec) fetch<V>(a, ts_row, i * V, smooth, m, tso);
  __shared__ Flags shared;
  if (threadIdx.x == 0) {
    shared = stream_flags(a, s);
    if (b == 0) a.ls_new[s] = shared.last_silent ? 1 : 0;
  }
  __syncthreads();
  const Flags f = shared;
  for (; i < nvec; i += step) {
    const int k0 = i * V;
    const bool more = i + step < nvec;
    Vec<V> m_next[kMaxC], t_next[kMaxC];
    if (more) fetch<V>(a, ts_row, (i + step) * V, smooth, m_next, t_next);
    Vec<V> ms[kMaxC], dbo[kMaxO];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      const size_t at = ts_row + static_cast<size_t>(c) * n + k0;
      if (f.read_ts[c] && !smooth) tso[c] = load<V>(a.ts_old + at);
      if (f.smoothed[c]) {
        Vec<V> sl;
        if (a.slope != nullptr) sl = load<V>(a.slope + k0);
#pragma unroll
        for (int l = 0; l < V; ++l) {
          float x = m[c].v[l] * a.coeff;
          if (a.slope != nullptr) x = x * sl.v[l];
          if (smooth) {
            const float old = peaks ? tmaximum(x, tso[c].v[l]) : tso[c].v[l];
            x = f.g * old + f.g2 * x;
          }
          ms[c].v[l] = x;
        }
      }
      Vec<V> t;
#pragma unroll
      for (int l = 0; l < V; ++l)
        t.v[l] = f.ts_mode[c] == kNew ? ms[c].v[l]
                 : f.ts_mode[c] == kOld ? tso[c].v[l] : 0.0f;
      store<V>(a.ts_new + at, t);
    }
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) {
      if (o >= O) break;
      if (f.read_db[o])
        dbo[o] = load<V>(a.db_old + db_row + static_cast<size_t>(o) * n + k0);
    }
    Vec<V> out[kMaxO];
    if (f.fold) {
      Vec<V> work[kMaxO];
#pragma unroll
      for (int o = 0; o < kMaxO; ++o) {
        if (o >= O) break;
        if (o < C)
          work[o] = f.skip[o] ? dbo[o] : ms[o];
        else                                     // O > C: channel 0 again
          work[o] = f.skip[0] ? dbo[0] : ms[0];
      }
      Vec<V> ro;
      if (a.rolloff != nullptr) ro = load<V>(a.rolloff + k0);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const bool shaped = k0 + l >= 1;         // bins >= 1 of the display
#pragma unroll
        for (int o = 0; o < kMaxO; ++o) {
          if (o >= O) break;
          float y;
          if (!stereo && C == 2)                 // mono fold: dB into 0
            y = o == 0 ? dbfs((work[0].v[l] + work[1].v[l]) * 0.5f)
                       : work[o].v[l];
          else
            y = dbfs(work[o].v[l]);
          if (o < D && shaped) {
            if (norm) y = y + f.comp;
            if (a.rolloff != nullptr) y = clamp_min(y - ro.v[l], kDbMin);
          }
          out[o].v[l] = y;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kMaxO; ++o) {
      if (o >= O) break;
      Vec<V> r;
#pragma unroll
      for (int l = 0; l < V; ++l)
        r.v[l] = f.db_mode[o] == kNew ? out[o].v[l]
                 : f.db_mode[o] == kOld ? dbo[o].v[l] : kDbMin;
      store<V>(a.db_new + db_row + static_cast<size_t>(o) * n + k0, r);
    }
    if (more) {
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        m[c] = m_next[c];
        tso[c] = t_next[c];
      }
    }
  }
}

// Blocks a stream of the fused tail: as many as the card holds at once
// over all streams (one wave: the flags are read once a block), no more
// than the stream's vectors fill.
template <int V>
int fuse_blocks(int streams, int nvec, int& blocks) {
  static int resident[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spectrum_tail_fuse<V>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[device] = per_sm * sms;
  }
  const int fill = (nvec + kThreads - 1) / kThreads;
  blocks = resident[device] / streams;
  blocks = blocks < 1 ? 1 : blocks > fill ? fill : blocks;
  return static_cast<int>(cudaSuccess);
}

template <int V>
int launch(Args a, int streams, int stages, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (stages & 1) {
    spectrum_tail_gate<V><<<streams * a.gate_blocks, kThreads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & 2) {
    const int e = fuse_blocks<V>(streams, a.nbins / V, a.fuse_blocks);
    if (e != 0) return e;
    spectrum_tail_fuse<V><<<streams * a.fuse_blocks, kThreads, 0, st>>>(a);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry point.  mag, ts_old [S, C, nbins] and db_old [S, O, nbins] f32;
// nz_k, valid [S, C], ls_old, active, run [S] bool (one byte each; valid and
// run may be null: all true); gravity [2] f32 (g, 1 - g) or null (then g,
// g2); input_rms [S] f32 (read under normalize); slope, rolloff [nbins] f32
// or null; partial [S, G, gate_blocks] bytes of scratch (G = C in stereo,
// else 1: one flag a gate block); outputs ts_new [S, C, nbins], db_new [S, O, nbins], ls_new [S] bool.
// flags: 1 stereo, 2 smoothing (the EMA), 4 fast peaks, 8 normalize volume.
// vec 4 takes 16-byte vectors (nbins % 4 == 0, every row 16-byte aligned),
// vec 1 single floats.  stages: 1 the gate, 2 the fused tail, 3 both (a
// stage alone is for timing).  Launches on `stream`; returns the first
// failing call's cudaError_t.
extern "C" int wf_spectrum_tail(
    const float* mag, const unsigned char* nz_k, const unsigned char* valid,
    const float* ts_old, const float* db_old, const unsigned char* ls_old,
    const float* gravity, const unsigned char* active, const float* input_rms,
    const unsigned char* run, const float* slope, const float* rolloff,
    unsigned char* partial, float* ts_new, float* db_new,
    unsigned char* ls_new, int streams, int nbins, int channels, int outputs,
    int display, int flags, int vec, int gate_blocks, float g, float g2,
    float coeff, float floor_gate, float volume_target, float max_gain,
    int stages, void* stream) {
  if (streams <= 0) return static_cast<int>(cudaSuccess);
  if (channels < 1 || channels > kMaxC || outputs < channels
      || outputs > kMaxO || display < 1 || display > outputs || gate_blocks < 1
      || nbins < 1 || (vec != 1 && vec != 4) || nbins % vec != 0
      || stages < 1 || stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{mag, nz_k, valid, ts_old, db_old, ls_old, gravity, active,
               input_rms, run, slope, rolloff, partial, ts_new, db_new,
               ls_new, nbins, channels, outputs, display, flags,
               gate_blocks, 0, g, g2, coeff, floor_gate, volume_target, max_gain};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<4>(a, streams, stages, st)
                  : launch<1>(a, streams, stages, st);
}
