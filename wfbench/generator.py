"""The one traffic generator: audio packets on a synthetic audio clock.

A traffic mix is a data file, ``traffic/<name>.json``, of the parameters
this generator reads:

* ``feed``: ``"per_stream"`` (one ``feed`` call a packet, as each OBS
  source's audio callback delivers it) or ``"batch"`` (one ``feed_batch``
  of every stream's packet, one capture feeding all streams at once);
* ``packet_frames``: frames a packet (OBS's audio output delivers 1024);
* ``phase``: ``"random"`` (each stream's first packet starts at its own
  offset within a packet, drawn from the seed) or ``"aligned"``;
* ``tone_amplitude``, ``tone_hz`` [low, high] (each stream's tone is drawn
  log-uniform between them) and ``noise_rms``: the audio, a tone and white
  noise on each channel.

The clock is the audio's: tick ``k`` is due when ``k`` video frames of
audio have played, and a packet is fed at the first tick due at or after
its last sample, stamped with its first sample's time on the same clock.
No packet is stamped ahead of the tick that takes it, so the program's
sync rule consumes every queued sample at that tick (within its hop
budget), and what each stream's ring holds follows from the packets fed.

Audio is made once, at set-up, from the seed: a loop of whole packets per
stream, at least two windows and 2**15 samples long, whose tone completes
whole cycles in it.  Feeding slices views of it, so the generator's own
work in the loop is a few array operations a tick.
"""

from __future__ import annotations

import math

import numpy as np

T0_NS = 1_000_000_000   # the audio clock at sample 0


def seed_words(seed: int) -> int:
    """Any whole number as a SeedSequence entropy word."""
    return int(seed) % (1 << 64)


class Traffic:
    """The packets of one traffic mix for ``streams`` sources of
    ``channels`` channels at ``sample_rate``, ticked at ``fps``, whose
    rings hold ``window`` samples."""

    def __init__(self, mix: dict, streams: int, channels: int, window: int,
                 sample_rate: int, fps: float, seed: int):
        hop = sample_rate / fps
        if hop != int(hop):
            raise ValueError(f"{sample_rate} Hz is no whole number of "
                             f"samples a frame at {fps} fps")
        self.hop = int(hop)
        self.S, self.C, self.N = streams, channels, window
        self.sr = sample_rate
        self.batch = mix["feed"] == "batch"
        if mix["feed"] not in ("batch", "per_stream"):
            raise ValueError(f"feed {mix['feed']!r}")
        self.P = int(mix["packet_frames"])
        if self.P <= 0:
            raise ValueError(f"packet_frames {self.P}")
        rng = np.random.default_rng([seed_words(seed), 0])
        if mix["phase"] == "random":
            self.offset = rng.integers(0, self.P, streams)
        elif mix["phase"] == "aligned":
            self.offset = np.zeros(streams, np.int64)
        else:
            raise ValueError(f"phase {mix['phase']!r}")
        if self.batch and self.offset.any():
            raise ValueError("a batch feed needs aligned phases")
        self.blocks = math.ceil(max(2 * window, 1 << 15) / self.P)
        L = self.blocks * self.P
        lo, hi = mix["tone_hz"]
        hz = np.exp(rng.uniform(math.log(lo), math.log(hi), streams))
        cycles = np.maximum(np.rint(hz * L / sample_rate), 1).astype(np.int64)
        phase = rng.uniform(0.0, 2.0 * math.pi, (streams, channels))
        audio = rng.standard_normal((streams, channels, L), dtype=np.float32)
        audio *= np.float32(mix["noise_rms"])
        j = np.arange(L, dtype=np.int64)
        for s in range(streams):
            # cycles·j mod L keeps the angle exact over the whole loop
            ang = 2.0 * math.pi * ((cycles[s] * j) % L) / L
            for c in range(channels):
                audio[s, c] += (mix["tone_amplitude"]
                                * np.sin(ang + phase[s, c])).astype(np.float32)
        # [S, C, blocks, P] -> contiguous packets: [S, blocks, C, P] for
        # per-stream feeds, [blocks, S, C, P] for a batch feed
        blocks = audio.reshape(streams, channels, self.blocks, self.P)
        order = (2, 0, 1, 3) if self.batch else (0, 2, 1, 3)
        self.loop = np.ascontiguousarray(blocks.transpose(order))
        self.first_tick = -(-(self.offset + self.P) // self.hop)

    def now_ns(self, k: int) -> int:
        """The audio clock at tick ``k``."""
        return T0_NS + (k * self.hop * 1_000_000_000) // self.sr

    def fed(self, k) -> np.ndarray:
        """Packets of each stream fed by tick ``k`` ([S], or [len(k), S]
        for an array of ticks)."""
        k = np.asarray(k, np.int64)[..., None]
        return np.maximum((k * self.hop - self.offset) // self.P, 0)

    def packets(self, k: int) -> list:
        """Tick ``k``'s packets, oldest first: (stream, [C, P] float32,
        start ns) for per-stream feeds, (None, [S, C, P], start ns) for a
        batch feed."""
        now, before = self.fed(k), self.fed(k - 1)
        out = []
        if self.batch:
            for p in range(int(before[0]), int(now[0])):
                out.append((None, self.loop[p % self.blocks], self._ns(0, p)))
            return out
        for s in np.flatnonzero(now > before).tolist():
            for p in range(int(before[s]), int(now[s])):
                out.append((s, self.loop[s, p % self.blocks],
                            self._ns(s, p)))
        return out

    def _ns(self, s: int, p: int) -> int:
        return T0_NS + ((int(self.offset[s]) + p * self.P)
                        * 1_000_000_000) // self.sr

    # -- what the reference reads ------------------------------------------

    def ends(self, ks) -> np.ndarray:
        """Samples of each stream fed by each tick of ``ks``: [len(ks), S]."""
        return self.fed(ks) * self.P

    def frames(self, s: int, ends) -> np.ndarray:
        """The last ``window`` samples fed to stream ``s`` by each count of
        ``ends``, zeros before its first: float64 [len(ends), C, N]."""
        L, N = self.blocks * self.P, self.N
        blocks = self.loop[:, s] if self.batch else self.loop[s]
        flat = blocks.transpose(1, 0, 2).reshape(self.C, L)
        ext = np.concatenate([flat, flat[:, :N]], axis=-1)   # wraps the loop
        out = np.zeros((len(ends), self.C, N))
        for i, e in enumerate(ends):
            n = min(e, N)
            a = (e - n) % L
            out[i, :, N - n:] = ext[:, a:a + n]
        return out
