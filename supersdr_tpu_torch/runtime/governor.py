"""Streaming governors: sample-rate drift compensation and the audio
latency drop/refill state machine.

Deterministic, clock-injected reimplementations of the reference's two
self-healing mechanisms (SURVEY.md §5e):

  DriftCompensator — KiwiSDR servers stream at a *true* rate slightly off
  nominal (MSG audio_init sample_rate); the client occasionally reads two
  frames to stay in sync (utils_supersdr.py:1049-1052).

  LatencyGovernor — accumulates (wall time spent - stream time received);
  when the backlog exceeds (buffer + 2) frames it enters `late` mode
  (frames are dropped, the sink plays silence) until the backlog drains,
  then refills the buffer and resumes (utils_supersdr.py:1106-1115,
  1150-1186).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DriftCompensator:
    """Decide when to consume an extra frame to absorb clock drift.

    nominal_rate: advertised rate (e.g. 12000); true_rate: measured
    (e.g. 12001.15); frame: samples per frame (512).
    """
    nominal_rate: float
    true_rate: float
    frame: int = 512
    run_index: int = 0

    @property
    def delta(self) -> float:
        return self.true_rate - self.nominal_rate

    def tick(self) -> bool:
        """Call once per frame read; True → read one extra frame now
        (double-read semantics, utils:1049-1052)."""
        self.run_index += 1
        drift_samples = (self.run_index * self.delta * self.frame
                         / self.nominal_rate)
        if drift_samples >= self.frame:
            self.run_index = 0
            return True
        return False


@dataclass
class LatencyGovernor:
    """Drop/refill latency state machine with an injectable clock."""
    buffer_frames: int         # FULL_BUFF_LEN
    ms_per_frame: float        # frame / true_rate * 1000
    late: bool = False
    total_delay_ms: float = 0.0
    _last_ms: float | None = field(default=None, repr=False)

    def reset(self) -> None:
        """Fresh stream timeline (a reconnect starts a NEW stream — the
        reference rebuilds kiwi_sound outright, supersdr.py:743-796):
        without this, dead air before a disconnect leaves a permanent
        positive backlog and the governor drops every frame forever."""
        self.late = False
        self.total_delay_ms = 0.0
        self._last_ms = None

    def on_frame(self, now_ms: float, delivered: bool = True) -> str:
        """Record one frame arrival at wall-clock `now_ms`.

        Returns the action for this frame:
          'buffer'  — enqueue it for playback
          'drop'    — late: discard it (sink plays silence)
          'refill'  — backlog drained: enqueue AND top the buffer back up
                      to buffer_frames before resuming playback
        """
        if self._last_ms is None:
            self._last_ms = now_ms
            return "drop" if self.late else "buffer"
        delta = now_ms - self._last_ms
        self._last_ms = now_ms
        # backlog = accumulated wall time minus stream time consumed: one
        # frame-time is paid per frame whether played or dropped
        # (utils:1158-1170). In-time streaming holds it near zero; a stall
        # spikes it positive; each burst frame then drains one frame-time.
        self.total_delay_ms += delta - self.ms_per_frame

        if not self.late and self.total_delay_ms > \
                (self.buffer_frames + 2) * self.ms_per_frame:
            self.late = True
            return "drop"
        if self.late:
            if self.total_delay_ms < self.ms_per_frame:
                self.late = False
                self.total_delay_ms = 0.0
                return "refill"
            return "drop"
        return "buffer"
