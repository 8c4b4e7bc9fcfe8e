"""Audio output sinks.

The reference plays through sounddevice/PortAudio with a callback pulling
from the frame queue (utils_supersdr.py:1106-1147,1211-1213). Here the
sink is pluggable: `SoundDeviceSink` when the library and a device exist,
`WavFileSink` for headless capture, `NullSink` for benchmarks — all with
the same pull-callback shape (silence on underrun)."""

from __future__ import annotations

import threading

import numpy as np

from supersdr_tpu_torch.io import wav


class NullSink:
    """Discards audio; counts frames (benchmark/test sink)."""

    def __init__(self, **_):
        self.frames = 0
        self.running = False

    def start(self, pull) -> None:
        self.pull = pull
        self.running = True

    def pump(self, n: int = 1) -> None:
        for _ in range(n):
            frame = self.pull()
            if frame is not None:
                self.frames += 1

    def stop(self) -> None:
        self.running = False


class WavFileSink:
    """Writes pulled audio to a WAV file on a pump thread."""

    def __init__(self, path: str, audio_rate: int = 48000,
                 max_frames: int | None = None):
        self.recorder = wav.AudioRecorder(audio_rate)
        self.path = path
        self.max_frames = max_frames
        self.frames = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self, pull) -> None:
        self.recorder.start(self.path)

        def _pump():
            while not self._stop.is_set():
                if self.max_frames and self.frames >= self.max_frames:
                    break
                frame = pull()
                if frame is None:
                    continue
                self.recorder.append(frame)
                self.frames += 1

        self._thread = threading.Thread(target=_pump, daemon=True)
        self._thread.start()

    def stop(self) -> str | None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self.recorder.stop()


class SoundDeviceSink:
    """PortAudio playback via sounddevice, when available.

    Matches the reference's output format: 48 kHz stereo int16, blocksize
    = frame length, 'low' latency (utils:1211-1212). Falls back to
    unavailable=True when sounddevice or an output device is missing."""

    def __init__(self, audio_rate: int = 48000, blocksize: int = 2048,
                 channels: int = 2):
        self.audio_rate = audio_rate
        self.blocksize = blocksize
        self.channels = channels
        self.unavailable = False
        self.stream = None
        try:
            import sounddevice  # noqa: F401
            self._sd = sounddevice
        except Exception:  # ImportError or PortAudio load failure
            self._sd = None
            self.unavailable = True

    def start(self, pull) -> None:
        if self._sd is None:
            raise RuntimeError("sounddevice not available")
        last = np.zeros((self.blocksize, self.channels), np.int16)

        def callback(outdata, frame_count, time_info, status):
            frame = pull()
            if frame is None:
                outdata[:] = 0  # silence after underrun (utils:1110-1114)
                return
            f = np.asarray(frame)
            if f.dtype != np.int16:
                f = np.clip(np.round(f * 32767), -32768, 32767).astype(np.int16)
            if f.ndim == 1:
                f = np.stack([f, f], axis=-1)
            n = min(len(f), frame_count)
            outdata[:n] = f[:n]
            if n < frame_count:
                outdata[n:] = 0
            last[:] = outdata

        self.stream = self._sd.OutputStream(
            blocksize=self.blocksize, dtype=np.int16, latency="low",
            samplerate=self.audio_rate, channels=self.channels,
            callback=callback)
        self.stream.start()

    def stop(self) -> None:
        if self.stream is not None:
            self.stream.stop()
            self.stream.close()
            self.stream = None
