"""Hamlib rigctld integration: CAT client and rigctld emulator server.

Client (`CatClient`): TCP client of a hamlib `rigctld`, mirroring the
reference `cat` class (utils_supersdr.py:1218-1298):
freq/mode/vfo/PTT polling, set freq/mode, degrade to `cat_ok=False` on
failure (empty reply or "RPRT -5") with runtime re-enable.

Server (`RigctldServer`): emulates the rigctld command subset used by
fldigi/wsjtx (`f F m M s v q \\chk_vfo \\dump_state`), mapping onto any
object with the small `TunableRig` interface — the behavior of
kiwi/rigctld.py:52-241 re-homed onto our receiver control plane.
"""

from __future__ import annotations

import select
import socket
import threading
from typing import Protocol

KNOWN_MODES = {"USB", "LSB", "CW", "AM"}
CAT_MIN_FREQ_KHZ = 100.0
CAT_MAX_FREQ_KHZ = 30000.0


class CatClient:
    """rigctld TCP client; all frequencies in kHz (hamlib wire is Hz)."""

    def __init__(self, host: str, port: int, timeout: float = 3.0):
        self.host, self.port = host, port
        self.cat_ok = False
        self.cat_tx = False
        self.freq: float | None = None
        self.radio_mode = "USB"
        self.vfo = "A"
        self.reply: str | None = None
        self.socket: socket.socket | None = None
        try:
            self.socket = socket.create_connection((host, port),
                                                   timeout=timeout)
        except OSError:
            self.socket = None
            return
        self.freq = self.get_freq()
        if self.freq is None:
            return
        self.radio_mode = self.get_mode()
        self.cat_ok = True

    def send_msg(self, msg: str) -> None:
        if self.socket is None:
            self.cat_ok = False
            self.reply = None
            return
        try:
            self.socket.send((msg + "\n").encode())
            out = self.socket.recv(64).decode()
        except OSError:
            out = ""
        if len(out) == 0 or "RPRT -5" in out:
            self.cat_ok = False
            self.reply = None
        else:
            self.reply = out

    def get_ptt(self) -> bool:
        self.send_msg("\\get_ptt")
        self.cat_tx = bool(self.reply) and self.reply == "1\n"
        return self.cat_tx

    def get_vfo(self) -> str:
        self.send_msg("\\get_vfo")
        if self.reply:
            self.vfo = "A" if "VFOA" in self.reply else "B"
        return self.vfo

    def get_freq(self) -> float | None:
        self.get_vfo()
        self.send_msg("\\get_freq")
        if self.reply:
            try:
                self.freq = int(self.reply) / 1000.0
            except ValueError:
                self.cat_ok = False
        return self.freq

    def get_mode(self) -> str:
        self.send_msg("\\get_mode")
        if self.reply:
            mode = self.reply.split("\n")[0]
            # RTTY/FSK/etc degrade to USB (utils_supersdr.py:1295-1296)
            self.radio_mode = mode if mode in KNOWN_MODES else "USB"
            return self.radio_mode
        return "USB"

    def set_freq(self, freq_khz: float) -> None:
        if CAT_MIN_FREQ_KHZ <= freq_khz <= CAT_MAX_FREQ_KHZ:
            self.send_msg("\\set_freq %d" % (freq_khz * 1000))
            self.freq = freq_khz

    def set_mode(self, mode: str) -> None:
        self.send_msg("\\set_mode %s 2400" % mode)
        if self.reply:
            self.radio_mode = mode

    def close(self) -> None:
        if self.socket is not None:
            try:
                self.socket.close()
            except OSError:
                pass
            self.socket = None


class TunableRig(Protocol):
    """What the rigctld emulator needs from a receiver."""

    def get_frequency(self) -> float: ...          # kHz
    def get_mod(self) -> str: ...
    def get_lowcut(self) -> int: ...
    def get_highcut(self) -> int: ...
    def set_mod(self, mod: str, lc: int | None, hc: int | None,
                freq_khz: float) -> None: ...


def _dump_state() -> str:
    """The rig-capability table hamlib clients expect on connect
    (kiwi/rigctld.py:122-168 semantics: 0.1-30 MHz RX, AM/SSB/CW/FM)."""
    modes = "0x2f"
    lines = ["0", "2", "0",
             f"0.000000 30000000.000000 -1 -1 0x1 0x1",
             "0 0 0 0 0 0 0",
             "0 0 0 0 0 0 0"]
    for step in ("1", "100", "1000", "5000", "9000", "10000"):
        lines.append(f"{modes} {step}")
    lines += ["0 0", "0xc 2200", "0x2 500", "0x1 6000", "0x20 12000", "0 0",
              "0", "0", "0", "0", "", "", "0x0", "0x0", "0x0", "0x0",
              "0x0", "0x0", "vfo_ops=0x0", "ptt_type=0x0", "done"]
    return "\n".join(lines) + "\n"


class RigctldServer:
    """Non-blocking select-loop rigctld emulator. Call run() from a host
    loop (as kiwi/worker.py:46-47 interleaves it), or serve_forever() on a
    thread."""

    def __init__(self, rig: TunableRig, port: int = 6400,
                 address: str = "127.0.0.1"):
        self.rig = rig
        self._clients: list[socket.socket] = []
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.setblocking(False)
        s.bind((address, port))
        s.listen()
        self._server = s
        self.port = s.getsockname()[1]
        self._stop = threading.Event()

    def close(self) -> None:
        self._stop.set()
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass
        self._clients.clear()
        self._server.close()

    # long-form ↔ single-letter command aliases (real rigctld accepts both;
    # our CatClient sends the long forms, fldigi/wsjtx the short ones)
    _LONG_FORMS = {"\\get_freq": "f", "\\set_freq": "F", "\\get_mode": "m",
                   "\\set_mode": "M", "\\get_vfo": "v", "\\get_split_vfo": "s"}

    def _handle_command(self, sock: socket.socket, command: str) -> str:
        rig = self.rig
        for long, short in self._LONG_FORMS.items():
            if command.startswith(long):
                command = short + command[len(long):]
                break
        if command.startswith("\\get_ptt"):
            return "0\n"
        if command.startswith("q"):
            try:
                sock.send(b"RPRT 0\n")
                sock.close()
                self._clients.remove(sock)
            except (OSError, ValueError):
                pass
            return ""
        if command.startswith("\\chk_vfo"):
            return "0\n"
        if command.startswith("\\dump_state"):
            return _dump_state()
        if command.startswith("f"):
            return "%d\n" % int(rig.get_frequency() * 1000)
        if command.startswith("F"):
            try:
                freq_khz = float(command[1:].strip()) / 1000.0
                rig.set_mod(rig.get_mod(), rig.get_lowcut(), rig.get_highcut(),
                            freq_khz)
                return "RPRT 0\n"
            except (ValueError, AttributeError):
                return "RPRT -1\n"
        if command.startswith("m"):
            return "%s\n%d\n" % (rig.get_mod().upper(), rig.get_highcut())
        if command.startswith("M"):
            try:
                parts = command.split()
                mod = parts[1]
                hc = int(parts[2]) if len(parts) > 2 and parts[2].lstrip("-").isdigit() else None
                rig.set_mod(mod, None, hc, rig.get_frequency())
                return "RPRT 0\n"
            except (IndexError, ValueError, AttributeError):
                return "RPRT -1\n"
        if command.startswith("s"):
            return "0\nVFOA\n"
        if command.startswith("v"):
            return "VFOA\n"
        return "RPRT 0\n"

    def run(self) -> None:
        """One poll iteration: accept new clients, answer pending commands."""
        try:
            conn, _ = self._server.accept()
            conn.setblocking(True)
            self._clients.append(conn)
        except (BlockingIOError, OSError):
            pass
        # drop sockets already closed by close() racing this loop
        # (fileno() == -1 would make select() raise)
        self._clients = [s for s in self._clients if s.fileno() >= 0]
        if not self._clients:
            return
        try:
            readable, _, errored = select.select(list(self._clients), [],
                                                 list(self._clients), 0)
        except (ValueError, OSError):
            return
        for s in errored:
            try:
                s.close()
            finally:
                if s in self._clients:
                    self._clients.remove(s)
        for s in readable:
            try:
                buf = s.recv(4096).decode("ascii", errors="replace")
            except OSError:
                continue
            if not buf:
                try:
                    s.close()
                finally:
                    if s in self._clients:
                        self._clients.remove(s)
                continue
            reply = ""
            for line in buf.splitlines():
                if line:
                    reply += self._handle_command(s, line)
            if reply and s in self._clients:
                try:
                    s.send(reply.encode("ascii"))
                except OSError:
                    continue

    def serve_forever(self, poll_s: float = 0.01) -> None:
        import time
        while not self._stop.is_set():
            self.run()
            time.sleep(poll_s)
