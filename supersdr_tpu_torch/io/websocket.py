"""Minimal RFC 6455 WebSocket transport (client + server endpoints).

A from-scratch implementation of the subset the KiwiSDR protocol uses —
hybi-13 handshake, binary/text frames, client-side masking, ping/pong,
close, fragmentation — replacing the ~3,800 LoC vendored pywebsocket stack
the reference carries (SURVEY.md §2 row 10). Framing follows the public
RFC 6455 wire format.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

STATUS_GOING_AWAY = 1001


class ConnectionTerminated(ConnectionError):
    pass


class HandshakeError(ConnectionError):
    pass


def _apply_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR-mask per RFC 6455 §5.3 — native word-wise kernel when built,
    numpy otherwise."""
    try:
        from supersdr_tpu_torch import native
        if native.available():
            buf = bytearray(payload)
            native.xor_mask(buf, mask)
            return bytes(buf)
    except Exception:
        pass
    import numpy as np
    a = np.frombuffer(payload, np.uint8)
    m = np.frombuffer((mask * ((len(a) + 3) // 4))[: len(a)], np.uint8)
    return (a ^ m).tobytes()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionTerminated("socket closed mid-frame")
        buf += part
    return buf


def _read_http_head(sock: socket.socket) -> bytes:
    data = b""
    while b"\r\n\r\n" not in data:
        part = sock.recv(4096)
        if not part:
            raise HandshakeError("connection closed during handshake")
        data += part
        if len(data) > 65536:
            raise HandshakeError("oversized handshake")
    return data


class WebSocket:
    """A connected endpoint. Client endpoints mask outgoing frames
    (RFC 6455 §5.3); servers do not."""

    def __init__(self, sock: socket.socket, mask_send: bool):
        self.sock = sock
        self.mask_send = mask_send
        self._closed = False

    # -- send ------------------------------------------------------------

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        fin_op = 0x80 | opcode
        n = len(payload)
        if n < 126:
            header = struct.pack("!BB", fin_op, (0x80 if self.mask_send else 0) | n)
        elif n < 65536:
            header = struct.pack("!BBH", fin_op,
                                 (0x80 if self.mask_send else 0) | 126, n)
        else:
            header = struct.pack("!BBQ", fin_op,
                                 (0x80 if self.mask_send else 0) | 127, n)
        if self.mask_send:
            mask = os.urandom(4)
            masked = _apply_mask(payload, mask)
            self.sock.sendall(header + mask + masked)
        else:
            self.sock.sendall(header + payload)

    def send(self, message: bytes | str) -> None:
        if isinstance(message, str):
            self._send_frame(OP_TEXT, message.encode())
        else:
            self._send_frame(OP_BINARY, bytes(message))

    # -- receive ---------------------------------------------------------

    def _recv_frame(self) -> tuple[int, bool, bytes]:
        b1, b2 = struct.unpack("!BB", _recv_exact(self.sock, 2))
        fin = bool(b1 & 0x80)
        opcode = b1 & 0x0F
        masked = bool(b2 & 0x80)
        length = b2 & 0x7F
        if length == 126:
            (length,) = struct.unpack("!H", _recv_exact(self.sock, 2))
        elif length == 127:
            (length,) = struct.unpack("!Q", _recv_exact(self.sock, 8))
        mask = _recv_exact(self.sock, 4) if masked else None
        payload = _recv_exact(self.sock, length) if length else b""
        if mask:
            payload = _apply_mask(payload, mask)
        return opcode, fin, payload

    def receive(self) -> bytes | None:
        """Next data message (handles fragmentation and control frames).
        Returns None on a clean close."""
        if self._closed:
            return None
        assembled = b""
        while True:
            opcode, fin, payload = self._recv_frame()
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._closed = True
                try:
                    self._send_frame(OP_CLOSE, payload[:2])
                except OSError:
                    pass
                return None
            assembled += payload
            if fin:
                return assembled

    def close(self, status: int = STATUS_GOING_AWAY) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._send_frame(OP_CLOSE, struct.pack("!H", status))
            except OSError:
                pass
        try:
            self.sock.close()
        except OSError:
            pass


def client_handshake(sock: socket.socket, host: str, port: int,
                     resource: str) -> WebSocket:
    """Perform the client side of the upgrade; returns a masking endpoint.
    The KiwiSDR resource is '/<unix-timestamp>/<SND|W/F>'
    (utils_supersdr.py:962-965)."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (f"GET {resource} HTTP/1.1\r\n"
           f"Host: {host}:{port}\r\n"
           "Upgrade: websocket\r\n"
           "Connection: Upgrade\r\n"
           f"Sec-WebSocket-Key: {key}\r\n"
           "Sec-WebSocket-Version: 13\r\n\r\n")
    sock.sendall(req.encode())
    head = _read_http_head(sock)
    status_line = head.split(b"\r\n", 1)[0]
    if b"101" not in status_line:
        raise HandshakeError(f"upgrade refused: {status_line!r}")
    expect = base64.b64encode(
        hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"sec-websocket-accept:"):
            got = line.split(b":", 1)[1].strip().decode()
            if got != expect:
                raise HandshakeError("bad Sec-WebSocket-Accept")
            return WebSocket(sock, mask_send=True)
    raise HandshakeError("missing Sec-WebSocket-Accept")


def server_handshake(sock: socket.socket) -> tuple[WebSocket, str]:
    """Accept an upgrade request; returns (endpoint, resource_path)."""
    head = _read_http_head(sock)
    lines = head.split(b"\r\n")
    resource = lines[0].split(b" ")[1].decode()
    key = None
    for line in lines[1:]:
        if line.lower().startswith(b"sec-websocket-key:"):
            key = line.split(b":", 1)[1].strip().decode()
    if key is None:
        raise HandshakeError("no Sec-WebSocket-Key")
    accept = base64.b64encode(
        hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
    resp = ("HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept}\r\n\r\n")
    sock.sendall(resp.encode())
    return WebSocket(sock, mask_send=False), resource


def connect(host: str, port: int, resource: str,
            timeout: float | None = 10.0) -> WebSocket:
    sock = socket.create_connection((host, port), timeout=timeout)
    return client_handshake(sock, host, port, resource)
