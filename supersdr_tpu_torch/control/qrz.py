"""QRZ.com XML callsign lookup.

Behavior of the reference qrz_utils.py: key=value credentials file
(`qrz_settings.cfg`), session-key login to xmldata.qrz.com, callsign query
with one transparent re-login on session expiry, error taxonomy. Uses
stdlib ElementTree + urllib (no requests/xmltodict dependency); the
transport is injectable for tests."""

from __future__ import annotations

import os
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from pathlib import Path

QRZ_NS = "{http://xmldata.qrz.com}"


class QRZError(Exception):
    pass


class CallsignNotFound(QRZError):
    pass


class QRZSessionNotFound(QRZError):
    pass


class QRZMissingCredentials(QRZError):
    pass


def load_credentials(cfg_filename: str | Path) -> tuple[str | None, str | None]:
    username = password = None
    try:
        for row in Path(cfg_filename).read_text().splitlines():
            if "username" in row:
                username = row.split("=", 1)[1].rstrip()
            if "password" in row:
                password = row.split("=", 1)[1].rstrip()
    except OSError:
        pass
    return username, password


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def parse_response(content: bytes) -> tuple[dict, dict]:
    """XML → ({session fields}, {callsign fields})."""
    root = ET.fromstring(content)
    session, ham = {}, {}
    for child in root:
        name = _strip_ns(child.tag)
        target = session if name == "Session" else ham if name == "Callsign" else None
        if target is None:
            continue
        for el in child:
            target[_strip_ns(el.tag)] = (el.text or "").strip()
    return session, ham


class QRZ:
    def __init__(self, cfg_filename: str | Path = "qrz_settings.cfg",
                 fetch=None):
        self.username, self.password = load_credentials(cfg_filename)
        self._session_key: str | None = None
        self._fetch = fetch or self._default_fetch

    @staticmethod
    def _default_fetch(url: str) -> bytes:
        import ssl
        ctx = None
        if not bool(os.getenv("SSL_VERIFY", False)):
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        with urllib.request.urlopen(url, timeout=10, context=ctx) as r:
            return r.read()

    def _get_session(self) -> None:
        if not self.username or not self.password:
            raise QRZMissingCredentials("No Username/Password found")
        url = ("https://xmldata.qrz.com/xml/current/?username="
               f"{urllib.parse.quote(self.username)}&password="
               f"{urllib.parse.quote(self.password)}")
        session, _ = parse_response(self._fetch(url))
        self._session_key = session.get("Key")
        if not self._session_key:
            raise QRZSessionNotFound("Could not get QRZ session")

    def callsign(self, callsign: str, retry: bool = True) -> dict:
        if self._session_key is None:
            self._get_session()
        url = ("http://xmldata.qrz.com/xml/current/?s="
               f"{self._session_key}&callsign={urllib.parse.quote(callsign)}")
        session, ham = parse_response(self._fetch(url))
        error = session.get("Error")
        if error:
            if ("Session Timeout" in error or "Invalid session key" in error):
                if retry:
                    self._session_key = None
                    return self.callsign(callsign, retry=False)
            if "not found" in error.lower():
                raise CallsignNotFound(error)
            raise QRZError(error)
        if ham:
            return ham
        raise QRZError("Unhandled error during query")
