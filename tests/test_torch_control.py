"""The port's copies of the reference's session-preference modules —
`control/{memories, logbook, dxcluster, kiwilist, qrz}` — on the cases of
tests/test_control.py, plus the files each package writes read by the
other, the cluster's ingest loop over a local socket pair and the QRZ
client over an injected fetch. Nothing here opens a network connection."""

import socket
import threading
from datetime import datetime, timezone

import pytest

from supersdr_tpu.control import kiwilist as jkiwilist
from supersdr_tpu.control import logbook as jlogbook
from supersdr_tpu.control import memories as jmemories
from supersdr_tpu.control import qrz as jqrz
from supersdr_tpu_torch.control import dxcluster, qrz
from supersdr_tpu_torch.control.kiwilist import KiwiList
from supersdr_tpu_torch.control.logbook import QSO, Logbook
from supersdr_tpu_torch.control.memories import MemoryBank

SPOT_LINES = (
    "DX de EA5XYZ:    14025.0  W1AW         CW 25 dB                  1200Z\n"
    "DX de DL1ABC:     7074.0  IK2XYZ       FT8                       1201Z\n"
)


# -------------------------------------------------------------- memories

def test_memory_bank_cycle(tmp_path):
    m = MemoryBank(tmp_path / "mem.json")
    for f in (7040, 14200, 3573):
        m.write_mem(f, "USB", 0, 0)
    assert len(m) == 3
    seen = {m.recall_mem()[0] for _ in range(6)}
    assert seen == {7040, 14200, 3573}
    m.save_to_disk()
    m2 = MemoryBank(tmp_path / "mem.json")
    m2.load_from_disk()
    assert len(m2) == 3


def test_memory_depth_limit(tmp_path):
    m = MemoryBank(tmp_path / "mem.json")
    for i in range(15):
        m.write_mem(7000 + i, "LSB", 0, 0)
    assert len(m) == 10  # cyclic 10-deep


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_memory_file_is_shared_with_the_reference(writer, tmp_path):
    make = {"reference": jmemories.MemoryBank, "port": MemoryBank}
    other = make["port" if writer == "reference" else "reference"]
    m = make[writer](tmp_path / "mem.json")
    for f, mode in ((7040, "LSB"), (14200, "USB"), (10100, "CW")):
        m.write_mem(f, mode, -100, 200)
    m.save_to_disk()
    back = other(tmp_path / "mem.json")
    back.load_from_disk()
    assert len(back) == 3
    assert [back.recall_mem() for _ in range(3)] == \
        [m.recall_mem() for _ in range(3)]


# ------------------------------------------------------------- dxcluster

def test_dxcluster_feed_and_query():
    dx = dxcluster.DxCluster("TEST0CALL")
    n = dx.feed(SPOT_LINES)
    assert n == 2
    vis = dx.get_stations(14000, 14350)
    assert len(vis) == 1
    call, qrg, utc, spotter = dx.spot(vis[0])
    assert call == "W1AW" and qrg == 14025.0 and spotter == "EA5XYZ"


def test_dxcluster_dedup_keeps_newest():
    dx = dxcluster.DxCluster("TEST0CALL")
    old = datetime(2026, 1, 1, 10, 0, tzinfo=timezone.utc)
    new = datetime(2026, 1, 1, 10, 5, tzinfo=timezone.utc)
    dx.feed("DX de AA1AA:    14020.0  W1AW         CW\n", now=old)
    dx.feed("DX de BB1BB:    14022.0  W1AW         CW\n", now=new)
    vis = dx.get_stations(14000, 14350)
    assert len(vis) == 1
    assert dx.spot(vis[0])[3] == "BB1BB"


def test_dxcluster_ttl_expiry():
    dx = dxcluster.DxCluster("TEST0CALL")
    old = datetime(2026, 1, 1, 8, 0, tzinfo=timezone.utc)
    dx.feed(SPOT_LINES, now=old)
    dx.clean_old_spots(datetime(2026, 1, 1, 10, 0, tzinfo=timezone.utc))
    assert len(dx.spot_dict) == 0


def test_age_colors():
    assert dxcluster.age_color(0) == "green"
    assert dxcluster.age_color(700) == "yellow"
    assert dxcluster.age_color(2500) == "grey"


def test_dxcluster_needs_a_callsign():
    with pytest.raises(ValueError):
        dxcluster.DxCluster("")


def test_dxcluster_run_loop_over_a_local_socket_pair():
    """The ingest thread logs in with the callsign, stores the spots the
    'server' end sends and refreshes the visible list; disconnect ends
    it. A socket pair stands in for the cluster: no network."""
    ours, server = socket.socketpair()
    dx = dxcluster.DxCluster("TEST0CALL", sock=ours)
    th = threading.Thread(target=dx.run, kwargs=dict(
        span_provider=lambda: (14000, 14350), poll_timeout=0.05),
        daemon=True)
    th.start()
    server.settimeout(5)
    assert server.recv(64) == b"TEST0CALL\n"
    server.sendall(SPOT_LINES.encode())
    for _ in range(100):
        if len(dx.spot_dict) == 2 and dx.visible_stations:
            break
        threading.Event().wait(0.05)
    assert len(dx.spot_dict) == 2
    assert [dx.spot(s)[0] for s in dx.visible_stations] == ["W1AW"]
    dx.disconnect()
    th.join(timeout=5)
    assert not th.is_alive()
    server.close()


# -------------------------------------------------------------- kiwilist

def test_kiwilist_roundtrip(tmp_path):
    path = tmp_path / "kiwi.list"
    kl = KiwiList(path)
    assert len(kl) == 0
    kl.add("kiwi.example.com:8074:pass", comments="fast one")
    kl.add("other.example.com")
    assert len(kl) == 2
    assert kl.servers[0] == ("kiwi.example.com", 8074, "pass", "fast one")
    assert kl.servers[1] == ("other.example.com", 8073, "", "")
    kl2 = KiwiList(path)
    assert kl2.servers == kl.servers


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_kiwilist_file_is_shared_with_the_reference(writer, tmp_path):
    make = {"reference": jkiwilist.KiwiList, "port": KiwiList}
    other = make["port" if writer == "reference" else "reference"]
    kl = make[writer](tmp_path / "kiwi.list")
    kl.add("kiwi.example.com:8074:pass", comments="fast one")
    kl.add("other.example.com")
    assert other(tmp_path / "kiwi.list").servers == kl.servers


# --------------------------------------------------------------- logbook

def test_logbook(tmp_path):
    lb = Logbook(tmp_path / "log.sdr")
    lb.add(QSO(callsign="W1AW", freq_khz=14025.0, mode="CW"))
    lb.add(QSO(callsign="IK2ABC", freq_khz=7074.0, mode="FT8",
               comment="nice sig"))
    lb2 = Logbook(tmp_path / "log.sdr")
    assert len(lb2) == 2
    hits = lb2.search("ik2")
    assert len(hits) == 1 and hits[0].freq_khz == 7074.0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_logbook_file_is_shared_with_the_reference(writer, tmp_path):
    make = {"reference": (jlogbook.Logbook, jlogbook.QSO),
            "port": (Logbook, QSO)}
    book, qso = make[writer]
    other = make["port" if writer == "reference" else "reference"][0]
    lb = book(tmp_path / "log.sdr")
    lb.add(qso(callsign="W1AW", freq_khz=14025.0, mode="CW"))
    lb.add(qso(callsign="IK2ABC", freq_khz=7074.0, mode="FT8",
               comment="nice sig"))
    back = other(tmp_path / "log.sdr")
    assert len(back) == 2
    assert [(q.callsign, q.freq_khz, q.mode, q.comment)
            for q in back.search("")] == \
        [(q.callsign, q.freq_khz, q.mode, q.comment) for q in lb.search("")]


# ------------------------------------------------------------------- qrz

_NS = "http://xmldata.qrz.com"


def _xml(session: dict, ham: dict | None = None) -> bytes:
    s = "".join(f"<{k}>{v}</{k}>" for k, v in session.items())
    h = ("<Callsign>" + "".join(f"<{k}>{v}</{k}>" for k, v in ham.items())
         + "</Callsign>") if ham else ""
    return (f'<?xml version="1.0"?><QRZDatabase xmlns="{_NS}">'
            f"<Session>{s}</Session>{h}</QRZDatabase>").encode()


class _Fetch:
    """The QRZ service as a script of responses; records the URLs asked."""

    def __init__(self, *responses):
        self.responses = list(responses)
        self.urls = []

    def __call__(self, url):
        self.urls.append(url)
        return self.responses.pop(0)


@pytest.fixture
def creds(tmp_path):
    p = tmp_path / "qrz_settings.cfg"
    p.write_text("username=N0CALL\npassword=s3cret\n")
    return p


@pytest.mark.parametrize("mod", [jqrz, qrz], ids=["reference", "port"])
def test_qrz_lookup_with_session_retry(mod, creds):
    """A timed-out session key is renewed once; the callsign's fields come
    back; both packages ask the same URLs."""
    fetch = _Fetch(_xml({"Key": "k1"}), _xml({"Error": "Session Timeout"}),
                   _xml({"Key": "k2"}),
                   _xml({"Key": "k2"}, {"call": "W1AW", "fname": "Hiram"}))
    q = mod.QRZ(creds, fetch=fetch)
    assert q.callsign("W1AW") == {"call": "W1AW", "fname": "Hiram"}
    assert len(fetch.urls) == 4
    assert "username=N0CALL&password=s3cret" in fetch.urls[0]
    assert fetch.urls[3].endswith("s=k2&callsign=W1AW")


@pytest.mark.parametrize("mod", [jqrz, qrz], ids=["reference", "port"])
def test_qrz_errors(mod, creds, tmp_path):
    with pytest.raises(mod.QRZMissingCredentials):
        mod.QRZ(tmp_path / "absent.cfg", fetch=_Fetch()).callsign("W1AW")
    q = mod.QRZ(creds, fetch=_Fetch(_xml({"Key": "k"}),
                                    _xml({"Error": "Not found: ZZ9ZZZ"})))
    with pytest.raises(mod.CallsignNotFound):
        q.callsign("ZZ9ZZZ")
    q = mod.QRZ(creds, fetch=_Fetch(_xml({})))
    with pytest.raises(mod.QRZSessionNotFound):
        q.callsign("W1AW")
