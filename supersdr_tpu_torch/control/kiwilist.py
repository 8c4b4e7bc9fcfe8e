"""KiwiSDR server book: `kiwi.list` CSV persistence.

Behavior of `kiwi_list` (utils_supersdr.py:394-453):
semicolon-separated file with a KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS
header, '#' comment lines, append-on-save with 'host:port:password' input
normalization."""

from __future__ import annotations

from pathlib import Path

DEFAULT_PORT = 8073
HEADER = "KIWIHOST;KIWIPORT;KIWIPASSWORD;COMMENTS\n"


class KiwiList:
    def __init__(self, path: str | Path = "kiwi.list"):
        self.path = Path(path)
        self.servers: list[tuple[str, int, str, str]] = []
        self.load_from_disk()

    def load_from_disk(self) -> None:
        self.servers = []
        try:
            lines = self.path.read_text(encoding="latin-1").splitlines()
        except OSError:
            return
        for row in lines[1:]:
            if not row or row[0] == "#":
                continue
            fields = row.rstrip().split(";")
            host = fields[0]
            if not host:
                continue
            try:
                port = int(fields[1])
            except (IndexError, ValueError):
                port = DEFAULT_PORT
            password = fields[2] if len(fields) > 2 else ""
            comments = fields[3] if len(fields) > 3 else ""
            self.servers.append((host, port, password, comments))

    def add(self, entry: str, comments: str = "") -> None:
        """Add 'host[:port[:password]]' and persist (append semantics,
        utils:409-427)."""
        parts = entry.split(":")
        host = parts[0]
        port = int(parts[1]) if len(parts) > 1 and parts[1] else DEFAULT_PORT
        password = parts[2] if len(parts) > 2 else ""
        new_file = not self.path.exists() or not self.path.read_text(
            encoding="latin-1").strip()
        with self.path.open("a", encoding="latin-1") as fd:
            if new_file:
                fd.write(HEADER)
            fd.write(f"{host};{port};{password};{comments}\n")
        self.load_from_disk()

    def __iter__(self):
        return iter(self.servers)

    def __len__(self):
        return len(self.servers)
