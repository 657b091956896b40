"""Write-ahead log with the reference's on-disk format.

Matches reference db/wal/write_ahead_log.hpp: per-table append-only
text logs at `{base}/{table_id}/wal/<epoch-seconds>.log`, each line
`"<global_id> <type> <json>\n"` with types INSERT=1 DELETE=2 UPSERT=3; 600 s
rotation, 7-day retention, `last_id.txt` persists the counter; leader-only
writes; replay applies entries with id > the segment's consumed wal_global_id.
WAL files written by the reference engine replay here unchanged.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, List, Optional, Tuple

from .logger import logger
from .utils import AtomicCounter, ensure_dir

ROTATION_INTERVAL_S = 600
LOG_RETENTION_S = 3600 * 24 * 7

INSERT = 1
DELETE = 2
UPSERT = 3
# Binary column-batch entries (this engine's extension; payload is a
# colcodec blob instead of JSON text — see colcodec.py). Text entries 1-3
# remain readable for logs written by the reference engine.
BIN_INSERT = 4
BIN_UPSERT = 5

BINARY_MAGIC = b"VWALBIN1"


class WriteAheadLog:
    def __init__(self, base_path: str, table_id: int, is_leader: bool):
        self.logs_folder = os.path.join(base_path, str(table_id), "wal")
        self.is_leader = is_leader
        self.enabled = True
        self.counter = AtomicCounter()
        self._file = None
        self._bin_file = None
        self._last_rotation = time.time()
        # One writer at a time: appends are header+payload pairs and
        # rotation swaps file handles (concurrent HTTP inserts otherwise
        # interleave frames and corrupt the log).
        self._write_lock = threading.Lock()
        # Native IO acceleration (C++ framing/fsync) when available.
        from .native import get_native
        self._native = get_native()

        id_path = os.path.join(self.logs_folder, "last_id.txt")
        if os.path.exists(id_path):
            try:
                with open(id_path, "r") as f:
                    self.counter.set_value(int(f.read().strip()))
            except (ValueError, OSError):
                pass
        if is_leader:
            ensure_dir(self.logs_folder)
            self._rotate()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._bin_file is not None:
            self._bin_file.close()
            self._bin_file = None
        if self.is_leader:
            self._save_last_id()

    def _save_last_id(self) -> None:
        ensure_dir(self.logs_folder)
        with open(os.path.join(self.logs_folder, "last_id.txt"), "w") as f:
            f.write(str(self.counter.get()))

    def _rotate(self) -> None:
        """Swap target paths; files open lazily on first write so a
        binary-mode table doesn't litter empty text .log files (and vice
        versa)."""
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._bin_file is not None:
            self._bin_file.close()
            self._bin_file = None
        ensure_dir(self.logs_folder)
        self._text_path = os.path.join(self.logs_folder,
                                       f"{int(time.time())}.log")
        self._bin_path = os.path.join(self.logs_folder,
                                      f"{int(time.time())}.blog")
        self._last_rotation = time.time()

    def _text_file(self):
        if self._file is None:
            self._file = open(self._text_path, "a", encoding="utf-8")
        return self._file

    def _binary_file(self):
        if self._bin_file is None:
            fresh = not os.path.exists(self._bin_path)
            self._bin_file = open(self._bin_path, "ab")
            if fresh:
                self._bin_file.write(BINARY_MAGIC)
                self._bin_file.flush()
        return self._bin_file

    def set_enabled(self, enabled: bool) -> None:
        self.enabled = enabled

    def writing(self) -> bool:
        """Whether an entry would be written: the log is enabled and this
        node leads."""
        return self.enabled and self.is_leader

    def set_leader(self, leader: bool) -> None:
        self.is_leader = leader
        if leader:
            self._rotate()

    def write_entry(self, entry_type: int, entry: str) -> int:
        """Append one entry; returns its global id (WriteEntry, wal:71-91)."""
        if not self.writing():
            return self.counter.get()
        with self._write_lock:
            if time.time() - self._last_rotation > ROTATION_INTERVAL_S:
                self._rotate()
            next_id = self.counter.increment_and_get()
            f = self._text_file()
            f.write(f"{next_id} {entry_type} {entry}\n")
            f.flush()
        return next_id

    def write_binary_entry(self, entry_type: int, payload: bytes) -> int:
        """Append a binary (colcodec) entry: CRC-framed, flushed. The
        native C++ appender handles framing+flush when built."""
        if not self.writing():
            return self.counter.get()
        with self._write_lock:
            if time.time() - self._last_rotation > ROTATION_INTERVAL_S:
                self._rotate()
            next_id = self.counter.increment_and_get()
            f = self._binary_file()
            if self._native is not None:
                f.flush()
                self._native.wal_append(f.fileno(), next_id, entry_type,
                                        payload)
            else:
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                f.write(struct.pack("<QBIQ", next_id, entry_type, crc,
                                    len(payload)) + payload)
                f.flush()
        return next_id

    def _sorted_log_files(self, ext: str = ".log") -> List[str]:
        if not os.path.isdir(self.logs_folder):
            return []
        files = [os.path.join(self.logs_folder, f)
                 for f in os.listdir(self.logs_folder) if f.endswith(ext)]
        return sorted(files)

    def _read_text_entries(self, path: str):
        out = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                first = line.find(" ")
                second = line.find(" ", first + 1)
                if first < 0 or second < 0:
                    continue
                try:
                    gid = int(line[:first])
                    etype = int(line[first + 1:second])
                except ValueError:
                    # Torn/corrupted line (e.g. partial write before a
                    # crash): skip it, matching the reference's lenient
                    # atoll parsing (write_ahead_log.hpp:187-197).
                    logger.error("Skipping unparseable WAL line in " + path)
                    continue
                out.append((gid, etype, line[second + 1:]))
        return out

    def _read_binary_entries(self, path: str):
        out = []
        with open(path, "rb") as f:
            if f.read(len(BINARY_MAGIC)) != BINARY_MAGIC:
                logger.error("Bad binary WAL magic: " + path)
                return out
            while True:
                head = f.read(21)
                if len(head) < 21:
                    break
                gid, etype, crc, plen = struct.unpack("<QBIQ", head)
                payload = f.read(plen)
                if len(payload) < plen:
                    logger.error("Truncated binary WAL entry in " + path)
                    break
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    logger.error("CRC mismatch in binary WAL " + path)
                    break
                out.append((gid, etype, payload))
        return out

    def replay(self, apply_entry: Callable[[int, int, object], None],
               consumed_id: int) -> None:
        """Re-apply entries with id > consumed_id (Replay, wal:93-142).

        apply_entry(global_id, entry_type, content) — content is a JSON str
        for text entries (types 1-3) or a colcodec bytes payload for binary
        entries (types 4-5). Text and binary logs are merged by global id.
        """
        per_file: List[Tuple[str, List]] = []
        for path in self._sorted_log_files(".log"):
            try:
                per_file.append((path, self._read_text_entries(path)))
            except OSError as e:
                logger.error("Error reading WAL file " + path + ": " + str(e))
        for path in self._sorted_log_files(".blog"):
            try:
                per_file.append((path, self._read_binary_entries(path)))
            except OSError as e:
                logger.error("Error reading WAL file " + path + ": " + str(e))

        entries = []
        for path, ents in per_file:
            entries.extend(ents)
            for gid, _, _ in ents:
                self.counter.set_if_greater(gid)
        entries.sort(key=lambda e: e[0])
        for gid, etype, content in entries:
            if gid <= consumed_id:
                continue
            try:
                apply_entry(gid, etype, content)
            except Exception as e:  # match reference: log & continue
                logger.error("Fail to apply wal entry: " + str(e))

        if self.is_leader:
            # Drop fully-consumed files (all but the most recent of each
            # kind, mirroring the reference's keep-last behavior).
            for kind in (".log", ".blog"):
                files = self._sorted_log_files(kind)
                for path in files[:-1]:
                    ents = next((e for p, e in per_file if p == path), [])
                    if all(g <= consumed_id for g, _, _ in ents):
                        try:
                            os.remove(path)
                        except OSError:
                            pass
            self._save_last_id()

    def clean_up_old_files(self) -> None:
        now = time.time()
        for path in (self._sorted_log_files(".log")
                     + self._sorted_log_files(".blog")):
            stem = os.path.splitext(os.path.basename(path))[0]
            try:
                ts = int(stem)
            except ValueError:
                continue
            if now - ts > LOG_RETENTION_S:
                try:
                    os.remove(path)
                except OSError:
                    pass
            else:
                break


def encode_delete_entry(pks: List, filter_str: str) -> str:
    return json.dumps({"pk": pks, "filter": filter_str})


def decode_delete_entry(content: str):
    """DELETE entries: new format {'pk': [...], 'filter': '...'} or legacy
    bare pk array (ApplyEntry, wal:187-237)."""
    obj = json.loads(content)
    if isinstance(obj, dict):
        return obj.get("pk", []), obj.get("filter", "")
    return obj, ""
