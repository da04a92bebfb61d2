"""Sharded append-only feedback log: the serve→train data bridge.

The port's copy of ``cxxnet_tpu/loop/feedback_log.py``: shards, commit
sidecars, the sequence reservation, the cursor file and the retention
boundary are byte for byte the JAX package's, so either package tails
the other's log.  The closed loop's durability layer: the
serve front-end appends ``(input, label)`` records here, and the
continuous trainer tails them through a persisted cursor.  The on-disk
page layout is imgbin's native ``CXBP`` format (``io/imgbin.py`` — the
same magic/header/length-table byte layout ``iter_cxbp_pages`` reads),
so a full shard can be read back or repacked into a training set with
the existing imgbin tooling.  What this module adds on top is the
**commit protocol** an always-on serving process needs:

* **atomic page commits** — records buffer in RAM until a page fills
  (``page_bytes``) or :meth:`FeedbackWriter.flush` is called; the page
  bytes are appended to the shard and fsynced, and only THEN is the
  page's ``{offset, bytes, crc32, nrec, seq0}`` entry appended (and
  fsynced) to the ``.commit`` JSONL sidecar.  A crash mid-append leaves
  a trailing torn page that no sidecar entry references — readers never
  observe it;
* **lineage sequence ids** — every appended record gets a log-wide id
  (assigned at append, never reused); a page's ``seq0`` anchors the
  contiguous range ``[seq0, seq0 + nrec)`` it holds, so the publish
  pointer can name exactly which records trained a served model;
* **CRC sidecars** — every committed page carries its CRC32; the reader
  verifies before parsing, and a mismatching page (bit rot, torn
  sidecar replay) is skipped and counted, never served to the trainer;
* **rotation by size** — a shard exceeding ``rotate_bytes`` is closed
  and ``feedback-NNNNNN.bin`` rolls to the next index, so retention can
  prune whole shards without touching the live tail;
* **tailing reader + cursor** — :meth:`FeedbackReader.read_since`
  returns every record committed after a ``(shard, offset)`` cursor;
  :class:`CursorFile` persists the cursor atomically so the trainer
  resumes where it left off across restarts;
* **degrade-don't-fail appends** — the ``loop.append`` fault-injection
  site fires per append; an I/O failure (injected or real) DROPS the
  record and bumps ``loop_feedback_dropped_total`` instead of failing
  the serving request (``drop_on_error=True``, the serving default).

Record encoding (one CXBP blob)::

    u32 nlabel | f4*nlabel labels | u16 h,w,c,pad | f4*h*w*c input

The input tail is exactly ``io.imgbin.encode_raw`` so the blob's data
part round-trips through ``ImageBinIterator._decode_raw``.
"""

from __future__ import annotations

import errno
import json
import os
import re
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io.imgbin import PAGE_MAGIC, encode_raw
from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from ..utils import diskio, faults

__all__ = [
    "FeedbackRecord",
    "FeedbackWriter",
    "FeedbackReader",
    "CursorFile",
    "StaleCursorError",
    "encode_record",
    "decode_record",
    "loop_metrics",
    "read_retention",
]

SHARD_RE = re.compile(r"feedback-(\d{6})\.bin$")
COMMIT_SUFFIX = ".commit"
SEQ_FILE = "seq.json"
#: retention pointer (loop/retention.py): ``{"compacted_below": k}``
#: means every shard with index < k has been compacted away — the
#: pointer is fsynced BEFORE any unlink, so a crash mid-compaction
#: leaves orphan files below the boundary (ignored by readers, deleted
#: by the next sweep) instead of a boundary that lies
RETENTION_FILE = "retention.json"
#: lineage ids are handed out from durably RESERVED blocks: one atomic
#: sidecar write reserves this many ids ahead, so an id acknowledged to
#: a /feedback client can never be reassigned after a crash (the
#: unassigned remainder of a block becomes a gap, which readers
#: tolerate) at a cost of one fsynced write per block, not per append
SEQ_RESERVE_BLOCK = 1 << 16


class _LoopMetrics:
    """Process-wide registry families for the closed loop (lazy, shared
    by the writer, reader, continuous trainer, and publisher)."""

    def __init__(self) -> None:
        reg = obs_registry()
        self.appended = reg.counter(
            "loop_feedback_records_total",
            "Feedback records durably committed to the log.")
        self.dropped = reg.counter(
            "loop_feedback_dropped_total",
            "Feedback records dropped on append/commit failure "
            "(degrade-don't-fail).")
        self.bad_pages = reg.counter(
            "loop_feedback_bad_pages_total",
            "Committed pages skipped by the reader (CRC mismatch / "
            "unreadable).")
        self.cycles = reg.counter(
            "loop_cycles_total",
            "Continuous-training cycles by outcome: trained / idle.",
            labelnames=("outcome",),
        )
        self.publishes = reg.counter(
            "loop_publish_total",
            "Eval-gate decisions: published / rejected / rollback.",
            labelnames=("decision",),
        )
        self.pending = reg.gauge(
            "loop_feedback_pending_records",
            "Records committed but not yet consumed by the trainer "
            "cursor (set at each cycle).")


_METRICS: Optional[_LoopMetrics] = None
_METRICS_LOCK = threading.Lock()


def loop_metrics() -> _LoopMetrics:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = _LoopMetrics()
        return _METRICS


class FeedbackRecord:
    """One decoded (input, labels) feedback instance.

    ``seq`` is the record's log-wide sequence id (lineage): assigned at
    append time, durably recorded per page as the commit entry's
    ``seq0``, and stamped through the training cycle into the publish
    pointer so ``PUBLISHED.json`` can name the exact records that
    trained a served model.  ``None`` for pages committed before the
    lineage format (legacy sidecars without ``seq0``)."""

    __slots__ = ("data", "labels", "seq")

    def __init__(self, data: np.ndarray, labels: np.ndarray,
                 seq: Optional[int] = None) -> None:
        self.data = data
        self.labels = labels
        self.seq = seq


def encode_record(data, labels) -> bytes:
    """Encode one instance: label vector + raw-pixel input blob."""
    arr = np.ascontiguousarray(data, np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, 1, -1)
    if arr.ndim != 3:
        raise ValueError(
            f"feedback input must be a (H, W, C) or flat row, got shape "
            f"{arr.shape}")
    lab = np.atleast_1d(np.asarray(labels, np.float32)).reshape(-1)
    return (struct.pack("<I", lab.shape[0]) + lab.tobytes()
            + encode_raw(arr))


def decode_record(blob) -> FeedbackRecord:
    """Inverse of :func:`encode_record` (raises on truncation)."""
    blob = bytes(blob)
    (nlabel,) = struct.unpack_from("<I", blob)
    off = 4 + 4 * nlabel
    labels = np.frombuffer(blob, "<f4", count=nlabel, offset=4).copy()
    h, w, c = struct.unpack_from("<HHH", blob, off)
    data = np.frombuffer(blob, "<f4", offset=off + 8).reshape(h, w, c)
    return FeedbackRecord(data.copy(), labels)


class StaleCursorError(RuntimeError):
    """A reader's cursor points into a shard that retention compacted
    away: the records it expects are GONE, and silently skipping ahead
    would hand the trainer a hole it can never audit.  The holder must
    decide — re-baseline the cursor (a fresh consumer) or treat the
    loss as fatal (a consumer that believed it was caught up)."""

    def __init__(self, cursor: Dict, compacted_below: int,
                 dir_: str) -> None:
        super().__init__(
            f"cursor {cursor} points into a compacted shard of {dir_}: "
            f"every shard below index {compacted_below} was deleted by "
            "retention (records behind the consumed-and-published "
            "cursor); re-baseline the cursor or restore the log")
        self.cursor = dict(cursor)
        self.compacted_below = int(compacted_below)
        self.dir = dir_


def read_retention(dir_: str) -> Dict:
    """The retention pointer: ``{"compacted_below": 0, ...}`` when the
    log was never compacted (or the pointer is unreadable — a missing
    pointer can only UNDER-report the boundary, never invent one)."""
    try:
        with open(os.path.join(dir_, RETENTION_FILE), "r",
                  encoding="utf-8") as f:
            ret = json.load(f)
        if isinstance(ret, dict) and isinstance(
                ret.get("compacted_below"), int):
            return ret
    except (OSError, ValueError):
        pass
    return {"compacted_below": 0}


def _shard_path(dir_: str, idx: int) -> str:
    return os.path.join(dir_, f"feedback-{idx:06d}.bin")


def list_shards(dir_: str) -> List[Tuple[int, str]]:
    """All shard files in the log directory, sorted by index."""
    try:
        names = os.listdir(dir_)
    except OSError:
        return []
    out = []
    for n in names:
        m = SHARD_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_, n)))
    return sorted(out)


def _read_commits_full(shard_path: str) -> Tuple[List[Dict], int]:
    """Committed-page entries of one shard, plus the sidecar byte length
    they cover (the **clean length**).

    A commit entry counts only when its line is newline-TERMINATED and
    parses with the full schema: the trailing newline is part of the
    fsynced commit record, so a line missing it was torn mid-write and
    never acknowledged — its page is simply uncommitted.  Parsing stops
    at the first bad line (nothing after a tear is trustworthy); the
    clean length is where a recovering writer must truncate before
    appending, so a torn partial line can never fuse with the next
    entry into one unparseable line that hides every commit after it
    (the crash-audit ``torn-commit-sidecar-append`` regression).
    """
    out: List[Dict] = []
    clean_len = 0
    try:
        with open(shard_path + COMMIT_SUFFIX, "rb") as f:
            raw = f.read()
    except OSError:
        return out, 0
    pos = 0
    while pos < len(raw):
        nl = raw.find(b"\n", pos)
        if nl < 0:
            break  # unterminated tail: torn mid-line
        line = raw[pos:nl].strip()
        pos = nl + 1
        if not line:
            clean_len = pos
            continue
        try:
            ent = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            break
        if isinstance(ent, dict) and {"off", "bytes", "crc32",
                                      "nrec"} <= set(ent):
            out.append(ent)
            clean_len = pos
        else:
            break
    return out, clean_len


def _read_commits(shard_path: str) -> List[Dict]:
    """Committed-page entries of one shard (see
    :func:`_read_commits_full` for the torn-tail rules)."""
    return _read_commits_full(shard_path)[0]


class FeedbackWriter:
    """Thread-safe append side of the log (the serve front-end's handle).

    Appends buffer in RAM; a page is committed when the buffer reaches
    ``page_bytes`` or on :meth:`flush`.  With ``drop_on_error`` (the
    serving default) any I/O failure — injected via the ``loop.append``
    chaos site or real — drops the affected records and counts them in
    ``loop_feedback_dropped_total`` instead of propagating, so a sick
    disk degrades feedback capture without failing predict traffic.
    """

    def __init__(
        self,
        dir_: str,
        page_bytes: int = 1 << 20,
        rotate_bytes: int = 8 << 20,
        fsync: bool = True,
        drop_on_error: bool = True,
    ) -> None:
        self.dir = dir_
        self.page_bytes = int(page_bytes)
        self.rotate_bytes = int(rotate_bytes)
        self.fsync = fsync
        self.drop_on_error = drop_on_error
        self._lock = threading.Lock()
        self._blobs: List[bytes] = []
        self._cur = 0
        self._m = loop_metrics()
        self.appended = 0  # records durably committed
        self.dropped = 0
        os.makedirs(dir_, exist_ok=True)
        shards = list_shards(dir_)
        # resume at the last shard's committed length (a torn tail past
        # it is dead bytes; truncate so offsets stay contiguous); never
        # resume BELOW the retention boundary — if every shard was
        # compacted away, reusing index 0 would put new records behind
        # the boundary where readers must ignore them
        self._shard_idx = max(
            shards[-1][0] if shards else 0,
            read_retention(dir_)["compacted_below"])
        self._f = None
        # lineage: the next record sequence id, resumed past everything
        # ever ASSIGNED — the committed pages' coverage AND the durable
        # reservation sidecar, so ids acknowledged for records that were
        # still buffered at a crash are never reused (they become a gap)
        self._seq_next = self._resume_seq(self.dir, shards)
        self._seq_reserved = self._seq_next
        self._open_shard(truncate_torn=True)

    @staticmethod
    def _resume_seq(dir_: str, shards: List[Tuple[int, str]]) -> int:
        seq = 0
        for _idx, path in shards:
            for ent in _read_commits(path):
                s0 = ent.get("seq0")
                end = (int(s0) + int(ent["nrec"]) if s0 is not None
                       else seq + int(ent["nrec"]))
                seq = max(seq, end)
        try:
            with open(os.path.join(dir_, SEQ_FILE), "r",
                      encoding="utf-8") as f:
                reserved = json.load(f).get("reserved")
            if isinstance(reserved, int):
                seq = max(seq, reserved)
        except (OSError, ValueError, AttributeError):
            pass
        return seq

    def _reserve_seq_locked(self) -> bool:
        """Make sure ``_seq_next`` lies inside a durably reserved block
        (one atomic fsynced write per ``SEQ_RESERVE_BLOCK`` ids).  False
        when the reservation cannot be persisted — the caller must then
        drop rather than hand out an id a restart could reuse."""
        if self._seq_next < self._seq_reserved:
            return True
        from ..utils.checkpoint import atomic_write_bytes

        limit = self._seq_next + SEQ_RESERVE_BLOCK
        try:
            atomic_write_bytes(
                os.path.join(self.dir, SEQ_FILE),
                json.dumps({"reserved": limit}).encode("utf-8"))
        except OSError:
            return False
        self._seq_reserved = limit
        return True

    # ------------------------------------------------------------------
    def _open_shard(self, truncate_torn: bool = False) -> None:
        path = _shard_path(self.dir, self._shard_idx)
        commits, clean_len = _read_commits_full(path)
        committed_end = (commits[-1]["off"] + commits[-1]["bytes"]
                         if commits else 0)
        if truncate_torn:
            # a torn trailing sidecar line must go BEFORE we append the
            # next entry: appending onto a half-written line would fuse
            # them into one unparseable line, and since commit parsing
            # stops at the first bad line, every commit after it would
            # silently vanish (committed records lost)
            cpath = path + COMMIT_SUFFIX
            try:
                if os.path.getsize(cpath) > clean_len:
                    diskio.truncate(cpath, clean_len)
            except OSError:
                pass
        self._f = diskio.open_append(path)
        if truncate_torn and self._f.tell() > committed_end:
            self._f.truncate(committed_end)
            self._f.seek(committed_end)
        self._off = self._f.tell()

    def _rotate_locked(self) -> None:
        self._f.close()
        self._shard_idx += 1
        self._open_shard()

    def append(self, data, labels) -> int:
        """Buffer one record; returns 1, or 0 when it was dropped
        (``drop_on_error``).  Encoding errors (bad shapes) always
        raise — they are caller bugs, not I/O weather."""
        return 1 if self.append_seq(data, labels) is not None else 0

    def append_seq(self, data, labels) -> Optional[int]:
        """Buffer one record and return its lineage sequence id, or
        ``None`` when the record was dropped.  Ids are assigned at
        append time and never reused — a page lost to a commit failure
        leaves a gap, which readers tolerate (ranges come from each
        committed page's ``seq0``)."""
        blob = encode_record(data, labels)
        with self._lock:
            return self._append_blob_locked(blob)

    def _append_blob_locked(self, blob: bytes) -> Optional[int]:
        """Buffer one encoded record under the writer lock (a hang/IO
        fault at the ``loop.append`` site therefore holds the lock —
        exactly what a sick disk would do, since page commits run under
        it too)."""
        try:
            faults.fault_point("loop.append")
            if not self._reserve_seq_locked():
                raise OSError(
                    "cannot persist the lineage id reservation "
                    f"({SEQ_FILE}); refusing to hand out a reusable id")
        except OSError as e:
            if not self.drop_on_error:
                raise
            self._drop_locked(1, e)
            return None
        seq = self._seq_next
        self._seq_next += 1
        self._blobs.append((blob, seq))
        self._cur += len(blob) + 4
        if self._cur + 8 >= self.page_bytes:
            self._commit_page_locked()
        return seq

    def append_batch(self, data, labels) -> int:
        """Append N instances; returns how many were accepted."""
        return self.append_batch_ids(data, labels)[0]

    def append_batch_ids(
        self, data, labels
    ) -> Tuple[int, Optional[int], Optional[int]]:
        """Append N instances; returns ``(accepted, first_seq,
        last_seq)`` — the id range the serve front-end hands back to the
        ``/feedback`` caller (``None``s when every record dropped).
        The whole batch is appended under ONE lock hold, so the range
        covers exactly this caller's records even when concurrent
        ``/feedback`` handlers interleave (per-record locking would let
        another request's ids land inside the reported range)."""
        data = np.asarray(data)
        labels = np.asarray(labels)
        if labels.ndim == 1:
            labels = labels[:, None]
        if data.shape[0] != labels.shape[0]:
            raise ValueError(
                f"feedback batch: {data.shape[0]} rows vs "
                f"{labels.shape[0]} labels")
        blobs = [encode_record(data[i], labels[i])
                 for i in range(data.shape[0])]
        n, first, last = 0, None, None
        with self._lock:
            for blob in blobs:
                seq = self._append_blob_locked(blob)
                if seq is None:
                    continue
                n += 1
                first = seq if first is None else first
                last = seq
        return n, first, last

    def _drop_locked(self, nrec: int, exc: BaseException) -> None:
        """Account a degrade-drop; the caller holds the writer lock
        (the metrics/event sinks take their own locks)."""
        self.dropped += nrec
        self._m.dropped.inc(nrec)
        if getattr(exc, "errno", None) == errno.ENOSPC:
            # disk-full is its own paging alert, not just a drop stat
            diskio.count_disk_full("loop.append", self.dir)
        obs_events.log_exception_once(
            "loop.append", exc, kind="loop.append_error", dropped=nrec)

    def _commit_page_locked(self) -> int:
        """Write the buffered page + its commit entry.  Returns the
        record count committed (0 after a degrade-drop)."""
        if not self._blobs:
            return 0
        blobs, self._blobs, self._cur = self._blobs, [], 0
        page = bytearray(struct.pack("<II", PAGE_MAGIC, len(blobs)))
        for b, _seq in blobs:
            page += struct.pack("<I", len(b))
        for b, _seq in blobs:
            page += b
        page = bytes(page)
        try:
            self._f.write(page, site="loop.commit")
            self._f.flush()
            if self.fsync:
                self._f.fsync()
            # seq0 is the page's lineage anchor: buffered records are
            # committed in append order, so the page covers exactly
            # [seq0, seq0 + nrec) — readers reconstruct per-record ids
            ent = {"off": self._off, "bytes": len(page),
                   "crc32": zlib.crc32(page) & 0xFFFFFFFF,
                   "nrec": len(blobs), "seq0": blobs[0][1]}
            cpath = (_shard_path(self.dir, self._shard_idx)
                     + COMMIT_SUFFIX)
            line = json.dumps(ent, separators=(",", ":")) + "\n"
            diskio.append_bytes(cpath, line.encode("utf-8"),
                                fsync=self.fsync, site="loop.commit")
        except OSError as e:
            # degrade: the page (and its records) are lost, serving
            # is not.  Reopen at the committed tail so the next page
            # starts on a clean offset.
            if not self.drop_on_error:
                raise
            try:
                self._f.close()
            except OSError:
                pass
            self._open_shard(truncate_torn=True)
            self._m.dropped.inc(len(blobs))
            self.dropped += len(blobs)
            obs_events.log_exception_once(
                "loop.commit", e, kind="loop.append_error",
                dropped=len(blobs))
            return 0
        self._off += len(page)
        self.appended += len(blobs)
        self._m.appended.inc(len(blobs))
        if self._off >= self.rotate_bytes:
            self._rotate_locked()
        return len(blobs)

    def flush(self) -> int:
        """Commit the current partial page (cycle boundaries, tests)."""
        with self._lock:
            return self._commit_page_locked()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "appended": self.appended,
                "dropped": self.dropped,
                "buffered": len(self._blobs),
                "shard": self._shard_idx,
                "shard_bytes": self._off,
                "next_seq": self._seq_next,
            }

    def close(self) -> None:
        with self._lock:
            self._commit_page_locked()
            if self._f is not None:
                self._f.close()
                self._f = None
            # clean shutdown: shrink the reservation to exactly the
            # next id, so an orderly reopen continues gap-free (only a
            # crash leaves the unassigned block remainder as a gap)
            if self._seq_reserved > self._seq_next:
                from ..utils.checkpoint import atomic_write_bytes

                try:
                    atomic_write_bytes(
                        os.path.join(self.dir, SEQ_FILE),
                        json.dumps(
                            {"reserved": self._seq_next}).encode("utf-8"))
                    self._seq_reserved = self._seq_next
                except OSError:
                    pass  # the over-reservation stays: a gap, never reuse

    def __enter__(self) -> "FeedbackWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


Cursor = Dict[str, int]  # {"shard": int, "off": int}


def _cursor(shard: int = 0, off: int = 0) -> Cursor:
    return {"shard": int(shard), "off": int(off)}


class FeedbackReader:
    """Tailing read side: committed pages only, CRC-verified."""

    def __init__(self, dir_: str) -> None:
        self.dir = dir_

    # ------------------------------------------------------------------
    def _shard_commits(self) -> List[Tuple[int, str, List[Dict]]]:
        return [(idx, path, _read_commits(path))
                for idx, path in list_shards(self.dir)]

    def _compacted_below(self, cur: Cursor) -> int:
        """Retention boundary check shared by :meth:`pending` and
        :meth:`read_since`: a cursor pointing below the boundary wants
        records that no longer exist — fail loud, never skip."""
        below = read_retention(self.dir)["compacted_below"]
        if cur["shard"] < below:
            raise StaleCursorError(cur, below, self.dir)
        return below

    def pending(self, cursor: Optional[Cursor] = None) -> int:
        """Committed records past ``cursor`` (cheap: sidecars only).
        Raises :class:`StaleCursorError` for a cursor pointing into a
        compacted shard."""
        cur = cursor or _cursor()
        below = self._compacted_below(cur)
        n = 0
        for idx, _path, commits in self._shard_commits():
            if idx < max(cur["shard"], below):
                continue
            for ent in commits:
                if idx == cur["shard"] and ent["off"] < cur["off"]:
                    continue
                n += ent["nrec"]
        return n

    def read_since(
        self, cursor: Optional[Cursor] = None, max_records: int = 0
    ) -> Tuple[List[FeedbackRecord], Cursor]:
        """Every record committed after ``cursor`` (in commit order),
        plus the advanced cursor to persist once the records are
        consumed.  A CRC-mismatching or unreadable committed page is
        skipped and counted (``loop_feedback_bad_pages_total``) — the
        cursor still advances past it.  ``max_records > 0`` caps the
        read (the cursor then stops at a page boundary).  A cursor
        pointing into a compacted shard raises
        :class:`StaleCursorError`; shards below the retention boundary
        that still exist on disk (a crash between the boundary fsync
        and the unlinks) are ignored — they are already deleted as far
        as the protocol is concerned."""
        cur = dict(cursor) if cursor else _cursor()
        below = self._compacted_below(cur)
        out: List[FeedbackRecord] = []
        m = loop_metrics()
        for idx, path, commits in self._shard_commits():
            if idx < max(cur["shard"], below):
                continue
            for ent in commits:
                if idx == cur["shard"] and ent["off"] < cur["off"]:
                    continue
                if max_records and len(out) >= max_records:
                    return out, cur
                try:
                    with open(path, "rb") as f:
                        f.seek(ent["off"])
                        page = f.read(ent["bytes"])
                    if (len(page) != ent["bytes"]
                            or (zlib.crc32(page) & 0xFFFFFFFF)
                            != ent["crc32"]):
                        raise ValueError(
                            f"page@{ent['off']}: CRC/size mismatch")
                    out.extend(self._parse_page(page, ent.get("seq0")))
                except (OSError, ValueError, struct.error) as e:
                    m.bad_pages.inc()
                    obs_events.emit(
                        "loop.bad_page", shard=idx, off=ent["off"],
                        error=f"{type(e).__name__}: {e}")
                cur = _cursor(idx, ent["off"] + ent["bytes"])
        return out, cur

    @staticmethod
    def _parse_page(page: bytes,
                    seq0: Optional[int] = None) -> Iterator[FeedbackRecord]:
        magic, nrec = struct.unpack_from("<II", page)
        if magic != PAGE_MAGIC:
            raise ValueError(f"bad page magic {magic:#x}")
        lens = struct.unpack_from(f"<{nrec}I", page, 8)
        off = 8 + 4 * nrec
        mv = memoryview(page)
        for i, l in enumerate(lens):
            rec = decode_record(mv[off: off + l])
            if seq0 is not None:
                rec.seq = int(seq0) + i
            yield rec
            off += l


class CursorFile:
    """Atomic persistence for the trainer's read cursor."""

    def __init__(self, path: str) -> None:
        self.path = path

    def load(self) -> Cursor:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                cur = json.load(f)
            if (isinstance(cur, dict)
                    and {"shard", "off"} <= set(cur)):
                return _cursor(cur["shard"], cur["off"])
        except (OSError, ValueError, TypeError):
            pass
        return _cursor()

    def store(self, cursor: Cursor) -> None:
        from ..utils.checkpoint import atomic_write_bytes

        atomic_write_bytes(
            self.path,
            json.dumps(_cursor(**cursor)).encode("utf-8"),
        )
