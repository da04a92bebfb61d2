"""Recording/injecting disk-I/O layer for the durable writers.

The port's copy of ``cxxnet_tpu/utils/diskio.py``, whole.  Every writer
whose crash-safety the port claims routes its file ops through this
module: checkpoint atomic writes and their manifests
(``utils/checkpoint.py``, site ``checkpoint.write``), the event log and
its rotation (``obs/events.py``, site ``obs.append``), the span trace
(``obs/trace.py``) and telemetry.jsonl (``cli.py``, site
``obs.append``).  That buys three things at one choke point:

1. **One fsync contract.**  :func:`write_atomic` is THE atomic-replace
   helper (temp file in the same dir, fsync, ``os.replace``, dir fsync);
   :func:`append_bytes` / :class:`AppendHandle` are THE append paths.
2. **Recording.**  Under :func:`recording`, every op (create / write /
   fsync / fsync_dir / rename / unlink / truncate) is journaled with its
   payload bytes and a stable file id that survives renames.
   :func:`simulate_crash` replays any prefix of that journal into a
   fresh directory, and the real recovery paths run against each state.
3. **Runtime fault injection.**  The ``enospc`` / ``short`` / ``ioerror``
   kinds of ``utils/faults.py`` fire inside the write path, so disk-full
   behavior is testable in-process.  Any ENOSPC (injected or real)
   increments ``disk_full_total{site}`` and emits a deduped
   ``diskio.disk_full`` event.

Crash-state model (the **ext4-reorder model**):

* ``flush`` variant — every executed op landed (crash after a clean
  sync; the most generous state).
* ``sync`` variant — only *durable* ops survive: a data write/truncate
  survives iff a later ``fsync`` of the same file id precedes the crash
  point; a create/rename survives iff a later dir fsync of its directory
  OR a later file fsync of the same file id precedes it (ext4 semantics:
  fsync of a file also commits its directory entry); an unlink survives
  only via a later dir fsync.  Un-fsynced tails vanish, un-fsynced
  renames roll back, un-fsynced unlinks resurrect files (orphans).
* ``torn`` variant — like ``flush``, but the last not-yet-fsynced write
  is cut at a configurable byte count (a torn tail mid-write).

Writers here only create/append/truncate/replace/unlink — never seek
backwards to overwrite — so per-file data loss in the ``sync`` variant
is always a tail truncation, exactly like delayed allocation on ext4.

Deterministic kill hook: ``CXXNET_DISKIO_KILL_AT=substr[:nth]`` SIGKILLs
the process immediately before executing the nth durable op whose path
contains ``substr``.
"""

from __future__ import annotations

import contextlib
import errno
import hashlib
import os
import signal
import threading
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Recorder",
    "recording",
    "recorder",
    "mark",
    "write_atomic",
    "append_bytes",
    "open_append",
    "AppendHandle",
    "replace",
    "unlink",
    "truncate",
    "fsync_dir",
    "simulate_crash",
    "write_tree",
    "tree_fingerprint",
    "marks_before",
    "VARIANTS",
    "KILL_ENV",
]

KILL_ENV = "CXXNET_DISKIO_KILL_AT"
VARIANTS = ("flush", "sync", "torn")

_LOCK = threading.RLock()
_REC: Optional["Recorder"] = None

# ----------------------------------------------------------------------
# recording


class Recorder:
    """Journal of durable-I/O ops under one root directory.

    Ops are dicts: ``{"op": <kind>, "fid": <int|None>, "path": <rel>,
    ...}`` with payload bytes attached to writes.  File ids are assigned
    at create time and FOLLOW renames, so the simulator can tell "the
    bytes fsynced into the temp file" from "the name they were published
    under".  Paths outside the root are executed but not recorded.
    """

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self.ops: List[dict] = []
        self._fids: Dict[str, int] = {}
        self._sizes: Dict[int, int] = {}
        self._next_fid = 0

    # -- path / fid bookkeeping ---------------------------------------
    def rel(self, path: str) -> Optional[str]:
        p = os.path.abspath(path)
        if p == self.root:
            return "."
        if not p.startswith(self.root + os.sep):
            return None
        return os.path.relpath(p, self.root)

    def _new_fid(self, rel: str) -> int:
        fid = self._next_fid
        self._next_fid += 1
        self._fids[rel] = fid
        self._sizes[fid] = 0
        return fid

    def note(self, op: dict) -> None:
        self.ops.append(op)

    # -- op emitters (called by the primitives, under _LOCK) ----------
    def ensure_known(self, path: str) -> Optional[int]:
        """Make ``path`` traceable.  A file that predates the recording
        is snapshotted as a durable create+write+fsync prologue tagged
        ``snap`` — the simulator applies snapshot ops at EVERY crash
        point (the file existed before any recorded op, so no crash can
        unmake it), even though they are journaled lazily mid-stream."""
        rel = self.rel(path)
        if rel is None:
            return None
        if rel in self._fids:
            return self._fids[rel]
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        fid = self._new_fid(rel)
        self.note({"op": "create", "fid": fid, "path": rel, "snap": True})
        self.note({"op": "write", "fid": fid, "path": rel,
                   "off": 0, "data": data, "snap": True})
        self.note({"op": "fsync", "fid": fid, "path": rel, "snap": True})
        self.note({"op": "fsync_dir", "path": os.path.dirname(rel),
                   "snap": True})
        self._sizes[fid] = len(data)
        return fid

    def note_create(self, path: str) -> Optional[int]:
        rel = self.rel(path)
        if rel is None:
            return None
        fid = self._new_fid(rel)
        self.note({"op": "create", "fid": fid, "path": rel})
        return fid

    def note_write(self, path: str, data: bytes) -> None:
        rel = self.rel(path)
        if rel is None:
            return
        fid = self._fids.get(rel)
        if fid is None:
            fid = self._new_fid(rel)
            self.note({"op": "create", "fid": fid, "path": rel})
        off = self._sizes.get(fid, 0)
        self.note({"op": "write", "fid": fid, "path": rel,
                   "off": off, "data": bytes(data)})
        self._sizes[fid] = off + len(data)

    def note_fsync(self, path: str) -> None:
        rel = self.rel(path)
        if rel is None or rel not in self._fids:
            return
        self.note({"op": "fsync", "fid": self._fids[rel], "path": rel})

    def note_fsync_dir(self, dirpath: str) -> None:
        rel = self.rel(dirpath)
        if rel is None:
            return
        self.note({"op": "fsync_dir", "path": "" if rel == "." else rel})

    def note_truncate(self, path: str, size: int) -> None:
        rel = self.rel(path)
        if rel is None or rel not in self._fids:
            return
        fid = self._fids[rel]
        self.note({"op": "truncate", "fid": fid, "path": rel,
                   "size": int(size)})
        self._sizes[fid] = min(self._sizes.get(fid, 0), int(size))

    def note_replace(self, src: str, dst: str) -> None:
        rsrc, rdst = self.rel(src), self.rel(dst)
        if rsrc is None or rdst is None:
            return
        fid = self._fids.pop(rsrc, None)
        if fid is None:
            return
        self._fids[rdst] = fid
        self.note({"op": "rename", "fid": fid, "src": rsrc, "dst": rdst})

    def note_unlink(self, path: str) -> None:
        rel = self.rel(path)
        if rel is None:
            return
        fid = self._fids.pop(rel, None)
        self.note({"op": "unlink", "fid": fid, "path": rel})

    def note_mark(self, name: str, **fields) -> None:
        op = {"op": "mark", "name": name}
        op.update(fields)
        self.note(op)


def recorder() -> Optional[Recorder]:
    return _REC


@contextlib.contextmanager
def recording(root: str) -> Iterator[Recorder]:
    """Record every diskio op under ``root`` for the scope's duration.
    One active recording per process (the audit is single-threaded)."""
    global _REC
    rec = Recorder(root)
    with _LOCK:
        if _REC is not None:
            raise RuntimeError("diskio: recording already active")
        _REC = rec
    try:
        yield rec
    finally:
        with _LOCK:
            _REC = None


def mark(name: str, **fields) -> None:
    """Record an invariant obligation (e.g. "seqs [a,b) committed",
    "round 5 durable").  No-op outside a recording; the auditor asserts
    every mark before the crash point against the recovered tree."""
    with _LOCK:
        if _REC is not None:
            _REC.note_mark(name, **fields)


# ----------------------------------------------------------------------
# kill hook + disk-full accounting

_kill_spec: Optional[Tuple[str, int]] = None
_kill_parsed = False
_kill_seen = 0


def _maybe_kill(path: str) -> None:
    """SIGKILL self just before the nth matching durable op — the
    deterministic stand-in for "the machine died mid-write"."""
    global _kill_spec, _kill_parsed, _kill_seen
    if not _kill_parsed:
        _kill_parsed = True
        raw = os.environ.get(KILL_ENV, "")
        if raw:
            sub, _, nth = raw.partition(":")
            try:
                _kill_spec = (sub, max(1, int(nth)) if nth else 1)
            except ValueError:
                _kill_spec = (sub, 1)
    if _kill_spec is None:
        return
    sub, nth = _kill_spec
    if sub and sub in path:
        _kill_seen += 1
        if _kill_seen >= nth:
            os.kill(os.getpid(), signal.SIGKILL)


def count_disk_full(site: Optional[str], path: str) -> None:
    """ENOSPC (injected or real) is a page-the-operator event: count it
    and emit one deduped event per site.  Never raises."""
    try:
        from ..obs.registry import registry as obs_registry
        obs_registry().counter(
            "disk_full_total",
            "ENOSPC hits on durable writers (injected or real).",
            labelnames=("site",),
        ).labels(site=site or "unspecified").inc()
    except Exception:
        pass
    try:
        from ..obs import events as obs_events
        obs_events.emit_once(f"diskio.disk_full:{site or 'unspecified'}",
                             "diskio.disk_full", site=site or "unspecified",
                             path=path)
    except Exception:
        pass


def _inject(site: Optional[str], payload: Optional[bytes], path: str):
    """Run the fault point for ``site``.  Returns the byte count a short
    write should keep before re-raising, or None for a full write.
    ENOSPC-class injections are counted before they propagate."""
    if not site:
        return None
    from . import faults
    try:
        faults.fault_point(site, payload)
    except faults.InjectedShortWrite as e:
        count_disk_full(site, path)
        return e
    except OSError as e:
        if getattr(e, "errno", None) == errno.ENOSPC:
            count_disk_full(site, path)
        raise
    return None


# ----------------------------------------------------------------------
# primitives


def fsync_dir(dirpath: str) -> None:
    """Best-effort directory fsync (makes renames/creates durable on
    POSIX; not supported everywhere, hence best-effort)."""
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        return
    finally:
        os.close(dfd)
    with _LOCK:
        if _REC is not None:
            _REC.note_fsync_dir(dirpath)


def write_atomic(path: str, data: bytes, fsync: bool = True,
                 site: Optional[str] = "checkpoint.write") -> None:
    """THE atomic publish: temp file in the same directory, write, fsync,
    ``os.replace``, dir fsync.  A crash at any point leaves either the
    old file or the new file — never a torn one (the temp may linger;
    every consumer ignores ``.*.tmp.*`` names).

    A short-write injection lands its prefix in the TEMP file and
    aborts — the torn bytes never reach ``path`` (the abort-atomically
    contract for checkpoint writes under disk-full).
    """
    path = os.path.abspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    data = bytes(data)
    short = _inject(site, data, path)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with _LOCK:
            if _REC is not None:
                _REC.ensure_known(path)
                _REC.note_create(tmp)
        _maybe_kill(tmp)
        with open(tmp, "wb") as f:
            part = data if short is None else data[: short.keep]
            try:
                f.write(part)
            except OSError as e:
                if getattr(e, "errno", None) == errno.ENOSPC:
                    count_disk_full(site, path)
                raise
            with _LOCK:
                if _REC is not None:
                    _REC.note_write(tmp, part)
            if short is not None:
                f.flush()
                raise short
            if fsync:
                f.flush()
                os.fsync(f.fileno())
                with _LOCK:
                    if _REC is not None:
                        _REC.note_fsync(tmp)
        _maybe_kill(path)
        os.replace(tmp, path)
        with _LOCK:
            if _REC is not None:
                _REC.note_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            with contextlib.suppress(OSError):
                os.unlink(tmp)
                with _LOCK:
                    if _REC is not None:
                        _REC.note_unlink(tmp)
    if fsync:
        fsync_dir(d)


class AppendHandle:
    """A recorded append-only file handle (the feedback-log shard file).

    Supports exactly what the durable writers need: append, flush,
    fsync, tell, truncate-then-continue.  Fault sites fire per-write so
    ENOSPC/short-write hit individual pages, not whole sessions.
    """

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        existed = os.path.exists(self.path)
        with _LOCK:
            if _REC is not None:
                if existed:
                    _REC.ensure_known(self.path)
        self._f = open(self.path, "ab")
        with _LOCK:
            if _REC is not None and not existed:
                _REC.note_create(self.path)

    def write(self, data: bytes, site: Optional[str] = None) -> int:
        data = bytes(data)
        short = _inject(site, data, self.path)
        part = data if short is None else data[: short.keep]
        _maybe_kill(self.path)
        if part:
            try:
                self._f.write(part)
            except OSError as e:
                if getattr(e, "errno", None) == errno.ENOSPC:
                    count_disk_full(site, self.path)
                raise
            with _LOCK:
                if _REC is not None:
                    _REC.note_write(self.path, part)
        if short is not None:
            # land the torn tail on disk before failing, like a real
            # ENOSPC partway through a page
            self._f.flush()
            raise short
        return len(data)

    def flush(self) -> None:
        self._f.flush()

    def fsync(self) -> None:
        self._f.flush()
        _maybe_kill(self.path)
        os.fsync(self._f.fileno())
        with _LOCK:
            if _REC is not None:
                _REC.note_fsync(self.path)

    def tell(self) -> int:
        return self._f.tell()

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def truncate(self, size: int) -> None:
        self._f.truncate(size)
        with _LOCK:
            if _REC is not None:
                _REC.note_truncate(self.path, size)

    def fileno(self) -> int:
        return self._f.fileno()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def open_append(path: str) -> AppendHandle:
    return AppendHandle(path)


def append_bytes(path: str, data: bytes, fsync: bool = False,
                 site: Optional[str] = None) -> None:
    """One-shot recorded append (event-log lines, telemetry records,
    ``.commit`` sidecar entries)."""
    h = AppendHandle(path)
    try:
        h.write(data, site=site)
        h.flush()
        if fsync:
            h.fsync()
    finally:
        h.close()


def replace(src: str, dst: str) -> None:
    """Recorded ``os.replace`` (event-log rotation)."""
    _maybe_kill(dst)
    os.replace(src, dst)
    with _LOCK:
        if _REC is not None:
            _REC.ensure_known(src)
            _REC.ensure_known(dst)
            _REC.note_replace(src, dst)


def unlink(path: str, missing_ok: bool = True) -> bool:
    """Recorded ``os.unlink``.  Returns True when a file was removed."""
    with _LOCK:
        if _REC is not None:
            _REC.ensure_known(path)
    _maybe_kill(path)
    try:
        os.unlink(path)
    except FileNotFoundError:
        if missing_ok:
            return False
        raise
    with _LOCK:
        if _REC is not None:
            _REC.note_unlink(path)
    return True


def truncate(path: str, size: int) -> None:
    """Recorded in-place truncate (event-log emergency reset)."""
    with _LOCK:
        if _REC is not None:
            _REC.ensure_known(path)
    with open(path, "r+b") as f:
        f.truncate(size)
    with _LOCK:
        if _REC is not None:
            _REC.note_truncate(path, size)


# ----------------------------------------------------------------------
# crash-state simulator


def marks_before(ops: List[dict], k: int) -> List[dict]:
    """Marks recorded strictly before crash point ``k`` — the invariant
    obligations that were ACKNOWLEDGED before the crash."""
    return [op for op in ops[:k] if op["op"] == "mark"]


def _durable_sets(ops: List[dict], k: int):
    """Per the ext4-reorder model: indices of fsyncs by fid and dir
    fsyncs by dir, within the crash prefix (plus the pre-existing-file
    snapshot syncs, which hold at every crash point)."""
    fsyncs: Dict[int, List[int]] = {}
    dirsyncs: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        if i >= k and not op.get("snap"):
            continue
        if op["op"] == "fsync":
            fsyncs.setdefault(op["fid"], []).append(i)
        elif op["op"] == "fsync_dir":
            dirsyncs.setdefault(op["path"], []).append(i)
    return fsyncs, dirsyncs


def _synced_after(idxs: Optional[List[int]], i: int) -> bool:
    return bool(idxs) and idxs[-1] > i


def simulate_crash(ops: List[dict], k: int, variant: str = "sync",
                   torn_keep: Optional[int] = None,
                   ) -> Optional[Dict[str, bytes]]:
    """Compute the post-crash filesystem tree (rel path -> bytes) for a
    crash immediately before op ``k``.  Returns None when the variant
    adds nothing at this point (e.g. ``torn`` with no unsynced tail, or
    a cut past the write's length) so the caller can skip duplicates.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown crash variant {variant!r}")
    fsyncs, dirsyncs = _durable_sets(ops, k)

    torn_idx = -1
    if variant == "torn":
        for i in range(k - 1, -1, -1):
            op = ops[i]
            if op["op"] == "write" and not op.get("snap"):
                if not _synced_after(fsyncs.get(op["fid"]), i):
                    torn_idx = i
                break
        if torn_idx < 0:
            return None
        if torn_keep is None or torn_keep >= len(ops[torn_idx]["data"]):
            return None

    namespace: Dict[str, int] = {}
    contents: Dict[int, bytearray] = {}
    for i, op in enumerate(ops):
        if i >= k and not op.get("snap"):
            continue
        kind = op["op"]
        if kind == "mark":
            continue
        if variant == "sync":
            if kind in ("write", "truncate"):
                if not _synced_after(fsyncs.get(op["fid"]), i):
                    continue
            elif kind in ("create", "rename"):
                d = os.path.dirname(op.get("dst") or op["path"])
                if not (_synced_after(dirsyncs.get(d), i)
                        or _synced_after(fsyncs.get(op["fid"]), i)):
                    continue
            elif kind == "unlink":
                d = os.path.dirname(op["path"])
                if not _synced_after(dirsyncs.get(d), i):
                    continue
        if kind == "create":
            contents.setdefault(op["fid"], bytearray())
            namespace[op["path"]] = op["fid"]
        elif kind == "write":
            buf = contents.setdefault(op["fid"], bytearray())
            data = op["data"]
            if i == torn_idx:
                data = data[:torn_keep]
            off = op["off"]
            if off > len(buf):
                buf.extend(b"\0" * (off - len(buf)))
            buf[off:off + len(data)] = data
        elif kind == "truncate":
            buf = contents.setdefault(op["fid"], bytearray())
            del buf[op["size"]:]
        elif kind == "rename":
            fid = op["fid"]
            if namespace.get(op["src"]) == fid:
                del namespace[op["src"]]
            namespace[op["dst"]] = fid
        elif kind == "unlink":
            namespace.pop(op["path"], None)
    return {path: bytes(contents.get(fid, b""))
            for path, fid in namespace.items()}


def tree_fingerprint(tree: Dict[str, bytes]) -> str:
    h = hashlib.sha1()
    for path in sorted(tree):
        h.update(path.encode())
        h.update(b"\0")
        h.update(hashlib.sha1(tree[path]).digest())
    return h.hexdigest()


def write_tree(tree: Dict[str, bytes], out_root: str) -> None:
    """Materialize a simulated crash state into ``out_root`` (which
    should be fresh/empty) so the real recovery code can run on it."""
    for path, data in tree.items():
        full = os.path.join(out_root, path)
        os.makedirs(os.path.dirname(full) or out_root, exist_ok=True)
        with open(full, "wb") as f:
            f.write(data)
