"""Packed binary-page image records: the reader and both writers.

The port's copy of ``cxxnet_tpu/io/imgbin.py``.  A shard is a page file
(``image_bin``) with a ``.lst`` label file (``image_list``: ``index \\t
label(s) \\t filename`` a line).  Two page layouts, told apart per file
by the leading u32 and read and written byte for byte as the JAX package
does:

* ``CXBP``: ``page := magic u32 | nrec u32 | {len u32}*nrec |
  {blob}*nrec`` (``BinPageWriter``);
* the reference's ``BinaryPage``: fixed 64 MiB pages of little-endian
  i32s, ``data[0] = nrec``, ``data[1..nrec+1]`` the cumulative blob sizes
  (``data[1] = 0``), blobs packed backwards from the page's end
  (``RefBinPageWriter``).

A record is an encoded image (JPEG/PNG, decoded with PIL) or, with
``raw_pixels = 1``, a raw float32 HWC blob (``encode_raw``), which needs
no PIL.  PIL is imported only where a record is decoded; without it a
``raw_pixels = 0`` chain refuses at ``init()``, naming the key.

Bad data: ``max_bad_records = N`` skips up to N bad records or pages an
epoch, each written to a ``.quarantine`` sidecar (in ``quarantine_dir``
when set); the default 0 raises ``BadDataError`` at the first.  The
fault sites ``imgbin.page`` and ``imgbin.record`` are visited on the
reading thread, in record order.  ``image_conf_prefix`` (a printf
pattern) with ``image_conf_ids = lb-ub`` names the shards.
``shuffle_bin`` is read and, as in the JAX package, does nothing.

``native_decoder = 1`` (the default) reads encoded pages with the native
reader (``io/native.py``: a C++ page thread and a libjpeg decode pool of
``decode_thread`` workers, 0 = the cores less two) when it can be built,
as the JAX package does; a non-JPEG blob comes back raw and PIL decodes
it.  Raw-pixel pages, ``max_bad_records > 0`` (which needs the Python
reader's record-level isolation) and ``native_decoder = 0`` take the
Python reader, and so does a machine where the native reader does not
build.  The iterator says which reader it runs (``reader``:
``native`` or ``python``) and, for the Python reader, why
(``reader_why``; the build's error line where the build failed).  The
native reader visits no fault site and keeps no bad-record budget; the
decode pool (``io/pipeline.py``) then augments its decoded instances.
The worker shard of a data-parallel job (``dist_num_worker`` /
``dist_worker_rank``, or the ``PS_RANK`` / ``PS_NUM_WORKER``
environment, as in the reference): whole shard files, worker ``r``
taking the files ``i % n == r`` (``image_conf_prefix``: contiguous
blocks of ids), every worker's epoch capped at the smallest worker's
row count (``epoch_cap``; the decode pool counts the cap on decoded
records), so every worker runs the same number of batches.
"""

from __future__ import annotations

import io as _io
import os
import re
import struct
import time
from typing import IO, List, Optional, Tuple

import numpy as np

from ..utils import faults
from ..utils.faults import BadRecordBudget
from ..utils.profiler import pipeline_stats
from .batch import DataInst, InstIterator

PAGE_MAGIC = 0x43584250  # "CXBP"
DEFAULT_PAGE_SIZE = 64 << 20
# the reference's BinaryPage: kPageSize = 64<<18 i32s = 64 MiB exactly
# (io.h:226); every page on disk is this many bytes, full or not
REF_PAGE_BYTES = (64 << 18) * 4


class BinPageWriter:
    """Pack blobs into ~page_size pages (tools/im2bin analog)."""

    def __init__(self, path: str, page_size: int = DEFAULT_PAGE_SIZE) -> None:
        self.f: IO[bytes] = open(path, "wb")
        self.page_size = page_size
        self._blobs: List[bytes] = []
        self._cur = 0

    def push(self, blob: bytes) -> None:
        if self._cur + len(blob) + 8 > self.page_size and self._blobs:
            self.flush_page()
        self._blobs.append(blob)
        self._cur += len(blob) + 4

    def flush_page(self) -> None:
        if not self._blobs:
            return
        self.f.write(struct.pack("<II", PAGE_MAGIC, len(self._blobs)))
        for b in self._blobs:
            self.f.write(struct.pack("<I", len(b)))
        for b in self._blobs:
            self.f.write(b)
        self._blobs, self._cur = [], 0

    def close(self) -> None:
        self.flush_page()
        self.f.close()


class RefBinPageWriter:
    """Write the reference's BinaryPage bit-format byte-for-byte.

    Mirrors ``BinaryPage::Push/Save`` (io.h:254-271) + the ``im2bin.cpp``
    page-flush loop: i32 header array growing from the front, blobs
    packing backwards from the 64 MiB page end, every saved page padded
    to exactly ``REF_PAGE_BYTES``.
    """

    def __init__(self, path: str) -> None:
        self.f: IO[bytes] = open(path, "wb")
        self._blobs: List[bytes] = []
        self._cum = 0  # data_[nrec+1]: cumulative blob bytes

    def _free_bytes(self) -> int:
        # FreeBytes() (io.h:286-288): ints not yet used by the header,
        # minus the blob bytes already packed at the tail
        n = len(self._blobs)
        return (REF_PAGE_BYTES // 4 - (n + 2)) * 4 - self._cum

    def push(self, blob: bytes) -> None:
        if self._free_bytes() < len(blob) + 4:
            self.flush_page()
            if self._free_bytes() < len(blob) + 4:
                raise ValueError(
                    f"blob of {len(blob)} bytes exceeds the 64 MiB page"
                )
        self._blobs.append(blob)
        self._cum += len(blob)

    def flush_page(self) -> None:
        if not self._blobs:
            return
        hdr = np.zeros(len(self._blobs) + 2, "<i4")
        hdr[0] = len(self._blobs)
        hdr[1:] = 0
        np.cumsum([len(b) for b in self._blobs], out=hdr[2:])
        page = bytearray(REF_PAGE_BYTES)
        page[: hdr.nbytes] = hdr.tobytes()
        end = REF_PAGE_BYTES
        for b in self._blobs:  # first blob lands at the very page end
            page[end - len(b): end] = b
            end -= len(b)
        self.f.write(page)
        self._blobs, self._cum = [], 0

    def close(self) -> None:
        self.flush_page()
        self.f.close()


def detect_bin_format(path: str) -> str:
    """``'cxbp'`` or ``'ref'`` by the leading u32.  A reference page
    starts with its record count — far below the CXBP magic value — and
    reference files are whole 64 MiB pages."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
    if len(head) < 8:
        raise ValueError(f"{path}: too short to be a page file")
    first, second = struct.unpack("<II", head)
    if first == PAGE_MAGIC:
        return "cxbp"
    if size % REF_PAGE_BYTES == 0 and second == 0:
        return "ref"
    raise ValueError(
        f"{path}: neither CXBP (magic {PAGE_MAGIC:#x}) nor reference "
        f"BinaryPage (64 MiB pages, first offset 0); got "
        f"head=({first:#x}, {second:#x}), size={size}"
    )


def iter_ref_bin_pages(path: str):
    """Yield lists of blobs from a reference-format ``.bin`` (io.h layout).

    Page-granular: one 64 MiB read per page; each blob is a zero-copy
    ``memoryview`` slice of the page buffer (no per-instance copy)."""
    with open(path, "rb") as f:
        while True:
            page = f.read(REF_PAGE_BYTES)
            if not page:
                return
            if len(page) < REF_PAGE_BYTES:
                raise ValueError(f"{path}: truncated 64 MiB page")
            nrec = struct.unpack_from("<i", page)[0]
            if nrec < 0 or (nrec + 2) * 4 > REF_PAGE_BYTES:
                raise ValueError(f"{path}: corrupt page (nrec={nrec})")
            offs = np.frombuffer(page, "<i4", count=nrec + 1, offset=4)
            if offs[0] != 0 or (np.diff(offs) < 0).any() or (
                int(offs[-1]) + (nrec + 2) * 4 > REF_PAGE_BYTES
            ):
                raise ValueError(f"{path}: corrupt page offsets")
            mv = memoryview(page)
            yield [
                mv[REF_PAGE_BYTES - int(offs[r + 1]):
                   REF_PAGE_BYTES - int(offs[r])]
                for r in range(nrec)
            ]


def iter_cxbp_pages(path: str):
    """Yield lists of blobs, one list per CXBP page.

    Page-granular: header + length table + ONE read for the whole blob
    region, then zero-copy ``memoryview`` slices — the old per-blob
    ``f.read(l)`` did one syscall and one bytes allocation per instance.
    A truncated final page yields short tail blobs (the downstream
    decoder fails on them record by record), matching the short-read
    behavior of the per-blob reads."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            magic, nrec = struct.unpack("<II", hdr)
            if magic != PAGE_MAGIC:
                raise ValueError(f"{path}: bad page magic {magic:#x}")
            lens_raw = f.read(4 * nrec)
            if len(lens_raw) < 4 * nrec:
                raise ValueError(f"{path}: truncated page length table")
            lens = struct.unpack(f"<{nrec}I", lens_raw)
            mv = memoryview(f.read(sum(lens)))
            out, off = [], 0
            for l in lens:
                out.append(mv[off: off + l])
                off += l
            yield out


def iter_bin_pages(path: str):
    """Yield lists of blobs per page; the layout is auto-detected, so
    cxxnet-era reference packs and native CXBP packs both read.  An
    empty pack (what a writer closed on zero pushes produces) yields no
    pages; a 1-7 byte file is a truncation and still raises."""
    if os.path.getsize(path) == 0:
        return iter(())
    if detect_bin_format(path) == "ref":
        return iter_ref_bin_pages(path)
    return iter_cxbp_pages(path)


def parse_lst_line(line: str) -> Tuple[int, np.ndarray, str]:
    """``index \\t labels... \\t filename`` (tab-separated)."""
    parts = line.rstrip("\n").split("\t")
    if len(parts) < 3:
        raise ValueError(f"bad .lst line: {line!r}")
    idx = int(float(parts[0]))
    labels = np.asarray([float(t) for t in parts[1:-1]], np.float32)
    return idx, labels, parts[-1]


def pil_image(key: str):
    """``PIL.Image``, or a ``RuntimeError`` naming the conf key that asked
    for it when PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{key} needs PIL (Pillow), which is not installed here; "
            "pack the records as raw pixels (raw_pixels = 1, encode_raw) "
            "and leave out the affine augmentation keys") from e
    return Image


def decode_image_u8(blob) -> np.ndarray:
    """JPEG/PNG blob -> HWC RGB uint8 (the augmenter converts to float32
    after the crop, which is exact)."""
    img = pil_image("raw_pixels = 0").open(_io.BytesIO(blob))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img)


def encode_raw(img: np.ndarray) -> bytes:
    """A raw-pixel blob: u16 h, w, c, a u16 pad, then float32 HWC."""
    h, w, c = img.shape
    return struct.pack("<HHHH", h, w, c, 0) + img.astype(np.float32).tobytes()


def decode_raw(blob) -> np.ndarray:
    h, w, c = struct.unpack("<HHH", blob[:6])
    return np.frombuffer(blob, np.float32, offset=8).reshape(h, w, c).copy()


class RawRecord:
    """One undecoded record, the decode pool's unit of work;
    ``source``/``offset`` locate it for the quarantine."""

    __slots__ = ("index", "labels", "payload", "source", "offset")

    def __init__(self, index: int, labels: np.ndarray, payload,
                 source: str, offset) -> None:
        self.index = index
        self.labels = labels
        self.payload = payload
        self.source = source
        self.offset = offset


def _load_labels(lst_path: str) -> List[Tuple[int, np.ndarray]]:
    out = []
    with open(lst_path, "r", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                idx, labels, _ = parse_lst_line(line)
                out.append((idx, labels))
    return out


class ImageBinIterator(InstIterator):
    """Instance iterator over one or more page shards and their .lst
    files."""

    def supports_dist_shard(self) -> bool:
        return True

    def __init__(self) -> None:
        self.image_bin: List[str] = []
        self.image_list: List[str] = []
        self.image_conf_prefix = ""
        self.image_conf_ids = ""
        self.silent = 0
        self.raw = 0
        self.native_decoder = 1
        self.decode_thread = 0  # native decode workers; 0: cores less two
        self.reader = "python"  # the reader init() picked, and why
        self.reader_why = ""
        self._native = None  # NativePageReader
        self._native_labels: List[Tuple[int, np.ndarray]] = []
        self._native_pos = 0
        self.dist_num_worker = 1
        self.dist_worker_rank = 0
        self.epoch_cap = 0  # records an epoch, 0: all (worker shards)
        self._served = 0
        self.max_bad_records = 0
        self.quarantine_dir = ""
        self._records: List[Tuple[int, np.ndarray]] = []
        self._shards: List[Tuple[str, str]] = []
        self._page_iter = None
        self._page: list = []
        self._page_pos = 0
        self._shard_pos = 0
        self._rec_pos = 0
        self._out: Optional[DataInst] = None
        self._budget: Optional[BadRecordBudget] = None

    def set_param(self, name, val):
        if name in ("image_bin", "image_bin_x"):
            self.image_bin.append(val)
        elif name in ("image_list", "image_list_x"):
            self.image_list.append(val)
        elif name == "image_conf_prefix":
            self.image_conf_prefix = val
        elif name == "image_conf_ids":
            self.image_conf_ids = val
        elif name == "silent":
            self.silent = int(val)
        elif name == "raw_pixels":
            self.raw = int(val)
        elif name == "native_decoder":
            self.native_decoder = int(val)
        elif name == "decode_thread":
            self.decode_thread = int(val)
        elif name == "dist_num_worker":
            self.dist_num_worker = int(val)
        elif name == "dist_worker_rank":
            self.dist_worker_rank = int(val)
        elif name == "max_bad_records":
            self.max_bad_records = int(val)
        elif name == "quarantine_dir":
            self.quarantine_dir = val

    def _conf_shards(self) -> None:
        """``image_conf_prefix`` % id for each id of ``image_conf_ids``
        names a ``.bin``/``.lst`` pair."""
        if self.image_bin or self.image_list:
            raise ValueError("imgbin: set either image_conf_prefix or "
                             "image_bin/image_list, not both")
        m = re.fullmatch(r"\s*(\d+)-(\d+)\s*", self.image_conf_ids)
        if not m:
            raise ValueError(
                "imgbin: image_conf_ids only supports a range like 1-100")
        lb, ub = int(m.group(1)), int(m.group(2))
        if ub < lb:
            raise ValueError("imgbin: image_conf_ids range is empty")
        try:
            names = [self.image_conf_prefix % i for i in range(lb, ub + 1)]
            if names[0] == self.image_conf_prefix:
                raise ValueError("pattern formats nothing")
        except (TypeError, ValueError) as e:
            raise ValueError(
                "imgbin: image_conf_prefix must contain one %d-style "
                f"pattern (got {self.image_conf_prefix!r}): {e}") from e
        self.image_bin = [n + ".bin" for n in names]
        self.image_list = [n + ".lst" for n in names]

    def init(self):
        if os.environ.get("PS_RANK"):
            # as the reference: the env's rank wins, unconditionally
            self.dist_worker_rank = int(os.environ["PS_RANK"])
            if self.dist_num_worker == 1:
                self.dist_num_worker = int(
                    os.environ.get("PS_NUM_WORKER", "1") or 1)
        if not self.raw:
            pil_image("raw_pixels = 0")
        conf_mode = bool(self.image_conf_prefix)
        if conf_mode:
            self._conf_shards()
        if len(self.image_bin) != len(self.image_list):
            raise ValueError(
                "imgbin: need matching image_bin / image_list counts")
        if not self.image_bin:
            raise ValueError("imgbin: must set image_bin and image_list")
        self._shards = self._worker_shards(
            list(zip(self.image_bin, self.image_list)), conf_mode)
        self._open_native()
        self._budget = BadRecordBudget(
            self.max_bad_records, what="imgbin", silent=bool(self.silent),
            quarantine_dir=self.quarantine_dir or None)
        self.before_first()

    def _worker_shards(self, shards, conf_mode: bool):
        """This worker's whole shard files, and ``epoch_cap``: the
        smallest worker's row count (every worker counts every file's
        rows from the ``.lst`` files of the conf)."""
        self.epoch_cap = 0
        n = self.dist_num_worker
        if n <= 1:
            return shards
        if len(shards) < n:
            raise ValueError(
                f"imgbin: {len(shards)} shard file(s) cannot feed {n} "
                "workers distinct data — repack with "
                "tools/imgbin_partition_maker.py (>= one shard per worker)")
        if conf_mode:
            step = -(-len(shards) // n)  # contiguous blocks of ids
            owner = lambda i: i // step  # noqa: E731
            if (n - 1) * step >= len(shards):
                raise ValueError(
                    "imgbin: too many workers — the image_conf_ids range "
                    "cannot be divided into non-empty contiguous blocks")
        else:
            owner = lambda i: i % n  # noqa: E731
        per_worker = [0] * n
        for i, (_b, lst) in enumerate(shards):
            per_worker[owner(i)] += len(_load_labels(lst))
        self.epoch_cap = min(per_worker)
        if self.epoch_cap == 0:
            raise ValueError(
                f"imgbin: worker {per_worker.index(0)}'s shard files "
                "contain 0 rows — repack so every worker gets data")
        return [s for i, s in enumerate(shards)
                if owner(i) == self.dist_worker_rank]

    def _open_native(self) -> None:
        """Pick the reader: the native one for encoded pages when it
        builds, as the JAX package does, else the Python one."""
        if self.raw:
            self.reader_why = "raw_pixels = 1"
        elif not self.native_decoder:
            self.reader_why = "native_decoder = 0"
        elif self.max_bad_records > 0:
            # skip-and-quarantine needs record-level error isolation,
            # which only the Python reader has: the native pool decodes
            # ahead across threads and a corrupt record aborts it
            self.reader_why = "max_bad_records > 0"
            if not self.silent:
                print("imgbin: max_bad_records set; using the pure-Python "
                      "reader for skip-and-quarantine", flush=True)
        else:
            from . import native

            if not native.available():
                self.reader_why = native.unavailable_reason()
                if not self.silent:
                    print(f"imgbin: native reader unavailable "
                          f"({self.reader_why}); reading with the Python "
                          "reader", flush=True)
                return
            self._native = native.NativePageReader(
                [b for b, _ in self._shards], self.decode_thread)
            self._native_labels = []
            for _, lst in self._shards:
                self._native_labels.extend(_load_labels(lst))
            self.reader, self.reader_why = "native", ""

    def raw_available(self) -> bool:
        """Can :meth:`next_raw` feed the decode pool?  Not under the
        native reader, which decodes on its own pool."""
        return self._native is None

    def close(self) -> None:
        if self._native is not None:
            self._native.close()  # stops the reader and decode threads
            self._native = None

    def before_first(self):
        self._budget.start_epoch()
        self._served = 0
        if self._native is not None:
            self._native.reset()
            self._native_pos = 0
            return
        self._shard_pos = 0
        self._open_shard(0)

    def _open_shard(self, k: int) -> None:
        while k < len(self._shards):
            bin_path, lst_path = self._shards[k]
            try:
                records = _load_labels(lst_path)
            except (OSError, ValueError) as e:
                self._budget.record(bin_path, "open", e,
                                    note="whole shard skipped")
                k += 1
                continue
            try:
                page_iter = iter_bin_pages(bin_path)
            except (OSError, ValueError) as e:
                self._budget.record(
                    bin_path, "open", e,
                    note=f"whole shard skipped, {len(records)} record(s) "
                         "dropped")
                k += 1
                continue
            self._records = records
            self._page_iter = page_iter
            self._page, self._page_pos, self._rec_pos = [], 0, 0
            self._shard_pos = k
            return
        self._shard_pos = k
        self._page_iter = None

    def next(self) -> bool:
        if self.epoch_cap and self._served >= self.epoch_cap:
            return False
        self._served += 1
        if self._native is not None:
            return self._next_native()
        while True:
            rec = self.next_raw()
            if rec is None:
                self.note_epoch_end()
                return False
            try:
                data = self.decode_record(rec)
            except Exception as e:  # noqa: BLE001 - untrusted bytes
                self._budget.record(rec.source, rec.offset, e)
                continue
            # float32, the instance contract of direct consumers; the
            # pool's workers keep uint8 until after the crop (exact)
            self._out = DataInst(rec.index, data.astype(np.float32, copy=False),
                                 rec.labels)
            return True

    def _next_native(self) -> bool:
        rec = self._native.next()
        if rec is None:
            return False
        kind, payload = rec
        # kind 1: decoded HWC uint8; kind 0: a non-JPEG blob for PIL
        data = payload if kind == 1 else decode_image_u8(payload)
        idx, labels = self._native_labels[self._native_pos]
        self._native_pos += 1
        self._out = DataInst(idx, data.astype(np.float32), labels)
        return True

    # ------------------------------------------------------------------
    # the raw-record API of the decode pool (io/pipeline.py)
    def next_raw(self) -> Optional[RawRecord]:
        """The next undecoded record (page and shard advance, page-level
        quarantine, the ``imgbin.record`` fault point), or None at the
        epoch's end."""
        while True:
            if self._page_iter is None:
                return None
            bin_path = self._shards[self._shard_pos][0]
            if self._page_pos < len(self._page):
                blob = self._page[self._page_pos]
                self._page_pos += 1
                rec = self._rec_pos
                idx, labels = self._records[rec]
                self._rec_pos += 1
                blob = faults.fault_point("imgbin.record", blob)
                return RawRecord(idx, labels, blob, bin_path, rec)
            try:
                faults.fault_point("imgbin.page")
                self._page = next(self._page_iter)
                self._page_pos = 0
            except StopIteration:
                self._shard_pos += 1
                self._open_shard(self._shard_pos)
                if self._shard_pos >= len(self._shards):
                    return None
            except (OSError, ValueError) as e:
                # past a bad page the shard's blobs and labels no longer
                # line up: drop the rest of the shard, counted
                dropped = len(self._records) - self._rec_pos
                self._budget.record(
                    bin_path, f"page@rec{self._rec_pos}", e,
                    note=f"{dropped} trailing record(s) of the shard "
                         "dropped")
                self._shard_pos += 1
                self._open_shard(self._shard_pos)
                if self._shard_pos >= len(self._shards):
                    return None

    def next_raw_block(self, k: int) -> List[RawRecord]:
        """Up to ``k`` raw records (the pool's chunk)."""
        out: List[RawRecord] = []
        while len(out) < k:
            rec = self.next_raw()
            if rec is None:
                break
            out.append(rec)
        return out

    def note_epoch_end(self) -> None:
        """Print the epoch's skip summary once every decode failure has
        been recorded."""
        if self._budget.epoch_count and not self.silent:
            print(self._budget.summary(), flush=True)

    def decode_record(self, rec: RawRecord) -> np.ndarray:
        """One record's pixels (float32 raw, uint8 decoded); a pure
        function of the payload, safe on the pool's threads; timed as
        the ``decode`` stage."""
        t0 = time.perf_counter()
        data = (decode_raw(rec.payload) if self.raw
                else decode_image_u8(rec.payload))
        pipeline_stats().add("decode", time.perf_counter() - t0)
        return data

    def pil_available(self) -> bool:
        """Are the records encoded images that :meth:`decode_pil` reads?"""
        return not self.raw

    def decode_pil(self, rec: RawRecord):
        """One record as a loaded RGB PIL image (the split worker path)."""
        im = pil_image("raw_pixels = 0").open(_io.BytesIO(rec.payload))
        if im.mode != "RGB":
            im = im.convert("RGB")
        im.load()
        return im

    def record_bad(self, source: str, offset, exc: BaseException) -> None:
        """Quarantine a worker's decode failure (called by the pool's
        consumer, in record order)."""
        self._budget.record(source, offset, exc)

    def value(self) -> DataInst:
        if self._out is None:
            raise RuntimeError("ImageBinIterator: value() before next()")
        return self._out
