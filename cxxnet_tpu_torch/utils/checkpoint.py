"""Checkpoint container and manifests, shared with the JAX package.

The port's own copy of the format in ``cxxnet_tpu/utils/checkpoint.py``
and ``cxxnet_tpu/nnet/trainer.py``: a model file is the 8-byte magic
``CXTPU001``, a little-endian u32 header length, a JSON header
(``structure``, ``epoch_counter``), then an npz of the params under
``<param key>/<tag>`` names.  Beside it, ``<file>.manifest.json``
carries the CRC32, byte size, round and net fingerprint, so a reader
can prove a checkpoint is intact and belongs to its net before loading
it.  Writes are atomic (temp file, fsync, rename, directory fsync)
and go through ``utils/diskio.py`` (site ``checkpoint.write``); the
validation visits ``checkpoint.read``.  ``apply_retention`` prunes all
but the newest ``keep_latest`` rounds and their manifests.
The publish pointer (``PUBLISHED.json``) names the round the closed
loop (``loop/``) last published, with its gate metric, the round before
it and the feedback lineage it was fine-tuned on; its bytes and keys are
the JAX package's, so either package reads the other's ``model_dir``.
``PreemptionHandler`` turns SIGTERM/SIGINT into a flag the train loop
checks at each batch, so it can snapshot and exit cleanly.
"""

from __future__ import annotations

import fnmatch
import json
import os
import signal
import struct
import time
import zlib
from typing import List, Optional, Sequence, Tuple

from . import diskio, faults

MODEL_MAGIC = b"CXTPU001"
MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_FORMAT = 1


class CheckpointError(RuntimeError):
    """A checkpoint failed validation or could not be written/read."""


class DivergenceError(RuntimeError):
    """A training step's loss tripped the divergence guard (non-finite,
    or a finite spike past ``divergence_loss_ratio``).

    Raised by ``NetTrainer`` when ``divergence_policy`` is set; carries
    the loss value(s) read and the update they tripped at, for the task
    CLI's report."""

    def __init__(self, message: str, loss=None, epoch: Optional[int] = None):
        super().__init__(message)
        self.loss = loss
        self.epoch = epoch


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a crash at any point leaves
    either the old file or the new one, never a truncation.  The write
    goes through :func:`~cxxnet_tpu_torch.utils.diskio.write_atomic` at
    the ``checkpoint.write`` fault site (recorded under
    ``diskio.recording``)."""
    diskio.write_atomic(path, data, site="checkpoint.write")


def crc32_of(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            crc = zlib.crc32(b, crc)
    return crc & 0xFFFFFFFF


def net_fingerprint(structure_json: str) -> str:
    """Stable fingerprint of a net's structure (key-order independent)."""
    canon = json.dumps(json.loads(structure_json), sort_keys=True,
                       separators=(",", ":"))
    return f"{crc32_of(canon.encode('utf-8')):08x}"


def manifest_path(model_path: str) -> str:
    return model_path + MANIFEST_SUFFIX


def write_manifest(model_path: str, blob: bytes,
                   round_: Optional[int] = None,
                   net_fp: Optional[str] = None,
                   quant: Optional[dict] = None,
                   probe: Optional[dict] = None,
                   mesh: Optional[dict] = None) -> dict:
    """Write the sidecar manifest for an already-written checkpoint whose
    exact bytes are ``blob``; written after the checkpoint, so a
    manifest's existence implies its checkpoint was fully durable.  The
    port writes no updater state (``save_ustate`` 0).  ``quant``
    (``{"scheme", "scales_dtype", "int8_layers", "bf16_layers", ...}``)
    marks a quantized inference artifact (``nnet/quant.py``); it is
    absent on f32 checkpoints.  ``probe`` (``{"seed", "rows", "shape",
    "backend", "crc32"?}``, ``integrity/canary.py``) commits the serving
    canary's probe batch and, when the writer scored it, its golden
    score CRC.  ``mesh`` (``{"n_data", "n_model", "zero", "processes"}``)
    records the layout that wrote it, informational only: the payload
    holds gathered whole arrays, which load onto any number of ranks."""
    man = {
        "format": MANIFEST_FORMAT,
        "crc32": crc32_of(blob),
        "size": len(blob),
        "round": round_,
        "net_fingerprint": net_fp,
        "save_ustate": 0,
        "time": time.time(),
    }
    if mesh is not None:
        man["mesh"] = mesh
    if quant is not None:
        man["quant"] = quant
    if probe is not None:
        man["probe"] = probe
    atomic_write_bytes(manifest_path(model_path),
                       (json.dumps(man, indent=1) + "\n").encode("utf-8"))
    return man


def write_checkpoint(path: str, blob: bytes, round_: Optional[int] = None,
                     net_fp: Optional[str] = None,
                     quant: Optional[dict] = None,
                     probe: Optional[dict] = None,
                     mesh: Optional[dict] = None) -> None:
    """Atomic payload write, then the sidecar manifest, inside the
    ``checkpoint.write`` span; a ``checkpoint.save`` event either way
    (``ok`` false, with the error, when a write raised)."""
    from ..obs import events as obs_events
    from ..obs import trace as obs_trace

    try:
        with obs_trace.span("checkpoint.write", path=path, bytes=len(blob)):
            atomic_write_bytes(path, blob)
            write_manifest(path, blob, round_=round_, net_fp=net_fp,
                           quant=quant, probe=probe, mesh=mesh)
    except Exception as e:
        obs_events.emit("checkpoint.save", ok=False, path=path, round=round_,
                        error=f"{type(e).__name__}: {e}")
        raise
    obs_events.emit("checkpoint.save", ok=True, path=path, round=round_,
                    bytes=len(blob))


def read_manifest(model_path: str) -> Optional[dict]:
    """The checkpoint's manifest, or None if absent/unparseable."""
    try:
        with open(manifest_path(model_path), "r", encoding="utf-8") as f:
            man = json.load(f)
        return man if isinstance(man, dict) else None
    except (OSError, ValueError):
        return None


def validate_checkpoint(model_path: str,
                        net_fp: Optional[str] = None) -> Optional[str]:
    """None when the checkpoint is valid, else a human-readable reason.

    With a manifest: byte size and CRC32 must match, and — when both
    sides carry one — the net fingerprint too.  Without a manifest:
    structural checks only (magic, parseable header)."""
    try:
        faults.fault_point("checkpoint.read")
        size = os.path.getsize(model_path)
    except OSError as e:
        return f"unreadable: {e}"
    man = read_manifest(model_path)
    if man is not None:
        if man.get("size") != size:
            return f"size mismatch: manifest {man.get('size')}, file {size}"
        try:
            crc = crc32_file(model_path)
        except OSError as e:
            return f"unreadable: {e}"
        if man.get("crc32") != crc:
            return (f"crc32 mismatch: manifest {man.get('crc32'):#010x}, "
                    f"file {crc:#010x}")
        mfp = man.get("net_fingerprint")
        if net_fp is not None and mfp is not None and mfp != net_fp:
            return (f"net fingerprint mismatch: checkpoint {mfp}, "
                    f"current conf {net_fp} (different netconfig)")
        return None
    try:
        with open(model_path, "rb") as f:
            if f.read(8) != MODEL_MAGIC:
                return "bad magic (not a cxxnet-tpu model file)"
            raw = f.read(4)
            if len(raw) < 4:
                return "truncated header length"
            (hlen,) = struct.unpack("<I", raw)
            hdr = f.read(hlen)
            if len(hdr) < hlen:
                return "truncated header"
            json.loads(hdr.decode("utf-8"))
    except (OSError, ValueError, UnicodeDecodeError) as e:
        return f"corrupt header: {e}"
    return None


def checkpoint_round(filename: str) -> Optional[int]:
    """Round number encoded in a ``NNNN.model`` filename, else None."""
    stem, _, ext = os.path.basename(filename).partition(".")
    if ext != "model" or not stem.isdigit():
        return None
    return int(stem)


def list_checkpoints(model_dir: str) -> List[Tuple[int, str]]:
    """All ``NNNN.model`` files in ``model_dir``, sorted by round."""
    try:
        names = os.listdir(model_dir)
    except OSError:
        return []
    out = []
    for n in fnmatch.filter(names, "*.model"):
        r = checkpoint_round(n)
        if r is not None:
            out.append((r, os.path.join(model_dir, n)))
    return sorted(out)


def apply_retention(model_dir: str, keep_latest: int,
                    silent: bool = True) -> List[str]:
    """Prune all but the newest ``keep_latest`` checkpoints (and their
    manifests) through ``diskio.unlink``; ``keep_latest <= 0`` keeps
    everything.  Returns the removed model paths."""
    if keep_latest <= 0:
        return []
    removed = []
    for _, path in list_checkpoints(model_dir)[:-keep_latest]:
        for p in (path, manifest_path(path)):
            try:
                diskio.unlink(p)
            except OSError:
                continue
        removed.append(path)
        if not silent:
            print(f"retention: removed {path}", flush=True)
    return removed


def find_latest_valid(model_dir: str, net_fp: Optional[str] = None,
                      silent: bool = False,
                      before: Optional[int] = None
                      ) -> Optional[Tuple[int, str]]:
    """Newest checkpoint that passes validation, scanning newest to
    oldest past corrupt ones; ``before`` excludes rounds >= it."""
    for round_, path in reversed(list_checkpoints(model_dir)):
        if before is not None and round_ >= before:
            continue
        reason = validate_checkpoint(path, net_fp=net_fp)
        if reason is None:
            return round_, path
        if not silent:
            print(f"checkpoint {path} skipped: {reason}", flush=True)
    return None


# ----------------------------------------------------------------------
# the publish pointer (the closed loop, loop/publisher.py)
PUBLISH_POINTER = "PUBLISHED.json"


def publish_path(model_dir: str, round_: int) -> str:
    """The checkpoint path of a published round (``NNNN.model``, the
    name the trainer and the serving engine's discovery use)."""
    return os.path.join(model_dir, f"{round_:04d}.model")


def pointer_path(model_dir: str) -> str:
    return os.path.join(model_dir, PUBLISH_POINTER)


def write_publish_pointer(model_dir: str, round_: int, path: str,
                          net_fp: Optional[str] = None,
                          metric: Optional[dict] = None,
                          prev_round: Optional[int] = None,
                          lineage: Optional[dict] = None) -> dict:
    """Flip the publish pointer to ``round_``/``path`` atomically (site
    ``checkpoint.write``).  ``metric`` is the gate's ``{"name", "value",
    "cohorts"?}``, ``prev`` keeps the round served before, and
    ``lineage`` the feedback-log id range (and record and cycle counts)
    the published weights were fine-tuned on."""
    ptr = {
        "format": MANIFEST_FORMAT,
        "round": int(round_),
        "path": path,
        "net_fingerprint": net_fp,
        "metric": metric,
        "prev": ({"round": int(prev_round)}
                 if prev_round is not None else None),
        "lineage": lineage,
        "time": time.time(),
    }
    atomic_write_bytes(pointer_path(model_dir),
                       (json.dumps(ptr, indent=1) + "\n").encode("utf-8"))
    return ptr


def read_publish_pointer(model_dir: str) -> Optional[dict]:
    """The current publish pointer, or None if absent or unparseable."""
    try:
        with open(pointer_path(model_dir), "r", encoding="utf-8") as f:
            ptr = json.load(f)
        if isinstance(ptr, dict) and "round" in ptr and "path" in ptr:
            return ptr
    except (OSError, ValueError):
        pass
    return None


class PreemptionHandler:
    """Cooperative SIGTERM/SIGINT handling for the train loop: the first
    signal sets ``requested`` (the loop finishes its batch, snapshots and
    exits 0); a second one restores the previous handlers and re-sends
    itself (force quit)."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT)) -> None:
        self.signals = tuple(signals)
        self.requested = False
        self._prev: dict = {}

    def _handle(self, signum, frame):
        if self.requested:
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        print(f"received signal {signal.Signals(signum).name}: finishing the "
              "current step, then checkpointing and exiting (signal again "
              "to force quit)", flush=True)

    def install(self) -> "PreemptionHandler":
        if not self._prev:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
