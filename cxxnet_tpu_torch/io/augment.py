"""Per-instance augmentation: crop, mirror, mean subtraction, jitter, affine.

The port's copy of ``cxxnet_tpu/io/augment.py``: crop (random, or fixed
by ``crop_y_start``/``crop_x_start``), mirror, the mean image
(``image_mean``) or per-channel ``mean_value`` (given b,g,r as in the
reference's files and applied to the RGB channels reversed), contrast and
illumination jitter, ``divideby``/``scale``, and the affine keys
(``max_rotate_angle``, ``max_shear_ratio``, ``max_aspect_ratio``,
``rotate``, ``rotate_list``, ``min/max_random_scale``,
``min/max_crop_size``) as one PIL warp.

Every random draw of a record is a hash of ``(seed_data, epoch, record
index, slot)`` (SplitMix64 on numpy ``uint64``, 53 bits to a float64),
so the stream depends only on the records and the epoch, never on the
decode workers, the buffers or where an epoch was resumed, and it is
bit-equal to the JAX package's.  The no-affine case has a whole-batch
vectorized path (``augment_batch``), bit-equal to the per-record one.

The epoch: each ``before_first()`` advances it by one, and
``augment_epoch`` sets it outright, as in the JAX package.
``augment_epoch_next = r`` is the port's anchor: the next rewind (or,
when the batch layer goes on from a wrap point, ``resume_epoch()``)
takes epoch r instead of advancing.  The CLI sets it before each
round's rewind, and ``threadbuffer`` hands it to its producer with that
rewind, so round r draws epoch r with or without the buffer.

The mean image is loaded from ``image_mean``, or made in one pass over
the data (epoch ``MEAN_PASS_EPOCH``, no mean subtracted, float64 sums in
record order) and saved with ``np.savez``, which appends ``.npz`` to the
name: the next run does not find it under ``image_mean`` and makes it
again, as the JAX package does (ROADMAP.md §C).  Files are interchanged
with the JAX package both ways.

PIL is imported only for the affine warp and the split decode path;
without it an affine key refuses at ``init()``, naming the key.
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..utils.profiler import pipeline_stats
from .batch import DataInst, InstIterator
from .imgbin import pil_image

_RAND_MAGIC = 111

#: The epoch anchor's key: the epoch the next rewind takes.
ANCHOR_KEY = "augment_epoch_next"

#: epoch index for draws made outside the training epoch sequence (the
#: first-run mean-image pass).  Training epochs start at 1 (the first
#: ``before_first`` of the chain), so 0 never collides.
MEAN_PASS_EPOCH = 0

_M64 = (1 << 64) - 1
_SLOT_ODD = 0x9E3779B97F4A7C15  # golden-ratio odd constant


def _splitmix64(z: int) -> int:
    """SplitMix64 finalizer (python-int form, exact 64-bit wrap)."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def _splitmix64_vec(z: np.ndarray) -> np.ndarray:
    """SplitMix64 over a uint64 array (wrapping arithmetic)."""
    z = (z + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def record_key(seed_base: int, epoch: int, index: int) -> int:
    """The record's 64-bit RNG key: a SplitMix64 chain over
    ``(seed_data, epoch, record index)``."""
    h = _splitmix64(seed_base & _M64)
    h = _splitmix64(h ^ (epoch & _M64))
    return _splitmix64(h ^ (index & _M64))


def record_key_vec(seed_base: int, epoch: int,
                   indices: np.ndarray) -> np.ndarray:
    """Vectorized :func:`record_key` over an index array."""
    h = _splitmix64(seed_base & _M64)
    h = _splitmix64(h ^ (epoch & _M64))
    return _splitmix64_vec(np.uint64(h) ^ indices.astype(np.uint64))


def _slot_hash_vec(keys: np.ndarray, slot: int) -> np.ndarray:
    return _splitmix64_vec(keys ^ np.uint64((slot * _SLOT_ODD) & _M64))


def _u53(h) -> np.ndarray:
    """uint64 hash → uniform float64 in [0, 1) (53 mantissa bits)."""
    return (h >> np.uint64(11)) * (1.0 / (1 << 53))


# Fixed draw-slot assignments: every random decision of a record has a
# NAMED slot, so any pipeline stage — serial loop, vectorized batch,
# PIL-side decode worker, consumer-side float tail — can (re)compute
# exactly the draw it needs from ``(seed_data, epoch, index, slot)``
# without any other stage having run first.
S_CROP_Y = 0
S_CROP_X = 1
S_CONTRAST = 2
S_ILLUM = 3
S_MIRROR = 4
S_AFF_ANGLE = 8
S_AFF_ROTPICK = 9
S_AFF_SHEAR = 10
S_AFF_SCALE = 11
S_AFF_RATIO = 12
S_AFF_CSIZE = 13
S_AFF_CS_Y = 14
S_AFF_CS_X = 15


class RecordRNG:
    """Stateless per-record RNG: draw ``slot`` of record ``r`` is a pure
    hash of ``(seed_data, epoch, record index, slot)`` — no shared or
    sequential state, ~1 µs per draw (a seeded ``RandomState``/
    ``Philox`` object costs 30-150 µs to CONSTRUCT, which at JPEG-decode
    rates was itself a pipeline stage).  Slot draws vectorize exactly
    (:func:`_slot_hash_vec`), and fixed slot numbers mean different
    pipeline stages can recompute each other's draws independently."""

    __slots__ = ("key",)

    def __init__(self, key: int) -> None:
        self.key = key

    def _hash(self, slot: int) -> int:
        return _splitmix64(self.key ^ ((slot * _SLOT_ODD) & _M64))

    def rand(self, slot: int) -> float:
        """Uniform float64 in [0, 1)."""
        return (self._hash(slot) >> 11) * (1.0 / (1 << 53))

    def uniform(self, slot: int, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + (hi - lo) * self.rand(slot)

    def randint(self, slot: int, lo: int, hi: Optional[int] = None) -> int:
        """Integer in [lo, hi) (or [0, lo) with one argument) — modulo
        reduction; the negligible bias is part of the defined stream."""
        if hi is None:
            lo, hi = 0, lo
        return lo + self._hash(slot) % (hi - lo)


#: The affine keys, each with the test of whether it is set: each needs
#: PIL, and ``init()`` names the first one set when PIL is missing.
_AFFINE_KEYS = (
    ("max_rotate_angle", lambda a: a.max_rotate_angle > 0),
    ("max_shear_ratio", lambda a: a.max_shear_ratio > 0),
    ("max_aspect_ratio", lambda a: a.max_aspect_ratio > 0),
    ("rotate", lambda a: a.rotate >= 0),
    ("rotate_list", lambda a: bool(a.rotate_list)),
    ("min_random_scale", lambda a: a.min_random_scale != 1.0),
    ("max_random_scale", lambda a: a.max_random_scale != 1.0),
    ("min_crop_size", lambda a: a.min_crop_size > 0),
)


class AugmentIterator(InstIterator):
    def supports_dist_shard(self) -> bool:
        return self.base.supports_dist_shard()

    def __init__(self, base: InstIterator) -> None:
        self.base = base
        self.shape = (0, 0, 0)           # (C,H,W) net convention
        self.rand_crop = 0
        self.rand_mirror = 0
        self.mirror = 0
        self.crop_y_start = -1
        self.crop_x_start = -1
        self.scale = 1.0
        self.silent = 0
        self.name_meanimg = ""
        self.mean_value: Optional[np.ndarray] = None  # per-channel, RGB order
        self.max_random_contrast = 0.0
        self.max_random_illumination = 0.0
        # affine params (image_augmenter)
        self.max_rotate_angle = 0.0
        self.max_shear_ratio = 0.0
        self.max_aspect_ratio = 0.0
        self.min_crop_size = -1
        self.max_crop_size = -1
        self.rotate = -1.0
        self.rotate_list: List[int] = []
        self.min_random_scale = 1.0
        self.max_random_scale = 1.0
        self.min_img_size = 0.0
        self.max_img_size = 1e10
        self.fill_value = 255
        self._seed_base = _RAND_MAGIC
        self._epoch = 0          # bumped by every before_first()
        self._anchor: Optional[int] = None  # augment_epoch_next
        self._meanimg: Optional[np.ndarray] = None
        self._out: Optional[DataInst] = None

    def set_param(self, name, val):
        self.base.set_param(name, val)
        if name == "input_shape":
            c, h, w = (int(t) for t in val.split(","))
            self.shape = (c, h, w)
        elif name == "seed_data":
            self._seed_base = (_RAND_MAGIC + int(val)) & 0xFFFFFFFF
        elif name == "augment_epoch":
            self._epoch = int(val)
        elif name == ANCHOR_KEY:
            self._anchor = int(val)
        elif name == "rand_crop":
            self.rand_crop = int(val)
        elif name == "rand_mirror":
            self.rand_mirror = int(val)
        elif name == "mirror":
            self.mirror = int(val)
        elif name == "crop_y_start":
            self.crop_y_start = int(val)
        elif name == "crop_x_start":
            self.crop_x_start = int(val)
        elif name == "divideby":
            self.scale = 1.0 / float(val)
        elif name == "scale":
            self.scale = float(val)
        elif name == "image_mean":
            self.name_meanimg = val
        elif name == "mean_value":
            b, g, r = (float(t) for t in val.split(","))
            self.mean_value = np.asarray([r, g, b], np.float32)  # RGB order
        elif name == "max_random_contrast":
            self.max_random_contrast = float(val)
        elif name == "max_random_illumination":
            self.max_random_illumination = float(val)
        elif name == "max_rotate_angle":
            self.max_rotate_angle = float(val)
        elif name == "max_shear_ratio":
            self.max_shear_ratio = float(val)
        elif name == "max_aspect_ratio":
            self.max_aspect_ratio = float(val)
        elif name == "min_crop_size":
            self.min_crop_size = int(val)
        elif name == "max_crop_size":
            self.max_crop_size = int(val)
        elif name == "rotate":
            self.rotate = float(val)
        elif name == "rotate_list":
            self.rotate_list = [int(t) for t in val.replace(",", " ").split()]
        elif name == "min_random_scale":
            self.min_random_scale = float(val)
        elif name == "max_random_scale":
            self.max_random_scale = float(val)
        elif name == "min_img_size":
            self.min_img_size = float(val)
        elif name == "max_img_size":
            self.max_img_size = float(val)
        elif name == "fill_value":
            self.fill_value = int(val)
        elif name == "silent":
            self.silent = int(val)

    # ------------------------------------------------------------------
    # deterministic per-record RNG
    @property
    def epoch(self) -> int:
        """Current epoch index (count of ``before_first`` calls)."""
        return self._epoch

    def record_rng(self, epoch: int, index: int) -> RecordRNG:
        """The record's private RNG: keyed by ``(seed_data, epoch,
        record index)``, so the same record in the same epoch draws the
        same augmentation no matter which worker processes it, in what
        order, or whether the epoch was restarted mid-way."""
        return RecordRNG(record_key(self._seed_base, epoch, index))

    def _affine_active(self) -> bool:
        """True when :meth:`_affine` does work (and draws)."""
        return any(test(self) for _, test in _AFFINE_KEYS)

    def _stochastic(self) -> bool:
        """Does augmenting a record consume any random draw?"""
        return (
            self._affine_active()
            or bool(self.rand_crop)
            or bool(self.rand_mirror)
            or self.max_random_contrast > 0
            or self.max_random_illumination > 0
        )

    def vectorizable(self) -> bool:
        """True when the whole-batch fast path applies: no affine warp
        (everything else — crop / mirror / mean / contrast /
        illumination / scale — vectorizes exactly)."""
        return not self._affine_active()

    # ------------------------------------------------------------------
    def init(self):
        for key, test in _AFFINE_KEYS:
            if test(self):
                pil_image(key)
                break
        self.base.init()
        if self.name_meanimg:
            if os.path.exists(self.name_meanimg):
                with np.load(self.name_meanimg) as z:
                    self._meanimg = z["mean"]
                if not self.silent:
                    print(f"loading mean image from {self.name_meanimg}")
            else:
                self._create_mean_img()

    def _create_mean_img(self):
        """The mean image, made in one pass before the pool starts:
        chunks of records augmented as a stack (epoch
        ``MEAN_PASS_EPOCH``, no mean subtracted), summed in float64 one
        record at a time in record order, as the JAX package sums."""
        if not self.silent:
            print(f"cannot find {self.name_meanimg}: creating mean image...")
        total, cnt = None, 0
        chunk = 64
        self.base.before_first()
        more = True
        while more:
            insts: List[DataInst] = []
            while len(insts) < chunk:
                if not self.base.next():
                    more = False
                    break
                insts.append(self.base.value())
            if not insts:
                break
            for d in self.augment_insts(insts, MEAN_PASS_EPOCH,
                                        apply_mean=False):
                total = (d.data.astype(np.float64) if total is None
                         else total + d.data)
                cnt += 1
        if total is None:
            raise ValueError("AugmentIterator: empty input, cannot build mean image")
        self._meanimg = (total / cnt).astype(np.float32)
        np.savez(self.name_meanimg, mean=self._meanimg)
        if not self.silent:
            print(f"saved mean image to {self.name_meanimg} ({cnt} images)")
        self.base.before_first()

    def before_first(self):
        self._epoch = self._epoch + 1 if self._anchor is None else self._anchor
        self._anchor = None
        self.base.before_first()

    def resume_epoch(self):
        if self._anchor is not None:
            self._epoch, self._anchor = self._anchor, None
        self.base.resume_epoch()

    def next(self) -> bool:
        if not self.base.next():
            return False
        d = self.base.value()
        t0 = time.perf_counter()
        rng = (self.record_rng(self._epoch, d.index)
               if self._stochastic() else None)
        self._out = self._augmented(d, apply_mean=True, rng=rng)
        pipeline_stats().add("augment", time.perf_counter() - t0)
        return True

    def value(self) -> DataInst:
        if self._out is None:
            raise RuntimeError("AugmentIterator: value() before next()")
        return self._out

    def close(self) -> None:
        self.base.close()

    # ------------------------------------------------------------------
    def _affine(self, img: np.ndarray, rng) -> np.ndarray:
        """Rotation/shear/scale/aspect as one warp (image_augmenter:75-123)."""
        if not self._affine_active():
            return img
        Image = pil_image("the affine augmentation")

        angle = 0.0
        if self.max_rotate_angle > 0:
            angle = rng.uniform(S_AFF_ANGLE, -self.max_rotate_angle,
                                self.max_rotate_angle)
        if self.rotate > 0:
            angle = self.rotate
        if self.rotate_list:
            angle = float(self.rotate_list[
                rng.randint(S_AFF_ROTPICK, len(self.rotate_list))])
        s = (rng.uniform(S_AFF_SHEAR, -self.max_shear_ratio,
                         self.max_shear_ratio)
             if self.max_shear_ratio > 0 else 0.0)
        scale = rng.uniform(S_AFF_SCALE, self.min_random_scale,
                            self.max_random_scale)
        ratio = (rng.uniform(S_AFF_RATIO, -self.max_aspect_ratio,
                             self.max_aspect_ratio) + 1.0
                 if self.max_aspect_ratio > 0 else 1.0)
        hs = 2.0 * scale / (1.0 + ratio)
        ws = ratio * hs
        a = math.cos(math.radians(angle))
        b = math.sin(math.radians(angle))
        h, w = img.shape[:2]
        # forward warp matrix, exact parity with the reference
        # (image_augmenter-inl.hpp:96-104): dst = M @ (src_x, src_y) + t,
        # centered in a (new_w, new_h) = scale-clamped output canvas
        m00 = hs * a - s * b * ws
        m01 = hs * b + s * a * ws
        m10 = -b * ws
        m11 = a * ws
        new_w = int(round(max(self.min_img_size, min(self.max_img_size, scale * w))))
        new_h = int(round(max(self.min_img_size, min(self.max_img_size, scale * h))))
        tx = (new_w - (m00 * w + m01 * h)) / 2.0
        ty = (new_h - (m10 * w + m11 * h)) / 2.0
        det = m00 * m11 - m01 * m10
        if abs(det) < 1e-8:
            return img
        # PIL wants the inverse map (output coords → input coords)
        i00, i01 = m11 / det, -m01 / det
        i10, i11 = -m10 / det, m00 / det
        coeffs = (
            i00, i01, -(i00 * tx + i01 * ty),
            i10, i11, -(i10 * tx + i11 * ty),
        )
        mode = "F" if img.ndim == 2 or img.shape[2] == 1 else "RGB"
        if mode == "RGB":
            pim = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")
        else:
            pim = Image.fromarray(img.reshape(h, w).astype(np.float32), "F")
        pim = pim.transform(
            (new_w, new_h), Image.AFFINE, coeffs,
            resample=Image.BILINEAR, fillcolor=self.fill_value,
        )
        out = np.asarray(pim, np.float32)
        if out.ndim == 2:
            out = out[..., None]
        # random crop-size: crop a random square then resize back (bowl.conf)
        if self.min_crop_size > 0 and self.max_crop_size >= self.min_crop_size:
            cs = rng.randint(S_AFF_CSIZE, self.min_crop_size,
                             self.max_crop_size + 1)
            cs = min(cs, out.shape[0], out.shape[1])
            yy = rng.randint(S_AFF_CS_Y, out.shape[0] - cs + 1)
            xx = rng.randint(S_AFF_CS_X, out.shape[1] - cs + 1)
            patch = out[yy : yy + cs, xx : xx + cs]
            if mode == "RGB":
                pim2 = Image.fromarray(np.clip(patch, 0, 255).astype(np.uint8), "RGB")
                pim2 = pim2.resize((w, h), Image.BILINEAR)
                out = np.asarray(pim2, np.float32)
            else:
                pim2 = Image.fromarray(patch.reshape(cs, cs), "F").resize((w, h), Image.BILINEAR)
                out = np.asarray(pim2, np.float32)[..., None]
        return out

    def _augmented(self, d: DataInst, *, apply_mean: bool,
                   rng=None) -> DataInst:
        """SetData parity (iter_augment_proc-inl.hpp:98-162), HWC layout.

        ``rng`` is the record's private RandomState (None when no random
        augmentation is armed — no draw then happens)."""
        c, th, tw = self.shape
        data = d.data.astype(np.float32)
        if c == 1 and th == 1:
            return DataInst(d.index, data.reshape(-1) * self.scale, d.label)
        if data.ndim == 2:
            data = data[..., None]
        data = self._affine(data, rng)
        h, w = data.shape[:2]
        if h < th or w < tw:
            raise ValueError("data size must be at least the net input size")
        yy_max, xx_max = h - th, w - tw
        if self.rand_crop and (yy_max or xx_max):
            yy = rng.randint(S_CROP_Y, yy_max + 1)
            xx = rng.randint(S_CROP_X, xx_max + 1)
        else:
            yy, xx = yy_max // 2, xx_max // 2
        if h != th and self.crop_y_start != -1:
            yy = self.crop_y_start
        if w != tw and self.crop_x_start != -1:
            xx = self.crop_x_start
        contrast = 1.0
        illumination = 0.0
        if self.max_random_contrast > 0:
            contrast = rng.uniform(S_CONTRAST, 1 - self.max_random_contrast,
                                   1 + self.max_random_contrast)
        if self.max_random_illumination > 0:
            illumination = rng.uniform(
                S_ILLUM, -self.max_random_illumination,
                self.max_random_illumination,
            )
        do_mirror = self.mirror == 1 or (
            self.rand_mirror and rng.rand(S_MIRROR) < 0.5)

        if apply_mean and self.mean_value is not None:
            data = data - self.mean_value[: data.shape[2]]
            img = data[yy : yy + th, xx : xx + tw] * contrast + illumination
        elif apply_mean and self._meanimg is not None:
            if self._meanimg.shape == data.shape:
                data = data - self._meanimg
                img = data[yy : yy + th, xx : xx + tw] * contrast + illumination
            else:
                img = data[yy : yy + th, xx : xx + tw]
                if self._meanimg.shape == img.shape:
                    img = img - self._meanimg
                img = img * contrast + illumination
        else:
            img = data[yy : yy + th, xx : xx + tw]
        if do_mirror:
            img = img[:, ::-1]
        return DataInst(d.index, np.ascontiguousarray(img) * self.scale, d.label)

    # ------------------------------------------------------------------
    # whole-batch vectorized fast path
    def augment_insts(self, insts: Sequence[DataInst], epoch: int, *,
                      apply_mean: bool = True) -> List[DataInst]:
        """Augment a window of records, vectorized when possible.

        Uses :meth:`augment_batch` when no affine warp is armed and the
        decoded images share one shape; falls back to the per-record
        path otherwise.  Either way the output is bitwise-identical to
        calling :meth:`_augmented` record by record — the random draws
        come from the same per-record RNGs."""
        if not insts:
            return []
        c, th, tw = self.shape
        flat = c == 1 and th == 1
        shapes = {tuple(d.data.shape) for d in insts}
        if (not flat and len(shapes) == 1 and self.vectorizable()
                and len(next(iter(shapes))) >= 2):
            # native dtype (uint8 from the decoder): float32 conversion
            # happens during the crop copy — exact, 4x less bandwidth
            stack = np.stack([
                d.data if d.data.ndim == 3 else d.data[..., None]
                for d in insts
            ])
            out = self.augment_batch(
                stack, [d.index for d in insts], epoch,
                apply_mean=apply_mean,
            )
            return [DataInst(d.index, out[i], d.label)
                    for i, d in enumerate(insts)]
        out_insts = []
        for d in insts:
            rng = (self.record_rng(epoch, d.index)
                   if self._stochastic() else None)
            out_insts.append(self._augmented(d, apply_mean=apply_mean,
                                             rng=rng))
        return out_insts

    def augment_batch(self, stack: np.ndarray, indices: Sequence[int],
                      epoch: int, *, apply_mean: bool = True) -> np.ndarray:
        """Vectorized ``_augmented`` over a uniform ``(N, H, W, C)``
        stack (uint8 or float32) — the no-affine fast path: crop,
        mirror, mean-subtract, contrast, illumination and scale as
        batch-level numpy ops, float32 out.  Bitwise-identical to the
        per-record path: the draws come from the same per-record slot
        hashes (vectorized here), uint8→float32 conversion is exact on
        either side of the crop, and every float op is the same
        elementwise float32 operation in the same order."""
        if not self.vectorizable():
            raise ValueError("augment_batch: the affine warp has no batch "
                             "path")
        n, h, w, cdim = stack.shape
        _, th, tw = self.shape
        if h < th or w < tw:
            raise ValueError("data size must be at least the net input size")
        yy_max, xx_max = h - th, w - tw
        yy = np.full(n, yy_max // 2, np.intp)
        xx = np.full(n, xx_max // 2, np.intp)
        contrast = None
        illum = None
        do_mirror = np.full(n, self.mirror == 1)
        # per-record fixed-slot draws, vectorized — the same hashes the
        # per-record RecordRNG computes in _augmented
        if self._stochastic():
            keys = record_key_vec(
                self._seed_base, epoch,
                np.asarray(indices, np.int64).astype(np.uint64),
            )
            if self.rand_crop and (yy_max or xx_max):
                yy = (_slot_hash_vec(keys, S_CROP_Y)
                      % np.uint64(yy_max + 1)).astype(np.intp)
                xx = (_slot_hash_vec(keys, S_CROP_X)
                      % np.uint64(xx_max + 1)).astype(np.intp)
            if self.max_random_contrast > 0:
                lo, hi = (1 - self.max_random_contrast,
                          1 + self.max_random_contrast)
                contrast = lo + (hi - lo) * _u53(
                    _slot_hash_vec(keys, S_CONTRAST))
            if self.max_random_illumination > 0:
                lo, hi = (-self.max_random_illumination,
                          self.max_random_illumination)
                illum = lo + (hi - lo) * _u53(_slot_hash_vec(keys, S_ILLUM))
            if self.mirror != 1 and self.rand_mirror:
                do_mirror = _u53(_slot_hash_vec(keys, S_MIRROR)) < 0.5
        if h != th and self.crop_y_start != -1:
            yy[:] = self.crop_y_start
        if w != tw and self.crop_x_start != -1:
            xx[:] = self.crop_x_start

        # crop + mirror in ONE cast-copy per record: the mirrored
        # records read their window with a reversed W stride, so the
        # uint8→float32 conversion, the crop copy, and the flip are a
        # single pass (an in-place ``out[m] = out[m, :, ::-1]`` is ~6x
        # slower — overlapping-buffer reversal takes numpy's buffered
        # path).  Mirroring commutes with every elementwise op below,
        # so doing it first is bitwise-identical to the per-record
        # order (jitter, then flip).
        out = np.empty((n, th, tw, cdim), np.float32)
        for i in range(n):
            win = stack[i, yy[i]: yy[i] + th, xx[i]: xx[i] + tw]
            out[i] = win[:, ::-1] if do_mirror[i] else win

        jitter = False
        if apply_mean and self.mean_value is not None:
            out -= self.mean_value[:cdim]  # per-channel: flip-invariant
            jitter = True
        elif apply_mean and self._meanimg is not None:
            if self._meanimg.shape == stack.shape[1:]:
                # mean is full-size: subtract each record's crop
                # window, mirrored along with the record
                for i in range(n):
                    mwin = self._meanimg[yy[i]: yy[i] + th,
                                         xx[i]: xx[i] + tw]
                    out[i] -= mwin[:, ::-1] if do_mirror[i] else mwin
            elif self._meanimg.shape == out.shape[1:]:
                for i in range(n):
                    out[i] -= (self._meanimg[:, ::-1] if do_mirror[i]
                               else self._meanimg)
            jitter = True
        if jitter:
            # float32-cast per-record scalars: elementwise identical to
            # the serial path's python-float (weak-promotion) arithmetic
            if contrast is not None:
                out *= contrast.astype(np.float32)[:, None, None, None]
            if illum is not None:
                out += illum.astype(np.float32)[:, None, None, None]
        if self.scale != 1.0:  # x * 1.0 is a bitwise identity
            out *= np.float32(self.scale)
        return out

    # ------------------------------------------------------------------
    # split decode-worker fast path: PIL-side crop+mirror, float tail
    # on the consumer (io/pipeline.py).  Rationale: a decode worker that
    # only runs PIL C ops (decode, crop, flip — all GIL-releasing) and
    # hands back the small uint8 window scales across cores; the float32
    # arithmetic runs once, vectorized, on the consumer thread.
    def pil_path_ok(self, apply_mean: bool = True) -> bool:
        """Can a decode worker run :meth:`augment_pil`?  Static per
        config: no affine warp, a real 2-D crop target, and no
        full-image mean (its subtract window needs the pre-crop image
        size, which the split path no longer has)."""
        c, th, tw = self.shape
        if c == 1 and th == 1:
            return False  # flat vectors never touch PIL
        if not self.vectorizable():
            return False
        if (apply_mean and self._meanimg is not None
                and self._meanimg.shape != (th, tw, c)):
            return False
        return True

    def tail_identity(self, apply_mean: bool = True) -> bool:
        """True when the post-crop float tail does nothing: the uint8
        crop IS the augmented record (the batch collator's store-cast
        to float32 is exact), so nobody pays for a float pass."""
        return (self.scale == 1.0
                and self.max_random_contrast <= 0
                and self.max_random_illumination <= 0
                and not (apply_mean and (self.mean_value is not None
                                         or self._meanimg is not None)))

    def augment_pil(self, im, index: int, labels, epoch: int) -> DataInst:
        """Worker half of the split path: crop + mirror as PIL C-level
        ops on the decoded uint8 image (bit-exact vs numpy slicing),
        returning a uint8 ``DataInst``.  Run :meth:`augment_tail` on
        the result unless :meth:`tail_identity`."""
        Image = pil_image("raw_pixels = 0")

        _, th, tw = self.shape
        w, h = im.size
        if h < th or w < tw:
            raise ValueError("data size must be at least the net input size")
        rng = (self.record_rng(epoch, index) if self._stochastic() else None)
        yy_max, xx_max = h - th, w - tw
        if self.rand_crop and (yy_max or xx_max):
            yy = rng.randint(S_CROP_Y, yy_max + 1)
            xx = rng.randint(S_CROP_X, xx_max + 1)
        else:
            yy, xx = yy_max // 2, xx_max // 2
        if h != th and self.crop_y_start != -1:
            yy = self.crop_y_start
        if w != tw and self.crop_x_start != -1:
            xx = self.crop_x_start
        do_mirror = self.mirror == 1 or (
            self.rand_mirror and rng.rand(S_MIRROR) < 0.5)
        if (yy, xx) != (0, 0) or (h, w) != (th, tw):
            im = im.crop((xx, yy, xx + tw, yy + th))
        if do_mirror:
            im = im.transpose(Image.FLIP_LEFT_RIGHT)
        return DataInst(index, np.asarray(im), labels)

    def augment_tail(self, insts: Sequence[DataInst], epoch: int, *,
                     apply_mean: bool = True) -> List[DataInst]:
        """Consumer half of the split path: the float32 tail
        (mean-subtract, contrast/illumination, scale) vectorized over
        the uniform uint8 crops :meth:`augment_pil` produced.  Bitwise
        equal to the serial ``_augmented`` tail: the crops are already
        mirrored, and every tail op commutes with the flip (the
        crop-sized mean window is flipped to compensate)."""
        if not insts or self.tail_identity(apply_mean):
            return list(insts)
        n = len(insts)
        out = np.stack([d.data for d in insts]).astype(np.float32)
        jitter = False
        if apply_mean and self.mean_value is not None:
            out -= self.mean_value[: out.shape[3]]
            jitter = True
        elif apply_mean and self._meanimg is not None:
            if self._meanimg.shape == out.shape[1:]:
                if self.mirror == 1 or self.rand_mirror:
                    keys = record_key_vec(
                        self._seed_base, epoch,
                        np.asarray([d.index for d in insts],
                                   np.int64).astype(np.uint64),
                    )
                    mirrored = (np.full(n, True) if self.mirror == 1
                                else _u53(_slot_hash_vec(keys, S_MIRROR))
                                < 0.5)
                    for i in range(n):
                        out[i] -= (self._meanimg[:, ::-1] if mirrored[i]
                                   else self._meanimg)
                else:
                    out -= self._meanimg
            jitter = True
        if jitter and (self.max_random_contrast > 0
                       or self.max_random_illumination > 0):
            keys = record_key_vec(
                self._seed_base, epoch,
                np.asarray([d.index for d in insts],
                           np.int64).astype(np.uint64),
            )
            if self.max_random_contrast > 0:
                lo, hi = (1 - self.max_random_contrast,
                          1 + self.max_random_contrast)
                c = lo + (hi - lo) * _u53(_slot_hash_vec(keys, S_CONTRAST))
                out *= c.astype(np.float32)[:, None, None, None]
            if self.max_random_illumination > 0:
                lo, hi = (-self.max_random_illumination,
                          self.max_random_illumination)
                v = lo + (hi - lo) * _u53(_slot_hash_vec(keys, S_ILLUM))
                out += v.astype(np.float32)[:, None, None, None]
        if self.scale != 1.0:
            out *= np.float32(self.scale)
        return [DataInst(d.index, out[i], d.label)
                for i, d in enumerate(insts)]
