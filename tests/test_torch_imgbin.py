"""The imgbin chain of the port against the JAX package's, on the CPU.

* Page writers: each package's ``BinPageWriter`` (CXBP) and
  ``RefBinPageWriter`` (the reference's 64 MiB ``BinaryPage``) write
  byte-equal files from the same blobs, and each package reads the
  other's.
* The draws: ``record_key``, ``RecordRNG`` and the vectorized slot
  hashes equal the JAX package's over many (seed, epoch, index, slot).
* The chain (``BatchAdapt(ParallelAugment(Augment(source)))`` from
  ``create_iterator``): over three epochs each batch's data, labels,
  indices and padding are bit-equal to the JAX chain's, for raw and JPEG
  pages, every augmentation key, ``round_batch`` 0 and 1,
  ``test_skipread``, the pool at 1 and 4 workers, a mid-epoch rewind,
  ``image_conf_prefix`` and ``iter = img``; the mean image created and
  loaded, its file read by the other package both ways.
* Quarantine: corrupt records and pages under ``max_bad_records`` give
  the JAX package's skip counts and sidecars; the strict budget raises
  ``BadDataError``; ``fault_inject = imgbin.record:corrupt:...`` fires on
  the same records.
* The epoch anchor: the port's ``threadbuffer`` chain equals its plain
  chain each round, and both equal the JAX plain chain at the round's
  epoch; a resumed round draws the uninterrupted stream; through the
  CLI, 2 rounds equal 1 round plus a ``continue = 1`` round, bit for bit.
* A small inception net trained 2 rounds from imgbin pages by both CLIs
  (the JAX one in a subprocess), and ``pred_raw`` on a narrowed
  ``bowl.conf`` with ``pred.conf``'s section: checkpoints and outputs
  within the limits of ``tests/test_torch_mnist.py``.
* Without PIL each PIL path refuses at ``init()`` naming its key, and raw
  pages still run; a fault site the port does not visit raises; with
  ``dist_num_worker = 2`` (or ``PS_RANK``) each worker's shard files and
  equal-steps cap give the JAX package's batches.
"""

import contextlib
import io
import json
import os
import pathlib
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

from cxxnet_tpu.io import augment as jaug
from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.io import imgbin as jimgbin
from cxxnet_tpu.utils import faults as jfaults

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.io import augment as taug
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.io import imgbin as timgbin
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.utils import faults as tfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_TOL = 1e-5  # of each tensor's largest weight (test_torch_mnist.py)
TASK_ATOL = 1e-5   # pred_raw's printed values (test_torch_mnist.py)
N_RECORDS, SIDE, CROP = 37, 12, 8


@pytest.fixture(autouse=True)
def _faults_disarmed():
    yield
    tfaults.reset()
    jfaults.reset()


def _images(n, side, seed, channels=3):
    return (np.random.RandomState(seed).rand(n, side, side, channels)
            * 255).astype(np.float32)


def _jpeg(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def write_shard(d, name, imgs, fmt="cxbp", raw=True, page_size=5000,
                first=0):
    """``<d>/<name>.bin`` and ``.lst`` from ``imgs`` with the port's
    writers; record i has index ``first + i`` and label i % 5."""
    path = os.path.join(str(d), name)
    w = (timgbin.BinPageWriter(path + ".bin", page_size=page_size)
         if fmt == "cxbp" else timgbin.RefBinPageWriter(path + ".bin"))
    with open(path + ".lst", "w") as f:
        for i, img in enumerate(imgs):
            w.push(timgbin.encode_raw(img) if raw else _jpeg(img))
            f.write(f"{first + i}\t{i % 5}\timg{i}.jpg\n")
    w.close()
    return path + ".bin", path + ".lst"


def _entries(sources, extra=(), shape=f"3,{CROP},{CROP}", batch=5,
             it="imgbin", tail=()):
    """A data section; the JAX package reads with its Python reader
    (``native_decoder = 0``), as the port does."""
    out = [("iter", it), ("native_decoder", "0")]
    for b, l in sources:
        out += [("image_bin", b), ("image_list", l)] if b else \
            [("image_list", l)]
    out += [("silent", "1"), *extra, *tail, ("iter", "end"),
            ("input_shape", shape), ("batch_size", str(batch))]
    return out


def _pair(entries, port_extra=()):
    a = jdata.create_iterator(entries)
    b = tdata.create_iterator(list(entries) + list(port_extra))
    a.init()
    b.init()
    return a, b


def _epoch(it):
    out = []
    it.before_first()
    while it.next():
        v = it.value()
        out.append((v.data.copy(), v.label.copy(),
                    np.asarray(v.inst_index).copy(), v.num_batch_padd))
    return out


def _same(xs, ys):
    assert len(xs) == len(ys) and xs
    for (d, l, i, p), (d2, l2, i2, p2) in zip(xs, ys):
        assert d.dtype == d2.dtype == np.float32 and d.shape == d2.shape
        assert np.array_equal(d, d2) and np.array_equal(l, l2)
        assert np.array_equal(i, i2) and p == p2


def _three_epochs_equal(a, b):
    try:
        for _ in range(3):
            _same(_epoch(a), _epoch(b))
    finally:
        a.close()
        b.close()


# ----------------------------------------------------------------------
# pages and draws

@pytest.mark.parametrize("fmt", ["cxbp", "ref"])
def test_page_writers_byte_equal_and_read_both_ways(tmp_path, fmt):
    rs = np.random.RandomState(1)
    blobs = [rs.bytes(int(n)) for n in rs.randint(1, 3000, 23)]
    files = {}
    for pkg, mod in (("port", timgbin), ("jax", jimgbin)):
        path = str(tmp_path / f"{pkg}.bin")
        w = (mod.BinPageWriter(path, page_size=8000) if fmt == "cxbp"
             else mod.RefBinPageWriter(path))
        for b in blobs:
            w.push(b)
        w.close()
        files[pkg] = path
    port, ref = (pathlib.Path(files[k]).read_bytes() for k in ("port", "jax"))
    assert port == ref
    assert timgbin.detect_bin_format(files["jax"]) == fmt
    assert jimgbin.detect_bin_format(files["port"]) == fmt
    for reader, path in ((timgbin.iter_bin_pages, files["jax"]),
                         (jimgbin.iter_bin_pages, files["port"])):
        pages = [[bytes(b) for b in page] for page in reader(path)]
        assert [b for page in pages for b in page] == blobs
        assert len(pages) == 1 if fmt == "ref" else len(pages) > 3


def test_raw_blob_and_lst_line_match():
    img = _images(1, 5, 2)[0]
    blob = timgbin.encode_raw(img)
    assert blob == jimgbin.encode_raw(img)
    assert np.array_equal(timgbin.decode_raw(blob),
                          jimgbin.ImageBinIterator._decode_raw(blob))
    line = "7\t1.5\t2\tsub/dir/a.jpg\n"
    (i, l, f), (j, m, g) = (timgbin.parse_lst_line(line),
                            jimgbin.parse_lst_line(line))
    assert (i, f) == (j, g) and np.array_equal(l, m)


SEEDS = (0, 1, 111, 2 ** 31 - 1, 2 ** 63 + 12345, 2 ** 64 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_record_draws_equal_the_jax_package(seed):
    rs = np.random.RandomState(seed % 2 ** 32)
    idx = rs.randint(0, 2 ** 62, 200, dtype=np.int64)
    for epoch in (0, 1, 7, 2 ** 40 + 3):
        keys = taug.record_key_vec(seed, epoch, idx)
        assert np.array_equal(keys, jaug.record_key_vec(seed, epoch, idx))
        for slot in range(16):
            h = taug._slot_hash_vec(keys, slot)
            assert np.array_equal(h, jaug._slot_hash_vec(keys, slot))
            assert np.array_equal(taug._u53(h), jaug._u53(h))
        for i in idx[:20]:
            k = taug.record_key(seed, epoch, int(i))
            assert k == jaug.record_key(seed, epoch, int(i))
            r, q = taug.RecordRNG(k), jaug.RecordRNG(k)
            for slot in range(16):
                assert r.rand(slot) == q.rand(slot)
                assert r.uniform(slot, -3, 5) == q.uniform(slot, -3, 5)
                assert r.randint(slot, 7, 300) == q.randint(slot, 7, 300)


# ----------------------------------------------------------------------
# the chain against the JAX chain

@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgbin")
    imgs = _images(N_RECORDS, SIDE, 3)
    out = {"dir": d, "imgs": imgs,
           "raw": [write_shard(d, "raw_a", imgs[:20]),
                   write_shard(d, "raw_b", imgs[20:], fmt="ref",
                               first=20)]}
    out["jpeg"] = [write_shard(d, "jpg", imgs, raw=False)]
    return out


RAW = (("raw_pixels", "1"),)
CASES = {
    "crop_mirror": (("rand_crop", "1"), ("rand_mirror", "1")),
    "fixed_crop": (("crop_y_start", "1"), ("crop_x_start", "3"),
                   ("mirror", "1")),
    "center_crop_scale": (("scale", "0.5"),),
    "mean_value_jitter": (("rand_crop", "1"), ("mean_value", "10,20,30"),
                          ("max_random_contrast", "0.3"),
                          ("max_random_illumination", "7"),
                          ("divideby", "255")),
    "affine": (("max_rotate_angle", "30"), ("max_shear_ratio", "0.2"),
               ("max_aspect_ratio", "0.3"), ("min_random_scale", "0.9"),
               ("max_random_scale", "1.2"), ("rand_crop", "1"),
               ("rand_mirror", "1"), ("fill_value", "17")),
    "rotate_list_crop_size": (("rotate_list", "0,90,180"),
                              ("min_crop_size", "7"), ("max_crop_size", "10"),
                              ("rand_mirror", "1")),
    "round_batch": (("rand_crop", "1"), ("rand_mirror", "1"),
                    ("round_batch", "1")),
    "skipread": (("rand_crop", "1"), ("test_skipread", "1")),
    "seeded": (("rand_crop", "1"), ("rand_mirror", "1"), ("seed_data", "5"),
               ("max_random_contrast", "0.1")),
}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_raw_chain_bit_equal_to_jax(shards, case, workers):
    """Raw pages in both layouts; the port's pool at ``workers`` threads
    (chunks of 3 records, a window of 2) against the JAX serial chain."""
    extra = RAW + CASES[case]
    pool = (("num_decode_workers", str(workers)), ("decode_chunk", "3"),
            ("decode_queue_depth", "2"))
    a, b = _pair(_entries(shards["raw"], extra), pool)
    if case == "skipread":
        try:
            xs, ys = [], []
            for it, out in ((a, xs), (b, ys)):
                it.before_first()
                for _ in range(4):
                    assert it.next()
                    out.append((it.value().data.copy(), it.value().label,
                                it.value().inst_index, 0))
            _same(xs, ys)
            assert np.array_equal(ys[0][0], ys[3][0])
        finally:
            a.close()
            b.close()
        return
    _three_epochs_equal(a, b)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("case", ["crop_mirror", "mean_value_jitter",
                                  "affine", "round_batch"])
def test_jpeg_chain_bit_equal_to_jax(shards, case, workers):
    """JPEG pages (PIL here): at 4 workers the port's pool takes the split
    PIL path where no affine key is set."""
    pool = (("num_decode_workers", str(workers)), ("decode_chunk", "4"))
    a, b = _pair(_entries(shards["jpeg"], CASES[case]), pool)
    _three_epochs_equal(a, b)


@pytest.mark.parametrize("raw", [1, 0])
def test_mean_image_created_and_read_both_ways(shards, tmp_path, raw):
    """Each package creates the mean image in its own directory (under
    the name with ``.npz``, as ``np.savez`` writes it); the arrays are
    equal, and each package's chain over the other's file equals its
    own."""
    src = shards["raw"] if raw else shards["jpeg"]
    extra = (("raw_pixels", str(raw)), ("rand_crop", "1"),
             ("rand_mirror", "1"), ("max_random_contrast", "0.2"))
    means = {}
    for pkg in ("port", "jax"):
        means[pkg] = str(tmp_path / pkg / "mean.bin")
        os.makedirs(tmp_path / pkg)
    a, b = (jdata.create_iterator(_entries(
        src, extra + (("image_mean", means["jax"]),))),
        tdata.create_iterator(_entries(
            src, extra + (("image_mean", means["port"]),))))
    a.init()
    b.init()
    _three_epochs_equal(a, b)
    files = {k: v + ".npz" for k, v in means.items()}
    assert not any(os.path.exists(v) for v in means.values())
    arrays = {k: np.load(v)["mean"] for k, v in files.items()}
    assert arrays["port"].shape == (CROP, CROP, 3)  # the crops' mean
    assert np.array_equal(arrays["port"], arrays["jax"])
    # each package reads the other's file
    a, b = (jdata.create_iterator(_entries(
        src, extra + (("image_mean", files["port"]),))),
        tdata.create_iterator(_entries(
            src, extra + (("image_mean", files["jax"]),))))
    a.init()
    b.init()
    _three_epochs_equal(a, b)


def test_mean_file_is_made_again_next_launch(shards, tmp_path, capsys):
    """``image_mean = m.bin`` is saved as ``m.bin.npz``, so the next
    launch does not find it and makes it again, as in the JAX package."""
    name = str(tmp_path / "m.bin")
    entries = [e for e in _entries(shards["raw"], RAW + (
        ("image_mean", name),)) if e != ("silent", "1")]
    for _ in range(2):
        it = tdata.create_iterator(entries)
        it.init()
        it.close()
    out = capsys.readouterr().out
    assert out.count(f"cannot find {name}: creating mean image") == 2
    assert os.listdir(tmp_path) == ["m.bin.npz"]


def test_mid_epoch_rewind_and_conf_prefix(shards, tmp_path):
    """``image_conf_prefix``/``image_conf_ids`` name the shards; the
    port's 4-worker pool rewound after two batches gives the JAX plain
    chain's epochs."""
    d = tmp_path
    imgs = shards["imgs"]
    write_shard(d, "tr_001", imgs[:15])
    write_shard(d, "tr_002", imgs[15:], first=15)
    conf = [("image_conf_prefix", str(d / "tr_%03d")),
            ("image_conf_ids", "1-2")]
    extra = RAW + tuple(conf) + CASES["crop_mirror"]
    a, b = _pair(_entries([], extra), (("num_decode_workers", "4"),
                                       ("decode_chunk", "2")))
    try:
        b.before_first()
        for _ in range(2):
            assert b.next()
        a.before_first()  # JAX: the epoch the port rewound in
        _same(_epoch(a), _epoch(b))
        _same(_epoch(a), _epoch(b))
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_img_iterator_bit_equal_to_jax(shards, tmp_path, workers):
    from PIL import Image

    root = tmp_path / "imgs"
    root.mkdir()
    lst = tmp_path / "img.lst"
    with open(lst, "w") as f:
        for i, img in enumerate(shards["imgs"][:13]):
            Image.fromarray(img.astype(np.uint8)).save(root / f"{i}.png")
            f.write(f"{i}\t{i % 5}\t{i}.png\n")
    entries = _entries([(None, str(lst))], CASES["mean_value_jitter"]
                       + (("image_root", str(root) + "/"),), it="img")
    a, b = _pair(entries, (("num_decode_workers", str(workers)),))
    _three_epochs_equal(a, b)


def test_flat_shape_and_label_width(shards):
    """C = H = 1 collates flat ``(N, D)`` rows."""
    d = shards["dir"]
    vecs = _images(9, 1, 4, channels=1).reshape(9, 1, 1, 1)
    vecs = np.repeat(vecs, 6, axis=2)  # 1x6x1 records
    write_shard(d, "flat", vecs)
    src = [(str(d / "flat.bin"), str(d / "flat.lst"))]
    a, b = _pair(_entries(src, RAW + (("divideby", "255"),), shape="1,1,6",
                          batch=4))
    try:
        ys = _epoch(b)
        _same(_epoch(a), ys)
    finally:
        a.close()
        b.close()
    assert ys[0][0].shape == (4, 6) and ys[-1][3] == 3


# ----------------------------------------------------------------------
# quarantine and fault injection

def _corrupt_shard(d):
    """Two shards: records 3 and 11 of the first with a broken raw
    header, and the second's fourth page with a bad magic."""
    imgs = _images(24, SIDE, 6)
    a = write_shard(d, "bad_a", imgs[:14])
    data = bytearray(pathlib.Path(a[0]).read_bytes())
    pages = list(timgbin.iter_cxbp_pages(a[0]))
    blob = bytes(pages[0][0])
    for rec in (3, 11):
        at = data.find(timgbin.encode_raw(imgs[rec]))
        data[at:at + 2] = b"\xff\xff"
    pathlib.Path(a[0]).write_bytes(bytes(data))
    assert len(blob) == 8 + SIDE * SIDE * 3 * 4
    b = write_shard(d, "bad_b", imgs[14:], first=14, page_size=2000)
    data = bytearray(pathlib.Path(b[0]).read_bytes())
    per_page = 4 + 4 + 4 + len(blob)  # one record a page at this size
    data[3 * per_page: 3 * per_page + 4] = b"XXXX"
    pathlib.Path(b[0]).write_bytes(bytes(data))
    return [a, b]


def _quarantine_runs(d, src, extra, port_extra=()):
    a, b = _pair(_entries(src, extra), port_extra)
    try:
        xs, ys = [], []
        for _ in range(2):
            xs += _epoch(a)
            ys += _epoch(b)
        return a, b, xs, ys
    finally:
        a.close()
        b.close()


def _budget(it):
    return it.base.aug.base._budget


@pytest.mark.parametrize("workers", [1, 4])
def test_quarantine_matches_jax(tmp_path, workers):
    """Two epochs over records 3 and 11 with a broken header and a bad
    page that drops the rest of its shard: the same skips, events and
    sidecars (one quarantine directory each)."""
    src = _corrupt_shard(tmp_path)
    # the pool reads ahead of its workers' decode failures, so a page
    # error is recorded before them: both packages at the same workers
    extra = RAW + CASES["crop_mirror"] + (
        ("max_bad_records", "10"), ("num_decode_workers", str(workers)),
        ("decode_chunk", "3"))
    a = jdata.create_iterator(_entries(src, extra + (
        ("quarantine_dir", str(tmp_path / "qj")),)))
    b = tdata.create_iterator(_entries(src, extra + (
        ("quarantine_dir", str(tmp_path / "qp")),)))
    a.init()
    b.init()
    try:
        for _ in range(2):
            _same(_epoch(a), _epoch(b))
        ja, pa = _budget(a), _budget(b)
        assert pa.total_count == ja.total_count == 6  # 2 records, 1 page
        assert pa.epoch_count == ja.epoch_count == 3
        assert pa.events == ja.events and len(pa.events) == 3
    finally:
        a.close()
        b.close()
    sidecars = {d: {f: (tmp_path / d / f).read_text()
                    for f in sorted(os.listdir(tmp_path / d))}
                for d in ("qj", "qp")}
    assert sidecars["qp"] == sidecars["qj"]
    assert sorted(sidecars["qp"]) == ["bad_a.bin.quarantine",
                                      "bad_b.bin.quarantine"]
    assert sidecars["qp"]["bad_a.bin.quarantine"].count("\n") == 2
    assert "7 trailing record(s)" in sidecars["qp"]["bad_b.bin.quarantine"]


@pytest.mark.parametrize("workers", [1, 4])
def test_strict_budget_raises(tmp_path, workers):
    src = _corrupt_shard(tmp_path)
    for mod, errors, extra in (
            (jdata, jfaults, ()),
            (tdata, tfaults, (("num_decode_workers", str(workers)),))):
        it = mod.create_iterator(_entries(src, RAW) + list(extra))
        it.init()
        try:
            it.before_first()
            with pytest.raises(errors.BadDataError, match="budget exceeded"):
                while it.next():
                    pass
        finally:
            it.close()
    assert not any(f.endswith(".quarantine") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("workers", [1, 4])
def test_injected_record_corruption_matches_jax(tmp_path, workers):
    spec = [("fault_seed", "7"), ("fault_inject", "imgbin.record:corrupt:0.2")]
    out = {}
    for pkg, mod, fl, extra in (
            ("jax", jdata, jfaults, ()),
            ("port", tdata, tfaults,
             (("num_decode_workers", str(workers)),))):
        d = tmp_path / pkg
        d.mkdir()
        src = [write_shard(d, "s", _images(30, SIDE, 8))]
        fl.configure(spec)
        it = mod.create_iterator(_entries(src, RAW + CASES["crop_mirror"] + (
            ("max_bad_records", "30"),)) + list(extra))
        it.init()
        try:
            out[pkg] = (_epoch(it) + _epoch(it),
                        [o for _, o, _ in _budget(it).events],
                        fl.injector().fire_counts())
        finally:
            it.close()
            fl.reset()
    (xs, ja, jc), (ys, pa, pc) = out["jax"], out["port"]
    _same(xs, ys)
    assert pa == ja and len(pa) > 3
    assert pc == jc == {"imgbin.record:corrupt": jc["imgbin.record:corrupt"]}


def test_fault_sites_the_port_does_not_visit_raise():
    # the closed loop's, the data service's and the fleet's sites are
    # armable now
    for spec in ("loop.append:ioerror:1", "loop.commit:enospc:1",
                 "dataservice.rpc:hang:1", "serve.replica:hang:1"):
        assert tfaults.install(spec).site == spec.split(":")[0]
    tfaults.reset()
    tfaults.configure([("fault_inject", "serve.replica:ioerror:1")])
    tfaults.reset()
    with pytest.raises(NotImplementedError, match=r"item \(k\)"):
        tfaults.install("mesh.replica:hang:1")
    with pytest.raises(NotImplementedError, match=r"item \(k\)"):
        tfaults.configure([("fault_inject", "mesh.replica:ioerror:1")])
    with pytest.raises(ValueError, match="unknown site"):
        tfaults.install("imgbin.nope:corrupt:1")
    with pytest.raises(ValueError, match="supports kinds"):
        tfaults.install("imgbin.record:hang:1")
    assert tfaults.injector().specs() == []
    for site in tfaults.PORTED_SITES:
        assert site in jfaults.SITES
        assert tfaults.SITES[site] == jfaults.SITES[site]
    assert tfaults.SITES == jfaults.SITES


def _pool_threads():
    return sum(t.name.startswith("decode-worker-")
               for t in threading.enumerate())


def test_pipeline_worker_fault_relayed_and_threads_joined(shards):
    before = _pool_threads()
    tfaults.configure([("fault_inject", "pipeline.worker:latency:1:2"),
                       ("fault_latency_ms", "1")])
    it = tdata.create_iterator(_entries(shards["raw"], RAW + (
        ("num_decode_workers", "4"),)))
    it.init()
    assert _pool_threads() == before + 4
    _epoch(it)
    assert tfaults.injector().fire_counts() == {"pipeline.worker:latency": 2}
    it.close()
    assert _pool_threads() == before


def test_pool_under_stress_keeps_the_serial_stream(shards):
    """More workers than cores, one record a chunk, a thread switch every
    microsecond: two epochs and a rewind mid-way still give the serial
    chain's batches, and every worker is joined on ``close()``."""
    extra = RAW + CASES["mean_value_jitter"] + (("rand_mirror", "1"),)
    serial = tdata.create_iterator(_entries(shards["raw"], extra))
    serial.init()
    workers = 2 * (os.cpu_count() or 4) + 1
    before = _pool_threads()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = tdata.create_iterator(_entries(shards["raw"], extra) + [
            ("num_decode_workers", str(workers)), ("decode_chunk", "1"),
            ("decode_queue_depth", str(workers))])
        pool.init()
        try:
            ref = [_epoch(serial) for _ in range(2)]
            pool.before_first()
            for _ in range(3):
                assert pool.next()
            _same(_epoch(pool), ref[1])  # the epoch after the rewound one
            _same(_epoch(serial), _epoch(pool))
        finally:
            pool.close()
            serial.close()
    finally:
        sys.setswitchinterval(interval)
    assert _pool_threads() == before


# ----------------------------------------------------------------------
# the epoch anchor

def _round(it, r, port=True):
    """One CLI round: the port anchors before the rewind, the JAX CLI
    sets ``augment_epoch`` after it."""
    if port:
        it.set_param("augment_epoch_next", str(r))
        return _epoch(it)
    it.before_first()
    it.set_param("augment_epoch", str(r))
    out = []
    while it.next():
        v = it.value()
        out.append((v.data.copy(), v.label.copy(),
                    np.asarray(v.inst_index).copy(), v.num_batch_padd))
    return out


@pytest.mark.parametrize("round_batch", [0, 1])
def test_threadbuffer_chain_equals_plain_chain_each_round(shards,
                                                          round_batch):
    extra = RAW + CASES["mean_value_jitter"] + (
        ("rand_mirror", "1"), ("round_batch", str(round_batch)))
    tb = (("iter", "threadbuffer"),)
    plain = tdata.create_iterator(_entries(shards["raw"], extra))
    buffered = tdata.create_iterator(_entries(shards["raw"], extra, tail=tb)
                                     + [("num_decode_workers", "4")])
    ref = jdata.create_iterator(_entries(shards["raw"], extra))
    for it in (plain, buffered, ref):
        it.init()
    try:
        for r in (1, 2, 3):
            ours = _round(plain, r)
            _same(ours, _round(buffered, r))
            _same(ours, _round(ref, r, port=False))
    finally:
        for it in (plain, buffered, ref):
            it.close()


def test_threadbuffer_defers_the_augmenters_anchor():
    """The augmenter's anchor is one of the keys threadbuffer holds for
    the next rewind, and threadbuffer knows no stage it wraps."""
    from cxxnet_tpu_torch.io import prefetch

    assert taug.ANCHOR_KEY in tdata.DEFERRED_KEYS
    assert not hasattr(prefetch, "ANCHOR_KEY")
    tb = prefetch.ThreadBufferIterator(tdata.DataIter())
    tb.set_param(taug.ANCHOR_KEY, "3")
    assert tb._deferred == {taug.ANCHOR_KEY: "3"}


def test_resumed_round_draws_the_uninterrupted_stream(shards):
    extra = RAW + CASES["crop_mirror"]
    tb = (("iter", "threadbuffer"),)
    whole = tdata.create_iterator(_entries(shards["raw"], extra, tail=tb))
    whole.init()
    resumed = tdata.create_iterator(_entries(shards["raw"], extra, tail=tb))
    resumed.init()
    try:
        rounds = [_round(whole, r) for r in (1, 2, 3)]
        _same(_round(resumed, 3), rounds[2])
        _same(_round(resumed, 2), rounds[1])
        assert not np.array_equal(rounds[1][0][0], rounds[2][0][0])
    finally:
        whole.close()
        resumed.close()


# ----------------------------------------------------------------------
# the CLIs on a small inception net

NET = """
netconfig = start
layer[0->stem] = conv:stem
  kernel_size = 3
  pad = 1
  nchannel = 8
  init_sigma = 0.2
layer[stem->stem] = relu
layer[stem->p] = max_pooling
  kernel_size = 3
  stride = 1
  pad = 1
layer[p->n] = lrn
  local_size = 5
  alpha = 0.01
layer[n->b1] = conv:br1
  kernel_size = 1
  nchannel = 4
  init_sigma = 0.2
layer[n->b2] = conv:br2
  kernel_size = 1
  nchannel = 6
  init_sigma = 0.2
layer[n->b3] = conv:br3
  kernel_size = 1
  nchannel = 2
  init_sigma = 0.2
layer[b1,b2,b3->cat] = ch_concat
layer[cat->cat] = relu
layer[cat->q] = max_pooling
  kernel_size = 3
  stride = 2
layer[q->fl] = flatten
layer[fl->out] = fullc:fc
  nhidden = 5
  init_sigma = 0.2
layer[+0] = softmax
netconfig = end
input_shape = 3,8,8
batch_size = 8
updater = sgd
eta = 0.05
momentum = 0.9
wd = 0.0005
metric = error
dev = cpu
seed = 3
"""

SECTIONS = """
data = train
iter = imgbin
  image_list = ./train.lst
  image_bin = ./train.bin
  raw_pixels = 1
  rand_crop = 1
  rand_mirror = 1
  image_mean = ./mean.bin
{train_extra}iter = end

eval = val
iter = imgbin
  image_list = ./val.lst
  image_bin = ./val.bin
  raw_pixels = 1
  image_mean = ./mean.bin
iter = end
"""

_JAX_CLI = """
import contextlib, io, json, os, sys
from cxxnet_tpu.cli import LearnTask
out = []
for cwd, argv in json.loads(sys.argv[1]):
    os.chdir(cwd)
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        LearnTask().run(argv)
    out.append(err.getvalue())
print(json.dumps(out))
"""


def _run_port_cli(cwd, argv):
    old = os.getcwd()
    os.chdir(cwd)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            assert LearnTask().run(argv) == 0
    finally:
        os.chdir(old)
    return err.getvalue()


def _run_jax_cli(jobs):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_CLI, json.dumps(jobs)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


def _weights(path, conf):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_file(conf))
    tr.load_model(path)
    return {(k, t): w.numpy() for k, tags in tr.params.items()
            for t, w in tags.items()}


BOWL_NARROW = (("nchannel = 32", "nchannel = 8"),
               ("nchannel = 64", "nchannel = 8"),
               ("nchannel = 128", "nchannel = 16"),
               ("nhidden = 512", "nhidden = 32"))


def _bowl_pred_conf():
    text = pathlib.Path(REPO, "example", "kaggle_bowl",
                        "bowl.conf").read_text()
    net = text[text.index("netconfig = start"):]
    for a, b in BOWL_NARROW:
        net = net.replace(a, b)
    pred = pathlib.Path(REPO, "example", "kaggle_bowl",
                        "pred.conf").read_text()
    pred = pred[pred.index("pred = "):].replace(
        "./data/test.", "./test.").replace(
        "image_bin = ./test.bin\n", "image_bin = ./test.bin\n"
        "  raw_pixels = 1\n").replace("model_in = ./models/0100.model",
                                           "model_in = ./bowl.model")
    return net + "\n" + pred + "dev = cpu\nsilent = 1\n"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The port writes the initial checkpoints; each package's CLI then
    trains the small net 2 rounds (``model_in = 0000.model``) and runs
    ``pred_raw`` on the narrowed bowl net, each in a directory of its
    own (the JAX CLI in one subprocess)."""
    root = tmp_path_factory.mktemp("imgbin_cli")
    train_imgs = _images(44, 12, 11)  # 5 full batches and one of 4
    val_imgs = _images(16, 12, 12)
    bowl_imgs = _images(70, 40, 13)
    conf_text = SECTIONS.format(train_extra="") + NET
    init = NetTrainer()
    init.set_params(tcfg.parse_pairs(conf_text))
    init.init_model()
    init.save_model(str(root / "0000.model"))
    bowl = _bowl_pred_conf()
    btr = NetTrainer()
    btr.set_params(tcfg.parse_pairs(bowl))
    btr.init_model()
    btr.save_model(str(root / "bowl.model"))
    for pkg in ("port", "jax"):
        d = root / pkg
        d.mkdir()
        write_shard(d, "train", train_imgs)
        write_shard(d, "val", val_imgs, fmt="ref")
        write_shard(d, "test", bowl_imgs)
        (d / "train.conf").write_text(conf_text)
        (d / "pred.conf").write_text(bowl)
        for m in ("0000.model", "bowl.model"):
            os.symlink(root / m, d / m)
    argv = ["train.conf", "model_in=0000.model", "num_round=2",
            "max_round=2", "model_dir=models"]
    pred = ["pred.conf"]
    errs = {"port": _run_port_cli(root / "port", argv)}
    _run_port_cli(root / "port", pred)
    errs["jax"] = _run_jax_cli([[str(root / "jax"), argv],
                                [str(root / "jax"), pred]])[0]
    return root, errs


def test_small_inception_two_rounds_match_jax(cli_runs):
    root, errs = cli_runs
    conf = str(root / "port" / "train.conf")
    for r in (1, 2):
        ours = _weights(str(root / "port" / "models" / f"{r:04d}.model"),
                        conf)
        ref = _weights(str(root / "jax" / "models" / f"{r:04d}.model"), conf)
        assert ours.keys() == ref.keys()
        for key, w in ours.items():
            err = np.abs(w - ref[key]).max() / np.abs(ref[key]).max()
            assert err <= WEIGHT_TOL, (r, key, err)
    lines = {k: [l for l in v.splitlines() if l.startswith("[")]
             for k, v in errs.items()}
    assert len(lines["port"]) == 2 and lines["port"] == lines["jax"]
    assert np.array_equal(np.load(root / "port" / "mean.bin.npz")["mean"],
                          np.load(root / "jax" / "mean.bin.npz")["mean"])


def test_bowl_pred_raw_matches_jax(cli_runs):
    root, _ = cli_runs
    a, b = ((root / p / "test.txt").read_text() for p in ("port", "jax"))
    rows = a.split("\n")[:-1]
    assert len(rows) == 70 and all(r.endswith(" ") for r in rows)
    assert len(rows[0].split()) == 121
    ours = np.array([float(v) for v in a.split()]).reshape(70, 121)
    ref = np.array([float(v) for v in b.split()]).reshape(70, 121)
    np.testing.assert_allclose(ours, ref, atol=TASK_ATOL, rtol=0)
    np.testing.assert_allclose(ours.sum(1), 1.0, atol=1e-4)


def test_cli_resume_with_threadbuffer_is_exact(tmp_path):
    """Through the port's CLI with ``threadbuffer`` and 2 decode workers:
    2 rounds in one run equal 1 round, then ``continue = 1`` for the
    second, bit for bit (``save_ustate = 1``)."""
    write_shard(tmp_path, "train", _images(44, 12, 11))
    write_shard(tmp_path, "val", _images(16, 12, 12))
    (tmp_path / "t.conf").write_text(SECTIONS.format(
        train_extra="  num_decode_workers = 2\niter = threadbuffer\n")
        + NET + "save_ustate = 1\nsilent = 1\n")
    common = ["t.conf", "model_in=NULL"]
    _run_port_cli(tmp_path, common + ["num_round=2", "model_dir=whole"])
    _run_port_cli(tmp_path, common + ["num_round=1", "model_dir=split"])
    _run_port_cli(tmp_path, ["t.conf", "continue=1", "num_round=2",
                             "model_dir=split"])
    conf = str(tmp_path / "t.conf")
    for r in (0, 1, 2):
        ours = _weights(str(tmp_path / "split" / f"{r:04d}.model"), conf)
        ref = _weights(str(tmp_path / "whole" / f"{r:04d}.model"), conf)
        for key, w in ours.items():
            assert np.array_equal(w, ref[key]), (r, key)


def test_cli_arms_the_fault_sites(tmp_path):
    """``fault_inject`` in the conf reaches the data chain through
    ``faults.configure``; the skipped records land in the sidecar."""
    write_shard(tmp_path, "train", _images(44, 12, 11))
    write_shard(tmp_path, "val", _images(16, 12, 12))
    (tmp_path / "t.conf").write_text(SECTIONS.format(train_extra="") + NET
                                     + "max_bad_records = 40\nsilent = 1\n")
    _run_port_cli(tmp_path, ["t.conf", "num_round=1", "model_dir=m",
                             "fault_seed=2",
                             "fault_inject=imgbin.record:corrupt:0.1"])
    side = (tmp_path / "train.bin.quarantine").read_text().splitlines()
    fired = tfaults.injector().fire_counts()["imgbin.record:corrupt"]
    assert side and fired >= len(side)
    with pytest.raises(NotImplementedError, match="the port does not visit"):
        _run_port_cli(tmp_path, ["t.conf", "num_round=1", "model_dir=m2",
                                 "fault_inject=mesh.replica:latency:1"])


# ----------------------------------------------------------------------
# without PIL, and refusals

@pytest.fixture
def no_pil(monkeypatch):
    for name in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


AFFINE = (("max_rotate_angle", "10"), ("max_shear_ratio", "0.1"),
          ("max_aspect_ratio", "0.1"), ("rotate", "90"),
          ("rotate_list", "0,90"), ("min_random_scale", "0.9"),
          ("max_random_scale", "1.1"), ("min_crop_size", "6"))


@pytest.mark.parametrize("key,val", AFFINE)
def test_without_pil_affine_keys_refuse_at_init(shards, no_pil, key, val):
    it = tdata.create_iterator(_entries(shards["raw"], RAW + ((key, val),)))
    with pytest.raises(RuntimeError, match=f"^{key} needs PIL"):
        it.init()
    it.close()


def test_without_pil_encoded_records_and_img_refuse(shards, tmp_path,
                                                    no_pil):
    it = tdata.create_iterator(_entries(shards["jpeg"]))
    with pytest.raises(RuntimeError, match="^raw_pixels = 0 needs PIL"):
        it.init()
    it.close()
    (tmp_path / "a.lst").write_text("0\t1\ta.png\n")
    it = tdata.create_iterator(_entries([(None, str(tmp_path / "a.lst"))],
                                        it="img"))
    with pytest.raises(RuntimeError, match="^iter = img needs PIL"):
        it.init()
    it.close()


def test_without_pil_raw_pages_still_run(shards, no_pil):
    extra = RAW + CASES["mean_value_jitter"] + (("rand_mirror", "1"),)
    it = tdata.create_iterator(_entries(shards["raw"], extra)
                               + [("num_decode_workers", "3")])
    it.init()
    try:
        batches = _epoch(it)
    finally:
        it.close()
    assert len(batches) == 8 and batches[-1][3] == 3
    assert all(np.isfinite(b[0]).all() for b in batches)


@pytest.mark.parametrize("it_name", ["imgbin", "img"])
def test_distributed_sharding_refuses(shards, tmp_path, monkeypatch,
                                      it_name):
    """Once refused; now each worker of ``dist_num_worker = 2`` reads
    the JAX package's rows (imgbin: whole shard files, capped at the
    smaller worker's rows; img: records ``rank::2``), also through the
    decode pool and from the ``PS_RANK`` environment."""
    src, extra = shards["raw"], RAW
    if it_name == "img":
        from PIL import Image

        root = tmp_path / "imgs"
        root.mkdir()
        lst = tmp_path / "img.lst"
        with open(lst, "w") as f:
            for i, img in enumerate(shards["imgs"][:13]):
                Image.fromarray(img.astype(np.uint8)).save(root / f"{i}.png")
                f.write(f"{i}\t{i % 5}\t{i}.png\n")
        src, extra = [(None, str(lst))], (("image_root", str(root) + "/"),)
    counts = []
    for rank in range(2):
        entries = _entries(src, extra + (
            ("dist_num_worker", "2"), ("dist_worker_rank", str(rank))),
            it=it_name)
        for workers in (1, 3):
            a, b = _pair(entries, (("num_decode_workers", str(workers)),))
            assert b.supports_dist_shard()
            _three_epochs_equal(a, b)
        it = tdata.create_iterator(entries)
        it.init()
        try:
            counts.append(len(_epoch(it)))
        finally:
            it.close()
    assert counts[0] == counts[1] > 0
    if it_name == "imgbin":
        monkeypatch.setenv("PS_RANK", "1")
        monkeypatch.setenv("PS_NUM_WORKER", "2")
        _three_epochs_equal(*_pair(_entries(src, RAW)))


def _reader_of(it):
    """The imgbin source at the bottom of a chain."""
    while not hasattr(it, "reader"):
        it = it.aug if hasattr(it, "aug") else it.base
    return it


def test_native_decoder_says_it_reads_in_python(shards, capsys,
                                                monkeypatch):
    """Where the native reader cannot be built, ``native_decoder = 1``
    reads with the Python reader and says why (once, unless silent);
    the iterator names the reader it runs either way."""
    from cxxnet_tpu_torch.io import native as tnative

    why = ("host build of libcxxnet_io failed: fatal error: jpeglib.h: "
           "No such file or directory")
    monkeypatch.setattr(tnative, "_tried", True)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_reason", why)
    for silent in ("0", "1"):
        it = tdata.create_iterator([e for e in _entries(shards["jpeg"])
                                    if e[0] not in ("silent",
                                                    "native_decoder")]
                                   + [("silent", silent)])
        it.init()
        assert (_reader_of(it).reader, _reader_of(it).reader_why) == (
            "python", why)
        it.close()
    out = capsys.readouterr().out
    assert out.count("native reader unavailable") == 1
    assert why in out
    for entries, reason in ((_entries(shards["jpeg"]), "native_decoder = 0"),
                            (_entries(shards["raw"], RAW), "raw_pixels = 1")):
        it = tdata.create_iterator(entries)
        it.init()
        assert (_reader_of(it).reader, _reader_of(it).reader_why) == (
            "python", reason)
        it.close()


def test_raw_header_matches_struct():
    blob = timgbin.encode_raw(np.zeros((3, 4, 2), np.float32))
    assert struct.unpack("<HHHH", blob[:8]) == (3, 4, 2, 0)
    assert len(blob) == 8 + 3 * 4 * 2 * 4
