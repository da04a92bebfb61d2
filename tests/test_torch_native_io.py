"""The port's native page reader (``io/native.py``,
``csrc/host/cxxnet_io.cc``) against the JAX package's.

* the port's reader and the JAX reader (its own source and Makefile,
  built in the test's directory so nothing is written under
  ``native/``) give byte-equal records here, the same libjpeg, and
  records within ±1 of PIL's decode;
* a non-JPEG blob comes back raw (kind 0) and the chain decodes it with
  PIL;
* the port's imgbin chain with ``native_decoder = 1`` gives batches
  bit-equal to the JAX chain's, serial and through the decode pool, over
  two epochs, and names the reader it runs;
* a missing shard raises instead of ending the epoch early; ``reset``
  replays; ``max_bad_records`` takes the Python reader;
* where the reader does not build, the build error's last line is the
  reason the iterator gives for reading in Python.

Tolerances: none inside the libjpeg path (byte-equal); ±1 against PIL.
"""

import io
import os
import shutil

import numpy as np
import pytest

from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.io import native as jnative
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.io import imgbin as timgbin
from cxxnet_tpu_torch.io import native as tnative
from cxxnet_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not shutil.which("g++") or not os.path.exists("/usr/include/jpeglib.h"),
    reason="no g++ or no jpeglib.h: the native reader does not build here")


@pytest.fixture(scope="module")
def jax_reader(tmp_path_factory):
    """The JAX package's native module, bound to a library built from
    its own source and Makefile in a scratch directory."""
    d = tmp_path_factory.mktemp("native")
    for f in ("cxxnet_io.cc", "Makefile"):
        shutil.copy(os.path.join(REPO, "native", f), d / f)
    saved = {k: getattr(jnative, k)
             for k in ("_NATIVE_DIR", "_LIB_PATH", "_lib", "_tried")}
    jnative._NATIVE_DIR = str(d)
    jnative._LIB_PATH = str(d / "libcxxnet_io.so")
    jnative._lib, jnative._tried = None, False
    try:
        assert jnative.available()
        yield jnative
    finally:
        for k, v in saved.items():
            setattr(jnative, k, v)


def _image(seed, h=32, w=32, mode="RGB"):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 255, (h, w, 3)).astype(np.uint8)
    from PIL import Image

    im = Image.fromarray(base)
    return im.convert(mode) if mode != "RGB" else im


def _blob(im, fmt="JPEG"):
    buf = io.BytesIO()
    im.save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _pack(d, blobs, name="part0"):
    bin_path, lst_path = str(d / f"{name}.bin"), str(d / f"{name}.lst")
    w = timgbin.BinPageWriter(bin_path, page_size=8192)  # several pages
    for b in blobs:
        w.push(b)
    w.close()
    with open(lst_path, "w") as f:
        for i in range(len(blobs)):
            f.write(f"{i}\t{i % 7}\timg{i}.jpg\n")
    return bin_path, lst_path


def _drain(reader):
    out = []
    while (rec := reader.next()) is not None:
        out.append(rec)
    return out


def test_records_byte_equal_to_the_jax_reader_and_pil(tmp_path, jax_reader):
    blobs = [_blob(_image(i, 24 + i, 32)) for i in range(10)]
    blobs.append(_blob(_image(10), "JPEG"))
    blobs.append(_blob(_image(11, mode="L")))  # grayscale JPEG
    bin_path, _ = _pack(tmp_path, blobs)
    got = {}
    for name, mod in (("jax", jax_reader), ("port", tnative)):
        r = mod.NativePageReader([bin_path], n_decode=3)
        got[name] = _drain(r)
        r.reset()  # replays from the start
        again = _drain(r)
        r.close()
        r.close()
        assert [k for k, _ in again] == [k for k, _ in got[name]]
    assert len(got["port"]) == len(blobs)
    for (kj, pj), (kt, pt), blob in zip(got["jax"], got["port"], blobs):
        assert kj == kt == 1
        assert pt.dtype == np.uint8 and pt.shape == pj.shape
        np.testing.assert_array_equal(pt, pj)
        ref = timgbin.decode_image_u8(blob)
        assert ref.shape == pt.shape or (ref.ndim == 3 and pt.shape[2] == 1)
        if ref.shape == pt.shape:
            assert np.abs(pt.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_non_jpeg_blobs_come_back_raw(tmp_path):
    png = _blob(_image(3), "PNG")
    blobs = [b"not-an-image-%d" % i for i in range(3)] + [png]
    bin_path, _ = _pack(tmp_path, blobs)
    r = tnative.NativePageReader([bin_path], n_decode=2)
    recs = _drain(r)
    r.close()
    assert [k for k, _ in recs] == [0, 0, 0, 0]
    assert [p for _, p in recs] == blobs
    # the chain decodes the PNG with PIL
    d = tmp_path / "png"
    d.mkdir()
    b, l = _pack(d, [png] * 2)
    it = timgbin.ImageBinIterator()
    for k, v in (("image_bin", b), ("image_list", l), ("silent", "1")):
        it.set_param(k, v)
    it.init()
    assert it.reader == "native"
    assert it.next()
    np.testing.assert_array_equal(it.value().data,
                                  timgbin.decode_image_u8(png).astype(
                                      np.float32))
    it.close()


def _entries(b, l, extra=()):
    return [("iter", "imgbin"), ("image_bin", b), ("image_list", l),
            ("native_decoder", "1"), ("silent", "1"), ("rand_crop", "1"),
            ("rand_mirror", "1"), *extra, ("iter", "end"),
            ("input_shape", "3,24,24"), ("batch_size", "5")]


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        it.before_first()
        while it.next():
            v = it.value()
            out.append((np.array(v.data), np.array(v.label),
                        v.num_batch_padd))
    return out


def _source(it):
    while not hasattr(it, "_native"):
        it = it.aug if hasattr(it, "aug") else it.base
    return it


@pytest.mark.parametrize("workers", ["1", "2"])
def test_native_chain_bit_equal_to_the_jax_chain(tmp_path, jax_reader,
                                                 workers):
    blobs = [_blob(_image(i)) for i in range(13)]
    b, l = _pack(tmp_path, blobs)
    entries = _entries(b, l, (("num_decode_workers", workers),))
    ji, ti = jdata.create_iterator(entries), tdata.create_iterator(entries)
    ji.init()
    ti.init()
    assert _source(ji)._native is not None
    src = _source(ti)
    assert (src.reader, src.reader_why) == ("native", "")
    got = [_epochs(ji), _epochs(ti)]
    ji.close()
    ti.close()
    assert len(got[1]) == 6  # 13 rows, batches of 5, two epochs
    for (dj, lj, pj), (dt, lt, pt) in zip(*got):
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(lt, lj)
        assert pt == pj


def test_missing_shard_raises_and_budget_takes_python(tmp_path):
    b, l = _pack(tmp_path, [_blob(_image(i)) for i in range(3)])
    r = tnative.NativePageReader([b, str(tmp_path / "gone.bin")],
                                 n_decode=2)
    with pytest.raises(RuntimeError):
        _drain(r)
    r.close()
    it = timgbin.ImageBinIterator()
    for k, v in (("image_bin", b), ("image_list", l), ("silent", "1"),
                 ("max_bad_records", "2")):
        it.set_param(k, v)
    it.init()
    assert (it.reader, it.reader_why) == ("python", "max_bad_records > 0")
    assert it.raw_available()
    it.close()


def test_a_failed_build_is_the_reason_given(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    text = open(os.path.join(_build.HOST_SRC, "cxxnet_io.cc")).read()
    (src / "cxxnet_io.cc").write_text(
        text.replace("#include <jpeglib.h>", "#include <no_such_jpeglib.h>"))
    monkeypatch.setattr(_build, "HOST_SRC", str(src))
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(_build.HostBuildError) as e:
        _build.build_host("libcxxnet_io")
    assert "no_such_jpeglib.h" in str(e.value)
    assert not os.listdir(tmp_path / "out")[1:]  # only the lock file
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_reason", "")
    assert not tnative.available()
    why = tnative.unavailable_reason()
    assert why == str(e.value) and why.startswith(
        "host build of libcxxnet_io failed: ")
    d = tmp_path / "pages"
    d.mkdir()
    b, l = _pack(d, [_blob(_image(0))])
    it = timgbin.ImageBinIterator()
    for k, v in (("image_bin", b), ("image_list", l), ("silent", "1")):
        it.set_param(k, v)
    it.init()
    assert (it.reader, it.reader_why) == ("python", why)
    assert it.next()
