"""The port's native NIfTI decoder (``glfusion_tpu_torch/native``) and the
frame loader's cache warm-up, against the JAX package on the CPU.

Decoder: volumes of the eight NIfTI types, unscaled and scaled by
``scl_slope``/``scl_inter`` (0.1 and 0.3, 1.7 and −3.3, 0.0137 and 101.9,
2.5 and 0.25; slope 0, which means no scaling), as ``.nii`` and
``.nii.gz``; a big-endian file, mixed batches, a truncated file, and every
file of the synthetic corpus. The port's decoder, single and batched, and
its ``read_nifti`` return the same bytes and types as both packages' pure
readers. JAX's native reader matches them bit for bit on unscaled volumes.
On scaled ones it may differ, and the count of voxels that do is recorded
(JUnit property ``jax_native_ulp_diffs``): JAX builds with
``-march=native``, where GCC fuses ``f * slope + inter`` into one FMA on a
CPU that has one, while the port builds with ``-ffp-contract=off`` and
rounds twice, as numpy does (ROADMAP Queue 3, standing deviations). The
fused result skips the product's rounding, so it is held within one
float32 ulp of the product plus two of the result (where the sum cancels,
as 1.7·2 − 3.3 does, that is many ulps of the result).

Warm-up: ``epoch_keys`` as JAX's; the cache after ``warm_async`` equal to
serial loads of every key; ``stop_warming`` and the 90 % guard end the
thread; ``batches`` bit for bit JAX's, with warming on and off.
"""

from __future__ import annotations

import gzip
import struct
import threading
from pathlib import Path

import numpy as np
import pytest

from _torch_port_common import one_torch_thread  # noqa: F401
from glfusion_tpu import config as jconfig
from glfusion_tpu import native as jnative
from glfusion_tpu.data import nifti as jnifti
from glfusion_tpu.data import pipeline as jpipe
from glfusion_tpu.data.infos import PatientIndex as JPatientIndex
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch import native
from glfusion_tpu_torch.data import nifti, pipeline
from glfusion_tpu_torch.data.infos import PatientIndex, load_infos, load_split
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from glfusion_tpu_torch.native import loader

DTYPES = (np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
          np.float32, np.float64)
SCALINGS = ((1.0, 0.0), (0.0, 5.0), (0.1, 0.3), (1.7, -3.3),
            (0.0137, 101.9), (2.5, 0.25))
SHAPE = (64, 64, 16)
# what the float32 core holds exactly: the decoder's own scaled types
F32_EXACT = (np.uint8, np.int8, np.int16, np.uint16, np.float32)


def _volume(dtype, rs):
    if np.dtype(dtype).kind == "f":
        return (rs.standard_normal(SHAPE) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rs.randint(max(info.min, -2**31), min(info.max, 2**31 - 1),
                      SHAPE, dtype=np.int64).astype(dtype)


def _write(path, arr, slope=1.0, inter=0.0, bo="<"):
    """A NIfTI-1 file of ``arr`` with the given scaling, in byte order
    ``bo``, gzipped when ``path`` ends in .gz."""
    hdr = bytearray(352)
    struct.pack_into(f"{bo}i", hdr, 0, 348)
    struct.pack_into(f"{bo}8h", hdr, 40, arr.ndim, *arr.shape,
                     *[1] * (7 - arr.ndim))
    struct.pack_into(f"{bo}h", hdr, 70, nifti._CODES[arr.dtype])
    struct.pack_into(f"{bo}h", hdr, 72, arr.dtype.itemsize * 8)
    struct.pack_into(f"{bo}8f", hdr, 76, *[1.0] * 8)
    struct.pack_into(f"{bo}3f", hdr, 108, 352.0, slope, inter)
    hdr[344:348] = b"n+1\x00"
    data = bytes(hdr) + arr.astype(arr.dtype.newbyteorder(bo)).tobytes(
        order="F")
    path = str(path)
    with open(path, "wb") as f:
        f.write(gzip.compress(data, 1) if path.endswith(".gz") else data)
    return path


def _same(got, want, what=""):
    """Same type, shape and bytes."""
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                          np.ascontiguousarray(want).view(np.uint8)), what


def _within_fma(j, want, arr, slope) -> int:
    """JAX's native scaled decode against the two-rounding one: within
    one float32 ulp of the product plus two of the result (an FMA skips
    the product's rounding). Returns the voxels that differ."""
    assert j.dtype == want.dtype == np.float32
    prod = arr.astype(np.float32) * np.float32(slope)
    bound = np.spacing(np.abs(prod)) + 2 * np.spacing(np.abs(want))
    err = np.abs(j.astype(np.float64) - want)
    assert (err <= bound).all(), (slope, (err / bound).max())
    return int((j != want).sum())


def _scaled(slope, inter):
    return nifti.needs_scaling(np.float32(slope), np.float32(inter))


@pytest.fixture(scope="module")
def built():
    """The decoder, built from the port's own source into its _build/."""
    assert native.native_available(), native.build_error()
    path = native.library_path()
    assert path.exists() and path.parent == loader.BUILD_DIR
    assert path.parent.parent.name == "glfusion_tpu_torch"
    assert "-ffp-contract=off" in loader.CXX_FLAGS
    assert not any(f.startswith("-march") for f in loader.CXX_FLAGS)
    return path


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_decoder_matches_the_pure_readers(built, tmp_path, dtype, ext,
                                          record_property):
    """Each scaling of one type: the port's single and batched native
    reads and its ``read_nifti`` equal both pure readers in bytes and
    type; where JAX's decoder leaves a file to the pure reader, so does
    the port's. JAX's native reader: equal when unscaled, within the
    rounding an FMA skips when scaled."""
    rs = np.random.RandomState(np.dtype(dtype).num)
    arr = _volume(dtype, rs)
    files, diffs = [], 0
    for i, (slope, inter) in enumerate(SCALINGS):
        f = _write(tmp_path / f"v{i}{ext}", arr, slope, inter)
        want = nifti.read_nifti_py(f)
        _same(jnifti.read_nifti_py(f), want, f"JAX pure {slope}")
        _same(nifti.read_nifti(f), want, f"read_nifti {slope}")
        scaled = _scaled(slope, inter)
        assert want.dtype == (np.float32 if scaled else dtype)
        routed = scaled and dtype not in F32_EXACT
        if routed:  # scaled 32-bit integers and float64: the pure reader
            with pytest.raises(IOError, match="python reader"):
                native.read_nifti_native(f)
        else:
            _same(native.read_nifti_native(f), want, f"native {slope}")
            files.append((f, want, scaled))
        if jnative.native_available():
            if routed:
                with pytest.raises(IOError):
                    jnative.read_nifti_native(f)
                continue
            j = jnative.read_nifti_native(f)
            if scaled:
                diffs += _within_fma(j, want, arr, slope)
            else:
                _same(j, want, f"JAX native {slope}")
    record_property("jax_native_ulp_diffs", diffs)
    got = native.read_nifti_batch_native([f for f, *_ in files])
    for (f, want, _), g in zip(files, got):
        _same(g, want, f"batch {f}")
    unscaled = [(f, w) for f, w, scaled in files if not scaled]
    if jnative.native_available():
        for (f, want), g in zip(unscaled, jnative.read_nifti_batch_native(
                [f for f, _ in unscaled])):
            _same(g, want, f"JAX batch {f}")


@pytest.mark.parametrize("case", ["big_endian", "mixed_batch", "truncated"])
def test_decoder_falls_back_as_jax(built, tmp_path, case):
    """An unscaled big-endian file goes to the pure reader, which swaps
    it, and a scaled one to the float32 core, which does; a batch
    of scaled int16 and unscaled uint8 runs on the float32 core and keeps
    each file's type, one with an unscaled int32 (which that core would
    round) or a big-endian file raises, as JAX's does; a truncated file
    raises from every reader."""
    rs = np.random.RandomState(7)
    i16, u8 = _volume(np.int16, rs), _volume(np.uint8, rs)
    if case == "big_endian":
        for ext in (".nii", ".nii.gz"):
            for slope, inter in ((1.0, 0.0), (0.1, 0.3)):
                f = _write(tmp_path / f"be{slope}{ext}", i16, slope, inter,
                           bo=">")
                want = nifti.read_nifti_py(f)
                assert want.dtype.isnative or want.dtype.byteorder == ">"
                np.testing.assert_array_equal(
                    want, (i16 if slope == 1.0 else i16.astype(np.float32)
                           * np.float32(slope) + np.float32(inter)))
                _same(nifti.read_nifti(f), want)
                if slope == 1.0:  # the raw copy refuses it (rc 5)
                    _same(jnifti.read_nifti(f), want)
                    for read in (native.read_nifti_native,
                                 lambda f: native.read_nifti_batch_native(
                                     [f])):
                        with pytest.raises(IOError):
                            read(f)
                else:  # the float32 core swaps the bytes itself
                    _within_fma(jnifti.read_nifti(f), want, i16, slope)
                    _same(native.read_nifti_native(f), want)
                    _same(native.read_nifti_batch_native([f])[0], want)
    elif case == "mixed_batch":
        a = _write(tmp_path / "a.nii.gz", i16, 0.1, 0.3)
        b = _write(tmp_path / "b.nii", u8)
        c = _write(tmp_path / "c.nii", _volume(np.int32, rs))
        be = _write(tmp_path / "d.nii", u8, bo=">")
        got = native.read_nifti_batch_native([a, b, a])
        for g, f in zip(got, (a, b, a)):
            _same(g, nifti.read_nifti_py(f), f)
        assert [g.dtype for g in got] == [np.float32, np.uint8, np.float32]
        for bad in ([a, c], [b, be]):
            with pytest.raises(IOError):
                native.read_nifti_batch_native(bad)
            if jnative.native_available():
                with pytest.raises(IOError):
                    jnative.read_nifti_batch_native(bad)
    else:
        f = _write(tmp_path / "t.nii", i16)
        data = open(f, "rb").read()
        with open(f, "wb") as fh:
            fh.write(data[:len(data) // 2])
        with pytest.raises(IOError):
            native.read_nifti_native(f)
        with pytest.raises(IOError):
            native.read_nifti_batch_native([f])
        for read in (nifti.read_nifti, nifti.read_nifti_py,
                     jnifti.read_nifti):
            with pytest.raises(ValueError):
                read(f)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    cfg = pconfig.tiny_config()
    paths = generate_synthetic_dataset(tmp_path_factory.mktemp("corpus"),
                                       cfg.data, seed=11)
    return cfg, paths


def test_decoder_reads_the_synthetic_corpus(built, corpus):
    """Every file of the synthetic corpus: the batched native read equals
    both pure readers and JAX's native reader, bit for bit."""
    _, paths = corpus
    files = sorted(str(p) for p in Path(paths["root"]).rglob("*.nii*"))
    assert len(files) > 50
    got = native.read_nifti_batch_native(files)
    for f, g in zip(files, got):
        want = nifti.read_nifti_py(f)
        _same(g, want, f)
        _same(jnifti.read_nifti_py(f), want, f)
        if jnative.native_available():
            _same(jnative.read_nifti_native(f), want, f)


def test_decoder_switch_and_build(tmp_path, monkeypatch):
    """``GLFUSION_NO_NATIVE`` switches the decoder off (``read_nifti``
    then reads with the pure reader and says why); a build names its
    library by the source's and flags' hash and replaces it whole."""
    for name, value in (("_TRIED", False), ("_LIB", None), ("_ERROR", None)):
        monkeypatch.setattr(loader, name, value)
    monkeypatch.setenv("GLFUSION_NO_NATIVE", "1")
    assert not native.native_available()
    assert "GLFUSION_NO_NATIVE" in native.build_error()
    f = _write(tmp_path / "x.nii.gz", np.arange(24, dtype=np.uint8).reshape(
        2, 3, 4), 0.1, 0.3)
    _same(nifti.read_nifti(f), nifti.read_nifti_py(f))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read_nifti_native(f)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    path = native.build()
    assert path.parent == tmp_path / "_build"
    assert path.name.startswith("libglnative-") and path.name.endswith(".so")
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert native.compiler_version().startswith("g++")


# ------------------------------------------------------------- warm-up

@pytest.fixture(scope="module")
def loaders(corpus):
    """(port loader factory, JAX loader factory) on the corpus's index."""
    cfg, paths = corpus
    jcfg = jconfig.tiny_config()
    ids = load_split(f"{paths['data_list_dir']}/train_list.npy")
    infos = load_infos(paths["infos"])
    idx = PatientIndex.from_infos(infos, cfg.data.use_data)
    jidx = JPatientIndex.from_infos(infos, jcfg.data.use_data)

    def port(is_train, **kw):
        return pipeline.SegFrameLoader(idx, ids, cfg.model.views, cfg,
                                       is_train, seed=5, **kw)

    def jax(is_train):
        return jpipe.SegFrameLoader(jidx, ids, jcfg.model.views, jcfg,
                                    is_train, seed=5)
    return port, jax


def _entries_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            _same(x, y)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_epoch_keys_and_batches_match_jax(built, loaders, is_train):
    """``epoch_keys`` as JAX's for epochs 0 and 1; ``batches`` bit for bit
    JAX's with warming off, and with ``warm_async`` running beside them."""
    port, jax = loaders
    for epoch in (0, 1):
        assert port(is_train).epoch_keys(epoch) == \
            jax(is_train).epoch_keys(epoch)
        want = list(jax(is_train).batches(2, epoch))
        assert want
        cold = port(is_train)
        warm = port(is_train)
        thread = warm.warm_async(epoch, chunk=2)
        for ld in (cold, warm):
            got = list(ld.batches(2, epoch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for k in w:
                    _same(g[k], w[k], k)
        thread.join(timeout=60)
        assert not thread.is_alive()


def test_warm_async_fills_the_cache_as_serial_loads(built, loaders):
    """After the warm thread ends, the cache holds every key of the epoch,
    each entry equal to a serial ``_load`` of it by a fresh loader."""
    port, _ = loaders
    warm, serial = port(True), port(True)
    keys = warm.epoch_keys(0)
    t = warm.warm_async(0)
    t.join(timeout=60)
    assert warm._cache.keys() == set(keys)
    for key in keys:
        _entries_equal(warm._cache.get(key), serial._load(*key))


@pytest.mark.parametrize("stop", ["stop_warming", "cache_90_percent"])
def test_warming_stops(loaders, monkeypatch, stop):
    """``stop_warming`` ends the thread after the chunk in flight; a cache
    at 90 % of its bytes ends it before any read, and one just below is
    warmed chunk by chunk through the epoch's keys."""
    port, _ = loaders
    ld = port(True, cache_bytes=1000)
    calls, gate = [], threading.Event()

    def prefill(keys):
        calls.append(list(keys))
        gate.wait(timeout=30)

    monkeypatch.setattr(ld, "_prefill", prefill)
    keys = ld.epoch_keys(0)
    assert len(keys) > 2
    if stop == "stop_warming":
        t = ld.warm_async(0, chunk=1)
        while not calls:
            t.join(timeout=0.01)
        ld.stop_warming()
        gate.set()
        t.join(timeout=30)
        assert not t.is_alive() and calls == [keys[:1]]
        return
    gate.set()
    ld._cache.put("filler", np.zeros(899, np.uint8))
    ld.warm_async(0, chunk=1).join(timeout=30)
    assert calls == [[k] for k in keys]
    calls.clear()
    ld._cache.put("filler", np.zeros(900, np.uint8))
    t = ld.warm_async(0, chunk=1)
    t.join(timeout=30)
    assert not t.is_alive() and calls == []
