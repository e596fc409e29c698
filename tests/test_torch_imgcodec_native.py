"""The port's native camera encoder (ops/imgcodec.py over
native/imgenc.cpp, built with g++ into build/host/) against its numpy
spec and the JAX package's numpy encoders, on the same numpy inputs.

Tolerance: bit-exact, on both wires, batched and single frames, the
chroma-clip and luma-clamp edges included. Dims that are not multiples
of the wire's block raise the spec's ValueError before any native call,
non-uint8 input raises TypeError, a failed build raises RuntimeError with
g++'s message, and no path falls back to numpy.
"""
import ctypes
import shutil
import threading

import numpy as np
import pytest

from pc_accumulation_lib_tpu.ops import imgcodec as jcodec
from pc_accumulation_lib_tpu_torch.ops import imgcodec as tcodec
from pc_accumulation_lib_tpu_torch.utils import native

# wire -> (native encoder, the port's spec, the JAX package's spec)
ENCODERS = {
    'yuv420': (tcodec.encode_yuv420, tcodec.encode_yuv420_np,
               jcodec.encode_yuv420_np),
    'yuv420h': (tcodec.encode_yuv420h, tcodec.encode_yuv420h_np,
                jcodec.encode_yuv420h_np)}


def _edge_images(seed):
    """Random frames with the edges of tests/test_imgcodec.py: pure blue
    and pure red blocks (U and V clip past 255) and a full-swing 2x2
    luma edge (the Haar details clamp)."""
    imgs = np.random.default_rng(seed).integers(0, 256, (3, 12, 16, 3),
                                                dtype=np.uint8)
    imgs[0, :4, :4] = (0, 0, 255)
    imgs[0, :4, 4:8] = (255, 0, 0)
    imgs[1, :2, :2] = 255
    imgs[2] = 0
    imgs[2, :, 8:] = 255
    return imgs


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize('kind', tcodec.WIRES)
def test_native_matches_spec_and_jax_bit_exactly(kind):
    enc, spec, jspec = ENCODERS[kind]
    imgs = _edge_images(11)
    big = np.random.default_rng(12).integers(0, 256, (2, 3, 40, 56, 3),
                                             dtype=np.uint8)
    cases = {'batched': imgs, 'single': imgs[1], 'two_lead_axes': big,
             'strided_crop': big[0, :, -36:, -44:],
             'gray': np.repeat(imgs[1, ..., :1], 3, -1),
             'empty_batch': imgs[:0]}
    for name, img in cases.items():
        got = enc(img)
        _equal(got, spec(img))
        _equal(got, jspec(img))
        assert got[0].shape[:-2] == img.shape[:-3], name
    _equal(tcodec.encode_wire(imgs, kind), spec(imgs))


@pytest.mark.parametrize('kind', tcodec.WIRES)
def test_native_four_channels_equal_spec(kind):
    enc, spec, _ = ENCODERS[kind]
    rgba = np.random.default_rng(13).integers(0, 256, (2, 8, 16, 4),
                                              dtype=np.uint8)
    _equal(enc(rgba), spec(rgba))
    _equal(enc(rgba), spec(rgba[..., :3]))


@pytest.mark.parametrize('kind, hw', [('yuv420', (7, 8)), ('yuv420', (8, 9)),
                                      ('yuv420h', (6, 8)),
                                      ('yuv420h', (8, 10))])
def test_native_rejects_dims_as_jax(kind, hw, monkeypatch):
    def no_native():
        raise AssertionError('native call before the dims check')

    monkeypatch.setattr(tcodec, 'load_library', no_native)
    enc, spec, _ = ENCODERS[kind]
    img = np.zeros(hw + (3,), np.uint8)
    for fn in (enc, spec, jcodec.encode_yuv420 if kind == 'yuv420'
               else jcodec.encode_yuv420h):
        with pytest.raises(ValueError, match=kind):
            fn(img)


@pytest.mark.parametrize('dtype', [np.float32, np.int64, np.uint16])
def test_native_refuses_non_uint8(dtype):
    img = np.zeros((8, 16, 3), dtype)
    for kind in tcodec.WIRES:
        with pytest.raises(TypeError, match='uint8'):
            tcodec.encode_wire(img, kind)


def test_encodes_from_four_threads_equal_serial(tmp_path, monkeypatch):
    """Four threads encode at once, the first of them building and
    loading the library (into a fresh directory) under the module lock;
    each result equals the serial one."""
    monkeypatch.setattr(tcodec, '_LIBRARY', tmp_path / 'libimgenc.so')
    monkeypatch.setattr(tcodec, '_lib', None)
    rng = np.random.default_rng(14)
    imgs = [rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
            for _ in range(4)]
    want = [(tcodec.encode_yuv420_np(i), tcodec.encode_yuv420h_np(i))
            for i in imgs]
    got, errors = [None] * 4, []
    start = threading.Barrier(4)

    def work(t):
        try:
            start.wait(timeout=30)
            got[t] = [(tcodec.encode_wire(imgs[t], 'yuv420'),
                       tcodec.encode_wire(imgs[t], 'yuv420h'))
                      for _ in range(5)]
        except Exception as e:   # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for t in range(4):
        for a, b in got[t]:
            _equal(a, want[t][0])
            _equal(b, want[t][1])


def test_library_builds_into_build_host(tmp_path, monkeypatch):
    """The library lands in build/host/ and is loaded with ctypes.CDLL
    (which releases the GIL per call), never PyDLL; a build from a copy
    of native/ writes nothing beside the source."""
    tcodec.encode_yuv420(np.zeros((2, 4, 3), np.uint8))
    assert tcodec._LIBRARY == native.REPO / 'build' / 'host' / 'libimgenc.so'
    lib = tcodec.load_library()
    assert lib._name == str(tcodec._LIBRARY) and tcodec._LIBRARY.exists()
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    src_dir, out_dir = tmp_path / 'native', tmp_path / 'build' / 'host'
    src_dir.mkdir()
    shutil.copy(native.SOURCE_DIR / 'imgenc.cpp', src_dir)
    monkeypatch.setattr(tcodec, '_SOURCE', src_dir / 'imgenc.cpp')
    monkeypatch.setattr(tcodec, '_LIBRARY', out_dir / 'libimgenc.so')
    monkeypatch.setattr(tcodec, '_lib', None)
    img = np.random.default_rng(15).integers(0, 256, (8, 16, 3),
                                             dtype=np.uint8)
    _equal(tcodec.encode_yuv420h(img), tcodec.encode_yuv420h_np(img))
    assert sorted(p.name for p in src_dir.iterdir()) == ['imgenc.cpp']
    assert sorted(p.name for p in out_dir.iterdir()) == ['libimgenc.so']


def test_broken_source_raises_with_gxx_message(tmp_path, monkeypatch):
    src = tmp_path / 'imgenc.cpp'
    src.write_text('this is not C++\n')
    monkeypatch.setattr(tcodec, '_SOURCE', src)
    monkeypatch.setattr(tcodec, '_LIBRARY', tmp_path / 'libimgenc.so')
    monkeypatch.setattr(tcodec, '_lib', None)
    img = np.zeros((8, 16, 3), np.uint8)
    for kind in tcodec.WIRES:
        with pytest.raises(RuntimeError, match=r'g\+\+ failed(.|\n)*error'):
            tcodec.encode_wire(img, kind)
    assert sorted(p.name for p in tmp_path.iterdir()) == ['imgenc.cpp']
