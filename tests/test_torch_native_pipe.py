"""The port's native framepipe (``waifu2x_tensorrt_tpu_torch.native`` and
``io/native_pipe.py``) on the CPU.

Its ``framepipe.cpp`` is a byte-equal copy of the JAX package's
``native/framepipe.cpp``; g++ builds it into the port's own
``build/framepipe/`` (never the JAX package's ``native/build/``); the
reader and writer rings round-trip raw frames through plain shell
commands (``cat``) as they do through ffmpeg.
"""

from pathlib import Path

import numpy as np
import pytest

from waifu2x_tensorrt_tpu_torch.io.native_pipe import (
    NativeFrameReader,
    NativeFrameWriter,
    native_available,
)
from waifu2x_tensorrt_tpu_torch.utils import native_build

ROOT = Path(__file__).resolve().parents[1]
H, W = 12, 17


@pytest.fixture()
def native():
    if not native_available():
        pytest.skip("no C++ toolchain for the native framepipe")


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, H, W, 3),
                                                np.uint8)


def test_source_is_a_byte_equal_copy():
    assert native_build.SRC == (ROOT / "waifu2x_tensorrt_tpu_torch"
                                / "native" / "framepipe.cpp")
    assert native_build.SRC.read_bytes() == \
        (ROOT / "native" / "framepipe.cpp").read_bytes()


def test_library_builds_into_the_ports_own_directory(native):
    path = native_build.build_framepipe()
    assert path == native_build.lib_path()
    assert path.parent == ROOT / "build" / "framepipe"
    assert path.exists()
    assert not list(path.parent.glob("*.tmp*"))  # atomic rename
    lib = native_build.load_framepipe()
    assert Path(lib._name) == path


def test_reader_streams_frames(native, tmp_path):
    frames = _frames(7)
    raw = tmp_path / "in.raw"
    raw.write_bytes(frames.tobytes())
    with NativeFrameReader(f"cat {raw}", H, W) as r:
        got = []
        while (f := r.read()) is not None:
            got.append(f)
    np.testing.assert_array_equal(np.stack(got), frames)


def test_reader_zero_copy_mode(native, tmp_path):
    frames = _frames(3, seed=1)
    raw = tmp_path / "in.raw"
    raw.write_bytes(frames.tobytes())
    with NativeFrameReader(f"cat {raw}", H, W, depth=2) as r:
        for i in range(3):
            view = r.read(copy=False)
            np.testing.assert_array_equal(view, frames[i])
            r.release(view)
        assert r.read() is None


def test_reader_truncated_frame_raises(native, tmp_path):
    raw = tmp_path / "in.raw"
    raw.write_bytes(_frames(2, seed=4).tobytes()[:-5])
    with NativeFrameReader(f"cat {raw}", H, W) as r:
        assert r.read() is not None
        with pytest.raises(RuntimeError, match="truncated"):
            r.read()


def test_writer_roundtrip_and_validation(native, tmp_path):
    frames = _frames(5, seed=2)
    out = tmp_path / "out.raw"
    with NativeFrameWriter(f"cat > {out}", H, W) as w:
        with pytest.raises(ValueError):
            w.write(np.zeros((H, W + 1, 3), np.uint8))
        with pytest.raises(ValueError):
            w.write(np.zeros((H, W, 3), np.float32))
        for f in frames:
            w.write(f)
        assert w.close() == 0
    got = np.frombuffer(out.read_bytes(), np.uint8).reshape(5, H, W, 3)
    np.testing.assert_array_equal(got, frames)


def test_full_pipe_roundtrip(native, tmp_path):
    """reader(cat) -> transform -> writer(cat) end to end."""
    frames = _frames(4, seed=3)
    src, dst = tmp_path / "src.raw", tmp_path / "dst.raw"
    src.write_bytes(frames.tobytes())
    with NativeFrameReader(f"cat {src}", H, W, depth=2) as r, \
            NativeFrameWriter(f"cat > {dst}", H, W, depth=2) as w:
        while (f := r.read()) is not None:
            w.write(255 - f)
    got = np.frombuffer(dst.read_bytes(), np.uint8).reshape(4, H, W, 3)
    np.testing.assert_array_equal(got, 255 - frames)
