"""The port's video I/O (``waifu2x_tensorrt_tpu_torch.io.video``) against
the JAX package's copy, on the CPU.

There is no ffmpeg here: the ffmpeg / ffprobe stand-ins of
``chip_smoke.py`` serve a raw rgb24 clip over the same pipes (probe
fields, frame-exact trim, the encoder's stdin, the concat demuxer). The
port's ``VideoCapture`` / ``VideoWriter`` round-trip it through the native
framepipe ring and through the Python reader thread, and through OpenCV's
codecs when no ffmpeg is on PATH (decoded frames equal the JAX copy's
decode of the same file). Probe parsing, the decode and encode commands,
``segment_grid`` and ``segment_path`` equal the JAX functions on the same
cases.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

from waifu2x_tensorrt_tpu.io import video as jvideo
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.io import video
from waifu2x_tensorrt_tpu_torch.io.image import write_image
from waifu2x_tensorrt_tpu_torch.io.native_pipe import native_available
from waifu2x_tensorrt_tpu_torch.io.video import VideoCapture, VideoWriter

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the ffmpeg / ffprobe stand-ins)

H, W, N = 10, 12, 6


@pytest.fixture()
def clip(tmp_path, monkeypatch):
    """A raw clip of N frames behind the stand-ins, first on PATH."""
    frames = np.random.default_rng(0).integers(0, 256, (N, H, W, 3),
                                               np.uint8)
    path = chip_smoke.write_raw_clip(tmp_path / "clip.mp4", frames)
    bin_dir = chip_smoke.write_ffmpeg_shims(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    return path, frames


def _pipe_impl(monkeypatch, native: bool) -> None:
    if native:
        if not native_available():
            pytest.skip("no C++ toolchain for the native framepipe")
        monkeypatch.delenv("W2X_NO_NATIVE_PIPE", raising=False)
    else:
        monkeypatch.setenv("W2X_NO_NATIVE_PIPE", "1")


@pytest.mark.parametrize("native", [False, True])
def test_capture_roundtrip(clip, monkeypatch, native):
    _pipe_impl(monkeypatch, native)
    path, frames = clip
    cap = VideoCapture()
    cap.open(path)
    assert (cap._native is not None) == native  # wiring check
    assert (cap.frame_width, cap.frame_height) == (W, H)
    assert cap.frame_rate == pytest.approx(30000 / 1001)
    assert cap.frame_count == N
    got = list(cli._frames(cap))
    assert cap.read() is None
    cap.release()
    np.testing.assert_array_equal(np.stack(got), frames)


@pytest.mark.parametrize("native", [False, True])
def test_capture_frame_range_exact(clip, monkeypatch, native):
    _pipe_impl(monkeypatch, native)
    path, frames = clip
    cap = VideoCapture()
    cap.open(path, frame_range=(2, 5))
    assert cap.frame_count == 3
    got = [cap.read() for _ in range(3)]
    assert cap.read() is None
    cap.release()
    np.testing.assert_array_equal(np.stack(got), frames[2:5])
    with pytest.raises(ValueError, match="frame_range"):
        VideoCapture().open(path, frame_range=(4, N + 1))


@pytest.mark.parametrize("native", [False, True])
def test_writer_roundtrip(clip, tmp_path, monkeypatch, native):
    _pipe_impl(monkeypatch, native)
    _, frames = clip
    out = tmp_path / "out.mp4"
    w = (VideoWriter().set_frame_size(W, H).set_frame_rate(29.97)
         .set_codec("libx264").set_pixel_format("yuv420p")
         .set_constant_rate_factor(23).set_output_file(out))
    w.open()
    assert (w._native is not None) == native  # wiring check
    for f in frames:
        w.write(f[:, ::-1][:, ::-1])  # a strided view of the frame
    w.release()
    np.testing.assert_array_equal(chip_smoke.read_raw_clip(out, H, W),
                                  frames)


def test_concat_segments_stitches_byte_for_byte(clip, tmp_path):
    _, frames = clip
    out = tmp_path / "whole.mp4"
    parts = []
    for a, b in video.segment_grid(N, 4):
        part = video.segment_path(out, a, b)
        part.write_bytes(frames[a:b].tobytes())
        parts.append(part)
    video.concat_segments(parts, out, 29.97)
    assert out.read_bytes() == frames.tobytes()


def test_capture_without_nb_frames_reads_to_eof(clip, monkeypatch):
    """A probe without nb_frames leaves the count unknown (-1) and the
    CLI's frame iterator reads to EOF in one pass."""
    monkeypatch.setenv("W2X_NO_NATIVE_PIPE", "1")
    path, frames = clip
    monkeypatch.setattr(video, "probe", lambda p: {
        "width": str(W), "height": str(H), "r_frame_rate": "30/1",
        "nb_frames": "N/A"})
    cap = VideoCapture()
    cap.open(path)
    assert cap.frame_count == -1
    got = list(cli._frames(cap))
    cap.release()
    np.testing.assert_array_equal(np.stack(got), frames)


def test_cv2_fallback_roundtrip(tmp_path, monkeypatch):
    """Without ffmpeg on PATH both directions fall back to OpenCV's
    codecs; the port decodes the port's file as the JAX copy does."""
    monkeypatch.setenv("PATH", "/nonexistent")
    assert not video.have_ffmpeg() and not jvideo.have_ffmpeg()
    yy, xx = np.mgrid[0:48, 0:64]
    frames = np.stack(
        [np.stack([(xx * 4 + i * 16) % 256, (yy * 5) % 256,
                   np.full_like(xx, i * 30)], -1) for i in range(8)]
    ).astype(np.uint8)
    out = tmp_path / "clip.mp4"
    w = (VideoWriter().set_frame_size(64, 48).set_frame_rate(24)
         .set_codec("libx264").set_pixel_format("yuv420p")
         .set_constant_rate_factor(23).set_output_file(out))
    w.open()
    for f in frames:
        w.write(f)
    w.release()
    decoded = []
    for mod in (video, jvideo):
        cap = mod.VideoCapture()
        cap.open(out)
        assert (cap.frame_width, cap.frame_height, cap.frame_count) == \
            (64, 48, 8)
        decoded.append(np.stack([cap.read() for _ in range(8)]))
        assert cap.read() is None
        cap.release()
    np.testing.assert_array_equal(decoded[0], decoded[1])
    # lossy codec: gross similarity only
    assert np.mean(np.abs(decoded[0].astype(int) - frames)) < 40
    cap = VideoCapture()
    cap.open(out, frame_range=(3, 6))
    np.testing.assert_array_equal(
        np.stack([cap.read() for _ in range(3)]), decoded[0][3:6])
    assert cap.read() is None
    cap.release()


def test_image_mode(tmp_path, monkeypatch):
    """Images need no ffmpeg; image-mode writers refuse a zero-frame
    release; a video needs ffmpeg or a file OpenCV can open."""
    monkeypatch.setenv("PATH", "/nonexistent")
    img = np.random.default_rng(1).integers(0, 256, (H, W, 3), np.uint8)
    write_image(tmp_path / "x.png", img)
    cap = VideoCapture()
    cap.open(tmp_path / "x.png")
    assert cap.frame_count == 1
    np.testing.assert_array_equal(cap.read(), img)
    assert cap.read() is None
    cap.release()
    assert video.probe_size(tmp_path / "x.png") == (H, W)
    w = (VideoWriter().set_frame_size(4, 4).set_frame_rate(1)
         .set_codec("").set_pixel_format("")
         .set_output_file(tmp_path / "never.png"))
    w.open()
    with pytest.raises(RuntimeError, match="no frame was written"):
        w.release()
    (tmp_path / "v.mp4").touch()  # no ffmpeg, and OpenCV cannot open it
    with pytest.raises(RuntimeError, match="ffmpeg"):
        VideoCapture().open(tmp_path / "v.mp4")


@pytest.mark.parametrize("text", [
    "width=1920\nheight=1080\nr_frame_rate=30000/1001\nnb_frames=300\n",
    "garbage\nno equals", "a=b=c\n=x\n"])
def test_probe_parsing_equals_the_reference(text):
    assert video.parse_key_value_string(text) == \
        jvideo.parse_key_value_string(text)


@pytest.mark.parametrize("text", ["30000/1001", "25/1", "0/0", "25", "1/0"])
def test_fraction_equals_the_reference(text):
    def run(f):
        try:
            return f(text)
        except (ValueError, ZeroDivisionError) as e:
            return type(e)

    assert run(video.fraction_string_to_double) == \
        run(jvideo.fraction_string_to_double)


@pytest.mark.parametrize("frame_range", [None, (0, 1), (2, 5), (7, 300)])
def test_decode_cmd_equals_the_reference(frame_range):
    path = Path("/in/a clip's.mkv")
    assert VideoCapture._decode_cmd(path, frame_range) == \
        jvideo.VideoCapture._decode_cmd(path, frame_range)


@pytest.mark.parametrize("settings", [
    {}, {"fps": 29.97, "codec": "libx265", "pix_fmt": "yuv444p", "crf": 18},
    {"fps": 24.0, "codec": "", "pix_fmt": "", "quality": 5},
    {"fps": 30000 / 1001, "crf": 0}])
def test_encode_cmd_equals_the_reference(settings):
    def cmd(mod):
        w = mod.VideoWriter().set_output_file(Path("/out/v(m).mp4"))
        if "fps" in settings:
            w.set_frame_rate(settings["fps"])
        if "codec" in settings:
            w.set_codec(settings["codec"])
        if "pix_fmt" in settings:
            w.set_pixel_format(settings["pix_fmt"])
        if "crf" in settings:
            w.set_constant_rate_factor(settings["crf"])
        if "quality" in settings:
            w.set_quality(settings["quality"])
        return w._encode_cmd(1280, 720)

    assert cmd(video) == cmd(jvideo)


@pytest.mark.parametrize("count,seg", [
    (6, 0), (6, 2), (6, 4), (6, 6), (6, 10), (1, 1), (7, 3), (300, 64)])
def test_segment_grid_and_paths_equal_the_reference(count, seg):
    grid = video.segment_grid(count, seg)
    assert grid == jvideo.segment_grid(count, seg)
    out = Path("/out/clip(m)(scale2).mp4")
    assert [video.segment_path(out, a, b) for a, b in grid] == \
        [jvideo.segment_path(out, a, b) for a, b in grid]
