"""The port's CLI against the JAX package's CLI over one mixed folder, on
the CPU, with the same weights (a small swin ``.npz``: base_dim 32,
depths (1, 1, 2, 1, 1), seed 2), fp32 (``--precision tf32``), tile 64,
batch 3:

- two same-size stills (one cross-file stream run, its carry crossing the
  file boundary), a still of another size (a geometry change), an RGBA
  still (``--alpha auto``) and a 6-frame clip, served by the ffmpeg /
  ffprobe stand-ins of ``chip_smoke.py`` (raw rgb24 over pipes);
- the clip again with ``--segment-frames 4``;
- a folder with a Unicode name holding a Unicode-named still and a broken
  one, with ``--continue-on-error``.

Each CLI runs each once (module scope). Every output of the port passes
the golden gate (max 2 LSB, at most 1e-4 of the values changed) against
the JAX CLI's, the clip's raw bytes and the stitched clip included; the
messages, exit codes and ``--metrics-json`` reports are the JAX CLI's.
The port alone then shows ``--resume`` (of whole files and of a segment),
and ``--profile`` (a trace holding the program's spans).
"""

import contextlib
import io
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from waifu2x_tensorrt_tpu import cli as jcli
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.models.onnx_backend import write_npz_verification
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image
from waifu2x_tensorrt_tpu_torch.io.video import segment_path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the ffmpeg / ffprobe stand-ins)

ARCH = {"base_dim": 32, "depths": (1, 1, 2, 1, 1)}
SUFFIX = "(swin_unet_art)(scale2)"
STILLS = {"a": (72, 100), "b": (72, 100), "c": (40, 52)}
CLIP_HW, CLIP_N = (40, 68), 6
UNICODE_DIR, UNICODE_NAME = "入力 フォルダ", "画像 テスト①.png"


def _argv(models, port):
    return ["--model", "swin_unet/art", "--scale", "2", "--noise", "-1",
            "--batchSize", "3", "--tileSize", "64", "--precision", "tf32",
            *(["--device", "cpu"] if port else []),
            "--models-dir", str(models), "render"]


def _run(mod, argv):
    """(exit code, the CLI's own messages): the console's info and error
    lines without the engine's stamped ``[function@line]`` logs and the
    progress lines (warnings come from the JAX package's advisor, which is
    not ported)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    lines = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"^\[[0-9:.]+\] \[(INFO |ERROR)\] (.*)$", line)
        if m and not m.group(2).startswith(("[", "Rendered file")):
            lines.append(m.group(2))
    return rc, lines


def _gate(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    frac = float((diff > 0).mean())
    assert diff.max() <= 2 and frac <= 1e-4, (int(diff.max()), frac)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("io_cli")
    models = root / "models"
    module, _ = jreg.create_model("swin_unet/art", 2, -1, **ARCH)
    npz = jreg.weights_path(models, "swin_unet/art", 2, -1)
    jreg.save_params(npz, jreg.init_params(module, tile=64, seed=2))
    # the JAX package reads a non-flagship swin's architecture from the
    # checkpoint's verification record; the port reads it from the .npz
    write_npz_verification(npz, {"max_err": 0.0, "arch": {
        "base_dim": ARCH["base_dim"], "stage_depths": [1, 2, 1]}})
    rng = np.random.default_rng(9)
    src = root / "in"
    src.mkdir()
    for name, hw in STILLS.items():
        write_image(src / f"{name}.png",
                    rng.integers(0, 256, (*hw, 3), np.uint8))
    rgba = rng.integers(0, 256, (40, 52, 4), np.uint8)
    rgba[..., 3] = 255
    rgba[:18, :, 3] = 0
    write_image(src / "d.png", rgba)
    chip_smoke.write_raw_clip(
        src / "clip.mp4",
        rng.integers(0, 256, (CLIP_N, *CLIP_HW, 3), np.uint8))
    bad = root / UNICODE_DIR
    bad.mkdir()
    write_image(bad / UNICODE_NAME, rng.integers(0, 256, (40, 52, 3),
                                                  np.uint8))
    (bad / "broken.png").write_bytes(b"not a png")
    chip_smoke.write_ffmpeg_shims(root / "bin")

    out = {"root": root, "src": src, "models": models}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", f"{root / 'bin'}{os.pathsep}{os.environ['PATH']}")
        for name, mod, port in (("jax", jcli, False), ("port", cli, True)):
            argv = _argv(models, port)
            d = {k: root / f"{name}_{k}" for k in ("all", "seg", "bad")}
            for p in d.values():
                p.mkdir()
            extra = ["--profile", str(root / "prof")] if port else []
            out[name] = {
                "dirs": d,
                "all": _run(mod, argv + [
                    "-i", str(src), "-o", str(d["all"]), "--alpha", "auto",
                    "--metrics-json", str(root / f"{name}.json"), *extra]),
                "seg": _run(mod, argv + [
                    "-i", str(src / "clip.mp4"), "-o", str(d["seg"]),
                    "--segment-frames", "4"]),
                "bad": _run(mod, argv + [
                    "-i", str(bad), "-o", str(d["bad"]),
                    "--continue-on-error",
                    "--metrics-json", str(root / f"{name}_bad.json")]),
            }
        yield out


def _clip_frames(path):
    return chip_smoke.read_raw_clip(path, 2 * CLIP_HW[0], 2 * CLIP_HW[1])


def _messages(runs, key, name):
    """The run's messages with its output directory as ``OUT``."""
    d = str(runs[name]["dirs"][key])
    return [m.replace(d, "OUT") for m in runs[name][key][1]]


@pytest.mark.parametrize("key", ["all", "seg", "bad"])
def test_exit_codes_and_messages_match_the_reference(runs, key):
    assert runs["port"][key][0] == runs["jax"][key][0]
    assert _messages(runs, key, "port") == _messages(runs, key, "jax")


def test_exit_codes_and_outputs(runs):
    assert runs["port"]["all"][0] == 0 and runs["port"]["seg"][0] == 0
    assert runs["port"]["bad"][0] == -1  # the broken still, run continued
    wrote = [m for m in runs["port"]["all"][1] if m.startswith("Wrote ")]
    assert len(wrote) == 5
    assert any("Failed to open" in m or "Render failed" in m
               for m in runs["port"]["bad"][1])


@pytest.mark.parametrize("name", sorted(STILLS))
def test_streamed_stills_match_the_reference(runs, name):
    got, want = (read_image(runs[k]["dirs"]["all"] / f"{name}{SUFFIX}.png")
                 for k in ("port", "jax"))
    assert got.shape == (2 * STILLS[name][0], 2 * STILLS[name][1], 3)
    _gate(got, want)


def test_rgba_still_matches_the_reference(runs):
    from PIL import Image

    got, want = (np.asarray(Image.open(
        runs[k]["dirs"]["all"] / f"d{SUFFIX}.png")) for k in ("port", "jax"))
    assert got.shape == (80, 104, 4)
    _gate(got, want)


@pytest.mark.parametrize("key", ["all", "seg"])
def test_clip_matches_the_reference(runs, key):
    got, want = (_clip_frames(runs[k]["dirs"][key] / f"clip{SUFFIX}.mp4")
                 for k in ("port", "jax"))
    assert got.shape == (CLIP_N, 2 * CLIP_HW[0], 2 * CLIP_HW[1], 3)
    _gate(got, want)


def test_segmented_clip_matches_the_whole_clip(runs):
    d = runs["port"]["dirs"]
    _gate(_clip_frames(d["seg"] / f"clip{SUFFIX}.mp4"),
          _clip_frames(d["all"] / f"clip{SUFFIX}.mp4"))
    assert not list(d["seg"].glob("*.seg*"))  # parts stitched and removed


def test_metrics_json_matches_the_reference(runs):
    root = runs["root"]
    for stem in ("", "_bad"):
        got, want = (json.loads((root / f"{k}{stem}.json").read_text())
                     for k in ("port", "jax"))
        assert got["config"] == want["config"]
        assert [(f["input"], f["rc"], f["frames"]) for f in got["files"]] \
            == [(f["input"], f["rc"], f["frames"]) for f in want["files"]]
        assert {k: v for k, v in got["totals"].items()
                if k != "wall_seconds"} == {
            k: v for k, v in want["totals"].items() if k != "wall_seconds"}
    bad = json.loads((root / "port_bad.json").read_text())
    assert bad["totals"]["failed"] == 1 and bad["totals"]["exit_code"] == -1


def test_unicode_still_written_after_a_failure(runs):
    got, want = (read_image(runs[k]["dirs"]["bad"]
                            / (Path(UNICODE_NAME).stem + SUFFIX + ".png"))
                 for k in ("port", "jax"))
    _gate(got, want)


def test_resume_renders_nothing(runs, monkeypatch):
    """A second run with --resume over the finished folder skips every
    file before any model work."""
    root, d = runs["root"], runs["port"]["dirs"]["all"]
    before = {p.name: p.stat().st_mtime_ns for p in d.iterdir()}

    def banned(*a, **k):  # pragma: no cover
        raise AssertionError("--resume rendered a file")

    monkeypatch.setattr(cli.Upscaler, "render", banned)
    monkeypatch.setattr(cli.Upscaler, "open_stream", banned)
    monkeypatch.setenv("PATH", f"{root / 'bin'}{os.pathsep}"
                       f"{os.environ['PATH']}")
    rc, msgs = _run(cli, _argv(runs["models"], True) + [
        "-i", str(runs["src"]), "-o", str(d), "--alpha", "auto", "--resume"])
    assert rc == 0
    assert sum(m.startswith("Skipping ") for m in msgs) == 5
    assert {p.name: p.stat().st_mtime_ns for p in d.iterdir()} == before


def test_segment_resume_keeps_finished_parts(runs, tmp_path, monkeypatch):
    """Frame-index resume: a finished part file is stitched as it is and
    only the other segments render."""
    root = runs["root"]
    monkeypatch.setenv("PATH", f"{root / 'bin'}{os.pathsep}"
                       f"{os.environ['PATH']}")
    out = tmp_path / f"clip{SUFFIX}.mp4"
    oh, ow = 2 * CLIP_HW[0], 2 * CLIP_HW[1]
    sentinel = bytes(range(256)) * (2 * oh * ow * 3 // 256)
    segment_path(out, 0, 2).write_bytes(sentinel)
    rc, msgs = _run(cli, _argv(runs["models"], True) + [
        "-i", str(runs["src"] / "clip.mp4"), "-o", str(tmp_path),
        "--segment-frames", "2", "--resume"])
    assert rc == 0
    assert "Skipping frames [0, 2) (segment exists)" in msgs
    data = out.read_bytes()
    assert data[:len(sentinel)] == sentinel
    rest = np.frombuffer(data[len(sentinel):], np.uint8).reshape(-1, oh,
                                                                  ow, 3)
    want = _clip_frames(runs["jax"]["dirs"]["all"] / f"clip{SUFFIX}.mp4")
    _gate(rest, want[2:])


def test_profile_writes_a_trace(runs):
    assert list((runs["root"] / "prof").glob("*.pt.trace.json"))


def test_profile_trace_holds_program_spans(runs):
    """The port's stage spans are in the ``--profile`` trace, with their
    counts as arguments, and the record is empty once ``trace`` ends."""
    from waifu2x_tensorrt_tpu_torch.utils import profiling

    (path,) = (runs["root"] / "prof").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("name", "").startswith("w2x."):
            spans.setdefault(e["name"], []).append(e.get("args", {}))
    assert {"w2x.prepare", "w2x.model", "w2x.finalize"} <= set(spans)
    assert all(a.get("n", 0) > 0 for a in spans["w2x.model"])
    assert profiling.records() == []
