"""The port's CLI against the JAX package's on the CPU: the same flags
parse, the same arguments are refused with the same exit code (-1), in
the same order, and the video flags ride along on still images.
"""

import numpy as np
import pytest

from waifu2x_tensorrt_tpu import cli as jcli
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image

VIDEO_FLAGS = ["--codec", "libx265", "--pix_fmt", "yuv444p", "--crf", "18"]


def _argv(tmp_path, render_extra=(), front=(), port=True):
    """The same command for both CLIs; the port's renders on the CPU (the
    reference's ``--device`` takes an index only), in fp32 as the CLI test
    of tests/test_torch_render.py renders."""
    return (["--model", "swin_unet/art", "--scale", "2", "--noise", "-1",
             "--batchSize", "2", "--tileSize", "64", "--precision", "tf32",
             *(["--device", "cpu"] if port else []),
             "--models-dir", str(tmp_path / "none"),
             "--allow-random-weights", *front, "render", "-i",
             str(tmp_path / "in.png"), *render_extra])


def _frame(tmp_path):
    yy, xx = np.mgrid[0:29, 0:35]
    frame = np.stack([xx * 7 % 256, yy * 5 % 256, (xx + yy) * 3 % 256],
                     -1).astype(np.uint8)
    write_image(tmp_path / "in.png", frame)


def test_video_flags_accepted_on_still_images(tmp_path):
    _frame(tmp_path)
    outs = []
    for name, extra in (("plain", []), ("flags", VIDEO_FLAGS)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        extra = ["-o", str(out_dir), *extra]
        # the reference's parser and checks take the same arguments
        jcli._validate(jcli.build_parser().parse_args(
            _argv(tmp_path, extra, port=False)))
        assert cli.main(_argv(tmp_path, extra)) == 0
        outs.append(read_image(out_dir / "in(swin_unet_art)(scale2).png"))
    np.testing.assert_array_equal(outs[0], outs[1])
    args = cli.build_parser().parse_args(_argv(tmp_path))
    ref = jcli.build_parser().parse_args(_argv(tmp_path, port=False))
    for flag in ("codec", "pix_fmt", "crf", "continue_on_error"):
        assert getattr(args, flag) == getattr(ref, flag), flag


@pytest.mark.parametrize("render_extra,front", [
    (["--crf", "52"], []),
    (["--crf", "-1"], []),
    ([], ["--dp", "-1"]),
    (["-o", "missing-dir"], []),
    # the order of the checks: --dp before the blend and the -o directory
    (["--blend", "0.3", "-o", "missing-dir"], ["--dp", "-1"]),
], ids=["crf52", "crf-1", "dp-1", "no-outdir", "order"])
def test_refused_arguments_exit_minus_one_like_the_reference(
        tmp_path, render_extra, front, capsys):
    _frame(tmp_path)
    extra = [str(tmp_path / a) if a == "missing-dir" else a
             for a in render_extra]
    assert jcli.main(_argv(tmp_path, extra, front, port=False)) == -1
    want = capsys.readouterr().err
    assert cli.main(_argv(tmp_path, extra, front)) == -1
    assert capsys.readouterr().err == want


def test_continue_on_error_not_yet_ported(tmp_path, capsys):
    _frame(tmp_path)
    assert cli.main(_argv(tmp_path, ["--continue-on-error"])) == 2
    assert "--continue-on-error: not yet ported" in capsys.readouterr().err
