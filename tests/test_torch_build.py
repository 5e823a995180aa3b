"""Engine sidecars, ``build`` and ``validate --save-npz`` of the port
against the JAX package's, on the CPU:

- ``config_hash`` / ``engine_sidecar_path``: the same key and file name
  for the same profile and device name (``"cpu"`` on the CPU in both
  packages); sidecars round-trip and read alike;
- ``is_compatible`` / ``compiled_shapes`` / ``is_warm`` / ``is_optimized``
  and ``find_engine``'s selection (exact opt first, else the first
  compatible corner; other devices, unreadable files and cold geometries
  skipped) equal to the JAX package's;
- ``require_engine`` after a ``build``;
- ``build`` then ``render`` through both CLIs on a small swin export
  (base_dim 32, 64-pixel tiles): equal exit codes, error lines and
  sidecar names, outputs within the golden gate; ``build``'s failures
  ("Engine build failed: ...") alike;
- ``validate --save-npz``: the weights it writes load in both packages.
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from waifu2x_tensorrt_tpu import cli as jcli
from waifu2x_tensorrt_tpu.engine import cache as jcache
from waifu2x_tensorrt_tpu.engine import config as jconfig
from waifu2x_tensorrt_tpu.models import onnx_backend as jback
from waifu2x_tensorrt_tpu.models import onnx_graph as jgraph
from waifu2x_tensorrt_tpu.models import registry as jreg
from waifu2x_tensorrt_tpu.utils import hashing as jhashing
from waifu2x_tensorrt_tpu_torch import cli
from waifu2x_tensorrt_tpu_torch.engine import cache, config
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.io.image import read_image, write_image
from waifu2x_tensorrt_tpu_torch.models import registry, validate
from waifu2x_tensorrt_tpu_torch.utils import hashing

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mirror import export_torch_swin  # noqa: E402

FIELDS = ("min_batch_size", "opt_batch_size", "max_batch_size",
          "min_width", "opt_width", "max_width", "min_height",
          "opt_height", "max_height")


def _build(pkg, precision="fp16", corners=((1, 64), (4, 256), (8, 640))):
    mod = config if pkg == "port" else jconfig
    kw = {}
    for (b, t), level in zip(corners, ("min", "opt", "max")):
        kw.update({f"{level}_batch_size": b, f"{level}_width": t,
                   f"{level}_height": t})
    return mod.BuildConfig(precision=mod.Precision(precision), **kw)


def _render(pkg, batch, tile, precision="fp16"):
    mod = config if pkg == "port" else jconfig
    return mod.RenderConfig(precision=mod.Precision(precision),
                            batch_size=batch, height=tile, width=tile)


PROFILES = [("fp16", ((1, 64), (4, 256), (8, 640))),
            ("tf32", ((16, 256), (16, 256), (16, 256))),
            ("fp16", ((2, 128), (2, 128), (3, 400)))]


@pytest.mark.parametrize("device", ["cpu", "NVIDIA H100 80GB HBM3",
                                    " tab\tand  spaces "])
@pytest.mark.parametrize("profile", range(len(PROFILES)))
def test_hash_and_sidecar_name_match_jax(tmp_path, device, profile):
    precision, corners = PROFILES[profile]
    p, j = _build("port", precision, corners), _build("jax", precision,
                                                      corners)
    assert hashing.config_hash(p, device) == jhashing.config_hash(j, device)
    stem = tmp_path / "noise3_scale4x.npz"
    assert cache.engine_sidecar_path(stem, p, device) == \
        jcache.engine_sidecar_path(stem, j, device)
    assert cache.serialize_config(p, device) == \
        jcache.serialize_config(j, device)


def test_cpu_device_name_is_the_jax_packages(tmp_path):
    """On the CPU both packages key engines on "cpu", so their sidecars
    for one profile have one name; the sidecar reads back alike."""
    import torch

    assert hashing.device_kind(torch.device("cpu")) == "cpu"
    assert hashing.device_kind("cpu") == jhashing.device_kind(0) == "cpu"
    p, j = _build("port"), _build("jax")
    stem = tmp_path / "scale2x.npz"
    path = cache.write_engine_sidecar(stem, p, "cpu")
    assert path == jcache.engine_sidecar_path(stem, j)
    back, dev = cache.deserialize_config(path)
    jback_cfg, jdev = jcache.deserialize_config(path)
    assert dev == jdev == "cpu"
    assert back == p
    assert [getattr(back, f) for f in FIELDS] == \
        [getattr(jback_cfg, f) for f in FIELDS]
    assert json.loads(path.read_text()) == jcache.serialize_config(j, "cpu")


RENDERS = [(1, 64), (4, 256), (8, 640), (2, 128), (3, 400), (16, 256),
           (4, 128), (9, 256)]


@pytest.mark.parametrize("profile", range(len(PROFILES)))
def test_config_checks_match_jax(profile):
    precision, corners = PROFILES[profile]
    p, j = _build("port", precision, corners), _build("jax", precision,
                                                      corners)
    assert config.compiled_shapes(p) == jconfig.compiled_shapes(j)
    for b, t in RENDERS:
        for prec in ("fp16", "tf32"):
            r, jr = _render("port", b, t, prec), _render("jax", b, t, prec)
            for name in ("is_compatible", "is_warm", "is_optimized"):
                assert getattr(config, name)(r, p) == \
                    getattr(jconfig, name)(jr, j), (name, b, t, prec)


@pytest.fixture
def engine_dir(tmp_path):
    """A model directory holding sidecars of several profiles and
    devices, an unreadable one and one of another model's stem."""
    stem = tmp_path / "noise3_scale4x.npz"
    for pkg_corners, dev in (
            (((1, 64), (4, 256), (8, 640)), "cpu"),
            (((4, 256), (4, 256), (4, 256)), "other-device"),
            (((2, 128), (4, 256), (4, 400)), "cpu"),
            (((16, 256), (16, 256), (16, 256)), "cpu")):
        cache.write_engine_sidecar(stem, _build("port", "fp16", pkg_corners),
                                   dev)
    (tmp_path / "noise3_scale4x_broken.engine.json").write_text("{not json")
    cache.write_engine_sidecar(tmp_path / "scale2x.npz", _build("port"),
                               "cpu")
    return stem


@pytest.mark.parametrize("render", RENDERS)
def test_find_engine_matches_jax(engine_dir, render):
    b, t = render
    for prec in ("fp16", "tf32"):
        got = cache.find_engine(engine_dir, _render("port", b, t, prec),
                                "cpu")
        want = jcache.find_engine(engine_dir, _render("jax", b, t, prec),
                                  "cpu")
        assert (got is None) == (want is None), render
        if got is not None:
            assert got[0] == want[0]
            assert [getattr(got[1], f) for f in FIELDS] == \
                [getattr(want[1], f) for f in FIELDS]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("build_art")
    return export_torch_swin(d / "scale2x.onnx", scale=2, base_dim=32,
                             depths=(2, 2, 2, 2, 2), tile=64, seed=8)[1]


def _models(root, src):
    path = Path(root) / "swin_unet" / "art" / "scale2x.onnx"
    path.parent.mkdir(parents=True)
    path.write_bytes(Path(src).read_bytes())
    return path.parent


def test_require_engine_after_build(tmp_path, artifact):
    art_dir = _models(tmp_path, artifact)
    up = Upscaler(models_dir=tmp_path, device="cpu")
    msgs = []
    up.set_message_callback(lambda s, m: msgs.append(m))
    cfg = config.RenderConfig(precision=config.Precision.TF32, batch_size=2,
                              height=64, width=64, scaling=2)
    with pytest.raises(FileNotFoundError, match="could not satisfy"):
        up.load("swin_unet/art", 2, -1, cfg, require_engine=True)
    up.build("swin_unet/art", 2, -1, config.BuildConfig(
        precision=config.Precision.TF32, min_batch_size=2, opt_batch_size=2,
        max_batch_size=2, min_width=64, opt_width=64, max_width=64,
        min_height=64, opt_height=64, max_height=64))
    (sidecar,) = art_dir.glob("*.engine.json")
    up.load("swin_unet/art", 2, -1, cfg, require_engine=True)
    assert any(m.endswith(f"Using engine {sidecar.name}") for m in msgs)
    assert not any("persistent" in m for m in msgs)
    # another batch is not a corner of that profile
    with pytest.raises(FileNotFoundError, match="could not satisfy"):
        up.load("swin_unet/art", 2, -1, config.RenderConfig(
            precision=config.Precision.TF32, batch_size=3, height=64,
            width=64, scaling=2), require_engine=True)


def _run(mod, argv):
    """(exit code, error lines, engine messages without their stamps)."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    errors, engine = [], []
    for line in buf.getvalue().splitlines():
        m = re.match(r"^\[[0-9:.]+\] \[(\w+) *\] (.*)$", line)
        if not m:
            continue
        if m.group(1) == "ERROR":
            errors.append(m.group(2))
        engine.append(re.sub(r"^\[\w+@\d+\] ", "", m.group(2)))
    return rc, errors + err.getvalue().splitlines(), engine


def _argv(models, port, *tail, tile="64"):
    return ["--model", "swin_unet/art", "--scale", "2", "--noise", "-1",
            "--batchSize", "2", "--tileSize", tile, "--precision", "tf32",
            *(["--device", "cpu"] if port else []),
            "--models-dir", str(models), *tail]


def test_build_then_render_through_both_clis(tmp_path, artifact):
    dirs = {name: _models(tmp_path / name, artifact)
            for name in ("jax", "port")}
    img = np.random.default_rng(8).integers(0, 256, (50, 70, 3), np.uint8)
    write_image(tmp_path / "in.png", img)
    runs = {}
    for name, mod, port in (("jax", jcli, False), ("port", cli, True)):
        models = tmp_path / name
        (tmp_path / f"out_{name}").mkdir()
        runs[name] = {
            "build": _run(mod, _argv(models, port, "build")),
            "render": _run(mod, _argv(models, port, "render", "-i",
                                      str(tmp_path / "in.png"), "-o",
                                      str(tmp_path / f"out_{name}"))),
        }
    for step in ("build", "render"):
        assert runs["port"][step][:2] == runs["jax"][step][:2], step
        assert runs["port"][step][0] == 0
    names = {name: sorted(p.name for p in d.glob("*.engine.json"))
             for name, d in dirs.items()}
    assert names["port"] == names["jax"] and len(names["port"]) == 1
    for name in ("jax", "port"):
        assert f"Using engine {names[name][0]}" in runs[name]["render"][2]
    out = "in(swin_unet_art)(scale2).png"
    got = read_image(tmp_path / "out_port" / out)
    want = read_image(tmp_path / "out_jax" / out)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("case", ["fixed_geometry", "no_weights"])
def test_build_failures_match_jax(tmp_path, artifact, case):
    rc_msgs = {}
    for name, mod, port in (("jax", jcli, False), ("port", cli, True)):
        models = tmp_path / name
        if case == "fixed_geometry":  # the 64-pixel export built at 128
            _models(models, artifact)
            argv = _argv(models, port, "--graph-exact", "build",
                         tile="128")
        else:
            argv = _argv(models, port, "build")
        rc, errors, _ = _run(mod, argv)
        rc_msgs[name] = (rc, [e.replace(str(models), "<models>")
                              for e in errors])
    assert rc_msgs["port"] == rc_msgs["jax"]
    rc, errors = rc_msgs["port"]
    assert rc == -1 and errors[0].startswith("Engine build failed: ")


def test_validate_save_npz_loads_in_both_packages(tmp_path, artifact):
    """The port's validate (CPU) writes the converted weights and its
    record; the JAX package reads the same arrays (its own converter's)
    and loads them, with the architecture from the record; the port
    trusts its own record."""
    npz = tmp_path / "models" / "swin_unet" / "art" / "scale2x.npz"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = validate.main([str(artifact), "--family", "swin_unet/art",
                            "--scale", "2", "--device", "cpu",
                            "--save-npz", str(npz)])
    assert rc == 0, buf.getvalue()[-2000:]
    assert "OK: per-tile forward matches" in buf.getvalue()
    rec = json.loads(npz.with_name(npz.name + ".verify.json").read_text())
    assert rec["max_err"] <= 1e-4
    flat = registry.load_params(npz)
    want = jreg._flatten(jback.swin_params_from_graph(
        jgraph.read_graph(artifact)))
    assert sorted(flat) == sorted(want)
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    from waifu2x_tensorrt_tpu.engine.upscaler import Upscaler as JUpscaler

    pmsgs = []
    jup = JUpscaler(models_dir=tmp_path / "models")
    jup.load("swin_unet/art", 2, -1, jconfig.RenderConfig(
        precision=jconfig.Precision.TF32, batch_size=2, height=64, width=64,
        scaling=2))
    assert jup._module.base_dim == 32
    up = Upscaler(models_dir=tmp_path / "models", device="cpu")
    up.set_message_callback(lambda s, m: pmsgs.append(m))
    up.load("swin_unet/art", 2, -1, config.RenderConfig(
        precision=config.Precision.TF32, batch_size=2, height=64, width=64,
        scaling=2))
    assert any("conversion verified vs" in m for m in pmsgs), pmsgs
    assert up.render(np.zeros((20, 30, 3), np.uint8)).shape == (40, 60, 3)


def test_validate_errors_match_jax(tmp_path):
    """Exit code 2 and the JAX tool's triage text for a file that is not
    an ONNX model and for an impossible model choice."""
    from waifu2x_tensorrt_tpu.models import validate as jvalidate

    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
    for argv in ([str(bad), "--family", "swin_unet/art", "--scale", "2"],
                 [str(bad), "--family", "cunet/art", "--scale", "4"]):
        outs = []
        for mod, extra in ((validate, ["--device", "cpu"]), (jvalidate, [])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv + extra)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1] and outs[0][0] == 2
