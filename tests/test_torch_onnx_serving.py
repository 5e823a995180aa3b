"""Serving a bare ``.onnx`` through the port's ``Upscaler`` on the CPU,
against the JAX package's ``Upscaler`` on the same artifact:

- the verified path (positional conversion checked against the
  artifact's own graph, served on the port's modules) and the
  ``graph_exact`` path (``GraphModule``), in fp32 (tf32) at equal chunk
  shapes, within the golden gate (max 2 LSB, at most 1e-4 of the pixels
  changed) of the JAX package's renders;
- the stored golden ``tests/golden/swin_unet_art_s2_n-1_graph.png``
  (the JAX package's graph-exact render, ``test_golden.py::
  test_golden_graph_backed``) reproduced by the port through that test's
  recipe;
- every artifact error case with the JAX package's message: scale and
  family mismatches, a fixed-geometry export at another tile, the tile
  divisor, whole-frame tiles on a parsed graph, a corrupt file, a missing
  external-data file, ``require_engine`` without a sidecar, and a
  conversion that does not verify (a warning, then graph serving; the
  failure cached).
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

from waifu2x_tensorrt_tpu.engine.config import Precision as JPrecision
from waifu2x_tensorrt_tpu.engine.config import RenderConfig as JRenderConfig
from waifu2x_tensorrt_tpu.engine.upscaler import Upscaler as JUpscaler
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.io.image import read_image

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mirror import export_torch_cunet, export_torch_swin  # noqa: E402
from torch_onnx_artifacts import rewrite  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "swin_unet_art_s2_n-1_graph.png"


def _gate(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    frac = float((diff > 0).mean())
    assert diff.max() <= 2 and frac <= 1e-4, (int(diff.max()), frac)


def _frame():
    """The golden recipe's 48 x 64 frame."""
    yy, xx = np.mgrid[0:48, 0:64]
    return np.stack([xx * 5 % 256, yy * 7 % 256, (xx + yy) * 3 % 256],
                    -1).astype(np.uint8)


def _cfgs(tile=32, batch=2, precision="tf32"):
    kw = dict(batch_size=batch, height=tile, width=tile, scaling=2,
              overlap=(1 / 16, 1 / 16))
    return (RenderConfig(precision=Precision(precision), **kw),
            JRenderConfig(precision=JPrecision(precision), **kw))


def _place(root, src, family="swin_unet/art", name="scale2x.onnx"):
    path = Path(root) / family / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(Path(src).read_bytes())
    return path


@pytest.fixture(scope="module")
def golden_artifact(tmp_path_factory):
    """The golden recipe's artifact: a seeded torch export, swin 2x,
    base_dim 32, 32-pixel tiles (a fixed-geometry export)."""
    d = tmp_path_factory.mktemp("golden_art")
    return export_torch_swin(str(d / "scale2x.onnx"), scale=2, tile=32,
                             seed=0)[1]


def test_port_reproduces_the_graph_golden(golden_artifact, tmp_path):
    _place(tmp_path, golden_artifact)
    up = Upscaler(models_dir=tmp_path, device="cpu")
    up.load("swin_unet/art", 2, -1, _cfgs()[0], graph_exact=True)
    _gate(up.render(_frame()), read_image(GOLDEN))


@pytest.mark.parametrize("graph_exact", [False, True])
def test_onnx_serving_matches_jax_upscaler(golden_artifact, tmp_path,
                                           graph_exact):
    """The same artifact, frame and chunk shapes through both packages'
    Upscaler, tf32 (fp32)."""
    _place(tmp_path / "port", golden_artifact)
    _place(tmp_path / "jax", golden_artifact)
    cfg, jcfg = _cfgs()
    msgs = []
    up = Upscaler(models_dir=tmp_path / "port", device="cpu")
    up.set_message_callback(lambda s, m: msgs.append(m))
    up.load("swin_unet/art", 2, -1, cfg, graph_exact=graph_exact)
    jup = JUpscaler(models_dir=tmp_path / "jax")
    jup.load("swin_unet/art", 2, -1, jcfg, graph_exact=graph_exact)
    frame = np.random.default_rng(4).integers(0, 256, (40, 72, 3), np.uint8)
    _gate(up.render(frame), np.asarray(jup.render(frame)))
    assert any(("parsed ONNX graph" if graph_exact else "VERIFIED") in m
               for m in msgs), msgs


def test_cunet_artifact_verified_and_graph_agree(tmp_path):
    """A cunet 2x torch export (no fixed geometry): the verified path
    (the port's UpCUNet) and the graph within the golden gate of each
    other, at a tile that is not the export's, and whole-frame tiles on
    the verified path."""
    src = export_torch_cunet(tmp_path / "c.onnx", scale=2, tile=76,
                             seed=5)[1]
    _place(tmp_path / "m", src, "cunet/art", "noise1_scale2x.onnx")
    frame = np.random.default_rng(5).integers(0, 256, (60, 52, 3), np.uint8)
    outs = []
    for graph_exact in (False, True):
        up = Upscaler(models_dir=tmp_path / "m", device="cpu")
        up.load("cunet/art", 2, 1, RenderConfig(
            precision=Precision.TF32, batch_size=2, height=64, width=64,
            scaling=2), graph_exact=graph_exact)
        outs.append(up.render(frame))
    _gate(outs[1], outs[0])
    up.load("cunet/art", 2, 1, RenderConfig(
        precision=Precision.TF32, batch_size=1, height=0, width=0,
        scaling=2))
    _gate(up.render(frame), outs[0])


def _load_errors(root, family, scale, noise, cfg, jcfg, **kw):
    """(port message, JAX message) of a failing load of both packages."""
    with pytest.raises(Exception) as got:
        Upscaler(models_dir=root, device="cpu").load(family, scale, noise,
                                                     cfg, **kw)
    with pytest.raises(Exception) as want:
        JUpscaler(models_dir=root).load(family, scale, noise, jcfg, **kw)
    assert type(got.value) is type(want.value) or (
        isinstance(got.value, ValueError)
        and isinstance(want.value, ValueError))
    return str(got.value), str(want.value)


@pytest.fixture(scope="module")
def cunet_artifact(tmp_path_factory):
    d = tmp_path_factory.mktemp("cunet_art")
    return export_torch_cunet(d / "c.onnx", scale=2, tile=76, seed=6)[1]


def _case(name, root, golden_artifact, cunet_artifact):
    """(family, scale, noise, port cfg, jax cfg, kw) of an error case,
    with its artifact placed under ``root``."""
    cfg, jcfg = _cfgs()
    if name == "scale_mismatch":  # a 2x export where the 4x one belongs
        _place(root, golden_artifact, name="scale4x.onnx")
        return ("swin_unet/art", 4, -1, *_cfgs(), {})
    if name == "family_mismatch":  # a cunet export under swin_unet/art
        _place(root, cunet_artifact)
        return ("swin_unet/art", 2, -1, cfg, jcfg, {})
    if name == "fixed_geometry":  # a 32-pixel export served at 64
        _place(root, golden_artifact)
        return ("swin_unet/art", 2, -1, *_cfgs(tile=64),
                {"graph_exact": True})
    if name == "tile_divisor":  # cunet's graph at a tile not /4
        _place(root, cunet_artifact, "cunet/art", "noise1_scale2x.onnx")
        return ("cunet/art", 2, 1, *_cfgs(tile=66), {"graph_exact": True})
    if name == "whole_frame_graph":
        _place(root, cunet_artifact, "cunet/art", "noise1_scale2x.onnx")
        return ("cunet/art", 2, 1, *_cfgs(tile=0), {"graph_exact": True})
    if name == "corrupt_file":
        path = root / "swin_unet" / "art" / "scale2x.onnx"
        path.parent.mkdir(parents=True)
        path.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
        return ("swin_unet/art", 2, -1, cfg, jcfg, {})
    if name == "missing_external_data":
        from waifu2x_tensorrt_tpu_torch.models.onnx_build import (
            externalize_initializers,
        )

        path = _place(root, golden_artifact)
        externalize_initializers(path, path, threshold_bytes=1024)
        (path.parent / (path.name + ".data")).unlink()
        return ("swin_unet/art", 2, -1, cfg, jcfg, {})
    if name == "require_engine":
        _place(root, golden_artifact)
        return ("swin_unet/art", 2, -1, cfg, jcfg, {"require_engine": True})
    raise KeyError(name)


ERRORS = ["scale_mismatch", "family_mismatch", "fixed_geometry",
          "tile_divisor", "whole_frame_graph", "corrupt_file",
          "missing_external_data", "require_engine"]


@pytest.mark.parametrize("name", ERRORS)
def test_artifact_errors_match_jax(tmp_path, golden_artifact, cunet_artifact,
                                   name):
    family, scale, noise, cfg, jcfg, kw = _case(
        name, tmp_path, golden_artifact, cunet_artifact)
    got, want = _load_errors(tmp_path, family, scale, noise, cfg, jcfg, **kw)
    assert got == want


def test_unverifiable_artifact_serves_its_graph(tmp_path, golden_artifact):
    """A conversion that does not verify (the artifact's leaky-ReLU slope
    differs from the reconstruction's): the JAX package's warning, the
    parsed graph serves, and the failure is cached in .verify.json (the
    next load says so and verifies nothing)."""
    def edit(node):
        if node.op_type == "LeakyRelu":
            node.attrs["alpha"] = 0.5

    src = rewrite(golden_artifact, tmp_path / "slope.onnx", edit)
    _place(tmp_path / "port", src)
    _place(tmp_path / "jax", src)
    warns = {"port": [], "jax": []}
    cfg, jcfg = _cfgs()
    up = Upscaler(models_dir=tmp_path / "port", device="cpu")
    up.set_message_callback(lambda s, m: warns["port"].append(m))
    jup = JUpscaler(models_dir=tmp_path / "jax")
    jup.set_message_callback(lambda s, m: warns["jax"].append(m))
    for _ in range(2):
        up.load("swin_unet/art", 2, -1, cfg)
        jup.load("swin_unet/art", 2, -1, jcfg)

    def unavailable(msgs):
        out = [re.sub(r"^\[\w+@\d+\] ", "", m) for m in msgs
               if "optimized serving unavailable" in m]
        return [re.sub(r"\d\.\d+e[-+]\d+", "<err>", m) for m in out]

    got, want = unavailable(warns["port"]), unavailable(warns["jax"])
    assert len(got) == 2 and got == want, (got, want)
    assert "(cached verification)" in got[1]
    assert any("parsed ONNX graph" in m for m in warns["port"])
    frame = _frame()
    _gate(up.render(frame), np.asarray(jup.render(frame)))
