"""The port's ONNX backend (``models/onnx_backend.py``) against the JAX
package's, on the CPU at small widths (``torch_onnx_artifacts``):

- ``derive_arch`` gives the JAX package's ``ArchInfo``;
- the positional converters give, array for array, the JAX converters'
  ``_flatten``ed trees (the flat dict ``registry.load_into`` takes);
- conversion and verification errors carry the JAX package's messages;
- ``.verify.json`` records: a sidecar the JAX package wrote (another
  ``CONVERTER_VERSION``) is re-verified, never trusted and never raised
  on, and the JAX package re-verifies one the port wrote; ``.npz``
  records likewise;
- ``GraphModule`` (one graph run a tile under ``torch.func.vmap``) on a
  static-batch export (``onnx_build``, batch 1 in its Reshapes) and a
  dynamic-batch torch export: fp32 against the numpy executor run tile by
  tile, bf16 by the bf16 rule.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.models import onnx_backend as jback
from waifu2x_tensorrt_tpu.models import onnx_graph as jgraph
from waifu2x_tensorrt_tpu.models.registry import _flatten
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.upscaler import Upscaler
from waifu2x_tensorrt_tpu_torch.models import onnx_backend as pback
from waifu2x_tensorrt_tpu_torch.models import onnx_graph as pgraph

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_onnx_artifacts import (  # noqa: E402
    CUNET,
    SWIN,
    make_artifacts,
    probe,
    rewrite,
)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return make_artifacts(tmp_path_factory.mktemp("onnx_backend"))


def _both(path):
    return pgraph.read_graph(path), jgraph.read_graph(path)


@pytest.mark.parametrize("name", SWIN + CUNET)
def test_derive_arch_matches_reference(artifacts, name):
    g, jg = _both(artifacts[name])
    assert pback.derive_arch(g).summary() == jback.derive_arch(jg).summary()


@pytest.mark.parametrize("name", SWIN)
def test_swin_conversion_matches_reference(artifacts, name):
    g, jg = _both(artifacts[name])
    got = pback.swin_params_from_graph(g)
    want = _flatten(jback.swin_params_from_graph(jg))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", CUNET)
def test_cunet_conversion_matches_reference(artifacts, name):
    g, jg = _both(artifacts[name])
    for scale in (None, 1 if name == "build_cunet1" else 2):
        got = pback.cunet_params_from_graph(g, scale=scale)
        want = _flatten(jback.cunet_params_from_graph(jg, scale=scale))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


def test_conversion_errors_match_reference(artifacts):
    cases = [
        (pback.swin_params_from_graph, jback.swin_params_from_graph,
         "torch_cunet", {}),
        (pback.cunet_params_from_graph, jback.cunet_params_from_graph,
         "build_swin", {}),
        (pback.cunet_params_from_graph, jback.cunet_params_from_graph,
         "build_cunet2", {"scale": 1}),
    ]
    for port_fn, jax_fn, name, kw in cases:
        g, jg = _both(artifacts[name])
        with pytest.raises(ValueError) as got:
            port_fn(g, **kw)
        with pytest.raises(ValueError) as want:
            jax_fn(jg, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["build_swin", "torch_swin",
                                  "build_cunet1", "torch_cunet"])
def test_verification_passes_like_reference(artifacts, name):
    g, jg = _both(artifacts[name])
    arch, jarch = pback.derive_arch(g), jback.derive_arch(jg)
    if arch.arch == "cunet":
        err = pback.verify_cunet_conversion(
            g, arch, pback.cunet_params_from_graph(g))
        jerr = jback.verify_cunet_conversion(
            jg, jarch, jback.cunet_params_from_graph(jg))
    else:
        err = pback.verify_swin_conversion(
            g, arch, pback.swin_params_from_graph(g))
        jerr = jback.verify_swin_conversion(
            jg, jarch, jback.swin_params_from_graph(jg))
    assert err <= 1e-5 and jerr <= 1e-5
    assert abs(err - jerr) <= 1e-5


def _slope_changed(src, dst):
    """The swin artifact with the stem's leaky ReLU slope at 0.5: it
    parses and converts alike, but computes other math."""
    def edit(node):
        if node.op_type == "LeakyRelu":
            node.attrs["alpha"] = 0.5
    return rewrite(src, dst, edit)


def _masked(msg):
    return re.sub(r"\d\.\d+e[-+]\d+", "<err>", msg)


def test_verification_divergence_matches_reference(artifacts, tmp_path):
    path = _slope_changed(artifacts["build_swin"], tmp_path / "slope.onnx")
    g, jg = _both(path)
    with pytest.raises(ValueError) as got:
        pback.verify_swin_conversion(g, pback.derive_arch(g),
                                     pback.swin_params_from_graph(g))
    with pytest.raises(ValueError) as want:
        jback.verify_swin_conversion(jg, jback.derive_arch(jg),
                                     jback.swin_params_from_graph(jg))
    assert "diverges" in str(got.value)
    assert _masked(str(got.value)) == _masked(str(want.value))
    num = [float(re.search(r"\d\.\d+e[-+]\d+", str(e.value)).group())
           for e in (got, want)]
    assert abs(num[0] - num[1]) <= 1e-3 * num[1]


def _models_dir(root, src, name="scale2x.onnx"):
    art = root / "swin_unet" / "art" / name
    art.parent.mkdir(parents=True)
    art.write_bytes(Path(src).read_bytes())
    return art


def _cfg(tile=64):
    return RenderConfig(precision=Precision.TF32, batch_size=2,
                        height=tile, width=tile, scaling=2)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_sidecars_of_the_other_package_are_reverified(artifacts, tmp_path,
                                                      monkeypatch):
    """A .verify.json the JAX package wrote (its CONVERTER_VERSION) is
    neither trusted nor raised on by the port — not as a success, not as
    a cached failure — and the JAX package re-verifies the port's."""
    from waifu2x_tensorrt_tpu.engine.config import (
        Precision as JPrecision,
        RenderConfig as JRenderConfig,
    )
    from waifu2x_tensorrt_tpu.engine.upscaler import Upscaler as JUpscaler

    art = _models_dir(tmp_path, artifacts["build_swin"])
    sidecar = art.parent / (art.name + ".verify.json")
    port_calls = _spy(monkeypatch, pback, "verify_swin_conversion")
    jax_calls = _spy(monkeypatch, jback, "verify_swin_conversion")

    JUpscaler(models_dir=tmp_path).load(
        "swin_unet/art", 2, -1, JRenderConfig(
            precision=JPrecision.TF32, batch_size=2, height=64, width=64,
            scaling=2))
    rec = json.loads(sidecar.read_text())
    assert rec["converter_version"] == jback.CONVERTER_VERSION
    assert rec["converter_version"] != pback.CONVERTER_VERSION
    assert jax_calls == [1]
    up = Upscaler(tmp_path, device="cpu")
    up.load("swin_unet/art", 2, -1, _cfg())
    assert port_calls == [1]  # re-verified, not trusted
    assert json.loads(sidecar.read_text())["converter_version"] == \
        pback.CONVERTER_VERSION
    up.load("swin_unet/art", 2, -1, _cfg())
    assert port_calls == [1]  # the port's own record is trusted

    # a cached FAILURE of the other package is not raised either
    rec.update(error="a failure the JAX package recorded")
    sidecar.write_text(json.dumps(rec))
    msgs = []
    up.set_message_callback(lambda s, m: msgs.append(m))
    up.load("swin_unet/art", 2, -1, _cfg())
    assert port_calls == [1, 1]
    assert not any("unavailable" in m for m in msgs), msgs
    assert any("VERIFIED" in m for m in msgs), msgs

    # and the JAX package re-verifies the port's record
    JUpscaler(models_dir=tmp_path).load(
        "swin_unet/art", 2, -1, JRenderConfig(
            precision=JPrecision.TF32, batch_size=2, height=64, width=64,
            scaling=2))
    assert jax_calls == [1, 1]


def test_npz_records_are_keyed_by_converter_version(artifacts, tmp_path):
    npz = tmp_path / "w.npz"
    np.savez(npz, a=np.zeros(3, np.float32))
    for writer, reader, other in (
            (pback.write_npz_verification, pback.npz_verification,
             jback.npz_verification),
            (jback.write_npz_verification, jback.npz_verification,
             pback.npz_verification)):
        writer(npz, {"max_err": 1e-6, "arch": {"base_dim": 32}})
        assert reader(npz)["arch"] == {"base_dim": 32}
        assert other(npz) is None  # another version: not trusted
    # the JAX package still reads the facts of the port's record
    pback.write_npz_verification(npz, {"max_err": 1e-6})
    assert jback.npz_verification(npz, trust=False)["max_err"] == 1e-6
    pback.write_npz_verification(npz, {"max_err": 1e-3})  # past the gate
    assert pback.npz_verification(npz) is None
    pback.write_npz_verification(npz, {"max_err": 0.0})
    np.savez(npz, a=np.ones(3, np.float32))  # edited after the record
    assert pback.npz_verification(npz) is None


@pytest.mark.parametrize("name", ["build_swin", "torch_swin", "torch_cunet"])
def test_graph_module_runs_each_tile(artifacts, name):
    """A tile batch through ``GraphModule``: each tile equal to its own
    numpy-executor run (fp32, atol 3e-5), on the static-batch export and
    the dynamic-batch one; in bf16 by the bf16 rule against the fp32
    truth, the plain bf16 run being ``run_graph_torch`` tile by tile
    (itself held against the JAX executor in test_torch_onnx_graph.py).
    NHWC in and out, contiguous."""
    g = pgraph.read_graph(artifacts[name])
    x = probe(artifacts[name], n=3)
    want = np.stack([pgraph.run_graph(g, {g.inputs[0]: t[None]})
                     [g.outputs[0]][0] for t in x]).transpose(0, 2, 3, 1)
    tiles = torch.from_numpy(x.transpose(0, 2, 3, 1).copy())
    p16 = {k: torch.from_numpy(np.array(v)).bfloat16()
           for k, v in pgraph.graph_params(g).items()}
    with torch.inference_mode():
        got = pback.GraphModule(g)(tiles)
        got16 = pback.GraphModule(g, torch.bfloat16)(tiles.bfloat16())
        plain16 = torch.cat([pgraph.run_graph_torch(
            g, {g.inputs[0]: t.permute(2, 0, 1)[None].bfloat16()},
            params=p16, compute_dtype=torch.bfloat16)[g.outputs[0]]
            for t in tiles]).permute(0, 2, 3, 1)
    assert got.shape == want.shape and got.is_contiguous()
    assert got.dtype == torch.float32 and got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)
    tol = max(2 * float(np.abs(plain16.float().numpy() - want).max()), 0.02)
    assert float(np.abs(got16.float().numpy() - want).max()) <= tol


def test_graph_module_weights_are_buffers_in_the_compute_dtype(artifacts):
    g = pgraph.read_graph(artifacts["torch_swin"])
    m = pback.GraphModule(g, torch.bfloat16)
    bufs = dict(m.named_buffers())
    assert len(bufs) == len(pgraph.graph_params(g)) > 0
    assert all(b.dtype == torch.bfloat16 for b in bufs.values())
    assert not list(m.parameters())
    assert set(m.params()) == set(pgraph.graph_params(g))
