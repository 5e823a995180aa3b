"""The port's program store (``engine/exe_cache.py``) on the CPU.

- the key covers the tag and every argument's shape, dtype and device,
  and the fingerprint covers the code, torch and the device;
- ``module_tag`` tracks every hyperparameter (width, depths, fused_block,
  dtype, the packed-x head, the cunet family) and nothing else: two
  modules built alike share a tag whatever their weights;
- ``enabled()`` is False on the CPU, and a ``CachedProgram`` there is the
  eager function byte for byte, with no graph kept; ``store_dir()`` is
  None (nothing is persisted);
- the pipeline's model programs and ``RendererCache``'s whole-frame
  programs carry the JAX package's tags (``model|``, ``fused|``);
- a graph's launch record: what a capture counted is taken off the
  counters and named (``launches_B``, ``direct_B``), each replay adds it
  back, and a replay's trace counts carry it (the graph itself is a stub:
  the CPU has none).
"""

import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu_torch.engine import exe_cache
from waifu2x_tensorrt_tpu_torch.engine.config import Precision, RenderConfig
from waifu2x_tensorrt_tpu_torch.engine.renderer import (
    ChunkedPipeline,
    RendererCache,
)
from waifu2x_tensorrt_tpu_torch.models import registry

SMALL = {"base_dim": 32, "depths": (1, 1, 2, 1, 1)}


def _cfg(**kw):
    return RenderConfig(precision=Precision.TF32, batch_size=2, height=64,
                        width=64, scaling=2, overlap=(1 / 16, 1 / 16), **kw)


def test_key_covers_tag_shape_dtype_and_device():
    prog = exe_cache.cached_program(lambda x: x + 1, tag="t")
    x = torch.zeros((2, 8, 8, 3))
    key = prog.key(x)
    assert key[0] == "t"
    assert key[2] == exe_cache.fingerprint("cpu")
    others = [
        exe_cache.cached_program(lambda x: x + 1, tag="u").key(x),
        prog.key(torch.zeros((3, 8, 8, 3))),
        prog.key(torch.zeros((2, 8, 16, 3))),
        prog.key(x.to(torch.bfloat16)),
        prog.key(torch.zeros((2, 8, 8, 3), device="meta")),
        prog.key(x, x),
    ]
    assert len({key, *others}) == 1 + len(others)
    assert prog.key(torch.ones((2, 8, 8, 3))) == key  # values are not


def test_fingerprint_covers_code_torch_and_device():
    fp = exe_cache.fingerprint("cpu")
    code, version, cuda, device = fp.split("|", 3)
    assert len(code) == 16 and version == torch.__version__
    assert cuda == str(torch.version.cuda) and device == "cpu"
    assert exe_cache.fingerprint("meta") != fp


def test_module_tag_tracks_hyperparameters():
    def tag(family="swin_unet/art", scale=2, noise=-1, **kw):
        module, _ = registry.create_model(family, scale, noise, **kw)
        return exe_cache.module_tag(module)

    base = tag(**SMALL)
    assert tag(**SMALL) == base  # other random weights, same program
    variants = {
        tag(base_dim=64, depths=SMALL["depths"]),
        tag(base_dim=32, depths=(1, 1, 4, 1, 1)),
        tag(fused_block=True, **SMALL),
        tag(dtype=torch.bfloat16, **SMALL),
        tag(scale=4, **SMALL),
        tag("cunet/art", 2, 1),
        tag("cunet/art", 1, 0),
    }
    assert base not in variants and len(variants) == 7
    module, spec = registry.create_model("swin_unet/art", 2, -1, **SMALL)
    twin, _ = registry.packed_x_twin(module, spec)
    assert exe_cache.module_tag(twin) != exe_cache.module_tag(module)
    block = module.swin2.block1
    assert block.shift == 4
    before = exe_cache.module_tag(module)
    block.shift = 0
    assert exe_cache.module_tag(module) != before


def test_disabled_on_the_cpu_and_eager_byte_for_byte():
    exe_cache.configure("models", "cpu")
    try:
        assert not exe_cache.enabled()
        assert not exe_cache.enabled("cpu")
        assert exe_cache.enabled("cuda:0")  # a device name; nothing runs
        assert exe_cache.store_dir() is None
    finally:
        exe_cache.configure(None)
    module, _ = registry.create_model("swin_unet/art", 2, -1, **SMALL)
    prog = exe_cache.cached_program(module, tag="model|x")
    assert prog.fn is module
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 64, 3), dtype=np.float32))
    with torch.inference_mode():
        want = module(x)
    got = prog(x)
    assert torch.equal(got, want)
    assert prog.graphs == {}


@pytest.mark.parametrize("family,scale,noise,arch", [
    ("swin_unet/art", 2, -1, SMALL),
    ("cunet/art", 2, 1, {}),
])
def test_programs_carry_the_jax_tags(family, scale, noise, arch):
    module, spec = registry.create_model(family, scale, noise, **arch)
    pl = ChunkedPipeline(module, spec, _cfg(), "cpu")
    tag = exe_cache.module_tag(module)
    assert pl.model_prog.tag == f"model|{tag}"
    assert pl.model_prog.fn is module and pl.model_prog_px is None
    assert pl.model_prog.pool is pl.pool
    rc = RendererCache(module, spec, _cfg(), "cpu")
    prog = rc.get((40, 56))
    assert prog.tag == f"fused|{tag}|{spec}|{_cfg()}"
    assert rc.get((40, 56)) is prog and rc.get((40, 64)) is not prog
    assert prog.pool is rc.pool
    assert prog.n_chunks == -(-prog.plan.tile_count // 2)


class _StubGraph:
    def replay(self):
        pass


def test_graph_launch_record_counts_direct_b(monkeypatch):
    from waifu2x_tensorrt_tpu_torch.ops.swin_block import fused_swin_block

    before = exe_cache.counter_values()
    assert set(before) == {"launches_A", "launches_B", "launches_C",
                           "launches_D", "launches_E", "launches_F",
                           "launches_G", "launches_H", "launches_I",
                           "launches_J", "launches_K", "direct_B",
                           "overlap_G", "rect_G", "padded_G", "padded_I",
                           "padded_J", "skip_I"}
    # a flagship chunk's capture: 10 launches of B, all on activations,
    # and one of C
    fused_swin_block.launches += 10
    fused_swin_block.direct_launches += 10
    exe_cache.graph_counters()["launches_C"][0].launches += 1
    recorded = exe_cache.take_recorded(before)
    assert recorded == {"launches_B": 10, "direct_B": 10, "launches_C": 1}
    assert exe_cache.counter_values() == before  # recorded, not run
    x = torch.zeros((2, 8, 8, 3))
    graph = exe_cache._Graph(_StubGraph(), (x.clone(),), x.clone(),
                             recorded, 0, 0.0, 0.0)
    for _ in range(3):
        graph.replay((x,))
    after = exe_cache.counter_values()
    assert {k: after[k] - before[k] for k in before if after[k] != before[
        k]} == {"launches_B": 30, "direct_B": 30, "launches_C": 3}
    prog = exe_cache.cached_program(lambda t: t, tag="model|x")
    prog.graphs[prog.key(x)] = graph
    monkeypatch.setattr(exe_cache, "enabled", lambda device=None: True)
    assert prog.trace_counts(x) == {"program": "replay", "launches_B": 10,
                                    "direct_B": 10, "launches_C": 1}
    assert prog.trace_counts(torch.zeros((1, 8, 8, 3))) == {
        "program": "capture"}
