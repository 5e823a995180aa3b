"""Kernel B's prepared operands (``ops/swin_block.block_operands``) and
their cache in ``models/swin_unet.SwinBlock``, on the CPU.

- The plain twin on prepared operands (``swin_block_prepared``) gives the
  bytes of the plain twin on the JAX-layout params, fp32 and bf16, and the
  JAX package's Pallas ``fused_swin_block`` in interpret mode within fp32
  atol 1e-4 (C=64 / 2 heads, shifts 0 and 4), as
  ``tests/test_torch_swin_block.py`` holds the per-call path;
- the (out, in) layout of the bf16 kernel on the card turns back into the
  JAX layout unchanged (``BlockOperands.params``);
- a block builds its operands once per dtype and reuses them; after
  ``registry.load_into`` with other weights, a ``SwinBlock``, a
  ``SwinUNet`` and its packed-x twin give the output of freshly built
  modules holding those weights (no stale cache);
- so does every model's operand cache (``models/layers.cached``):
  swin_unet (fused and unfused blocks), cunet and HAT build it at the
  first forward, keep it, rebuild it after ``registry.load_into``, and
  the packed-x twin shares it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waifu2x_tensorrt_tpu.ops.swin_block import (
    fused_swin_block as jax_fused_block,
)
from waifu2x_tensorrt_tpu_torch.models import registry as treg
from waifu2x_tensorrt_tpu_torch.models.swin_unet import SwinBlock
from waifu2x_tensorrt_tpu_torch.ops.swin_block import (
    PARAM_NAMES,
    BlockOperands,
    block_operands,
    fused_swin_block,
    swin_block_plain,
    swin_block_prepared,
)

C, NH, N = 64, 2, 64
SMALL = dict(base_dim=32, depths=(2, 2, 2, 2, 2))


def _inputs(seed, bw=10):
    rng = np.random.default_rng(seed)

    def r(*shape, loc=0.0, scale=0.05):
        return rng.normal(loc, scale, shape).astype(np.float32)

    params = {
        "n1_scale": r(C, loc=1, scale=0.1), "n1_bias": r(C, scale=0.1),
        "qkv_kernel": r(C, 3 * C), "qkv_bias": r(3 * C),
        "proj_kernel": r(C, C), "proj_bias": r(C),
        "n2_scale": r(C, loc=1, scale=0.1), "n2_bias": r(C, scale=0.1),
        "fc1_kernel": r(C, 2 * C), "fc1_bias": r(2 * C),
        "fc2_kernel": r(2 * C, C), "fc2_bias": r(C),
    }
    bias = r(NH, N, N, scale=0.2)
    flags = rng.integers(0, 4, bw).astype(np.int32)
    x = r(bw, N, C, scale=1.0)
    return x, params, bias, flags


def _torch(x, params, bias, flags):
    return (torch.tensor(x), {k: torch.tensor(v) for k, v in params.items()},
            torch.tensor(bias), torch.tensor(flags))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_prepared_equals_per_call_params(shift, dtype):
    x, params, bias, flags = _torch(*_inputs(shift + 1))
    x = x.to(dtype)
    ops = block_operands(params, bias, dtype)
    assert not ops.out_in  # the CPU keeps the JAX layout
    assert ops.num_heads == NH and ops.dim == C
    got = swin_block_prepared(x, ops, flags, shift=shift)
    want = swin_block_plain(x, params, bias, flags, num_heads=NH,
                            shift=shift)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(fused_swin_block(x, params, bias, flags,
                                        num_heads=NH, shift=shift), want)


@pytest.mark.parametrize("shift", [0, 4])
def test_prepared_matches_pallas_interpret(shift):
    x, params, bias, flags = _inputs(shift + 11)
    want = np.array(jax_fused_block(
        jnp.array(x), {k: jnp.array(v) for k, v in params.items()},
        jnp.array(bias), jnp.array(flags), num_heads=NH, shift=shift,
        block_windows=4, interpret=True))
    tx, tp, tb, tf = _torch(x, params, bias, flags)
    got = swin_block_prepared(tx, block_operands(tp, tb, torch.float32), tf,
                              shift=shift).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_out_in_layout_round_trips():
    _x, params, bias, _f = _torch(*_inputs(3))
    gemm = ("qkv_kernel", "proj_kernel", "fc1_kernel", "fc2_kernel")
    tensors = tuple(params[k].t().to(torch.bfloat16).contiguous()
                    if k in gemm else params[k] for k in PARAM_NAMES)
    ops = BlockOperands(tensors, bias, torch.bfloat16, out_in=True)
    back = ops.params()
    for k in PARAM_NAMES:
        want = params[k].to(torch.bfloat16) if k in gemm else params[k]
        assert back[k].is_contiguous()
        assert torch.equal(back[k], want), k
    assert ops.dim == C


def test_block_operands_rejects_bad_shapes():
    _x, params, bias, _f = _torch(*_inputs(4))
    with pytest.raises(ValueError, match="fc2_kernel"):
        block_operands(dict(params, fc2_kernel=params["fc2_kernel"][:C]),
                       bias, torch.float32)
    with pytest.raises(ValueError, match="bias"):
        block_operands(params, bias[:, :32], torch.float32)
    with pytest.raises(ValueError, match="heads"):
        block_operands(params, bias[:1], torch.float32)
    with pytest.raises(TypeError):
        block_operands(params, bias, torch.float16)


def _reseeded(module, seed):
    """Seeded weights with non-zero LayerNorm and bias-table entries."""
    return treg.init_params(module, seed=seed)


# name: ((family, scale, noise), create_model options, tile)
CACHE_MODELS = {
    "swin_unet": (("swin_unet/art", 2, 1), SMALL, 32),
    "swin_unet-fused": (("swin_unet/art", 2, 1),
                        dict(SMALL, fused_block=True), 32),
    "cunet": (("cunet/art", 2, 1), {}, 48),
    "hat": (("hat/photo", 4, -1),
            dict(hat_arch={"embed_dim": 60, "depths": (2,),
                           "num_heads": 2}), 32),
    "dat": (("dat/photo", 4, -1),
            dict(dat_arch={"embed_dim": 96, "depths": (2,),
                           "num_heads": 6}), 32),
    "mambair": (("mambair/photo", 4, -1),
                dict(mambair_arch={"embed_dim": 60, "depths": (2,),
                                   "d_state": 4}), 32),
}


def _cache(module):
    """What the operand cache holds for ``module`` and its submodules, by
    (submodule name, dtype)."""
    return {(name, dt): hit[1] for name, m in module.named_modules()
            for dt, hit in vars(m).get("_operands", {}).items()}


def _same(cache, other):
    return cache.keys() == other.keys() and all(
        cache[k] is v for k, v in other.items())


def _model_builds_operands_once(model):
    (family, scale, noise), options, tile = CACHE_MODELS[model]
    module, spec = treg.create_model(family, scale, noise, **options)
    treg.load_into(module, _reseeded(module, 1))
    twin = (treg.packed_x_twin(module, spec)[0]
            if family == "swin_unet/art" else None)
    x = torch.rand(1, tile, tile, 3)
    with torch.inference_mode():
        module(x)
        built = _cache(module)
        module(x)
        if twin is not None:
            twin(x)
            assert _same(_cache(twin), built)  # shared
    assert built and _same(_cache(module), built)  # built once
    second = _reseeded(module, 2)
    treg.load_into(module, second)
    fresh, _ = treg.create_model(family, scale, noise, **options)
    treg.load_into(fresh, second)
    with torch.inference_mode():
        got, want = module(x), fresh(x)
        rebuilt = _cache(module)
        if twin is not None:
            twin(x)
            assert _same(_cache(twin), rebuilt)
    assert rebuilt.keys() == built.keys()
    assert not any(rebuilt[k] is v for k, v in built.items())  # rebuilt
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["swin_block", *CACHE_MODELS])
def test_block_builds_operands_once_and_rebuilds_after_load(model):
    if model != "swin_block":
        _model_builds_operands_once(model)
        return
    torch.manual_seed(0)
    block = SwinBlock(C, NH, shift=4, fused_block=True)
    fresh = SwinBlock(C, NH, shift=4, fused_block=True)
    with torch.no_grad():
        for p in fresh.parameters():
            p.normal_(0, 0.05)
    x = torch.rand(2, 16, 24, C)
    with torch.no_grad():
        block(x)
        ops = block.operands(torch.float32)
        block(x)
        assert block.operands(torch.float32) is ops  # cached
        ops16 = block.operands(torch.bfloat16)
        assert ops16 is not ops and ops16.dtype == torch.bfloat16
        block.load_state_dict(fresh.state_dict())
        assert block.operands(torch.float32) is not ops  # rebuilt
        assert torch.equal(block(x), fresh(x))
        assert torch.equal(block(x.bfloat16()), fresh(x.bfloat16()))


@pytest.mark.parametrize("packed", [False, True], ids=["pixel", "packed_x"])
def test_reload_matches_fresh_module(packed):
    """A module that ran (and cached its blocks' operands) with one set
    of weights, then got another through ``registry.load_into``, renders
    what a fresh module with the second set renders; the packed-x twin
    shares the blocks, so it sees the reload too."""
    module, spec = treg.create_model("swin_unet/art", 2, -1,
                                     fused_block=True, **SMALL)
    treg.load_into(module, _reseeded(module, 1))
    twin, _ = treg.packed_x_twin(module, spec)
    x = torch.rand(1, 32, 32, 3)
    with torch.inference_mode():
        before = (twin if packed else module)(x)
    second = _reseeded(module, 2)
    treg.load_into(module, second)
    fresh, fresh_spec = treg.create_model("swin_unet/art", 2, -1,
                                          fused_block=True, **SMALL)
    treg.load_into(fresh, second)
    if packed:
        fresh, _ = treg.packed_x_twin(fresh, fresh_spec)
    with torch.inference_mode():
        got = (twin if packed else module)(x)
        want = fresh(x)
    assert not torch.equal(got, before)
    assert torch.equal(got, want)
