"""Kernel F (the int8/bf16 tensor-core probe) on the CPU against the JAX
probe's own Pallas kernel.

``probes/int8_pallas_probe.py`` measures at import (it calls
``bench._probe_devices`` and times every shape at module level), so it is
not imported: its ``_kernel`` and ``run`` are taken out of the file with
``ast`` and executed in a namespace whose ``pl.pallas_call`` runs in
interpret mode. On CPU tensors ``ops.mma_probe`` runs its plain twin.

Limits: int8 equal element for element. bf16: the products of bf16 values
are exact in float32, so the two sides differ only in the order of their
float32 sums; each sum is within K u sum_k |a_mk| |b_kn| of the exact one
(u = 2^-24, to first order), so they may differ by K 2^-23 max_mn
sum_k |a_mk| |b_kn| (``fp32_sum_bound``).
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from waifu2x_tensorrt_tpu_torch.ops.mma_probe import (
    fp32_sum_bound,
    mma_probe,
    mma_probe_plain,
)
from waifu2x_tensorrt_tpu_torch.probes import int8_probe

PROBE = Path(__file__).resolve().parents[1] / "probes" / "int8_pallas_probe.py"

# the probe's four shapes, M cut to 64-128, K and N as published
CUT_SHAPES = [(128, 1024, 512), (128, 96, 288), (64, 96, 384),
              (128, 384, 96)]


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The probe's ``run`` (and its ``_kernel``), with pallas_call in
    interpret mode."""
    tree = ast.parse(PROBE.read_text(), filename=str(PROBE))
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_kernel", "run")]
    assert [n.name for n in body] == ["_kernel", "run"]
    shim = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": shim,
          "pltpu": pltpu}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(PROBE), "exec"),
         ns)
    return ns["run"]


def _jax_probe(a, b, reps):
    """The JAX kernel on torch a (M, K) and b (K, N), its lhs stacked
    twice as the probe's time_call stacks it."""
    a_np, b_np = a.float().numpy(), b.float().numpy()
    if a.dtype == torch.int8:
        args = (jnp.asarray(a_np.astype(np.int8)),
                jnp.asarray(b_np.astype(np.int8)), jnp.int32)
    else:  # bf16 values, exact in float32
        args = (jnp.asarray(a_np).astype(jnp.bfloat16),
                jnp.asarray(b_np).astype(jnp.bfloat16), jnp.float32)
    out = _jax_run()(jnp.stack([args[0], args[0]]), args[1], args[2], reps)
    return np.asarray(out)


@pytest.mark.parametrize("reps", [1, 2, 3])
@pytest.mark.parametrize("m,k,n", CUT_SHAPES)
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_matches_pallas_interpret(dtype, m, k, n, reps):
    a8, b8, abf, bbf = int8_probe.make_inputs(
        m, k, n, np.random.default_rng(m + k + n + reps))
    a, b = (a8, b8) if dtype == "int8" else (abf, bbf)
    before = mma_probe.launches
    got = mma_probe(int8_probe.stack2(a), b, reps).numpy()
    assert mma_probe.launches == before  # CPU tensors: the plain twin
    want = _jax_probe(a, b, reps)
    assert got.shape == want.shape == (m, n)
    if dtype == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        tol = fp32_sum_bound(a, b)
        assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("reps", [0, 1, 2, 3, 5])
def test_int8_closed_form(reps):
    """acc >> 31 is 0 or -1, so for reps >= 2 the result is D - (D < 0)
    (D = a b exactly), for reps 1 it is D and for reps 0 zero; -128
    entries included."""
    rng = np.random.default_rng(reps)
    a = rng.integers(-128, 128, (64, 96), np.int8)
    b = rng.integers(-128, 128, (96, 32), np.int8)
    a[0] = -128
    b[:, 0] = -128
    d = a.astype(np.int64) @ b.astype(np.int64)
    want = {0: np.zeros_like(d), 1: d}.get(reps, d - (d < 0))
    got = mma_probe(int8_probe.stack2(torch.from_numpy(a)),
                    torch.from_numpy(b), reps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (d < 0).any() and (d > 0).any()


def test_bf16_closed_form_and_carry():
    """bf16: the result is the last product; a product that is not finite
    turns every later acc NaN through acc * 0, as in the JAX kernel."""
    _a8, _b8, a, b = int8_probe.make_inputs(32, 64, 32,
                                            np.random.default_rng(3))
    d = a.double() @ b.double()
    tol = fp32_sum_bound(a, b)
    for reps in (1, 2, 3):
        got = mma_probe(int8_probe.stack2(a), b, reps)
        assert (got.double() - d).abs().max().item() <= tol
    a = a.clone()
    a[5, 7] = float("inf")
    got1 = mma_probe(int8_probe.stack2(a), b, 1)
    got2 = mma_probe(int8_probe.stack2(a), b, 2)
    assert not torch.isfinite(got1[5]).any()
    assert torch.isnan(got2[5]).all()
    assert torch.isfinite(got2[torch.arange(32) != 5]).all()
    want = _jax_probe(a, b, 2)
    np.testing.assert_array_equal(np.isnan(got2.numpy()), np.isnan(want))
    rest = np.arange(32) != 5
    assert np.abs(got2.numpy()[rest] - want[rest]).max() <= tol


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_reads_the_first_copy_and_wrapper_equals_plain(dtype):
    """Every product is a2[0] @ b, whatever a2[1] holds (the kernel reads
    a2[0] only); the wrapper on CPU tensors returns exactly the plain
    twin's result."""
    a8, b8, abf, bbf = int8_probe.make_inputs(32, 32, 32,
                                              np.random.default_rng(4))
    a, b = (a8, b8) if dtype == "int8" else (abf, bbf)
    a2 = torch.stack([a, torch.flip(a, [0])])
    for reps in (1, 2, 3):
        got = mma_probe_plain(a2, b, reps)
        assert torch.equal(got, mma_probe_plain(int8_probe.stack2(a), b,
                                                reps))
        assert torch.equal(mma_probe(a2, b, reps), got)
    d0 = a8.double() @ b8.double()
    if dtype == "int8":
        assert torch.equal(got, (d0 - (d0 < 0).double()).to(torch.int32))


def test_make_inputs_follows_the_jax_probe():
    """The same numpy draws as the JAX probe's, and torch's bf16 rounding
    equals JAX's."""
    rng = np.random.default_rng(0)
    a8 = rng.integers(-127, 128, (64, 96), np.int8)
    b8 = rng.integers(-127, 128, (96, 32), np.int8)
    abf = jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32)
                      ).astype(jnp.bfloat16)
    bbf = jnp.asarray(rng.standard_normal((96, 32)).astype(np.float32)
                      ).astype(jnp.bfloat16)
    got = int8_probe.make_inputs(64, 96, 32, np.random.default_rng(0))
    assert got[0].dtype == torch.int8 and got[2].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].numpy(), a8)
    np.testing.assert_array_equal(got[1].numpy(), b8)
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  np.asarray(abf.astype(jnp.float32)))
    np.testing.assert_array_equal(got[3].float().numpy(),
                                  np.asarray(bbf.astype(jnp.float32)))


@pytest.mark.parametrize("a2,b,reps,err", [
    (torch.zeros(2, 32, 32, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.bfloat16), 1, TypeError),
    (torch.zeros(2, 32, 32), torch.zeros(32, 32), 1, TypeError),
    (torch.zeros(3, 32, 32, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.int8), 1, ValueError),
    (torch.zeros(2, 32, 64, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.int8), 1, ValueError),
    (torch.zeros(2, 48, 32, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.int8), 1, ValueError),
    (torch.zeros(2, 32, 1056, dtype=torch.bfloat16),
     torch.zeros(1056, 32, dtype=torch.bfloat16), 1, ValueError),
    (torch.zeros(2, 32, 32, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.int8), -1, ValueError),
    (torch.zeros(2, 32, 32, dtype=torch.int8),
     torch.zeros(32, 32, dtype=torch.int8), True, ValueError),
], ids=["mixed", "float32", "three-copies", "k-mismatch", "m-not-32",
        "k-too-wide", "negative-reps", "bool-reps"])
def test_wrapper_rejects(a2, b, reps, err):
    with pytest.raises(err):
        mma_probe(a2, b, reps)


def test_gate_and_rates():
    row = int8_probe.rates(2.0e12, 2.0, 1.0)
    assert row["speedup"] == 2.0 and row["int8_rate"] == 2.0e15
    assert row["bf16_peak_share"] == pytest.approx(1.0e15 / 989e12)
    rows = [dict(row, name=name) for name, *_ in int8_probe.SHAPES]
    assert int8_probe.gate(rows)
    rows[1]["speedup"] = 1.49  # the qkv shape misses
    assert not int8_probe.gate(rows)
    rows[1]["speedup"], rows[2]["speedup"] = 1.5, 1.0  # fc1 does not count
    assert int8_probe.gate(rows)


def test_probe_main_needs_a_gpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert int8_probe.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


# kernel F's CTA tile and shared-memory layout (csrc/mma_probe.cu,
# csrc/wgmma.cuh): 64 x 32 tiles, K-major operands in 128-byte-swizzled
# column blocks of 128 bytes of K; A in registers up to REG_A_KBYTES bytes
# of K a row
BM, BN = 64, 32
REG_A_KBYTES = 512


def _sw128_offset(row, kbyte, rows):
    """wgmma.cuh ``sw128_offset``: where the kernel stores (row, kbyte)."""
    return ((kbyte >> 7) * rows * 128 + row * 128
            + ((((kbyte >> 4) & 7) ^ (row & 7)) << 4) + (kbyte & 15))


def _wgmma_read(smem, base, rows, kb):
    """The operand (rows x kb bytes) that wgmma reads, k step by k step,
    through the descriptors of csrc/mma_probe.cu: step s starts at
    base + (s // 4) * rows * 128 + (s % 4) * 32; row r's 32 bytes lie at
    start + (r // 8) * 1024 (SBO) + (r % 8) * 128, and the hardware's
    128-byte swizzle XORs address bits 7-9 into bits 4-6."""
    out = np.zeros((rows, kb), np.uint8)
    r = np.arange(rows)[:, None]
    j = np.arange(32)[None, :]
    for s in range(kb // 32):
        start = base + (s // 4) * rows * 128 + (s % 4) * 32
        addr = start + (r // 8) * 1024 + (r % 8) * 128 + j
        out[:, 32 * s:32 * s + 32] = smem[addr ^ (((addr >> 7) & 7) << 4)]
    return out


def _fragment_map():
    """wgmma.cuh's m64n32 accumulator map: (thread, value) -> (row, col)."""
    t, i = np.meshgrid(np.arange(128), np.arange(BM * BN // 128),
                       indexing="ij")
    warp, g, q = t // 32, (t % 32) // 4, t % 4
    return 16 * warp + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * q + i % 2


def _register_a(slab_a):
    """A's register fragments (wgmma.cuh ``MmaRegA``): thread t (warp w,
    lane 4 g + q), k step s, register j holds the 4 bytes at 32 s +
    16 (j // 2) + 4 q of row 16 w + g + 8 (j % 2). Returns the 64 x kb
    operand they hold; each byte must be held exactly once."""
    kb = slab_a.shape[1]
    got = np.zeros_like(slab_a)
    held = np.zeros(slab_a.shape, np.int32)
    t, s, j, i = np.meshgrid(np.arange(128), np.arange(kb // 32),
                             np.arange(4), np.arange(4), indexing="ij")
    row = 16 * (t // 32) + (t % 32) // 4 + 8 * (j % 2)
    col = 32 * s + 16 * (j // 2) + 4 * (t % 4) + i
    got[row, col] = slab_a[row, col]
    np.add.at(held, (row.reshape(-1), col.reshape(-1)), 1)
    assert (held == 1).all()
    return got


def _tile_emulation(a, b, reps):
    """numpy replay of kernel F on a (M, K) and b (K, N), int8 or bf16 (as
    torch tensors): each 64 x 32 CTA tile stages its B^T slab, and its A
    slab (rows past M zero) unless A fits in registers, at the kernel's
    swizzled addresses, which must all differ; wgmma reads them back by
    the descriptors (A otherwise from its register fragments); the tile's
    product (exact, in float64) goes through the carry R times and out by
    the fragment map, which must cover the output exactly once."""
    m, k = a.shape
    n = b.shape[1]
    itemsize = a.element_size()
    raw_a = a.contiguous().view(torch.uint8).numpy().reshape(m, -1)
    raw_b = b.contiguous().view(torch.uint8).numpy().reshape(k, n, itemsize)
    kb = k * itemsize
    kpad = -(-kb // 128) * 128
    out = np.zeros((m, n), np.float64)
    hits = np.zeros((m, n), np.int32)
    rows, cols = _fragment_map()
    kbyte = np.arange(kb)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            smem = np.zeros((BM + BN) * kpad, np.uint8)
            owner = np.zeros(smem.shape, np.int32)
            slab_a = np.zeros((BM, kb), np.uint8)
            slab_a[:min(BM, m - m0)] = raw_a[m0:m0 + BM]
            addr = _sw128_offset(np.arange(BM)[:, None], kbyte[None, :], BM)
            smem[addr] = slab_a
            np.add.at(owner, addr.reshape(-1), 1)
            # B^T: (n, kbyte) holds byte kbyte % itemsize of b[kbyte // is, n]
            bt = raw_b[:, n0:n0 + BN].transpose(1, 0, 2).reshape(BN, kb)
            addr = BM * kpad + _sw128_offset(np.arange(BN)[:, None],
                                             kbyte[None, :], BN)
            smem[addr] = bt
            np.add.at(owner, addr.reshape(-1), 1)
            assert owner.max() == 1 and owner.sum() == (BM + BN) * kb
            ra = (_register_a(slab_a) if kb <= REG_A_KBYTES
                  else _wgmma_read(smem, 0, BM, kb))
            rb = _wgmma_read(smem, BM * kpad, BN, kb)
            assert np.array_equal(ra, slab_a) and np.array_equal(rb, bt)
            to = torch.int8 if itemsize == 1 else torch.bfloat16
            ta = torch.from_numpy(ra.copy()).view(to).double().numpy()
            tb = torch.from_numpy(rb.copy()).view(to).double().numpy()
            d = ta @ tb.T  # the tile's product, exact in float64
            acc = np.zeros_like(d)
            for _ in range(reps):
                acc = (d + np.floor(acc / 2.0 ** 31) if itemsize == 1
                       else d + acc * 0)
            keep = m0 + rows < m
            out[m0 + rows[keep], n0 + cols[keep]] = acc[rows[keep],
                                                        cols[keep]]
            np.add.at(hits, (m0 + rows[keep], n0 + cols[keep]), 1)
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (64, 96, 96), (96, 160, 64),
                                   (128, 64, 96), (32, 96, 64),
                                   (64, 320, 32), (32, 640, 64)])
def test_kernel_layout_and_fragments_match_plain(dtype, m, k, n):
    """Kernel F's shared-memory layout, descriptor reads, register
    fragments of A and accumulator map, replayed in numpy
    (``_tile_emulation``), give the plain twin's result: int8 equal, bf16
    within ``fp32_sum_bound`` (the replay sums exactly); M = 32 leaves half
    a tile of zero rows, K 160 in int8 steps across a 128-byte column
    block, and K 320 and 640 in bf16 (640 in int8) put A in shared
    memory."""
    a8, b8, abf, bbf = int8_probe.make_inputs(m, k, n,
                                              np.random.default_rng(m + k))
    a, b = (a8, b8) if dtype == "int8" else (abf, bbf)
    for reps in (1, 3):
        got = _tile_emulation(a, b, reps)
        want = mma_probe_plain(int8_probe.stack2(a), b, reps).double().numpy()
        if dtype == "int8":
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= fp32_sum_bound(a, b)
