"""Faults planted in the program's timed path, which the check has to catch.

    with faults.plant("half_batch"):
        harness.run_cell(...)

- ``half_batch``: the second half of every model chunk's output left out
  (zeros);
- ``tile_altered``: the first tile of every chunk scaled by a half where
  the model makes it;
- ``unchanged``: the model returns its input, upscaled by repetition,
  in place of its output;
- ``answer_altered``: one byte of every frame's answer flipped where
  kernel C's finalize makes it.

Each wraps a function of ``waifu2x_tensorrt_tpu_torch.engine.renderer``
(``ChunkedPipeline.run_model``, ``make_finalize_epilogue``) for the time
of the ``with`` block; plant before the run loads the program.
"""

from __future__ import annotations

import contextlib


def _half_batch(run_model):
    def broken(self, tiles, use_pack_x=False):
        out = run_model(self, tiles, use_pack_x).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return broken


def _tile_altered(run_model):
    def broken(self, tiles, use_pack_x=False):
        out = run_model(self, tiles, use_pack_x).clone()
        out[0] = (out[0].float() * 0.5).to(out.dtype)
        return out
    return broken


def _unchanged(run_model):
    def broken(self, tiles, use_pack_x=False):
        out = run_model(self, tiles, use_pack_x)
        s = self.config.scaling
        x = tiles.repeat_interleave(s, 1).repeat_interleave(s, 2)
        o = (x.shape[1] - out.shape[1]) // 2
        return x[:, o:o + out.shape[1],
                 o:o + out.shape[2]].to(out.dtype).contiguous()
    return broken


def _answer_altered(make_fin):
    def broken(plan, device):
        fin = make_fin(plan, device)

        def finalize(*outs):
            out = fin(*outs).clone()
            out[0, 0, 0] ^= 128
            return out
        return finalize
    return broken


FAULTS = {"half_batch": ("run_model", _half_batch),
          "tile_altered": ("run_model", _tile_altered),
          "unchanged": ("run_model", _unchanged),
          "answer_altered": ("make_finalize_epilogue", _answer_altered)}


@contextlib.contextmanager
def plant(name: str):
    from waifu2x_tensorrt_tpu_torch.engine import renderer

    attr, wrap = FAULTS[name]
    owner = renderer.ChunkedPipeline if attr == "run_model" else renderer
    original = getattr(owner, attr)
    setattr(owner, attr, wrap(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)
