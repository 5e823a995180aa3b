"""Traffic kind ``stream``: one video through ``Upscaler.open_stream``.

Mix parameters: ``frame_hw`` (the frames' (H, W)), ``pool`` (distinct
seeded frames, sent in turn), ``warm_frames`` (frames through the
stream before the window). One caller sends frames back to back
(closed loop) through ``submit`` and ``flush``; every output is fetched
to the host through ``engine.upscaler.fetch_async`` as the CLI's video
loop does: a submit's outputs are read after the next frame's work is
queued. The window ends when every output has reached the host and the
device has synchronized.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from benchmark_torch.lib.traffic import Item, Sample, stop
from benchmark_torch.lib.weights import generator, make_picture


class Traffic:
    def __init__(self, mix: dict, seed: int, device):
        self.mix = mix
        hw = tuple(mix["frame_hw"])
        self.sizes = [hw]
        g = generator(seed, 1, device)
        self.pictures = {(0, i): make_picture(hw, g, device)
                         for i in range(mix["pool"])}
        self._sent = 0

    def next_item(self) -> Item:
        i = self._sent % self.mix["pool"]
        self._sent += 1
        return Item((0, i), self.sizes[0])


def chunk_sizes(tiles, batch: int) -> list:
    """Full chunks over the concatenated tiles (the cross-frame carry),
    then the flush's one tail."""
    total = sum(tiles)
    return [batch] * (total // batch) + ([total % batch] if total % batch
                                         else [])


def warm(up, traffic: Traffic, fetch, sync) -> None:
    """The stream's own warm (every chunk split and flush tail, captured
    once), then ``warm_frames`` frames through a stream as the window
    sends them."""
    up.open_stream(traffic.sizes[0]).warm()
    drive(up, traffic, Sample(0, 0), 0,
          n_items=traffic.mix["warm_frames"], fetch=fetch, sync=sync)


def drive(up, traffic: Traffic, sample, seconds, n_items=None,
          span=contextlib.nullcontext, fetch=None, sync=lambda: None):
    """Frames through one stream until ``seconds`` pass (or ``n_items``
    frames); returns (items sent, items delivered, window seconds)."""
    hw = traffic.sizes[0]
    session = up.open_stream(hw)
    sent, done = [], []
    out_hw = (hw[0] * up.spec.scale, hw[1] * up.spec.scale, 3)

    def read(pairs):
        for item, h in pairs:
            with span("bench.fetch_wait"):
                a = np.asarray(h)
            if a.shape == out_hw and a.dtype == np.uint8:
                done.append(item)
                sample.offer(item, h)

    def fetched(outs):
        # outputs come back in submission order
        n = fetched.n
        fetched.n += len(outs)
        return [(it, fetch(o)) for it, o in zip(sent[n:n + len(outs)], outs)]

    fetched.n = 0
    t0 = time.perf_counter()
    ready = []
    while not stop(t0, seconds, len(sent), n_items):
        item = traffic.next_item()
        sent.append(item)
        with span("bench.submit"):
            outs = session.submit(traffic.pictures[item.key])
        prev, ready = ready, fetched(outs)
        read(prev)
    with span("bench.flush"):
        outs = session.flush()
    read(ready + fetched(outs))
    sync()
    return sent, done, time.perf_counter() - t0
