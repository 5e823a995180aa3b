"""What every traffic kind shares, and the lookup of a kind by name.

A traffic mix is a data file, ``traffic/<mix>.json``, whose ``kind``
names the module that generates and drives it, ``traffic/<kind>.py``.
A kind module holds everything specific to its traffic:

- ``Traffic(mix, seed, device)``: the inputs made from the seed
  (``sizes``, ``pictures`` keyed by (size class, index)) and
  ``next_item()``, the next ``Item`` to send;
- ``warm(up, traffic, fetch, sync)``: every shape the window meets, run
  once before the window;
- ``drive(up, traffic, sample, seconds, n_items=None, span=..., fetch=...,
  sync=...)``: the closed loop of the window, which returns (items sent,
  items delivered, window seconds);
- ``chunk_sizes(tiles, batch)``: the model chunks that items of
  ``tiles`` tiles each make, for the benchmark's own account of the work.

Every mix also gives ``trace_items``, the fixed number of items of a
traced window, and ``sample``, how many outputs of each size class are
kept for the comparison, drawn from the seed.
"""

from __future__ import annotations

import importlib
import random
import time


def kind(mix: dict):
    """The module of the mix's traffic kind, ``traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark_torch.traffic.{mix['kind']}")


class Item:
    """One frame or picture sent: its input key (size class, index) and
    size. A kind may set on it what its own metrics read, such as a
    latency."""

    def __init__(self, key, hw):
        self.key = key
        self.hw = tuple(hw)


class Sample:
    """A reservoir of ``k`` outputs per size class, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self._rng = random.Random(int(seed) + 7)
        self._seen: dict = {}
        self.kept: dict = {}

    def offer(self, item: Item, out) -> None:
        c = item.key[0]
        n = self._seen.get(c, 0)
        self._seen[c] = n + 1
        slot = self.kept.setdefault(c, [])
        if n < self.k:
            slot.append((item, out))
        else:
            j = self._rng.randrange(n + 1)
            if j < self.k:
                slot[j] = (item, out)

    def items(self):
        return [pair for slot in self.kept.values() for pair in slot]


def stop(t0, seconds, n, n_items) -> bool:
    """Whether a window that started at ``t0`` and has sent ``n`` items
    is over: after ``n_items`` items where that is given, else once
    ``seconds`` have passed and one item was sent."""
    if n_items is not None:
        return n >= n_items
    return n > 0 and time.perf_counter() - t0 >= seconds
