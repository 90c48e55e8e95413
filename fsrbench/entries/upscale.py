"""Entry ``upscale``: ``fsr_tpu_torch.upscale`` on one card, a batch per call,
read in turn from a ring of batches resident on the card."""

from __future__ import annotations

from typing import Iterator, Tuple

from fsrbench.drive import call_options, frames


class Entry:
    def __init__(self, cfg, traffic, seed, devices):
        import fsr_tpu_torch

        self.devices = devices[:1]
        self.ring = frames(cfg, traffic, seed, devices[0])
        self.kw = call_options(cfg)
        self.kw["preset"] = cfg["preset"]
        self.api = fsr_tpu_torch

    def produce(self, i: int) -> None:
        pass

    def call(self, i: int):
        return self.api.upscale(self.ring[i % len(self.ring)], **self.kw)

    def keep(self, i: int, out) -> tuple:
        return i, out

    def release(self) -> None:
        """Nothing of the program's outlives its calls here."""

    def pairs(self, kept) -> Iterator[Tuple[object, dict]]:
        """(program output, its inputs) of every kept frame."""
        for i, out in kept:
            for b in range(out.shape[0]):
                yield out[b], {"src": self.ring[i % len(self.ring)][b]}
