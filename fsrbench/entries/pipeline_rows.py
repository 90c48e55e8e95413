"""Entry ``pipeline_rows``: ``UpscalePipeline(mesh=)`` over ``strips`` cards,
captured once per card (``parallel.spatial.CapturedSpatial.from_pipeline``).
Each frame's rows are split over the cards; a producer writes each call's
strips where they lie, into the graphs' ``inputs`` after ``writable()``,
from a ring of batches per card; a kept call's outputs are cloned on their
cards' streams before the next call overwrites them."""

from __future__ import annotations

import torch

from fsrbench.drive import call_options, frames


class Entry:
    def __init__(self, cfg, traffic, seed, devices):
        from fsr_tpu_torch import UpscalePipeline
        from fsr_tpu_torch.parallel.sharding import Sharded, make_mesh
        from fsr_tpu_torch.parallel.spatial import CapturedSpatial

        n = traffic["strips"]
        self.devices = devices[:n]
        self.full = frames(cfg, traffic, seed, devices[0])
        h = cfg["in_size"][0] // n
        # Each card's strips contiguous on it, as a decoder hands them over,
        # so that every card's producer write is the same plain copy.
        self.ring = [[f[..., k * h:(k + 1) * h, :].contiguous().to(d) for k, d in enumerate(self.devices)]
                     for f in self.full]
        mesh = make_mesh(n, axis_names=("sp",), devices=self.devices)
        pipe = UpscalePipeline(out_size=tuple(cfg["out_size"]), mesh=mesh, **call_options(cfg))
        spec = (None,) * (self.full[0].dim() - 2) + ("sp", None)
        example = Sharded(mesh, spec, tuple(self.ring[0]), tuple(self.full[0].shape), self.full[0].dtype)
        self.cap = CapturedSpatial.from_pipeline(pipe, example)

    def produce(self, i: int) -> None:
        ins = self.cap.writable()
        for dst, src in zip(ins.shards, self.ring[i % len(self.ring)]):
            dst.copy_(src)

    def call(self, i: int):
        return self.cap(self.cap.inputs, frame=0)

    def keep(self, i: int, out) -> tuple:
        return i, [s.clone() for s in out.shards]

    def release(self) -> None:
        """Free the captured graphs and their buffers."""
        del self.cap

    def pairs(self, kept):
        for i, shards in kept:
            out = torch.cat([s.to(self.devices[0]) for s in shards], dim=-2)
            for b in range(out.shape[0]):
                yield out[b], {"src": self.full[i % len(self.full)][b]}
