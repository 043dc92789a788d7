"""Random draws of a batch sharded over ranks.

A training step draws t, the noise z and the dropout masks from the state's
generator, one row a sample. Where the batch is split over ranks, each rank
draws the rows of the **global** batch from the same generator, seeded alike
on every rank, and keeps its own slice: an N-rank step then draws what the
1-rank step draws on the same global batch, and every rank's generator
stays in step. ``BatchRows`` carries a generator with this rank's place in
the global batch; ``draw_rows`` is the draw that honours it (a plain
``torch.Generator`` or None draws as before).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """``generator`` drawing for rows [start, start + rows) of a global
    batch of ``total`` rows."""

    generator: torch.Generator
    start: int
    total: int


def draw_rows(fn, shape, generator, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=..., **kwargs)``; with ``BatchRows`` the global
    batch's draw ``(total, *shape[1:])`` sliced to this rank's rows."""
    if not isinstance(generator, BatchRows):
        return fn(tuple(shape), generator=generator, **kwargs)
    full = fn((generator.total, *shape[1:]), generator=generator.generator, **kwargs)
    return full[generator.start:generator.start + shape[0]]
