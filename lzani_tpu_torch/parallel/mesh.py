"""Several devices on one query batch: each reference's batch split over
a mesh of devices.

Counterpart of ``lzani_tpu/parallel/mesh.py``. There, the index is
replicated over a ``jax.sharding.Mesh`` and the padded batch is sharded
over its ``pairs`` axis inside one jit. Here a mesh is a tuple of
``torch.device`` entries (a device may repeat), and the split is the
automaton backend's own (``engine_jax.parse_split``): each distinct
device keeps one copy of the reference index, the batch is cut into
contiguous shards, one per entry, and every shard's parse and fold
launches go out before any result is read back, so distinct cards work
at once. ``all2all_sharded`` is ``all2all_jax`` over the mesh.

The JAX step also all-reduces the triples into totals over the mesh; its
only caller throws them away, so that reduction is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.engine_jax import RefIndexJax, all2all_jax, parse_split


def make_mesh(devices=None) -> tuple:
    """The mesh's devices: `devices` as ``torch.device`` entries, or by
    default every visible CUDA device. Raises when there is none."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device (give the mesh's "
                               "devices to run elsewhere)")
        return tuple(torch.device("cuda", i) for i in range(n))
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: an empty device list")
    return mesh


class ShardedRefIndex:
    """One reference's index on every device of `mesh` and the batch parse
    split over the mesh's entries."""

    def __init__(self, codes: np.ndarray, params, mesh):
        self.mesh = make_mesh(mesh)
        self.index = {d: RefIndexJax(codes, params, d)
                      for d in dict.fromkeys(self.mesh)}

    def parse_batch(self, qcodes: list, params) -> np.ndarray:
        """Triples (len(qcodes), 3) int32; raises on a rejected log. The
        batch is padded with empty queries to a multiple of the mesh size,
        as the JAX step pads it, and the padding lanes are dropped."""
        B = -(-len(qcodes) // len(self.mesh)) * len(self.mesh)
        lanes = list(qcodes) + [np.zeros(0, np.uint8)] * (B - len(qcodes))
        res = parse_split(self.index, self.mesh, B,
                          lambda idx, lo, hi: idx.index.batch_args(
                              lanes[lo:hi]), lanes.__getitem__)
        if len(res.mismatched):
            raise RuntimeError(f"fold_stats rejected the event logs of "
                               f"queries {res.mismatched.tolist()}")
        return res.stats[:len(qcodes)]


def all2all_sharded(codes: list, params, mesh=None, filter_csr=None,
                    batch_size: int = 1024, stats: dict | None = None
                    ) -> np.ndarray:
    """Mesh-parallel all-vs-all: ``all2all_jax`` with each batch split
    over the mesh's entries; output layout matches
    ``native_engine.all2all``, `stats` as ``all2all_jax``'s."""
    return all2all_jax(codes, params, filter_csr=filter_csr,
                       batch_size=batch_size, device=list(make_mesh(mesh)),
                       stats=stats)
