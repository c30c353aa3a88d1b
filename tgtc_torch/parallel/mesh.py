"""Data parallelism over processes — port of tgtc/parallel/mesh.py.

The JAX package builds one mesh with a single ``data`` axis: parameters are
replicated, every batch axis is sharded, and XLA inserts the gradient psum
because the loss averages over the sharded axis. The port's counterpart is
:class:`DataGroup`, which each step takes:

* every process draws the **global** batch from the same generator and
  keeps its contiguous rows (:meth:`DataGroup.rows`): rank r holds rows
  ``r·B/W … (r+1)·B/W``, the block ``P("data")`` places on process r, and a
  batch that W does not divide raises, as the mesh refuses one (so there is
  no counterpart of ``pad_to_multiple``);
* after the backward, :meth:`DataGroup.all_reduce_mean_` makes one
  all-reduce of the flattened gradients and divides by W;
* :meth:`DataGroup.broadcast_` gives every rank rank 0's parameters once;
* :meth:`DataGroup.mean_scalars` averages logged metrics, at log steps only.

``DataGroup()`` (no process group) is the 1-process group: every method is
the identity and no collective runs. :meth:`DataGroup.world_group` is the
group of every process. The collectives use all-reduce and broadcast only, which
gloo also takes for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """A process group with this process's rank and the group's size.
    ``pg`` None runs no collective: the 1-process group, or (with ``rank``
    and ``world`` given) one rank's view of a split, whose collectives
    raise."""

    pg: Any = None
    rank: int = 0
    world: int = 1

    @classmethod
    def world_group(cls) -> "DataGroup":
        """Every process of the initialized default group."""
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "tgtc_torch.parallel.maybe_initialize_distributed first")
        return cls(dist.group.WORLD, dist.get_rank(), dist.get_world_size())

    @property
    def active(self) -> bool:
        """Whether collectives run (a process group is attached)."""
        return self.pg is not None

    def local_size(self, n: int) -> int:
        """Rows of an ``n``-row global batch this rank holds."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split over {self.world} processes")
        return n // self.world

    def row_offset(self, n: int) -> int:
        """The global index of this rank's first row of an ``n``-row batch."""
        return self.rank * self.local_size(n)

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's contiguous rows of a global batch (None stays None)."""
        if x is None or self.world == 1:
            return x
        b = self.local_size(x.shape[0])
        return x[self.rank * b: (self.rank + 1) * b]

    def _pg(self):
        if self.pg is None:
            raise RuntimeError(f"a {self.world}-process view without a process group runs no "
                               "collective")
        return self.pg

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (a new tensor; ``x`` itself when no
        collective runs)."""
        if not self.active and self.world == 1:
            return x
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self._pg())
        return out

    def all_reduce_mean_(self, tensors: Sequence[Optional[torch.Tensor]]
                         ) -> List[Optional[torch.Tensor]]:
        """Average ``tensors`` over the ranks in place: one flat buffer and
        one all-reduce per dtype (one in all for a uniform list). None
        entries are skipped. Returns the list."""
        tensors = list(tensors)
        if not self.active and self.world == 1:
            return tensors
        pg = self._pg()
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            if t is not None:
                by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=pg)
            flat.div_(self.world)
            i = 0
            for t in group:
                t.copy_(flat[i: i + t.numel()].view_as(t))
                i += t.numel()
        return tensors

    def mean_scalars(self, scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One-element tensors averaged over the ranks (f32, one all-reduce)."""
        if not self.active and self.world == 1:
            return dict(scalars)
        keys = list(scalars)
        flat = torch.stack([scalars[k].detach().float().reshape(()) for k in keys])
        self.all_reduce_mean_([flat])
        return dict(zip(keys, flat.unbind(0)))

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` (parameters, buffers) on every rank with
        rank ``src``'s, in one broadcast per dtype."""
        if not self.active and self.world == 1:
            return
        pg = self._pg()
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in group])
                dist.broadcast(flat, src=dist.get_global_rank(pg, src), group=pg)
                i = 0
                for t in group:
                    t.copy_(flat[i: i + t.numel()].view_as(t))
                    i += t.numel()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of which ``x`` is this rank's rows, on every rank
        (an all-reduce of zero-padded blocks, which every backend takes)."""
        if not self.active and self.world == 1:
            return x
        b = x.shape[0]
        out = x.new_zeros((b * self.world, *x.shape[1:]))
        out[self.rank * b: (self.rank + 1) * b] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self._pg())
        return out

    def barrier(self) -> None:
        if self.active:
            dist.barrier(group=self.pg)
