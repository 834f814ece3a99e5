"""The device mesh of the sharded classifier and the sharded build.

Counterpart of ``bonsai_tpu/parallel/mesh.py`` (axes ``dp`` over reads,
``db`` over the database, ``sp`` over a contig's sequence).  JAX runs a
mesh as one program over its devices; here each mesh rank is a *rank*
with its own ``torch.device``, and the three collectives that the JAX
code uses under ``shard_map`` are methods of the mesh:

* ``all_to_all`` over ``db``: rank j of each dp row receives block j of
  every rank of the row, in rank order;
* ``psum`` over ``db`` or over every rank: a sum;
* ``ppermute`` over ``sp``: each rank's tensor to another rank.

A mesh runs its ranks in one of two ways, never both:

* in process (``make_mesh``): every rank in this process.  The device
  list may repeat a device, so that several ranks share one card or the
  CPU (the counterpart of the JAX suite's virtual CPU mesh); the
  collectives move tensors between the ranks' devices with copies on the
  devices (a repeated device: none), never through the host.
* one rank a process (``init_distributed`` then ``make_mesh`` with the
  world's size): the collectives are ``torch.distributed`` calls
  (``all_to_all_single`` on each dp row's ``db`` group, ``all_reduce``,
  ``batch_isend_irecv``), ``nccl`` on CUDA and ``gloo`` on the CPU.

Ranks are numbered row-major over the axes in their given order (rank r
of a {"dp": 2, "db": 3} mesh sits at dp r // 3, db r % 3), as the JAX
mesh's device array is.  A collective takes and returns ``{rank:
tensor}`` over the ranks this process holds (``local_ranks``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Axis sizes, each rank's device, and the process group when the
    ranks are processes."""

    def __init__(self, axis_sizes: Dict[str, int], devices: List[torch.device],
                 distributed: bool = False):
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(axis_sizes)
        self.size = int(np.prod(list(axis_sizes.values()), dtype=np.int64))
        self.devices = list(devices)  # every rank's device (in process)
        self.distributed = distributed
        if distributed:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            self.local_ranks = [self.rank]
            self.process_index = self.rank
            self.process_count = dist.get_world_size()
            self._groups = {}
            for axis in self.axis_names:  # every process makes every group
                for members in self._axis_groups(axis):
                    g = dist.new_group(members)
                    if self.rank in members:
                        self._groups[axis] = (g, members)
            self._world = dist.group.WORLD
        else:
            self.local_ranks = list(range(self.size))
            self.process_index = 0
            self.process_count = 1

    def device(self, r: int) -> torch.device:
        return self.devices[r]

    def coords(self, r: int) -> Dict[str, int]:
        """The axis coordinates of rank r."""
        idx = np.unravel_index(r, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def index(self, r: int, axis: str) -> int:
        return self.coords(r)[axis] if axis in self.shape else 0

    def _axis_groups(self, axis: str) -> List[List[int]]:
        """The ranks of each line of the mesh along ``axis``, in order."""
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        ax = self.axis_names.index(axis)
        lines = np.moveaxis(grid, ax, -1).reshape(-1, self.shape[axis])
        return [list(map(int, line)) for line in lines]

    # -- collectives ------------------------------------------------------
    def all_to_all(self, x: Dict[int, torch.Tensor],
                   axis: str = "db") -> Dict[int, torch.Tensor]:
        """Each rank's (n * cap,) tensor cut into n = shape[axis] blocks;
        rank j of a line receives block j of each rank of its line, in
        line order (``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``)."""
        n = self.shape[axis]
        if self.distributed:
            import torch.distributed as dist

            (r, t), = x.items()
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=self._groups[axis][0])
            return {r: out}
        out = {}
        for line in self._axis_groups(axis):
            blocks = [x[r].view(n, -1) for r in line]
            for j, r in enumerate(line):
                dev = self.device(r)
                out[r] = torch.cat([b[j].to(dev) for b in blocks])
        return out

    def psum(self, x: Dict[int, torch.Tensor],
             axes: Sequence[str] = ("db",)) -> Dict[int, torch.Tensor]:
        """The sum of each rank's tensor over the ranks that share its
        coordinates off ``axes`` (``jax.lax.psum(x, axes)``)."""
        axes = tuple(a for a in axes if a in self.shape)
        if self.distributed:
            import torch.distributed as dist

            (r, t), = x.items()
            t = t.clone()
            if len(axes) == len(self.shape):
                group = self._world
            elif len(axes) == 1:
                group = self._groups[axes[0]][0]
            else:
                raise ValueError(f"psum over {axes}: one axis or all")
            dist.all_reduce(t, group=group)
            return {r: t}
        sums = {}  # one sum for each set of ranks that share the rest
        for r in x:
            key = tuple(v for a, v in self.coords(r).items() if a not in axes)
            dev = self.device(r)
            if key not in sums:
                sums[key] = x[r].to(dev)
            else:
                sums[key] = sums[key] + x[r].to(sums[key].device)
        return {r: sums[tuple(v for a, v in self.coords(r).items()
                              if a not in axes)].to(self.device(r))
                for r in x}

    def ppermute(self, x: Dict[int, torch.Tensor], perm, axis: str = "sp"
                 ) -> Dict[int, torch.Tensor]:
        """Send each rank's tensor along ``axis`` by the pairs (source,
        destination) of line positions in ``perm``; a rank that receives
        nothing gets zeros (``jax.lax.ppermute``)."""
        if self.distributed:
            import torch.distributed as dist

            (r, t), = x.items()
            line = self._groups[axis][1]
            me = line.index(r)
            out = torch.zeros_like(t)
            ops = []
            for s, d in perm:
                if s == me:
                    ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                          line[d], self._groups[axis][0]))
                if d == me:
                    ops.append(dist.P2POp(dist.irecv, out, line[s],
                                          self._groups[axis][0]))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return {r: out}
        out = {r: torch.zeros_like(t) for r, t in x.items()}
        for line in self._axis_groups(axis):
            for s, d in perm:
                out[line[d]] = x[line[s]].to(self.device(line[d]))
        return out


def make_mesh(axis_sizes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``axis_sizes`` (ordered: the rank numbering is row-major
    over them).  In process, ``devices`` gives each rank's device (a
    device may repeat; default: every rank on the current card, which must
    be present: a caller that wants the CPU names it, ``["cpu"]``); once
    ``init_distributed`` has run with more than one process, the ranks
    are the processes, and ``devices`` (if given) is this process's one
    device (default: its card on the host, ``_local_card``)."""
    n = int(np.prod(list(axis_sizes.values()), dtype=np.int64))
    if _world_size() > 1:
        import torch.distributed as dist

        if n != dist.get_world_size():
            raise ValueError(
                f"mesh of {n} ranks over {dist.get_world_size()} processes: "
                "under torch.distributed each process is one rank (ranks in "
                "process and processes are not mixed)")
        if devices is not None and len(devices) != 1:
            raise ValueError("under torch.distributed a process holds one "
                             "rank: give its one device")
        dev = _norm(devices[0]) if devices is not None else _my_device()
        devs = [dev] * n  # only this rank's entry is used
        return Mesh(axis_sizes, devs, distributed=True)
    if devices is None:
        devices = ["cuda"]
    devs = [_norm(d) for d in devices]
    if len(devs) == 1:
        devs = devs * n
    if len(devs) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    return Mesh(axis_sizes, devs[:n])


def default_mesh(n_devices: Optional[int] = None, db_shards: int = 1,
                 device="cuda") -> Mesh:
    """The classifier's mesh of ``db_shards`` database ranks: on CUDA one
    rank a card (all ``torch.cuda.device_count()`` of them, dp = n /
    db_shards), with the JAX package's message where db_shards does not
    divide them; on the CPU ``db_shards`` ranks in this process (dp = 1:
    the output does not depend on the split).  Under torch.distributed,
    one rank a process over the world's size."""
    db_shards = max(int(db_shards), 1)
    if _world_size() > 1:
        import torch.distributed as dist

        n = n_devices or dist.get_world_size()
        if n % db_shards:
            raise ValueError(f"{n} devices not divisible by db_shards={db_shards}")
        dev = torch.device(device)
        return make_mesh({"dp": n // db_shards, "db": db_shards},
                         [_my_device() if dev.type == "cuda" else dev])
    dev = torch.device(device)
    if dev.type == "cuda":
        _cuda_present()
        n = n_devices or torch.cuda.device_count()
        if n % db_shards:
            raise ValueError(f"{n} devices not divisible by db_shards={db_shards}")
        return make_mesh({"dp": n // db_shards, "db": db_shards},
                         [torch.device("cuda", i) for i in range(n)])
    n = n_devices or db_shards
    if n % db_shards:
        raise ValueError(f"{n} devices not divisible by db_shards={db_shards}")
    return make_mesh({"dp": n // db_shards, "db": db_shards}, [dev])


def _cuda_present() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but CUDA is not "
                           "available")


def _norm(device) -> torch.device:
    """``device`` with the current card's index where CUDA names none."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        _cuda_present()
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _local_card(rank: int) -> int:
    """The card of the process of ``rank`` on its host: LOCAL_RANK where
    torchrun set it, else ``rank`` modulo the host's cards (a coordinator
    launch numbers a host's processes together)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def _my_device() -> torch.device:
    """This process's device under torch.distributed: its card on the
    host (``_local_card``), which must be present."""
    import torch.distributed as dist

    _cuda_present()
    return torch.device("cuda", _local_card(dist.get_rank()))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> int:
    """Join the process group (``init_distributed`` of the JAX package):
    at ``coordinator`` ("host:port", as ``init_method="tcp://host:port"``)
    with ``num_processes`` as the world size and ``process_id`` as this
    process's rank where they are given, else from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``nccl`` for
    ``device`` "cuda" (which must be present), ``gloo`` for "cpu".  One
    rank a process, on its host's card ``_local_card(rank)``.  Returns
    this process's rank; a second call only returns it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init = f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if v not in os.environ]
        if missing:
            raise RuntimeError(f"--distributed: {', '.join(missing)} not set "
                               "(launch with torchrun)")
        init = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None
                   else os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        _cuda_present()
        torch.cuda.set_device(_local_card(rank))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank)
    return dist.get_rank()
