"""A mesh of torch devices, sharded tensors, and the collectives among them.

The counterpart of ``bitnuc_tpu/parallel/mesh.py``. The JAX package is
single-controller: one process holds the global batch, a ``jax.sharding.Mesh``
names the devices, and XLA inserts the collectives. Here a mesh is an array
of ``torch.device``s in one process, a sharded tensor is a list of
per-shard tensors in mesh order (``Sharded``), and the collectives are
explicit copies and reductions among them (``psum``, ``pmax``,
``all_gather``, ``ppermute``). Axis convention, as in the JAX package:

  * "data"  — batch of reads: each device owns a slab of reads
  * "seq"   — words of one long sequence: halo exchange for windows that
              cross shard edges (see parallel/kmer.py)

A device may repeat: ``make_mesh((8,), devices=[torch.device("cpu")] * 8)``
holds eight CPU shards (the counterpart of the JAX tests' forced host
device count), and ``[torch.device("cuda:0")] * 4`` four shards on one
card. Per-shard work runs through the port's dispatching functions, so
CUDA shards launch the kernels and CPU shards run the plain versions; the
shards are visited in turn and nothing is read back between them.

When ``runtime.initialize`` has joined more than one process, ``psum``,
``pmax`` and ``all_gather`` also cross the process group after their local
step (``torch.distributed``); ``ppermute`` stays within the process.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sequence import PackedReads


class Mesh:
    """devices: an ndarray of ``torch.device`` of the mesh's shape;
    axis_names: one name an axis; shape: {axis name: size}, so
    ``mesh.shape[axis]`` reads as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of rank {devices.ndim} needs as many axis names, got {axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> List[torch.device]:
        """The devices in mesh order (row-major over the axes)."""
        return list(self.devices.reshape(-1))

    def axis_dim(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return self.axis_names.index(axis)

    def groups(self, axis: str) -> List[List[int]]:
        """Flat shard positions of each group along ``axis``: one list per
        index of the other axes, in mesh order along ``axis``."""
        idx = np.arange(self.size).reshape(self.devices.shape)
        moved = np.moveaxis(idx, self.axis_dim(axis), -1)
        return [list(map(int, g)) for g in moved.reshape(-1, self.shape[axis])]

    def axis_index(self, axis: str) -> List[int]:
        """Each shard's index along ``axis``, in flat mesh order."""
        idx = np.indices(self.devices.shape)[self.axis_dim(axis)]
        return [int(i) for i in idx.reshape(-1)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat_devices]})"


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh spans the visible CUDA devices unless `devices` "
            "names others (devices=[torch.device('cpu')] * n holds n CPU shards)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Mesh over ``devices`` (default: every visible CUDA device; without
    CUDA this raises). Default shape: a 1-D mesh over all of them. The
    product of the shape must equal the number of devices."""
    devices = _visible_devices() if devices is None else [torch.device(d) for d in devices]
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {int(np.prod(shape))} devices, got {len(devices)}"
        )
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)


def on_device(device: torch.device):
    """A context that makes ``device`` the current CUDA device (kernels
    launch on the current device's stream); a no-op for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# -- sharded tensors ---------------------------------------------------------------


class Sharded:
    """A tensor split along ``dim`` over one mesh axis: ``shards[i]`` lives
    on the mesh's i-th device (flat order) and holds the slab of that
    device's index along ``axis`` (devices along other axes hold copies).

    ``shape`` and ``dtype`` are the whole's; ``full()`` concatenates the
    slabs on the first device, and ``np.asarray`` of it gives the whole on
    the host."""

    def __init__(self, shards: List[torch.Tensor], mesh: Mesh, axis: str, dim: int = 0):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} devices")
        self.shards = list(shards)
        self.mesh = mesh
        self.axis = axis
        self.dim = dim

    def slabs(self) -> List[torch.Tensor]:
        """One shard per index along the axis, in order."""
        return [self.shards[g] for g in self.mesh.groups(self.axis)[0]]

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.dim] = sum(int(t.shape[self.dim]) for t in self.slabs())
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def full(self) -> torch.Tensor:
        """The whole tensor on the first device."""
        dev = self.shards[0].device
        return torch.cat([t.to(dev) for t in self.slabs()], self.dim)

    def __array__(self, dtype=None, copy=None):
        a = self.full().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, axis={self.axis!r}, "
                f"dim={self.dim}, shards={len(self.shards)})")


def split(x, mesh: Mesh, axis: str, dim: int = 0) -> List[torch.Tensor]:
    """Per-device shards of ``x`` split along ``dim`` over ``axis`` (flat
    mesh order, copies along the other axes): a ``Sharded`` of this mesh
    and axis gives its own shards; a tensor or array is cut into equal
    slabs, each moved to its device. The size along ``dim`` must divide."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.axis == axis and x.dim == dim:
            return x.shards
        x = x.full()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    n = mesh.shape[axis]
    size = int(x.shape[dim])
    if size % n:
        raise ValueError(f"mesh axis {axis!r} of size {n} must divide {size} (dim {dim})")
    slabs = torch.chunk(x, n, dim) if size else [x] * n
    pos = mesh.axis_index(axis)
    return [slabs[p].to(d) for p, d in zip(pos, mesh.flat_devices)]


def replicate(x, mesh: Mesh) -> List[torch.Tensor]:
    """One copy of ``x`` on each device of the mesh, in mesh order (a
    device that repeats shares one copy)."""
    if isinstance(x, Sharded):
        x = x.full()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    copies = {}
    out = []
    for d in mesh.flat_devices:
        if d not in copies:
            copies[d] = x.to(d)
        out.append(copies[d])
    return out


class ShardedReads:
    """A read batch sharded over a mesh axis: ``word_shards[i]`` and
    ``length_shards[i]`` on the mesh's i-th device. ``words``, ``lengths``
    and ``batch_size`` describe the padded whole."""

    def __init__(self, word_shards, length_shards, mesh: Mesh, axis: str):
        self.word_shards = list(word_shards)
        self.length_shards = list(length_shards)
        self.mesh = mesh
        self.axis = axis

    @property
    def words(self) -> Sharded:
        return Sharded(self.word_shards, self.mesh, self.axis, 0)

    @property
    def lengths(self) -> Sharded:
        return Sharded(self.length_shards, self.mesh, self.axis, 0)

    @property
    def batch_size(self) -> int:
        return int(self.words.shape[0])

    def __len__(self) -> int:
        return self.batch_size


def pad_batch(reads: PackedReads, multiple: int) -> PackedReads:
    """Zero-pad the batch so its size divides the mesh axis. Padded reads have
    length 0, so every op treats them as empty."""
    B = reads.batch_size
    rem = (-B) % multiple
    if rem == 0:
        return reads
    words = torch.nn.functional.pad(reads.words, (0, 0, 0, rem))
    lengths = torch.nn.functional.pad(reads.lengths, (0, rem))
    return PackedReads(words=words, lengths=lengths)


def shard_reads(reads, mesh: Mesh, axis: str = "data") -> ShardedReads:
    """A read batch padded to a multiple of the axis size (``pad_batch``)
    and split over it: each device gets its slab of words and lengths."""
    if isinstance(reads, ShardedReads) and reads.mesh is mesh and reads.axis == axis:
        return reads
    reads = pad_batch(reads, int(mesh.shape[axis]))
    return ShardedReads(split(reads.words, mesh, axis), split(reads.lengths, mesh, axis),
                        mesh, axis)


def pad_rows(x, rows: int):
    """``x`` ([B, ...] tensor or array) zero-padded to ``rows`` rows."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    extra = rows - int(x.shape[0])
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])


# -- collectives -------------------------------------------------------------------


def _dist_group() -> bool:
    """True when more than one process has joined the process group."""
    from . import runtime

    return runtime.is_initialized() and runtime.world_size() > 1


def _cross_process_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    from . import runtime

    buf = runtime.collective_tensor(t)
    ops = {"sum": torch.distributed.ReduceOp.SUM, "max": torch.distributed.ReduceOp.MAX}
    torch.distributed.all_reduce(buf, op=ops[op])
    return buf.to(t.device)


def _reduce(shards: List[torch.Tensor], mesh: Mesh, axis: str, combine, op: str
            ) -> List[torch.Tensor]:
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for group in mesh.groups(axis):
        root = shards[group[0]].device
        acc = shards[group[0]].clone()
        for g in group[1:]:
            acc = combine(acc, shards[g].to(root))
        if _dist_group():
            acc = _cross_process_reduce(acc, op)
        copies = {root: acc}
        for g in group:
            d = shards[g].device
            if d not in copies:
                copies[d] = acc.to(d)
            out[g] = copies[d]
    return out


def psum(shards: List[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Sum of the shards of each group along ``axis``, in their dtype: added
    on the group's first device, then copied back to each device."""
    return _reduce(shards, mesh, axis, torch.add, "sum")


def pmax(shards: List[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Elementwise maximum of the shards of each group along ``axis``."""
    return _reduce(shards, mesh, axis, torch.maximum, "max")


def all_gather(shards: List[torch.Tensor], mesh: Mesh, axis: str, dim: int = 0
               ) -> List[torch.Tensor]:
    """The shards of each group along ``axis`` concatenated along ``dim`` in
    mesh order, on each device of the group (across processes: in rank
    order after the local step; every process's shards must match in
    shape)."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for group in mesh.groups(axis):
        root = shards[group[0]].device
        cat = torch.cat([shards[g].to(root) for g in group], dim)
        if _dist_group():
            from . import runtime

            buf = runtime.collective_tensor(cat)
            parts = [torch.empty_like(buf) for _ in range(runtime.world_size())]
            torch.distributed.all_gather(parts, buf)
            cat = torch.cat([p.to(root) for p in parts], dim)
        copies = {root: cat}
        for g in group:
            d = shards[g].device
            if d not in copies:
                copies[d] = cat.to(d)
            out[g] = copies[d]
    return out


def ppermute(shards: List[torch.Tensor], mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Within each group along ``axis``: the shard at index src moves to
    index dst's device for each (src, dst) of ``perm``; an index that
    receives nothing gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for group in mesh.groups(axis):
        got = {dst: src for src, dst in perm}
        for i, g in enumerate(group):
            d = shards[g].device
            out[g] = (shards[group[got[i]]].to(d) if i in got
                      else torch.zeros_like(shards[g]))
    return out
