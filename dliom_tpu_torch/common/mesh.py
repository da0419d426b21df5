"""A mesh of devices, the port's counterpart of the JAX package's
`jax.sharding.Mesh` with one axis (dliom_tpu/parallel/batch.py:367-393).

One process drives every device of the mesh, as one JAX controller does.
A `Mesh` is an ordered tuple of `torch.device`s and one axis name; shard k
of anything sharded over it lives on `devices[k]`. A mesh may name one
device more than once (four shards on `cuda:0`, or four on `cpu`): the
sharded code then runs its shards one after another on that device. That
is the caller's choice, never a fallback: `make_mesh` takes distinct cards
and raises when there are too few.

`shard_over_mesh` splits the leading (lane) axis of every tensor of a tree
into D contiguous pieces, lane-major as JAX's `PartitionSpec(axis)` lays
it out, each piece a copy on its shard's device; `gather` concatenates the
pieces of per-shard trees on one device, in shard order, as the JAX
package's global arrays read.

Cross-device sums go onto the mesh's first device: each partial is copied
there (`to_first`) and the sum's body adds them in shard order, so a mesh
that repeats one device adds in the same order as one of distinct cards.
Eager copies (`to_each`, `to_first`) make new tensors, which PyTorch
orders against both devices' current streams. Compiled programs copy into
static tensors between their replays (`copy_out`, `copy_in`), ordered by
CUDA events on the calling thread's current stream of each device.
Nothing here synchronizes a device or waits on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def indexed(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis (the name is what
    the JAX package's sharding specs read; here the errors of a lane count
    that does not divide over the axis name it)."""

    devices: Tuple[torch.device, ...]
    axis: str = "seq"

    def __post_init__(self):
        devices = tuple(indexed(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """The number of shards, D."""
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device that reductions land on."""
        return self.devices[0]

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    def __str__(self) -> str:
        return f"Mesh({self.axis}: {', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "seq", device: str = "cuda") -> Mesh:
    """A mesh over the first `n_devices` distinct devices of type `device`
    (all of them by default). Raises when fewer are present. The CPU is
    one device: a mesh of several CPU shards is made as `Mesh((cpu,) * n)`."""
    kind = torch.device(device).type
    if kind == "cuda":
        avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        avail = [torch.device("cpu")]
    else:
        raise ValueError(f"make_mesh: unsupported device type {kind!r}")
    devices = avail[: n_devices or len(avail)]
    if not devices or (n_devices and len(devices) < n_devices):
        raise RuntimeError(f"requested {n_devices or 'all'} {kind} devices, have {len(avail)} "
                           "(a mesh that repeats a device is made as Mesh((device,) * n))")
    return Mesh(tuple(devices), axis)


def split_sizes(n: int, mesh: Mesh) -> List[int]:
    """Lengths of the D contiguous pieces of a leading axis of n, as JAX
    lays out an axis it pads to a multiple of D: ceil(n / D) each, the last
    shards shorter or empty."""
    per = -(-n // mesh.size)
    return [max(0, min(per, n - k * per)) for k in range(mesh.size)]


def shard_over_mesh(tree, mesh: Mesh) -> list:
    """Per-shard copies of `tree`: shard k holds piece k of the leading axis
    of every tensor, on `mesh.devices[k]`. Every leading axis must divide
    by D; None leaves stay None."""
    leaves, spec = tree_flatten(tree)
    for x in leaves:
        if x is not None and (x.dim() == 0 or x.shape[0] % mesh.size):
            raise ValueError(f"shard_over_mesh: a leading axis of {tuple(x.shape)} does not divide "
                             f"over the {mesh.size} shards of mesh axis {mesh.axis!r}")
    shards = []
    for k, dev in enumerate(mesh.devices):
        out = []
        for x in leaves:
            if x is None:
                out.append(None)
                continue
            per = x.shape[0] // mesh.size
            out.append(x[k * per:(k + 1) * per].to(dev, copy=True))
        shards.append(tree_unflatten(out, spec))
    return shards


def gather(trees: Sequence, device) -> object:
    """The per-shard trees as one tree on `device`: every tensor the
    concatenation of its shards' pieces in shard order. Always a copy (a
    shard's tensors may be graph buffers that its next step rewrites)."""
    device = torch.device(device)
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    if any(s != spec for _, s in flat):
        raise ValueError("gather: the shards' trees differ in structure")
    out = []
    for parts in zip(*(leaves for leaves, _ in flat)):
        if parts[0] is None:
            out.append(None)
        else:
            out.append(torch.cat([p.to(device) for p in parts]) if len(parts) > 1
                       else parts[0].to(device, copy=True))
    return tree_unflatten(out, spec)


def to_each(tensors, mesh: Mesh) -> list:
    """`tensors` (a tree) replicated: one copy per distinct device of the
    mesh, by shard (shards on one device share it; the copy on a tensor's
    own device is the tensor itself)."""
    by_device = {}
    for dev in mesh.distinct_devices:
        leaves, spec = tree_flatten(tensors)
        by_device[dev] = tree_unflatten([None if x is None else x.to(dev) for x in leaves], spec)
    return [by_device[d] for d in mesh.devices]


def to_first(parts: Sequence, mesh: Mesh) -> list:
    """Per-shard trees of tensors each copied to `mesh.first` (a tensor
    already there is itself), in shard order."""
    return [tree_map(lambda x: x.to(mesh.first), part) for part in parts]


def _recorded(device: torch.device):
    """A CUDA event recorded on `device`'s current stream; None off the card."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _wait(device: torch.device, event) -> None:
    if event is not None:
        torch.cuda.current_stream(device).wait_event(event)


def copy_out(src, dsts: Sequence, mesh: Mesh) -> None:
    """Copy the tree `src` (on `mesh.first`) into every shard's tree of
    static tensors `dsts[k]` (on its device): the first device's current
    stream records an event after what it has queued, and each shard's
    current stream waits on it before its copy. (PyTorch runs a copy
    between two cards on the source's current stream, after both streams'
    queued work; the event orders the shards' streams the same way where
    they share a card.)"""
    ready = _recorded(mesh.first)
    src = tree_leaves(src)
    for dev, dst in zip(mesh.devices, dsts):
        _wait(dev, ready)
        for s, x in zip(tree_leaves(dst), src):
            s.copy_(x)


def copy_in(srcs: Sequence, dsts: Sequence, mesh: Mesh) -> None:
    """Copy every shard's tree `srcs[k]` (on its device) into the tree of
    static tensors `dsts[k]` on `mesh.first`: each shard's current stream
    records an event after what it has queued, and the first device's
    current stream waits on all of them before the copies."""
    for event in [_recorded(dev) for dev in mesh.devices]:
        _wait(mesh.first, event)
    for src, dst in zip(srcs, dsts):
        for s, x in zip(tree_leaves(dst), tree_leaves(src)):
            s.copy_(x)
