"""A device mesh over ``torch.distributed`` ranks (counterpart of
``efficient_gnns_tpu/parallel/mesh.py``: ``make_mesh``, ``shard_rows``,
``replicate``; ``shard_cols``, the ``P(None, axis)`` block).

A JAX mesh is an array of devices in one process; here each rank is one
process that owns one device, and a :class:`Mesh` is this rank's view of
the grid: its coordinates, its device and one process group per axis. The
ranks are laid out row-major over ``shape``, as ``np.reshape`` lays out the
JAX mesh's devices, so on a ``("host", "chip")`` mesh rank ``d = host * C +
chip`` (the row-shard order of ``P((host, chip))``), and the chip group of
each host and the host group of each chip index are ordered host-major.

The mesh spans the whole world: ``make_mesh`` raises where the JAX mesh
would take the first ``n`` of more devices (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from efficient_gnns_tpu_torch.parallel.collectives import broadcast_


class Mesh:
    """This rank's place in a grid of ranks: ``axes``, ``shape``, ``coords``
    (this rank's index along each axis), ``device`` and the process group of
    each axis (:meth:`group`), whose ranks differ from this one along that
    axis only, in ascending order."""

    def __init__(self, axes: Tuple[str, ...], shape: Tuple[int, ...], device: torch.device,
                 groups: Dict[str, dist.ProcessGroup]):
        self.axes, self.shape, self.device = axes, shape, device
        self.rank = dist.get_rank()
        self.coords = dict(zip(axes, _unravel(self.rank, shape)))
        self._groups = groups

    def size(self, axis) -> int:
        """The size of ``axis``, or of a tuple of axes taken together."""
        return math.prod(self.shape[self.axes.index(a)] for a in _names(axis))

    def index(self, axis) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``); along a
        tuple of axes, row-major over them (``P((host, chip))``'s order)."""
        i = 0
        for a in _names(axis):
            i = i * self.size(a) + self.coords[a]
        return i

    def group(self, axis: str) -> dist.ProcessGroup:
        return self._groups[axis]


def _names(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _axis_groups(axes: Sequence[str], shape: Tuple[int, ...]) -> Dict[str, dist.ProcessGroup]:
    """One group per axis for this rank. ``dist.new_group`` is collective
    over the whole world, so every rank creates every group, in one order."""
    world, me = dist.get_world_size(), dist.get_rank()
    grid = torch.arange(world).reshape(shape)
    groups = {}
    for a, axis in enumerate(axes):
        if shape[a] == world:
            groups[axis] = dist.group.WORLD
            continue
        lines = grid.movedim(a, -1).reshape(-1, shape[a])  # one row per group, ascending
        for line in lines.tolist():
            g = dist.new_group(line)
            if me in line:
                groups[axis] = g
    return groups


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device="cuda",
) -> Mesh:
    """The mesh over the default process group's ranks.

    The default is a 1-D ``data`` mesh; pass ``axes=("host", "chip")`` with
    a ``shape`` to split it (e.g. ``shape=(2, 4)``). ``device`` is this
    rank's device: ``"cuda"`` is the current CUDA device (the one
    :func:`~efficient_gnns_tpu_torch.parallel.launch.run_world` set), and the
    CPU is used only when asked for. Raises ``ValueError`` when no process
    group is initialised or the world does not hold exactly ``n_devices``
    ranks.
    """
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised default process group "
                         "(parallel.launch.run_world, or dist.init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, not {world}")
    axes = tuple(axes)
    shape = (n,) + (1,) * (len(axes) - 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(axes) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not fit {n} devices on axes {axes}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(axes, shape, dev, _axis_groups(axes, shape))


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of the rows of ``x`` (the whole array,
    identical on every rank), on the mesh's device: the block that
    ``P(axis, ...)`` gives the device at this rank's index along ``axis``."""
    d = mesh.size(axis)
    if x.shape[0] % d:
        raise ValueError(f"rows ({x.shape[0]}) must divide the '{axis}' axis ({d})")
    rows = x.shape[0] // d
    i = mesh.index(axis)
    return x[i * rows:(i + 1) * rows].to(mesh.device).contiguous()


def shard_cols(mesh: Mesh, w: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's contiguous block of the last dim of ``w`` (the whole
    array, identical on every rank), on the mesh's device: the block that
    ``P(None, axis)`` gives the device at this rank's index along ``axis``."""
    d = mesh.size(axis)
    if w.shape[-1] % d:
        raise ValueError(f"columns ({w.shape[-1]}) must divide the '{axis}' axis ({d})")
    cols = w.shape[-1] // d
    i = mesh.index(axis)
    return w[..., i * cols:(i + 1) * cols].to(mesh.device).contiguous()


def replicate(mesh: Mesh, tensors_or_module):
    """Broadcast rank 0's values in place to every rank: a module's
    parameters and buffers, or each tensor of a sequence. Returns its
    argument."""
    if isinstance(tensors_or_module, nn.Module):
        tensors = itertools.chain(tensors_or_module.parameters(), tensors_or_module.buffers())
    else:
        tensors = tensors_or_module
    with torch.no_grad():
        for t in tensors:
            broadcast_(t, src=0)
    return tensors_or_module
