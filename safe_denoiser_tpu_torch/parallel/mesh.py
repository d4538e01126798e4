"""Device meshes in one process: named axes of device *slots*, batch
sharding and replication.

Counterpart of ``safe_denoiser_tpu/parallel/mesh.py``. The JAX layer is one
process over a mesh of devices in which XLA inserts the collectives; here a
:class:`Mesh` is a numpy object array of ``torch.device`` slots shaped by
its named axes, a sharded tensor is a list of per-slot pieces in slot order,
and each parallel function calls the ordinary single-device code (and its
kernels) once per slot. Data moves between slots only in ``comm.py``.

A slot is a position in the mesh, not a device: an explicit ``devices=``
list may repeat one (``[torch.device("cpu")] * 8`` in the CPU tests, eight
``cuda:0`` slots in ``chip_smoke.py``), so every sharded path runs with
real shards, a kernel call per shard and real reductions on one device.
Without ``devices=`` a mesh takes distinct CUDA devices and raises when
fewer are visible than asked for (the JAX package's ``make_mesh``
truncates to the devices it has).

Functions that work along one axis of a mesh with more than one take the
slots of that axis at the current coordinates of the others
(:func:`slot_coords`, default 0): ``Mesh.line``. The data-parallel loops
(:func:`over_axis`) set the data coordinate while they run a row's work, so
a tensor-parallel layer inside uses that row's model slots.

A slot's work runs under :func:`on_slot`, which makes its device the
current CUDA device: the kernel wrappers launch on the current device's
stream (and refuse a tensor of another device), and a CUDA graph captures
the current device's work.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import weakref
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

_COORDS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "slot_coords", default={})


@contextlib.contextmanager
def slot_coords(**coords: int):
    """Fix mesh coordinates (axis name -> index) for the block: the other
    axes of ``Mesh.line`` and the rows a data-parallel loop is running."""
    token = _COORDS.set({**_COORDS.get(), **coords})
    try:
        yield
    finally:
        _COORDS.reset(token)


def current_coords() -> dict:
    return dict(_COORDS.get())


def on_slot(device):
    """The block with ``device`` the current CUDA device (nothing to do for
    the CPU): every loop over a mesh's slots runs each slot's work so."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index ("cuda" is the current
    GPU), so two names of one device compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _device_array(devices) -> np.ndarray:
    arr = np.asarray(devices, dtype=object)
    out = np.empty(arr.shape, dtype=object)
    for idx, d in np.ndenumerate(arr):
        out[idx] = as_device(d)
    return out


class Mesh:
    """Slots (``devices``: an object array of ``torch.device``) over named
    axes. ``shape`` maps an axis name to its size, as JAX's
    ``mesh.shape[axis]``; ``devices.size`` counts the slots."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = _device_array(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D device array for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def line(self, axis: str) -> list[torch.device]:
        """The slots along ``axis``, the other axes at the current
        coordinates (0 where none is set)."""
        coords = _COORDS.get()
        idx = tuple(slice(None) if name == axis else coords.get(name, 0)
                    for name in self.axis_names)
        return list(self.devices[idx])

    def distinct_devices(self) -> list[torch.device]:
        seen: dict[str, torch.device] = {}
        for d in self.devices.flat:
            seen.setdefault(str(d), d)
        return list(seen.values())

    def _key(self):
        return self.axis_names, tuple(str(d) for d in self.devices.flat), \
            self.devices.shape

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh. ``devices=None``: the first ``n_devices`` CUDA devices
    (all of them by default), raising when fewer are visible. ``devices``:
    these slots (repeats allowed), the first ``n_devices`` of them."""
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n < 1 or n > have:
            raise RuntimeError(
                f"make_mesh({n_devices}): a mesh of {n} device(s) needs as "
                f"many CUDA devices and {have} are visible (pass devices= "
                "to lay slots on one device)")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"make_mesh({n_devices}) over "
                                 f"{len(devices)} listed devices")
            devices = devices[:n_devices]
    return Mesh(devices, (axis,))


class _Pieces(list):
    """A tensor's per-slot pieces: a leaf of ``_map``."""


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    if torch.is_tensor(tree) or isinstance(tree, _Pieces):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def split_rows(x: torch.Tensor, n: int, dim: int = 0) -> list:
    """``x`` cut into ``n`` equal contiguous pieces along ``dim``."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide "
                         f"into {n} shards")
    return [p.contiguous() for p in x.chunk(n, dim)]


def shard_batch(tree: Any, mesh: Mesh, axis: str = "data",
                batch_dim: int = 0) -> list:
    """One tree per slot along ``axis`` (slot order), each tensor cut along
    ``batch_dim`` and placed on its slot's device."""
    devs = mesh.line(axis)
    cut = _map(tree, lambda x: _Pieces(split_rows(x, len(devs), batch_dim)))
    return [_map(cut, lambda p, i=i, dev=dev: p[i].to(dev))
            for i, dev in enumerate(devs)]


def module_device(module: nn.Module) -> torch.device:
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")


def replicate(tree_or_module: Any, mesh: Mesh) -> list:
    """One copy per slot (``mesh.devices.flat`` order) with one copy per
    distinct device: slots on one device share it (a module already there
    is itself; a module's copies are :func:`module_on`'s), so a model is
    not copied for slots that repeat a device."""
    if isinstance(tree_or_module, nn.Module):
        return [module_on(tree_or_module, dev) for dev in mesh.devices.flat]
    copies: dict[str, Any] = {}
    out = []
    for dev in mesh.devices.flat:
        key = str(dev)
        if key not in copies:
            copies[key] = _map(tree_or_module, lambda x: x.to(dev))
        out.append(copies[key])
    return out


# source module -> {device: (its weights' signature, the copy there)}; an
# entry goes with its module
_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, dict]" = \
    weakref.WeakKeyDictionary()


def _signature(module: nn.Module) -> tuple:
    """What a copy must be made again for: every parameter's and buffer's
    name, dtype and shape (``enable_int8`` swaps layers) and version
    counter (an in-place ``load_lora``, ``load_state_dict`` or optimizer
    step raises it)."""
    return tuple((name, t.dtype, t.shape, t._version) for name, t in (
        *module.named_parameters(), *module.named_buffers()))


def module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` on ``device``: itself where it lies there, else one copy
    per (module, device), made again when the module's weights have
    changed since (:func:`_signature`). The one way the parallel layer and
    the pipelines place a module on a slot's device."""
    device = as_device(device)
    if module_device(module) == device:
        return module
    per_device = _REPLICAS.setdefault(module, {})
    sig = _signature(module)
    hit = per_device.get(str(device))
    if hit is None or hit[0] != sig:
        per_device.pop(str(device), None)     # free the stale copy first
        hit = (sig, copy.deepcopy(module).to(device))
        per_device[str(device)] = hit
    return hit[1]


def over_axis(mesh: Optional[Mesh], axis: str, fn: Callable, *tensors,
              dim: int = 0):
    """``fn(*tensors)`` with the rows (``dim``) split over ``axis``: each
    slot's rows run under ``slot_coords(axis=i)`` on that slot's device and
    the outputs (a tensor or a tuple of them, None kept) come back
    concatenated in slot order on the first input's device. Runs ``fn``
    whole where the mesh has no such axis or a caller already fixed it."""
    if mesh is None or axis not in mesh.axis_names or \
            axis in _COORDS.get():
        return fn(*tensors)
    devs = mesh.line(axis)
    home = tensors[0].device
    parts = [split_rows(t, len(devs), dim) for t in tensors]
    outs = []
    for i, dev in enumerate(devs):
        with slot_coords(**{axis: i}), on_slot(dev):
            outs.append(fn(*(p[i].to(dev) for p in parts)))
    if torch.is_tensor(outs[0]):
        return torch.cat([o.to(home) for o in outs], dim)
    return tuple(None if o[0] is None else
                 torch.cat([x.to(home) for x in o], dim)
                 for o in zip(*outs))
