"""Device meshes and data-parallel batch solving (parallel/mesh.py of the JAX
package).

Data-parallel ARAP needs no communication: every device owns whole problems
(batch entries), as the reference's one-GPU-per-worker farm
(para_gen.py:560-567), batched on the device and without processes or tmp
files. ``data_sharded`` is the port's ``data_sharded_jit``: it runs a
batched function on each device's contiguous slice of the batch, issues
every slice before it reads any product back, and gathers the products on
the mesh's first device. There is no collective and no compile, so a
schedule's floats reach each slice as they are and a remainder splits
unevenly (``torch.tensor_split``'s sizes) instead of being padded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import solver as S
from ..ops.energy import ArapOperands


class Mesh:
    """A (data, space) array of devices; ``shape`` maps each axis name to
    its size, as a ``jax.sharding.Mesh``'s does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "space": devices.shape[1]}

    @property
    def first(self) -> torch.device:
        """The device the products are gathered on."""
        return self.devices[0, 0]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              space: int = 1, devices=None) -> Mesh:
    """A ('data', 'space') mesh, by default over every visible CUDA device
    on the 'data' axis. `devices` takes any list of devices, repeats
    included (several mesh entries on one card exercise the split and the
    gather, not scaling)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (e.g. [torch.device('cpu')])")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data is None:
        data = n // space
    if data * space != n or n == 0:
        raise ValueError(f"mesh {data}x{space} != {n} devices")
    arr = np.empty((data, space), dtype=object)
    for i, d in enumerate(devices):
        arr[i // space, i % space] = d
    return Mesh(arr)


def batch_slices(B: int, n: int) -> list[slice]:
    """The non-empty contiguous slices of ``torch.tensor_split(·, n)`` over
    a batch of B: the first B mod n hold one problem more."""
    q, r = divmod(B, n)
    out, start = [], 0
    for k in range(n):
        size = q + (k < r)
        if size:
            out.append(slice(start, start + size))
        start += size
    return out


def _batch_size(a) -> int:
    if dataclasses.is_dataclass(a):
        return _batch_size(getattr(a, dataclasses.fields(a)[0].name))
    return int(a.shape[0])


def _place(a, sl: slice, device: torch.device):
    """Slice `sl` of a batched argument on `device`: tensors and operand
    sets (tensor or numpy leaves) move there; a bare numpy array (host
    metadata such as canvas offsets) stays on the host."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: _place_leaf(getattr(a, f.name)[sl], device)
                          for f in dataclasses.fields(a)})
    if isinstance(a, torch.Tensor):
        return a[sl].to(device, non_blocking=True)
    return a[sl]


def _place_leaf(leaf, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.to(device, non_blocking=True)
    return torch.as_tensor(np.ascontiguousarray(leaf), device=device)


def shard_batch(ops_batched, mesh: Mesh) -> list:
    """Split every leaf of a batched operand set on dim 0 into the mesh's
    'data' slices, each on its device; slices of 0 problems are left out.
    Returns the slices in batch order."""
    n = mesh.shape["data"]
    return [_place(ops_batched, sl, mesh.devices[k, 0])
            for k, sl in enumerate(batch_slices(_batch_size(ops_batched), n))]


def data_sharded(mesh: Mesh, fn, *batched) -> tuple:
    """``fn`` on each 'data' slice of the batched arguments (see ``_place``),
    on the slice's device. Every slice is issued before any product is read
    back, so on several cards the launches overlap; each of ``fn``'s
    products is gathered on ``mesh.first``, in batch order."""
    n = mesh.shape["data"]
    outs = []
    for k, sl in enumerate(batch_slices(_batch_size(batched[0]), n)):
        dev = mesh.devices[k, 0]
        outs.append(fn(*(_place(a, sl, dev) for a in batched)))
    return tuple(
        torch.cat([o[i].to(mesh.first, non_blocking=True) for o in outs])
        for i in range(len(outs[0])))


def solve_batch_sharded(ops_batched: ArapOperands, cfg: S.SolverConfig,
                        mesh: Mesh):
    """Data-parallel batched solve: ``solver.solve_batch`` on each device's
    slice of the batch (so each slice takes the route ``solve_batch`` picks
    for its device), with no collectives. Returns (xs (B, 3, H, W), flows
    (B, 2, H, W)) on ``mesh.first``."""
    return data_sharded(mesh, lambda o: S.solve_batch(o, cfg), ops_batched)
