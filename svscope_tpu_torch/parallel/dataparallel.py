"""Process-wide data-parallel mesh of the port (counterpart of
svscope_tpu/parallel/dataparallel.py).

The reference's only scale-out is a 6-process pool over candidate windows
(src/SVscope.py:158-161).  Here the same axis, windows, is split over the
devices of one process: installing a mesh, an ordered tuple of local
`torch.device`s, makes every batched device dispatch of the engine (the
folded EM's bucket chunks in models/mixture, K1's per-round batches in
ops/poa_batch, the fused build's chunks in ops/poa_fused) cut its batch
axis into one chunk per device.  Each site launches every chunk on its
device before it fetches any, so distinct GPUs work at once; the results
concatenate in chunk order, so the records equal the unsharded run's.

Devices may repeat: ("cuda:0", "cuda:0") runs the sharded code paths on a
one-GPU card, ("cpu",) * n on the CPU.  There is no NCCL: windows are
independent, and the read-parallel EM's and the wavefront's reductions are
plain copies to the first device, summed there in shard order
(`cross_sum`).

This module owns only the registry and the placement helpers; it imports
nothing of the model code (models/mixture and ops/poa_batch import it,
parallel/mesh imports models), which breaks the cycle.
"""
from __future__ import annotations

import contextlib
import logging

import torch

from ..utils.device import resolve_device

log = logging.getLogger("svscope_tpu_torch.dataparallel")

_MESH = None
# introspection for tests / dryrun: how the last shard_batch placed data
LAST_DISPATCH = {"sharded": False, "n_shards": 1}


def set_data_mesh(mesh) -> None:
    """Install (or clear, with None) the engine-wide device tuple.  A
    tuple has no axis names: the JAX package's "dp" axis is the tuple."""
    global _MESH
    _MESH = None if mesh is None else tuple(resolve_device(d) for d in mesh)
    if _MESH is not None:
        log.info("data-parallel mesh installed: %d devices %s",
                 len(_MESH), [str(d) for d in _MESH])


def data_mesh():
    """The installed device tuple, or None."""
    return _MESH


@contextlib.contextmanager
def data_mesh_installed(mesh):
    """Install `mesh` (None clears it) for the block, and clear it after,
    so no later call inherits it."""
    set_data_mesh(mesh)
    try:
        yield
    finally:
        set_data_mesh(None)


def make_dp_mesh(n_devices: int | None = None, devices=None) -> tuple:
    """Device tuple over the given devices, or the first n / all local
    CUDA devices.  Without CUDA and without `devices` it raises: there is
    no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_dp_mesh: CUDA is not available on this "
                               "host and no devices were given")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n_devices:
            devices = devices[:n_devices]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("make_dp_mesh: empty device tuple")
    return mesh


def shard_batch(arrays: tuple, min_per_shard: int = 1, device=None):
    """Split batch-leading numpy arrays over the installed mesh.

    Returns [(device, chunk arrays)]: one chunk per mesh device when the
    mesh divides the shared leading axis with >= min_per_shard rows each;
    else one chunk, the whole batch, on the mesh's first device (or on
    `device`, as the caller resolved it, when no mesh is installed)."""
    mesh = _MESH
    b = int(arrays[0].shape[0])
    if mesh is not None:
        n = len(mesh)
        if b % n == 0 and b // n >= min_per_shard:
            per = b // n
            LAST_DISPATCH.update(sharded=True, n_shards=n)
            return [(d, tuple(a[k * per:(k + 1) * per] for a in arrays))
                    for k, d in enumerate(mesh)]
        device = mesh[0]
    LAST_DISPATCH.update(sharded=False, n_shards=1)
    return [(device, tuple(arrays))]


def cross_sum(parts: list, op=torch.add) -> list:
    """Cross-device reduction of per-shard partials (the JAX package's
    psum; pmax with op=torch.maximum): each partial is copied to the first
    shard's device and combined there in shard order; the result is copied
    back to every shard's device."""
    if len(parts) == 1:
        return list(parts)
    dev0 = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = op(total, p.to(dev0))
    return [total.to(p.device) for p in parts]
