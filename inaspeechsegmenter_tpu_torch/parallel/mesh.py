"""Device meshes for the multi-GPU engine, the counterpart of
``inaspeechsegmenter_tpu/parallel/mesh.py``.

A ``Mesh`` is a numpy object array of ``torch.device`` with named axes, read
as ``jax.sharding.Mesh`` is (``.devices``, ``.shape``, ``.axis_names``), so
the engine reads like the JAX code.  Where JAX shards an array over the
mesh and lets XLA place the pieces, the port works slot by slot: each slot
holds its own copy of a module (``replicate``) and its own CUDA stream
(``slot_streams``), and ``run_on_slots`` runs one piece of work per slot,
each on its own thread, under the slot's device and stream.

A mesh's slots may name one device more than once: ``["cuda:0"] * 2`` on a
single card, or ``["cpu"] * 8`` in the CPU tests, which is the testing form
of a mesh, as the JAX tests force 8 host devices.  Every code path of the
engine then runs for real; only the copies between two physical cards and
the scaling with their number need several GPUs.
"""

from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from ..utils.device import resolve_device


class Mesh:
    """Devices on named axes.

    :param devices: an array-like of ``torch.device`` (or device names)
        whose dimensions are the axes.
    :param axis_names: one name per dimension, e.g. ``("data",)`` or
        ``("data", "model")``.
    """

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = _device(d)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis="data"):
        """The device of each slot along ``axis`` (the first slot of the
        other axes)."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out


def _device(d):
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(devices):
    """The given devices, or every visible CUDA device (raises if none)."""
    if devices is not None:
        return [_device(d) for d in devices]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device is visible; pass devices= explicitly "
            "(e.g. ['cpu'] * 8, the CPU testing form)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices=None, axis="data", devices=None):
    """1-D mesh over the first ``n_devices`` devices.

    :param devices: the slots' devices; a device may repeat (the one-card
        and CPU testing form).  None takes every visible CUDA device and
        raises if there is none: never the CPU.
    """
    devs = _devices(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"make_mesh: {n_devices} slots asked, "
                             f"{len(devs)} devices given")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def make_2d_mesh(data=None, model=1, devices=None):
    """(data, model) mesh for the trainer's dp x tp layout: ``data`` rows
    of ``model`` slots, filled row by row from ``devices`` (every visible
    CUDA device if None; a device may repeat, as in ``make_mesh``)."""
    devs = _devices(devices)
    if data is None:
        data = len(devs) // model
    if data < 1 or data * model > len(devs):
        raise ValueError(f"make_2d_mesh: a {data} x {model} mesh needs "
                         f"{data * model} devices, {len(devs)} given")
    arr = np.empty(data * model, dtype=object)
    arr[:] = devs[:data * model]
    return Mesh(arr.reshape(data, model), ("data", "model"))


def shard_batch(mesh, x, axis="data"):
    """Split the leading axis of ``x`` evenly over the slots of ``axis``
    -> one tensor per slot, on that slot's device."""
    devs = mesh.axis_devices(axis)
    x = torch.as_tensor(x)
    if x.shape[0] % len(devs):
        raise ValueError(f"leading axis {x.shape[0]} is not divisible by "
                         f"the mesh {axis} axis ({len(devs)})")
    return [part.to(d) for part, d in zip(x.chunk(len(devs)), devs)]


def replicate(mesh, obj):
    """One copy of ``obj`` per slot of ``mesh``, in slot order.

    A module is deep-copied for every slot, also where slots share a
    device, so each slot runs its own replica as on separate cards.  A
    tensor (or a list, tuple or dict of them) is moved with ``.to``, so
    slots on one device share one read-only tensor."""
    out = []
    for d in mesh.devices.flat:
        if isinstance(obj, torch.nn.Module):
            out.append(copy.deepcopy(obj).to(d))
        else:
            out.append(_map_tensors(obj, lambda t, d=d: t.to(d)))
    return out


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def slot_streams(devices):
    """A new CUDA stream for each CUDA slot, None for a CPU slot."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in devices]


def run_on_slots(fn, items, devices, streams):
    """``fn(k, items[k])`` for each slot k, each on its own thread under
    slot k's device and stream -> the results in slot order.

    Each slot's stream first waits for the caller's current streams (the
    inputs were made there); afterwards the caller's streams wait for the
    slots' streams, and every tensor in the results is recorded on the
    caller's stream of its device, so the caller may use and free it.  A
    single item runs on the calling thread.  The first exception of any
    slot is raised once every slot has ended."""
    cuda_devs = sorted({d for d in devices if d.type == "cuda"},
                       key=lambda d: d.index)
    callers = {d: torch.cuda.current_stream(d) for d in cuda_devs}

    def one(k):
        dev, stream = devices[k], streams[k]
        if stream is None:
            return fn(k, items[k])
        for c in callers.values():
            stream.wait_stream(c)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            return fn(k, items[k])

    n = len(items)
    results, errors = [None] * n, [None] * n
    if n == 1:
        results[0] = one(0)
    else:
        def work(k):
            try:
                results[k] = one(k)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors[k] = e

        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
    for k in range(n):
        if streams[k] is not None:
            for c in callers.values():
                c.wait_stream(streams[k])

    def handed(t):
        if t.device.type == "cuda":
            t.record_stream(callers[t.device])
        return t

    return [_map_tensors(r, handed) for r in results]

