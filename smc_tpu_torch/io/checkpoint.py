"""SMC state checkpoint/resume (PyTorch port of ``smc_tpu.io.checkpoint``).

A checkpoint holds the state's 13 fields: particles, log_lik, gamma, the
run's random-number state, step, the diagnostics and the running
log-evidence, so a run resumes exactly: pass the loaded state to
``run_smc(..., state=...)``. Three formats, as in the JAX package, with
the same file layouts, so each package's readers read the other's files:

- ``.npz`` (:func:`save_state`): one NumPy archive;
- ``.smck`` (:func:`save_state_async`): the native runtime's container,
  written on its background thread (``smc_tpu_torch/runtime``);
- ``.smcd`` (:func:`save_state_chunked`): a directory with one ``.npy``
  per field of the particle axis and a ``meta.json``. Each field comes off
  the device in row slabs of at most ``max_bytes`` (``t[ofs:ofs+rows]
  .cpu()``) into a memory-mapped file, and is read back in slabs of the
  same bound into a tensor allocated once on the device, so host memory
  stays O(slab) both ways, whatever N is.

``.npz`` and ``.smck`` gather each field to the host whole: O(N x d) host
memory, about 32 MB at N = 1e6.

The ``key`` field is the run's ``TorchDraws`` generator state as tagged
uint32 words, written and read by the rule of ``smc_tpu_torch.convert``
(``key_to_words``, ``draws_from_key``): a port file restores the generator
exactly (on the device type it was saved from); a JAX file's threefry key
seeds a fresh ``TorchDraws`` from its bytes. The other 12 fields keep the
JAX package's dtypes (float32, and int32 for the counters), bit for bit.
The JAX package's ``load_state`` cannot read a port file's key (it is not
threefry data); its array readers read every field.

Both single states and ensemble states (a leading dataset axis D on every
field) go through the same functions.

A run sharded over a mesh (parallel/mesh.py) writes the same files: its
processes gather the state (``gather_state``) and the primary one writes
it. ``load_state(path, sharding=psh)`` reads only this process's rows; a
``.smcd`` field is read from its memory map slab by slab, so no process
holds the whole particle array on the host.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from smc_tpu_torch.config import resolve_device
from smc_tpu_torch.convert import (STATE_FIELDS, key_to_words,
                                   state_from_numpy, state_to_numpy)
from smc_tpu_torch.smc.state import SMCState

SLAB_BYTES = 64 * 2 ** 20


def _flatten(state: SMCState) -> dict:
    """The 13 fields as host arrays, ``key`` as tagged uint32 words."""
    flat = state_to_numpy(state)
    flat["key"] = key_to_words(state.key)
    return flat


def _unflatten(d: dict, device) -> SMCState:
    d = dict(d)
    # Fields added after a checkpoint was written load with their neutral
    # value (pre-evidence .npz/.smck snapshots).
    d.setdefault("log_evidence", np.zeros(np.shape(d["gamma"]), np.float32))
    return state_from_numpy(d, device=device)


def save_state(path: str, state: SMCState) -> None:
    """Synchronous .npz checkpoint (``np.savez`` appends ``.npz`` to a
    path without it)."""
    np.savez(path, **_flatten(state))


def save_state_async(checkpointer, path: str, state: SMCState) -> None:
    """Queue a checkpoint on the native async writer (``.smck``
    container; ``runtime.AsyncCheckpointer``). The caller's thread pays for
    the device-to-host copies; the disk write runs on the writer's
    thread."""
    checkpointer.submit(path, _flatten(state))


def _slab_rows(shape, itemsize: int, max_bytes: int) -> int:
    row_bytes = max(1, int(np.prod(shape[1:])) * itemsize)
    return max(1, max_bytes // row_bytes)


def _iter_row_slabs(t: torch.Tensor, max_bytes: int):
    """Yield ``(row_offset, host_slab)`` covering ``t``'s rows, each slab
    at most ``max_bytes`` (at least one row): the slice is taken on the
    device, so each transfer is slab-sized."""
    rows = _slab_rows(t.shape, t.element_size(), max_bytes)
    for ofs in range(0, t.shape[0], rows):
        yield ofs, t[ofs:ofs + rows].cpu().numpy()


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


def save_state_chunked(path: str, state: SMCState,
                       max_bytes: int = SLAB_BYTES) -> str:
    """Bounded-host-memory checkpoint: a ``.smcd`` directory with one
    memory-mapped ``.npy`` per field whose leading axis is longer than 1,
    filled in row slabs of at most ``max_bytes``; the other fields and the
    key go into ``meta.json``. The same content as :func:`save_state`'s
    .npz, in the JAX package's layout. Returns the directory's path."""
    path = str(path)
    if not path.endswith(".smcd"):
        path += ".smcd"
    os.makedirs(path, exist_ok=True)
    meta = {"format": "smcd", "version": 1, "fields": []}
    scalars = {}
    for name in STATE_FIELDS:
        if name == "key":
            continue
        t = getattr(state, name).detach()
        if t.dim() >= 1 and t.shape[0] > 1:
            mm = np.lib.format.open_memmap(
                os.path.join(path, name + ".npy"), mode="w+",
                dtype=_np_dtype(t), shape=tuple(t.shape))
            for ofs, slab in _iter_row_slabs(t, max_bytes):
                mm[ofs:ofs + slab.shape[0]] = slab
            mm.flush()
            del mm
            meta["fields"].append({"name": name, "kind": "npy"})
        else:
            a = t.cpu().numpy()
            scalars[name] = a.tolist()
            meta["fields"].append({"name": name, "kind": "scalar",
                                   "dtype": a.dtype.name})
    meta["scalars"] = scalars
    meta["key"] = key_to_words(state.key).tolist()
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return path


def _put_slabbed_from_memmap(mm: np.memmap, device,
                             max_bytes: int = SLAB_BYTES) -> torch.Tensor:
    """A tensor on ``device`` from a memory-mapped .npy: allocated once,
    filled in row slabs of at most ``max_bytes``. Host memory stays
    O(slab), and the device holds no second copy."""
    out = torch.empty(mm.shape, dtype=getattr(torch, mm.dtype.name),
                      device=device)
    rows = _slab_rows(mm.shape, mm.dtype.itemsize, max_bytes)
    for ofs in range(0, mm.shape[0], rows):
        out[ofs:ofs + rows].copy_(torch.from_numpy(np.array(
            mm[ofs:ofs + rows])))
    return out


def _rows_of(sharding, arrays: dict):
    """``name -> index`` of this process's part of each field of a whole
    state whose fields are ``arrays`` (anything with ``.shape``)."""
    ens = len(arrays["gamma"].shape) == 1
    n = arrays["particles"].shape[-2]
    d = arrays["gamma"].shape[0] if ens else 0
    return lambda name: sharding.field_index(name, ens, n, d)


def _load_state_chunked(path: str, device, max_bytes: int = SLAB_BYTES,
                        sharding=None) -> SMCState:
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    d, maps = {}, {}
    for spec in meta["fields"]:
        name = spec["name"]
        if spec["kind"] == "npy":
            maps[name] = np.load(os.path.join(path, name + ".npy"),
                                 mmap_mode="r")
        else:
            d[name] = np.asarray(meta["scalars"][name],
                                 dtype=np.dtype(spec["dtype"]))
    index = None if sharding is None else _rows_of(sharding, {**d, **maps})
    for name, mm in maps.items():
        if index is not None:
            mm = mm[index(name)]
        d[name] = _put_slabbed_from_memmap(mm, device, max_bytes)
    del maps
    d["key"] = np.asarray(meta["key"], dtype=np.uint32)
    return _unflatten(d, device)


def load_state(path: str, sharding=None, device="cuda") -> SMCState:
    """Load any of the three formats, written by either package, onto
    ``device``. A ``.smcd`` directory is read in row slabs of at most
    ``SLAB_BYTES`` (host memory O(slab)); ``.npz`` and ``.smck`` are read
    whole. ``sharding`` (``parallel.mesh.particle_sharding`` of a mesh,
    or the mesh): this process's rows of the state only (for ``.smcd``
    only they are read from the file)."""
    dev = resolve_device(device)
    path = str(path)
    if sharding is not None:
        from smc_tpu_torch.parallel.mesh import as_sharding
        sharding = as_sharding(sharding)
    if os.path.isdir(path) or path.endswith(".smcd"):
        return _load_state_chunked(path, dev, sharding=sharding)
    if path.endswith(".smck"):
        from smc_tpu_torch.runtime import load_snapshot
        d = load_snapshot(path)
    else:
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            d = {k: z[k] for k in z.files}
    if sharding is not None:
        index = _rows_of(sharding, d)
        d = {k: (np.ascontiguousarray(v[index(k)])
                 if k != "key" and index(k) else v) for k, v in d.items()}
    return _unflatten(d, dev)
