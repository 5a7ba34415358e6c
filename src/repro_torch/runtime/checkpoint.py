"""Atomic per-leaf checkpoints (the port's copy of the reference's format).

Port of ``repro.runtime.checkpoint``: the same directory layout and leaf
names, so a checkpoint written by either package is read by the other.

- A checkpoint is a directory: ``manifest.json`` + one ``leaf_{i:05d}.npy``
  per leaf, leaves in the order of jax's ``tree_flatten_with_path``: dict
  keys sorted, a NamedTuple's fields in their order and by name, list and
  tuple items in index order, names joined with '.' (``params.w``,
  ``opt.m.w.q``, ``opt.m.w.scale``, ``forces.0``, ..., ``forces.10``).  The
  manifest holds ``step``, ``extra`` and ``leaves`` (name, file, shape,
  dtype of each).
- Atomicity: writes go to ``<dir>.tmp`` and are renamed into place.  Re-
  saving an existing step swaps the old dir aside to ``<dir>.old``, renames
  the tmp dir into place, then deletes the old copy, so at every instant
  at least one complete copy (tmp, old or final) is on disk.
- Async save (:class:`AsyncCheckpointer`): every leaf is copied to host
  memory synchronously, the files are written on a worker thread.
- :func:`restore` places each leaf on a device or by a ``NamedSharding``
  of a mesh (one, or a tree of them) and, with ``slices``, gives a rank
  its :class:`RankSlice` of the leaves that carry the atom axis.
- DTensor leaves (a mesh): every rank of the mesh saves together; each
  leaf is gathered whole and written once, by the mesh's first rank, so
  the files are the reference's, whatever mesh wrote them.

Leaves may be numpy arrays or torch tensors (copied to the host).  A
bfloat16 leaf is stored as its raw 2-byte values (numpy's ``|V2``, named
``bfloat16`` in the manifest), as the reference writes it, and restored as
bfloat16 (the reference's own ``restore`` cannot cast that file back).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, '_fields')


def _children(tree):
    """[(key, subtree)] of a dict (sorted keys), a NamedTuple (its field
    names, in field order) or a list or tuple (index order), else None for
    a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix=''):
    """[(name, leaf)] in jax's ``tree_flatten_with_path`` order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix or 'leaf', tree)]
    out = []
    for k, sub in kids:
        out += _flatten(sub, f'{prefix}.{k}' if prefix else str(k))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _unflatten(sub, leaves) for k, sub in kids}
    fields = [_unflatten(sub, leaves) for _, sub in kids]
    return type(tree)(*fields) if _is_namedtuple(tree) else type(tree)(fields)


# numpy has no bfloat16: such a leaf is stored as its raw 2-byte values
# (numpy's '|V2'), named 'bfloat16' in the manifest, as the reference's
# files hold it
_BF16_FILE = np.dtype('V2')


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FILE)
    return t.numpy()


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == _BF16_FILE:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtensor_type():
    import torch.distributed as dist
    if not dist.is_available():
        return ()
    from torch.distributed.tensor import DTensor
    return DTensor


def _whole(x):
    """A DTensor's global value (gathered on every rank of its mesh: all
    of them must call); anything else unchanged."""
    return x.full_tensor() if isinstance(x, _dtensor_type()) else x


def host_array(x) -> np.ndarray:
    """A tensor (copied from its device; a DTensor gathered whole) or
    array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return _numpy(_whole(x).detach().cpu())
    return np.asarray(x)


def _host_copy(x) -> np.ndarray:
    """A host copy of a leaf that shares no memory with it (``.cpu()`` of
    a CPU tensor and ``np.asarray`` of an array alias their input)."""
    if isinstance(x, torch.Tensor):
        return _numpy(_whole(x).detach().to('cpu', copy=True))
    return np.array(x, copy=True)


def _meshes(tree) -> list:
    return [leaf.device_mesh for _, leaf in _flatten(tree)
            if isinstance(leaf, _dtensor_type())]


def _writes(tree) -> bool:
    """Whether this rank writes ``tree``: always, unless a leaf is a
    DTensor and this rank is not the first rank of its mesh."""
    import torch.distributed as dist
    meshes = _meshes(tree)
    return not meshes or dist.get_rank() == int(meshes[0].mesh.flatten()[0])


def save(ckpt_dir, tree, step: int, extra: Optional[Dict] = None):
    """Synchronous atomic checkpoint write.  A tree with DTensor leaves is
    saved by every rank of their mesh together: each leaf is gathered
    whole, the mesh's first rank writes it once, and every rank returns
    once the checkpoint is complete."""
    import torch.distributed as dist
    if _meshes(tree):
        arrays = [host_array(leaf) for _, leaf in _flatten(tree)]
        if _writes(tree):
            save(ckpt_dir, _unflatten(tree, iter(arrays)), step, extra)
        dist.barrier()
        return
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir.with_suffix('.tmp')
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = dict(step=step, extra=extra or {}, leaves=[])
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr = host_array(leaf)
        fname = f'leaf_{i:05d}.npy'
        np.save(tmp / fname, arr)
        manifest['leaves'].append(
            dict(name=name, file=fname, shape=list(arr.shape),
                 dtype='bfloat16' if arr.dtype == _BF16_FILE
                 else str(arr.dtype)))
    (tmp / 'manifest.json').write_text(json.dumps(manifest))
    old = ckpt_dir.parent / (ckpt_dir.name + '.old')
    if old.exists():                      # stale leftover from a crash
        shutil.rmtree(old)
    if ckpt_dir.exists():
        # swap-then-delete: a rename onto a non-empty dir fails, and
        # rmtree-then-rename would leave a window with no checkpoint
        os.rename(ckpt_dir, old)
    os.rename(tmp, ckpt_dir)
    if old.exists():
        shutil.rmtree(old)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk on a worker thread.

    ``save_async`` waits for the previous write (re-raising its error),
    copies every leaf to host memory — a copy, so changing a leaf in place
    afterwards cannot reach the checkpoint — and starts the write;
    ``wait`` joins it and re-raises the worker's error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, ckpt_dir, tree, step: int,
                   extra: Optional[Dict] = None):
        self.wait()
        host_tree = _unflatten(tree, iter(
            [_host_copy(leaf) for _, leaf in _flatten(tree)]))
        if not _writes(tree):       # another rank of the mesh writes it
            return

        def work():
            try:
                save(ckpt_dir, host_tree, step, extra)
            except BaseException as e:   # re-raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


@dataclass(frozen=True)
class RankSlice:
    """Rank ``rank``'s rows of a leaf split along its first (atom) axis
    into ``n_shards`` equal parts, in rank order (the port's counterpart
    of the reference's ``NamedSharding(mesh, P('data'))``)."""
    rank: int
    n_shards: int

    def rows(self, n: int) -> slice:
        if n % self.n_shards or not 0 <= self.rank < self.n_shards:
            raise ValueError(f'{n} rows do not split into {self.n_shards} '
                             f'equal slices, or rank {self.rank} is not one '
                             'of them')
        n_local = n // self.n_shards
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _per_leaf(spec, n: int, what: str) -> list:
    """One entry of ``spec`` a leaf: ``spec`` itself for every leaf when
    it is a single device, sharding, slice or None, else its flattened
    tree."""
    if spec is None or isinstance(spec, (str, torch.device, RankSlice)) \
            or hasattr(spec, 'placements'):
        return [spec] * n
    got = [x for _, x in _flatten(spec)]
    if len(got) != n:
        raise ValueError(f'{len(got)} {what} for {n} leaves — structure '
                         'mismatch')
    return got


def _read_leaf(path, name: str, cut: Optional[RankSlice], shape,
               against: str):
    """Leaf ``name``'s file, whole, or only ``cut``'s rows of it (memory-
    mapped); its shape must be ``shape`` (the ``against``'s)."""
    arr = np.load(path, mmap_mode=None if cut is None else 'r')
    if list(arr.shape) != list(shape):
        raise ValueError(f'leaf {name}: checkpoint shape {arr.shape} != '
                         f'{against} {tuple(shape)}')
    return arr if cut is None else np.array(arr[cut.rows(arr.shape[0])])


def _placed(t: torch.Tensor, where):
    """``t`` on a device, or a DTensor by a ``launch.sharding.
    NamedSharding`` (every rank holds the whole leaf, so its shard is cut
    locally)."""
    if hasattr(where, 'placements'):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t.to(where.mesh.device_type), where.mesh,
                                 where.placements, src_data_rank=None)
    return t.to(device=torch.device(where or 'cpu'))


def restore(ckpt_dir, target_tree, devices=None, slices=None):
    """Restore into the structure of ``target_tree`` (leaves: tensors,
    DTensors, arrays or anything with ``shape`` and ``dtype``, the whole
    logical shape): each leaf cast to its target's dtype (torch or numpy)
    and placed by ``devices`` — one device or ``NamedSharding`` for every
    leaf, or a tree of them shaped like ``target_tree``; None gives CPU
    tensors.  A ``NamedSharding`` makes the leaf a DTensor of its mesh,
    which need not be the mesh that saved it (the reference's resharding
    restore).

    ``slices``: None, or a tree shaped like ``target_tree`` of
    :class:`RankSlice` (this rank's rows along the atom axis; only those
    rows are read from the file) or None (the whole leaf, replicated) —
    see :func:`repro_torch.runtime.shard.atom_slices`.

    The checkpoint holds logical (whole) leaves, so a checkpoint written
    on any device, or by any number of ranks, restores onto any other.
    """
    ckpt_dir = Path(ckpt_dir)
    manifest = json.loads((ckpt_dir / 'manifest.json').read_text())
    leaves = _flatten(target_tree)
    if len(manifest['leaves']) != len(leaves):
        raise ValueError(
            f'checkpoint has {len(manifest["leaves"])} leaves, target has '
            f'{len(leaves)} — structure mismatch')
    where = _per_leaf(devices, len(leaves), 'devices')
    cuts = _per_leaf(slices, len(leaves), 'slices')
    out = []
    for (name, tgt), meta, dev, cut in zip(leaves, manifest['leaves'], where,
                                           cuts):
        arr = _read_leaf(ckpt_dir / meta['file'], name, cut, tgt.shape,
                         'target')
        out.append(_placed(_tensor(arr).to(dtype=_torch_dtype(tgt.dtype)),
                           dev))
    return _unflatten(target_tree, iter(out))


def restore_named(ckpt_dir, slices: Optional[Dict[str, RankSlice]] = None
                  ) -> tuple:
    """``(leaves, manifest)`` from the manifest alone, ``leaves`` a dict of
    leaf name -> numpy array.

    ``slices``: leaf name -> :class:`RankSlice` for the leaves of which
    only this rank's rows are read (memory-mapped); the other leaves are
    read whole.

    When the final dir is missing (or lacks its manifest) but
    ``<dir>.old`` holds a complete checkpoint — a re-save died inside the
    swap window — the ``.old`` copy is the latest complete checkpoint and
    is read instead.
    """
    ckpt_dir = Path(ckpt_dir)
    slices = slices or {}
    if not (ckpt_dir / 'manifest.json').exists():
        old = ckpt_dir.parent / (ckpt_dir.name + '.old')
        if (old / 'manifest.json').exists():
            ckpt_dir = old
    manifest = json.loads((ckpt_dir / 'manifest.json').read_text())
    leaves = {}
    for meta in manifest['leaves']:
        leaves[meta['name']] = _read_leaf(
            ckpt_dir / meta['file'], meta['name'], slices.get(meta['name']),
            meta['shape'], 'manifest (a corrupt checkpoint)')
    return leaves, manifest


def latest_step(root) -> Optional[int]:
    """The largest step with a complete ``step_<digits>`` dir under
    ``root`` ('.tmp' and '.old' dirs never count), or None."""
    root = Path(root)
    if not root.exists():
        return None
    steps = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith('step_') and \
                d.name.split('_', 1)[1].isdigit() and \
                (d / 'manifest.json').exists():
            steps.append(int(d.name.split('_')[1]))
    return max(steps) if steps else None


def step_dir(root, step: int) -> Path:
    return Path(root) / f'step_{step:08d}'
