"""Atomic per-leaf checkpoints (the port's copy of the reference's format).

Port of the synchronous part of ``repro.runtime.checkpoint``: the same
directory layout, so a checkpoint written by either package is read by
the other.

- A checkpoint is a directory: ``manifest.json`` + one ``leaf_{i:05d}.npy``
  per leaf, leaves in sorted key order (nested dict keys joined with
  '.'), the manifest holding ``step``, ``extra`` and ``leaves`` (name,
  file, shape, dtype of each).
- Atomicity: writes go to ``<dir>.tmp`` and are renamed into place.  Re-
  saving an existing step swaps the old dir aside to ``<dir>.old``, renames
  the tmp dir into place, then deletes the old copy, so at every instant
  at least one complete copy (tmp, old or final) is on disk.

Leaves may be numpy arrays or torch tensors (copied to the host).  The
asynchronous writer and the resharding ``restore`` are not ported yet.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=''):
    """[(name, leaf)] of a dict tree in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix or 'leaf', tree)]
    out = []
    for k in sorted(tree):
        out += _flatten(tree[k], f'{prefix}.{k}' if prefix else str(k))
    return out


def host_array(x) -> np.ndarray:
    """A tensor (copied from its device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir, tree, step: int, extra: Optional[Dict] = None):
    """Synchronous atomic checkpoint write."""
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
                 dtype=str(arr.dtype)))
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


def restore_named(ckpt_dir) -> tuple:
    """``(leaves, manifest)`` from the manifest alone, ``leaves`` a dict of
    leaf name -> numpy array.

    When the final dir is missing (or lacks its manifest) but
    ``<dir>.old`` holds a complete checkpoint — a re-save died inside the
    swap window — the ``.old`` copy is the latest complete checkpoint and
    is read instead.
    """
    ckpt_dir = Path(ckpt_dir)
    if not (ckpt_dir / 'manifest.json').exists():
        old = ckpt_dir.parent / (ckpt_dir.name + '.old')
        if (old / 'manifest.json').exists():
            ckpt_dir = old
    manifest = json.loads((ckpt_dir / 'manifest.json').read_text())
    leaves = {}
    for meta in manifest['leaves']:
        arr = np.load(ckpt_dir / meta['file'])
        if list(arr.shape) != list(meta['shape']):
            raise ValueError(
                f'leaf {meta["name"]}: file shape {arr.shape} != manifest '
                f'{meta["shape"]} — corrupt checkpoint')
        leaves[meta['name']] = arr
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
