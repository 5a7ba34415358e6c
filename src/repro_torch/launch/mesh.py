"""Production meshes (the port of ``repro.launch.mesh``).

Functions, so that importing this module touches no process group.  The
production meshes need 256 or 512 ranks: such a world exists only in the
dry run's fake group (``python -m repro_torch.launch.dryrun``).

- single pod: 16 x 16 = 256 devices, axes ("data", "model"): "data" is the
  FSDP/ZeRO shard axis, "model" the TP/EP/SP axis.
- multi-pod: 2 x 16 x 16 = 512 devices, axes ("pod", "data", "model"):
  the "pod" axis carries pure data parallelism.
"""

from __future__ import annotations

from .compat import axis_sizes, make_auto_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type='cuda'):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return make_auto_mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device_type='cuda'):
    """A small ('data', 'model') mesh for multi-rank tests."""
    return make_auto_mesh((n_data, n_model), ('data', 'model'), device_type)


DATA_AXES_SINGLE = ('data',)
DATA_AXES_MULTI = ('pod', 'data')


def batch_axes(mesh) -> tuple:
    """The axes a global batch dimension shards over."""
    return DATA_AXES_MULTI if 'pod' in axis_sizes(mesh) else DATA_AXES_SINGLE
