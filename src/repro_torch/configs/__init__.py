"""The paper's SNAP problem sizes: ``get_snap_config(name)``.

Copy of the SNAP half of ``repro.configs`` (snap_2j8, snap_2j14) on the
port's :class:`~repro_torch.core.snap.SnapConfig`.
"""

from importlib import import_module

SNAP_CONFIGS = ('snap_2j8', 'snap_2j14')


def get_snap_config(name: str):
    """The CONFIG dict of ``name`` (``'snap_2j8'`` or ``'snap_2j14'``;
    ``'snap-2j8'`` also accepted)."""
    mod = name.replace('-', '_')
    if mod not in SNAP_CONFIGS:
        raise ValueError(f'unknown SNAP config {name!r}; choose from '
                         f'{SNAP_CONFIGS}')
    return import_module(f'repro_torch.configs.{mod}').CONFIG
