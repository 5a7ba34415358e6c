"""Architecture registry: ``get_config(name)`` / ``list_archs()``, and the
paper's SNAP problem sizes: ``get_snap_config(name)``.

A copy of ``repro.configs``: one module per language-model architecture
(the ten public-literature configs, on the port's
:class:`~repro_torch.models.config.ModelConfig`) and the SNAP sizes
(snap_2j8, snap_2j14, on :class:`~repro_torch.core.snap.SnapConfig`).
"""

from importlib import import_module

ARCHS = (
    'seamless-m4t-medium',
    'arctic-480b',
    'granite-moe-1b-a400m',
    'gemma2-2b',
    'deepseek-7b',
    'glm4-9b',
    'gemma3-1b',
    'zamba2-7b',
    'llama-3.2-vision-90b',
    'falcon-mamba-7b',
)

_ALIAS = {
    'seamless-m4t-medium': 'seamless_m4t_medium',
    'arctic-480b': 'arctic_480b',
    'granite-moe-1b-a400m': 'granite_moe_1b_a400m',
    'gemma2-2b': 'gemma2_2b',
    'deepseek-7b': 'deepseek_7b',
    'glm4-9b': 'glm4_9b',
    'gemma3-1b': 'gemma3_1b',
    'zamba2-7b': 'zamba2_7b',
    'llama-3.2-vision-90b': 'llama32_vision_90b',
    'falcon-mamba-7b': 'falcon_mamba_7b',
}

SNAP_CONFIGS = ('snap_2j8', 'snap_2j14')


def list_archs():
    return list(ARCHS)


def get_config(name: str):
    """The :class:`ModelConfig` of an architecture, by its name in
    ``ARCHS`` or its module name."""
    mod = _ALIAS.get(name, name).replace('-', '_').replace('.', '')
    return import_module(f'repro_torch.configs.{mod}').CONFIG


def get_snap_config(name: str):
    """The CONFIG dict of ``name`` (``'snap_2j8'`` or ``'snap_2j14'``;
    ``'snap-2j8'`` also accepted)."""
    mod = name.replace('-', '_')
    if mod not in SNAP_CONFIGS:
        raise ValueError(f'unknown SNAP config {name!r}; choose from '
                         f'{SNAP_CONFIGS}')
    return import_module(f'repro_torch.configs.{mod}').CONFIG
