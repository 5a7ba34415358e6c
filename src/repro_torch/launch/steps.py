"""Step functions: train / prefill / decode (the port of
``repro.launch.steps``).

``make_train_step`` is forward + backward (``torch.autograd.grad`` over
the parameter leaves, each group recomputed in the backward) + AdamW.
The parameters and the optimizer state are updated in place and returned
(``optim.adamw``).  The activation partition spec of the reference's
sharded step waits for the port's mesh (``act_partition_spec`` is not
ported yet), so the step takes none.
"""

from __future__ import annotations

import torch

from ..core.snap import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import (decode_step, init_params, prefill,
                                  train_loss, tree_from_paths, tree_leaves,
                                  tree_map, value_and_grad)
from ..optim.adamw import adamw_init, adamw_update

# per-arch training numerics policy: everything defaults to float32 master
# params + float32 moments; the two largest models trade moment precision
# (int8 block-quantized) and/or master precision (bf16) for memory
TRAIN_POLICY = {
    'arctic-480b': dict(state_dtype='int8', param_dtype='bfloat16',
                        microbatches=4),
    'llama-3.2-vision-90b': dict(state_dtype='float32',
                                 param_dtype='float32', microbatches=8),
    'seamless-m4t-medium': dict(state_dtype='float32',
                                param_dtype='float32', microbatches=4),
    'granite-moe-1b-a400m': dict(state_dtype='float32',
                                 param_dtype='float32', microbatches=4),
    'deepseek-7b': dict(state_dtype='float32', param_dtype='float32',
                        microbatches=2),
    'glm4-9b': dict(state_dtype='float32', param_dtype='float32',
                    microbatches=2),
    'zamba2-7b': dict(state_dtype='float32', param_dtype='float32',
                      microbatches=2),
    'falcon-mamba-7b': dict(state_dtype='float32', param_dtype='float32',
                            microbatches=2),
}


def train_policy(cfg: ModelConfig):
    pol = dict(state_dtype='float32', param_dtype='float32',
               microbatches=1)
    pol.update(TRAIN_POLICY.get(cfg.name, {}))
    return pol


def cast_params(params, dtype_name: str):
    if dtype_name == 'float32':
        return params
    return tree_map(lambda p: p.to(torch.bfloat16), params)


def _on(batch, dev):
    """The batch's tensors on ``dev`` (numpy arrays or tensors; token ids
    as int64)."""
    ids = ('tokens', 'labels')
    return {k: torch.as_tensor(v).to(dev, dtype=torch.long if k in ids
                                     else None)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, state_dtype='float32', lr=3e-4,
                    microbatches: int = 1, device='cuda'):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (the card unless the CPU is asked for; without a card
    the default raises).  ``metrics`` holds ``loss`` and ``grad_norm`` as
    device tensors.  With ``microbatches > 1`` the batch splits evenly
    along its first axis, the gradients accumulate in float32 over the
    parts, and loss and gradients are divided by ``microbatches``."""
    dev = resolve_device(device)

    def loss_and_grads(params, batch):
        return value_and_grad(
            lambda p: train_loss(cfg, p, batch, remat=True), params)

    def step(params, opt_state, batch):
        batch = _on(batch, dev)
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f'batch {b} does not split into '
                                 f'{microbatches} microbatches')
            parts = [{k: v[i:i + b // microbatches]
                      for k, v in batch.items()}
                     for i in range(0, b, b // microbatches)]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {path: torch.zeros(p.shape, dtype=torch.float32,
                                       device=dev)
                     for path, p in tree_leaves(params)}
            for part in parts:
                part_loss, part_grads = loss_and_grads(params, part)
                loss = loss + part_loss
                for path, g in part_grads.items():
                    grads[path] += g.float()
                del part_grads
            loss = loss / microbatches
            grads = {path: g / microbatches for path, g in grads.items()}
        else:
            loss, grads = loss_and_grads(params, batch)
        params, opt_state, metrics = adamw_update(
            tree_from_paths(grads), opt_state, params, lr=lr,
            state_dtype=state_dtype)
        metrics['loss'] = loss
        return params, opt_state, metrics
    return step


def make_prefill_step(cfg: ModelConfig):
    def step(params, batch):
        return prefill(cfg, params, batch['tokens'],
                       frontend_embeds=batch.get('frontend'))
    return step


def make_decode_step(cfg: ModelConfig):
    def step(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)
    return step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     state_dtype='float32', param_dtype='float32',
                     device='cuda'):
    """(params, AdamW state) on ``device``: ``init_params`` drawn from
    ``generator`` and cast to ``param_dtype``."""
    params = cast_params(init_params(cfg, generator, device), param_dtype)
    return params, adamw_init(params, state_dtype)
