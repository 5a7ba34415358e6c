"""Step functions: train / prefill / decode (the port of
``repro.launch.steps``).

``make_train_step`` is forward + backward (``torch.autograd.grad`` over
the parameter leaves, each group recomputed in the backward) + AdamW.
The parameters and the optimizer state are updated in place and returned
(``optim.adamw``).

On a mesh the parameters and moments are DTensors (``launch.sharding.
place`` by ``param_shardings`` and ``opt_shardings``) and the step runs
under ``launch.compat.set_mesh``: it places a plain batch by
``batch_shardings``, and DTensor's sharding propagation partitions the
computation, as XLA's partitioner does the reference's jitted step.
``act_spec`` (from :func:`act_partition_spec`) pins the residual stream
between and inside the layer groups.  Every gradient is brought to its
parameter's placements (:func:`placed_like`) as it comes out of the
backward, so the float32 microbatch accumulators and AdamW's inputs are
sharded as the parameters are.
"""

from __future__ import annotations

import torch

from ..core.snap import resolve_device
from ..models.config import ModelConfig
from ..models.shard_utils import is_dtensor, mesh_context
from ..models.transformer import (decode_step, init_params, prefill,
                                  train_loss, tree_from_paths, tree_leaves,
                                  tree_map, value_and_grad)
from ..optim.adamw import adamw_init, adamw_update
from .compat import axis_sizes, current_mesh
from .sharding import P, batch_shardings, place

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


def act_partition_spec(cfg: ModelConfig, mesh, seq: int):
    """Residual-stream constraints [B, S, d] as a (sharded, gathered) pair:
    between groups the stream is sequence-parallel (S over 'model', bounds
    remat-saved activations); inside a group it is gathered once.

    Only worthwhile when the residual stream is large (d_model >= 4096),
    or when the backbone is SSM/hybrid: mamba layers are elementwise along
    S, so the whole state-update pipeline inherits the S-sharding.  None
    when neither holds or the model axis does not divide ``seq``."""
    from .mesh import batch_axes
    wants_sp = cfg.d_model >= 4096 or cfg.family in ('ssm', 'hybrid')
    if seq % axis_sizes(mesh).get('model', 1) or not wants_sp:
        return None
    ba = batch_axes(mesh)
    return (P(ba, 'model', None), P(ba, None, None))


def _on(batch, dev):
    """The batch's tensors on ``dev`` (numpy arrays or tensors; token ids
    as int64); under a mesh, plain ones placed by ``batch_shardings``."""
    ids = ('tokens', 'labels')
    out = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v))
           .to(dev, dtype=torch.long if k in ids else None)
           for k, v in batch.items()}
    mesh = current_mesh()
    if mesh is None or all(is_dtensor(v) for v in out.values()):
        return out
    return place(out, batch_shardings(out, mesh))


def _split(v, n: int):
    """``v`` cut into ``n`` equal parts along its first axis.  A DTensor
    sharded along it whose ranks' rows split evenly is cut on each rank's
    own rows (part i holds the i-th n-th of every rank's rows), so that no
    rows move; the parts sum to the same loss and gradients."""
    b = v.shape[0]
    if b % n:
        raise ValueError(f'batch {b} does not split into {n} microbatches')
    if is_dtensor(v) and any(pl.is_shard(0) for pl in v.placements) \
            and v.to_local().shape[0] % n == 0:
        from torch.distributed.tensor import DTensor
        local = v.to_local()
        m = local.shape[0] // n
        return [DTensor.from_local(local[i * m:(i + 1) * m], v.device_mesh,
                                   v.placements, run_check=False)
                for i in range(n)]
    return [v[i:i + b // n] for i in range(0, b, b // n)]


def placed_like(g, p):
    """The gradient ``g`` in its parameter ``p``'s placements (a DTensor;
    anything else unchanged): a partial gradient is reduce-scattered onto
    the parameter's shards, never gathered whole."""
    if not is_dtensor(g) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(cfg: ModelConfig, *, state_dtype='float32', lr=3e-4,
                    act_spec=None, microbatches: int = 1, device='cuda'):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``device`` (the card unless the CPU is asked for; without a card
    the default raises).  ``metrics`` holds ``loss`` and ``grad_norm`` as
    device tensors.  With ``microbatches > 1`` the batch splits evenly
    along its first axis, the gradients accumulate in float32 over the
    parts, and loss and gradients are divided by ``microbatches``.
    ``act_spec``: None, or the residual stream's (between groups, inside a
    group) ``NamedSharding`` pair (``forward``'s ``act_sharding``)."""
    dev = resolve_device(device)

    def loss_and_grads(params, batch):
        return value_and_grad(
            lambda p: train_loss(cfg, p, batch, remat=True,
                                 act_sharding=act_spec), params)

    def step(params, opt_state, batch):
        batch = _on(batch, dev)
        with mesh_context(params):
            flat = dict(tree_leaves(params))
            if microbatches > 1:
                parts = {k: _split(v, microbatches) for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                # the float32 accumulators take the parameters' placements
                # (ZeRO: each rank sums its own shards)
                grads = {path: torch.zeros_like(p, dtype=torch.float32)
                         for path, p in flat.items()}
                for i in range(microbatches):
                    part_loss, part_grads = loss_and_grads(
                        params, {k: v[i] for k, v in parts.items()})
                    loss = loss + part_loss
                    for path in list(part_grads):
                        grads[path] += placed_like(part_grads.pop(path),
                                                   flat[path]).float()
                loss = loss / microbatches
                grads = {path: g / microbatches
                         for path, g in grads.items()}
            else:
                loss, grads = loss_and_grads(params, batch)
                grads = {path: placed_like(g, flat[path])
                         for path, g in grads.items()}
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
