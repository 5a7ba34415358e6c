"""End-to-end training entry point: data pipeline -> sharded train step ->
async checkpointing -> elastic restart (the port of
``repro.launch.train``).

Runs on the card unless ``--device cpu`` is given (without a card the
default raises).  ``--debug-mesh`` (on, as in the reference) trains on a
``('data', 'model')`` mesh of ``(n // 2, 2)`` over the ``n`` ranks of the
process group the driver runs in (``(1, 1)`` for one rank); a single
process makes itself a one-rank gloo group.  Off, it asks for the 16 x 16
production mesh.  On a mesh of more than one device the parameters and
AdamW state are DTensors placed by ``param_shardings`` and
``opt_shardings`` and each step runs under ``set_mesh``; on one device
every placement is the whole tensor, and the state stays plain tensors.

It is also the restart entry point: on startup it restores the latest
checkpoint under ``--ckpt`` (if any), placed by the current mesh's
shardings whatever mesh wrote it, and moves the token stream to that step,
so the same command line resumes after a failure or a change of ranks and
continues the same run.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 20 --batch 8 --seq 128 --ckpt /tmp/run1 \\
        [--device cpu]

The arch's ``train_policy`` sets the parameter and moment dtypes and the
microbatches.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.snap import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.compat import axis_sizes, make_auto_mesh, set_mesh
from repro_torch.launch.sharding import opt_shardings, param_shardings, place
from repro_torch.launch.steps import (init_train_state, make_train_step,
                                      train_policy)
from repro_torch.models.shard_utils import is_dtensor
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.resilience import ResilienceLog, StragglerPolicy


def build_mesh(debug: bool, device_type: str = 'cuda'):
    """The debug mesh ``(n // model, model)`` over the ``n`` ranks of the
    process group (``model`` 2 when ``n`` is even and above 1, else 1), or
    the production mesh."""
    if debug:
        n = dist.get_world_size()
        model = 2 if n % 2 == 0 and n > 1 else 1
        return make_auto_mesh((n // model, model), ('data', 'model'),
                              device_type)
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(device_type=device_type)


def _value(t):
    """A metric's global value (a DTensor gathered)."""
    return t.full_tensor() if is_dtensor(t) else t


def main(argv=None):
    """Train ``--steps`` steps (from the latest checkpoint's step on);
    returns ``{'params', 'opt', 'losses', 'start_step'}``, ``losses`` the
    logged steps' losses (the parameters and state DTensors on a mesh of
    more than one device)."""
    ap = argparse.ArgumentParser(prog='python -m repro_torch.launch.train')
    ap.add_argument('--arch', required=True)
    ap.add_argument('--reduced', action='store_true')
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--ckpt', default='')
    ap.add_argument('--ckpt-every', type=int, default=10)
    ap.add_argument('--debug-mesh', action='store_true', default=True)
    ap.add_argument('--log-every', type=int, default=1)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    if own_group:   # one rank: a group of its own, no network
        dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        return _train(args, dev)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, dev):

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pol = train_policy(cfg)
    mesh = build_mesh(args.debug_mesh, dev.type)
    sharded = mesh.size() > 1
    print(f'arch={cfg.name} device={dev} mesh={axis_sizes(mesh)} '
          f'policy={pol}', flush=True)

    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0),
        state_dtype=pol['state_dtype'], param_dtype=pol['param_dtype'],
        device=dev)
    pshard = param_shardings(params, mesh)
    oshard = opt_shardings(opt, pshard, mesh)
    where = {'params': pshard, 'opt': oshard} if sharded else dev
    data = SyntheticTokens(vocab=cfg.vocab, seq=args.seq,
                           global_batch=args.batch)
    start_step = 0
    ckpt_root = Path(args.ckpt) if args.ckpt else None
    checkpointer = ckpt.AsyncCheckpointer()
    last = None if ckpt_root is None else ckpt.latest_step(ckpt_root)
    if last is not None:
        print(f'restoring step {last} (resharding onto the current mesh)',
              flush=True)
        state = ckpt.restore(ckpt.step_dir(ckpt_root, last),
                             {'params': params, 'opt': opt}, where)
        params, opt = state['params'], state['opt']
        data.restore({'step': last})
        start_step = last
    elif sharded:
        params, opt = place(params, pshard), place(opt, oshard)

    step_fn = make_train_step(cfg, state_dtype=pol['state_dtype'],
                              lr=args.lr, microbatches=pol['microbatches'],
                              device=dev)
    if sharded:
        step_fn = _under(mesh, step_fn)
    stragglers = StragglerPolicy()
    rlog = ResilienceLog()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data.next_batch())
        logged = step % args.log_every == 0
        if logged:   # the step's one readback
            loss, gnorm = torch.stack(
                [_value(metrics['loss']), _value(metrics['grad_norm'])]
            ).tolist()
            losses.append(loss)
        dt = time.perf_counter() - t0
        stragglers.record_step({'worker0': dt})
        for w in stragglers.stragglers():
            rlog.record(step, 'straggler', w)
        if logged:
            print(f'step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} '
                  f'{dt * 1e3:.0f} ms', flush=True)
        if ckpt_root is not None and (step + 1) % args.ckpt_every == 0:
            checkpointer.save_async(
                ckpt.step_dir(ckpt_root, step + 1),
                {'params': params, 'opt': opt}, step + 1,
                extra=data.state())
    checkpointer.wait()
    if sharded:     # every rank sees the checkpoints the first one wrote
        dist.barrier()
    print(f'done; resilience events {rlog.summary()}', flush=True)
    return dict(params=params, opt=opt, losses=losses,
                start_step=start_step)


def _under(mesh, fn):
    def run(*args):
        with set_mesh(mesh):
            return fn(*args)
    return run


if __name__ == '__main__':
    main()
