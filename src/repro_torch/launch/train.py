"""End-to-end training entry point: data pipeline -> train step -> async
checkpointing -> restart (the port of ``repro.launch.train``).

Runs on the card unless ``--device cpu`` is given (without a card the
default raises).  It is also the restart entry point: on startup it
restores the latest checkpoint under ``--ckpt`` (if any) onto the device
and moves the token stream to that step, so the same command line resumes
after a failure and continues the same run bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 20 --batch 8 --seq 128 --ckpt /tmp/run1 \\
        [--device cpu]

The arch's ``train_policy`` sets the parameter and moment dtypes and the
microbatches.  The reference's ``--debug-mesh`` and its mesh placement
(``build_mesh``, ``param_shardings``, ``opt_shardings``) are not ported
yet: they come with the port's mesh, and until then one process trains on
one device.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.core.snap import resolve_device
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.steps import (init_train_state, make_train_step,
                                      train_policy)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.resilience import ResilienceLog, StragglerPolicy


def main(argv=None):
    """Train ``--steps`` steps (from the latest checkpoint's step on);
    returns ``{'params', 'opt', 'losses', 'start_step'}``, ``losses`` the
    logged steps' losses."""
    ap = argparse.ArgumentParser(prog='python -m repro_torch.launch.train')
    ap.add_argument('--arch', required=True)
    ap.add_argument('--reduced', action='store_true')
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq', type=int, default=128)
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--ckpt', default='')
    ap.add_argument('--ckpt-every', type=int, default=10)
    ap.add_argument('--log-every', type=int, default=1)
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pol = train_policy(cfg)
    print(f'arch={cfg.name} device={dev} policy={pol}', flush=True)

    params, opt = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0),
        state_dtype=pol['state_dtype'], param_dtype=pol['param_dtype'],
        device=dev)
    data = SyntheticTokens(vocab=cfg.vocab, seq=args.seq,
                           global_batch=args.batch)
    start_step = 0
    ckpt_root = Path(args.ckpt) if args.ckpt else None
    checkpointer = ckpt.AsyncCheckpointer()
    if ckpt_root is not None:
        last = ckpt.latest_step(ckpt_root)
        if last is not None:
            print(f'restoring step {last}', flush=True)
            state = ckpt.restore(ckpt.step_dir(ckpt_root, last),
                                 {'params': params, 'opt': opt}, dev)
            params, opt = state['params'], state['opt']
            data.restore({'step': last})
            start_step = last

    step_fn = make_train_step(cfg, state_dtype=pol['state_dtype'],
                              lr=args.lr, microbatches=pol['microbatches'],
                              device=dev)
    stragglers = StragglerPolicy()
    rlog = ResilienceLog()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data.next_batch())
        logged = step % args.log_every == 0
        if logged:   # the step's one readback
            loss, gnorm = torch.stack(
                [metrics['loss'], metrics['grad_norm']]).tolist()
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
    print(f'done; resilience events {rlog.summary()}', flush=True)
    return dict(params=params, opt=opt, losses=losses,
                start_step=start_step)


if __name__ == '__main__':
    main()
