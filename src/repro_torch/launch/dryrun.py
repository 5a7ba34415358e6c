"""Multi-pod dry run: run every (architecture x input shape x mesh) cell's
step once against the production meshes on fake tensors (no allocation),
and record per-device memory, cost and collectives (the port of
``repro.launch.dryrun``).

It needs no card and allocates nothing: the world is a ``fake`` process
group (``torch.testing._internal.distributed.fake_pg``: every collective
returns at once) of 256 or 512 ranks, this process being rank 0;
parameters, optimizer state, batches and caches are DTensors over
``meta`` local shards, placed by the port's shardings; and the port's own
train, prefill or decode step runs once under DTensor's sharding
propagation, every local op on ``meta`` tensors (shapes only; a DTensor
over meta shards reports the meta device, so the model's own buffers are
meta too).  ``meta`` rather than ``FakeTensorMode``: DTensor's sharding
propagation reads the values of small index tensors of its own (a
``_StridedShard``'s offsets, ``.tolist()``), which an active fake mode
refuses.  A dispatch mode of its own (:class:`CostMode`) sees the local
ops that DTensor issues for rank 0 and counts, per device:

- ``cost['flops']``: ``torch.utils.flop_counter``'s formulas on the local
  shapes;
- ``cost['bytes accessed']``: input plus output bytes of every op that is
  not a view (eager's counterpart of XLA's per-op operand and output
  bytes);
- ``collectives``: count and output bytes of each ``_c10d_functional``
  collective, by the reference's kinds;
- ``memory``: the live bytes of every tensor storage, the step's inputs
  included, at their peak (``argument_size_in_bytes``: the inputs' local
  bytes; ``output_size_in_bytes``: the outputs'; ``temp_size_in_bytes``:
  the peak minus the arguments).

The production meshes are planned as a pod's, of device type ``cuda``
(no card is needed; the local shards stay on ``meta``): DTensor then
moves a tensor between two sharded layouts with an all-to-all, as on the
pod, where on a ``cpu`` mesh it would gather the whole and keep its chunk
(gloo has no all-to-all).

Run it as its own process (a fake group is global to its process; only
:func:`lower_cell` and :func:`main` create one, never an import):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh single --out experiments/dryrun

There is no HLO: a record has no ``hlo_file``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.compat import axis_sizes, set_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                         cache_shardings, opt_shardings,
                                         param_shardings, place, tree_map)
from repro_torch.launch.steps import (act_partition_spec, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      train_policy)
from repro_torch.models.config import SHAPES
from repro_torch.models.specs import input_specs, params_specs
from repro_torch.optim.adamw import adamw_init

_COLL_OPS = ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
             'collective-permute')
_COLL_NAMES = (('all_gather', 'all-gather'), ('reduce_scatter',
               'reduce-scatter'), ('all_reduce', 'all-reduce'),
               ('all_to_all', 'all-to-all'), ('alltoall', 'all-to-all'),
               ('permute', 'collective-permute'))
_COLL_NAMESPACES = ('_c10d_functional', '_c10d_functional_autograd',
                    '_dtensor', 'c10d')
_SKIP = ('wait_tensor',)      # a collective's completion, not a collective
_META = {'size', 'sym_size', 'stride', 'sym_stride', 'storage_offset',
         'sym_storage_offset', 'numel', 'sym_numel', 'dim', 'is_contiguous',
         'sym_is_contiguous', 'is_strides_like_format',
         'is_non_overlapping_and_dense', 'layout'}


def _tensors(tree, out=None):
    """The tensors in nested lists, tuples and dicts (a DTensor is one)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """The local bytes of a tree's tensors (a DTensor's shard), each
    storage counted once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


class CostMode(TorchDispatchMode):
    """Per-device FLOP, bytes accessed, collectives and live memory of the
    local ops run inside it (see the module docstring).  An op on a
    DTensor is passed on (``NotImplemented``), so the mode sees the local
    ops and collectives that DTensor issues for this rank instead of the
    global op.  Only ops whose outputs lie on ``device`` count, and no op
    on fake tensors: DTensor's sharding propagation runs its own on fake
    tensors of the global shape (on ``meta`` too, where the op names that
    device) and on small CPU index tensors."""

    def __init__(self, device: str = 'meta'):
        super().__init__()
        self.device = device        # only ops with outputs there count
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode().flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: dict(count=0, bytes=0) for k in _COLL_OPS}
        self.live = 0
        self.peak = 0
        self._storages = weakref.WeakSet()

    def track(self, *trees):
        """Count the storages of tensors made before the mode (a step's
        inputs) as live."""
        for tree in trees:
            for t in _tensors(tree):
                self._track(_local(t))

    def _track(self, t):
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages.add(st)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        if name in _META or any(t.device.type != self.device
                                or isinstance(t, FakeTensor) for t in outs):
            return out
        if func.namespace in _COLL_NAMESPACES:
            kind = next((k for key, k in _COLL_NAMES if key in name), None)
            if kind is not None and name not in _SKIP:
                self.collectives[kind]['count'] += 1
                self.collectives[kind]['bytes'] += sum(
                    t.nbytes for t in outs)
        elif func._overloadpacket in self.registry:
            self.flops += self.registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs))
                              + outs)
        for t in outs:
            self._track(t)
        return out

    def collective_stats(self):
        stats = {k: dict(v) for k, v in self.collectives.items()}
        stats['total_bytes'] = sum(v['bytes'] for v in self.collectives
                                   .values())
        return stats


def fake_world(n: int):
    """This process as rank 0 of a ``fake`` process group of ``n`` ranks
    (a group of another size or backend is replaced)."""
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == 'fake':
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=n)


def lower(cfg, mesh, kind: str, seq: int, batch: int, specs=None):
    """One step of ``cfg`` on ``mesh`` (a ``DeviceMesh`` of a fake group)
    at ``batch`` x ``seq``: the record's per-device ``memory``, ``cost``
    and ``collectives`` and its wall seconds.  ``specs``: the cell's
    ``input_specs`` (default: built from ``kind``, ``seq``, ``batch``)."""
    from repro_torch.models import specs as S
    if specs is None:
        specs = {'train': S.train_batch_specs, 'prefill': S.prefill_specs,
                 'decode': S.decode_specs}[kind](cfg, seq, batch)
    pol = train_policy(cfg)
    t0 = time.time()
    params = params_specs(cfg)
    if pol['param_dtype'] != 'float32' or kind != 'train':
        # serving deployments store bf16 weights at rest, as the
        # reference's; so does a bf16-master training policy
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    pshard = param_shardings(params, mesh)
    with set_mesh(mesh):
        params = place(params, pshard)
        if kind == 'train':
            opt = adamw_init(params, pol['state_dtype'])
            opt = place(opt, opt_shardings(opt, pshard, mesh))
            data = place(specs, batch_shardings(specs, mesh))
            act = act_partition_spec(cfg, mesh, seq)
            act_ns = (None if act is None
                      else tuple(NamedSharding(mesh, a) for a in act))
            step = make_train_step(cfg, state_dtype=pol['state_dtype'],
                                   act_spec=act_ns,
                                   microbatches=pol['microbatches'],
                                   device='meta')
            args = (params, opt, data)
        elif kind == 'prefill':
            data = place(specs, batch_shardings(specs, mesh))
            step, args = make_prefill_step(cfg), (params, data)
        else:
            cache = place(specs['cache'],
                          cache_shardings(specs['cache'], mesh))
            tok = place({'t': specs['tokens']},
                        batch_shardings({'t': specs['tokens']}, mesh))['t']
            step = make_decode_step(cfg)
            args = (params, cache, tok, seq - 1)   # the full cache read
        del params
        t_setup = time.time() - t0
        cm = CostMode()
        cm.track(args)
        arg_bytes = local_bytes(args)
        with cm:
            out = step(*args)
        out_bytes = local_bytes(out)
    del args, out
    return dict(
        memory=dict(argument_size_in_bytes=arg_bytes,
                    output_size_in_bytes=out_bytes,
                    temp_size_in_bytes=cm.peak - arg_bytes,
                    peak_size_in_bytes=cm.peak),
        cost={'flops': float(cm.flops), 'bytes accessed': float(cm.bytes)},
        collectives=cm.collective_stats(),
        setup_s=round(t_setup, 1),
        step_s=round(time.time() - t0 - t_setup, 1))


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """One cell on its production mesh (this process made rank 0 of a fake
    group of 256 or 512 ranks); returns the record dict."""
    cfg = get_config(arch)
    specs = input_specs(cfg, shape_name)
    if specs is None:
        return dict(status='skipped',
                    reason='long_500k inapplicable: full-attention arch '
                           '(see DESIGN.md long-context policy)')
    s = SHAPES[shape_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type='cuda')
    rec = dict(status='ok', arch=arch, shape=shape_name,
               mesh='2x16x16' if multi_pod else '16x16',
               n_devices=math.prod(axis_sizes(mesh).values()),
               kind=s['kind'], policy=train_policy(cfg))
    rec.update(lower(cfg, mesh, s['kind'], s['seq'], s['batch'], specs))
    return rec


def cell_path(outdir: Path, arch, shape, multi_pod):
    mesh = 'multi' if multi_pod else 'single'
    return outdir / f'{arch}__{shape}__{mesh}.json'


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python -m repro_torch.launch.dryrun')
    ap.add_argument('--arch', default='all')
    ap.add_argument('--shape', default='all')
    ap.add_argument('--mesh', default='both',
                    choices=['single', 'multi', 'both'])
    ap.add_argument('--out', default='experiments/dryrun')
    ap.add_argument('--force', action='store_true')
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == 'all' else [args.arch]
    shapes = list(SHAPES) if args.shape == 'all' else [args.shape]
    meshes = {'single': [False], 'multi': [True],
              'both': [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                path = cell_path(outdir, arch, shape, mp)
                if path.exists() and not args.force:
                    print(f'[skip existing] {path.name}', flush=True)
                    continue
                print(f'[cell] {arch} x {shape} x '
                      f'{"multi" if mp else "single"}', flush=True)
                try:
                    rec = lower_cell(arch, shape, mp)
                except Exception:
                    rec = dict(status='error', arch=arch, shape=shape,
                               mesh='2x16x16' if mp else '16x16',
                               traceback=traceback.format_exc())
                    n_fail += 1
                path.write_text(json.dumps(rec, indent=1))
                print(f'  -> {rec["status"]}'
                      + (f' step={rec["step_s"]}s'
                         if 'step_s' in rec else ''), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f'done; {n_fail} failures')
    return 0 if n_fail == 0 else 1


if __name__ == '__main__':
    raise SystemExit(main())
