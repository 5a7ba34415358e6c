"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  All sources compile in parallel, one ``nvcc`` each, into
``build/`` beside this file; a library's file name carries a digest of its
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  A failed build raises with the compiler's output.

Every exported function returns the ``cudaError_t`` of its launch; the
wrappers call :func:`launch` (or :func:`launcher`'s bound function, where
the wrapper's host time counts), which raises when it is not 0, and then
report it with ``analysis.launches.record``, which adds one to the kernel's
entry of :data:`LAUNCHES`.  ``-Xptxas -v``'s report is kept
beside each library (``.log``); :func:`ptxas_report` reads each kernel's
registers, stack frame and spills from it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / 'build'
SOURCES = ('snap_u', 'snap_y', 'snap_fused_de', 'assemble_forces',
           'cell_list', 'brute_neighbors')
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / 'bin' / 'nvcc').exists():
        return str(Path(CUDA_HOME) / 'bin' / 'nvcc')
    raise RuntimeError('nvcc not found (PATH or CUDA_HOME); the CUDA '
                       'kernels cannot be built')


def _target(name: str) -> Path:
    h = hashlib.sha256(' '.join(FLAGS).encode())
    for src in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build() -> dict:
    """Compile every missing library in parallel.

    Returns {name: dict(path, log)}; ``log`` holds ``-Xptxas -v``'s
    registers / spill report, kept beside the library for later calls.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs, out = {}, {}
    for name in SOURCES:
        path = _target(name)
        if path.exists():
            log = path.with_suffix('.log')
            out[name] = dict(path=path, log=log.read_text()
                             if log.exists() else '(cached, no log)')
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        jobs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f'--- {name} (nvcc exit {proc.returncode})\n{log}')
            continue
        path.with_suffix('.log').write_text(log)
        os.replace(tmp, path)
        out[name] = dict(path=path, log=log)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return out


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: dict(registers, stack, spill_stores,
    spill_loads)} from an ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out[name]['registers'] = int(m.group(1))
    return out


@lru_cache(maxsize=None)
def _libraries():
    built = build()
    return {name: ctypes.CDLL(str(info['path']))
            for name, info in built.items()}


@lru_cache(maxsize=None)
def _function(source: str, symbol: str, argtypes: tuple):
    lib = _libraries()[source]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = lib.snap_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


P, I, D, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
# kernel launches per wrapper entry (launches.record counts; CPU runs do not)
LAUNCHES = collections.Counter()


def query(source: str, symbol: str, argtypes: tuple, *args) -> None:
    """Call a non-launching function of library ``source`` on the current
    device (its last two arguments are the device and an unused stream)
    and raise on a CUDA error."""
    fn, err_string = _function(source, symbol, tuple(argtypes) + (I, P))
    code = fn(*args, torch.cuda.current_device(), None)
    if code != 0:
        raise RuntimeError(f'{symbol}: CUDA error {code} '
                           f'({err_string(code).decode()})')


@lru_cache(maxsize=None)
def launcher(source: str, symbol: str, argtypes: tuple):
    """``run(device, *args)``: call ``symbol`` of library ``source`` on
    PyTorch's current stream of CUDA device ``device`` (an index) and raise
    on a CUDA error.  ``args`` are already plain: device pointers as ints
    (``data_ptr()``), ints and floats.  For wrappers whose host time
    counts: the function, its argument types and the stream query are
    bound once."""
    fn, err_string = _function(source, symbol, tuple(argtypes) + (I, P))
    raw_stream = torch._C._cuda_getCurrentRawStream

    def run(device, *args):
        code = fn(*args, device, raw_stream(device))
        if code != 0:
            raise RuntimeError(f'{symbol}: CUDA error {code} '
                               f'({err_string(code).decode()})')
    return run


def launch(source: str, symbol: str, argtypes: tuple, *args) -> None:
    """Call ``symbol`` of library ``source`` and raise on a CUDA error.

    Tensors in ``args`` are passed as device pointers; the caller keeps
    them alive across the (asynchronous) launch by holding references.
    The launch goes to PyTorch's current stream on the first tensor's
    device, which the C function also makes its current device.
    """
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    launcher(source, symbol, tuple(argtypes))(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        *conv)
