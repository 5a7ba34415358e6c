"""Nothing the benchmark runs may load JAX or the JAX package ``repro``,
compared by whole top-level names (``repro_torch`` begins with
``repro``), and the reference takes nothing of the program."""

import ast
import sys

from snapbench import harness

FILES = sorted(p for p in harness.HERE.rglob('*.py')
               if '__pycache__' not in p.parts)


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'id', getattr(node.func, 'attr', '')) in (
                'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split('.')[0])
    return tops


def test_no_module_of_the_benchmark_imports_jax_or_repro():
    assert FILES
    for path in FILES:
        bad = imported_tops(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((harness.HERE / 'reference').glob('*.py')):
        tops = imported_tops(path)
        assert tops <= {'__future__', 'math', 'dataclasses', 'warnings',
                        'numpy', 'torch'}, (path, tops)


def test_forbidden_names_are_whole_top_level_names():
    ok = ['repro_torch', 'repro_torch.md.integrate', 'jaxtyping', 'numpy']
    assert harness.forbidden_modules(ok) == []
    assert harness.forbidden_modules(ok + ['repro.core.snap', 'jax',
                                           'jaxlib.xla_client', 'flax']) \
        == ['flax', 'jax', 'jaxlib', 'repro']


def test_a_run_loads_neither_jax_nor_repro(tiny):
    from .conftest import run_tiny
    before = {m.split('.')[0] for m in sys.modules}
    run_tiny(*tiny, 'tiny-md')
    loaded = {m.split('.')[0] for m in sys.modules} - before
    assert not loaded & set(harness.FORBIDDEN), loaded
