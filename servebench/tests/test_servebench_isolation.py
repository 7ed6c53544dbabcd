"""The benchmark stands apart from the JAX package: no file under
servebench/ imports jax, jaxlib, flax or hpc_ops_tpu (top-level names
compared whole, so hpc_ops_tpu_torch passes), nothing under reference/
imports the port, and no file opens a path under the old benchmark/."""

import ast
import os

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "hpc_ops_tpu"}


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                yield p, ast.parse(open(p).read(), p)


def imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_and_no_jax_package():
    bad = {p: sorted(set(imported(t)) & FORBIDDEN) for p, t in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_takes_nothing_of_the_port():
    for p, t in sources():
        if os.sep + "reference" + os.sep in p:
            assert "hpc_ops_tpu_torch" not in set(imported(t)), p


def test_nothing_reads_the_old_benchmark_folder():
    for p, t in sources():
        if os.path.samefile(p, __file__):  # the patterns below
            continue
        for node in ast.walk(t):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value
                assert not (v.startswith("benchmark/") or "/benchmark/" in v or v == "benchmark"), (p, v)


def test_the_check_itself_sees_a_forbidden_import(tmp_path):
    t = ast.parse("import jax.numpy as jnp\nfrom hpc_ops_tpu.ops import x\nimport hpc_ops_tpu_torch\n")
    assert set(imported(t)) & FORBIDDEN == {"jax", "hpc_ops_tpu"}
