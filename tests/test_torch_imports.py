"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import ast
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hpc_ops_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "hpc_ops_tpu"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_checker_catches_jax():
    assert _forbidden("jax.numpy") and _forbidden("jaxlib") and _forbidden("hpc_ops_tpu.ops")
    assert not _forbidden("hpc_ops_tpu_torch.ops") and not _forbidden("torch")


def _shared_names():
    """(JAX top-level name, its JAX object, the port's object of the same
    module path and name) for every public name the port has ported."""
    import importlib

    import hpc_ops_tpu as J

    out = []
    for name in J.__all__:
        obj = getattr(J, name)
        mod = getattr(obj, "__module__", None) or ""
        if not mod.startswith("hpc_ops_tpu."):
            continue  # constants, re-exported dtypes
        try:
            port_mod = importlib.import_module("hpc_ops_tpu_torch" + mod[len("hpc_ops_tpu"):])
        except ModuleNotFoundError:
            continue  # a module of a later slice
        if hasattr(port_mod, name):
            out.append((name, obj, getattr(port_mod, name)))
    return out


def test_top_level_has_every_ported_jax_name():
    """``import hpc_ops_tpu_torch as hpc; hpc.<op>`` works for every public
    name of the JAX package's top level that the port has, as the JAX
    package's own top level re-exports its op modules."""
    import hpc_ops_tpu_torch as T

    shared = _shared_names()
    assert len(shared) > 60
    missing = [n for n, _, _ in shared if n not in T.__all__ or not hasattr(T, n)]
    assert not missing, f"ported but not on hpc_ops_tpu_torch: {missing}"
    for n, _, port_obj in shared:
        assert getattr(T, n) is port_obj, n
    built = json.loads(T.built_json())
    assert set(built) >= {"version", "torch", "cuda"} and built["version"] == T.__version__


def test_ported_functions_take_the_jax_keywords():
    """A call written for the JAX package runs on the port: every ported
    function accepts each of its JAX counterpart's parameters by name (TPU
    hints such as ``tn`` or ``interpret`` are accepted and ignored)."""
    import inspect

    bad = {}
    for name, jax_obj, port_obj in _shared_names():
        if not inspect.isfunction(jax_obj):
            continue
        want = [p for p, v in inspect.signature(jax_obj).parameters.items()
                if v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD)]
        have = inspect.signature(port_obj).parameters
        if any(v.kind == v.VAR_KEYWORD for v in have.values()):
            continue
        lacking = [p for p in want if p not in have]
        if lacking:
            bad[name] = lacking
    assert not bad, f"ported functions without the JAX keywords: {bad}"


@pytest.mark.parametrize("module", ["ops.stem", "ops.gemm", "ops.normalization", "ops.attention"])
def test_every_public_name_of_the_module_is_on_the_top_level(module):
    """``hpc.<name>`` works for every public name of JAX's ``ops.stem``,
    ``ops.gemm``, ``ops.normalization`` and ``ops.attention`` (the
    block-sparse prefill entry point among them), each the port module's own."""
    import importlib

    import hpc_ops_tpu_torch as T

    jax_mod = importlib.import_module("hpc_ops_tpu." + module)
    port_mod = importlib.import_module("hpc_ops_tpu_torch." + module)
    missing = [n for n in jax_mod.__all__ if getattr(T, n, None) is not getattr(port_mod, n, 0)]
    assert not missing, f"{module}: not exported by hpc_ops_tpu_torch: {missing}"


def test_top_level_carries_the_ported_parallel_names():
    """JAX's top level re-exports ``hpc_ops_tpu.parallel``; the port's carries
    every name of it, each the port module's own, and
    ``fuse_allreduce_rmsnorm_pallas`` takes the JAX kernel wrapper's keywords
    (``interpret`` and ``collective_id`` are TPU hints, accepted and
    unused)."""
    import inspect

    import hpc_ops_tpu.parallel as jax_parallel
    import hpc_ops_tpu_torch as T
    import hpc_ops_tpu_torch.parallel as port_parallel

    names = list(jax_parallel.__all__)
    assert sorted(port_parallel.__all__) == sorted(names)
    assert all(getattr(T, n) is getattr(port_parallel, n) and n in T.__all__ for n in names)
    want = list(inspect.signature(jax_parallel.fuse_allreduce_rmsnorm_pallas).parameters)
    assert list(inspect.signature(T.fuse_allreduce_rmsnorm_pallas).parameters) == want
