"""The check that no run loads JAX or the JAX package, by whole
top-level module names."""

from benchmark import harness


def test_catches_jax_jaxlib_flax_and_the_jax_package():
    got = harness.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "bonsai_tpu", "bonsai_tpu.config", "numpy"])
    assert got == ["bonsai_tpu", "flax", "jax", "jaxlib"]


def test_lets_the_port_and_lookalikes_pass():
    assert harness.forbidden_modules(
        ["bonsai_tpu_torch", "bonsai_tpu_torch.classify.pipeline",
         "jaxtyping", "flaxen", "torch", "benchmark.harness"]) == []


def test_raises_where_a_forbidden_module_is_loaded(monkeypatch):
    import sys
    import types

    harness.no_forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    try:
        harness.no_forbidden_modules()
    except harness.ForbiddenModules as e:
        assert e.names == ["jaxlib"]
    else:
        raise AssertionError("jaxlib went unseen")


def test_the_benchmark_sources_import_neither():
    import ast
    import os

    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module] if not node.level else []
                assert not harness.forbidden_modules(names), (f, names)


def test_the_yardstick_imports_nothing_of_the_program():
    import ast
    import os

    for f in ("reference.py", "deploy.py", "traffic.py", "trace.py",
              "roofline.py"):
        tree = ast.parse(open(os.path.join(harness.HERE, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            assert not any(n.split(".")[0] == "bonsai_tpu_torch"
                           for n in names), (f, names)
