"""The port (spark_rapids_tpu_torch) stands alone: it imports neither JAX
nor the JAX package, and its entry points never move to the CPU unasked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pyarrow as pa
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spark_rapids_tpu_torch")


def _modules():
    import spark_rapids_tpu_torch

    names = ["spark_rapids_tpu_torch"]
    for m in pkgutil.walk_packages(spark_rapids_tpu_torch.__path__,
                                   "spark_rapids_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) > 15
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.') or k == 'spark_rapids_tpu' "
            "or k.startswith('spark_rapids_tpu.'))\n"
            "print('BAD', bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "spark_rapids_tpu"
            or name.startswith("spark_rapids_tpu."))


def test_no_source_file_imports_jax_or_the_jax_package():
    files = []
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_from_arrow_without_device_raises_when_no_card(monkeypatch):
    import torch

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.plan import from_arrow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    with pytest.raises(RuntimeError, match="CUDA"):
        from_arrow(t)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_from_arrow(t)
    # asked for the CPU, it runs there
    assert from_arrow(t, device="cpu").to_arrow().column("a").to_pylist() \
        == [1, 2]


def test_unported_nodes_raise_naming_them():
    from spark_rapids_tpu_torch.exprs import expr as E
    from spark_rapids_tpu_torch.plan import from_arrow

    t = pa.table({"a": pa.array([1, 2], pa.int64())})
    df = from_arrow(t, device="cpu")
    with pytest.raises(NotImplementedError, match="left join"):
        df.join(df, on="a", how="left").to_arrow()

    class Modulo(E.Expression):
        pass

    with pytest.raises(NotImplementedError, match="Modulo"):
        df.filter(Modulo()).to_arrow()
