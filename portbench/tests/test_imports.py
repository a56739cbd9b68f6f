"""Nothing of the benchmark loads JAX or the JAX package (compared by the
whole top-level name: ``recformer_tpu_torch`` is not ``recformer_tpu``),
and the reference loads nothing of the program."""

import os
import subprocess
import sys

import portbench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(portbench.__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "recformer_tpu"}


def _modules(package: str):
    base = os.path.join(ROOT, *package.split("."))
    for dirpath, _, files in os.walk(base):
        if "__pycache__" in dirpath or os.sep + "tests" in dirpath[len(base):]:
            continue
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py"):
                yield rel if f == "__init__.py" else f"{rel}.{f[:-3]}"


def _loaded_after(modules):
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    return set(out.stdout.split())


def test_no_jax_anywhere_in_the_benchmark():
    mods = [m for m in _modules("portbench") if not m.startswith("portbench.metrics.")]
    loaded = _loaded_after(mods + ["recformer_tpu_torch.training.steps",
                                   "recformer_tpu_torch.training.loops"])
    assert not loaded & FORBIDDEN
    assert "recformer_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(list(_modules("portbench.reference")))
    assert "recformer_tpu_torch" not in loaded and not loaded & FORBIDDEN


def test_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "recformer_tpu_torch_extra", sys)
    assert "recformer_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in run.forbidden_modules()
