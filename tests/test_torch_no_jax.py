"""The port imports neither JAX, flax nor the JAX package: the GPU machine
has none of them."""

import os
import pkgutil
import re
import subprocess
import sys

import recformer_tpu_torch

PKG_DIR = os.path.dirname(recformer_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG_DIR], "recformer_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    mods = port_modules()
    for name in ("ops.window_attention", "ops.layernorm", "ops.embed_layernorm",
                 "ops.band_probes", "benchmarks.kernel_ablation", "benchmarks.headpair_probe",
                 "cli.encode_items", "cli.evaluate_seq", "utils.timing", "cli.finetune",
                 "training.checkpoint", "utils.logging", "cli.finetune_classification",
                 "cli.convert_ckpt", "pipelines.transactional",
                 "pipelines.synthetic_transactions", "native", "pipelines.synthetic",
                 "utils.clustering", "cli.cluster", "pipelines.amazon", "utils.profiling",
                 "examples.synthetic_end_to_end", "parallel.mesh", "parallel.collectives",
                 "parallel.catalog", "parallel.tensor", "parallel.dryrun", "cli.pretrain",
                 "cli.serve", "parallel.sequence", "parallel.pipeline", "ops.full_attention",
                 "models.modernbert", "reference.modernbert", "utils.graphs"):
        assert f"recformer_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax')"
        " or n == 'recformer_tpu' or n.startswith('recformer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_sources_name_no_jax():
    # "recformer_tpu_torch" passes: no word boundary or dot after "recformer_tpu"
    bad_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|recformer_tpu)\b", re.M)
    jax_package = re.compile(r"\brecformer_tpu\.")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
               if f.endswith((".py", ".cu", ".cuh", ".cpp")) and "_build" not in d.split(os.sep)]
    sources += [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "scripts/profile_torch_ln_bwd.py")]
    assert len(sources) > 20
    names = {os.path.basename(p) for p in sources}
    assert {"embed_layernorm.cu", "layernorm_bwd.cu", "row_reduce.cuh", "layernorm.py",
            "embed_layernorm.py", "band_mma.cuh", "band_probes.cu", "band_probes.py",
            "hopper_tma.cuh",
            "kernel_ablation.py", "headpair_probe.py", "encode_items.py", "evaluate_seq.py",
            "timing.py", "finetune.py", "checkpoint.py", "logging.py",
            "finetune_classification.py", "convert_ckpt.py",
            "transactional.py", "synthetic_transactions.py", "batcher.cpp", "tokenizer.cpp",
            "synthetic.py", "clustering.py", "cluster.py", "amazon.py", "profiling.py",
            "synthetic_end_to_end.py", "mesh.py", "collectives.py", "catalog.py", "tensor.py",
            "dryrun.py", "pretrain.py", "serve.py", "full_attention.py", "modernbert.py",
            "graphs.py"} <= names
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not bad_import.search(text), path
        assert not jax_package.search(text), path
