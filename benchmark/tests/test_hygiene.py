"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""
import os
import subprocess
import sys

from benchmark import hygiene
from benchmark.tests.conftest import ROOT


def test_sources_clean():
    assert hygiene.scan() == {}


def test_scan_catches(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "b.py").write_text("from shadow_gnn_tpu.nn import x\n")
    (tmp_path / "c.py").write_text("import shadow_gnn_tpus\nimport jaxtyping\n")
    (tmp_path / "reference" / "d.py").write_text("from shadow_gnn_torch import TRAIN\n")
    assert hygiene.scan(str(tmp_path)) == {"a.py": ["jax"], "b.py": ["shadow_gnn_tpu"],
                                           os.path.join("reference", "d.py"):
                                               ["shadow_gnn_torch"]}


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, check=True, timeout=600).stdout.strip()


def test_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import verify;"
            "from benchmark.entries import train_epochs;"
            "from benchmark.reference import sage, gat, ppr, subgraph, optim;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'shadow_gnn_torch', 'shadow_gnn_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert _run(code) == "[]"


def test_run_loads_no_jax():
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark import harness, hygiene;"
            "from benchmark.tests.conftest import small;"
            "res = harness.run('sage3_flickr.train', 5, 0.2, False, time.time(), 'cpu',"
            " small('sage3_flickr'));"
            "print(hygiene.loaded_forbidden(), res['correct'])")
    assert _run(code).splitlines()[-1] == "[] True"


def test_cli_refuses_without_card():
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sage3_flickr.train", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
