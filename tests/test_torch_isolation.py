"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and it never picks the CPU on its own."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad)); print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=300, check=True,
    )
    assert out.stdout.splitlines()[0] == "0", out.stdout


def test_no_import_of_jax_or_the_reference_in_the_source():
    offenders = []
    for p in sorted(PORT.rglob("*.py")):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{p.relative_to(REPO)}:{node.lineno} {name}")
    assert offenders == []


def test_entry_points_without_device_raise_instead_of_using_the_cpu(
    small_corpus, small_seclud
):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from _torch_parity import port_result

    from repro_torch.core.device_engine import device_counts, device_index
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import Corpus
    from repro_torch.serve.search_service import SearchService

    res = port_result(small_seclud)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_index(res.hier_index)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(res)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_counts(res.hier_index, [[1, 2]])
    corpus = Corpus(
        doc_ptr=small_corpus.doc_ptr[:201].copy(),
        doc_terms=small_corpus.doc_terms[: small_corpus.doc_ptr[200]].copy(),
        n_terms=small_corpus.n_terms,
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SecludPipeline(tc=200, seed=0).fit(corpus, k=2)
    # the explicit CPU device is accepted and runs the plain path
    assert SearchService(res, device="cpu").device_index.device.type == "cpu"


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_without_the_repo(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke run would start for real")
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
