"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (every module under ``src/repro_torch``, the recsys models,
``serve/retrieval.py`` and the model axis's modules among them), and it
never picks the CPU on its own, a mesh's slots included."""

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


def test_the_model_axis_modules_are_among_those_checked():
    mods = _port_modules()
    for m in ("repro_torch.dist.fault_tolerance", "repro_torch.dist.sharding",
              "repro_torch.models.layers", "repro_torch.models.transformer",
              "repro_torch.configs.qwen1_5_32b", "repro_torch.configs.registry",
              "repro_torch.kernels.flash_attention.ops", "repro_torch.launch.serve"):
        assert m in mods, m


def test_mesh_entry_points_without_device_raise_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.dist.fault_tolerance import ElasticMesh
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticMesh(model_parallel=4).remesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-32b", "--mesh", "1x4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_mesh("1x4", "cuda")


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
    # the serving tier: shards default to the visible CUDA devices
    from repro_torch.core.device_engine import sharded_device_index

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(res, device="cpu").enable_sharded()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_device_index(res.hier_index)
    # the explicit CPU device is accepted and runs the plain path
    assert SearchService(res, device="cpu").device_index.device.type == "cpu"


def test_lm_entry_points_without_device_raise_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs.gemma3_4b import SMOKE
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy

    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(SMOKE, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(SMOKE, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({}, SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma3-4b"])
    # the explicit CPU device is accepted and runs the plain path
    report = serve.main(["--arch", "gemma3-4b", "--device", "cpu", "--requests", "2",
                         "--decode-steps", "2"])
    assert report["device"] == "cpu" and report["tokens"].shape == (2, 2)


@pytest.mark.parametrize("arch", ["dien", "mind", "dcn-v2", "bert4rec"])
def test_recsys_entry_points_without_device_raise_instead_of_using_the_cpu(arch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.convert import recsys_from_numpy
    from repro_torch.models.recsys import recsys_module

    cfg = get_arch(arch).smoke_cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_module(arch).init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_from_numpy({}, arch, cfg)
    for cell in ([], ["--cell", "serve_p99"], ["--cell", "retrieval_cand"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, *cell])
    # the explicit CPU device is accepted and runs the plain path
    report = serve.main(["--arch", arch, "--device", "cpu", "--requests", "4"])
    assert report["device"] == "cpu" and report["scores"].shape == (4,)


def test_filtered_retriever_without_device_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import numpy as np

    from repro_torch.serve.retrieval import FilteredRetriever, items_as_corpus

    rng = np.random.default_rng(0)
    items = items_as_corpus([np.unique(rng.choice(40, 5)) for _ in range(300)], 40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilteredRetriever(items, k=4, tc=40)
    ids, report = FilteredRetriever(items, k=4, tc=40, device="cpu").filter(1, 2)
    assert report.n_filtered == len(ids)


def test_recsys_launcher_fails_without_a_gpu_when_run_as_a_program():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher would start for real")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "bert4rec"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_lm_launcher_fails_without_a_gpu_when_run_as_a_program():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the launcher would start for real")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma3-4b"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and "no CUDA device" in out.stderr


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
