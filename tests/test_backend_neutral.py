"""The package runs on whatever backend JAX gives it: no kernels or
branches for a machine other than the CPU and the GPU, no silent switch
to the CPU, and a compile cache placed from outside or inside the
checkout."""
import ast
import importlib.util
import os
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(
    [p for p in (ROOT / "arpack_ng_tpu").rglob("*.py")]
    + [p for p in (ROOT / "benchmarks").glob("*.py")]
    + [ROOT / "bench.py", ROOT / "chip_smoke.py"])

#: Pallas routes that compile for a GPU
GPU_PALLAS = {"triton", "mosaic_gpu"}
#: platforms the code may branch on
PLATFORMS = {"cpu", "gpu"}
#: expressions that name the machine
_PLATFORM_READS = {"default_backend", "platform", "device_kind"}


def _is_pallas_submodule(name: str) -> bool:
    return importlib.util.find_spec(
        f"jax.experimental.pallas.{name}") is not None


def _reads_platform(node) -> bool:
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute)
            and node.attr in _PLATFORM_READS)


def _machine_specific(path: Path):
    """Pallas routes other than the GPU's, comparisons of the platform
    with a machine other than the CPU or GPU, and ``interpret=True``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            if mod == "jax.experimental.pallas":
                subs = [a.name for a in node.names
                        if _is_pallas_submodule(a.name)]
            elif mod.startswith("jax.experimental.pallas."):
                subs = [mod.split(".")[3]]
            else:
                subs = []
            if any(s not in GPU_PALLAS for s in subs):
                found.append(f"{path.name}:{node.lineno} import {subs}")
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if (a.name.startswith("jax.experimental.pallas.")
                        and parts[3] not in GPU_PALLAS):
                    found.append(f"{path.name}:{node.lineno} import")
        elif isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if any(_reads_platform(x) for x in sides):
                for c in sides:
                    if (isinstance(c, ast.Constant)
                            and isinstance(c.value, str)
                            and c.value.lower() not in PLATFORMS):
                        found.append(f"{path.name}:{node.lineno} "
                                     f"compare {c.value!r}")
        elif isinstance(node, ast.keyword) and node.arg == "interpret":
            if isinstance(node.value, ast.Constant) and node.value.value:
                found.append(f"{path.name}:{node.lineno} interpret=True")
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_machine_specific_branches_or_kernels(path):
    assert _machine_specific(path) == []


def test_guard_detects_machine_specific_code(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("from jax.experimental.pallas import fuser\n"
                   "import jax\n"
                   "on = jax.default_backend() == 'metal'\n"
                   "k = dict(interpret=True)\n")
    assert len(_machine_specific(bad)) == 3
    ok = tmp_path / "ok.py"
    ok.write_text("from jax.experimental.pallas import triton as plgpu\n"
                  "import jax\n"
                  "cpu = jax.default_backend() == 'cpu'\n")
    assert _machine_specific(ok) == []


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax
    import arpack_ng_tpu as at
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert at.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: the helper sets no other path
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    import jax
    import arpack_ng_tpu as at
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = at.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_dryrun_multichip_refuses_too_few_devices():
    import sys
    sys.path.insert(0, str(ROOT))
    import jax
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)
    assert jax.devices()[0].platform == os.environ["JAX_PLATFORMS"]
