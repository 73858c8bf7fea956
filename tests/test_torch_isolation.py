"""The port stands alone: every module of ``repro_torch`` imports with
``jax`` and ``repro`` blocked, ``chip_smoke.py`` imports neither, and an
entry point given no device targets CUDA — on a host without one it
raises, naming CUDA, instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import pkgutil, importlib, repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [ROOT / "chip_smoke.py", *(ROOT / "src" / "repro_torch").rglob("*.py")]))
def test_no_source_imports_jax_or_repro(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


#: the training loop's modules
TRAINING_MODULES = (
    "repro_torch.train.train_step", "repro_torch.train.data",
    "repro_torch.train.accumulate", "repro_torch.train.fault_tolerance",
    "repro_torch.sharding.rules", "repro_torch.launch.train",
    "repro_torch.benchmarks.fig13_access",
    "repro_torch.examples.train_lm_extent")


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_modules_stand_alone(name):
    """Each is one of the modules the blocked-import walk imports, and
    its source imports neither jax nor repro."""
    path = ROOT / "src" / (name.replace(".", "/") + ".py")
    assert path.is_file(), path
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}
    import pkgutil
    import repro_torch
    assert name in {m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")}


def test_trainer_without_device_targets_cuda():
    """The training launcher and the data pipeline, given no device,
    target CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.launch import train
    from repro_torch.train import data
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        data.make_batch(data.DataConfig(16, 4, 2), 0)


def test_engine_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeConfig, ServingEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(get_config("qwen2.5-3b").reduced(), ServeConfig())


def test_launcher_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])


def test_kernel_wrapper_never_takes_the_twin_off_cpu():
    """Only a CPU tensor selects the twin; any other device launches the
    kernel or raises (here: 'meta', which no kernel takes)."""
    from repro_torch.kernels.extent_write import kernel as K
    x = torch.empty((8,), dtype=torch.int32, device="meta")
    v = torch.empty((32,), dtype=torch.int32, device="meta")
    e = torch.empty((32,), dtype=torch.float32, device="meta")
    before = K.extent_write_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        K.extent_write_cuda(x, x, 1, v, v, e, e)
    assert K.extent_write_cuda.launches == before


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    """Alone in a directory it exits non-zero; in the checkout on a host
    without CUDA it exits non-zero; neither prints a result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
            capture_output=True, text=True, timeout=120))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
