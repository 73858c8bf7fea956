"""The port's examples (``repro_torch.examples``) on the CPU,
in-process as ``tests/test_examples.py`` runs the reference's, and
``image_store_psnr``'s stores against the reference's.

* The reference's test card, fed to the port's oracle write, gives the
  reference's stored bits at all four levels (the same threefry
  uniforms), and PSNRs equal to ``PSNR_RTOL`` = 1e-6 (float32 means
  summed in another order).
* The port's own test card is within ``CARD_ULPS`` = 2 float32 ulp of
  1.0 of the reference's (sin and cos are not XLA's; the grid is).
"""
import ast
import pkgutil
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro import memory as jmemory
from repro.core import Priority as JPriority
from repro_torch.examples import (image_store_psnr, serve_approx_kv,
                                  train_lm_extent)

ROOT = Path(__file__).resolve().parents[1]
PSNR_RTOL = 1e-6
CARD_ULPS = 2


@pytest.fixture(scope="module")
def reference_example():
    """The reference example's namespace (its functions, not its main)."""
    return runpy.run_path(str(ROOT / "examples" / "image_store_psnr.py"))


@pytest.fixture(scope="module")
def reference_gray(reference_example):
    return jnp.mean(reference_example["test_card"](), axis=-1)


def test_test_card_is_the_reference_card(reference_example):
    ref = np.asarray(reference_example["test_card"]())
    port = image_store_psnr.test_card(device="cpu").numpy()
    assert port.shape == ref.shape == (256, 256, 3)
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=CARD_ULPS * 2.0 ** -23)


@pytest.mark.parametrize("level", ["LOW", "MID", "HIGH", "EXACT"])
def test_store_matches_the_reference(reference_example, reference_gray,
                                     level):
    gray = torch.from_numpy(np.array(reference_gray))
    stored, h = image_store_psnr.store(
        gray, getattr(image_store_psnr.Priority, level))
    jstored, jst = jmemory.write(jax.random.PRNGKey(0),
                                 jnp.zeros_like(reference_gray),
                                 reference_gray,
                                 level=getattr(JPriority, level),
                                 backend="oracle")
    np.testing.assert_array_equal(stored.numpy().view(np.int32),
                                  np.asarray(jstored).view(np.int32))
    jh = jst.host_dict()
    for k in ("bits_written", "bit_errors", "bits_total"):
        assert h[k] == jh[k], k
    assert image_store_psnr.psnr(gray, stored) == pytest.approx(
        reference_example["psnr"](reference_gray, jstored), rel=PSNR_RTOL)


def test_image_store_psnr_runs(capsys):
    image_store_psnr.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].split()[:2] == ["level", "PSNR(dB)"]
    for level in ("LOW", "MID", "HIGH", "EXACT"):
        assert any(line.startswith(level) for line in out.splitlines())
    assert "OK: LOW-priority storage keeps PSNR above 30 dB" in out


def test_serve_approx_kv_runs(capsys):
    serve_approx_kv.main(["--new-tokens", "4", "--batch", "2",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    for text in ("arch=qwen2.5-3b-reduced  batch=2  new_tokens=4  "
                 "backend=lanes_ref",
                 "token agreement (extent vs exact):", "KV write energy:",
                 "CMP write-skip rate:", "realized KV bit-error rate:",
                 "kv_prefill", "kv_decode",
                 "-- continuous batching (slot pool, staggered arrivals) --",
                 "4 requests,", "req 3 app=chat", "EXTENT table:"):
        assert text in out, text


def test_examples_target_cuda_without_a_device_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for mod in (image_store_psnr, serve_approx_kv, train_lm_extent):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])


def test_no_port_code_uses_the_kernel_keywords():
    """``repro.analysis``'s registry rule bans ``use_kernel=`` and
    ``interpret=`` keywords in ``src/``; the port uses none."""
    found = []
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.keyword) and node.arg in (
                    "use_kernel", "interpret"):
                found.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not found, found


def test_isolation_covers_the_new_modules():
    """``test_torch_isolation`` walks every module of the package: the
    examples, the serving benchmarks and ``launch.hw`` are among them."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for name in ("repro_torch.examples.image_store_psnr",
                 "repro_torch.examples.serve_approx_kv",
                 "repro_torch.launch.hw",
                 *(f"repro_torch.benchmarks.{m}" for m in (
                     "kernel_bench", "serving_energy", "endurance_sweep",
                     "prefix_reuse", "workload_mixes", "telemetry_overhead",
                     "shard_scaling"))):
        assert name in names, name
