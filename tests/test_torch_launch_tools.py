"""The port's roofline and meta-device dry run (the twin of
``tests/test_launch_tools.py``), held against the reference: the
analytic cell model bit for bit, the roofline's terms at the reference's
rates, the backend smoke's flips and energies, and the dry run's
records on reduced configs at the cells' full shapes."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import hw as H
from repro_torch.launch import roofline as rl
from repro_torch.models import get_model

ROOT = Path(__file__).resolve().parents[1]


class TestInputSpecs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_every_cell_has_specs(self, arch):
        for shape in SHAPES:
            specs = dryrun.input_specs(arch, shape)
            assert "tokens" in specs or "frames" in specs
            for shp, dtype in specs.values():
                assert isinstance(dtype, torch.dtype)
                assert shp[0] == SHAPES[shape].global_batch

    def test_cell_count(self):
        cells = list(all_cells())
        assert len(cells) == 34  # 40 assigned − 6 long_500k skips


class TestRooflineModel:
    def test_terms_positive_for_all_cells(self):
        for arch, shape in all_cells():
            r = rl.analyze(arch, shape)
            assert r.compute_s > 0 and r.memory_s > 0, (arch, shape)
            assert r.collective_s >= 0
            assert 0 < r.useful_ratio <= 1.2, (arch, shape, r.useful_ratio)
            assert r.bottleneck in ("compute", "memory", "collective")

    def test_train_flops_close_to_6nd(self):
        """Dense train cells: analytic total within [6ND, 10ND] (attention
        + remat overhead on top of the matmul floor)."""
        for arch in ("qwen2.5-3b", "mistral-nemo-12b"):
            r = rl.analyze(arch, "train_4k")
            assert 1.0 <= r.total_flops / r.model_flops <= 1.8, arch

    def test_moe_uses_active_params(self):
        r = rl.analyze("llama4-scout-17b-a16e", "train_4k")
        api = get_model(get_config("llama4-scout-17b-a16e"))
        n_act, n_tot = api.active_params_per_token(), api.num_params()
        assert n_act < 0.3 * n_tot
        T = 4096 * 256
        np.testing.assert_allclose(r.model_flops, 6 * n_act * T, rtol=1e-6)

    def test_decode_memory_includes_kv(self):
        base = rl.analyze("qwen2.5-3b", "decode_32k")
        kvq = rl.analyze("qwen2.5-3b", "decode_32k",
                         rl.STRATEGIES["serve_tp_only_kvq8"])
        assert kvq.memory_s < base.memory_s

    def test_strategies_change_collectives(self):
        base = rl.analyze("mamba2-2.7b", "train_4k")
        wide = rl.analyze("mamba2-2.7b", "train_4k",
                          rl.STRATEGIES["dp64_tp4"])
        assert wide.collective_s < 0.5 * base.collective_s

    def test_windowed_attention_cheaper(self):
        cfg = get_config("h2o-danube-1.8b")
        full = dataclasses.replace(cfg, window_pattern=(0,))
        shp = SHAPES["prefill_32k"]
        assert rl.cell_flops(cfg, shp)["total"] < rl.cell_flops(
            full, shp)["total"]


def test_dryrun_import_is_side_effect_free(tmp_path):
    """Importing the dry run and the roofline runs nothing: no output, no
    file, no CUDA initialisation, no default-device change."""
    code = ("import os, torch\n"
            "env = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "assert dict(os.environ) == env\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert torch.empty(1).device.type == 'cpu'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout == "" and list(tmp_path.iterdir()) == []


# ------------------------------------------------------ against the JAX


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in all_cells()])
def test_cell_model_bit_identical_with_reference(cell):
    """cell_flops, and cell_bytes and cell_collectives under every
    strategy, equal the reference's dict for dict, float for float."""
    from repro.configs import SHAPES as R_SHAPES
    from repro.configs import get_config as r_config
    from repro.launch import roofline as ref
    arch, shape = cell.split("|")
    cp, cr = get_config(arch), r_config(arch)
    assert rl.cell_flops(cp, SHAPES[shape]) == ref.cell_flops(
        cr, R_SHAPES[shape])
    assert sorted(rl.STRATEGIES) == sorted(ref.STRATEGIES)
    for name, strat in rl.STRATEGIES.items():
        assert dataclasses.asdict(strat) == dataclasses.asdict(
            ref.STRATEGIES[name])
        assert rl.cell_bytes(cp, SHAPES[shape], strat) == ref.cell_bytes(
            cr, R_SHAPES[shape], ref.STRATEGIES[name])
        assert rl.cell_collectives(cp, SHAPES[shape], strat) == \
            ref.cell_collectives(cr, R_SHAPES[shape], ref.STRATEGIES[name])


def test_analyze_equals_reference_at_its_rates(monkeypatch):
    """With the port's hw constants set to the reference's, every term of
    every cell and strategy is the reference's."""
    from repro.launch import hw as ref_hw
    from repro.launch import roofline as ref
    monkeypatch.setattr(H, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(H, "HBM_BW", ref_hw.HBM_BW)
    monkeypatch.setattr(H, "NVLINK_BW_PER_LINK", ref_hw.ICI_BW_PER_LINK)
    assert rl.CHIPS == ref.CHIPS == 256
    for arch, shape in all_cells():
        for name in ("baseline", "dp64_tp4", "selective_remat",
                     "serve_tp_only_kvq8"):
            a = dataclasses.asdict(rl.analyze(arch, shape,
                                              rl.STRATEGIES[name]))
            b = dataclasses.asdict(ref.analyze(arch, shape,
                                               ref.STRATEGIES[name]))
            assert a == b, (arch, shape, name)


def test_analyze_divides_by_the_h100_rates():
    cfg, shp = get_config("qwen2.5-3b"), SHAPES["train_4k"]
    r = rl.analyze("qwen2.5-3b", "train_4k")
    assert r.compute_s == rl.cell_flops(cfg, shp)["total"] / (
        256 * 989e12)
    assert r.memory_s == rl.cell_bytes(cfg, shp)["total"] / (256 * 3.35e12)
    assert r.collective_s == rl.cell_collectives(cfg, shp)["total"] / 50e9
    assert r.roofline_fraction == r.model_flops / (256 * 989e12) / r.step_s


def test_roofline_cli_compare(capsys):
    rl.main(["--compare", "qwen2.5-3b", "train_4k"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "== qwen2.5-3b x train_4k: strategy comparison =="
    assert len(lines) == 2 + len(rl.STRATEGIES)


# ---------------------------------------------------------- smoke


def _reference_smoke_cases():
    import jax
    import jax.numpy as jnp
    return [
        ("bf16", jax.random.normal(jax.random.PRNGKey(1), (33,)
                                   ).astype(jnp.bfloat16)),
        ("int8", jax.random.randint(jax.random.PRNGKey(2), (129,), -128,
                                    128, jnp.int32).astype(jnp.int8)),
    ]


def test_smoke_backends_cpu_equals_reference(capsys):
    """Every backend the port runs on the CPU (``cuda`` through its
    twin there) gives the reference's flips exactly and its energies
    within 1e-5, from inputs bit-identical to the reference's."""
    import jax
    import jax.numpy as jnp
    from repro import memory as ref_mem
    from repro.core.priority import Priority
    out = dryrun.smoke_backends("cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "all 4 backends OK"
    assert sorted(out["bf16"]) == ["cuda", "exact", "lanes_ref", "oracle"]
    key = jax.random.PRNGKey(0)
    for label, new in _reference_smoke_cases():
        old = jnp.zeros_like(new)
        for name in ("exact", "lanes_ref", "oracle"):
            stored, st = ref_mem.write(key, old, new, level=Priority.LOW,
                                       backend=name)
            h = st.host_dict()
            for port_name in ((name, "cuda") if name == "lanes_ref"
                              else (name,)):
                got = out[label][port_name]
                assert got["flips"] == h["bits_written"], (label, name)
                assert got["errors"] == h["bit_errors"], (label, name)
                assert abs(got["energy_pj"] - h["energy_pj"]) <= 1e-5 * max(
                    abs(h["energy_pj"]), 1e-30), (label, name)
                width = {"bf16": np.uint16, "int8": np.uint8}[label]
                np.testing.assert_array_equal(
                    got["stored"].view({"bf16": torch.int16,
                                        "int8": torch.int8}[label]
                                       ).numpy().view(width),
                    np.asarray(jax.lax.bitcast_convert_type(
                        stored, {"bf16": jnp.uint16,
                                 "int8": jnp.uint8}[label])))
        # the port's cuda backend is bit-identical to its twin
        assert torch.equal(out[label]["cuda"]["stored"],
                           out[label]["lanes_ref"]["stored"])


def test_smoke_backends_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.smoke_backends()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--smoke-backends"])


# ---------------------------------------------------------- dry run

#: ``cost.flops`` / ``cell_flops['total']`` of the reduced configs at
#: the cells' full shapes, as counted on meta (a train step counts its
#: remat recompute and the chunked loss's; qwen2.5-3b at full width
#: gives 1.029); held to 1%
FLOP_RATIO = {("qwen2.5-3b", "train_4k"): 1.8577,
              ("qwen2.5-3b", "decode_32k"): 1.0,
              ("dbrx-132b", "train_4k"): 1.5465,
              ("dbrx-132b", "decode_32k"): 1.0}

RECORD_KEYS = {"arch", "shape", "tag", "mesh", "rules", "remat",
               "n_devices", "device", "trace_s", "memory", "cost",
               "collectives", "num_params", "active_params"}


@pytest.fixture
def reduced(monkeypatch):
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: real(a).reduced())
    return real


def hand_bytes(shape, dtype, axes, rules, mesh_size):
    """Bytes of one device's share: every dimension whose logical axis
    the rules place on a mesh axis, and which that axis divides, is
    split ``mesh_size`` ways (each mesh axis has that size here)."""
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    for i, name in enumerate(axes or ()):
        if name is not None and rules.get(name) is not None \
                and shape[i] % mesh_size == 0:
            n //= mesh_size
    return n


@pytest.mark.parametrize("cell", sorted(f"{a}|{s}" for a, s in FLOP_RATIO))
def test_run_cell_on_meta(cell, reduced, tmp_path):
    from repro_torch import tree as T
    from repro_torch.sharding.rules import strategy_rules
    arch, shape = cell.split("|")
    cfg = reduced(arch).reduced()
    api = get_model(cfg)
    shp = SHAPES[shape]
    tdef = T.structure(api.descs())
    p_items = list(zip(tdef.flatten_up_to(api.param_shapes()),
                       tdef.flatten_up_to(api.param_axes())))
    for mesh_shape in ((1, 1), (2, 2)):
        rec = dryrun.run_cell(arch, shape, False, tmp_path,
                              mesh_shape=mesh_shape)
        assert set(rec) == RECORD_KEYS
        assert rec["mesh"] == "x".join(map(str, mesh_shape))
        assert rec["n_devices"] == math.prod(mesh_shape)
        assert (tmp_path / f"{arch}__{shape}__{rec['mesh']}__baseline.json"
                ).is_file()
        assert rec["memory"]["temp_bytes"] is None
        assert rec["memory"]["peak_bytes"] is None
        assert rec["collectives"]["source"] == "analytic"
        assert rec["num_params"] == api.num_params()
        ratio = rec["cost"]["flops"] / rl.cell_flops(cfg, shp)["total"]
        assert ratio == pytest.approx(FLOP_RATIO[(arch, shape)], rel=0.01)
        rules = strategy_rules(dryrun.dry_mesh(shape=mesh_shape))
        k = mesh_shape[0]
        pdt = api.param_dtype
        params = sum(hand_bytes(s, pdt, a, rules, k) for s, a in p_items)
        if shp.kind == "train":
            moments = sum(hand_bytes(s, torch.float32, a, rules, k)
                          for s, a in p_items)
            batch = sum(hand_bytes(s, d, ("batch",), rules, k)
                        for s, d in api.batch_shapes(shp).values())
            expect = params + 2 * moments + 4 + batch
        else:
            B = shp.global_batch
            cache = api.init_cache(B, shp.seq_len, "meta")
            flat = T.structure(cache).flatten_up_to(api.cache_axes())
            kv = sum(hand_bytes(tuple(t.shape), t.dtype, a, rules, k)
                     for t, a in zip(T.leaves(cache), flat))
            expect = params + kv + 2 * hand_bytes((B,), torch.int64,
                                                  ("batch",), rules, k)
        assert rec["memory"]["argument_bytes"] == expect, mesh_shape


def test_dryrun_cli_reports_kernel_cells(reduced, tmp_path, capsys):
    """recurrentgemma-2b's prefill reaches the local_attention kernel,
    whose wrapper takes no meta tensor: the cell is reported and skipped,
    not failed; a cell that traces prints its line."""
    dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "prefill_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "SKIP recurrentgemma-2b x prefill_32k x 16x16: a kernel" in out
    assert "OK mamba2-2.7b x decode_32k x 16x16" in out
    assert "FAIL" not in out
