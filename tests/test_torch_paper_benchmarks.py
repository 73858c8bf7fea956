"""The port's paper benchmarks (``repro_torch.benchmarks``) against the
reference modules' ``run()`` at the reference runner's ``--fast`` sizes,
key for key, and the port's runner end to end.

Tolerances (each beside its assertion):
  * values priced with the driver's level table (Table 1's claims, Fig.
    14, Fig. 12's latencies): ``TABLE_RTOL`` = 1e-6, because the
    reference's process calibrates whichever of its two tables it asks
    for first (last-bit differences);
  * Fig. 12's energies: ``ORACLE_ENERGY_RTOL`` = 1e-5, the reference
    oracle's float32 sum against the port's float64 one (flips and errors
    are exact);
  * values the reference rounds for display (Fig. 14's rows to 4 digits,
    Fig. 16's stds to 3, Table 1's EXTENT row): one unit of that digit;
  * Fig. 15's summaries: ``SUMMARY_RTOL`` = 1e-6 (float64 against XLA's
    float32 sums; the samples are bit-equal);
  * Fig. 2's Monte-Carlo WERs: differing switching decisions counted
    (none at these seeds; sin/cos are not XLA's), the Eq. 1 WERs equal.
"""
import json

import numpy as np
import pytest

from benchmarks import (fig2_switching as jfig2, fig6_thermal as jfig6,
                        fig12_waveform as jfig12, fig14_energy as jfig14,
                        fig15_variation as jfig15, table1 as jtable1)
from repro_torch.benchmarks import (fig2_switching, fig6_thermal,
                                    fig12_waveform, fig14_energy,
                                    fig15_variation, run as runner, table1)

CPU = "cpu"
TABLE_RTOL = 1e-6
ORACLE_ENERGY_RTOL = 1e-5
SUMMARY_RTOL = 1e-6
FIG2_DECISIONS_DIFFERING = 0


def _close(a, b, rtol=0.0, atol=0.0):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _close(a[k], b[k], rtol, atol)
    elif isinstance(a, (bool, str)) or isinstance(b, (bool, str)):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_table1_matches():
    port, ref = table1.run(device=CPU), jtable1.run()
    _close(port["claims"], ref["claims"], rtol=TABLE_RTOL)
    assert [r["scheme"] for r in port["rows"]] == [
        r["scheme"] for r in ref["rows"]]
    for a, b in zip(port["rows"], ref["rows"]):
        assert list(a) == list(b)
        # the EXTENT row is rounded for display: one unit of the digit
        _close(a, b, atol=0.1)
    c = port["claims"]
    np.testing.assert_allclose(c["energy_saving_vs_ranjan"], 0.3304,
                               atol=0.005)
    np.testing.assert_allclose(c["latency_saving_vs_quark"], 0.0547,
                               atol=0.005)
    np.testing.assert_allclose(c["area_overhead_vs_cast"], 0.037, atol=0.003)


def test_fig2_switching_matches():
    port, ref = fig2_switching.run(n_mc=32, device=CPU), jfig2.run(n_mc=32)
    assert list(port) == list(ref)
    assert port["monotone"] == ref["monotone"]
    for k in ref:
        if k.startswith("I="):
            assert port[k]["eq1_wer"] == ref[k]["eq1_wer"]
            differing = round(abs(port[k]["mc_wer"] - ref[k]["mc_wer"]) * 32)
            assert differing <= FIG2_DECISIONS_DIFFERING
    assert port["us_per_call"] > 0


def test_fig6_thermal_equal():
    # bit-equal closed forms
    assert fig6_thermal.run(device=CPU) == jfig6.run()


def test_fig12_waveform_matches():
    port, ref = fig12_waveform.run(device=CPU), jfig12.run()
    assert port["checks"] == ref["checks"]
    assert all(port["checks"].values())
    for a, b in zip(port["events"], ref["events"]):
        assert list(a) == list(b)
        for k in ("event", "level", "bits_flipped", "bit_errors"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["energy_pj"], b["energy_pj"],
                                   rtol=ORACLE_ENERGY_RTOL)
        np.testing.assert_allclose(a["latency_ns"], b["latency_ns"],
                                   rtol=TABLE_RTOL)


def test_fig14_energy_matches():
    port, ref = fig14_energy.run(device=CPU), jfig14.run()
    assert list(port) == list(ref)
    _close(port["normalized_energy"], ref["normalized_energy"], atol=1e-4)
    for k in ("mean_saving_vs_basic", "mean_saving_vs_best_sota"):
        _close(port[k], ref[k], rtol=TABLE_RTOL)
    assert port["ordering_holds_all_workloads"] is True
    assert ref["ordering_holds_all_workloads"] is True


def test_fig15_variation_matches():
    port, ref = fig15_variation.run(n=200, device=CPU), jfig15.run(n=200)
    assert list(port) == list(ref)
    for k in ("fig15_full_write_energy", "fig15_approx_write_energy",
              "wer_exact_under_pv", "wer_low_under_pv"):
        _close(port[k], ref[k], rtol=SUMMARY_RTOL)
    # stds rounded to 3 digits by the benchmark
    _close(port["fig16_energy_std_vs_vdd_sigma"],
           ref["fig16_energy_std_vs_vdd_sigma"], atol=1e-3)
    assert port["fig15_claim_approx_spread_lower"] is True
    assert ref["fig15_claim_approx_spread_lower"] is True
    assert port["n_samples"] == ref["n_samples"] == 200


def test_runner_writes_report(tmp_path, capsys):
    assert runner.main(["--device", CPU, "--fast",
                        "--out-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,seconds,key_results"
    assert [l.split(",")[0] for l in lines[1:7]] == list(runner.BENCHES)
    report = json.loads((tmp_path / "BENCH_1.json").read_text())
    assert report["suite"] == "extent-repro-torch-benchmarks"
    assert report["device"] == CPU and report["fast"] is True
    assert set(report["benchmarks"]) == set(runner.BENCHES)
    m = report["benchmarks"]["table1"]["metrics"]
    np.testing.assert_allclose(m["claims.energy_saving_vs_ranjan"], 0.3304,
                               atol=0.005)
    assert report["benchmarks"]["fig15_variation"]["metrics"][
        "fig15_claim_approx_spread_lower"] is True
    assert runner.main(["--device", CPU, "--fast", "--only", "table1",
                        "--out-dir", str(tmp_path)]) == 0
    assert (tmp_path / "BENCH_2.json").exists()


def test_runner_without_device_targets_cuda(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.main(["--fast", "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        fig15_variation.run(n=8)
