"""The port's training example (``repro_torch.examples.train_lm_extent``)
on the CPU, as ``tests/test_examples.py::test_train_example_short`` runs
the reference's: 40 steps at dim 128 (seq 64, batch 4), the save at step
0 through the CPU's backend (``lanes_ref``), the simulated preemption at
step 20 restoring it (parameters, optimizer state and the data cursor),
and the example's own "must learn" assert."""
from repro_torch.examples import train_lm_extent
from test_torch_train_step import one_thread  # noqa: F401  (autouse)


def test_train_lm_extent_short(capsys, tmp_path):
    train_lm_extent.main(["--steps", "40", "--dim", "128", "--seq", "64",
                          "--batch", "4", "--ckpt-dir", str(tmp_path),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("model qwen-mini-128: ")
    assert lines[1].startswith("step    0 loss=") and "ckpt: " in lines[1]
    assert "bit_errors=" in lines[1] and "skipped=0" in lines[1]
    assert lines[2] == "step   20 !! simulated preemption -> restore"
    assert out.count("ckpt: ") == 1
    assert lines[-1] == "OK"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000000"]
