"""The port's benchmark modules run alone, as the reference's do:
``python -m repro_torch.benchmarks.<name>`` with the reference module's
flags plus ``--device``. Each parser is held against the flags the
reference's ``__main__`` block adds (read from its source), and the
cheap modules' ``main`` (``table1``, ``fig6_thermal``) against the
reference's printout, line for line."""
import ast
import importlib
from pathlib import Path

import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(p.stem for p in (ROOT / "benchmarks").glob("*.py")
                 if p.stem not in ("__init__", "run"))


def reference_flags(name: str) -> set:
    """The option strings of every ``add_argument`` call in the
    reference module."""
    tree = ast.parse((ROOT / "benchmarks" / f"{name}.py").read_text())
    return {a.value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "add_argument"
            for a in node.args if isinstance(a, ast.Constant)}


def test_every_reference_module_has_a_twin():
    assert len(MODULES) == 15
    for name in MODULES:
        assert (ROOT / "src" / "repro_torch" / "benchmarks"
                / f"{name}.py").is_file(), name


@pytest.mark.parametrize("name", MODULES)
def test_parser_takes_the_reference_flags_and_device(name):
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    flags = {s for a in mod.parser()._actions for s in a.option_strings}
    assert flags == reference_flags(name) | {"-h", "--help", "--device"}
    args = mod.parser().parse_args(["--device", "cpu"])
    assert args.device == "cpu"
    if "--fast" in flags:
        assert mod.parser().parse_args(["--fast"]).fast
    tree = ast.parse(Path(mod.__file__).read_text())
    guard = [n for n in tree.body if isinstance(n, ast.If)
             and ast.unparse(n.test) == "__name__ == '__main__'"]
    assert guard and ast.unparse(guard[0].body[0]) == "main()", name


@pytest.mark.parametrize("name", ["table1", "fig6_thermal"])
def test_main_prints_what_the_reference_prints(name, capsys):
    jmod = importlib.import_module(f"benchmarks.{name}")
    jmod.main()
    ref = capsys.readouterr().out
    importlib.import_module(f"repro_torch.benchmarks.{name}").main(
        ["--device", "cpu"])
    assert capsys.readouterr().out == ref


def test_main_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks import table1
    with pytest.raises(RuntimeError, match="CUDA"):
        table1.main([])
