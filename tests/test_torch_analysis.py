"""Fixture tests for ``repro_torch.analysis`` — each rule must fire on a
seeded violation (true positive), stay silent on conforming code (true
negative), and honor the inline waiver protocol; the twin of
``tests/test_analysis.py`` in the port's idiom (sync-free bursts, CUDA
graph captures and compiled callables in place of jit and scan bodies).

The fixtures are tiny synthetic trees under ``tmp_path`` (the engine
resolves paths against an explicit ``root``, so the zone/boundary rules
see the same ``src/repro_torch/...`` prefixes they see in the repo). The
engine-level findings are held against the reference engine's on
language-neutral fixtures. The final tests run the engine over the port
and pin its RNG registry to the reference's values.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import run_analysis as reference_analysis
from repro_torch.analysis import run_analysis
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.engine import PARSE_ERROR, WAIVER_DISCIPLINE
from repro_torch.analysis.visitors import SyncMap

REPO_ROOT = Path(__file__).resolve().parents[1]


def write_tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))


def lint(tmp_path, files, rules=None, paths=None):
    write_tree(tmp_path, files)
    return run_analysis(paths=paths or ["src"], root=tmp_path, rules=rules)


def rules_of(report):
    return sorted({f.rule for f in report.violations})


def of_rule(report, rule):
    return [f for f in report.violations if f.rule == rule]


# ------------------------------------------------------------ SyncMap
class TestSyncMap:
    def test_regions_of_each_idiom(self):
        import ast
        tree = ast.parse(textwrap.dedent("""
            import torch

            def step(x):
                return x

            def burst(dev, x):
                a = pre(x)
                with _no_host_sync(dev):
                    y = step(x)
                return a

            def pre(x):
                return x

            @torch.compile
            def compiled(x):
                return x

            def capture(g, x):
                with torch.cuda.graph(g):
                    return x + 1

            fast = torch.cuda.make_graphed_callables(pre, (1,))
        """))
        sm = SyncMap(tree)
        kinds = sorted((getattr(n, "name", type(n).__name__), k)
                       for n, k in sm.regions.items())
        # step is called from the burst's body; pre only from outside it
        # (its region comes from make_graphed_callables)
        assert kinds == [("With", "CUDA graph capture"),
                         ("With", "sync-free burst"),
                         ("compiled", "compiled callable"),
                         ("pre", "graphed callable"),
                         ("step", "sync-free burst")]
        calls = {c.func.id: c for c in ast.walk(tree)
                 if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
        # the call in the with body is in the region; the one above it
        # belongs to burst, which is not a region
        assert sm.region_of(calls["step"])[1] == "sync-free burst"
        assert sm.region_of(calls["pre"]) is None


# ------------------------------------------------------------------ R1
class TestOperandDiscipline:
    def test_fires_on_prngkey_and_literal_table_in_burst(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import torch
            from repro_torch import rng
            from repro_torch.serve.engine import _no_host_sync

            def burst(dev, x):
                with _no_host_sync(dev):
                    k = rng.PRNGKey(0)
                    t = torch.tensor([1.0, 2.0, 3.0])
                    return x * t
        """})
        msgs = [f.message for f in of_rule(rep, "operand-discipline")]
        assert len(msgs) == 2
        assert any("PRNGKey" in m for m in msgs)
        assert any("literal constant table" in m for m in msgs)

    def test_fires_on_closure_and_self_state(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import torch

            def make(scale):
                def h(x):
                    return x * torch.as_tensor(scale)
                return torch.compile(h)

            class Writer:
                def m(self, dev, x):
                    with _no_host_sync(dev):
                        return x * torch.as_tensor(self.scale)
        """})
        msgs = [f.message for f in of_rule(rep, "operand-discipline")]
        assert len(msgs) == 2
        assert any("closes over an enclosing function" in m for m in msgs)
        assert any("self" in m for m in msgs)

    def test_silent_on_operands_and_module_constants(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import torch
            from repro_torch import rng

            SCALE = [1.0, 2.0]

            @torch.compile
            def f(x, t, key):
                k2 = rng.fold_in(key, 3)
                return x * torch.as_tensor(t) * torch.as_tensor(SCALE)

            def host(scale):
                return torch.as_tensor(scale), rng.PRNGKey(0)  # host
        """})
        assert not of_rule(rep, "operand-discipline")

    def test_waiver_silences_with_justification(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            from repro_torch import rng

            def burst(dev, x):
                with _no_host_sync(dev):
                    # repro_torch: allow(operand-discipline): fixture bends it
                    k = rng.PRNGKey(0)
                    return x
        """})
        assert rep.ok
        assert len(rep.waived) == 1
        assert rep.waived[0].justification == "fixture bends it"


# ------------------------------------------------------------------ R2
class TestHostSync:
    def test_fires_inside_burst_body(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            def burst(dev, xs):
                c = 0.0
                with _no_host_sync(dev):
                    for x in xs:
                        c = c + x.item()
                return c
        """})
        v = of_rule(rep, "no-host-sync-in-burst")
        assert len(v) == 1 and ".item()" in v[0].message

    def test_fires_through_local_call_graph(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import numpy as np
            import torch

            def helper(x):
                return np.asarray(x)

            def entry(g, x):
                with torch.cuda.graph(g):
                    return helper(x)
        """})
        v = of_rule(rep, "no-host-sync-in-burst")
        assert len(v) == 1 and "np.asarray" in v[0].message

    def test_coercion_of_positional_param_kwonly_exempt(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import torch

            @torch.compile
            def f(x, *, n):
                return x * int(n) + int(x)
        """})
        v = of_rule(rep, "no-host-sync-in-burst")
        assert len(v) == 1 and "'x'" in v[0].message

    def test_fires_on_every_read_in_a_region(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import torch

            def burst(dev, x):
                with _no_host_sync(dev):
                    a = x.tolist()
                    b = x.cpu()
                    c = b.numpy()
                    torch.cuda.synchronize()
                    d = x.to("cpu")
                    print(x)
        """})
        msgs = [f.message for f in of_rule(rep, "no-host-sync-in-burst")]
        assert len(msgs) == 6
        for name in (".tolist()", ".cpu()", ".numpy()",
                     "torch.cuda.synchronize", '.to("cpu")', "print()"):
            assert any(name in m for m in msgs), name

    def test_zone_flags_host_path_read(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/sched.py": """
            def report(acc):
                return acc.cpu()
        """})
        v = of_rule(rep, "no-host-sync-in-burst")
        assert len(v) == 1 and "zero-sync serving zone" in v[0].message

    def test_silent_outside_zone_and_region(self, tmp_path):
        rep = lint(tmp_path, {"src/tools/host.py": """
            import numpy as np

            def dump(acc):
                print(np.asarray(acc.cpu()), acc.item())
        """})
        assert not of_rule(rep, "no-host-sync-in-burst")

    def test_zone_waiver(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/sched.py": """
            def report(acc):
                # repro_torch: allow(no-host-sync-in-burst): once per run
                return acc.tolist()
        """})
        assert rep.ok and len(rep.waived) == 1


# ------------------------------------------------------------------ R3
REGISTRY_FIXTURE = """
    from typing import NamedTuple

    class Stream(NamedTuple):
        name: str
        offset: int
        domain: str
        doc: str

    A_OFFSET = 1_000_003
    B_OFFSET = 1_000_003
    ORPHAN_OFFSET = 5_000

    STREAMS = (
        Stream("a", A_OFFSET, "root", "a's stream"),
        Stream("b", B_OFFSET, "root", "collides with a"),
    )
"""
REGISTRY_REL = "src/repro_torch/memory/rng_streams.py"


class TestMetricsDiscipline:
    def test_fires_on_adhoc_module_accumulator(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            TOTAL_WRITES = 0

            def record(n):
                global TOTAL_WRITES
                TOTAL_WRITES += n
        """})
        v = of_rule(rep, "metrics-discipline")
        assert len(v) == 1 and "TOTAL_WRITES" in v[0].message
        assert "registry" in v[0].message

    def test_fires_on_drain_in_sync_free_region(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            def run(dev, ins, xs):
                c = 0.0
                with _no_host_sync(dev):
                    for x in xs:
                        row = ins.drain()
                        c = c + x
                return c
        """})
        v = of_rule(rep, "metrics-discipline")
        assert len(v) == 1 and ".drain()" in v[0].message

    def test_silent_on_constants_and_host_drains(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            WRITE_LEAF_OFFSET = 0
            SCALE = 1.5

            def event(tele, clock):
                return tele.event(clock)

            def scaled(x):
                return x * SCALE
        """})
        assert "metrics-discipline" not in rules_of(rep)

    def test_waiver_suppresses(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            # repro_torch: allow(metrics-discipline): legacy counter
            HITS = 0

            def bump():
                global HITS
                HITS += 1
        """})
        assert "metrics-discipline" not in rules_of(rep)
        assert any(w.rule == "metrics-discipline" for w in rep.waived)


class TestRngStreamHygiene:
    def test_fires_on_magic_constant_and_offset_assign(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            from repro_torch import rng

            LOCAL_KEY_OFFSET = 9_000_001

            def fork(key, i):
                return rng.fold_in(key, 7_000_019 + i)
        """})
        msgs = [f.message for f in of_rule(rep, "rng-stream-hygiene")]
        assert len(msgs) == 2
        assert any("LOCAL_KEY_OFFSET" in m for m in msgs)
        assert any("7000019" in m for m in msgs)

    def test_fires_on_physical_fold(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            from repro_torch import rng

            def fork(key, phys_col):
                return rng.fold_in(key, phys_col)
        """})
        v = of_rule(rep, "rng-stream-hygiene")
        assert len(v) == 1 and "LOGICAL" in v[0].message

    def test_registry_collision_and_orphan(self, tmp_path):
        rep = lint(tmp_path, {REGISTRY_REL: REGISTRY_FIXTURE})
        msgs = [f.message for f in of_rule(rep, "rng-stream-hygiene")]
        assert len(msgs) == 2
        assert any("collides" in m for m in msgs)
        assert any("ORPHAN_OFFSET" in m for m in msgs)

    def test_unknown_registry_attribute(self, tmp_path):
        rep = lint(tmp_path, {
            REGISTRY_REL: REGISTRY_FIXTURE,
            "src/mod.py": """
                from repro_torch import rng
                from repro_torch.memory import rng_streams

                def fork(key):
                    return rng.fold_in(key, rng_streams.NOT_REAL)
            """})
        v = [f for f in of_rule(rep, "rng-stream-hygiene")
             if f.path == "src/mod.py"]
        assert len(v) == 1 and "NOT_REAL" in v[0].message

    def test_silent_on_registry_reference_and_small_folds(self, tmp_path):
        rep = lint(tmp_path, {
            REGISTRY_REL: """
                from typing import NamedTuple

                class Stream(NamedTuple):
                    name: str
                    offset: int
                    domain: str
                    doc: str

                GOOD_OFFSET = 1_000_003
                STREAMS = (Stream("good", GOOD_OFFSET, "root", "ok"),)
            """,
            "src/mod.py": """
                from repro_torch import rng
                from repro_torch.memory import rng_streams

                def fork(key, i):
                    k = rng.fold_in(key, rng_streams.GOOD_OFFSET + i)
                    return rng.fold_in(k, i)
            """})
        assert not of_rule(rep, "rng-stream-hygiene")

    def test_waiver(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            from repro_torch import rng

            def fork(key):
                # repro_torch: allow(rng-stream-hygiene): fixture constant
                return rng.fold_in(key, 7_000_019)
        """})
        assert rep.ok and len(rep.waived) == 1


# ------------------------------------------------------------------ R4
class TestRegistryDiscipline:
    def test_fires_outside_boundary(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/bad.py": """
            import repro_torch.kernels.scrub.kernel as sk
            from repro_torch.kernels.extent_write.kernel import (
                extent_write_cuda)

            def f(old, new, seed, vec):
                out = extent_write_cuda(old, new, seed, vec,
                                        use_kernel=True)
                return sk.scrub_cuda(out, interpret=False)
        """})
        msgs = [f.message for f in of_rule(rep, "registry-discipline")]
        assert len(msgs) == 6  # 2 imports + 2 kwargs + 2 direct calls
        assert any("repro_torch.kernels.extent_write.kernel" in m
                   for m in msgs)
        assert any("use_kernel" in m for m in msgs)
        assert any("interpret" in m for m in msgs)
        assert any("sk.scrub_cuda" in m for m in msgs)

    def test_fires_on_kernel_package_import(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/train/bad.py": """
            from repro_torch.kernels import extent_write, kv_quant
        """})
        v = of_rule(rep, "registry-discipline")
        assert len(v) == 1 and "repro_torch.kernels" in v[0].message

    def test_silent_inside_boundary_and_for_public_kernels(self, tmp_path):
        rep = lint(tmp_path, {
            "src/repro_torch/memory/backend.py": """
                from repro_torch.kernels.extent_write.kernel import (
                    extent_write_cuda)

                def write(old, new, seed, vec):
                    return extent_write_cuda(old, new, seed, vec)
            """,
            "src/repro_torch/serve/ok.py": """
                from repro_torch.kernels.kv_quant import ops
                from repro_torch.memory import get_backend

                def f(x):
                    return get_backend("cuda"), ops.kv_quant(x)
            """})
        assert not of_rule(rep, "registry-discipline")

    def test_waiver(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/benchmarks/bench.py": """
            # repro_torch: allow(registry-discipline): measures the kernel
            from repro_torch.kernels.extent_write.kernel import K
        """})
        assert rep.ok and len(rep.waived) == 1


# ------------------------------------------------------------------ R5
class TestTreeCarry:
    def test_fires_on_unfrozen_and_plain_carries(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import dataclasses

            @dataclasses.dataclass
            class BurstState:
                x: int

            class WriteStats:
                pass
        """})
        msgs = [f.message for f in of_rule(rep, "tree-carry-discipline")]
        assert len(msgs) == 2
        assert any("BurstState" in m and "unfrozen" in m for m in msgs)
        assert any("WriteStats" in m and "NamedTuple" in m for m in msgs)

    def test_fires_on_unfrozen_dataclass_built_in_burst(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import dataclasses

            @dataclasses.dataclass
            class Acc:
                n: int

            def burst(dev):
                with _no_host_sync(dev):
                    return Acc(0)
        """})
        v = of_rule(rep, "tree-carry-discipline")
        assert len(v) == 1 and "Acc" in v[0].message

    def test_silent_on_frozen_and_namedtuple(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import dataclasses
            from typing import NamedTuple

            @dataclasses.dataclass(frozen=True)
            class LifetimeState:
                x: int

            class OptState(NamedTuple):
                step: int

            @dataclasses.dataclass
            class Config:
                n: int

            def host():
                return Config(1)
        """})
        assert not of_rule(rep, "tree-carry-discipline")

    def test_waiver(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            import dataclasses

            @dataclasses.dataclass
            # repro_torch: allow(tree-carry-discipline): fixture mutability
            class CarryState:
                x: int
        """})
        assert rep.ok and len(rep.waived) == 1


# ------------------------------------------------------------------ R8
class TestShardLocality:
    def test_fires_on_collective_in_zone_burst(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/engine.py": """
            import torch.distributed as dist

            def burst(dev, acc):
                with _no_host_sync(dev):
                    dist.all_reduce(acc)
                return acc
        """})
        v = of_rule(rep, "shard-locality")
        assert len(v) == 1 and "dist.all_reduce" in v[0].message

    def test_fires_in_compiled_callable(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/reliability/scrub.py": """
            import torch

            def run(out, x):
                def body(x):
                    torch.distributed.all_gather(out, x)
                    return x
                return torch.compile(body)(x)
        """})
        v = of_rule(rep, "shard-locality")
        assert len(v) == 1 and "all_gather" in v[0].message

    def test_silent_on_host_paths_and_outside_zone(self, tmp_path):
        rep = lint(tmp_path, {
            # host-path reduction in the zone: the once-per-run ledger
            "src/repro_torch/serve/sched.py": """
                import torch.distributed as dist

                def merge(per_slot):
                    dist.all_reduce(per_slot)
                    return per_slot
            """,
            # a collective in a region OUTSIDE the serving zone: not this
            # rule's business
            "src/repro_torch/launch/train.py": """
                import torch
                import torch.distributed as dist

                @torch.compile
                def mean_grads(g):
                    dist.all_reduce(g)
                    return g
            """})
        assert not of_rule(rep, "shard-locality")

    def test_waiver(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/engine.py": """
            import torch.distributed as dist

            def report(dev, acc):
                with _no_host_sync(dev):
                    # repro_torch: allow(shard-locality): off the token path
                    dist.all_reduce(acc)
        """})
        assert rep.ok and len(rep.waived) == 1


# -------------------------------------------------------------- engine
class TestEngine:
    def test_unjustified_waiver_is_a_violation(self, tmp_path):
        rep = lint(tmp_path, {"src/mod.py": """
            def report(acc):
                # repro_torch: allow(no-host-sync-in-burst)
                return acc.cpu()
        """})
        assert [f.rule for f in rep.violations] == [WAIVER_DISCIPLINE]

    def test_star_waiver_covers_all_rules(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/x.py": """
            def report(acc):
                # repro_torch: allow(*): fixture silences everything
                return acc.item()
        """})
        assert rep.ok and len(rep.waived) == 1

    def test_waiver_only_covers_adjacent_line(self, tmp_path):
        rep = lint(tmp_path, {"src/repro_torch/serve/x.py": """
            # repro_torch: allow(no-host-sync-in-burst): too far away
            def report(acc):
                return acc.item()
        """})
        assert len(rep.violations) == 1

    def test_reference_waivers_do_not_cover(self, tmp_path):
        """The two linters' waivers never cover each other."""
        rep = lint(tmp_path, {"src/repro_torch/serve/x.py": """
            def report(acc):
                # repro: allow(no-host-sync-in-burst): the other linter's
                return acc.item()
        """})
        assert len(rep.violations) == 1 and not rep.waived

    def test_parse_error_is_reported_not_fatal(self, tmp_path):
        rep = lint(tmp_path, {"src/bad.py": "def broken(:\n"})
        assert [f.rule for f in rep.violations] == [PARSE_ERROR]

    def test_rule_subset_and_unknown_rule(self, tmp_path):
        files = {"src/repro_torch/serve/bad.py": """
            from repro_torch.kernels.extent_write.ops import extent_write

            def f(acc):
                return acc.cpu()
        """}
        rep = lint(tmp_path, files, rules=["registry-discipline"])
        assert rules_of(rep) == ["registry-discipline"]
        with pytest.raises(KeyError):
            lint(tmp_path, {}, rules=["not-a-rule"])

    def test_default_paths_walk_the_port_only(self, tmp_path):
        write_tree(tmp_path, {
            "src/repro_torch/serve/x.py": "def f(a):\n    return a.item()\n",
            "src/repro/serve/x.py": "def f(a):\n    return a.item()\n"})
        rep = run_analysis(root=tmp_path)
        assert [f.path for f in rep.violations] == [
            "src/repro_torch/serve/x.py"]


#: language-neutral fixtures: (files with a ``{marker}`` for the waiver
#: comment, rules to run); both engines must report the same findings
NEUTRAL = {
    "parse_error": ({"src/bad.py": "def broken(:\n"}, None),
    "unjustified_waiver": ({"src/mod.py": """
        # {marker}: allow(metrics-discipline)
        X = 1
    """}, None),
    "adjacent_line_waiver": ({"src/mod.py": """
        # {marker}: allow(metrics-discipline): two lines up
        COUNT = 0

        def bump():
            global COUNT
            COUNT += 1
    """}, ["metrics-discipline"]),
    "accumulator_waived": ({"src/mod.py": """
        # {marker}: allow(metrics-discipline): fixture
        COUNT = 0

        def bump():
            global COUNT
            COUNT += 1
    """}, ["metrics-discipline"]),
}


@pytest.mark.parametrize("case", sorted(NEUTRAL))
def test_engine_findings_equal_the_reference_engines(tmp_path, case):
    files, rules = NEUTRAL[case]

    def findings(marker, run, sub):
        root = tmp_path / sub
        write_tree(root, {rel: text.replace("{marker}", marker)
                          for rel, text in files.items()})
        rep = run(paths=["src"], root=root, rules=rules)
        return [(f.rule, f.path, f.line, f.col, f.waived, f.justification)
                for f in rep.findings]

    port = findings("repro_torch", run_analysis, "port")
    ref = findings("repro", reference_analysis, "ref")
    assert port == ref
    assert port, case


def test_unknown_rule_raises_in_both_engines(tmp_path):
    for run in (run_analysis, reference_analysis):
        with pytest.raises(KeyError, match="unknown rule"):
            run(paths=["src"], root=tmp_path, rules=["not-a-rule"])


# ----------------------------------------------------------------- CLI
class TestCli:
    def _tree(self, tmp_path, text):
        p = tmp_path / "src" / "repro_torch" / "mod.py"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
        return tmp_path

    def test_exit_zero_on_clean_tree(self, tmp_path, capsys):
        root = self._tree(tmp_path, "X = 1\n")
        assert analysis_main(["--root", str(root)]) == 0
        assert "0 violation(s)" in capsys.readouterr().out

    def test_exit_one_on_violation_and_json_artifact(self, tmp_path,
                                                     capsys):
        root = self._tree(tmp_path, """
            import torch
            from repro_torch import rng

            @torch.compile
            def f(x):
                return rng.PRNGKey(0)
        """)
        out = tmp_path / "report.json"
        assert analysis_main(["--root", str(root),
                              "--json", str(out)]) == 1
        data = json.loads(out.read_text())
        assert data["counts"]["violations"] == 1
        assert data["violations"][0]["rule"] == "operand-discipline"

    def test_exit_two_on_unknown_rule(self, tmp_path, capsys):
        root = self._tree(tmp_path, "X = 1\n")
        assert analysis_main(["--root", str(root),
                              "--rule", "not-a-rule"]) == 2


def test_linter_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "for n in ('torch', 'jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[n] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['--list-rules']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO_ROOT,
                         env={"PYTHONPATH": str(REPO_ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert len(out.stdout.strip().splitlines()) == 7


# ---------------------------------------------------------- this repo
class TestRepoInvariants:
    def test_repo_is_clean(self):
        """The gate: the engine over src/repro_torch reports zero
        unwaived violations, and every waiver carries a justification."""
        rep = run_analysis(root=REPO_ROOT)
        assert rep.ok, "\n".join(f.location + " " + f.message
                                 for f in rep.violations)
        assert all(f.justification for f in rep.waived)
        assert len(rep.files) > 100

    def test_rng_registry_values_are_pinned(self):
        """The port's constants are the reference's pinned values: the
        RNG schedule, and with it every bit-parity contract."""
        from repro.memory import rng_streams as ref
        from repro_torch.memory import rng_streams as rs
        rs.validate()
        assert rs.WRITE_LEAF_OFFSET == 0
        assert rs.SOFT_ERROR_OFFSET == 1_000_003
        assert rs.RETENTION_OFFSET == 2_000_003
        assert rs.SCRUB_OFFSET == 3_000_017
        assert rs.SCHEDULER_SCRUB_PASS_OFFSET == 1_000_000
        assert rs.CHECKPOINT_RESTORE_OFFSET == 4_000_037
        assert rs.RESTORE_SCRUB_OFFSET == 1_000_003
        assert rs.WORKLOAD_OFFSET == 5_000_011
        assert rs.INDEX_SPAN == 1_000_000
        for s in rs.STREAMS:
            r = {x.name: x for x in ref.STREAMS}[s.name]
            assert (s.offset, s.domain, s.span) == (r.offset, r.domain,
                                                    r.span)
