"""Reduced h2o-danube-1.8b served by the port against the JAX reference on a
trace whose prompts and decodes wrap the reduced window's ring, the
launcher on that trace, and the port's decode after the wrap against a
prefill (torch_wide_serving holds the trace and the bounds)."""
import pytest

from torch_threads import one_thread  # noqa: F401  (autouse)
from torch_wide_serving import (check_decode_after_wrap, check_exact,
                                serve_both, write_trace)

ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = write_trace(tmp_path_factory.mktemp("trace") / "t.jsonl", ARCH)
    return (path, *serve_both(ARCH, path))


def test_serving_with_reference_numerics_is_exact(served):
    _, ref, rep = served
    check_exact(ref, rep)


def test_decode_after_the_ring_wraps_matches_a_prefill():
    check_decode_after_wrap(ARCH)


def test_launcher_on_cpu(served, capsys):
    """``python -m repro_torch.launch.serve --arch h2o-danube-1.8b --reduced
    --device cpu`` replays the trace to the reference's step and burst
    counts."""
    from repro_torch.launch import serve
    path, ref, _ = served
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--trace",
                str(path), "--capacity", "2"])
    out = capsys.readouterr().out
    assert (f"served 4 requests in {ref['clock_steps']} steps "
            f"({ref['bursts']} compiled decode bursts") in out
