"""The port's local_attention entry point against the JAX reference's.

On CPU tensors ``repro_torch.kernels.local_attention.local_attention``
runs the kernel's plain version (the CUDA kernel itself is held against
it on the card by ``chip_smoke.py``). The reference runs as its own tests
run it: the Pallas kernel in interpret mode. Inputs are drawn with numpy
from fixed seeds. Tolerances are the reference test's: atol 2e-5 in
float32 and 3e-2 in bfloat16 (the plain version rounds the probabilities
to bfloat16 before the weighted sum; the Pallas kernel keeps them in
float32)."""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_attention import local_attention as jlocal
from repro_torch.kernels.local_attention import (kernel, local_attention,
                                                 local_attention_ref)


def _qkv(B, S, H, Kh, h, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, h), (B, S, Kh, h), (B, S, Kh, h))]


def _both(arrays, dtype, window, softcap=0.0, **tiles):
    """(port output, reference output) as float32 numpy arrays."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    out = local_attention(*(torch.from_numpy(a).to(dtype) for a in arrays),
                          window=window, softcap=softcap)
    ref = jlocal(*(jnp.asarray(a).astype(jd) for a in arrays),
                 window=window, softcap=softcap, **tiles)
    assert out.dtype == dtype and tuple(out.shape) == ref.shape
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("window", [64, 100, 128, 10_000])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_matches_reference_f32(window, heads):
    H, Kh = heads
    out, ref = _both(_qkv(2, 256, H, Kh, 32, seed=window + H * 10 + Kh),
                     torch.float32, window, bq=128, bk=64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_softcap():
    out, ref = _both(_qkv(1, 256, 4, 2, 32, seed=7), torch.float32, 128,
                     softcap=50.0, bq=128, bk=64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_bf16():
    out, ref = _both(_qkv(1, 256, 4, 2, 64, seed=8), torch.bfloat16, 128,
                     bq=128, bk=64)
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-2)


def test_ragged_sequence():
    """S = 96 divides no tile of the reference's defaults (it falls back
    to one q tile); the window cuts the band."""
    out, ref = _both(_qkv(1, 96, 2, 1, 16, seed=12), torch.float32, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_head_dim_256_one_kv_head():
    """recurrentgemma's attention: head_dim 256, MQA, window < S."""
    out, ref = _both(_qkv(1, 128, 2, 1, 256, seed=13), torch.float32, 48,
                     bq=64, bk=32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_reduced_hybrid_shape():
    """The reduced hybrid's prefill: 24 tokens, 4 heads over 1 KV head of
    16, window 16."""
    out, ref = _both(_qkv(2, 24, 4, 1, 16, seed=14), torch.float32, 16)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_window_at_least_sequence_is_full_causal():
    a = [torch.from_numpy(x) for x in _qkv(1, 40, 2, 1, 16, seed=15)]
    torch.testing.assert_close(local_attention(*a, window=10_000),
                               local_attention(*a, window=40), rtol=0,
                               atol=0)


def test_cpu_runs_the_plain_version_without_a_launch():
    a = [torch.from_numpy(x) for x in _qkv(1, 40, 4, 2, 16, seed=16)]
    before = kernel.local_attention_cuda.launches
    out = local_attention(*a, window=8, softcap=5.0)
    assert kernel.local_attention_cuda.launches == before
    torch.testing.assert_close(
        out, local_attention_ref(*a, window=8, softcap=5.0), rtol=0, atol=0)


def test_wrapper_never_takes_the_plain_version_off_cpu():
    x = torch.empty((1, 8, 2, 16), device="meta")
    before = kernel.local_attention_cuda.launches
    with pytest.raises(ValueError, match="unsupported device"):
        kernel.local_attention_cuda(x, x, x, window=4)
    assert kernel.local_attention_cuda.launches == before


def test_entry_point_checks_shapes():
    q = torch.zeros((1, 8, 3, 16))
    kv = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="query heads"):
        local_attention(q, kv, kv, window=4)
    with pytest.raises(ValueError, match="window"):
        local_attention(kv, kv, kv, window=0)


@pytest.mark.parametrize("case", [(1, 128, 2, 1, 256, 48, 0.0, 1.0),
                                  (2, 256, 8, 2, 64, 100, 50.0, 8.0)],
                         ids=["mqa_h256", "gqa_softcap"])
def test_bf16_float32_plain_within_one_ulp_of_reference_kernel(case):
    """The bf16 criterion ``chip_smoke.py`` holds the CUDA kernel to: the
    plain version run in float32 on the bf16 inputs and rounded to bf16
    is within 1e-4 + 2^-7 |value| (one bf16 ulp) of the reference's
    Pallas kernel, which also keeps the probabilities in float32."""
    B, S, H, Kh, h, window, cap, q_scale = case
    q, k, v = _qkv(B, S, H, Kh, h, seed=15 + h)
    q = q * q_scale
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = local_attention_ref(*(t.float() for t in bf), window=window,
                              softcap=cap).to(torch.bfloat16).float().numpy()
    ref = np.asarray(jlocal(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in (q, k, v)),
                            window=window, softcap=cap, bq=64, bk=32),
                     np.float32)
    assert np.all(np.abs(out - ref) <= 1e-4 + 2.0 ** -7 * np.abs(ref))


# ---- the routes of csrc/local_attention.cu ----

ROOT = Path(__file__).resolve().parents[1]


def _c_route_rule():
    """The bf16 widths the C dispatch sends to the wgmma kernel, read from
    ``route`` in csrc/local_attention.cu."""
    src = (ROOT / "src/repro_torch/csrc/local_attention.cu").read_text()
    body = re.search(r"int route\(int is_bf16, int h\) \{(.*?)\n\}", src,
                     re.S).group(1)
    return tuple(int(w) for w in re.findall(r"h == (\d+)", body))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route_cases():
    """(dtype, h) of every model configuration and every on-card case."""
    from repro_torch.configs import ARCHS, get_config
    hs = {get_config(a).head_dim for a in ARCHS} - {0}
    hs |= {c[5] for c in _chip_smoke().att_cases()}
    return sorted((dt, h) for h in hs for dt in ("float32", "bfloat16"))


@pytest.mark.parametrize("dtype,h", _route_cases())
def test_route_is_the_c_dispatch(dtype, h):
    widths = _c_route_rule()
    want = ("cuda_cores" if dtype == "float32" else
            "wgmma_tma" if h in widths else "mma_sync")
    assert kernel.route(getattr(torch, dtype), h) == want
    assert widths == kernel.WGMMA_WIDTHS


@pytest.mark.parametrize("route,h", [("cuda_cores", None),
                                     ("mma_sync", None),
                                     ("wgmma_tma", 64), ("wgmma_tma", 128),
                                     ("wgmma_tma", 256)])
def test_every_route_and_wgmma_width_has_a_chip_case(route, h):
    cases = _chip_smoke().att_cases()
    hit = [c for c in cases
           if kernel.route(getattr(torch, c[7]), c[5]) == route
           and (h is None or c[5] == h)]
    assert hit, (route, h)


@pytest.mark.parametrize("case", [
    # B, S, H, Kh, h, window, softcap, q scale, reference tiles (bq, bk)
    (1, 192, 4, 2, 64, 100, 0.0, 1.0, 64, 32),
    (1, 256, 10, 1, 64, 72, 30.0, 8.0, 128, 64),
    (1, 256, 10, 1, 128, 100, 30.0, 8.0, 128, 64),
    (2, 192, 4, 2, 128, 40, 0.0, 1.0, 64, 32),
    (1, 192, 10, 1, 256, 100, 0.0, 1.0, 64, 32),
    (2, 256, 4, 2, 256, 200, 30.0, 8.0, 128, 64),
], ids=["h64_gqa2_s192", "h64_gqa10_softcap", "h128_gqa10_softcap",
        "h128_b2_gqa2_s192", "h256_gqa10_s192", "h256_b2_gqa2_softcap"])
def test_bf16_at_wgmma_widths_matches_reference(case):
    """The plain version at the wgmma route's head widths against the
    reference's Pallas kernel in interpret mode, bf16, within the
    reference's bf16 tolerance: ragged S (192 is no multiple of 128),
    windows that are no multiple of the 64-key tile, GQA 10:1 and 2:1,
    the softcap on."""
    B, S, H, Kh, h, window, cap, q_scale, bq, bk = case
    q, k, v = _qkv(B, S, H, Kh, h, seed=40 + h + S + H)
    out, ref = _both([q * q_scale, k, v], torch.bfloat16, window,
                     softcap=cap, bq=bq, bk=bk)
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-2)
