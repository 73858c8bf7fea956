"""The port's audio family (whisper-large-v3) against the JAX reference,
float32 on the CPU.

* ``layer_norm`` (``1 + scale``, with a bias), ``sinusoid_positions``
  (the ``max(1, half - 1)`` divisor) and the per-row decode encodings at
  a few float32 ulps; the encoder at about three times its measured
  error (4.6e-6 of its largest value).
* ``prefill`` / ``decode_step`` on the reduced config at about three
  times the measured error (largest over seeds 0-3, as a fraction of the
  reference's largest value: prefill logits 1.2e-3, cache 2.6e-3, its
  first layer 3.8e-5, decode logits and the decoded column 3.2e-5; the
  random reduced stack amplifies last-bit differences about tenfold a
  layer, and the reference's own eager and jitted prefills differ by
  1.8e-4 in logits). The cross cache is as long as the frames after
  prefill and carried unchanged by decode.
* ``generate`` through the port's engine with the reference's model
  numerics: tokens, flips and errors exact, energies at rtol 1e-5.
* Continuous serving is refused by both packages: the reference's
  scheduler stops at its admission write's shape assert (the pool's
  cross cache is 1500 frames long), the port's at construction, with a
  ``ValueError`` naming the cause; the launcher's continuous modes exit
  with it.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.models import layers as jlayers
from repro.models import whisper as jw
from repro.serve import ContinuousScheduler as JSched
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve.scheduler import synthetic_requests as jsynthetic
from repro_torch import rng
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers
from repro_torch.models import whisper as tw
from repro_torch.serve import ContinuousScheduler, ServeConfig, ServingEngine
from repro_torch.serve import synthetic_requests
from repro_torch.serve.scheduler import modal_leaves
from test_torch_vlm import ModalAdapter, check_cache_tags, check_params

ARCH = "whisper-large-v3"
CPU = torch.device("cpu")
TOL = dict(enc=1.5e-5, logits=3.6e-3, cache=8e-3, layer0=1.2e-4,
           dlogits=1e-4, column=1e-4)
ULPS = 2e-6
PROMPT, NEW, FRAMES, BATCH = 12, 5, 24, 2


def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def models():
    japi = jmodel(jget(ARCH).reduced())
    api = get_model(get_config(ARCH).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    return japi, api, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_params_and_cache_tags(models):
    """The nested tree (``encoder``, ``decoder`` with ``self`` and
    ``cross``) crosses leaf for leaf; the pool's cross cache is 1500
    frames long."""
    japi, api, jp, tp = models
    check_params(ARCH, jp, tp, api)
    assert set(tp["decoder"]) >= {"self", "cross"}
    assert "self" in tp["encoder"]
    n = get_model(get_config(ARCH)).num_params()
    assert abs(n - 1.54e9) < 0.01e9
    check_cache_tags(ARCH)
    assert api.init_cache(1, 16, "meta")["cross"]["k"].shape[2] == 1500


def test_building_blocks_match():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 64)).astype(np.float32)
    s, b = (r.normal(size=(64,)).astype(np.float32) for _ in range(2))
    _close(tw.layer_norm(*map(torch.from_numpy, (x, s, b)), 1e-6),
           jw.layer_norm(*map(jnp.asarray, (x, s, b)), 1e-6), ULPS,
           "layer_norm")
    for S, D, off in ((24, 64, 0), (7, 1280, 5), (3, 2, 0)):
        _close(tlayers.sinusoid_positions(S, D, offset=off),
               jlayers.sinusoid_positions(S, D, offset=off), ULPS,
               f"sinusoid {S}x{D}")
    # the decode step's per-row encodings are the table's rows
    pos = torch.tensor([0, 7, 19])
    table = tlayers.sinusoid_positions(20, 64)
    _close(tlayers.sinusoid_at(pos, 64), table[pos], 0, "per-row")


def _batch(cfg, seed):
    r = np.random.default_rng(seed)
    toks = r.integers(0, 256, (BATCH, PROMPT))
    frames = r.normal(size=(BATCH, FRAMES, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)})


def test_encoder_matches(models):
    japi, api, jp, tp = models
    jb, tb = _batch(api.cfg, 0)
    _close(tw.encode(tp, tb["frames"], api.cfg),
           jw.encode(jp, jb["frames"], japi.cfg, remat=False),
           TOL["enc"], "encoder")


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match(models, seed):
    japi, api, jp, tp = models
    jb, tb = _batch(api.cfg, seed)
    ms = PROMPT + NEW
    jl, jc = japi.prefill(jp, jb, ms)
    tl, tc = api.prefill(tp, tb, ms)
    _close(tl, jl, TOL["logits"], "prefill logits")
    assert tc["cross"]["k"].shape[2] == FRAMES
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j, TOL["cache"], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], TOL["layer0"], f"layer 0 {path}")
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok, pos = np.array([3, 7]), np.array([PROMPT, PROMPT + 3])
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), ms)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), ms)
    _close(tl, jl, TOL["dlogits"], "decode logits")
    assert tc2["cross"]["k"] is tc["cross"]["k"]
    for (path, t), j in zip(T.flatten(tc2), jax.tree.leaves(jc2)):
        j, t = np.asarray(j), t.numpy()
        col = np.zeros(j.shape, bool)
        if path[0] == "self":
            for b, p in enumerate(pos):
                col[:, b, p % j.shape[2]] = True
            _close(t[col], j[col], TOL["column"], f"decode column {path}")
        np.testing.assert_array_equal(t[~col], j[~col], str(path))


def test_generate_with_reference_numerics_is_exact(models):
    """The launcher's ``--monolithic`` batch: tokens from ``PRNGKey(0)``,
    frames ``normal(PRNGKey(1), (B, 24, d_model))``, bit for bit the
    reference's draws."""
    japi, api, jp, _ = models
    cfg, jcfg = api.cfg, japi.cfg
    frames = modal_leaves(cfg, 1, CPU, batch=BATCH)["frames"]
    jframes = jax.random.normal(jax.random.PRNGKey(1),
                                (BATCH, FRAMES, cfg.d_model), jnp.float32)
    np.testing.assert_array_equal(frames.numpy().view(np.uint32),
                                  np.asarray(jframes).view(np.uint32))
    toks = rng.randint(rng.PRNGKey(0), (BATCH, PROMPT), 0, cfg.vocab_size)
    kw = dict(max_seq=PROMPT + NEW, max_new_tokens=NEW, backend="lanes_ref")
    jtok, ref = JEngine(jcfg, JServeConfig(**kw), params=jp).generate(
        {"tokens": jnp.asarray(toks), "frames": jframes})
    eng = ServingEngine(cfg, ServeConfig(**kw), jp, device="cpu",
                        api=ModalAdapter(cfg, ARCH))
    tok, rep = eng.generate({"tokens": torch.from_numpy(
        toks.astype(np.int64)), "frames": frames})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for s, r in ref["streams"].items():
        for k in ("bits_written", "bits_total", "bit_errors"):
            assert rep["streams"][s][k] == r[k], (s, k)
        np.testing.assert_allclose(rep["streams"][s]["energy_pj"],
                                   r["energy_pj"], rtol=1e-5)
    assert rep["streams"]["kv_prefill"]["bits_written"] > 0


def test_decode_columns_of_the_cross_cache_flip_nothing(models):
    """Each decode step writes column ``pos % T_enc`` of every leaf,
    cross included; the cross cache is unchanged, so those writes flip
    nothing: decode's bits equal a run whose cross leaves are left out."""
    _, api, _, tp = models
    cfg = api.cfg
    eng = ServingEngine(cfg, ServeConfig(max_seq=PROMPT + NEW,
                                         max_new_tokens=NEW,
                                         backend="lanes_ref"),
                        tp, device="cpu")
    batch = {"tokens": torch.from_numpy(rng.randint(
        rng.PRNGKey(0), (BATCH, PROMPT), 0, cfg.vocab_size).astype(
        np.int64)), **modal_leaves(cfg, 1, CPU, batch=BATCH)}
    key = rng.PRNGKey(3)
    vec = eng.vectors_for_floor()
    tok, cache, key, _ = eng.prefill(tp, batch, None, key, vec)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int64)
    new = api.decode_step(tp, tok, cache, pos, PROMPT + NEW)[1]
    _, st = eng.plan.write_columns(key, cache, new, pos, vec)
    cross_only = {"self": cache["self"], "cross": new["cross"]}
    _, st_cross = eng.plan.write_columns(key, cache, cross_only, pos, vec)
    assert int(st_cross.bits_written) == 0
    assert int(st.bits_written) > 0


def test_both_packages_refuse_continuous_audio(models):
    japi, api, jp, tp = models
    cfg, jcfg = api.cfg, japi.cfg
    kw = dict(max_seq=PROMPT + NEW, max_new_tokens=NEW, backend="lanes_ref")
    with pytest.raises(AssertionError):
        JSched(JEngine(jcfg, JServeConfig(**kw), params=jp),
               capacity=2).run(jsynthetic(jcfg, 2, prompt_len=PROMPT,
                                          new_tokens=NEW))
    eng = ServingEngine(cfg, ServeConfig(**kw), tp, device="cpu")
    with pytest.raises(ValueError, match="enc_len 1500"):
        ContinuousScheduler(eng, capacity=2)
    # the synthetic stream still draws the reference's frames
    reqs = synthetic_requests(cfg, 2, device=CPU, prompt_len=PROMPT)
    jreqs = jsynthetic(jcfg, 2, prompt_len=PROMPT)
    for r, j in zip(reqs, jreqs):
        assert r.modal_seed == j.modal_seed
        np.testing.assert_array_equal(r.prompt["frames"].numpy(),
                                      np.asarray(j.prompt["frames"]))


def test_launcher_refuses_continuous_audio():
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--requests", "2"])
    assert e.value.code == 2
    assert "enc_len 1500" in err.getvalue()
