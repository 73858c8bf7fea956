"""The port's dense model against the JAX reference, parameters moved
across with ``repro_torch.convert.params_from_jax``.

Tolerances, float32 on the CPU, as a fraction of the largest reference
value: the two packages round differently in the last bit (XLA's
reduction order and its exp/rsqrt kernels against torch's), and a
randomly initialised stack amplifies those bits layer by layer (about
10x per layer at one position of qwen2.5-3b's prompt). Each architecture
is held at about three times its own largest error, measured over XLA's
and torch's default and single-threaded CPU runs; the first layer's
cache, which no earlier layer amplifies, is held at a few ulps, so a
norm epsilon or a rope detail that is wrong shows there. Cache entries a
decode step does not write are bit-identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model

#: per architecture, as fractions of the largest reference value: prefill
#: logits, prefill cache, its first layer, decode logits, decode column.
#: Largest measured errors, in that order:
#:   qwen2.5-3b        4.2e-6  1.8e-4  2.1e-7  4.3e-6  1.5e-6
#:   h2o-danube-1.8b   7.8e-5  1.7e-5  1.9e-7  1.2e-5  7.6e-6
#:   gemma2-9b         2.2e-5  1.8e-5  2.2e-6  8.0e-5  2.4e-5
#:   mistral-nemo-12b  7.0e-6  7.3e-6  1.9e-7  1.6e-6  1.0e-6
TOL = {
    "qwen2.5-3b": dict(logits=1.5e-5, cache=5e-4, layer0=6e-7,
                       dlogits=1.5e-5, column=5e-6),
    "h2o-danube-1.8b": dict(logits=2.5e-4, cache=5e-5, layer0=6e-7,
                            dlogits=4e-5, column=2.5e-5),
    "gemma2-9b": dict(logits=7e-5, cache=6e-5, layer0=7e-6,
                      dlogits=2e-4, column=7e-5),
    "mistral-nemo-12b": dict(logits=2e-5, cache=2.5e-5, layer0=6e-7,
                             dlogits=5e-6, column=3e-6),
}
ARCHS = list(TOL)
MAX_SEQ = 20


def _close(port, ref, frac, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=frac * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    japi = jmodel(jget(arch).reduced())
    api = get_model(get_config(arch).reduced())
    jp = japi.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return japi, api, jp, tp, TOL[arch]


def test_params_convert_exactly(models):
    _, _, jp, tp, _ = models
    for (path, t), j in zip(T.flatten(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), str(path))


def test_prefill_logits_and_caches(models):
    japi, api, jp, tp, tol = models
    toks = np.random.default_rng(0).integers(0, 256, (2, 12))
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                          MAX_SEQ)
    tl, tc = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl, tol["logits"], "prefill logits")
    assert [p for p, _ in T.flatten(tc)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(jc)[0]]
    for (path, t), j in zip(T.flatten(tc), jax.tree.leaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(t, j, tol["cache"], f"prefill cache {path}")
        _close(t[0], np.asarray(j)[0], tol["layer0"],
               f"prefill cache {path}, first layer")


@pytest.mark.parametrize("pos", [[12, 12], [12, 19], [20, 25]])
def test_decode_step_same_cache(models, pos):
    """One decode step from the reference's own cache: logits close, the
    written ring column close, every other entry bit-identical. Position
    20 and 25 wrap the capacity-20 ring."""
    japi, api, jp, tp, tol = models
    toks = np.random.default_rng(1).integers(0, 256, (2, 12))
    _, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         MAX_SEQ)
    tc = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jc)
    tok = np.array([3, 7])
    pos = np.array(pos)
    jl, jc2 = japi.decode_step(jp, jnp.asarray(tok, jnp.int32), jc,
                               jnp.asarray(pos, jnp.int32), MAX_SEQ)
    tl, tc2 = api.decode_step(tp, torch.from_numpy(tok), tc,
                              torch.from_numpy(pos), MAX_SEQ)
    _close(tl, jl, tol["dlogits"], "decode logits")
    for (path, t), j, t0 in zip(T.flatten(tc2), jax.tree.leaves(jc2),
                                T.leaves(tc)):
        j = np.asarray(j)
        col = np.zeros(j.shape, bool)
        for b, p in enumerate(pos):
            col[:, b, p % j.shape[2]] = True
        t = t.numpy()
        np.testing.assert_array_equal(t[~col], j[~col], str(path))
        np.testing.assert_array_equal(t[~col], t0.numpy()[~col])
        np.testing.assert_allclose(t[col], j[col], rtol=0,
                                   atol=tol["column"] * np.abs(j).max())


def test_other_families_raise():
    """Every family the reference serves is served; a family neither
    package knows raises the reference's ValueError."""
    get_model(get_config("mamba2-2.7b").reduced())
    with pytest.raises(ValueError):
        get_model(dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                                      family="bogus"))
