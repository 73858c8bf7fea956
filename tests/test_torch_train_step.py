"""The port's training forward and train step against the JAX reference,
float32 on the CPU: the port's seeded parameters and a seeded smoke
batch of the reference test's shapes (``_smoke_torch``) fed to both
packages (JAX gets them as arrays; the JAX package initialises nothing,
which keeps one JAX compile per configuration).

Per family, one reduced config each (dense, moe and vlm here; hybrid,
ssm and audio in ``test_torch_train_families.py``): ``forward_hidden``'s
hidden states, ``lb_loss`` (the transformer families), ``loss_fn``'s
total and CE, and the gradient of every leaf against
``jax.value_and_grad``. Each is held at about three times its measured
error, the largest over seeds 0-3 (``TOL`` lists them):

* hidden states, as a fraction of the reference's largest value: the
  random reduced stack amplifies last-bit differences about tenfold a
  layer, as in ``test_torch_models.py``;
* the loss and the CE, relative;
* each gradient leaf, as a fraction of that leaf's largest reference
  value. The largest differences sit in leaves whose true gradient is
  cancellation: the attention key bias (softmax is invariant to it;
  qwen2.5-3b 1.8e-2) and whisper's encoder keys and norms. That is
  float32 noise, not the port's: evaluated in float64, whisper's
  gradients (the reference's init, seed 0) lie 0.069 from the port's
  float32 ones and 0.139 from the reference's.

``chunked_ce_loss`` on the same hidden states is held at 2e-6 relative,
a chunk that divides the sequence and one that does not, with IGNOREd
labels. Remat ``True``, ``"selective"`` and ``False`` give bit-identical
gradients; the selective policy saves exactly the weight products
(``aten.mm``, 7 a transformer layer). Last, a port-only twin of
``test_models_smoke.py::test_one_train_step`` over all ten
architectures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as tckpt

from repro.configs import get_config as jget
from repro.models import get_model as jmodel
from repro.train import train_step as jts
from repro_torch import tree as T
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.priority import keystr
from repro_torch.models import get_model, layers
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as tts

CPU = torch.device("cpu")
#: (hidden-state fraction, loss relative, gradient leaf fraction), ~3x
#: the largest measured over seeds 0-3:
#:   qwen2.5-3b             5.2e-4  2.9e-6  1.8e-2
#:   dbrx-132b              2.1e-4  1.6e-6  2.7e-3   (lb_loss 2.3e-7)
#:   recurrentgemma-2b      2.0e-5  4.1e-7  2.6e-4
#:   mamba2-2.7b            9.9e-6  1.3e-7  3.6e-5
#:   llava-next-mistral-7b  5.2e-4  2.1e-6  4.4e-3
#:   whisper-large-v3       2.5e-3  3.3e-5  6.3e-2
TOL = {
    "qwen2.5-3b": (1.5e-3, 9e-6, 5.4e-2),
    "dbrx-132b": (6.3e-4, 5e-6, 8e-3),
    "recurrentgemma-2b": (6e-5, 1.2e-6, 7.7e-4),
    "mamba2-2.7b": (3e-5, 3.8e-7, 1.1e-4),
    "llava-next-mistral-7b": (1.5e-3, 6.2e-6, 1.3e-2),
    "whisper-large-v3": (7.5e-3, 1e-4, 0.19),
}
LB_RTOL = 7e-7
CE_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tiny models: the suite runs
    on several workers at once, where torch's default thread pool (one
    thread a core, in every worker) stalls each small op at its
    barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
#: the families whose forward returns the MoE aux
LB_FAMILIES = ("dense", "moe", "vlm")


def _smoke_torch(cfg, seed):
    """A seeded smoke batch of the reference test's shapes (B 2, S 32;
    whisper 16 decoder tokens over 32 frames; llava's labels over the
    image positions too)."""
    g = torch.Generator().manual_seed(seed)
    B, S = 2, 32
    if cfg.family == "audio":
        return {"frames": torch.randn(B, S, cfg.d_model, generator=g),
                "tokens": torch.randint(0, cfg.vocab_size, (B, 16),
                                        generator=g),
                "labels": torch.randint(0, cfg.vocab_size, (B, 16),
                                        generator=g)}
    if cfg.family == "vlm":
        n_txt = S - cfg.num_image_tokens
        return {"image_embeds": torch.randn(B, cfg.num_image_tokens,
                                            cfg.vision_dim, generator=g),
                "tokens": torch.randint(0, cfg.vocab_size, (B, n_txt),
                                        generator=g),
                "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g)}
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.cat([toks[:, 1:], torch.full((B, 1), tts.IGNORE)], 1)
    return {"tokens": toks, "labels": labels}


def to_jax(tree):
    """A tree of CPU tensors -> JAX arrays (int64 ids as int32)."""
    def one(x):
        a = x.numpy()
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
    return jax.tree.map(one, tree)


def build_family(arch: str, seed: int = 0):
    """Seed ``seed``'s parameters and batch through both packages: one
    JAX compile (loss, aux, hidden states, gradients)."""
    api = get_model(get_config(arch).reduced())
    japi = jmodel(jget(arch).reduced())
    tp = api.init(seed, CPU)
    tb = _smoke_torch(api.cfg, seed + 1)

    def total(p, b):
        h, aux = japi.forward_hidden(p, b)
        loss, count = jts.chunked_ce_loss(japi, p, h, b["labels"])
        tot = loss + (jts.LB_LOSS_COEF * aux["lb_loss"] if "lb_loss" in aux
                      else 0.0)
        return tot, {"ce_loss": loss, "tokens": count, "h": h, **aux}

    (jl, jaux), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(
        to_jax(tp), to_jax(tb))
    return dict(arch=arch, api=api, tp=tp, tb=tb, jl=float(jl),
                jaux=jax.tree.map(np.asarray, jaux),
                jg=jax.tree.map(np.asarray, jg))


@pytest.fixture(scope="module", params=["qwen2.5-3b", "dbrx-132b",
                                        "llava-next-mistral-7b"])
def family(request):
    return build_family(request.param)


def _frac(port, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(port, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def check_hidden_states_and_aux(f):
    h_tol = TOL[f["arch"]][0]
    h, aux = f["api"].forward_hidden(f["tp"], f["tb"])
    assert tuple(h.shape) == f["jaux"]["h"].shape
    assert _frac(h.detach(), f["jaux"]["h"]) < h_tol
    assert set(aux) == ({"lb_loss"} if f["api"].cfg.family in LB_FAMILIES
                        else set())
    if "lb_loss" in aux:
        np.testing.assert_allclose(float(aux["lb_loss"]),
                                   f["jaux"]["lb_loss"], rtol=LB_RTOL,
                                   atol=1e-30)
        if f["arch"] == "dbrx-132b":
            assert float(aux["lb_loss"]) > 0


def check_loss_and_gradients(f):
    _, loss_rtol, g_tol = TOL[f["arch"]]
    loss, aux, grads = tts.value_and_grad(f["api"], f["tp"], f["tb"])
    np.testing.assert_allclose(float(loss), f["jl"], rtol=loss_rtol)
    np.testing.assert_allclose(float(aux["ce_loss"]), f["jaux"]["ce_loss"],
                               rtol=loss_rtol)
    assert float(aux["tokens"]) == float(f["jaux"]["tokens"])
    flat = T.flatten(grads)
    jflat = jax.tree.leaves(f["jg"])
    assert len(flat) == len(jflat)
    for (path, g), jg in zip(flat, jflat):
        assert tuple(g.shape) == jg.shape, keystr(path)
        assert _frac(g, jg) < g_tol, (keystr(path), _frac(g, jg))


def test_hidden_states_and_aux(family):
    check_hidden_states_and_aux(family)


def test_loss_and_gradients(family):
    check_loss_and_gradients(family)


@pytest.mark.parametrize("chunk", [8, 7])
def test_chunked_ce_matches_on_the_same_hidden_states(chunk):
    """The same h (the reference's) and labels with IGNOREd positions
    through both packages' chunked CE: a few ulps."""
    api = get_model(get_config("qwen2.5-3b").reduced())
    japi = jmodel(jget("qwen2.5-3b").reduced())
    params = api.init(0, CPU)
    batch = _smoke_torch(api.cfg, 1)
    h, _ = api.forward_hidden(params, batch, remat=False)
    h = h.detach()
    labels = batch["labels"].clone()
    labels[0, :5] = tts.IGNORE
    jl, jn = jax.jit(lambda p, hh, y: jts.chunked_ce_loss(
        japi, p, hh, y, chunk))(to_jax(params), jnp.asarray(h.numpy()),
                                jnp.asarray(labels.numpy().astype(np.int32)))
    tl, tn = tts.chunked_ce_loss(api, params, h, labels, chunk)
    assert float(tn) == float(jn) == labels.numel() - 5 - 1 - 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=CE_RTOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "whisper-large-v3"])
def test_remat_policies_give_identical_gradients(arch):
    api = get_model(get_config(arch).reduced())
    params = api.init(0, CPU)
    batch = _smoke_torch(api.cfg, 1)
    out = {r: tts.value_and_grad(api, params, batch, remat=r)
           for r in (True, "selective", False)}
    base_loss, _, base_g = out[False]
    for r in (True, "selective"):
        loss, _, g = out[r]
        assert torch.equal(loss, base_loss), r
        for a, b in zip(T.leaves(g), T.leaves(base_g)):
            assert torch.equal(a, b), r


def test_selective_policy_saves_the_weight_products(monkeypatch):
    """On reduced qwen2.5-3b (4 groups of one layer) the policy keeps 7
    matmuls a layer (q, k, v, o, gate, up, down) and nothing else."""
    saved = []
    policy = layers._selective_policy

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and \
                decision == tckpt.CheckpointPolicy.MUST_SAVE:
            saved.append(str(op))
        return decision

    monkeypatch.setattr(layers, "_selective_policy", counting)
    api = get_model(get_config("qwen2.5-3b").reduced())
    params = api.init(0, CPU)
    tts.value_and_grad(api, params, _smoke_torch(api.cfg, 1),
                       remat="selective")
    assert saved == ["aten.mm.default"] * (7 * api.cfg.num_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """Twin of ``test_models_smoke.py::test_one_train_step``."""
    api = get_model(get_config(arch).reduced())
    params = api.init(0, CPU)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = opt.init(params)
    step = tts.make_train_step(api, ocfg)
    params2, state2, metrics = step(params, state, _smoke_torch(api.cfg, 1))
    assert np.isfinite(float(metrics["loss"])), arch
    assert np.isfinite(float(metrics["grad_norm"])), arch
    assert int(state2.step) == 1
    keys = {"loss", "ce_loss", "tokens", "grad_norm", "lr"}
    if api.cfg.family in ("dense", "moe", "vlm"):
        keys.add("lb_loss")
    assert set(metrics) == keys
    assert any(not torch.allclose(a, b) for a, b in
               zip(T.leaves(params), T.leaves(params2))), arch
