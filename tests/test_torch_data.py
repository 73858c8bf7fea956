"""The port's synthetic data pipeline (``repro_torch.train.data``) against
the reference's ``repro.train.data``.

* Twins of ``test_substrate.py::TestData`` (determinism, steps differ,
  shifted labels, the iterator's resume, tokens in the vocabulary).
* ``make_batch`` equal to the reference's token for token and label for
  label for several (seed, step) pairs, qwen2.5-3b's vocabulary of
  151936 among them at a small (B, S): the draw is
  ``jax.random.categorical`` over ``xla_log`` of the Zipf probabilities,
  re-ranked with XLA's ``log`` (``rng.categorical_xla_t``); also with
  every row re-drawn whole (the path of a row whose candidates crowd
  within the margin) and over a flat distribution, where every row's
  top values are near-ties.
* The iterator's state round trip; a seed mismatch refused.
"""
import numpy as np
import pytest
import torch

from repro.train import data as jdata
from repro_torch import rng
from repro_torch.configs import SHAPES, get_config
from repro_torch.train import data as data_mod
from repro_torch.train.train_step import IGNORE
from test_torch_train_step import one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CFG = data_mod.DataConfig(vocab_size=128, seq_len=16, global_batch=4,
                          seed=7)


class TestData:
    def test_deterministic(self):
        a = data_mod.make_batch(CFG, 3, CPU)
        b = data_mod.make_batch(CFG, 3, CPU)
        assert torch.equal(a["tokens"], b["tokens"])

    def test_steps_differ(self):
        a = data_mod.make_batch(CFG, 0, CPU)
        b = data_mod.make_batch(CFG, 1, CPU)
        assert not torch.equal(a["tokens"], b["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = data_mod.make_batch(CFG, 0, CPU)
        assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert bool((b["labels"][:, -1] == IGNORE).all())

    def test_iterator_resume(self):
        it = data_mod.DataIterator(CFG, device=CPU)
        next(it), next(it)
        s = it.state_dict()
        b3 = next(it)
        it2 = data_mod.DataIterator(CFG, device=CPU)
        it2.load_state_dict(s)
        assert torch.equal(b3["tokens"], next(it2)["tokens"])

    def test_tokens_in_vocab(self):
        t = data_mod.make_batch(CFG, 0, CPU)["tokens"]
        assert t.dtype == torch.int64
        assert int(t.min()) >= 0 and int(t.max()) < CFG.vocab_size


def _same_as_reference(cfg, step):
    ref = jdata.make_batch(jdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=cfg.seq_len,
        global_batch=cfg.global_batch, seed=cfg.seed), step)
    got = data_mod.make_batch(cfg, step, CPU)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (128, 16, 4, 7, 0), (128, 16, 4, 7, 3), (256, 32, 8, 1234, 5),
    (151936, 8, 2, 1234, 0), (151936, 6, 2, 3, 11)])
def test_make_batch_equals_reference(vocab, seq, batch, seed, step):
    _same_as_reference(data_mod.DataConfig(vocab, seq, batch, seed=seed),
                       step)


def test_rows_drawn_whole_equal_reference(monkeypatch):
    """A margin no candidate set satisfies sends every row to the host's
    whole-row draw: the same batch."""
    monkeypatch.setattr(rng, "CATEGORICAL_MARGIN", float("inf"))
    _same_as_reference(data_mod.DataConfig(512, 8, 2, seed=5), 2)


def test_near_ties_rerank_exactly(monkeypatch):
    """Equal logits: each row's winner is decided among near-equal
    gumbels, by XLA's log, over chunks of 4 rows; the device values stay
    within the margin."""
    monkeypatch.setattr(rng, "CATEGORICAL_CHUNK", 4096)
    key = rng.PRNGKey(9)
    V = 1000
    logits = rng.xla_log(np.full(V, 1.0 / V, np.float32))
    got, err = rng.categorical_xla_t(key, logits, (6, 7), CPU,
                                     with_err=True)
    u = rng.uniform(key, (6, 7, V), minval=rng.TINY)
    want = np.argmax(rng.gumbel_xla(u) + logits, axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert err < rng.CATEGORICAL_MARGIN / 2


def test_iterator_state_round_trip():
    it = data_mod.for_model(get_config("qwen2.5-3b").reduced(),
                            SHAPES["train_4k"], seed=3, batch_override=2,
                            device=CPU)
    assert (it.cfg.seq_len, it.cfg.global_batch, it.cfg.vocab_size) == (
        4096, 2, 256)
    it.step = 5
    s = it.state_dict()
    assert s == {"step": 5, "seed": 3}
    it2 = data_mod.DataIterator(it.cfg, device=CPU)
    it2.load_state_dict(s)
    assert it2.step == 5
    with pytest.raises(ValueError, match="seed"):
        it2.load_state_dict({"step": 1, "seed": 4})


def test_make_batch_without_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        data_mod.make_batch(CFG, 0)
