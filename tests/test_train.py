"""Basecaller training: CRF loss sanity and optimization progress."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from nanopore_dna_storage.models import flipflop as ff
from nanopore_dna_storage.models.train import (
    train_on_synthetic, crf_loss, synthetic_batches,
)


def tiny_cfg():
    return ff.FlipflopConfig(winlen=5, stride=2, conv_filters=12, hidden=12)


def test_crf_loss_finite_and_positive():
    cfg = tiny_cfg()
    params = ff.init_params(cfg, 0)
    rng = np.random.default_rng(0)
    sig, ns, st, sl, _ = next(synthetic_batches(rng, 2, 20, 260, 22))
    loss = float(crf_loss(params, cfg, sig, ns, st, sl))
    assert np.isfinite(loss)
    # conditional NLL per block should be positive for an untrained model
    assert loss > 0


@pytest.mark.slow
def test_training_reduces_loss():
    cfg = tiny_cfg()
    state, losses = train_on_synthetic(cfg, steps=80, batch=4, seq_len=25,
                                       seed=1, learning_rate=5e-3)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < 0.85 * first, (first, last)
