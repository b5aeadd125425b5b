"""Basecaller network, forward-backward posterior, CRF Viterbi, signal prep."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanopore_dna_storage.models import flipflop as ff
from nanopore_dna_storage.ops.fwdbwd import (
    transition_posteriors, batched_transition_posteriors,
)
from nanopore_dna_storage.ops.crf_decode import (
    viterbi_flipflop, basecall_from_path,
)
from nanopore_dna_storage.ops.synthetic import synthetic_post, crf_state_path
from nanopore_dna_storage.signal.normalize import (
    medmad_normalize, trim_and_segment,
)
from nanopore_dna_storage.signal.barcode import (
    levenshtein, find_barcode_window,
)
from nanopore_dna_storage.signal.squiggle import simulate_raw_signal


def small_cfg():
    return ff.FlipflopConfig(winlen=5, stride=2, conv_filters=16, hidden=16)


def test_flipflop_forward_shapes_and_norm():
    cfg = small_cfg()
    params = ff.init_params(cfg, seed=1)
    sig = jax.random.normal(jax.random.PRNGKey(0), (2, 101))
    trans = ff.flipflop_transitions(params, cfg, sig)
    assert trans.shape == (2, 51, 40)
    # global normalization: per-read partition over valid blocks must be ~0
    nblk = jnp.full((2,), 51)
    logz = jax.vmap(ff.crf_log_partition)(trans, nblk)
    np.testing.assert_allclose(np.asarray(logz), 0.0, atol=2e-3)


def test_fwdbwd_rows_normalized_and_true_path_dominates():
    rng = np.random.default_rng(0)
    bases = rng.integers(0, 4, 30).astype(np.uint8)
    post = synthetic_post(bases, rng, noise=0.5)
    trans = jnp.asarray(post.reshape(post.shape[0], 40))
    tp = transition_posteriors(trans)
    lse = jax.nn.logsumexp(np.asarray(tp).reshape(tp.shape[0], 40), axis=1)
    np.testing.assert_allclose(lse, 0.0, atol=1e-4)


def test_viterbi_recovers_sequence_from_synthetic_post():
    rng = np.random.default_rng(1)
    bases = rng.integers(0, 4, 40).astype(np.uint8)
    post = synthetic_post(bases, rng, noise=0.8)
    path, score = viterbi_flipflop(jnp.asarray(post))
    call, chpos = basecall_from_path(np.asarray(path), post.shape[0])
    want = "".join("ACGT"[b] for b in bases)
    # viterbi over a clean synthetic post should recover nearly everything
    assert levenshtein(call, want) <= 2


def test_batched_fwdbwd_masking():
    rng = np.random.default_rng(2)
    p1 = synthetic_post(rng.integers(0, 4, 20).astype(np.uint8), rng)
    p2 = synthetic_post(rng.integers(0, 4, 12).astype(np.uint8), rng)
    T = max(p1.shape[0], p2.shape[0])
    batch = np.zeros((2, T, 40), np.float32)
    batch[0, : p1.shape[0]] = p1.reshape(-1, 40)
    batch[1, : p2.shape[0]] = p2.reshape(-1, 40)
    nblk = jnp.asarray([p1.shape[0], p2.shape[0]])
    out = batched_transition_posteriors(jnp.asarray(batch), nblk)
    solo = transition_posteriors(jnp.asarray(p2.reshape(-1, 40)))
    np.testing.assert_allclose(np.asarray(out[1][: p2.shape[0]]),
                               np.asarray(solo), rtol=2e-4, atol=2e-4)


def test_signal_prep():
    rng = np.random.default_rng(3)
    sig = np.concatenate([np.zeros(300), rng.normal(0, 1, 2000),
                          np.zeros(200)]).astype(np.float32)
    start, end = trim_and_segment(sig, trim_start=50, trim_end=10)
    assert 300 <= start <= 450
    assert end <= 2400
    norm = medmad_normalize(sig[start:end])
    assert abs(np.median(norm)) < 1e-3


def test_levenshtein_and_barcode_window():
    assert levenshtein("kitten", "sitting") == 3
    assert levenshtein("ACGT", "ACGT") == 0
    # construct a basecall with known barcodes and identity trans mapping
    rng = np.random.default_rng(4)
    mid = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    bc_s, bc_e = "AACCGGTTAA", "TTGGCCAATT"
    basecall = bc_s + mid + bc_e
    trans = np.arange(1, len(basecall) + 2)
    s, e, ds, de = find_barcode_window(basecall, trans, bc_s, bc_e)
    assert ds == 0
    # the reference never scans the last window position (helper.py:186
    # range(n//2, n-el) is exclusive), so a trailing exact barcode scores > 0
    assert de <= 2
    assert s == len(bc_s)
    assert e >= len(bc_s) + len(mid) - 3


def test_squiggle_sim_runs():
    rng = np.random.default_rng(5)
    raw = simulate_raw_signal(rng.integers(0, 4, 50).astype(np.uint8), rng)
    assert raw.ndim == 1 and len(raw) > 100


def test_weights_header_roundtrip(tmp_path):
    from nanopore_dna_storage.models import weights as wmod

    cfg = small_cfg()
    params = {k: np.asarray(v) for k, v in ff.init_params(cfg, 7).items()}
    path = tmp_path / "model.h"
    wmod.write_model_header(str(path), params, stride=cfg.stride)
    loaded, stride = wmod.params_from_header(str(path))
    assert stride == cfg.stride
    for k, v in params.items():
        got = loaded[k]
        if k == "conv_w":
            got = got.reshape(v.shape)
        np.testing.assert_allclose(got, v, rtol=0, atol=0)


@pytest.mark.slow
def test_weights_header_roundtrip_production_shapes(tmp_path):
    """The real guppy flip-flop architecture's shapes (supplementary
    §2.6: conv winlen 19 stride 2 with 256 filters, 5 GRU layers of 256,
    40-state head) survive an .mdl header round-trip bit-exactly —
    proving the loader at the scale of the LFS-absent pretrained blobs
    (networks.c:10-12), not just at test-model size."""
    from nanopore_dna_storage.models import weights as wmod

    cfg = ff.FlipflopConfig(winlen=19, stride=2, conv_filters=256,
                            hidden=256,
                            layer_dirs=("b", "f", "b", "f", "b"))
    params = {k: np.asarray(v) for k, v in ff.init_params(cfg, 11).items()}
    path = tmp_path / "r941_prod.h"
    wmod.write_model_header(str(path), params, stride=cfg.stride)
    loaded, stride = wmod.params_from_header(str(path))
    assert stride == cfg.stride
    for k, v in params.items():
        got = loaded[k]
        if k == "conv_w":
            got = got.reshape(v.shape)
        np.testing.assert_allclose(got, v, rtol=0, atol=0)


def test_taiyaki_json_import_roundtrip(tmp_path):
    """Taiyaki/guppy-JSON import path (models/import_taiyaki.py): a
    params dict exported to the JSON tree re-imports bit-exactly with
    the right stride and layer directions — the conversion path that
    makes real R9.4.1 models usable the day one is obtainable."""
    from nanopore_dna_storage.models import import_taiyaki as it

    cfg = ff.FlipflopConfig(winlen=19, stride=2, conv_filters=16,
                            hidden=24,
                            layer_dirs=("b", "f", "b", "f", "b"))
    params = {k: np.asarray(v) for k, v in ff.init_params(cfg, 3).items()}
    path = tmp_path / "model.jsn"
    it.write_taiyaki_json(str(path), params, stride=2,
                          layer_dirs=cfg.layer_dirs)
    loaded, stride, dirs = it.params_from_taiyaki_json(str(path))
    assert stride == 2 and dirs == cfg.layer_dirs
    for k, v in params.items():
        np.testing.assert_allclose(loaded[k], v, rtol=0, atol=1e-7)
