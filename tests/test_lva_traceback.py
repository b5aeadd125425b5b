"""Selection-traceback decoder vs the message-carrying oracle.

The traceback backend (ops/lva_traceback.py) reconstructs messages by
walking per-block selections backward through the double-buffer staleness
rule; these tests check bit-identical lists (messages AND scores) against
the oracle (ops/lva.py), which is itself golden-validated against the
reference binary. Fast configs only (the m>=8 golden matrix is in
test_lva_traceback_golden.py, marked slow).
"""
import numpy as np
import pytest

from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.coding.conv import (conv_encode_bases,
                                                  make_conv_code)
from nanopore_dna_storage.io.post import pack_posts
from nanopore_dna_storage.ops.lva import LVADecoder
from nanopore_dna_storage.ops.synthetic import synthetic_post


def _posts(enc_cfg, n, rng, rc=False, noise=0.9):
    code = make_conv_code(enc_cfg)
    msgs = rng.integers(0, 2, (n, enc_cfg.msg_len), dtype=np.uint8)
    bases = conv_encode_bases(code, msgs)
    if rc:
        bases = [(3 - b)[::-1] for b in bases]
    posts = [synthetic_post(b, rng, noise=noise) for b in bases]
    return msgs, *pack_posts(posts)


CASES = [
    # (rate, rc, L, dev) — dev small enough to exercise the beam's stale
    # trailing edge; L > 1 exercises dedup + slot selection.
    (1, False, 2, 8),
    (5, False, 4, 6),
    (5, True, 4, 6),
]


@pytest.mark.parametrize("rate,rc,L,dev", CASES)
def test_traceback_matches_oracle(rate, rc, L, dev):
    rng = np.random.default_rng(rate * 10 + rc)
    enc = ConvCodeConfig(mem=6, rate=rate, msg_len=30)
    msgs, packed, nblks = _posts(enc, 2, rng, rc=rc)
    cfg = ConvCodeConfig(mem=6, rate=rate, msg_len=30, rc=rc)
    dx = LVADecoder(DecodeConfig(code=cfg, list_size=L, max_deviation=dev,
                                 backend="oracle"))
    mx, sx, vx = dx.decode(packed, nblks)
    dp = LVADecoder(DecodeConfig(code=cfg, list_size=L, max_deviation=dev,
                                 backend="traceback"))
    mp, sp, vp = dp.decode(packed, nblks)
    assert np.array_equal(vx, vp)
    assert np.array_equal(sx, sp)
    assert np.array_equal(mx[vx], mp[vp])
    if not rc:
        assert (mx[:, 0] == msgs).all()


def test_traceback_logsumexp_scores():
    """logsumexp path combining changes scores, not selections.

    The suppression merge combines each accepted message's ENTIRE
    duplicate class at pop time, so the oracle must run exhaustive merge
    rounds (all Q*L candidates pop) to accumulate the same mass."""
    rng = np.random.default_rng(7)
    enc = ConvCodeConfig(mem=6, rate=1, msg_len=24)
    msgs, packed, nblks = _posts(enc, 1, rng)
    kw = dict(list_size=2, max_deviation=8, path_combine="logsumexp")
    dx = LVADecoder(DecodeConfig(code=enc, merge_rounds=33 * 2,
                                 backend="oracle", **kw))
    mx, sx, vx = dx.decode(packed, nblks)
    dp = LVADecoder(DecodeConfig(code=enc, backend="traceback", **kw))
    mp, sp, vp = dp.decode(packed, nblks)
    assert np.array_equal(mx[vx], mp[vp])
    np.testing.assert_allclose(sx, sp, rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 2])
def test_traceback_chunked(batch):
    """The chunked decode loop (chunk_blocks < T) is bit-identical to the
    single-chunk program: chunk boundaries only split the scans, they never
    change carry semantics (docs/DESIGN.md §6)."""
    rng = np.random.default_rng(99)
    enc = ConvCodeConfig(mem=6, rate=5, msg_len=30)
    msgs, packed, nblks = _posts(enc, batch, rng)
    dx = LVADecoder(DecodeConfig(code=enc, list_size=4, max_deviation=6,
                                 backend="oracle"))
    mx, sx, vx = dx.decode(packed, nblks)
    dp = LVADecoder(DecodeConfig(code=enc, list_size=4, max_deviation=6,
                                 backend="traceback", chunk_blocks=32))
    mp, sp, vp = dp.decode(packed, nblks)
    assert np.array_equal(vx, vp)
    assert np.array_equal(sx, sp)
    assert np.array_equal(mx[vx], mp[vp])
