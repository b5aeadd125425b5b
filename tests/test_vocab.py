"""Vocabulary Viterbi decode parity vs the older reference binary, and the
logsumexp path-combining LVA mode."""
import json

import numpy as np
import pytest

from nanopore_dna_storage.ops.vocab import decode_post_vocab
from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.ops.lva import LVADecoder


def test_vocab_golden_parity(golden_dir):
    with open(golden_dir / "vocab" / "manifest.json") as f:
        cases = json.load(f)
    assert len(cases) == 3
    for case in cases:
        post = np.fromfile(golden_dir / "vocab" / f"{case['name']}.post",
                           dtype="<f4").reshape(-1, 5, 8)
        got = decode_post_vocab(post, case["msg_len"], case["vocab"])
        assert got.tolist() == case["ref"], case["name"]


def test_vocab_short_post_rejected():
    with pytest.raises(ValueError):
        decode_post_vocab(np.zeros((3, 5, 8), np.float32), 5, ["ACGT"])


def test_logsumexp_combine_scores_dominate_max():
    """With logsumexp combining, merged-path scores are >= max-combining
    scores and the decoded top message on a clean post is unchanged."""
    from nanopore_dna_storage.coding.conv import (
        make_conv_code, conv_encode_bases)
    from nanopore_dna_storage.ops.synthetic import synthetic_post

    rng = np.random.default_rng(11)
    cfg = ConvCodeConfig(mem=6, rate=1, msg_len=40)
    code = make_conv_code(cfg)
    msg = rng.integers(0, 2, (1, 40), dtype=np.uint8)
    post = synthetic_post(conv_encode_bases(code, msg)[0], rng, noise=0.8)

    out_max = LVADecoder(DecodeConfig(code=cfg, list_size=4,
                                      max_deviation=None))
    out_lse = LVADecoder(DecodeConfig(code=cfg, list_size=4,
                                      max_deviation=None,
                                      path_combine="logsumexp"))
    m1, s1, v1 = out_max.decode(post[None])
    m2, s2, v2 = out_lse.decode(post[None])
    assert (m1[0, 0] == msg[0]).all()
    assert (m2[0, 0] == msg[0]).all()
    assert s2[0, 0] >= s1[0, 0]
