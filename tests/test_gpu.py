"""Decode on the card: the traceback backend as compiled for the GPU
against the reference goldens and the oracle (skips without a GPU)."""
import json

import numpy as np
import pytest

from nanopore_dna_storage.coding.conv import (conv_encode_bases,
                                              make_conv_code)
from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.io.post import pack_posts
from nanopore_dna_storage.ops.lva import LVADecoder
from nanopore_dna_storage.ops.synthetic import synthetic_post

pytestmark = pytest.mark.gpu


def _lists(msgs, valid):
    return ["".join(map(str, m)) for m, v in zip(msgs, valid) if v]


@pytest.mark.parametrize("name", ["m11_r5_rc0_l8", "m11_r5_rc1_l8"])
def test_gpu_traceback_golden(gpu, golden_dir, name):
    d = golden_dir / "decode"
    case = next(c for c in json.loads((d / "manifest.json").read_text())
                if c["name"] == name)
    post = np.fromfile(d / f"{name}.post", dtype="<f4").reshape(-1, 5, 8)
    dec = LVADecoder(DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"], max_deviation=case["max_deviation"]))
    msgs, _, valid = dec.decode(post[None])
    assert _lists(msgs[0], valid[0]) == (d / f"{name}.lists").read_text(
        ).split()


def test_gpu_traceback_matches_oracle(gpu):
    rng = np.random.default_rng(5)
    cfg = ConvCodeConfig(mem=8, rate=5, msg_len=60)
    msgs = rng.integers(0, 2, (2, cfg.msg_len), dtype=np.uint8)
    packed, nblks = pack_posts([
        synthetic_post(b, rng, noise=0.9)
        for b in conv_encode_bases(make_conv_code(cfg), msgs)])
    kw = dict(code=cfg, list_size=8, max_deviation=10)
    mt, st, vt = LVADecoder(DecodeConfig(**kw)).decode(packed, nblks)
    mo, so, vo = LVADecoder(DecodeConfig(backend="oracle", **kw)).decode(
        packed, nblks)
    assert np.array_equal(vt, vo) and np.array_equal(st, so)
    assert np.array_equal(mt[vt], mo[vo])
