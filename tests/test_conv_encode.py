"""Bit-exact encoder parity vs reference golden vectors (all mem x rate)."""
import json

import numpy as np
import pytest

from nanopore_dna_storage.config import ConvCodeConfig
from nanopore_dna_storage.coding.conv import (
    make_conv_code, conv_encode_bases, bases_to_str, str_to_bases,
    reverse_complement_bases,
)


def _manifest(golden_dir):
    with open(golden_dir / "encode" / "manifest.json") as f:
        return json.load(f)


def test_all_configs_match_reference(golden_dir):
    cases = _manifest(golden_dir)
    assert len(cases) == 24
    for case in cases:
        msgs = np.load(golden_dir / "encode" / f"{case['name']}_msgs.npy")
        want = (golden_dir / "encode" / f"{case['name']}_oligos.txt").read_text().split()
        code = make_conv_code(ConvCodeConfig(
            mem=case["mem"], rate=case["rate"], msg_len=case["msg_len"]))
        got = bases_to_str(conv_encode_bases(code, msgs))
        assert got == want, f"encode mismatch for {case['name']}"


def test_odd_output_length_rejected():
    # rate 3 (3/4): 2 input bits per base; msg_len + mem odd -> error
    with pytest.raises(ValueError):
        make_conv_code(ConvCodeConfig(mem=6, rate=3, msg_len=101))


def test_reverse_complement_roundtrip():
    arr = str_to_bases("ACGTTGCA")
    rc = reverse_complement_bases(arr)
    assert bases_to_str(rc)[0] == "TGCAACGT"
    assert (reverse_complement_bases(rc) == arr).all()


def test_rc_code_tables_differ():
    cfg = ConvCodeConfig(mem=8, rate=5, msg_len=100)
    fwd = make_conv_code(cfg)
    rev = make_conv_code(ConvCodeConfig(mem=8, rate=5, msg_len=100, rc=True))
    assert fwd.n_bases == rev.n_bases
    assert fwd.g0 != rev.g0  # taps reversed
    # reverse-then-complement (cpp:383-385) keeps endpoint msg positions
    assert rev.st_pos2msg_pos[0] == 0
    assert rev.st_pos2msg_pos[-1] == fwd.config.msg_len + fwd.mem
