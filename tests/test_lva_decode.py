"""List-Viterbi oracle (ops/lva.py) parity vs reference golden decoded lists.

Each golden case is a synthetic flip-flop posterior decoded by the reference
C++ binary; we require identical decoded bit lists (same order) from the
message-carrying oracle, exercising all code memories, rates, RC, list sizes
and the max-deviation beam. The production traceback backend runs the same
goldens in test_lva_traceback_golden.py.
"""
import json

import numpy as np
import pytest

from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.ops.lva import LVADecoder


def _cases(golden_dir):
    with open(golden_dir / "decode" / "manifest.json") as f:
        return json.load(f)


def _load_post(golden_dir, name):
    raw = np.fromfile(golden_dir / "decode" / f"{name}.post", dtype="<f4")
    assert raw.size % 40 == 0
    return raw.reshape(-1, 5, 8)


def _ref_lists(golden_dir, name):
    return (golden_dir / "decode" / f"{name}.lists").read_text().split()


def _run_case(golden_dir, case, merge_rounds=None):
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"],
        max_deviation=case["max_deviation"],
        merge_rounds=merge_rounds,
        backend="oracle",
    )
    dec = LVADecoder(cfg)
    post = _load_post(golden_dir, case["name"])
    msgs, scores, valid = dec.decode(post[None])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    return got, scores[0], _ref_lists(golden_dir, case["name"])


@pytest.mark.parametrize("idx", range(16))
def test_golden_decode_default_rounds(golden_dir, idx):
    """Production merge_rounds, m=6 cases — the fast-suite core parity
    (10-16 s each). m>=8 and the exhaustive-rounds variants run in
    test_lva_decode_large (slow): they take 1-20 min each on 2 vCPUs."""
    cases = _cases(golden_dir)
    if idx >= len(cases):
        pytest.skip("no such case")
    case = cases[idx]
    if case["mem"] >= 8:
        pytest.skip("m>=8 cases run in test_lva_decode_large (slow)")
    got, _, want = _run_case(golden_dir, case, merge_rounds=None)
    assert got == want, f"default-rounds mismatch for {case['name']}"


def test_top1_recovers_true_message(golden_dir):
    case = _cases(golden_dir)[0]
    got, _, _ = _run_case(golden_dir, case)
    assert got[0] == case["true_msg"]
