"""Large-memory (m>=8) golden parity of the oracle — slow, runs on the CPU.

The fast suite keeps only m=6 cases (<10 min total on 2 vCPUs); every
m=8/11/14 golden runs here, including the exhaustive-merge-rounds variant
for m=8 (exhaustive rounds at m>=11 multiply an already-minutes-long case).
"""
import json

import pytest

from tests.test_lva_decode import _cases, _run_case

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("idx", range(16))
def test_golden_decode_parity_large(golden_dir, idx):
    cases = _cases(golden_dir)
    if idx >= len(cases):
        pytest.skip("no such case")
    case = cases[idx]
    if case["mem"] < 8:
        pytest.skip("covered by the fast suite")
    got, _, want = _run_case(golden_dir, case, merge_rounds=None)
    assert got == want, f"decode mismatch for {case['name']}"


@pytest.mark.parametrize("idx", range(16))
def test_golden_decode_exhaustive_rounds(golden_dir, idx):
    """Exhaustive merge rounds = exact reference heap semantics (m<=8;
    exhaustive at m>=11 multiplies an already-minutes-long case)."""
    cases = _cases(golden_dir)
    if idx >= len(cases):
        pytest.skip("no such case")
    case = cases[idx]
    if case["mem"] > 8:
        pytest.skip("m>=11 exhaustive is impractical on CPU")
    exhaustive = (1 + 32) * case["list_size"]
    got, _, want = _run_case(golden_dir, case, merge_rounds=exhaustive)
    assert got == want, f"decode mismatch for {case['name']}"


def test_l64_golden_parity(golden_dir):
    """The reference's default list size for m=8 is 64 (supplementary 5.2)."""
    case = next(c for c in _cases(golden_dir) if c["list_size"] == 64)
    got, _, want = _run_case(golden_dir, case, merge_rounds=None)
    assert got == want


@pytest.mark.parametrize("idx", range(2))
def test_m14_production_golden_parity(golden_dir, idx):
    """m=14 r=5/6 L=4 fwd+RC, C=16384 — reference-binary lists,
    bit-for-bit (tests/golden/decode14, scripts/make_goldens.py). The CPU
    suite runs the msg_len=101 pair (~15 min/case on 2 vCPUs); the full
    msg_len=181 production pair runs on the card (chip_smoke.py)."""
    with open(golden_dir / "decode14" / "manifest.json") as f:
        cases = json.load(f)
    case = [c for c in cases if c["name"].endswith("_cpu")][idx]
    import numpy as np
    from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
    from nanopore_dna_storage.ops.lva import LVADecoder
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"],
        max_deviation=case["max_deviation"], backend="oracle")
    dec = LVADecoder(cfg)
    raw = np.fromfile(golden_dir / "decode14" / f"{case['name']}.post",
                      dtype="<f4").reshape(-1, 5, 8)
    msgs, scores, valid = dec.decode(raw[None])
    got = ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]
    want = (golden_dir / "decode14" / f"{case['name']}.lists"
            ).read_text().split()
    assert got == want, f"decode mismatch for {case['name']}"
