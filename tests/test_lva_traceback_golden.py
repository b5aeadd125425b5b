"""Traceback backend (the production decode path) golden parity: every
reference-binary decode golden, list for list. m=6 cases (incl. the
L=34 fori-loop merge) run in the fast suite; m>=8 and the m=14
production-length pair are slow on CPU and run in the slow suite and on
the card (chip_smoke.py phase b)."""
import json

import numpy as np
import pytest

from tests.test_lva_decode import _cases, _load_post, _ref_lists
from nanopore_dna_storage.config import ConvCodeConfig, DecodeConfig
from nanopore_dna_storage.ops.lva import LVADecoder

FAST = ["m6_r1_rc0_l1", "m6_r1_rc0_l4", "m6_r1_rc1_l4", "m6_r3_rc0_l4",
        "m6_r5_rc0_l8", "m6_r5_rc1_l8", "m6_r2_rc0_l2", "m6_r4_rc0_l2",
        "m6_r7_rc1_l2", "m6_r1_rc0_l34"]
SLOW = ["m8_r1_rc0_l4", "m8_r5_rc0_l8", "m8_r5_rc1_l8", "m8_r3_rc1_l4",
        "m11_r5_rc0_l8", "m11_r5_rc1_l8", "m14_r1_rc0_l2", "m8_r1_rc0_l64"]
SLOW14 = ["m14_r5_rc0_l4_cpu", "m14_r5_rc1_l4_cpu",
          "m14_r5_rc0_l4_prod", "m14_r5_rc1_l4_prod"]


def _decode(case, post):
    cfg = DecodeConfig(
        code=ConvCodeConfig(mem=case["mem"], rate=case["rate"],
                            msg_len=case["msg_len"], rc=case["rc"]),
        list_size=case["list_size"], max_deviation=case["max_deviation"],
        backend="traceback")
    msgs, _, valid = LVADecoder(cfg).decode(post[None])
    return ["".join(map(str, m)) for m, v in zip(msgs[0], valid[0]) if v]


@pytest.mark.parametrize(
    "name", FAST + [pytest.param(n, marks=pytest.mark.slow) for n in SLOW])
def test_traceback_golden(golden_dir, name):
    case = next(c for c in _cases(golden_dir) if c["name"] == name)
    got = _decode(case, _load_post(golden_dir, name))
    assert got == _ref_lists(golden_dir, name), name


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW14)
def test_traceback_golden_m14(golden_dir, name):
    """m=14 r=5/6 L=4 fwd+RC, C=16384, incl. the production msg_len=181
    pair (tests/golden/decode14, scripts/make_goldens.py)."""
    with open(golden_dir / "decode14" / "manifest.json") as f:
        case = next(c for c in json.load(f) if c["name"] == name)
    post = np.fromfile(golden_dir / "decode14" / f"{name}.post",
                       dtype="<f4").reshape(-1, 5, 8)
    want = (golden_dir / "decode14" / f"{name}.lists").read_text().split()
    assert _decode(case, post) == want, name
