"""Reading-cost sweep harness (supplementary Table 2 methodology) on
simulated decoded lists: minimum reads (in steps) for all-trials RS recovery,
reported as bases/bit. Exercises the full outer-loop evaluation:
encode -> channel -> LVA lists -> CRC/index -> majority vote -> RS -> sweep.
"""
import json
import os

import numpy as np
import pytest

from nanopore_dna_storage import cli
from nanopore_dna_storage.config import ExperimentConfig
from nanopore_dna_storage.pipeline.encode import encode_bytes
from nanopore_dna_storage.pipeline.simulate import simulate_posts
from nanopore_dna_storage.pipeline.decode import PipelineDecoder
from nanopore_dna_storage.io.lists import write_list_file


@pytest.mark.slow
def test_read_cost_sweep(tmp_path, capsys):
    exp = ExperimentConfig(bytes_per_oligo=4, rs_redundancy=0.5,
                           conv_mem=6, conv_rate=1)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 24, dtype=np.uint8).tobytes()
    enc = encode_bytes(data, exp)
    posts, rcs, _ = simulate_posts(enc.oligos, 40, rng, sub_prob=0.002,
                                   del_prob=0.002, ins_prob=0.0)
    dec = PipelineDecoder(exp, list_size=4, max_deviation=16)
    out = dec.decode_posts(posts, rcs,
                           enc.num_oligos_data + enc.num_oligos_rs)
    lists_dir = tmp_path / "lists"
    os.makedirs(lists_dir)
    for i in range(len(posts)):
        msgs = ["".join(map(str, m))
                for m, v in zip(out.msgs[i], out.valid[i]) if v]
        write_list_file(str(lists_dir), i, msgs)
    infile = tmp_path / "data.bin"
    infile.write_bytes(data)

    cli.main(["read-cost", "--lists-dir", str(lists_dir),
              "--data-size", str(len(data)), "--infile", str(infile),
              "--list-size", "4", "--step", "10", "--num-trials", "4",
              "--oligo-len", str(enc.oligo_len),
              "--bytes-per-oligo", "4", "--rs-redundancy", "0.5",
              "--mem", "6", "--rate", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["min_reads"] is not None
    assert res["reading_cost_bases_per_bit"] == pytest.approx(
        res["min_reads"] * enc.oligo_len / (8.0 * len(data)), rel=1e-6)
    assert res["sweep"][-1]["successes"] == 4
