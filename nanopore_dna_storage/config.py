"""Typed configuration for the nanopore DNA storage engine.

One config system replaces the reference's three disjoint flag mechanisms
(argparse in the Python drivers, cxxopts in viterbi_convolutional_code.cpp:137-173,
argp in flappie/src/flappie.c:42-63, plus edit-the-source constants in
encode_experiments.py / decode_RS_from_decoded_lists.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Supported convolutional code memories (viterbi_convolutional_code.cpp:269-293).
CONV_MEMORIES = (6, 8, 11, 14)
# Supported rate indices r -> rate (r+1)/(r+2) except r=7 -> 7/8
# (viterbi_convolutional_code.cpp:299-339).
CONV_RATES = (1, 2, 3, 4, 5, 7)


@dataclasses.dataclass(frozen=True)
class ConvCodeConfig:
    """Convolutional inner code parameters.

    Mirrors the parameter surface of `set_conv_params`
    (reference viterbi/viterbi_convolutional_code.cpp:264-415).
    """

    mem: int  # code memory m in {6, 8, 11, 14}
    rate: int  # rate index in {1,2,3,4,5,7} = rates 1/2,2/3,3/4,4/5,5/6,7/8
    msg_len: int  # input message length in bits (incl. index+crc+pad)
    rc: bool = False  # decode a reverse-complemented read
    sync_marker: str = ""  # e.g. "110"; empty = disabled
    sync_period: int = 0

    def __post_init__(self):
        if self.mem not in CONV_MEMORIES:
            raise ValueError(f"mem must be one of {CONV_MEMORIES}, got {self.mem}")
        if self.rate not in CONV_RATES:
            raise ValueError(f"rate must be one of {CONV_RATES}, got {self.rate}")
        if self.sync_marker and self.sync_period < len(self.sync_marker):
            raise ValueError("sync_period shorter than sync marker")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """List-Viterbi decode parameters (viterbi_convolutional_code.cpp:137-173)."""

    code: ConvCodeConfig
    list_size: int = 1
    # Beam width around the expected diagonal position; None = exact Viterbi
    # (reference default, viterbi_convolutional_code.cpp:238-242). Production
    # uses 20 (generate_decoded_lists.py:90).
    max_deviation: Optional[int] = 20
    # Number of merge rounds of the oracle's top-L dedup selection (the
    # reference's lazy heap, viterbi_convolutional_code.cpp:744-799, pops
    # until L unique messages are found; a fixed-shape loop needs a static
    # bound). None = auto (2*list_size + 2). The traceback backend's
    # suppression merge is exhaustive and ignores this.
    merge_rounds: Optional[int] = None
    # How duplicate-message paths merge: "max" keeps the better score (the
    # production binary, viterbi_convolutional_code.cpp:231-236); "logsumexp"
    # accumulates path probability mass (the older binary's --use-logsumexp,
    # extra/viterbi_nanopore.cpp:118,883-888).
    path_combine: str = "max"
    # Decode path: "traceback" (per-block selections + traceback,
    # ops/lva_traceback.py; production) or "oracle" (the message-carrying
    # reference path, ops/lva.py).
    backend: str = "traceback"
    # Signal blocks per jitted chunk program of the traceback decode (must
    # be even). The chunk loop bounds peak device memory at one selections
    # copy and is the sharding seam (docs/DESIGN.md §6).
    chunk_blocks: int = 128

    def __post_init__(self):
        if self.path_combine not in ("max", "logsumexp"):
            raise ValueError("path_combine must be 'max' or 'logsumexp'")
        if self.backend not in ("traceback", "oracle"):
            raise ValueError("backend must be traceback|oracle")

    @property
    def merge_rounds_(self) -> int:
        if self.merge_rounds is not None:
            return self.merge_rounds
        return 2 * self.list_size + 2


@dataclasses.dataclass(frozen=True)
class FramingConfig:
    """Index + CRC framing (reference helper.py:27-32)."""

    index_len: int = 12
    crc_len: int = 8
    prp_a: int = 1751
    prp_b: int = 2532
    prp_a_inv: int = 3303  # modular inverse of prp_a mod 2**index_len


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One storage experiment = outer RS + framing + inner conv code.

    Mirrors encode_experiments.py:35-113 plus helper.compute_parameters
    (helper.py:353-363).
    """

    bytes_per_oligo: int
    rs_redundancy: float  # e.g. 0.3 for 30%
    conv_mem: int
    conv_rate: int
    pad: bool = False
    framing: FramingConfig = dataclasses.field(default_factory=FramingConfig)
    start_barcode: str = ""
    end_barcode: str = ""

    def msg_len(self) -> int:
        f = self.framing
        return f.index_len + f.crc_len + 8 * self.bytes_per_oligo + int(self.pad)

    def oligo_counts(self, data_size_padded: int) -> Tuple[int, int, int]:
        """(num_oligos_data, num_oligos_rs, num_oligos). helper.py:353-363."""
        assert data_size_padded % self.bytes_per_oligo == 0
        num_data = data_size_padded // self.bytes_per_oligo
        num_rs = int(num_data * self.rs_redundancy)
        return num_data, num_rs, num_data + num_rs
