"""Convolutional inner code: parameter tables, vectorized encoder, RC transform.

Vectorized reformulation of the reference encoder
(viterbi/viterbi_convolutional_code.cpp:264-499):

* The shift-register encode loop becomes a binary sliding-window correlation:
  with the state register holding the last ``m`` input bits, output bit
  ``out[k, i] = parity(window_k . G_i)`` over the extended bit stream
  ``[init_bits, msg, termination_bits]``. That is a (windows @ G) %% 2 matmul,
  batched over messages — no sequential loop.
* Puncturing (viterbi_convolutional_code.cpp:468-497) becomes a static gather
  index built once per (rate, msg_len).
* The reverse-complement trellis transform (viterbi_convolutional_code.cpp:359-386)
  is applied to the parameter tables, not the data.

No code is shared with the reference; behavior is validated bit-exactly against
golden vectors produced by the reference binary (tests/golden).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import ConvCodeConfig

NBASE = 4
BASES = "ACGT"
NSTATE_CRF = 8  # A+,C+,G+,T+,A-,C-,G-,T- (flip/flop)

# Generator polynomial pairs (octal) and non-zero initial states per memory,
# from viterbi_convolutional_code.cpp:269-293. The non-zero start/end states
# avoid long repeated-base runs (supplementary material section 2.2).
_CODE_TABLE = {
    6: (0o171, 0o133, 0b100101),
    8: (0o515, 0o677, 0b10010110),
    11: (0o5537, 0o6131, 0b10010110001),
    14: (0o75063, 0o56711, 0b10010110001101),
}

# Puncturing patterns per rate index (viterbi_convolutional_code.cpp:296-339).
# Building blocks over one (elem 0) or two (elems 1-3) input bits:
#   0: keep both output bits of one input bit          (1 base / 1 input bit)
#   1: keep bits (1, 2) of the four bits of two inputs (1 base / 2 input bits)
#   2: keep bits (0, 3)
#   3: keep bits (1, 3)
_PUNCTURE_TABLE = {
    1: (0,),
    2: (0, 2, 0),
    3: (0, 1),
    4: (0, 3, 0, 2, 1),
    5: (0, 1, 2),
    7: (0, 3, 1, 1),
}

# Which of the 4 encoded bits of a pattern element are kept, and how many
# encoded bits the element spans.
_PATTERN_KEEP = {0: (0, 1), 1: (1, 2), 2: (0, 3), 3: (1, 3)}
_PATTERN_SPAN = {0: 2, 1: 4, 2: 4, 3: 4}
# When a pattern is traversed in the reverse direction (RC decode), elements
# 1 and 2 swap (viterbi_convolutional_code.cpp:375-376).
_PATTERN_REVERSE_MAP = (0, 2, 1, 3)


def reverse_bits(x: int, nbits: int) -> int:
    """Bit-reverse the low ``nbits`` of ``x``."""
    r = 0
    for i in range(nbits):
        r = (r << 1) | ((x >> i) & 1)
    return r


def int_bits_lsb(x: int, nbits: int) -> np.ndarray:
    """Low ``nbits`` of ``x`` as a uint8 array, LSB first."""
    return ((x >> np.arange(nbits)) & 1).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """Fully derived parameter set for one (mem, rate, msg_len, rc) config.

    ``pattern[j]`` is the puncturing element governing the transition into base
    position j+1 (st_pos j+1), matching the reference's
    ``puncturing_pattern[(st_pos - 1) %% len]`` convention.
    """

    config: ConvCodeConfig
    mem: int
    nstate_conv: int
    g0: int
    g1: int
    initial_state: int
    final_state: int
    pattern: Tuple[int, ...]
    n_bases: int  # number of DNA bases in one encoded oligo
    nstate_pos: int  # n_bases + 1
    # msg position (1-indexed bit count consumed) at each st_pos; under RC this
    # is reversed+complemented like the reference (cpp:383-385).
    st_pos2msg_pos: Tuple[int, ...]
    sync_marker_bits: Tuple[int, ...]
    sync_period: int

    @property
    def total_bits(self) -> int:
        """Input bits incl. termination = msg_len + mem."""
        return self.config.msg_len + self.mem

    def pattern_at(self, st_pos: int) -> int:
        """Pattern element for the transition into st_pos (>=1)."""
        return self.pattern[(st_pos - 1) % len(self.pattern)]


def _expand_positions(pattern_seq, msg_len: int, mem: int):
    """Walk the puncturing pattern, returning per-base (pattern elem, msg_pos).

    Reproduces the nstate_pos / st_pos2msg_pos construction of
    viterbi_convolutional_code.cpp:344-357. Raises if the output length is not
    an even number of bits (caller should pad the message by one bit).
    """
    total = msg_len + mem
    elems: List[int] = []
    msg_pos = [0]
    consumed = 0
    j = 0
    while consumed < total:
        p = pattern_seq[j % len(pattern_seq)]
        consumed += 1 if p == 0 else 2
        elems.append(p)
        msg_pos.append(consumed)
        j += 1
    if consumed != total:
        raise ValueError(
            "Output length not even for this (rate, msg_len); pad the message "
            "with a single 0 bit (reference viterbi_convolutional_code.cpp:353-357)"
        )
    return tuple(elems), tuple(msg_pos)


def make_conv_code(config: ConvCodeConfig) -> ConvCode:
    """Build all derived tables for a config, applying the RC transform."""
    g0, g1, init = _CODE_TABLE[config.mem]
    mem = config.mem
    final = reverse_bits(init, mem)
    base_pattern = _PUNCTURE_TABLE[config.rate]

    elems, msg_pos = _expand_positions(base_pattern, config.msg_len, mem)
    n_bases = len(elems)

    sync_bits = tuple(int(c) for c in config.sync_marker)

    if config.rc:
        # Decode the reverse-complement read: reverse the generator taps,
        # swap+reverse the boundary states, traverse the puncturing pattern
        # backwards with elements 1<->2 swapped, and flip st_pos2msg_pos
        # (viterbi_convolutional_code.cpp:359-386).
        g0 = reverse_bits(g0, mem + 1)
        g1 = reverse_bits(g1, mem + 1)
        init, final = reverse_bits(final, mem), reverse_bits(init, mem)
        elems = tuple(_PATTERN_REVERSE_MAP[e] for e in reversed(elems))
        total = config.msg_len + mem
        msg_pos = tuple(total - p for p in reversed(msg_pos))

    return ConvCode(
        config=config,
        mem=mem,
        nstate_conv=1 << mem,
        g0=g0,
        g1=g1,
        initial_state=init,
        final_state=final,
        pattern=elems,
        n_bases=n_bases,
        nstate_pos=n_bases + 1,
        st_pos2msg_pos=msg_pos,
        sync_marker_bits=sync_bits,
        sync_period=config.sync_period,
    )


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _puncture_index(code: ConvCode) -> np.ndarray:
    """Static gather index: punctured-bit position -> raw encoded-bit position."""
    keep: List[int] = []
    i = 0
    for p in code.pattern:
        a, b = _PATTERN_KEEP[p]
        keep.extend((i + a, i + b))
        i += _PATTERN_SPAN[p]
    assert i == 2 * code.total_bits
    return np.asarray(keep, dtype=np.int64)


def termination_bits(code: ConvCode) -> np.ndarray:
    """Termination input bits that drive the register to final_state.

    Bit i of final_state is fed at termination step i
    (viterbi_convolutional_code.cpp:459-464).
    """
    return int_bits_lsb(code.final_state, code.mem)


def conv_encode_bases(code: ConvCode, msgs: np.ndarray) -> np.ndarray:
    """Encode a batch of messages to DNA base indices.

    Args:
      code: a forward (rc=False) ConvCode.
      msgs: uint8 [B, msg_len] message bits.

    Returns:
      uint8 [B, n_bases] with values 0..3 (A,C,G,T).
    """
    if code.config.rc:
        raise ValueError("encoding uses the forward code; rc applies to decode")
    msgs = np.atleast_2d(np.asarray(msgs, dtype=np.uint8))
    batch, msg_len = msgs.shape
    if msg_len != code.config.msg_len:
        raise ValueError(f"message length {msg_len} != config {code.config.msg_len}")
    mem = code.mem

    # Extended stream: initial-state bits (LSB first = oldest first), message,
    # termination bits. Window k of length mem+1 is exactly (state_k | bit<<mem).
    init_bits = int_bits_lsb(code.initial_state, mem)
    term = termination_bits(code)
    stream = np.concatenate(
        [np.broadcast_to(init_bits, (batch, mem)), msgs,
         np.broadcast_to(term, (batch, mem))], axis=1,
    )
    windows = np.lib.stride_tricks.sliding_window_view(stream, mem + 1, axis=1)
    gmat = np.stack([int_bits_lsb(code.g0, mem + 1), int_bits_lsb(code.g1, mem + 1)])
    # out[b, k, i] = parity(window . G_i)
    out = (windows.astype(np.int64) @ gmat.T.astype(np.int64)) & 1
    raw = out.reshape(batch, -1)  # interleaved out0, out1 per input bit
    punct = raw[:, _puncture_index(code)]
    return (2 * punct[:, 0::2] + punct[:, 1::2]).astype(np.uint8)


def bases_to_str(bases: np.ndarray) -> List[str]:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return ["".join(map(chr, lut[row])) for row in np.atleast_2d(bases)]


def str_to_bases(seqs) -> np.ndarray:
    if isinstance(seqs, str):
        seqs = [seqs]
    lut = np.full(128, 255, dtype=np.uint8)
    for i, c in enumerate(BASES):
        lut[ord(c)] = i
    arr = np.stack([lut[np.frombuffer(s.encode(), dtype=np.uint8)] for s in seqs])
    if (arr == 255).any():
        raise ValueError("invalid base character")
    return arr


def reverse_complement_bases(bases: np.ndarray) -> np.ndarray:
    """A<->T, C<->G and reverse; complement of base i is 3-i in ACGT order."""
    return (3 - np.asarray(bases))[..., ::-1].astype(np.uint8)
