"""Batched list-Viterbi (parallel LVA) decoder over the joint
(position x conv-state x CRF-state) trellis — pure JAX, vmap over reads,
lax.scan over signal blocks.

This module holds the message-carrying ORACLE (backend "oracle") and the
``LVADecoder`` entry point; the production path is the selection
traceback of ops/lva_traceback.py (backend "traceback", the default).
The oracle is a faithful reformulation of
``decode_post_conv_parallel_LVA`` (reference
viterbi/viterbi_convolutional_code.cpp:589-858):

* The per-state lazy heap merge with message dedup (cpp:744-799) becomes a
  fixed-round K-way merge: each of the Q = 1 + 4*8 predecessors (stay plus
  (conv-candidate, CRF-predecessor) pairs) exposes a sorted candidate list
  (its predecessor's sorted L-list plus a transition score); each round takes
  the global head via argmax, rejects messages already accepted, and advances
  that predecessor's pointer. With merge_rounds >= Q*L this is exhaustive
  (exact reference heap semantics); the default 2L+2 is validated
  list-for-list against the reference binary on golden cases.
* Duplicate detection uses two independent modular hashes of the message
  value (h = msg mod p, p < 2^30 prime), updated incrementally per appended
  bits — so the merge rounds touch 3 words per (state, slot) instead of the
  full packed message. Collision probability over a full read is < 1e-7.
  Messages themselves are materialized once per block from the winning
  (predecessor, list-slot) selections and carried as packed uint32 words,
  like the reference's 256-bit bitsets (cpp:28-29,607-620) — no traceback.
* The beam (max-deviation window, cpp:673-687) is a dynamic slice over the
  position axis; out-of-window states keep stale values in the inactive
  buffer exactly like the reference's swapped double buffers, which matters
  for bit-parity at the trailing edge of the beam.
* Conv-state predecessor gathers use the shift-register structure
  (prev = (k*s + c) mod 2^m  <=>  reshape+tile), not per-state index tables.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DecodeConfig
from ..coding.conv import ConvCode, NSTATE_CRF
from ..trellis import tables as tb

NEG_INF = -jnp.inf
NCRF = NSTATE_CRF  # 8
NC = 4  # conv-candidate slots (2 used by pattern 0)
NQ = 1 + NC * NCRF  # predecessors per state: stay + (c, g)

# dual modular-hash dedup primes (largest primes < 2^30 so that
# (h << 2) + 3 stays within uint32)
HASH_P1 = np.uint32(1073741789)
HASH_P2 = np.uint32(1073741783)


def msg_words(code: ConvCode) -> int:
    return -(-(code.config.msg_len + code.mem) // 32)


@dataclasses.dataclass(frozen=True)
class LVASpec:
    """Static decode problem spec: everything shape-determining."""

    code: ConvCode
    list_size: int
    merge_rounds: int
    window: int
    npos_pad: int  # includes 1 leading ghost row for position -1
    n_msg_words: int
    combine_lse: bool = False  # logsumexp duplicate-path combining

    @classmethod
    def build(cls, cfg: DecodeConfig) -> Tuple["LVASpec", tb.TrellisTables]:
        from ..coding.conv import make_conv_code

        code = make_conv_code(cfg.code)
        tabs = tb.build_tables(code, cfg.max_deviation)
        return cls(
            code=code,
            list_size=cfg.list_size,
            merge_rounds=cfg.merge_rounds_,
            window=tabs.window,
            npos_pad=tabs.npos_pad + 1,
            n_msg_words=msg_words(code),
            combine_lse=cfg.path_combine == "logsumexp",
        ), tabs


def _consts(spec: LVASpec, tabs: tb.TrellisTables):
    """Device-constant tables (small, replicated)."""
    return dict(
        stay_idx=jnp.asarray(tb.stay_post_index()),  # [8]
        move_idx=jnp.asarray(tb.move_post_index()),  # [8,8]
        crf_mask=jnp.asarray(tb.crf_move_mask()),  # [8,8]
        base_out=jnp.asarray(tabs.base_out.astype(np.int32)),  # [4,C,4]
        base_out_cmin=jnp.asarray(
            np.transpose(tabs.base_out.astype(np.int32), (0, 2, 1))),
        newbits1=jnp.asarray(tabs.newbits1.astype(np.uint32)),  # [C]
        newbits2=jnp.asarray(tabs.newbits2.astype(np.uint32)),  # [C]
        # valid_state with the leading ghost row (pos -1): all False.
        valid_state=jnp.asarray(
            np.concatenate([np.zeros((1, tabs.nstate_conv), bool),
                            tabs.valid_state])),  # [npos_pad, C]
        pattern_of_pos=jnp.asarray(
            np.concatenate([[0], tabs.pattern_of_pos]).astype(np.int32)),
    )


def _shift_msg(msg: jnp.ndarray, shift: jnp.ndarray,
               newbits: jnp.ndarray) -> jnp.ndarray:
    """msg' = (msg << shift) | newbits over packed uint32 words.

    msg: [..., M] uint32, word 0 = least-significant. shift in {0,1,2}
    broadcastable to [...]; newbits broadcastable to [...].
    """
    shift = shift.astype(jnp.uint32)[..., None]
    carry_shift = jnp.where(shift == 0, jnp.uint32(1), 32 - shift)
    up = msg << shift
    carry = jnp.where(shift == 0, jnp.uint32(0), msg >> carry_shift)
    carry = jnp.concatenate(
        [jnp.zeros_like(carry[..., :1]), carry[..., :-1]], axis=-1)
    out = up | carry
    first = out[..., 0] | newbits.astype(jnp.uint32)
    return jnp.concatenate([first[..., None], out[..., 1:]], axis=-1)


def _hash_update(h: jnp.ndarray, shift: jnp.ndarray, newbits: jnp.ndarray,
                 p: np.uint32) -> jnp.ndarray:
    """h' = (h * 2^shift + newbits) mod p for h < p, shift in {0,1,2}."""
    t = (h << shift.astype(jnp.uint32)) + newbits.astype(jnp.uint32)
    t = jnp.where(t >= p, t - p, t)
    t = jnp.where(t >= p, t - p, t)
    t = jnp.where(t >= p, t - p, t)
    return t


def _expand_minor(x: jnp.ndarray, k: int, C: int) -> jnp.ndarray:
    """Predecessor view over the conv axis (minor axis of [..., C]).

    out[..., c, s] = x[..., (k*s + c) mod C] for c in [0, k): the trellis
    shift-register structure as a reshape + minor-dims transpose + tile —
    no gathers. Returns [..., k, C].
    """
    r = x.reshape(x.shape[:-1] + (C // k, k))
    rt = jnp.swapaxes(r, -1, -2)  # [..., k, C//k]
    reps = (1,) * (rt.ndim - 1) + (k,)
    return jnp.tile(rt, reps)


def _shift_msg_m(msg: jnp.ndarray, shift: jnp.ndarray,
                 newbits: jnp.ndarray) -> jnp.ndarray:
    """msg' = (msg << shift) | newbits over packed uint32 words.

    msg: [..., M, L, C] with word 0 least-significant along axis -3;
    shift/newbits broadcastable to [..., L, C], shift in {0, 1, 2}.
    """
    sh = shift.astype(jnp.uint32)[..., None, :, :]
    carry_shift = jnp.where(sh == 0, jnp.uint32(1), 32 - sh)
    up = msg << sh
    carry = jnp.where(sh == 0, jnp.uint32(0), msg >> carry_shift)
    carry = jnp.concatenate(
        [jnp.zeros_like(carry[..., :1, :, :]), carry[..., :-1, :, :]],
        axis=-3)
    out = up | carry
    first = out[..., 0, :, :] | newbits.astype(jnp.uint32)
    return jnp.concatenate([first[..., None, :, :], out[..., 1:, :, :]],
                           axis=-3)


def _step(spec: LVASpec, consts, carry, xs):
    """One signal block t.

    The conv axis is minor everywhere. Buffers: scores/hashes
    [P, 8crf, L, C]; messages [P, 8crf, M, L, C].
    """
    (prev_sc, prev_h1, prev_h2, prev_m,
     stale_sc, stale_h1, stale_h2, stale_m) = carry
    post_t, start, active = xs  # [5,8] f32, scalar int32, scalar bool
    C = spec.code.nstate_conv
    L, M = spec.list_size, spec.n_msg_words
    W = spec.window
    postf = post_t.reshape(-1)  # [40]
    bufs = (stale_sc, stale_h1, stale_h2, stale_m)

    def update_chunk(start1, bufs):
        stale_sc, stale_h1, stale_h2, stale_m = bufs
        pos_w = start1 + jnp.arange(W)

        def slc(a, s0):
            return jax.lax.dynamic_slice_in_dim(a, s0, W, axis=0)

        p_sc = slc(prev_sc, start1)  # [W,8,L,C] stay sources
        p_h1 = slc(prev_h1, start1)
        p_h2 = slc(prev_h2, start1)
        pm1_sc = slc(prev_sc, start1 - 1)  # move sources (previous position)
        pm1_h1 = slc(prev_h1, start1 - 1)
        pm1_h2 = slc(prev_h2, start1 - 1)

        pat_w = consts["pattern_of_pos"][pos_w]  # [W]
        is1 = pat_w == 0

        def expand(a, fill):
            """[W, 8g, L, C] -> [W, NC, 8g, L, C] move-candidate lists."""
            e2 = jnp.moveaxis(_expand_minor(a, 2, C), -2, 1)  # [W,2,8,L,C]
            e4 = jnp.moveaxis(_expand_minor(a, 4, C), -2, 1)  # [W,4,8,L,C]
            e2 = jnp.concatenate([e2, jnp.full_like(e2, fill)], axis=1)
            return jnp.where(is1[:, None, None, None, None], e2, e4)

        src = expand(pm1_sc, NEG_INF)  # [W,4c,8g,L,C]
        srch1 = expand(pm1_h1, jnp.uint32(0))
        srch2 = expand(pm1_h2, jnp.uint32(0))

        # --- transition scores and validity ------------------------------------
        stay_tr = postf[consts["stay_idx"]]  # [8]
        move_tr = postf[consts["move_idx"]]  # [f, g]
        bo = consts["base_out_cmin"][pat_w]  # [W, NC, C] emitted base per (c, s)
        f_ids = jnp.arange(NCRF, dtype=jnp.int32)
        base_match = bo[:, None, :, :] == (f_ids % 4)[None, :, None, None]
        c_valid = jnp.arange(NC)[None, :] < jnp.where(is1, 2, 4)[:, None]
        mvalid = base_match & c_valid[:, None, :, None] \
            & (pos_w > 1)[:, None, None, None]  # [W,8f,4c,C]
        mtr = jnp.where(
            mvalid[:, :, :, None, :] & consts["crf_mask"][None, :, None, :, None],
            move_tr[None, :, None, :, None], NEG_INF)  # [W,8f,4c,8g,C]
        mtr_flat = mtr.reshape(W, NCRF, NQ - 1, C)

        shift2 = jnp.where(is1, 1, 2).astype(jnp.uint32)  # [W]
        nbits_w = jnp.where(is1[:, None], consts["newbits1"][None, :],
                            consts["newbits2"][None, :])  # [W, C]

        q_range = jnp.arange(NQ)
        l_range = jnp.arange(L)

        def slc_l(a, l):
            """a[..., l, :] with a traced slot index (keeps HLO small)."""
            idx = (0,) * (a.ndim - 2) + (l, 0)
            sizes = a.shape[:-2] + (1, a.shape[-1])
            return jax.lax.dynamic_slice(a, idx, sizes).squeeze(-2)

        def cand_at(l):
            """Per-pred candidate tuple at list slot l (traced): ([W,8f,NQ,C]
            score, hash1, hash2); move hashes already shift-updated."""
            stay_s = slc_l(p_sc, l) + stay_tr[None, :, None]  # [W,8,C]
            move_s = slc_l(src, l).reshape(W, 1, NQ - 1, C) + mtr_flat
            sc = jnp.concatenate([stay_s[:, :, None, :], move_s], axis=2)
            mh1 = _hash_update(slc_l(srch1, l),
                               shift2[:, None, None, None],
                               nbits_w[:, None, None, :], HASH_P1)
            mh2 = _hash_update(slc_l(srch2, l),
                               shift2[:, None, None, None],
                               nbits_w[:, None, None, :], HASH_P2)
            h1 = jnp.concatenate(
                [slc_l(p_h1, l)[:, :, None, :],
                 jnp.broadcast_to(mh1.reshape(W, 1, NQ - 1, C),
                                  (W, NCRF, NQ - 1, C))], axis=2)
            h2 = jnp.concatenate(
                [slc_l(p_h2, l)[:, :, None, :],
                 jnp.broadcast_to(mh2.reshape(W, 1, NQ - 1, C),
                                  (W, NCRF, NQ - 1, C))], axis=2)
            return sc, h1, h2

        def round_body(_, st):
            (head_sc, head_h1, head_h2, ptr, out_sc, out_h1, out_h2,
             out_q, out_lp, acc) = st
            qstar = jnp.argmax(head_sc, axis=2)  # [W,8,C]
            oh_q = qstar[:, :, None, :] == q_range[None, None, :, None]
            hstar = jnp.max(head_sc, axis=2)
            ok = hstar > NEG_INF
            ch1 = jnp.where(oh_q, head_h1, 0).sum(2).astype(jnp.uint32)
            ch2 = jnp.where(oh_q, head_h2, 0).sum(2).astype(jnp.uint32)
            ptr_star = jnp.where(oh_q, ptr, 0).sum(2)
            lidx = jnp.clip(ptr_star, 0, L - 1)

            # dedup against accepted candidates
            eq = (out_h1 == ch1[:, :, None, :]) & (out_h2 == ch2[:, :, None, :])
            eq = eq & (l_range[None, None, :, None] < acc[:, :, None, :])
            seen = eq.any(2)
            if spec.combine_lse:
                # accumulate duplicate-path probability mass into the accepted
                # slot instead of discarding (extra/viterbi_nanopore.cpp:883-888)
                out_sc = jnp.where(eq & ok[:, :, None, :],
                                   jnp.logaddexp(out_sc, hstar[:, :, None, :]),
                                   out_sc)

            accept = ok & ~seen & (acc < L)
            onehot = (l_range[None, None, :, None] == acc[:, :, None, :]) & \
                accept[:, :, None, :]
            out_sc = jnp.where(onehot, hstar[:, :, None, :], out_sc)
            out_h1 = jnp.where(onehot, ch1[:, :, None, :], out_h1)
            out_h2 = jnp.where(onehot, ch2[:, :, None, :], out_h2)
            out_q = jnp.where(onehot, qstar[:, :, None, :], out_q)
            out_lp = jnp.where(onehot, lidx[:, :, None, :], out_lp)
            acc = acc + accept.astype(jnp.int32)

            # advance the winner's pointer and refresh its head
            adv = oh_q & ok[:, :, None, :]
            ptr = ptr + adv.astype(jnp.int32)
            exhausted = ptr >= L
            new_head_sc = jnp.where(exhausted, NEG_INF, head_sc)
            new_head_h1 = head_h1
            new_head_h2 = head_h2
            pl = jnp.clip(ptr, 0, L - 1)

            def refresh(l, hs):
                nsc, nh1, nh2 = hs
                at = adv & (pl == l)
                c_sc, c_h1, c_h2 = cand_at(l)
                nsc = jnp.where(at & ~exhausted, c_sc, nsc)
                nh1 = jnp.where(at, c_h1, nh1)
                nh2 = jnp.where(at, c_h2, nh2)
                return nsc, nh1, nh2

            # refreshed heads always have ptr >= 1
            new_head_sc, new_head_h1, new_head_h2 = jax.lax.fori_loop(
                1, L, refresh, (new_head_sc, new_head_h1, new_head_h2))
            return (new_head_sc, new_head_h1, new_head_h2, ptr, out_sc,
                    out_h1, out_h2, out_q, out_lp, acc)

        init_head_sc, init_head_h1, init_head_h2 = cand_at(0)
        init = (
            init_head_sc, init_head_h1, init_head_h2,
            jnp.zeros((W, NCRF, NQ, C), jnp.int32),
            jnp.full((W, NCRF, L, C), NEG_INF, jnp.float32),
            jnp.zeros((W, NCRF, L, C), jnp.uint32),
            jnp.zeros((W, NCRF, L, C), jnp.uint32),
            jnp.zeros((W, NCRF, L, C), jnp.int32),
            jnp.zeros((W, NCRF, L, C), jnp.int32),
            jnp.zeros((W, NCRF, C), jnp.int32),
        )
        (_, _, _, _, new_sc, new_h1, new_h2, out_q, out_lp, _) = \
            jax.lax.fori_loop(0, spec.merge_rounds, round_body, init)

        # --- materialize messages from the winning selections -------------------
        # Masked accumulation over (pred, source slot).
        p_m = slc(prev_m, start1)  # [W,8,M,L,C]
        pm1_m = slc(prev_m, start1 - 1)

        def move_src_m(c, g, l):
            """Message words of move predecessor (c, g) at slot l (all traced
            indices): [W, M, C]."""
            v = jax.lax.dynamic_slice(
                pm1_m, (0, g, 0, l, 0), (W, 1, M, 1, C)).reshape(W, M, C)
            v2 = jax.lax.dynamic_slice(
                v.reshape(W, M, C // 2, 2), (0, 0, 0, c % 2),
                (W, M, C // 2, 1)).squeeze(-1)
            v4 = jax.lax.dynamic_slice(
                v.reshape(W, M, C // 4, 4), (0, 0, 0, jnp.clip(c, 0, 3)),
                (W, M, C // 4, 1)).squeeze(-1)
            sel = jnp.where(is1[:, None, None], jnp.tile(v2, (1, 1, 2)),
                            jnp.tile(v4, (1, 1, 4)))
            return sel

        is_stay_l = out_q == 0  # [W,8,L,C]
        lp = jnp.clip(out_lp, 0, L - 1)
        raw_m = jnp.zeros((W, NCRF, M, L, C), jnp.uint32)
        for l_src in range(L):
            at_l = lp == l_src
            raw_m = jnp.where((is_stay_l & at_l)[:, :, None, :, :],
                              p_m[:, :, :, l_src, :][:, :, :, None, :], raw_m)

        def sel_move(i, acc_m):
            """i ranges over (l_src, c, g); masked-accumulate that source."""
            l_src = i // (NQ - 1)
            cg = i % (NQ - 1)
            c = cg // NCRF
            g = cg % NCRF
            q = 1 + cg
            sel = (out_q == q) & (lp == l_src)  # [W,8,L,C]
            return jnp.where(sel[:, :, None, :, :],
                             move_src_m(c, g, l_src)[:, None, :, None, :], acc_m)

        raw_m = jax.lax.fori_loop(0, L * (NQ - 1), sel_move, raw_m)
        sh_l = jnp.where(is_stay_l, 0, shift2[:, None, None, None]).astype(
            jnp.uint32)
        nb_l = jnp.where(is_stay_l, 0, nbits_w[:, None, None, :]).astype(
            jnp.uint32)
        new_m = _shift_msg_m(raw_m, sh_l, nb_l)

        # --- position 0: stay-only, list slot 0 only (cpp:706-713) -------------
        ispos0 = pos_w == 1
        m0 = ispos0[:, None, None, None]
        slot0 = l_range[None, None, :, None] == 0
        pos0_sc = jnp.where(slot0, p_sc + stay_tr[None, :, None, None], NEG_INF)
        new_sc = jnp.where(m0, pos0_sc, new_sc)
        new_h1 = jnp.where(m0, p_h1, new_h1)
        new_h2 = jnp.where(m0, p_h2, new_h2)
        new_m = jnp.where(ispos0[:, None, None, None, None], p_m, new_m)

        # --- masked write-back --------------------------------------------------
        vmask = consts["valid_state"][pos_w]  # [W, C]
        wmask = vmask & active  # [W, C]
        w3 = wmask[:, None, None, :]

        def put(buf, new, mask):
            cur = slc(buf, start1)
            return jax.lax.dynamic_update_slice_in_dim(
                buf, jnp.where(mask, new, cur), start1, axis=0)

        return (put(stale_sc, new_sc, w3), put(stale_h1, new_h1, w3),
                put(stale_h2, new_h2, w3),
                put(stale_m, new_m, wmask[:, None, None, None, :]))

    bufs = update_chunk(start + 1, bufs)
    return bufs + (prev_sc, prev_h1, prev_h2, prev_m), ()


def _init_buffers(spec: LVASpec):
    """State buffers, conv axis minor: scores/hashes [P, 8, L, C],
    messages [P, 8, M, L, C]."""
    C, L, M = spec.code.nstate_conv, spec.list_size, spec.n_msg_words
    P = spec.npos_pad
    sc = jnp.full((P, NCRF, L, C), NEG_INF, jnp.float32)
    # pos 0 lives at padded index 1 (index 0 is the ghost row for pos -1)
    sc = sc.at[1, :, 0, spec.code.initial_state].set(0.0)
    h = jnp.zeros((P, NCRF, L, C), jnp.uint32)
    m = jnp.zeros((P, NCRF, M, L, C), jnp.uint32)
    other_sc = jnp.full((P, NCRF, L, C), NEG_INF, jnp.float32)
    return (sc, h, h, m, other_sc, jnp.zeros_like(h), jnp.zeros_like(h),
            jnp.zeros_like(m))


def _decode_single(spec: LVASpec, consts, post, starts, nblk):
    """Decode one read. post [T,5,8] f32, starts [T] i32, nblk scalar."""
    T = post.shape[0]
    carry = _init_buffers(spec)
    active = jnp.arange(T) < nblk
    step = partial(_step, spec, consts)
    carry, _ = jax.lax.scan(step, carry, (post, starts, active))
    # the buffer written at the read's last active step t = nblk-1: if the
    # total step count and nblk have the same parity it is carry[0] else
    # carry[4] (buffers swap every step, including inactive ones).
    same = (T - nblk) % 2 == 0
    fin_sc = jnp.where(same, carry[0], carry[4])
    fin_m = jnp.where(same, carry[3], carry[7])
    last_pos = spec.code.nstate_pos - 1 + 1  # +1 ghost offset
    sc = fin_sc[last_pos, :, :, spec.code.final_state]  # [8, L]
    m = fin_m[last_pos, :, :, :, spec.code.final_state]  # [8, M, L]
    # collect in (crf, list) order, sort by score desc, truncate to L
    flat_sc = sc.reshape(-1)
    flat_m = jnp.transpose(m, (0, 2, 1)).reshape(-1, spec.n_msg_words)
    order = jnp.argsort(-flat_sc, stable=True)[: spec.list_size]
    return flat_sc[order], flat_m[order]


def _unpack_msgs(spec: LVASpec, msgs: np.ndarray) -> np.ndarray:
    """uint32 words [.., M] -> message bits [.., msg_len] (MSB-first path).

    Bit i of the decoded message is packed bit (msg_len + mem - 1 - i)
    (cpp:828-836); under rc the message is additionally reversed (cpp:835).
    """
    code = spec.code
    msg_len, mem = code.config.msg_len, code.mem
    total = msg_len + mem
    i = np.arange(msg_len)
    bitpos = total - 1 - i
    words = bitpos // 32
    shifts = bitpos % 32
    bits = (msgs[..., words] >> shifts) & 1
    if code.config.rc:
        bits = bits[..., ::-1]
    return bits.astype(np.uint8)


class LVADecoder:
    """Jitted batched list-Viterbi decoder for one DecodeConfig."""

    def __init__(self, cfg: DecodeConfig, mesh=None):
        self.cfg = cfg
        self.spec, self.tables = LVASpec.build(cfg)
        if cfg.backend == "traceback":
            from .lva_traceback import TracebackDecoder

            self.traceback = TracebackDecoder(
                self.spec, self.tables, chunk_blocks=cfg.chunk_blocks,
                mesh=mesh)
        else:
            self.traceback = None
            consts = _consts(self.spec, self.tables)
            single = partial(_decode_single, self.spec, consts)
            self._fn = jax.jit(jax.vmap(single))

    def schedule(self, nblks: np.ndarray, T: int) -> np.ndarray:
        """Per-read beam schedules [B, T] (host-side, float64 like the C++)."""
        out = np.zeros((len(nblks), T), dtype=np.int32)
        for b, n in enumerate(np.asarray(nblks)):
            s = tb.beam_schedule(self.tables, int(n))
            out[b, : int(n)] = s
            out[b, int(n):] = s[-1] if len(s) else 0
        return out

    def decode(self, posts: np.ndarray, nblks: Optional[np.ndarray] = None):
        """Decode a batch.

        Args:
          posts: [B, T, 5, 8] float32 (zero-padded beyond each read's nblk).
          nblks: [B] actual block counts (default: all T).
        Returns:
          (msgs uint8 [B, L, msg_len], scores f32 [B, L], valid bool [B, L])
        """
        posts = np.asarray(posts, dtype=np.float32)
        B, T = posts.shape[:2]
        if nblks is None:
            nblks = np.full((B,), T, np.int64)
        nblks = np.asarray(nblks)
        if (nblks < self.spec.code.nstate_pos + 1).any():
            raise ValueError("post matrix shorter than nstate_pos+1 blocks "
                             "(cpp:600-601)")
        starts = self.schedule(nblks, T)
        if self.traceback is not None:
            if T % 2:  # the traceback forward runs 2-block scan steps
                posts = np.concatenate(
                    [posts, np.zeros((B, 1, 5, 8), np.float32)], axis=1)
                starts = np.concatenate([starts, starts[:, -1:]], axis=1)
            m, sc, valid = self.traceback.decode(posts, starts, nblks)
            return _unpack_msgs(self.spec, m), sc, valid
        sc, m = self._fn(jnp.asarray(posts), jnp.asarray(starts),
                         jnp.asarray(nblks, dtype=jnp.int32))
        sc = np.asarray(sc)
        m = np.asarray(m)
        valid = sc > -np.inf
        return _unpack_msgs(self.spec, m), sc, valid
