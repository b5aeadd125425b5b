"""List-Viterbi decode by per-block selections + traceback (the production
path).

Faithful to ``decode_post_conv_parallel_LVA`` (reference
viterbi/viterbi_convolutional_code.cpp:589-858); validated list-for-list
against the message-carrying oracle (ops/lva.py) and the golden lists.

Design notes (docs/DESIGN.md §5 has the long version):

* **Shift-register predecessors.** Conv state ``s`` is entered from
  ``(k*s + c) mod C`` (k = 2 for pattern 0, 4 otherwise).
* **Base-compacted candidate lists.** Bit 0 of both generator polynomials
  is 1 for every supported code, so (dropped bits c) -> emitted base is
  injective per (pattern, state): the candidate planes compact to ONE
  plane per emitted base, gathered from ``(k*s + cstar) mod C`` (the
  ``cstar`` table names the one c per (pattern, base, state)), and each
  CRF destination merges 1 + |G_f| <= 8 sorted lists (stay + one per legal
  CRF predecessor, cpp:878-889) instead of 1 + 4*|G_f|.
* **Suppression merge.** The reference's lazy heap with message dedup
  (cpp:744-799) runs as L rounds over the nq*L candidates of each
  destination: a round pops the global max into list slot r and knocks out
  the winner's whole equal-dual-hash class, so later pops are distinct by
  construction. This is exhaustive (exact heap semantics), and under
  ``logsumexp`` the whole class's mass combines at pop time.
* **Selections, not messages.** The cell emits, per accepted list slot,
  the winning (predecessor, source-slot) code. Messages are reconstructed
  after the scan by walking selections backward (``_tb_chunk``),
  replicating the double-buffer staleness rule: a read at block t sees the
  last write to that position with time parity (t-1) mod 2 — exactly the
  reference's swapped full buffers (cpp:667-687). Device memory carries
  only scores and hashes, never [states, L, 256-bit] messages.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..trellis import tables as tb
from .lva import HASH_P1, HASH_P2, _hash_update

NCRF = 8
NEG = float("-inf")

# static CRF move mask: flip f from any g != f; flop f from flip f-4 only
CRF_MASK = tb.crf_move_mask()  # bool [8, 8]
G_LISTS = [tuple(int(g) for g in range(NCRF) if CRF_MASK[f, g])
           for f in range(NCRF)]
NQ_F = [1 + len(gl) for gl in G_LISTS]
NQ_MAX = max(NQ_F)
# CRF destinations merged together: flips (nq = 8) and flops (nq = 2)
MERGE_GROUPS = (tuple(range(4)), tuple(range(4, NCRF)))


def sel_format(L: int):
    """(dtype, shift) of the per-slot selection code q*shift + lsrc.

    q <= 7 (NQ_MAX - 1), so for L <= 16 the code fits int8
    (max 7*16 + 15 = 127), halving the [T, W, 8*L, C] selections buffer -
    decisive for m=14, whose int16 selections alone exceed device memory."""
    return (jnp.int8, 16) if L <= 16 else (jnp.int16, 64)


class TracebackConsts(NamedTuple):
    """Host tables for the cell + traceback (conv axis in natural order)."""

    nbits: np.ndarray  # uint32 [2, C] newbits (1-bit, 2-bit packed)
    valid: np.ndarray  # bool [Pv, C] valid-state incl. leading ghost row
    pattern: np.ndarray  # int32 [Pv]
    stay_idx: np.ndarray  # int32 [8] flat post index of stays
    move_idx: np.ndarray  # int32 [8, 8]
    qmap: np.ndarray  # int32 [8, NQ_MAX] local q -> CRF predecessor g; -1 pad
    cstar: np.ndarray  # int32 [4 pat, 4 base, C] the unique conv candidate c
    #                    emitting base beta into state s; -1 if none
    init_state: int
    final_state: int


def build_consts(spec, tabs: tb.TrellisTables) -> TracebackConsts:
    code = spec.code
    C = code.nstate_conv
    base_out = tabs.base_out.astype(np.int32)  # [4 pat, C, 4 c]
    valid = np.concatenate([np.zeros((1, C), bool), tabs.valid_state])
    pattern = np.concatenate([[0], tabs.pattern_of_pos]).astype(np.int32)
    qmap = np.full((NCRF, NQ_MAX), -1, np.int32)
    for f in range(NCRF):
        for qi, g in enumerate(G_LISTS[f]):
            qmap[f, 1 + qi] = g
    # the unique candidate c emitting each base (injectivity assert: the
    # compacted merge is exact only if no two c's share a base per state)
    cstar = np.full((4, 4, C), -1, np.int32)
    for p in range(4):
        ncs = 2 if p == 0 else 4
        for beta in range(4):
            hit = base_out[p, :, :ncs].T == beta  # [ncs, C]
            assert (hit.sum(axis=0) <= 1).all(), \
                f"base map not injective (pattern {p})"
            cstar[p, beta] = np.where(hit.any(axis=0), hit.argmax(axis=0), -1)
    return TracebackConsts(
        nbits=np.stack([tabs.newbits1, tabs.newbits2]).astype(np.uint32),
        valid=valid, pattern=pattern, stay_idx=tb.stay_post_index(),
        move_idx=tb.move_post_index(), qmap=qmap, cstar=cstar,
        init_state=int(code.initial_state),
        final_state=int(code.final_state))


def _compact_moves(spec, dev, src, pat, posgate):
    """Move candidates of every (CRF predecessor g, list slot, state s),
    compacted by emitted base: src (sc, h1, h2) [W, 8g, L, C] at the
    previous position -> (sc, h1, h2) [W, 4 base, 8g, L, C], hashes
    already extended by the appended message bits."""
    C = spec.code.nstate_conv
    is1 = (pat == 0)[:, None, None, None]  # [W, 1, 1, 1]
    cst = dev["cstar"][pat][:, :, None, None, :]  # [W, 4 base, 1, 1, C]
    shift = jnp.where(is1, 1, 2).astype(jnp.uint32)
    nb = jnp.where(is1, dev["nbits"][0], dev["nbits"][1])  # [W,1,1,C]
    # state s is entered with base beta from (k*s + cstar) mod C, the
    # traceback's predecessor step (k = 2 for pattern 0, else 4)
    k = jnp.where(is1, 2, 4)[:, None]  # [W, 1, 1, 1, 1]
    prev = (k * jnp.arange(C) + jnp.maximum(cst, 0)) % C

    def compact(x, fill):
        v = jnp.take_along_axis(x[:, None], prev, axis=-1)
        return jnp.where(cst >= 0, v, fill)  # [W, 4 base, 8, L, C]

    sc = compact(src[0], NEG)
    sc = jnp.where(posgate[:, None, None, None, None], sc, NEG)
    h1 = _hash_update(compact(src[1], 0), shift[:, None], nb[:, None],
                      HASH_P1)
    h2 = _hash_update(compact(src[2], 0), shift[:, None], nb[:, None],
                      HASH_P2)
    return sc, h1, h2


def _merge_group(spec, fs, stay, moves, stay_tr, move_tr):
    """Top-L-with-dedup for the CRF destinations ``fs`` (all with the same
    predecessor count nq). Returns (sc, h1, h2, sel) [W, F, L, C]."""
    L = spec.list_size
    nq = NQ_F[fs[0]]
    assert all(NQ_F[f] == nq for f in fs)
    fa = np.asarray(fs)
    # candidate rows per destination: stay, then moves from G_LISTS order
    g_idx = np.asarray([G_LISTS[f] for f in fs])  # [F, nq-1]
    b_idx = (fa % 4)[:, None]  # emitted base of a move into f
    tr = [stay_tr[fa], move_tr[fa[:, None], g_idx]]  # [F], [F, nq-1]

    def rows(a, add_tr):
        st = a[0][:, fa]  # [W, F, L, C]
        mv = a[1][:, b_idx, g_idx]  # [W, F, nq-1, L, C]
        if add_tr:
            st = st + tr[0][None, :, None, None]
            mv = mv + tr[1][None, :, :, None, None]
        c = jnp.concatenate([st[:, :, None], mv], axis=2)
        return c.reshape(c.shape[0], len(fs), nq * L, c.shape[-1])

    csc = rows((stay[0], moves[0]), True)
    ch1 = rows((stay[1], moves[1]), False)
    ch2 = rows((stay[2], moves[2]), False)
    shift = sel_format(L)[1]
    W, F, _, C = csc.shape
    lse = spec.combine_lse

    def pop(r, carry):
        csc, out = carry
        q = jnp.argmax(csc, axis=2)[:, :, None]  # first max: heap tie order
        best = jnp.take_along_axis(csc, q, axis=2)
        h1 = jnp.take_along_axis(ch1, q, axis=2)
        h2 = jnp.take_along_axis(ch2, q, axis=2)
        ok = best > NEG
        eqh = (ch1 == h1) & (ch2 == h2)
        val = best
        if lse:
            # the whole duplicate class's path mass combines at pop time
            # (extra/viterbi_nanopore.cpp:883-888)
            mass = jnp.where(eqh & (csc > NEG), jnp.exp(csc - best), 0.0)
            val = best + jnp.log(mass.sum(axis=2, keepdims=True))
        csc = jnp.where(eqh, NEG, csc)
        code = jnp.where(ok, (q // L) * shift + q % L, -1)
        new = (val, jnp.where(ok, h1, 0), jnp.where(ok, h2, 0), code)
        out = tuple(jax.lax.dynamic_update_index_in_dim(o, n[:, :, 0], r, 2)
                    for o, n in zip(out, new))
        return csc, out

    out = (jnp.full((W, F, L, C), NEG, jnp.float32),
           jnp.zeros((W, F, L, C), jnp.uint32),
           jnp.zeros((W, F, L, C), jnp.uint32),
           jnp.full((W, F, L, C), -1, jnp.int32))
    carry = (csc, out)
    if L <= 16:  # unrolled rounds; a loop for the large lists (m=8 L=64)
        for r in range(L):
            carry = pop(r, carry)
    else:
        carry = jax.lax.fori_loop(0, L, pop, carry)
    return carry[1]


def acs_block(spec, dev: Dict, prev, stale, postf, start1, active):
    """One signal-block ACS step over the full beam window.

    prev/stale: (sc f32, h1 u32, h2 u32), each [P, 8, L, C]. Returns
    (new_sc, new_h1, new_h2, sel [W, 8L, C]); the new buffers are the stale
    ones with the window rows [start1, start1 + W) updated.
    """
    L = spec.list_size
    W = spec.window
    sl = partial(jax.lax.dynamic_slice_in_dim, slice_size=W, axis=0)
    pos = start1 + jnp.arange(W)
    pat = dev["pattern"][pos]
    stay = tuple(sl(a, start1) for a in prev)  # [W, 8, L, C]
    src = tuple(sl(a, start1 - 1) for a in prev)  # move sources
    moves = _compact_moves(spec, dev, src, pat, pos > 1)
    stay_tr = postf[dev["stay_idx"]]  # [8]
    move_tr = postf[dev["move_idx"]]  # [8 f, 8 g]
    outs = [_merge_group(spec, fs, stay, moves, stay_tr, move_tr)
            for fs in MERGE_GROUPS]
    osc, oh1, oh2, osel = (jnp.concatenate(a, axis=1) for a in zip(*outs))

    # position 0 (padded row 1): stay-only, slot 0 scored, all list slots
    # carried through unchanged (cpp:706-713)
    isp0 = (pos == 1)[:, None, None, None]
    iL = jnp.arange(L)[None, None, :, None]
    p0 = jnp.where(iL == 0, stay[0] + stay_tr[None, :, None, None], NEG)
    osc = jnp.where(isp0, p0, osc)
    oh1 = jnp.where(isp0, stay[1], oh1)
    oh2 = jnp.where(isp0, stay[2], oh2)
    osel = jnp.where(isp0, iL, osel)

    # masked write-back; t >= nblk (inactive) keeps the stale buffer
    wm = (dev["valid"][pos] & active)[:, None, None, :]  # [W, 1, 1, C]
    new = [jax.lax.dynamic_update_slice_in_dim(
        s, jnp.where(wm, o, sl(s, start1)), start1, axis=0)
        for s, o in zip(stale, (osc, oh1, oh2))]
    sel = jnp.where(wm, osel, -1).reshape(W, NCRF * L, -1)
    return (*new, sel.astype(sel_format(L)[0]))


# ---------------------------------------------------------------------------
# Forward scan + traceback (chunked over signal blocks)
# ---------------------------------------------------------------------------
#
# The forward emits per-block selections consumed by the traceback. Keeping
# the whole [T, W, 8L, C] selections tensor inside ONE jitted
# forward+traceback program made XLA hold roughly two copies of it (the
# scan ys plus the reverse-scan view). The decode therefore runs as a
# host-orchestrated loop of jitted CHUNK programs over K-block slices:
# forward chunks carry the (prev, stale) buffers with donation (so the
# carries alias in place) and emit only their own K-block selections slice;
# traceback chunks walk the slices in reverse, dropping each slice's device
# buffer as soon as it is consumed. Peak device memory is one selections
# copy plus one buffer set, and the chunk loop is the natural seam for
# sharding (parallel/mesh.py wraps the chunk programs in shard_map over the
# batch axis). Host<->device traffic stays at O(posts + lists).


def _init_buffers(spec, consts: TracebackConsts):
    C, L = spec.code.nstate_conv, spec.list_size
    P = spec.npos_pad  # includes the leading ghost row
    sc = jnp.full((P, NCRF, L, C), NEG, jnp.float32)
    sc = sc.at[1, :, 0, consts.init_state].set(0.0)
    h = jnp.zeros((P, NCRF, L, C), jnp.uint32)
    o = jnp.full((P, NCRF, L, C), NEG, jnp.float32)
    return (sc, h, h, o, jnp.zeros_like(h), jnp.zeros_like(h))


def _forward_chunk(spec, dev, carry, post, starts, active):
    """Scan the ACS cell over one K-block slice.

    carry: ((sc,h1,h2) prev, (sc,h1,h2) stale); post [K,5,8]; starts [K];
    active [K] bool. Returns (carry', sels0, sels1) with selections paired
    ([K/2, W, 8L, C] each) for even/odd blocks of the slice.

    Two blocks per scan step: the (prev, stale) buffer roles swap every
    block, and a one-block step would permute the scan carry — which XLA
    implements as full-buffer copies. The 2-block step returns each buffer
    in the carry slot it arrived in, so the in-place window updates keep
    the whole scan copy-free.
    """
    K = post.shape[0]
    assert K % 2 == 0

    def step(carry, xs):
        pA, pB = carry  # pA = prev (sc,h1,h2), pB = stale
        post2, start2, act2 = xs  # leading axis 2
        n0 = acs_block(spec, dev, pA, pB, post2[0].reshape(-1),
                       start2[0] + 1, act2[0])
        n1 = acs_block(spec, dev, n0[:3], pA, post2[1].reshape(-1),
                       start2[1] + 1, act2[1])
        # n1 occupies pA's storage, n0 pB's: carry slots keep their buffers
        return (n1[:3], n0[:3]), (n0[3], n1[3])

    pair = lambda a: a.reshape((K // 2, 2) + a.shape[1:])  # noqa: E731
    carry, (sels0, sels1) = jax.lax.scan(
        step, carry, (pair(post), pair(starts), pair(active)))
    return carry, sels0, sels1


def _final_scores(spec, consts, carry, T, nblk):
    """Scores at (last position, final conv state) [8, L] after all chunks.

    The buffer written at the read's last active step t = nblk-1: carry[0]
    was written at block T-1, carry[1] at block T-2 (cf. ops/lva.py).
    """
    same = (T - nblk) % 2 == 0
    fsc = jnp.where(same, carry[0][0], carry[1][0])
    last_row = spec.code.nstate_pos - 1 + 1
    return fsc[last_row, :, :, consts.final_state]  # [8, L]


def window_bounds(starts_np: np.ndarray, nblk: int, npos_pad: int, W: int):
    """Per padded row, the first/last block t (< nblk) whose beam window
    [starts[t]+1, starts[t]+W] covers it. Rows never covered get
    (0, -10)."""
    rows = np.arange(npos_pad)
    s = np.asarray(starts_np[:nblk])
    tlo = np.searchsorted(s, rows - W, side="left")
    thi = np.searchsorted(s, rows - 1, side="right") - 1
    none = tlo > thi
    tlo = tlo.copy()
    thi = thi.copy()
    tlo[none] = 0
    thi[none] = -10
    return tlo.astype(np.int32), thi.astype(np.int32)


def _tb_init(spec, consts, tlo, thi, nblk):
    """Initial traceback state: all 8*L chains parked at the final state."""
    L = spec.list_size
    nch = NCRF * L
    Mw = -(-(spec.code.config.msg_len + spec.code.mem) // 32)
    last_row = spec.code.nstate_pos - 1 + 1
    ch = jnp.arange(nch, dtype=jnp.int32)
    par0 = (nblk - 1) % 2
    tw0 = _lastwrite(tlo, thi, jnp.full((nch,), last_row), nblk - 1, par0)
    return dict(
        pos=jnp.full((nch,), last_row, jnp.int32),
        conv=jnp.full((nch,), consts.final_state, jnp.int32),
        f=ch // L, slot=ch % L,
        tw=tw0,
        words=jnp.zeros((nch, Mw), jnp.int32),
        bitcnt=jnp.zeros((nch,), jnp.int32),
        alive=jnp.ones((nch,), bool),
        okend=jnp.zeros((nch,), bool),
    )


def _lastwrite(tlo, thi, row, tmax, par):
    """Largest block t' <= tmax with parity ``par`` whose window wrote
    ``row``; -1 if the read would hit the initial buffers."""
    x = jnp.minimum(tmax, thi[row])
    x = x - ((x - par) & 1)
    return jnp.where(x >= tlo[row], x, -1)


def _tb_chunk(spec, consts, dev, tlo, thi, st, t0, sels0, sels1, starts):
    """Walk one K-block selections slice backward (blocks t0..t0+K-1),
    carrying the traceback state across chunks.

    Reconstructs packed messages for all 8*L final-state chains,
    replicating the reference's double-buffer staleness: the value a block
    t read for row r was written at the largest t' <= t-1 with
    t' = t-1 (mod 2) and r inside window(t'); if no such t', the read hit
    the initial buffers (parity-1 buffer holds the single seeded state,
    cpp:607-620,667-687).
    """
    C = spec.code.nstate_conv
    L = spec.list_size
    Mw = st["words"].shape[-1]
    K = 2 * sels0.shape[0]
    qmap, pattern, nbits = dev["qmap"], dev["pattern"], dev["nbits"]
    cstar = dev["cstar"]  # [4 pat, 4 base, C]
    lastwrite = partial(_lastwrite, tlo, thi)
    wi_ids = jnp.arange(Mw, dtype=jnp.int32)

    def step(st, xs):
        t, sel_t, start_t = xs
        act = st["alive"] & (st["tw"] == t)
        w_i = jnp.clip(st["pos"] - start_t - 1, 0, sel_t.shape[0] - 1)
        flat = (w_i * (NCRF * L) + st["f"] * L + st["slot"]) * C + st["conv"]
        code = jnp.take(sel_t.reshape(-1), flat).astype(jnp.int32)
        sshift = sel_format(L)[1]
        q = jnp.clip(code // sshift, 0, NQ_MAX - 1)
        lsrc = jnp.clip(code % sshift, 0, L - 1)
        g = qmap[st["f"], q]  # CRF predecessor
        is_stay = q == 0
        pat = pattern[st["pos"]]
        kvar = jnp.where(pat == 0, 0, 1)
        nb = nbits[kvar, st["conv"]].astype(jnp.int32)
        # the conv candidate is determined by (pattern, emitted base,
        # state): the base of a move into CRF state f is f % 4 (cpp:890-904)
        beta = st["f"] % 4
        cflat = (jnp.clip(pat, 0, 3) * 4 + beta) * C + st["conv"]
        c = jnp.clip(jnp.take(cstar.reshape(-1), cflat), 0, 3)
        csrc = ((st["conv"] << (1 + kvar)) + c) % C
        off = st["bitcnt"] % 32
        widx = st["bitcnt"] // 32
        lo = nb << off
        hi = jnp.where(off == 0, 0, (nb >> 1) >> (31 - off))
        add = jnp.where(wi_ids[None] == widx[:, None], lo[:, None], 0) | \
            jnp.where(wi_ids[None] == widx[:, None] + 1, hi[:, None], 0)
        do_move = act & ~is_stay
        words = jnp.where(do_move[:, None], st["words"] | add, st["words"])
        bitcnt = jnp.where(do_move, st["bitcnt"] + 1 + kvar, st["bitcnt"])
        npos = jnp.where(is_stay, st["pos"], st["pos"] - 1)
        nconv = jnp.where(is_stay, st["conv"], csrc)
        nf = jnp.where(is_stay, st["f"], g)
        ntw = lastwrite(npos, t - 1, (t - 1) & 1)
        hit_init = act & (ntw < 0)
        okend = st["okend"] | (hit_init & (((t - 1) & 1) == 1)
                               & (npos == 1) & (nconv == consts.init_state)
                               & (lsrc == 0))
        return dict(
            pos=jnp.where(act, npos, st["pos"]),
            conv=jnp.where(act, nconv, st["conv"]),
            f=jnp.where(act, nf, st["f"]),
            slot=jnp.where(act, lsrc, st["slot"]),
            tw=jnp.where(act, ntw, st["tw"]),
            words=words, bitcnt=bitcnt,
            alive=st["alive"] & ~(act & (ntw < 0)),
            okend=okend), ()

    # paired reverse scan matching the forward's 2-block steps: within a
    # pair, the odd block runs first when walking backward
    def pair_step(st, xs):
        tp, sel_t0, sel_t1, start_t0, start_t1 = xs
        st, _ = step(st, (tp + 1, sel_t1, start_t1))
        return step(st, (tp, sel_t0, start_t0))

    ts = t0 + jnp.arange(0, K, 2, dtype=jnp.int32)
    st, _ = jax.lax.scan(
        pair_step, st,
        (ts, sels0, sels1,
         starts.reshape(K // 2, 2)[:, 0], starts.reshape(K // 2, 2)[:, 1]),
        reverse=True)
    return st


class TracebackDecoder:
    """Batched list-Viterbi decode via the ACS cell + selection traceback.

    The decode is a host-orchestrated loop of jitted chunk programs (see
    the chunking note above _init_buffers). ``mesh`` wraps every chunk
    program in ``shard_map`` over the mesh's 'data' axis, sharding the
    batch — this is THE multi-device path (parallel/mesh.py builds on
    it). B=1 runs unbatched programs, so no vmap squeezes or copies the
    carry buffers.
    """

    def __init__(self, spec, tabs, chunk_blocks: int = 128, mesh=None):
        self.spec = spec
        self.consts = build_consts(spec, tabs)
        self.chunk_blocks = max(2, chunk_blocks - chunk_blocks % 2)
        self.mesh = mesh
        # device copies of the array tables, shared by cell and traceback
        self._dev = {k: jnp.asarray(v) for k, v in self.consts._asdict(
        ).items() if isinstance(v, np.ndarray)}
        self._fns = {}

    # -- per-(batch-size, chunk) jitted chunk programs (cached) ------------
    def _get_fns(self, B: int | None, K: int):
        """B=None: unbatched programs; B>=1: vmapped (+ shard_mapped when a
        mesh is set) programs over a leading batch axis."""
        if (B, K) in self._fns:
            return self._fns[(B, K)]
        spec, c = self.spec, self.consts
        L = spec.list_size

        def fwd(carry, post, starts, active, i):
            # chunk slicing happens INSIDE jit: eager slicing of global
            # (multi-host) arrays is not allowed, and this also avoids a
            # dispatched slice program per chunk
            sl = partial(jax.lax.dynamic_slice_in_dim, start_index=i,
                         slice_size=K, axis=0)
            return _forward_chunk(spec, self._dev, carry, sl(post),
                                  sl(starts), sl(active))

        def tb(tlo, thi, st, t0, s0, s1, starts):
            starts_c = jax.lax.dynamic_slice_in_dim(starts, t0, K, axis=0)
            return _tb_chunk(spec, c, self._dev, tlo, thi, st, t0, s0,
                             s1, starts_c)

        def init():
            b = _init_buffers(spec, c)
            return (b[:3], b[3:])

        def tbinit(tlo, thi, nblk):
            return _tb_init(spec, c, tlo, thi, nblk)

        def fin(carry, tT, nblk):
            return _final_scores(spec, c, carry, tT, nblk)

        def order(fin_sc, words, okend):
            flat = fin_sc.reshape(-1)
            idx = jnp.argsort(-flat, stable=True)[:L]
            return flat[idx], words[idx], okend[idx]

        if B is not None:
            ndev = (1 if self.mesh is None
                    else self.mesh.devices.size)
            assert B % ndev == 0, "batch must divide over the mesh"
            # inside shard_map the program sees the LOCAL batch shard
            if B // ndev == 1:
                # one read per device: vmap would copy every carry buffer
                # around every cell call; squeeze the unit batch axis ONCE
                # per chunk program instead
                addb = partial(jax.tree.map, lambda x: x[None])
                dropb = partial(jax.tree.map, lambda x: x[0])
                fwd_u, tb_u, init_u = fwd, tb, init
                fwd = lambda c, p, s, a, i: addb(  # noqa: E731
                    fwd_u(dropb(c), p[0], s[0], a[0], i))
                tb = lambda lo, hi, st, t0, s0, s1, s: addb(  # noqa: E731
                    tb_u(lo[0], hi[0], dropb(st), t0, s0[0], s1[0], s[0]))
                init = lambda: addb(init_u())  # noqa: E731
            else:
                fwd = jax.vmap(fwd, in_axes=(0, 0, 0, 0, None))
                tb = jax.vmap(tb, in_axes=(0, 0, 0, None, 0, 0, 0))
                init = jax.vmap(init, axis_size=B // ndev)
            tbinit = jax.vmap(tbinit)
            fin = jax.vmap(fin, in_axes=(0, None, 0))
            order = jax.vmap(order)
            if self.mesh is not None:
                P = jax.sharding.PartitionSpec
                d, r = P("data"), P()
                mesh = self.mesh
                cspec = ((d, d, d), (d, d, d))  # carry pytree

                def smap(f, in_specs, out_specs):
                    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                         out_specs=out_specs,
                                         check_vma=False)

                stspec = dict(pos=d, conv=d, f=d, slot=d, tw=d, words=d,
                              bitcnt=d, alive=d, okend=d)
                fwd = smap(fwd, (cspec, d, d, d, r), (cspec, d, d))
                tb = smap(tb, (d, d, stspec, r, d, d, d), stspec)
                init = smap(init, (), cspec)
                tbinit = smap(tbinit, (d, d, d), stspec)
                fin = smap(fin, (cspec, r, d), d)
                order = smap(order, (d, d, d), (d, d, d))
        fns = dict(
            fwd=jax.jit(fwd, donate_argnums=(0,)),
            tb=jax.jit(tb, donate_argnums=(2,)),
            init=jax.jit(init),
            tbinit=jax.jit(tbinit),
            fin=jax.jit(fin),
            order=jax.jit(order),
        )
        self._fns[(B, K)] = fns
        return fns

    def prep(self, posts, starts, nblks):
        """Host-side prep: pad T to whole chunks, build the traceback
        coverage tables and the active mask. Returns numpy arrays
        (posts, starts, nblks_i32, tlo, thi, active)."""
        spec = self.spec
        W, Pp = spec.window, spec.npos_pad
        posts = np.asarray(posts, np.float32)
        starts = np.asarray(starts, np.int32)
        nblks = np.asarray(nblks)
        B, T = posts.shape[:2]
        K = min(self.chunk_blocks, T)
        if T % K:  # pad to a whole number of chunks (inactive blocks)
            padT = K - T % K
            posts = np.concatenate(
                [posts, np.zeros((B, padT, 5, 8), np.float32)], axis=1)
            starts = np.concatenate(
                [starts, np.repeat(starts[:, -1:], padT, axis=1)], axis=1)
            T += padT
        tlo = np.zeros((B, Pp), np.int32)
        thi = np.zeros((B, Pp), np.int32)
        for b, n in enumerate(nblks):
            tlo[b], thi[b] = window_bounds(starts[b], int(n), Pp, W)
        active = np.arange(T)[None, :] < nblks[:, None]
        return posts, starts, nblks.astype(np.int32), tlo, thi, active

    def decode_device(self, posts, starts, nblks, tlo, thi, active,
                      unbatched: bool = False):
        """Chunk-loop decode over committed device arrays (global arrays
        under a mesh; see class docstring). All inputs batch-leading unless
        ``unbatched``. Returns device arrays (scores [B?,L], words int32
        [B?,L,Mw], okend [B?,L])."""
        T = posts.shape[-3]
        K = min(self.chunk_blocks, T)
        fns = self._get_fns(None if unbatched else posts.shape[0], K)

        carry = fns["init"]()
        chunks = []
        for i in range(0, T, K):
            carry, s0, s1 = fns["fwd"](carry, posts, starts, active,
                                       jnp.int32(i))
            chunks.append((s0, s1))
        fin_sc = fns["fin"](carry, jnp.int32(T), nblks)
        del carry

        st = fns["tbinit"](tlo, thi, nblks)
        for i in reversed(range(len(chunks))):
            s0, s1 = chunks[i]
            chunks[i] = None
            st = fns["tb"](tlo, thi, st, jnp.int32(i * K), s0, s1, starts)
            del s0, s1  # free the slice once consumed
        return fns["order"](fin_sc, st["words"], st["okend"])

    def decode(self, posts, starts, nblks):
        """posts [B,T,5,8] f32, starts [B,T] i32, nblks [B] -> packed words
        uint32 [B,L,Mw], scores [B,L], valid [B,L]."""
        posts, starts, nblks, tlo, thi, active = self.prep(
            posts, starts, nblks)
        B = posts.shape[0]
        unb = B == 1 and self.mesh is None
        sq = (lambda a: a[0]) if unb else (lambda a: a)
        if self.mesh is not None:
            bsh = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec("data"))
            put = partial(jax.device_put, device=bsh)
        else:
            put = jnp.asarray
        sc, words, okend = self.decode_device(
            put(sq(posts)), put(sq(starts)), put(sq(nblks)), put(sq(tlo)),
            put(sq(thi)), put(sq(active)), unbatched=unb)
        sc = np.asarray(sc)
        msgs = np.asarray(words).view(np.uint32)
        okend = np.asarray(okend)
        if unb:
            sc, msgs, okend = sc[None], msgs[None], okend[None]
        valid = (sc > -np.inf) & okend
        return msgs, sc, valid
