"""Reed-Solomon outer code over GF(2^16) — from-scratch vectorized codec.

Replaces the reference's vendored schifra library + recompile-per-call wrapper
(RSCode_schifra/RSCode_16bit_fileio.py:33-43 regenerates and recompiles the
C++ codec for every encode/decode!). Same code: n = 65535, primitive
polynomial x^16+x^12+x^3+x+1 (schifra_galois_field.hpp:511), generator roots
alpha^0..alpha^{fec-1} (sequential-root creator, index 0), systematic block
[data | parity], polynomial ordering block[0] = x^{n-1} coefficient.

Shortening follows the reference wrapper exactly (RSCode_16bit_fileio.py:59-60,
95-99): the data is left-padded with ASCII '0' bytes, i.e. constant symbols
0x3030, then the pad is punctured away.

Vectorized reformulation: instead of O(n * fec) polynomial division / Horner
over all 65535 symbols, we use
  * closed-form geometric-series evaluation of the constant pad prefix,
  * sparse evaluation over the <= (reads + fec) real symbols,
  * parity recovery by Lagrange interpolation from the fec root evaluations,
so encode/decode cost is O(fec * (reads + fec)) — pure table-gather
arithmetic, equally at home in numpy (host) or jnp (device).

Decode is full errors-and-erasures: erasure locator, Berlekamp-Massey with
erasure initialization, Chien search, Forney (b=0 convention with the X_j
factor), with the same failure conditions as the reference decoder
(schifra_reed_solomon_decoder.hpp:117-164,360-383).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

N = 65535  # code length (full-length GF(2^16) RS)
PRIM_POLY = 0x1100B  # x^16 + x^12 + x^3 + x + 1
PAD_SYMBOL = 0x3030  # ASCII "00" — the reference wrapper's left-pad


@lru_cache(maxsize=1)
def _tables() -> Tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * N, dtype=np.int64)
    log = np.zeros(N + 1, dtype=np.int64)
    x = 1
    for i in range(N):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x10000:
            x ^= PRIM_POLY
    exp[N:] = exp[:N]
    log[0] = 0  # never used for zero operands (masked)
    return exp, log


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    exp, log = _tables()
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = exp[log[a] + log[b]]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_inv(a: np.ndarray) -> np.ndarray:
    exp, log = _tables()
    a = np.asarray(a, dtype=np.int64)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^16) inverse of zero")
    return exp[(N - log[a]) % N]


def gf_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return gf_mul(a, gf_inv(b))


def alpha_pow(e: np.ndarray) -> np.ndarray:
    """alpha^e for any integer exponent (mod N)."""
    exp, _ = _tables()
    return exp[np.mod(np.asarray(e, dtype=np.int64), N)]


def _geom_sum_alpha(t: np.ndarray, e_hi: int, length: int) -> np.ndarray:
    """sum_{j=0..length-1} (alpha^t)^(e_hi - j), vectorized over t.

    Closed form in characteristic 2: a^{e_lo} (a^{length}+1)/(a+1) for a != 1;
    equals length mod 2 when a == 1 (t == 0).
    """
    t = np.asarray(t, dtype=np.int64)
    if length <= 0:
        return np.zeros_like(t)
    e_lo = e_hi - length + 1
    a = alpha_pow(t)
    num = gf_mul(alpha_pow(t * e_lo), alpha_pow(t * length) ^ 1)
    den = a ^ 1
    safe_den = np.where(den == 0, 1, den)
    out = gf_div(num, safe_den)
    return np.where(den == 0, length % 2, out)


def _eval_sparse(t: np.ndarray, symbols: np.ndarray,
                 exponents: np.ndarray) -> np.ndarray:
    """sum_j symbols[j] * alpha^(t * exponents[j]) over j, vectorized over t."""
    exp, log = _tables()
    t = np.asarray(t, dtype=np.int64)
    symbols = np.asarray(symbols, dtype=np.int64)
    te = np.mod(t[:, None] * exponents[None, :], N)
    # exponent sums stay < 2N, covered by the doubled exp table
    prod = exp[log[symbols][None, :] + te]
    prod = np.where(symbols[None, :] == 0, 0, prod)
    return np.bitwise_xor.reduce(prod, axis=1)


class RS16:
    """Shortened systematic RS(65535, 65535-fec) over GF(2^16)."""

    def __init__(self, fec: int):
        if not 0 < fec < N:
            raise ValueError("invalid fec length")
        self.fec = fec
        self.k = N - fec
        self._g = self._generator_poly(fec)

    @staticmethod
    def _generator_poly(fec: int) -> np.ndarray:
        """g(x) = prod_{i=0..fec-1} (x + alpha^i); coeff index = degree."""
        g = np.zeros(fec + 1, dtype=np.int64)
        g[0] = 1
        for i in range(fec):
            r = alpha_pow(np.int64(i))
            # g = g*x + r*g
            shifted = np.concatenate([[0], g[:-1]])
            g = shifted ^ gf_mul(g, r)
        return g

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------
    def encode_shortened(self, data: np.ndarray) -> np.ndarray:
        """Parity symbols for a shortened message.

        Args:
          data: int array [num] of 16-bit symbols; conceptually left-padded
            with PAD_SYMBOL to the full data length k.
        Returns:
          parity int64 [fec] (block symbols in transmitted order).
        """
        data = np.asarray(data, dtype=np.int64)
        num = data.shape[0]
        if num > self.k:
            raise ValueError("too many data symbols")
        pad_len = self.k - num
        t = np.arange(self.fec, dtype=np.int64)
        # m(alpha^t): pad prefix occupies exponents n-1 .. n-pad_len;
        # real symbols exponents n-1-pad_len .. fec.
        y = gf_mul(PAD_SYMBOL, _geom_sum_alpha(t, N - 1, pad_len))
        exps = (N - 1 - pad_len) - np.arange(num, dtype=np.int64)
        y ^= _eval_sparse(t, data, exps)
        # parity polynomial p (deg < fec) with p(alpha^t) = y_t; block order
        # parity[i] = coeff x^{fec-1-i} (schifra encoder.hpp:72-75).
        p = self._interpolate_at_roots(y)
        return p[::-1].copy()

    def _interpolate_at_roots(self, y: np.ndarray) -> np.ndarray:
        """Unique poly p, deg(p) < fec, with p(alpha^t) = y[t] for t < fec."""
        fec = self.fec
        roots = alpha_pow(np.arange(fec, dtype=np.int64))
        # synthetic division q_t = g / (x + root_t), all roots at once
        q = np.zeros((fec, fec), dtype=np.int64)  # q[t, i] = coeff of x^i
        q[:, fec - 1] = self._g[fec]  # == 1
        for i in range(fec - 1, 0, -1):
            q[:, i - 1] = self._g[i] ^ gf_mul(roots, q[:, i])
        # denominators q_t(root_t) via Horner (vectorized over t)
        den = q[:, fec - 1]
        for i in range(fec - 2, -1, -1):
            den = gf_mul(den, roots) ^ q[:, i]
        w = gf_div(y, den)
        terms = gf_mul(w[:, None], q)
        return np.bitwise_xor.reduce(terms, axis=0)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def decode_shortened(self, received: np.ndarray,
                         erasures: Sequence[int]
                         ) -> Tuple[bool, Optional[np.ndarray]]:
        """Errors-and-erasures decode of a shortened codeword.

        Args:
          received: int array [total] of symbols (data then parity);
            conceptually left-padded with PAD_SYMBOL to length n.
          erasures: indices into ``received`` considered erased.
        Returns:
          (ok, corrected [total] or None). Mirrors the reference failure
          conditions; on failure the wrapper-level API substitutes '0' bytes
          (RSCode_16bit_fileio.py:111-117).
        """
        received = np.asarray(received, dtype=np.int64).copy()
        total = received.shape[0]
        pad_len = N - total
        fec = self.fec
        t = np.arange(fec, dtype=np.int64)
        # syndromes S_t = r(alpha^t)
        syn = gf_mul(PAD_SYMBOL, _geom_sum_alpha(t, N - 1, pad_len))
        exps = (N - 1 - pad_len) - np.arange(total, dtype=np.int64)
        syn ^= _eval_sparse(t, received, exps)
        if not syn.any():
            return True, received
        # erasure locator Gamma = prod (1 + alpha^{p_e} x), p_e = poly position
        era = np.asarray(sorted(set(int(e) for e in erasures)), dtype=np.int64)
        if (era < 0).any() or (era >= total).any():
            raise ValueError("erasure location outside the shortened block")
        positions = N - 1 - (era + pad_len)  # poly-degree positions
        lam = np.zeros(max(fec, len(era)) + 1, dtype=np.int64)
        lam[0] = 1
        for p in positions:
            a = alpha_pow(np.int64(p))
            lam = lam ^ np.concatenate([[0], gf_mul(lam[:-1], a)])
        n_era = len(era)
        if n_era < fec:
            lam = self._berlekamp_massey(lam, syn, n_era)
        deg = self._poly_deg(lam)
        roots_i = self._find_roots(lam, deg)
        if len(roots_i) == 0:
            return False, None
        if 2 * len(roots_i) - n_era > fec:
            return False, None
        # Forney: omega = (lambda * S) mod x^fec
        omega = self._poly_mul_mod(lam, syn, fec)
        lam_deriv = lam.copy()
        lam_deriv[::2] = 0  # formal derivative in char 2: odd terms shift down
        lam_deriv = lam_deriv[1:]
        errors_corrected = 0
        for i in roots_i:
            x_inv = alpha_pow(np.int64(i))  # alpha^i = X_j^{-1}
            num = gf_mul(self._poly_eval(omega, x_inv),
                         alpha_pow(np.int64(N - i)))
            den = self._poly_eval(lam_deriv, x_inv)
            if num != 0:
                if den == 0:
                    return False, None
                blk = i - 1 - pad_len  # block index in the shortened code
                if 0 <= blk < total:
                    received[blk] ^= gf_div(num, den)
                errors_corrected += 1
        if deg != len(roots_i):
            return False, None
        return True, received

    # --- helpers ---------------------------------------------------------
    @staticmethod
    def _poly_deg(p: np.ndarray) -> int:
        nz = np.nonzero(p)[0]
        return int(nz[-1]) if len(nz) else 0

    @staticmethod
    def _poly_eval(p: np.ndarray, x: np.ndarray) -> np.ndarray:
        out = np.int64(0)
        for c in p[::-1]:
            out = gf_mul(out, x) ^ c
        return out

    @staticmethod
    def _poly_mul_mod(a: np.ndarray, b: np.ndarray, m: int) -> np.ndarray:
        out = np.zeros(m, dtype=np.int64)
        for i, c in enumerate(a[:m]):
            if c:
                hi = min(m - i, len(b))
                out[i:i + hi] ^= gf_mul(c, b[:hi])
        return out

    def _find_roots(self, lam: np.ndarray, deg: int) -> List[int]:
        """Chien search over the whole field, i in 1..n with alpha^i a root.

        Returns at most deg roots in ascending i (schifra decoder.hpp:250-274).
        """
        exp, log = _tables()
        coeffs = lam[: deg + 1]
        nz = np.nonzero(coeffs)[0]
        i_all = np.arange(1, N + 1, dtype=np.int64)
        acc = np.zeros(N, dtype=np.int64)
        for k in nz:
            acc ^= exp[(log[coeffs[k]] + np.mod(i_all * k, N))]
        roots = i_all[acc == 0][:deg]
        return [int(r) for r in roots]

    def _berlekamp_massey(self, lam: np.ndarray, syn: np.ndarray,
                          n_era: int) -> np.ndarray:
        """Modified BM with erasure-initialized locator
        (schifra_reed_solomon_decoder.hpp:296-333)."""
        fec = self.fec
        size = fec + 1
        lam = lam.copy()
        prev = np.concatenate([[0], lam[:-1]])  # lambda << 1
        i_track = -1
        l = n_era
        for rnd in range(n_era, fec):
            ub = min(l, self._poly_deg(lam))
            idx = np.arange(ub + 1)
            disc = np.bitwise_xor.reduce(gf_mul(lam[idx], syn[rnd - idx]))
            if disc != 0:
                tau = lam ^ gf_mul(disc, prev)
                if l < rnd - i_track:
                    tmp = rnd - i_track
                    i_track = rnd - l
                    l = tmp
                    prev = gf_div(lam, disc)
                lam = tau
            prev = np.concatenate([[0], prev[:-1]])[:size]
        return lam


# ---------------------------------------------------------------------------
# Oligo-level API (the reference wrapper's MainEncoder / MainDecoder,
# RSCode_16bit_fileio.py:266-299, with codewords running vertically across
# oligos: symbol i of every oligo forms codeword i).
# ---------------------------------------------------------------------------


def _payload_to_symbols(payloads: np.ndarray) -> np.ndarray:
    """uint8 [num, 2*S] byte payloads -> int64 [num, S] little-endian symbols.

    The schifra CLI reads raw uint16 from the byte stream (little-endian on
    x86, schifra_RS_16bit_fileio.cpp:96-106).
    """
    p = np.asarray(payloads, dtype=np.uint8)
    assert p.shape[-1] % 2 == 0
    return (p[..., 0::2].astype(np.int64)
            | (p[..., 1::2].astype(np.int64) << 8))


def _symbols_to_payload(symbols: np.ndarray) -> np.ndarray:
    s = np.asarray(symbols, dtype=np.int64)
    out = np.empty(s.shape[:-1] + (2 * s.shape[-1],), dtype=np.uint8)
    out[..., 0::2] = s & 0xFF
    out[..., 1::2] = (s >> 8) & 0xFF
    return out


def rs_encode_oligos(payloads: np.ndarray, redundancy: int) -> np.ndarray:
    """Append RS parity oligos.

    Args:
      payloads: uint8 [num_data, bytes_per_oligo].
    Returns:
      uint8 [num_data + redundancy, bytes_per_oligo].
    """
    syms = _payload_to_symbols(payloads)  # [num, S]
    rs = RS16(redundancy)
    parity = np.stack(
        [rs.encode_shortened(syms[:, c]) for c in range(syms.shape[1])],
        axis=1)  # [redundancy, S]
    return np.concatenate(
        [np.asarray(payloads, np.uint8), _symbols_to_payload(parity)], axis=0)


def rs_decode_oligos(indices: np.ndarray, payloads: np.ndarray,
                     redundancy: int, total: int) -> Tuple[bool, np.ndarray]:
    """Recover the data payloads from a partial set of (index, payload).

    Missing indices become erasures filled with '0' bytes (the reference's
    dummy reads, RSCode_16bit_fileio.py:235-246). Returns (all_ok, payloads
    uint8 [total - redundancy, bytes_per_oligo]); failed codeword columns are
    '0'-filled like the wrapper's failure path.
    """
    payloads = np.atleast_2d(np.asarray(payloads, dtype=np.uint8))
    nsym = payloads.shape[1] // 2
    block = np.full((total, nsym), PAD_SYMBOL, dtype=np.int64)
    present = np.zeros(total, dtype=bool)
    for idx, pl in zip(np.asarray(indices, dtype=np.int64), payloads):
        block[idx] = _payload_to_symbols(pl[None])[0]
        present[idx] = True
    erasures = np.nonzero(~present)[0]
    rs = RS16(redundancy)
    out = np.full((total - redundancy, nsym), PAD_SYMBOL, dtype=np.int64)
    all_ok = True
    for c in range(nsym):
        ok, fixed = rs.decode_shortened(block[:, c], erasures)
        if ok:
            out[:, c] = fixed[: total - redundancy]
        else:
            all_ok = False
    return all_ok, _symbols_to_payload(out)
