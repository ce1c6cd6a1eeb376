"""Reed-Solomon encoder/decoder over GF(2^8) for Galileo HAS and INAV CED.

Counterpart of the reference's ``ReedSolomon`` class
(reference: src/core/system_parameters/reed_solomon.h:40-160,
reed_solomon.cc:26-45 for the E6B parameters and :312-320 for E1B).
The reference embeds a precomputed 255x32 generator matrix for encoding
and Phil-Karn-style tables for decoding; here both directions are derived
algebraically from the code parameters (same field polynomial 0x11D,
first consecutive root and shortening), so nothing is table-copied and
the implementation supports any RS(255, 255-nroots) configuration.

Presets:
- ``ReedSolomon("E6B")``  -> RS(255, 32), fcr=1: the Galileo HAS mother
  code (HAS SIS ICD 1.0 section 6.2); 223 parity symbols allow decoding
  a message from any 32 of its 255 encoded pages (erasure decoding).
- ``ReedSolomon("E1B")``  -> shortened RS(118, 58), fcr=195,
  shortening=137: the INAV FEC2 Reduced CED code.

Decoding is errors-and-erasures Berlekamp-Massey + Chien search +
Forney, matching the behaviour of the reference's ``decode_rs_8``
(reed_solomon.cc:758-1050): it returns the number of corrected symbols
or -1 on failure, correcting in place semantics via the returned array.
"""

from __future__ import annotations

import numpy as np

_FIELD_POLY = 0x11D  # x^8+x^4+x^3+x^2+1; low byte 0x1D = the reference's d_min_poly=29


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """alpha^i table (exp, length 512 for overflow-free products) and log table."""
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _FIELD_POLY
    exp[255:510] = exp[0:255]
    return exp, log


_EXP, _LOG = _build_tables()


def _gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _poly_mul(p: list[int], q: list[int]) -> list[int]:
    out = [0] * (len(p) + len(q) - 1)
    for i, pi in enumerate(p):
        if pi == 0:
            continue
        for j, qj in enumerate(q):
            out[i + j] ^= _gmul(pi, qj)
    return out


def _poly_eval(p: list[int], x: int) -> int:
    """Evaluate polynomial with p[i] the coefficient of x^i."""
    acc = 0
    xp = 1
    for c in p:
        acc ^= _gmul(c, xp)
        xp = _gmul(xp, x)
    return acc


class ReedSolomon:
    """RS(255, 255-nroots) with optional shortening, symbols of 8 bits."""

    N = 255

    def __init__(self, preset: str = "E6B", *, nroots: int | None = None,
                 fcr: int = 1, shortening: int = 0):
        if nroots is None:
            if preset in ("", "E6B"):
                nroots, fcr, shortening = 223, 1, 0
            elif preset == "E1B":
                nroots, fcr, shortening = 60, 195, 137
            else:
                raise ValueError(f"unknown Reed-Solomon preset {preset!r}")
        self.nroots = int(nroots)
        self.fcr = int(fcr)
        self.shortening = int(shortening)
        self.k = self.N - self.nroots              # info symbols, mother code
        self.block_len = self.N - self.shortening  # symbols in a (shortened) block
        self.info_len = self.k - self.shortening   # info symbols in a shortened block
        # generator polynomial g(x) = prod_{i=0}^{nroots-1} (x - alpha^(fcr+i)),
        # coefficients ascending in x
        g = [1]
        for i in range(self.nroots):
            g = _poly_mul(g, [int(_EXP[(self.fcr + i) % 255]), 1])
        self._genpoly = g  # g[j] multiplies x^j; g[nroots] == 1

    # -- encoding ---------------------------------------------------------

    def encode(self, info: np.ndarray) -> np.ndarray:
        """Systematic encode: returns [info | parity] of length block_len.

        Matches the layout of the reference's generator matrix
        (reed_solomon.cc:37-69 — identity rows on top), i.e. codeword
        symbol i < k is info[i] and symbols k..254 are parity.
        """
        info = np.asarray(info, dtype=np.uint8)
        if info.shape[0] != self.info_len:
            raise ValueError(f"expected {self.info_len} info symbols, got {info.shape[0]}")
        # message poly m(x) coefficients: data[0] is the highest-degree term.
        # parity = remainder of m(x) * x^nroots mod g(x) via LFSR division.
        parity = [0] * self.nroots
        g = self._genpoly
        for d in info:
            feedback = int(d) ^ parity[-1]
            # shift up: parity_new[j] = parity[j-1] + feedback*g[j]
            new = [0] * self.nroots
            if feedback != 0:
                lf = _LOG[feedback]
                for j in range(self.nroots):
                    gj = g[j]
                    new[j] = int(_EXP[lf + _LOG[gj]]) if gj else 0
            for j in range(self.nroots - 1, 0, -1):
                new[j] ^= parity[j - 1]
            parity = new
        return np.concatenate([info, np.array(parity[::-1], dtype=np.uint8)])

    # -- decoding ---------------------------------------------------------

    def decode(self, data: np.ndarray,
               erasure_positions: list[int] | None = None) -> tuple[int, np.ndarray]:
        """Errors-and-erasures decode of a block_len-symbol vector.

        erasure_positions are indices into ``data`` (same convention as
        the reference's HAS decoder, galileo_e6_has_msg_receiver.cc:306-323:
        position = page_id - 1 of a missing page).
        Returns (n_corrected, corrected_block); n_corrected = -1 on failure.
        """
        data = np.asarray(data, dtype=np.uint8).copy()
        if data.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} symbols")
        eras = sorted(set(int(e) for e in (erasure_positions or [])))
        if any(e < 0 or e >= self.block_len for e in eras):
            raise ValueError("erasure position out of range")
        if len(eras) > self.nroots:
            return -1, data
        n = self.N
        nr = self.nroots
        # work on the full (virtually padded) codeword: index i in data maps
        # to poly position k = n-1-(i+shortening); location value alpha^k.
        full = np.zeros(n, dtype=np.uint8)
        full[self.shortening:] = data
        # syndromes S_j = c(alpha^(fcr+j)), j = 0..nr-1 (vectorized over positions)
        nz = np.nonzero(full)[0]
        syn = np.zeros(nr, dtype=np.int64)
        if nz.size:
            pos_pow = (n - 1 - nz).astype(np.int64)  # exponent of location
            logs = _LOG[full[nz]]
            for j in range(nr):
                root = (self.fcr + j) % 255
                terms = _EXP[(logs + (pos_pow * root) % 255) % 255]
                acc = 0
                for t in terms:
                    acc ^= int(t)
                syn[j] = acc
        if not syn.any() and not eras:
            return 0, data
        # erasure locator Gamma(x) = prod (1 - X_e x)
        eras_x = [int(_EXP[(n - 1 - (e + self.shortening)) % 255]) for e in eras]
        gamma = [1]
        for X in eras_x:
            gamma = _poly_mul(gamma, [1, X])
        # errors-and-erasures Berlekamp-Massey: initialize the locator with
        # the erasure polynomial, then iterate over the remaining syndromes
        # (the classic decode_rs structure the reference's decode_rs_8
        # follows, reed_solomon.cc:758-1050)
        s_list = [int(v) for v in syn]
        n_eras = len(eras)
        lam = gamma + [0] * (nr + 1 - len(gamma))
        bpoly = lam[:]
        el = n_eras
        for r in range(n_eras + 1, nr + 1):
            delta = 0
            for i in range(r):
                if lam[i] != 0 and s_list[r - i - 1] != 0:
                    delta ^= int(_EXP[_LOG[lam[i]] + _LOG[s_list[r - i - 1]]])
            if delta == 0:
                bpoly = [0] + bpoly[:-1]
            else:
                tpoly = [lam[0]] + [
                    lam[i + 1] ^ _gmul(delta, bpoly[i]) for i in range(nr)]
                if 2 * el <= r + n_eras - 1:
                    el = r + n_eras - el
                    inv_d = int(_EXP[(255 - _LOG[delta]) % 255])
                    bpoly = [_gmul(c, inv_d) for c in lam[:nr + 1]]
                else:
                    bpoly = [0] + bpoly[:-1]
                lam = tpoly
        sigma = lam
        while len(sigma) > 1 and sigma[-1] == 0:
            sigma.pop()
        n_err = len(sigma) - 1
        if n_err > nr:
            return -1, data
        # Chien search: roots X^-1 of Sigma; only positions within the block
        err_pos = []
        for i in range(self.block_len):
            k = n - 1 - (i + self.shortening)
            x_inv = int(_EXP[(255 - k % 255) % 255])
            if _poly_eval(sigma, x_inv) == 0:
                err_pos.append(i)
        if len(err_pos) != n_err:
            return -1, data  # locator degree != number of roots found
        # Forney: Omega(x) = S(x)*Sigma(x) mod x^nr
        omega = [0] * nr
        for i in range(nr):
            acc = 0
            for j in range(min(i + 1, len(sigma))):
                acc ^= _gmul(sigma[j], s_list[i - j])
            omega[i] = acc
        while len(omega) > 1 and omega[-1] == 0:
            omega.pop()
        # formal derivative of Sigma: odd-power coefficients
        sigma_prime = [sigma[j] for j in range(1, len(sigma), 2)]
        for i in err_pos:
            k = n - 1 - (i + self.shortening)
            x_inv = int(_EXP[(255 - k % 255) % 255])
            num = _poly_eval(omega, x_inv)
            # Sigma'(x_inv) evaluated at even powers of x_inv
            x_inv2 = _gmul(x_inv, x_inv)
            den = _poly_eval(sigma_prime, x_inv2)
            if den == 0:
                return -1, data
            mag = _gmul(num, int(_EXP[(255 - _LOG[den]) % 255]))
            # correction magnitude scaled by X^(1-fcr)
            if self.fcr != 1:
                expo = ((1 - self.fcr) * k) % 255
                mag = _gmul(mag, int(_EXP[expo % 255]))
            data[i] ^= mag
        # verify: recompute syndromes on corrected word
        full[self.shortening:] = data
        nz = np.nonzero(full)[0]
        if nz.size:
            pos_pow = (n - 1 - nz).astype(np.int64)
            logs = _LOG[full[nz]]
            for j in range(nr):
                root = (self.fcr + j) % 255
                terms = _EXP[(logs + (pos_pow * root) % 255) % 255]
                acc = 0
                for t in terms:
                    acc ^= int(t)
                if acc != 0:
                    return -1, data
        return len(err_pos), data
