"""Plain reference of the Anemoi hash over Python integers.

The definition the benchmark judges the program against: the permutation
(constants, Flystel, linear layer), Jive-k, the sponge over field elements
and over bytes, and the 13-bit limb Montgomery encoding the program's API
takes and returns.  The constants are a frozen copy in ``constants/``,
checked against the SAGE test vectors by ``benchmark/tests``.  Nothing here
imports the program.

Values are plain integers in [0, p) unless a name says "mont".
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

LIMB_BITS = 13
_CONSTANTS = Path(__file__).resolve().parent / "constants"


@dataclass(frozen=True)
class Instance:
    field: str
    name: str
    p: int
    bits: int
    alpha: int
    beta: int  # the generator g of the Flystel
    delta: int  # g^-1 mod p
    inv_alpha: int
    byte_chunk: int
    digest_bytes: int
    width: int
    rate: int
    columns: int
    digest_size: int
    rounds: int
    C: tuple
    D: tuple

    @property
    def n_limbs(self) -> int:
        """13-bit limbs of an element in the API: two spare bits above p."""
        return -(-(self.bits + 2) // LIMB_BITS)

    @property
    def R(self) -> int:
        return (1 << (LIMB_BITS * self.n_limbs)) % self.p


@lru_cache(maxsize=None)
def instance(field: str, name: str) -> Instance:
    raw = json.loads((_CONSTANTS / f"{field}.json").read_text())
    ins = raw["instances"][name]
    return Instance(
        field=field, name=name, p=int(raw["modulus"]), bits=raw["bits"], alpha=raw["alpha"], beta=raw["beta"],
        delta=int(raw["delta"]), inv_alpha=int(raw["inv_alpha"]), byte_chunk=raw["byte_chunk"],
        digest_bytes=raw["digest_bytes"], width=ins["width"], rate=ins["rate"], columns=ins["columns"],
        digest_size=ins["digest_size"], rounds=ins["rounds"], C=tuple(int(c) for c in ins["C"]),
        D=tuple(int(d) for d in ins["D"]),
    )


# ----------------------------------------------------------------------------
# the permutation
# ----------------------------------------------------------------------------


def _linear(inst: Instance, s: list, pht_terms: bool = False) -> list:
    """The MDS product on each half, then the PHT (y += x; x += y).  With
    ``pht_terms`` the x half is left as the pairs (x, y) of its last
    addition."""
    p, g, cols = inst.p, inst.beta, inst.columns
    if cols == 1:
        x, y = s
    elif cols == 2:
        x0, x1, y0, y1 = s
        x0 = (x0 + g * x1) % p
        x1 = (x1 + g * x0) % p
        y1 = (y1 + g * y0) % p  # the y half rotated by one cell
        y0 = (y0 + g * y1) % p
        x, y = [x0, x1], [y1, y0]
    else:
        raise NotImplementedError("the reference covers one and two columns")
    x, y = (x, y) if cols > 1 else ([x], [y])
    y = [(b + a) % p for a, b in zip(x, y)]
    x = [(a, b) if pht_terms else (a + b) % p for a, b in zip(x, y)]
    return x + y


def permutation(inst: Instance, state: list, pht_terms: bool = False) -> list:
    """Rounds of (constants, linear layer, open Flystel), then the linear
    layer (with ``pht_terms``, as ``_linear`` leaves it)."""
    p, cols = inst.p, inst.columns
    s = list(state)
    for r in range(inst.rounds):
        for i in range(cols):
            s[i] = (s[i] + inst.C[r * cols + i]) % p
            s[cols + i] = (s[cols + i] + inst.D[r * cols + i]) % p
        s = sbox(inst, _linear(inst, s))
    return _linear(inst, s, pht_terms)


def sbox(inst: Instance, s: list) -> list:
    """The open Flystel on each column: x -= g y^2; y -= x^(1/alpha); x += g y^2 + delta."""
    p, g, cols = inst.p, inst.beta, inst.columns
    s = list(s)
    for i in range(cols):
        x, y = s[i], s[cols + i]
        x = (x - g * y * y) % p
        y = (y - pow(x, inst.inv_alpha, p)) % p
        x = (x + g * y * y + inst.delta) % p
        s[i], s[cols + i] = x, y
    return s


def jive_terms(inst: Instance, state: list, k: int = 2) -> list:
    """The terms of each Jive-k output: out[i] is the sum over j of
    x[i + c j] + P(x)[i + c j], c = width / k; each term canonical."""
    post = permutation(inst, state)
    c = inst.width // k
    return [[(state[i + c * j] + post[i + c * j]) % inst.p for j in range(k)] for i in range(c)]


def jive(inst: Instance, state: list, k: int = 2) -> list:
    return [sum(t) % inst.p for t in jive_terms(inst, state, k)]


def hash_field(inst: Instance, elems: list, pht_terms: bool = False) -> list:
    """The sponge over field elements, with the reference's padding.  With
    ``pht_terms`` each digest element is the pair of its last addition."""
    p = inst.p
    state = [0] * inst.width
    last_input = None  # the state the last permutation took

    def permute(s: list) -> list:
        nonlocal last_input
        last_input = s
        return permutation(inst, s)

    if inst.rate == 1:
        for e in elems:
            state[0] = (state[0] + e) % p
            state = permute(state)
    else:
        i = 0
        for e in elems:
            state[i] = (state[i] + e) % p
            i += 1
            if i == inst.rate:
                state = permute(state)
                i = 0
        if len(elems) % inst.rate:  # sigma = 0: pad with a one, then permute
            state[i] = (state[i] + 1) % p
            state = permute(state)
    # sigma = 1 (rate 1, or a whole number of blocks) goes into the last
    # state word, outside the digest
    if pht_terms:
        if last_input is None:
            return [(0, 0)] * inst.digest_size
        return permutation(inst, last_input, True)[: inst.digest_size]
    return state[: inst.digest_size]


def bytes_to_elements(inst: Instance, data: bytes) -> list:
    """byte_chunk bytes an element, little-endian; the last partial chunk
    is padded with one byte of value 1."""
    n = -(-len(data) // inst.byte_chunk)
    out = []
    for i in range(n):
        buf = data[i * inst.byte_chunk:(i + 1) * inst.byte_chunk]
        if i == n - 1 and len(buf) < inst.byte_chunk:
            buf += b"\x01"
        out.append(int.from_bytes(buf, "little") % inst.p)
    return out


def hash_bytes(inst: Instance, data: bytes) -> list:
    return hash_field(inst, bytes_to_elements(inst, data))


# ----------------------------------------------------------------------------
# the API's encoding: int32 13-bit limbs, least significant first, of x R mod p
# ----------------------------------------------------------------------------


def limbs_to_ints(limbs) -> list:
    """int array [L, n] -> n integers (the limbs as they are, no reduction)."""
    arr = np.asarray(limbs, dtype=np.int64)
    out = [0] * arr.shape[1]
    for i in range(arr.shape[0] - 1, -1, -1):
        row = arr[i].tolist()
        out = [(v << LIMB_BITS) | int(r) for v, r in zip(out, row)]
    return out


def from_mont(inst: Instance, v: int) -> int:
    return v * pow(inst.R, -1, inst.p) % inst.p


def to_mont(inst: Instance, v: int) -> int:
    return v * inst.R % inst.p


def lazy_mont(inst: Instance, terms) -> int:
    """The control's sum: canonical terms added in Montgomery form with the
    final reduction skipped, in [0, len(terms) p), as a kernel that left it
    out would store them."""
    return sum(to_mont(inst, t) for t in terms)
