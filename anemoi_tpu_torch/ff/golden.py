"""Golden model: bit-exact Anemoi permutation + modes over Python integers.

The port's own copy of ``anemoi_tpu/ff/golden.py``, over the port's
parameter registry, so that nothing here imports JAX or ``anemoi_tpu``.
It serves the scalar API (``instances.py``) and is the oracle that
``chip_smoke.py`` holds long messages against on the card, where the
plain PyTorch sponge would take minutes.  It mirrors the behavioral spec
of the reference implementation (reference: src/traits.rs:113-378 for the
permutation layers, src/<field>/anemoi_*/hasher.rs for the sponge/Jive
modes) using arbitrary-precision Python ints -- no limbs, no Montgomery
domain -- and is validated against the reference's SAGE-generated test
vectors (tests/vectors/*.json) and the JAX package's golden model.

All functions take/return plain ints in [0, p).
"""

from __future__ import annotations

from ..fields.params import FieldParams, InstanceParams


class ParityError(AssertionError):
    """Lanes of a device batch differ from the golden model."""


# --------------------------------------------------------------------------
# Permutation layers (spec: reference src/traits.rs)
# --------------------------------------------------------------------------


def mul_by_generator(fp: FieldParams, x: int) -> int:
    return x * fp.beta % fp.p


def exp_inv_alpha(fp: FieldParams, x: int) -> int:
    return pow(x, fp.inv_alpha, fp.p)


def exp_alpha(fp: FieldParams, x: int) -> int:
    """Forward S-box power map x^alpha (traits.rs:94-104)."""
    return pow(x, fp.alpha, fp.p)


def ark_layer(inst: InstanceParams, state: list[int], r: int) -> list[int]:
    """state[i] += C[r][i]; state[cols+i] += D[r][i]  (traits.rs:113-125)."""
    p = inst.field.p
    cols = inst.columns
    out = list(state)
    for i in range(cols):
        out[i] = (out[i] + inst.C[r * cols + i]) % p
        out[cols + i] = (out[cols + i] + inst.D[r * cols + i]) % p
    return out


def mds_internal(inst: InstanceParams, half: list[int]) -> list[int]:
    """MDS product on one half-state for the 3/4-column fast paths
    (traits.rs:298-323)."""
    fp = inst.field
    p = fp.p
    s = list(half)
    if inst.columns == 3:
        tmp = (s[0] + mul_by_generator(fp, s[2])) % p
        s[2] = (s[2] + s[1] + mul_by_generator(fp, s[0])) % p
        s[0] = (tmp + s[2]) % p
        s[1] = (s[1] + tmp) % p
    elif inst.columns == 4:
        s[0] = (s[0] + s[1]) % p
        s[2] = (s[2] + s[3]) % p
        s[3] = (s[3] + mul_by_generator(fp, s[0])) % p
        s[1] = mul_by_generator(fp, (s[1] + s[2]) % p)
        s[0] = (s[0] + s[1]) % p
        s[2] = (s[2] + mul_by_generator(fp, s[3])) % p
        s[1] = (s[1] + s[2]) % p
        s[3] = (s[3] + s[0]) % p
    return s


def _mds_circulant_5(x: list[int], p: int) -> list[int]:
    """5-column circulant product (traits.rs:188-204): out[i] =
    sum(x) + x[i+3] + 2*(x[i+2] + x[i+3] + 2*x[i+4]), indices mod 5."""
    total = sum(x) % p
    return [
        (total + x[(i + 3) % 5] + 2 * (x[(i + 2) % 5] + x[(i + 3) % 5] + 2 * x[(i + 4) % 5]))
        % p
        for i in range(5)
    ]


def _mds_circulant_6(x: list[int], p: int) -> list[int]:
    """6-column circulant product (traits.rs:222-246)."""
    total = sum(x) % p
    return [
        (
            total
            + x[(i + 3) % 6]
            + x[(i + 5) % 6]
            + 2 * (x[(i + 2) % 6] + x[(i + 3) % 6] + 2 * (x[(i + 4) % 6] + x[(i + 5) % 6]))
        )
        % p
        for i in range(6)
    ]


def _pht(s: list[int], cols: int, p: int) -> list[int]:
    """PHT layer: y += x; x += y (traits.rs:139-141 etc)."""
    for i in range(cols):
        s[cols + i] = (s[cols + i] + s[i]) % p
    for i in range(cols):
        s[i] = (s[i] + s[cols + i]) % p
    return s


def mds_layer(inst: InstanceParams, state: list[int]) -> list[int]:
    """Linear layer incl. PHT (traits.rs:129-294).

    Shipped instances use the 1/2-column fast paths; 3-6 columns and the
    generic-matrix fallback mirror the reference's dead-but-public paths so
    wider custom instances behave identically.
    """
    fp = inst.field
    p = fp.p
    cols = inst.columns
    s = list(state)
    if cols == 1:
        # MDS = identity; PHT: y += x; x += y
        s[1] = (s[1] + s[0]) % p
        s[0] = (s[0] + s[1]) % p
        return s
    if cols == 2:
        s[0] = (s[0] + mul_by_generator(fp, s[1])) % p
        s[1] = (s[1] + mul_by_generator(fp, s[0])) % p
        s[3] = (s[3] + mul_by_generator(fp, s[2])) % p
        s[2] = (s[2] + mul_by_generator(fp, s[3])) % p
        s[2], s[3] = s[3], s[2]
        return _pht(s, 2, p)
    if cols in (3, 4):
        # x half in place; y half rotated left one cell first (traits.rs:159-161)
        x = mds_internal(inst, s[:cols])
        y = mds_internal(inst, s[cols + 1 :] + s[cols : cols + 1])
        return _pht(x + y, cols, p)
    if cols in (5, 6):
        circ = _mds_circulant_5 if cols == 5 else _mds_circulant_6
        x = circ(s[:cols], p)
        y = circ(s[cols + 1 :] + s[cols : cols + 1], p)
        return _pht(x + y, cols, p)
    # generic fallback: naive matrix-vector product with the instance's MDS
    # (traits.rs:272-293); y half rotated left one cell first
    if inst.mds is None:
        raise ValueError("no MDS matrix specified for this instance")
    x_in = s[:cols]
    y_in = s[cols + 1 :] + s[cols : cols + 1]
    x = [sum(inst.mds[i * cols + j] * x_in[j] for j in range(cols)) % p for i in range(cols)]
    y = [sum(inst.mds[i * cols + j] * y_in[j] for j in range(cols)) % p for i in range(cols)]
    return _pht(x + y, cols, p)


def sbox_layer(inst: InstanceParams, state: list[int]) -> list[int]:
    """Open Flystel, column-wise (traits.rs:328-358):
    x -= g*y^2 ; y -= x^(1/alpha) ; x += g*y^2 + delta.
    """
    fp = inst.field
    p = fp.p
    cols = inst.columns
    x = list(state[:cols])
    y = list(state[cols:])
    for i in range(cols):
        x[i] = (x[i] - mul_by_generator(fp, y[i] * y[i] % p)) % p
    for i in range(cols):
        y[i] = (y[i] - exp_inv_alpha(fp, x[i])) % p
    for i in range(cols):
        x[i] = (x[i] + mul_by_generator(fp, y[i] * y[i] % p) + fp.delta) % p
    return x + y


def round_fn(inst: InstanceParams, state: list[int], r: int) -> list[int]:
    return sbox_layer(inst, mds_layer(inst, ark_layer(inst, state, r)))


def permutation(inst: InstanceParams, state: list[int]) -> list[int]:
    """NUM_ROUNDS rounds then a final mds_layer (traits.rs:370-378)."""
    s = list(state)
    for r in range(inst.rounds):
        s = round_fn(inst, s, r)
    return mds_layer(inst, s)


# --------------------------------------------------------------------------
# Modes (spec: reference src/<field>/anemoi_*/hasher.rs)
# --------------------------------------------------------------------------


def hash_field(inst: InstanceParams, elems: list[int]) -> list[int]:
    """Sponge over field elements (2_1: hasher.rs:67-84; 4_3: hasher.rs:92-128)."""
    p = inst.field.p
    state = [0] * inst.width
    if inst.rate == 1:
        for e in elems:
            state[0] = (state[0] + e) % p
            state = permutation(inst, state)
        state[-1] = (state[-1] + 1) % p
    else:
        sigma = 1 if len(elems) % inst.rate == 0 else 0
        i = 0
        for e in elems:
            state[i] = (state[i] + e) % p
            i += 1
            if i % inst.rate == 0:
                state = permutation(inst, state)
                i = 0
        state[-1] = (state[-1] + sigma) % p
        if sigma == 0:
            state[i] = (state[i] + 1) % p
            state = permutation(inst, state)
    return state[: inst.digest_size]


def bytes_to_elements(inst: InstanceParams, data: bytes) -> list[int]:
    """Byte absorb path: split into chunks, pad the last partial chunk with a
    1-byte, interpret little-endian mod p (2_1: hasher.rs:18-58)."""
    p = inst.field.p
    chunk = inst.field.byte_chunk
    n = -(-len(data) // chunk)  # empty input absorbs nothing, as in reference
    elems = []
    for k in range(n):
        buf = bytearray(data[k * chunk : (k + 1) * chunk])
        if k == n - 1 and len(buf) < chunk:
            buf.append(1)
        elems.append(int.from_bytes(bytes(buf), "little") % p)
    return elems


def hash_bytes(inst: InstanceParams, data: bytes) -> list[int]:
    return hash_field(inst, bytes_to_elements(inst, data))


def jive_compress_k(inst: InstanceParams, elems: list[int], k: int) -> list[int]:
    """Jive-k: P(x) then out[i] = sum_j x[i+c*j] + P(x)[i+c*j]
    (2_1: hasher.rs:95-109; 4_3: hasher.rs:147-178)."""
    p = inst.field.p
    assert len(elems) == inst.width
    assert inst.width % k == 0 and k % 2 == 0
    state = permutation(inst, elems)
    c = inst.width // k
    out = []
    for i in range(c):
        acc = 0
        for j in range(k):
            acc += elems[i + c * j] + state[i + c * j]
        out.append(acc % p)
    return out


def jive_compress(inst: InstanceParams, elems: list[int]) -> list[int]:
    return jive_compress_k(inst, elems, 2)


def merge(inst: InstanceParams, d0: list[int], d1: list[int]) -> list[int]:
    """Merkle 2-to-1 node combine.

    2_1 delegates to Jive compress (hasher.rs:86-91).  The reference's 4_3
    merge absorbs digests[0] into BOTH rate slots (vesta/anemoi_4_3/
    hasher.rs:136-137) -- an evident copy-paste bug that no reference test
    vector exercises (see SURVEY.md section 2.2-9).  We implement the
    evidently-intended semantics (d0 then d1); `merge_reference_quirk`
    reproduces the reference behavior for auditability.
    """
    if inst.rate == 1:
        return jive_compress(inst, list(d0) + list(d1))
    state = [0] * inst.width
    ds = inst.digest_size
    state[:ds] = list(d0)
    state[ds : 2 * ds] = list(d1)
    state = permutation(inst, state)
    return state[:ds]


def merge_reference_quirk(inst: InstanceParams, d0: list[int], d1: list[int]) -> list[int]:
    """Bit-compatible with the reference 4_3 merge (digests[0] used twice)."""
    if inst.rate == 1:
        return merge(inst, d0, d1)
    return merge(inst, d0, d0)


def digest_to_bytes(inst: InstanceParams, digest: list[int]) -> bytes:
    """Canonical little-endian serialization of digest element(s)
    (reference: anemoi_*/digest.rs:42-46 via ark_serialize)."""
    nbytes = inst.field.digest_bytes
    return b"".join(int(d).to_bytes(nbytes, "little") for d in digest)
