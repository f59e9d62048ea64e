"""Field and instance parameter registry of the PyTorch port.

Counterpart of ``anemoi_tpu/fields/params.py``: the same frozen dataclasses,
read from this package's own copy of ``data/params.json``, with the same
13-bit limb form (``R = 2^(13L)``) at every public boundary.

On top of that it derives what the CUDA kernels need for every field:
32-bit words (8 for the 20-limb fields, 12 for the 30-limb ones),
Montgomery form with ``R' = 2^(32 * words)``, and the two boundary
constants that move a value between the two Montgomery forms.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1

WORD_BITS = 32

_DATA = Path(__file__).parent / "data"


def limbs_from_int(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian base-2^13 limb decomposition as int32[n_limbs]."""
    out = np.zeros(n_limbs, dtype=np.int32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in the given limb count")
    return out


def int_from_limbs(limbs) -> int:
    x = 0
    for i, limb in enumerate(np.asarray(limbs).tolist()):
        x += int(limb) << (LIMB_BITS * i)
    return x


def words_from_int(x: int, n_words: int) -> np.ndarray:
    """Little-endian 32-bit words as uint32[n_words]."""
    out = np.zeros(n_words, dtype=np.uint32)
    for i in range(n_words):
        out[i] = x & 0xFFFFFFFF
        x >>= WORD_BITS
    if x:
        raise ValueError("value does not fit in the given word count")
    return out


@dataclass(frozen=True)
class FieldParams:
    """A prime field with its Anemoi S-box constants (plain-integer domain)."""

    name: str
    p: int
    bits: int
    alpha: int
    beta: int
    delta: int  # beta^-1 mod p
    inv_alpha: int  # alpha^-1 mod (p-1)
    byte_chunk: int
    digest_bytes: int

    @property
    def n_limbs(self) -> int:
        # two spare bits (4p <= R), as in the reference: 20 or 30 limbs
        return -(-(self.bits + 2) // LIMB_BITS)

    @property
    def R(self) -> int:
        return pow(2, LIMB_BITS * self.n_limbs, self.p)

    @property
    def R2(self) -> int:
        return pow(2, 2 * LIMB_BITS * self.n_limbs, self.p)

    @property
    def n0_inv(self) -> int:
        """-p^-1 mod 2^13 (the limb form's Montgomery reduction multiplier)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def p_limbs(self) -> np.ndarray:
        return limbs_from_int(self.p, self.n_limbs)

    def to_mont(self, x: int) -> int:
        return (x % self.p) * self.R % self.p

    def from_mont(self, x: int) -> int:
        return x * pow(self.R, -1, self.p) % self.p

    @property
    def inv_alpha_windows(self) -> tuple[int, ...]:
        """Base-16 digits of inv_alpha, most significant first (no leading
        0): the fixed 4-bit window schedule of x^(1/alpha)."""
        e = self.inv_alpha
        digits = []
        while e:
            digits.append(e & 0xF)
            e >>= 4
        return tuple(reversed(digits))

    @property
    def inv_alpha_sliding_schedule(self) -> tuple[tuple[int, int], ...]:
        """Left-to-right sliding-window schedule of x^inv_alpha: (squarings,
        odd window value) steps over windows of at most 4 bits that start
        and end on a 1-bit.  The first step only seeds the accumulator with
        x^v; each later one squares n times, then multiplies by x^v."""
        bits = bin(self.inv_alpha)[2:]
        n = len(bits)
        steps: list[tuple[int, int]] = []
        i = pending = 0
        while i < n:
            if bits[i] == "0":
                pending += 1
                i += 1
                continue
            length = min(4, n - i)
            while bits[i + length - 1] == "0":
                length -= 1
            steps.append((pending + length, int(bits[i : i + length], 2)))
            pending = 0
            i += length
        if pending:
            raise ValueError("inv_alpha must be odd")
        return tuple(steps)

    # --- the CUDA kernels' 32-bit form -------------------------------------
    @property
    def kernel_words(self) -> int:
        """32-bit words of an element inside the kernels: 8 for the 20-limb
        fields (p below 2^256), 12 for the 30-limb ones (p below 2^384)."""
        return -(-self.bits // WORD_BITS)

    @property
    def kernel_r_bits(self) -> int:
        """R' = 2^kernel_r_bits: 2^256 or 2^384."""
        return WORD_BITS * self.kernel_words

    def kernel_mont(self, x: int) -> int:
        """x in Montgomery form with R'."""
        return (x % self.p) * pow(2, self.kernel_r_bits, self.p) % self.p

    @property
    def kernel_n0(self) -> int:
        """-p^-1 mod 2^32."""
        return (-pow(self.p, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)

    @property
    def kernel_r2(self) -> int:
        """R'^2 mod p."""
        return pow(2, 2 * self.kernel_r_bits, self.p)

    @property
    def c_in(self) -> int:
        """2^(2*32*words - 13L) mod p (2^252 or 2^378): a Montgomery product
        by it turns a*R into a*R'."""
        return pow(2, 2 * self.kernel_r_bits - LIMB_BITS * self.n_limbs, self.p)

    @property
    def c_out(self) -> int:
        """R = 2^(13L) mod p (2^260 or 2^390): a Montgomery product by it
        turns b*R' into b*R."""
        return pow(2, LIMB_BITS * self.n_limbs, self.p)


@dataclass(frozen=True)
class InstanceParams:
    """One Anemoi instantiation (field x state shape) with round constants."""

    field: FieldParams
    name: str
    width: int
    rate: int
    columns: int
    digest_size: int
    rounds: int
    C: tuple[int, ...]  # round-major, len = rounds * columns
    D: tuple[int, ...]
    # an explicit MDS matrix (row-major, columns x columns) for widths with
    # no dedicated fast path; every shipped instance leaves it None
    mds: tuple[int, ...] | None = None

    @property
    def qualified_name(self) -> str:
        return f"{self.field.name}/{self.name}"


class _Registry:
    def __init__(self):
        raw = json.loads((_DATA / "params.json").read_text())
        self.fields: dict[str, FieldParams] = {}
        self.instances: dict[tuple[str, str], InstanceParams] = {}
        for fname, fdata in raw.items():
            fp = FieldParams(
                name=fname,
                p=int(fdata["modulus"]),
                bits=fdata["bits"],
                alpha=fdata["alpha"],
                beta=fdata["beta"],
                delta=int(fdata["delta"]),
                inv_alpha=int(fdata["inv_alpha"]),
                byte_chunk=fdata["byte_chunk"],
                digest_bytes=fdata["digest_bytes"],
            )
            self.fields[fname] = fp
            for iname, idata in fdata["instances"].items():
                self.instances[(fname, iname)] = InstanceParams(
                    field=fp,
                    name=iname,
                    width=idata["width"],
                    rate=idata["rate"],
                    columns=idata["columns"],
                    digest_size=idata["digest_size"],
                    rounds=idata["rounds"],
                    C=tuple(int(c) for c in idata["C"]),
                    D=tuple(int(d) for d in idata["D"]),
                )


@lru_cache(maxsize=1)
def registry() -> _Registry:
    return _Registry()


def get_field(name: str) -> FieldParams:
    try:
        return registry().fields[name]
    except KeyError:
        raise ValueError(
            f"unknown field {name!r}; known fields: {', '.join(FIELD_NAMES)}"
        ) from None


def get_instance(field: str, instance: str) -> InstanceParams:
    try:
        return registry().instances[(field, instance)]
    except KeyError:
        raise ValueError(
            f"unknown instance {field!r}/{instance!r}; known: fields "
            f"{', '.join(FIELD_NAMES)} x instances {', '.join(INSTANCE_NAMES)}"
        ) from None


def all_instances() -> list[InstanceParams]:
    return list(registry().instances.values())


@dataclass(frozen=True, eq=False)
class KernelConsts:
    """The 32-bit-word constants of one instance for the CUDA kernels.

    Every array is little-endian uint32 words, NW = ``field.kernel_words``
    of them per value; field values are canonical and, where marked, in
    Montgomery form with R' = 2^(32 NW).
    """

    p: np.ndarray  # [NW]
    n0: int  # -p^-1 mod 2^32
    r2: np.ndarray  # [NW] R'^2 mod p
    c_in: np.ndarray  # [NW] field.c_in
    c_out: np.ndarray  # [NW] field.c_out
    one: np.ndarray  # [NW] R' form: R' mod p (the sponge's sigma)
    beta: np.ndarray  # [NW] R' form
    delta: np.ndarray  # [NW] R' form
    C: np.ndarray  # [rounds, columns, NW] R' form
    D: np.ndarray  # [rounds, columns, NW] R' form
    inv_alpha: np.ndarray  # [NW] plain exponent words
    inv_alpha_bits: int  # bit length of the exponent

    def arrays(self) -> dict:
        return {k: np.asarray(v) for k, v in vars(self).items()}


def kernel_consts_from_ints(inst: InstanceParams, C, D, beta: int, delta: int, one: int) -> KernelConsts:
    """Kernel constants from plain-integer round constants, S-box constants
    and the field's one."""
    fp = inst.field
    nw = fp.kernel_words
    words = lambda v: words_from_int(v, nw)
    rc = lambda t: np.stack([words(fp.kernel_mont(v)) for v in t]).reshape(inst.rounds, inst.columns, nw)
    return KernelConsts(
        p=words(fp.p),
        n0=fp.kernel_n0,
        r2=words(fp.kernel_r2),
        c_in=words(fp.c_in),
        c_out=words(fp.c_out),
        one=words(fp.kernel_mont(one)),
        beta=words(fp.kernel_mont(beta)),
        delta=words(fp.kernel_mont(delta)),
        C=rc(C),
        D=rc(D),
        inv_alpha=words(fp.inv_alpha),
        inv_alpha_bits=fp.inv_alpha.bit_length(),
    )


@lru_cache(maxsize=None)
def kernel_consts(inst: InstanceParams) -> KernelConsts:
    """The port's own derivation, from its JSON copy."""
    return kernel_consts_from_ints(inst, inst.C, inst.D, inst.field.beta, inst.field.delta, 1)


@lru_cache(maxsize=None)
def inv_alpha_chain(field: str) -> tuple:
    """The reference's addition chain for x^(1/alpha), as register ops
    ("sqr", dst, src) / ("mul", dst, a, b); the result is in the last dst."""
    chains = json.loads((_DATA / "inv_alpha_chains.json").read_text())
    ops = tuple(tuple(op) for op in chains[field]["ops"])
    if ops[-1][1] != chains[field]["out"]:
        raise ValueError(f"inconsistent addition chain for {field}")
    return ops


FIELD_NAMES = (
    "bls12_377",
    "bls12_381",
    "bn_254",
    "ed_on_bls12_377",
    "jubjub",
    "pallas",
    "vesta",
)
INSTANCE_NAMES = ("anemoi_2_1", "anemoi_4_3")
FIELDS_30 = ("bls12_377", "bls12_381")  # 30 limbs, 12 kernel words
FIELDS_20 = tuple(f for f in FIELD_NAMES if f not in FIELDS_30)  # 20 limbs, 8 kernel words
