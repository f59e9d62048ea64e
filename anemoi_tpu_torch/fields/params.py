"""Field and instance parameter registry of the PyTorch port.

Counterpart of ``anemoi_tpu/fields/params.py``: the same frozen dataclasses,
read from this package's own copy of ``data/params.json``, with the same
13-bit limb form (``R = 2^(13L)``) at every public boundary.

On top of that it derives what the CUDA kernels need for a 20-limb
field: 32-bit words, Montgomery form with ``R' = 2^256``, and the two
boundary constants that move a value between the two Montgomery forms.
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
KERNEL_WORDS = 8  # 32-bit words of a 20-limb field inside the CUDA kernel
KERNEL_R_BITS = WORD_BITS * KERNEL_WORDS  # R' = 2^256

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


def words_from_int(x: int, n_words: int = KERNEL_WORDS) -> np.ndarray:
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
    def p_limbs(self) -> np.ndarray:
        return limbs_from_int(self.p, self.n_limbs)

    def to_mont(self, x: int) -> int:
        return (x % self.p) * self.R % self.p

    def from_mont(self, x: int) -> int:
        return x * pow(self.R, -1, self.p) % self.p

    # --- the CUDA kernel's 32-bit form (20-limb fields only) --------------
    @property
    def has_kernel_form(self) -> bool:
        return self.n_limbs == 20

    def kernel_mont(self, x: int) -> int:
        """x in Montgomery form with R' = 2^256."""
        return (x % self.p) * pow(2, KERNEL_R_BITS, self.p) % self.p

    @property
    def kernel_n0(self) -> int:
        """-p^-1 mod 2^32."""
        return (-pow(self.p, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)

    @property
    def kernel_r2(self) -> int:
        """R'^2 mod p."""
        return pow(2, 2 * KERNEL_R_BITS, self.p)

    @property
    def c_in(self) -> int:
        """2^252 mod p: a Montgomery product by it turns a*2^260 into a*2^256."""
        return pow(2, 2 * KERNEL_R_BITS - LIMB_BITS * self.n_limbs, self.p)

    @property
    def c_out(self) -> int:
        """2^260 mod p: a Montgomery product by it turns b*2^256 into b*2^260."""
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
    """The 32-bit-word constants of one 20-limb instance for the CUDA kernel.

    Every array is little-endian uint32 words; field values are canonical
    and, where marked, in Montgomery form with R' = 2^256.
    """

    p: np.ndarray  # [8]
    n0: int  # -p^-1 mod 2^32
    r2: np.ndarray  # [8] R'^2 mod p
    c_in: np.ndarray  # [8] 2^252 mod p
    c_out: np.ndarray  # [8] 2^260 mod p
    one: np.ndarray  # [8] R' form: 2^256 mod p (the sponge's sigma)
    beta: np.ndarray  # [8] R' form
    delta: np.ndarray  # [8] R' form
    C: np.ndarray  # [rounds, columns, 8] R' form
    D: np.ndarray  # [rounds, columns, 8] R' form
    inv_alpha: np.ndarray  # [8] plain exponent words
    inv_alpha_bits: int  # bit length of the exponent

    def arrays(self) -> dict:
        return {k: np.asarray(v) for k, v in vars(self).items()}


def kernel_consts_from_ints(inst: InstanceParams, C, D, beta: int, delta: int, one: int) -> KernelConsts:
    """Kernel constants from plain-integer round constants, S-box constants
    and the field's one."""
    fp = inst.field
    if not fp.has_kernel_form:
        raise ValueError(f"{fp.name} has {fp.n_limbs} limbs; the kernel takes 20")
    rc = lambda t: np.stack([words_from_int(fp.kernel_mont(v)) for v in t]).reshape(
        inst.rounds, inst.columns, KERNEL_WORDS
    )
    return KernelConsts(
        p=words_from_int(fp.p),
        n0=fp.kernel_n0,
        r2=words_from_int(fp.kernel_r2),
        c_in=words_from_int(fp.c_in),
        c_out=words_from_int(fp.c_out),
        one=words_from_int(fp.kernel_mont(one)),
        beta=words_from_int(fp.kernel_mont(beta)),
        delta=words_from_int(fp.kernel_mont(delta)),
        C=rc(C),
        D=rc(D),
        inv_alpha=words_from_int(fp.inv_alpha),
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
KERNEL_FIELDS = tuple(f for f in FIELD_NAMES if f not in ("bls12_377", "bls12_381"))
