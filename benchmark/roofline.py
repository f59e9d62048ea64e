"""The roofline: the least time the card could take for the work of a call.

The work is counted from the algorithm's definition, never from the
program's instructions, so every kernel that does the same work is held
to the same least time:

  * field products: a permutation needs, in each round and column, the
    Flystel's two squarings and two products by the generator, and
    x^(1/alpha) by the plain binary method over its exponent (bit length
    minus one squarings, popcount minus one products).  The additions and
    the linear layer are not counted.
  * operations: each product of w 32-bit words is 2 (4w)^2 + 4w byte
    multiply-accumulates (the schoolbook product and its Montgomery
    reduction, byte by byte), at 2 operations each, over the card's dense
    int8 tensor rate: its fastest arithmetic, so no kernel can pass 100%.
  * bytes: the API's int32 limbs of the inputs read once and the outputs
    written once, over the card's memory bandwidth.

The peaks are NVIDIA's published figures for the H100 SXM (dense, at its
700 W limit).
"""

from __future__ import annotations

from dataclasses import dataclass

# name fragment of torch.cuda.get_device_name() -> published peaks
PEAKS = {
    "H100": {"int8_ops_per_s": 1979e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return next((v for k, v in PEAKS.items() if k in device_name), None)


@dataclass(frozen=True)
class Work:
    ops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def __mul__(self, n: float) -> "Work":
        return Work(self.ops * n, self.bytes * n)


def words(bits: int) -> int:
    """32-bit words of an element: 8 up to 256 bits, 12 up to 384."""
    return -(-bits // 32)


def products_per_permutation(rounds: int, columns: int, inv_alpha: int) -> int:
    per_column = 4 + (inv_alpha.bit_length() - 1) + (bin(inv_alpha).count("1") - 1)
    return rounds * columns * per_column


def ops_per_product(bits: int) -> int:
    n = 4 * words(bits)  # bytes of an operand
    return 2 * (2 * n * n + n)


def permutations_per_message(elements: int, rate: int) -> int:
    """The sponge's permutations for a message of `elements` field elements."""
    if rate == 1:
        return elements
    return elements // rate + (1 if elements % rate else 0)


def _ops_per_permutation(defn) -> int:
    return products_per_permutation(defn.rounds, defn.columns, defn.inv_alpha) * ops_per_product(defn.bits)


def jive(defn, n: int, k: int = 2) -> Work:
    """n Jive-k compressions of the instance `defn` (``reference.anemoi.Instance``):
    width elements in, width / k out."""
    elem = 4 * defn.n_limbs
    return Work(ops=n * _ops_per_permutation(defn), bytes=n * elem * (defn.width + defn.width // k))


def sponge(defn, n: int, elements: int) -> Work:
    """The sponge of the instance `defn` over n messages of `elements` field elements each."""
    perms = permutations_per_message(elements, defn.rate)
    elem = 4 * defn.n_limbs
    return Work(ops=n * perms * _ops_per_permutation(defn), bytes=n * elem * (elements + defn.digest_size))


def least_time(work: Work, device_name: str) -> tuple[float, str] | None:
    """(seconds, bounding term) of the work on the named card, or None for
    a card with no published peaks here."""
    pk = peaks(device_name)
    if pk is None:
        return None
    t_ops = work.ops / pk["int8_ops_per_s"]
    t_bytes = work.bytes / pk["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
