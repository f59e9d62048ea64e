"""The Montgomery product with its two constant products on the tensor cores.

Counterpart of ``anemoi_tpu/ff/mxu_ops.py``, the JAX package's product on
the TPU's matrix unit, which its Pallas kernels run by default
(``mul_impl="mxuf"``).  The separated Montgomery product has three
products: T = a * b, which stays on the integer pipe, and two products by
constants, m = (T mod R') * p' mod R' and U = m * p, which are matrix
products: the bytes of T's low half (or of m) times a byte Toeplitz
matrix of the constant.  On the H100 they run on the integer tensor cores
(``csrc/field32_mma.cuh``: ``mma.sync`` m16n8k32, u8 x u8 -> s32, sixteen
states a tile as the M dimension, the constant as the B operand).

Here a field element is the kernels' NW 32-bit words (8 or 12), so
R' = 2^(32 NW) and p' = -p^-1 mod R'.  A column of either matrix product
sums at most 4 NW = 48 products of two bytes: below 48 * 255^2 < 2^22,
exact in the s32 accumulator.

``mxu_consts`` gives the two Toeplitz matrices as uint8, rows the output
byte columns and columns the input bytes (the JAX module's orientation):
p''s lower-triangular one truncated to 4 NW output columns (mod R'), and
p's full one with 8 NW.  Each also comes in the fragment order that the
kernel loads, a permutation of its rows and columns
(``from_fragment_order`` undoes it), and ``fragment_words`` packs that
order into the 32-bit B fragments each lane of a warp loads.

``mont_mul_mxu`` and ``mont_sqr_mxu`` are the plain PyTorch version of the
kernel's product at the I/O contract (int32 [L, N] canonical 13-bit limbs,
R = 2^(13L)): limbs to words, the bilinear product, m and U as int64
matrix products of the byte operands over the batch, the carries as the
kernel takes them, the last subtraction, and one more product by the
constant 2^(64 NW - 13L) mod p that turns R' back into R (as
``csrc/field32.cuh:f32_from_limbs`` does).  The JAX module's names ``mxu``,
``mxuf``, ``mxus``, ``mxu2`` and ``mxu3`` (its stream-fused, fold-packed and
SOS schedules) all select this one function; their outputs are the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..fields.params import LIMB_BITS, FieldParams, get_field

LANES = 32  # a warp
K32 = 32  # the bytes one m16n8k32 step contracts; a 12-word field adds one m16n8k16 step of 16


def selects_mma(mul_impl: str | None) -> bool:
    """Whether a mul_impl name selects the tensor-core product (every name
    that starts with "mxu", as the JAX package's do)."""
    return mul_impl is not None and mul_impl.startswith("mxu")


def _field(field) -> FieldParams:
    return get_field(field) if isinstance(field, str) else field


def _prime(field) -> tuple[int, int]:
    """(p, NW) of a field name, FieldParams or a bare prime below 2^384."""
    if isinstance(field, int):
        return field, 8 if field < 1 << 256 else 12
    fp = _field(field)
    return fp.p, fp.kernel_words


def _bytes(x: int, n: int) -> np.ndarray:
    return np.frombuffer(x.to_bytes(n, "little"), dtype=np.uint8).astype(np.int64)


def _toeplitz(v: np.ndarray, rows: int) -> np.ndarray:
    """W[j, t] = v[j - t] for 0 <= j - t < len(v): output byte column j of
    the product of the bytes x[t] by the constant whose bytes are v."""
    k = len(v)
    w = np.zeros((rows, k), dtype=np.int64)
    for j in range(rows):
        for t in range(max(0, j - k + 1), min(k, j + 1)):
            w[j, t] = v[j - t]
    return w


def input_order(words: int) -> np.ndarray:
    """perm[kappa] = the input byte at fragment K index kappa.  The m16n8k32
    A fragment gives lane t of a quad the 4-byte K slots t and t + 4 (and,
    in the m16n8k16 step of a 12-word field, slot 8 + t), and the group
    slicing gives lane t words [t S, t S + S): slot t holds word t S,
    slot t + 4 word t S + 1, slot 8 + t word t S + 2.  So no byte of the
    A operand crosses lanes."""
    s = words // 4
    perm = []
    for kappa in range(4 * words):
        slot = kappa // 4
        t, w = (slot % 4, slot // 4) if kappa < K32 else (slot - 8, 2)
        perm.append(4 * (s * t + w) + kappa % 4)
    return np.array(perm)


def m_order(words: int) -> np.ndarray:
    """perm[nu] = m's byte column at fragment N index nu = 8 j + 2 t + e:
    tile j's accumulator gives lane t columns 2t and 2t + 1, and lane t
    owns m's bytes [4 S t, 4 S t + 4 S), so tile j holds its bytes 2j and
    2j + 1."""
    s = words // 4
    return np.array([4 * s * (c // 2) + 2 * j + c % 2 for j in range(2 * s) for c in range(8)])


def u_order(words: int) -> np.ndarray:
    """perm[nu] = U's byte column at fragment N index nu.  Tiles 0 to
    2S - 1: U's high half, lane t's bytes as in ``m_order``.  Tile 2S: the
    low half's top two columns 4 NW - 2 and 4 NW - 1 at positions 6 and 7
    (lane 3, which holds T's top low word) after columns 4 NW - 8 to
    4 NW - 3, which the kernel does not read.  Then the other low columns,
    which the kernel never computes: the carry out of the low half follows
    from its top 16 bits alone (``csrc/field32_mma.cuh``)."""
    s, kb = words // 4, 4 * words
    high = [kb + 4 * s * (c // 2) + 2 * j + c % 2 for j in range(2 * s) for c in range(8)]
    return np.array(high + list(range(kb - 8, kb)) + list(range(kb - 8)))


def from_fragment_order(w_frag: np.ndarray, perm_out: np.ndarray, perm_in: np.ndarray) -> np.ndarray:
    """The plain matrix of one in fragment order, w_frag = w[perm_out][:, perm_in]."""
    w = np.zeros_like(w_frag)
    w[np.ix_(perm_out, perm_in)] = w_frag
    return w


@dataclass(frozen=True)
class MxuConsts:
    words: int  # NW
    pprime: int  # -p^-1 mod 2^(32 NW)
    w_pprime: np.ndarray  # uint8 [4 NW, 4 NW]: m's columns from T's low bytes, lower-triangular
    w_p: np.ndarray  # uint8 [8 NW, 4 NW]: U's columns from m's bytes
    w_pprime_frag: np.ndarray  # w_pprime[m_order][:, input_order]
    w_p_frag: np.ndarray  # w_p[u_order][:, input_order]


@lru_cache(maxsize=None)
def mxu_consts(field) -> MxuConsts:
    """The two byte Toeplitz matrices of `field` (a name, FieldParams or a
    bare odd prime below 2^384), in plain and in fragment order."""
    p, nw = _prime(field)
    kb = 4 * nw
    pprime = -pow(p, -1, 1 << (32 * nw)) % (1 << (32 * nw))
    w_pprime = _toeplitz(_bytes(pprime, kb), kb).astype(np.uint8)
    w_p = _toeplitz(_bytes(p, kb), 2 * kb).astype(np.uint8)
    pin = input_order(nw)
    return MxuConsts(nw, pprime, w_pprime, w_p, w_pprime[m_order(nw)][:, pin], w_p[u_order(nw)][:, pin])


def fragment_regs(words: int) -> int:
    """B-fragment registers of one n8 tile: two for the k32 step, one more
    for a 12-word field's k16 step."""
    return 2 if words == 8 else 3


def fragment_tiles(words: int) -> tuple[int, int]:
    """n8 tiles the kernel runs: 2S for m, 2S + 1 for U."""
    return words // 2, words // 2 + 1


# The fragments of mma.sync m16n8k32 and m16n8k16 with u8 operands and s32
# accumulators, lane L = 4 g + t of the warp, byte i of a register at bits
# 8i (the PTX ISA's layouts; csrc/field32_mma.cuh:HostWarp computes the
# product from the same definition, and chip_smoke.py holds both against
# the card's own mma.sync):
#   A [16, K]: register r holds row g + 8 (r & 1), columns 4t + 16 (r >> 1) + i;
#   B [K, 8]: register r holds rows 4t + 16 r + i, column g;
#   C, D [16, 8]: register r holds row g + 8 (r >> 1), column 2t + (r & 1).


def _pack(get, regs: int) -> np.ndarray:
    out = np.zeros((LANES, regs), dtype=np.uint32)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for r in range(regs):
            out[lane, r] = sum(int(get(g, t, r, i)) << (8 * i) for i in range(4))
    return out


def pack_a(a: np.ndarray) -> np.ndarray:
    """u8 A [16, K] (K = 32 or 16) -> uint32 [32, K / 8] registers."""
    return _pack(lambda g, t, r, i: a[g + 8 * (r & 1), 4 * t + 16 * (r >> 1) + i], a.shape[1] // 8)


def pack_b(b: np.ndarray) -> np.ndarray:
    """u8 B [K, 8] (K = 32 or 16) -> uint32 [32, K / 16] registers."""
    return _pack(lambda g, t, r, i: b[4 * t + 16 * r + i, g], b.shape[0] // 16)


def unpack_d(d: np.ndarray) -> np.ndarray:
    """int32 [32, 4] accumulator registers -> D [16, 8]."""
    out = np.zeros((16, 8), dtype=np.int64)
    for lane in range(LANES):
        g, t = divmod(lane, 4)
        for r in range(4):
            out[g + 8 * (r >> 1), 2 * t + (r & 1)] = d[lane, r]
    return out


@lru_cache(maxsize=None)
def fragment_words(field) -> np.ndarray:
    """uint32 [(m tiles + U tiles) * R * 32]: the B fragments the kernel
    loads, word (tile * R + r) * 32 + lane for register r of `lane`; m's
    tiles first, then U's.  Tile j's B is w_frag's rows 8j .. 8j + 7,
    transposed: K slots 0 to 31 in registers 0 and 1 (``pack_b`` of the k32
    step), slots 32 to 47 of a 12-word field in register 2 (the k16 step)."""
    mc = mxu_consts(field)
    nw = mc.words
    out = []
    for w_frag, tiles in zip((mc.w_pprime_frag, mc.w_p_frag), fragment_tiles(nw)):
        for j in range(tiles):
            b = w_frag[8 * j:8 * j + 8].T  # [4 NW, 8]
            regs = np.concatenate([pack_b(b[:K32])] + ([pack_b(b[K32:])] if nw == 12 else []), axis=1)
            out.append(regs.T)  # [R, 32]
    return np.concatenate(out).reshape(-1).astype(np.uint32)


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------


def _carry(cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [C, N] nonnegative byte columns -> (bytes [C, N], the carry out)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for i in range(cols.shape[0]):
        v = cols[i] + carry
        out[i] = v & 0xFF
        carry = v >> 8
    return out, carry


def _mont_bytes(x: torch.Tensor, y: torch.Tensor, fp: FieldParams) -> torch.Tensor:
    """x * y / R' mod p for int64 [4 NW, N] bytes of values below p (or x
    below R' and y below p); canonical bytes out.  The kernel's steps."""
    mc = mxu_consts(fp)
    kb = 4 * mc.words
    dev = x.device
    # the bilinear product T, 8 NW byte columns of at most 48 byte products
    cols = torch.zeros((2 * kb, x.shape[1]), dtype=torch.int64, device=dev)
    for i in range(kb):
        cols[i:i + kb] += x[i] * y
    t, _ = _carry(cols)  # T < p^2 < 2^(64 NW): no carry out
    # m = T_low * p' mod R': the lower-triangular product, its carry out dropped
    m, _ = _carry(torch.from_numpy(mc.w_pprime.astype(np.int64)).to(dev) @ t[:kb])
    u = torch.from_numpy(mc.w_p.astype(np.int64)).to(dev) @ m  # U = m * p, 8 NW columns
    # T_low + U_low is 0 or R' mod R', so its carry out follows from its top 16 bits: the
    # carry into them is below 2^16, and T_low + U_low's low 16 bits there end 0
    top = u[kb - 2] + (u[kb - 1] << 8) + t[kb - 2] + (t[kb - 1] << 8)
    c_low = (top >> 16) + ((top & 0xFFFF) != 0).long()
    high = t[kb:] + u[kb:]
    high[0] += c_low
    h, over = _carry(high)  # below 2p
    p = torch.from_numpy(_bytes(fp.p, kb)).to(dev).unsqueeze(1)
    d, borrow = _carry(h - p)  # a negative column borrows through the arithmetic shift
    take = (over + borrow) >= 0  # h + over * R' >= p
    return torch.where(take, d, h)


def _to_bytes(limbs: torch.Tensor, words: int) -> torch.Tensor:
    """int32 [L, N] 13-bit limbs of values below 2^(32 NW) -> int64 [4 NW, N] bytes."""
    L = limbs.shape[0]
    v = limbs.long() & ((1 << LIMB_BITS) - 1)
    bits = ((v.unsqueeze(1) >> torch.arange(LIMB_BITS, device=v.device).view(1, -1, 1)) & 1).reshape(L * LIMB_BITS, -1)
    bits = bits[: 32 * words]
    weights = (1 << torch.arange(8, device=v.device)).view(1, 8, 1)
    return (bits.reshape(4 * words, 8, -1) * weights).sum(1)


def _to_limbs(b: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """int64 [4 NW, N] bytes -> int32 [L, N] 13-bit limbs."""
    bits = ((b.unsqueeze(1) >> torch.arange(8, device=b.device).view(1, -1, 1)) & 1).reshape(-1, b.shape[1])
    pad = n_limbs * LIMB_BITS - bits.shape[0]
    if pad > 0:
        bits = torch.cat([bits, bits.new_zeros((pad, bits.shape[1]))])
    bits = bits[: n_limbs * LIMB_BITS].reshape(n_limbs, LIMB_BITS, -1)
    return (bits * (1 << torch.arange(LIMB_BITS, device=b.device)).view(1, -1, 1)).sum(1).int()


def mont_mul_mxu(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """a * b / R mod p for int32 [L, N] canonical limbs (R = 2^(13L)),
    canonical out, computed as ``jive_mma_kernel`` computes its products:
    x * y / R' on the words, then a product by 2^(64 NW - 13L) mod p."""
    fp = _field(field)
    nw = fp.kernel_words
    x, y = _to_bytes(a, nw), _to_bytes(b, nw)
    c_in = torch.from_numpy(_bytes(fp.c_in, 4 * nw)).to(a.device).unsqueeze(1).expand(-1, a.shape[1])
    return _to_limbs(_mont_bytes(_mont_bytes(x, y, fp), c_in, fp), fp.n_limbs)


def mont_sqr_mxu(a: torch.Tensor, field) -> torch.Tensor:
    """a^2 / R mod p: ``mont_mul_mxu(a, a)``, as the kernel squares."""
    return mont_mul_mxu(a, a, field)
