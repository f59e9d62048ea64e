"""Batched sponge, Jive and merge over limb-state tensors.

Counterpart of ``anemoi_tpu/modes/batched.py``.  A batch of B states is
int32 [WIDTH, L, B] in Montgomery form, canonical; a batch of B messages of
E elements is int32 [E, L, B].  On the card each call is a launch of one of
the CUDA kernels of ``ff/cuda_backend.py`` (or none, for an empty message);
on the CPU it runs the kernels' plain versions.  The device is the card
when ``device`` is None, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import cuda_backend
from ..ff import limb_ops as lo
from ..fields.params import InstanceParams


def _check_on(x, device: torch.device, shape: tuple, what: str) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != device.type:
        raise ValueError(f"expected a tensor on {device}")
    if x.dim() != len(shape) + 1 or tuple(x.shape[:-1]) != shape:
        raise ValueError(f"expected {what} {list(shape) + ['B']}, got {tuple(x.shape)}")


def jive_compress_batch_fn(inst: InstanceParams, k: int = 2, *, unroll: bool = False, device=None,
                           mul_impl: str | None = None):
    """Returns f(states: int32 [WIDTH, L, B]) -> int32 [WIDTH//k, L, B].

    Jive-k: out[i] = sum_j (x[i+c*j] + P(x)[i+c*j]), c = WIDTH//k.
    ``device`` None means the card; the function takes tensors on that
    device only.  ``unroll`` (the JAX package's XLA graph form) is accepted
    and ignored: the kernel chooses its own code.  ``mul_impl`` is the JAX
    kernel's product (``jive_pallas``'s keyword): a name that starts with
    "mxu" runs the tensor-core Jive kernel on the card
    (``cuda_backend.jive``); every name gives the same outputs, and one the
    JAX package rejects raises ``ValueError``."""
    if inst.width % k or k % 2:
        raise ValueError(f"{inst.qualified_name} has no Jive-{k}")
    lo.check_tuning(mul_impl)
    device = cuda_backend.resolve_device(device)
    W, L = inst.width, inst.field.n_limbs

    def compress(states: torch.Tensor) -> torch.Tensor:
        _check_on(states, device, (W, L), "states")
        B = states.shape[2]
        return cuda_backend.jive(inst, k, states.reshape(W * L, B), mul_impl).reshape(W // k, L, B)

    return compress


def merge_batch_fn(inst: InstanceParams, *, unroll: bool = False, device=None):
    """Returns f(d0, d1: int32 [DIGEST, L, B]) -> int32 [DIGEST, L, B]: the
    Merkle 2-to-1 node.

    2_1 is Jive 2-to-1 (one launch of the Jive kernel); 4_3 absorbs both
    digests into the rate and permutes once (one launch of the permutation
    kernel), with the reference's digests[0]-twice quirk corrected, as in
    the JAX package (see ``golden.merge``).  ``unroll`` is accepted and
    ignored, as in ``jive_compress_batch_fn``."""
    device = cuda_backend.resolve_device(device)
    ds, L, W = inst.digest_size, inst.field.n_limbs, inst.width
    compress = jive_compress_batch_fn(inst, 2, device=device) if inst.rate == 1 else None

    def merge(d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
        for d in (d0, d1):
            _check_on(d, device, (ds, L), "digests")
        if compress is not None:
            return compress(torch.cat([d0, d1], dim=0))
        B = d0.shape[-1]
        zeros = torch.zeros((W - 2 * ds, L, B), dtype=torch.int32, device=d0.device)
        state = torch.cat([d0, d1, zeros], dim=0).reshape(W * L, B)
        return cuda_backend.permutation(inst, state)[: ds * L].reshape(ds, L, B)

    return merge


def sponge_hash_batch_fn(
    inst: InstanceParams, num_elements: int, *, backend: str = "jit", block_b: int | None = None, device=None
):
    """Returns f(elems: int32 [E, L, B] Montgomery) -> int32 [DIGEST, L, B]
    for a fixed message length E.

    The JAX package's dispatch: E >= rate is one launch of the fused sponge
    kernel; 0 < E < rate (4_3 with one or two elements) puts the elements
    and sigma = 1 into the rate of a zero state on the host's side and
    launches the permutation once; E = 0 absorbs nothing, and its digest is
    0 with no launch (reference hasher.rs:92-128).

    The device picks the route, not ``backend``: every name the JAX package
    takes ("pallas", "jit" or any other) and the port's "cuda" give the
    kernels on the card and the plain version on the CPU, with the same
    digests.  ``block_b`` is accepted and ignored: the kernels choose their
    own blocking."""
    device = cuda_backend.resolve_device(device)
    W, L, rate, ds = inst.width, inst.field.n_limbs, inst.rate, inst.digest_size
    E = num_elements
    one = torch.as_tensor(lo.field_consts(inst.field).one_mont.reshape(1, L, 1))

    def hash_batch(elems: torch.Tensor) -> torch.Tensor:
        _check_on(elems, device, (E, L), "messages")
        B = elems.shape[-1]
        if E >= rate:
            return cuda_backend.sponge(inst, E, elems.reshape(E * L, B)).reshape(ds, L, B)
        if E == 0:
            return torch.zeros((ds, L, B), dtype=torch.int32, device=elems.device)
        # the state is 0, so absorbing an element sets its rate word
        sigma = one.to(elems.device).expand(1, L, B)
        zeros = torch.zeros((W - E - 1, L, B), dtype=torch.int32, device=elems.device)
        state = torch.cat([elems, sigma, zeros], dim=0).reshape(W * L, B)
        return cuda_backend.permutation(inst, state)[: ds * L].reshape(ds, L, B)

    return hash_batch


def encode_states(inst: InstanceParams, states: list, *, mont: bool = True, device=None) -> torch.Tensor:
    """list of B states (each WIDTH ints) -> int32 [WIDTH, L, B] on ``device``
    (None: the card)."""
    device = cuda_backend.resolve_device(device)
    width = len(states[0])
    arr = torch.stack([lo.encode_ints([s[w] for s in states], inst.field, mont=mont) for w in range(width)])
    return arr.to(device)


def decode_states(inst: InstanceParams, arr, *, mont: bool = True) -> list:
    """int32 [K, L, B] (tensor on any device, or array) -> list of B lists of K ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    per_w = [lo.decode_ints(arr[w], inst.field, mont=mont) for w in range(arr.shape[0])]
    return [[per_w[w][b] for w in range(arr.shape[0])] for b in range(arr.shape[-1])]


# --------------------------------------------------------------------------
# batched digest serialization (reference: anemoi_*/digest.rs:42-46)
# --------------------------------------------------------------------------


def digest_export_fn(inst: InstanceParams):
    """Returns f(d: int32 [DIGEST, L, B] Montgomery, a tensor on any device
    or an array) -> int32 [DIGEST, L, B] canonical plain-integer limbs, on
    the same device: the device half of digest byte serialization.  Pair
    with ``digests_to_bytes`` for the host half."""
    fc = lo.field_consts(inst.field)

    def export(d):
        d = torch.as_tensor(d)
        ds, L, B = d.shape
        flat = d.permute(1, 0, 2).reshape(L, ds * B)  # every digest element a column
        return lo.from_mont(flat, fc).reshape(L, ds, B).permute(1, 0, 2).contiguous()

    return export


def digests_to_bytes(inst: InstanceParams, canon) -> list[bytes]:
    """int32 [DIGEST, L, B] canonical plain limbs (tensor or array) -> B
    little-endian byte strings, digest_bytes per element (32 B for the
    fields up to 255 bits, 48 B for BLS12-377/381: reference digest.rs
    ``to_bytes`` via ark_serialize).  Vectorized over the batch: limbs ->
    13-bit little-endian bitstream -> packed bytes."""
    if isinstance(canon, torch.Tensor):
        canon = canon.cpu().numpy()
    arr = np.asarray(canon)
    ds, L, B = arr.shape
    nbytes = inst.field.digest_bytes
    lo16 = arr.astype(np.uint16)
    by = np.stack([lo16 & 0xFF, lo16 >> 8], axis=-1).astype(np.uint8)  # (ds, L, B, 2)
    bits = np.unpackbits(by, axis=-1, bitorder="little")[..., :13]  # each limb gives 13 bits
    stream = bits.transpose(0, 2, 1, 3).reshape(ds, B, 13 * L)
    want = 8 * nbytes
    if stream.shape[-1] < want:
        stream = np.concatenate([stream, np.zeros((ds, B, want - stream.shape[-1]), dtype=np.uint8)], axis=-1)
    else:
        stream = stream[..., :want]
    packed = np.packbits(stream, axis=-1, bitorder="little")  # (ds, B, nbytes)
    return [b"".join(packed[e, b].tobytes() for e in range(ds)) for b in range(B)]
