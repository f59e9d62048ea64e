"""Batched byte hashing: the messages' bytes gathered on the host, unpacked
and hashed on the device.

Counterpart of ``anemoi_tpu/modes/bytes_pipeline.py``.  Messages are
bucketed by element count E = ceil(len / byte_chunk), the reference's
chunking (src/vesta/anemoi_4_3/hasher.rs:18-58).  The host joins each
bucket's bytes into one buffer with each message's offset and length
(``gather_messages``) and copies both to the device;
``cuda_backend.unpack`` turns them into int32 [E, L, B] Montgomery limbs
(chunking, the pad byte, 13-bit limbs, the domain conversion: one launch
of ``csrc/unpack.cu`` on the card, its plain version on the CPU) and
``sponge_hash_batch_fn`` hashes them: one sponge launch on the card.

Under a running ``torch.profiler`` a call is an ``anemoi.bytes.hash`` span
holding the host's phases: ``anemoi.bytes.pack`` (the lengths, element
counts and buckets over every message), then for each bucket
``anemoi.bytes.layout`` (the join into one buffer) and
``anemoi.bytes.upload`` (the copy of the buffer and the spans to the
device).

``pack_messages`` and ``mont_messages`` are the older host route (the
native packer, a stack into [E, L, B], ``limb_ops.to_mont``), which
``AsyncByteHasher`` runs; it records ``pack``, ``layout`` and ``upload``
too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import cuda_backend, native
from ..ff import limb_ops as lo
from ..fields.params import InstanceParams
from ..utils.profiling import span
from .batched import sponge_hash_batch_fn


def pack_messages(inst: InstanceParams, messages: list) -> np.ndarray:
    """Equal-length byte messages -> canonical int32 [E, L, B] limbs."""
    if len({len(m) for m in messages}) != 1:
        raise ValueError("the messages of a batch must share a byte length")
    with span("anemoi.bytes.pack"):
        packed = [native.pack_bytes(m, inst.field) for m in messages]  # (E, L) each
    with span("anemoi.bytes.layout"):
        return np.ascontiguousarray(np.stack(packed).transpose(1, 2, 0))


def hash_bytes_batch(inst: InstanceParams, messages: list, *, backend: str = "jit", device=None) -> torch.Tensor:
    """Hashes a batch of equal-length byte messages on ``device`` (None: the
    card); returns int32 [DIGEST, L, B] Montgomery digests there.  Every
    ``backend`` name hashes alike: the device picks the route
    (``sponge_hash_batch_fn``)."""
    with span("anemoi.bytes.hash"):
        device = cuda_backend.resolve_device(device)
        with span("anemoi.bytes.pack"):
            lengths, buckets = bucket_messages(inst, messages)
        if len(set(lengths.tolist())) != 1:
            raise ValueError("the messages of a batch must share a byte length")
        (E, idxs), = buckets.items()
        return _hash_bucket(inst, messages, lengths, E, idxs, device)


def mont_messages(inst: InstanceParams, elems, device) -> torch.Tensor:
    """Canonical int32 [E, L, B] limbs (an array on the host, or a tensor)
    -> contiguous int32 [E, L, B] Montgomery limbs on ``device``."""
    E, L, B = elems.shape
    with span("anemoi.bytes.upload"):
        folded = torch.as_tensor(elems).to(device)
    # fold E into the batch axis for one domain conversion; reusing the name
    # frees the uploaded copy once it is folded
    folded = folded.permute(1, 0, 2).reshape(L, E * B)
    return lo.to_mont(folded, lo.field_consts(inst.field)).reshape(L, E, B).permute(1, 0, 2).contiguous()


def bucket_messages(inst: InstanceParams, messages: list) -> tuple[np.ndarray, dict]:
    """The messages' byte lengths (int64 [n]) and their buckets: element
    count E -> the indices of the messages of E elements, in input order,
    by increasing E."""
    lengths = np.fromiter(map(len, messages), dtype=np.int64, count=len(messages))
    elements = -(-lengths // inst.field.byte_chunk)
    return lengths, {int(E): np.flatnonzero(elements == E) for E in np.unique(elements)}


def gather_messages(messages: list, lengths: np.ndarray, idxs: np.ndarray, *,
                    pin: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The messages `idxs` joined into one uint8 buffer on the host (in
    page-locked memory with ``pin``), and int64 [2, B]: each one's offset
    in it and its length (``cuda_backend.unpack``'s input)."""
    lens = lengths[idxs]
    data = torch.empty(int(lens.sum()), dtype=torch.uint8, pin_memory=pin)
    np.concatenate([np.frombuffer(messages[i], dtype=np.uint8) for i in idxs], out=data.numpy())
    return data, torch.from_numpy(np.stack([np.cumsum(lens) - lens, lens]))


def _hash_bucket(inst: InstanceParams, messages: list, lengths: np.ndarray, E: int, idxs: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """Gathers, uploads, unpacks and hashes one bucket; returns its int32
    [DIGEST, L, B] digests on ``device``, not waited for.  For the card the
    bytes are joined into page-locked memory (PyTorch's pinned-memory cache
    reuses the block once its copy is done), so the copy runs at the bus's
    rate and the host does not wait for it."""
    with span("anemoi.bytes.layout"):
        data, spans = gather_messages(messages, lengths, idxs, pin=device.type == "cuda")
    with span("anemoi.bytes.upload"):
        data, spans = data.to(device, non_blocking=True), spans.to(device)
    return sponge_hash_batch_fn(inst, E, device=device)(cuda_backend.unpack(inst, E, data, spans))


def hash_bytes_mixed(inst: InstanceParams, messages: list, *, backend: str = "jit", device=None) -> np.ndarray:
    """Hashes byte messages of any lengths on ``device`` (None: the card).

    One bucket a message length in elements, each gathered, unpacked and
    hashed by one sponge call.  Every bucket is dispatched before any is
    fetched, so the card runs them back to back.  Returns int32
    [DIGEST, L, len(messages)] Montgomery digests in the messages' order.
    Every ``backend`` name hashes alike: the device picks the route
    (``sponge_hash_batch_fn``)."""
    with span("anemoi.bytes.hash"):
        device = cuda_backend.resolve_device(device)
        with span("anemoi.bytes.pack"):
            lengths, buckets = bucket_messages(inst, messages)
        pending = [(idxs, _hash_bucket(inst, messages, lengths, E, idxs, device)) for E, idxs in buckets.items()]
        out = np.zeros((inst.digest_size, inst.field.n_limbs, len(messages)), dtype=np.int32)
        for idxs, digests in pending:
            out[:, :, idxs] = digests.cpu().numpy()
        return out
