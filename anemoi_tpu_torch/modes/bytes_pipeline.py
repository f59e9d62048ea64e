"""Batched byte hashing: native packing, then the sponge on the device.

Counterpart of ``anemoi_tpu/modes/bytes_pipeline.py``.  The host's hot path
(chunking, padding, 13-bit limb packing) runs in the C++ packer
(``ff/native.py``); the device converts the elements to Montgomery form
(plain PyTorch, ``limb_ops.to_mont``) and runs the sponge for each message
length: one launch of the sponge kernel on the card.

Under a running ``torch.profiler`` a call is an ``anemoi.bytes.hash`` span
holding the host's phases: ``anemoi.bytes.pack`` (the native packer over
every message), ``anemoi.bytes.layout`` (stacking into a contiguous
[E, L, B]) and ``anemoi.bytes.upload`` (the copy to the device).
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
        return _hash_packed(inst, pack_messages(inst, messages), device)


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


def _hash_packed(inst: InstanceParams, elems: np.ndarray, device: torch.device) -> torch.Tensor:
    return sponge_hash_batch_fn(inst, elems.shape[0], device=device)(mont_messages(inst, elems, device))


def hash_bytes_mixed(inst: InstanceParams, messages: list, *, backend: str = "jit", device=None) -> np.ndarray:
    """Hashes byte messages of any lengths on ``device`` (None: the card).

    Messages are bucketed by element count E = ceil(len / byte_chunk), the
    reference's chunking (src/vesta/anemoi_4_3/hasher.rs:18-58); each bucket
    is packed by the native packer and hashed by one sponge call.  Every
    bucket is dispatched before any is fetched, so the card runs them back
    to back.  Returns int32 [DIGEST, L, len(messages)] Montgomery digests in
    the messages' order.  Every ``backend`` name hashes alike: the device
    picks the route (``sponge_hash_batch_fn``)."""
    with span("anemoi.bytes.hash"):
        device = cuda_backend.resolve_device(device)
        L = inst.field.n_limbs
        with span("anemoi.bytes.pack"):
            packed = [native.pack_bytes(m, inst.field) for m in messages]  # (E_i, L) each
        buckets: dict[int, list[int]] = {}
        for idx, p in enumerate(packed):
            buckets.setdefault(p.shape[0], []).append(idx)
        pending = []
        for E, idxs in sorted(buckets.items()):
            with span("anemoi.bytes.layout"):
                elems = np.zeros((0, L, len(idxs)), dtype=np.int32) if E == 0 else \
                    np.ascontiguousarray(np.stack([packed[i] for i in idxs]).transpose(1, 2, 0))
            pending.append((idxs, _hash_packed(inst, elems, device)))
        out = np.zeros((inst.digest_size, L, len(messages)), dtype=np.int32)
        for idxs, digests in pending:
            out[:, :, idxs] = digests.cpu().numpy()
        return out
