"""Streaming byte hashing with the host's work overlapped with the card.

Counterpart of ``anemoi_tpu/modes/async_pipeline.py``.  Each batch goes
through ``hash_bytes_batch``, the byte route of every byte call:

    1. host:     the messages' bytes joined into one page-locked buffer
                 (``gather_messages``);
    2. upload:   a ``non_blocking`` copy of that buffer to the card;
    3. card:     the unpack kernel (bytes to Montgomery limbs), the sponge
                 kernel and, with ``export``, the conversion back to
                 canonical limbs; then a ``non_blocking`` copy of the
                 digests into a pinned buffer and an event.

Stages 2 and 3 run on one stream of their own, so the host gathers batch
k+1 while the card hashes batch k.  A result is fetched one batch behind
the dispatch front, and only after its event has completed.

    pipe = AsyncByteHasher(inst)
    for batch in batches:                 # lists of equal-length bytes
        for digests in pipe.feed(batch):
            ...                           # int32 [DIGEST, L, B] canonical
    for digests in pipe.drain():
        ...

On the CPU (``device="cpu"``) the same stages run one after another on
the plain path, and ``feed`` and ``drain`` keep the same contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import cuda_backend
from ..fields.params import InstanceParams
from .batched import digest_export_fn
from .bytes_pipeline import hash_bytes_batch


class AsyncByteHasher:
    """Depth-1 pipelined hasher over batches of equal-length messages on
    ``device`` (None: the card).

    ``feed(batch)`` gathers and dispatches the batch and yields the results
    of the batches it has overtaken; ``drain()`` yields the rest.  Results
    are int32 [DIGEST, L, B] numpy arrays: canonical limbs (ready for
    ``digests_to_bytes``) with ``export``, Montgomery limbs without.  Every
    ``backend`` name hashes alike: the device picks the route."""

    def __init__(self, inst: InstanceParams, *, backend: str = "jit", export: bool = True, device=None):
        self.inst = inst
        self.device = cuda_backend.resolve_device(device)
        self._export = digest_export_fn(inst) if export else None
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._inflight: list = []

    def _digests(self, messages: list) -> torch.Tensor:
        """One batch's digests on the device, not waited for."""
        out = hash_bytes_batch(self.inst, messages, device=self.device)
        return out if self._export is None else self._export(out)

    def _dispatch(self, messages: list):
        if self._stream is None:
            return self._digests(messages).numpy(), None
        with torch.cuda.stream(self._stream):
            out = self._digests(messages)
            fetched = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            fetched.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return fetched, done

    def _fetch(self) -> np.ndarray:
        fetched, done = self._inflight.pop(0)
        if done is None:
            return fetched
        done.synchronize()
        return fetched.numpy().copy()

    def feed(self, messages: list):
        """Dispatches one batch; yields the results of earlier batches."""
        self._inflight.append(self._dispatch(messages))
        while len(self._inflight) > 1:
            yield self._fetch()

    def drain(self):
        """Yields the results still in flight, waiting for each."""
        while self._inflight:
            yield self._fetch()
