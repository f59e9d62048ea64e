"""Streaming batched sponge: absorb B equal-length element streams in
rate-aligned chunks.

Counterpart of ``anemoi_tpu/modes/streaming.py``.  The absorb loop is
sequential in message position, so a stream is fed chunk by chunk while
the state stays on the device:

    sponge = BatchedSponge(inst, batch=4096)
    for chunk in chunks:            # int32 [E_i, L, B], E_i % rate == 0
        sponge.absorb(chunk)
    digest = sponge.finalize(tail)  # tail: int32 [T, L, B], T < rate

Each rate-block is added into the rate with plain PyTorch and permuted by
one launch of the permutation kernel on the card (the plain permutation on
the CPU).
"""

from __future__ import annotations

import torch

from ..ff import cuda_backend
from ..ff import limb_ops as lo
from ..fields.params import InstanceParams


class BatchedSponge:
    """Incremental sponge over a batch of B equal-length element streams on
    ``device`` (None: the card).

    The device picks the route, not ``backend``: every name the JAX package
    takes and the port's "cuda" launch the permutation kernel on the card
    and run the plain version on the CPU.  ``block_b`` is accepted and
    ignored: the kernel chooses its own blocking."""

    def __init__(
        self, inst: InstanceParams, batch: int, *, backend: str = "jit", block_b: int | None = None, device=None
    ):
        self.inst = inst
        self.fc = lo.field_consts(inst.field)
        self.device = cuda_backend.resolve_device(device)
        self.batch = batch
        L = inst.field.n_limbs
        self.state = torch.zeros((inst.width, L, batch), dtype=torch.int32, device=self.device)
        self.count = 0  # elements absorbed per stream

    def _check(self, elems: torch.Tensor) -> None:
        L = self.inst.field.n_limbs
        if not isinstance(elems, torch.Tensor) or elems.device.type != self.device.type:
            raise ValueError(f"expected a tensor on {self.device}")
        if elems.dim() != 3 or tuple(elems.shape[1:]) != (L, self.batch):
            raise ValueError(f"expected elements [E, {L}, {self.batch}], got {tuple(elems.shape)}")

    def _permute(self, state: torch.Tensor) -> torch.Tensor:
        W, L, B = state.shape
        return cuda_backend.permutation(self.inst, state.reshape(W * L, B)).reshape(W, L, B)

    def absorb(self, elems: torch.Tensor) -> None:
        """elems: int32 [E, L, B] Montgomery, E a multiple of the rate."""
        self._check(elems)
        rate = self.inst.rate
        E = elems.shape[0]
        if E % rate:
            raise ValueError(f"stream chunks must be rate-aligned: {E} elements, rate {rate}")
        state = self.state
        for b in range(E // rate):
            rows = [lo.add_mod(state[i], elems[b * rate + i], self.fc) for i in range(rate)]
            state = self._permute(torch.cat([torch.stack(rows), state[rate:]]))
        self.state = state
        self.count += E

    def finalize(self, tail: torch.Tensor | None = None) -> torch.Tensor:
        """tail: int32 [T, L, B] with T < rate (or None); returns the digest
        int32 [DIGEST, L, B] with the reference's sigma / padding rules:
        rate 1 takes no tail and adds sigma to the last capacity word; a
        total that the rate divides adds sigma there too, with no further
        permutation; any other total adds the tail, then 1 after it, and
        permutes once more."""
        inst, fc = self.inst, self.fc
        T = 0 if tail is None else tail.shape[0]
        if tail is not None:
            self._check(tail)
        if inst.rate == 1 and T:
            raise ValueError("a rate-1 sponge takes no tail")
        if T >= inst.rate:
            raise ValueError(f"the tail must be shorter than the rate {inst.rate}")
        rows = list(self.state.unbind(0))
        for i in range(T):
            rows[i] = lo.add_mod(rows[i], tail[i], fc)
        if (self.count + T) % inst.rate == 0:
            rows[-1] = lo.add_const(rows[-1], fc.one_mont, fc)
            return torch.stack(rows[: inst.digest_size])
        rows[T] = lo.add_const(rows[T], fc.one_mont, fc)
        return self._permute(torch.stack(rows))[: inst.digest_size]
