"""Batched Jive-k over limb-state tensors.

Counterpart of ``anemoi_tpu/modes/batched.py`` (Jive and the host-side
encode / decode of states).  A batch of B states is int32 [WIDTH, L, B] in
Montgomery form, canonical.  On the card a call is one launch of the CUDA
kernel; on the CPU it runs the kernel's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ff import cuda_backend
from ..ff import limb_ops as lo
from ..fields.params import InstanceParams


def jive_compress_batch_fn(inst: InstanceParams, k: int = 2, *, device=None):
    """Returns f(states: int32 [WIDTH, L, B]) -> int32 [WIDTH//k, L, B].

    Jive-k: out[i] = sum_j (x[i+c*j] + P(x)[i+c*j]), c = WIDTH//k.
    ``device`` None means the card; the function takes tensors on that
    device only."""
    if inst.width % k or k % 2:
        raise ValueError(f"{inst.qualified_name} has no Jive-{k}")
    device = cuda_backend.resolve_device(device)
    W, L = inst.width, inst.field.n_limbs

    def compress(states: torch.Tensor) -> torch.Tensor:
        if not isinstance(states, torch.Tensor) or states.device.type != device.type:
            raise ValueError(f"expected a tensor on {device}")
        if states.dim() != 3 or tuple(states.shape[:2]) != (W, L):
            raise ValueError(f"expected states [{W}, {L}, B], got {tuple(states.shape)}")
        B = states.shape[2]
        return cuda_backend.jive(inst, k, states.reshape(W * L, B)).reshape(W // k, L, B)

    return compress


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
