"""The Jive kernels of the Pasta moduli's shape (``jive_pasta_kernel`` of
``csrc/jive.cu``) on the card: Vesta and Pallas at both widths on a ragged
batch against the plain version bit for bit, each launch counted in
``launch_counts()["jive_pasta"]``; BN-254 (8 words) and BLS12-377 (12
words) launch ``jive_kernel`` and leave that count as it was.  Skips
without a card; imports no JAX, so it runs on the chip as
``python3 -m pytest -o addopts="" --noconftest -q tests/test_torch_jive_pasta_card.py``.
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields.params import get_instance

N = (1 << 16) + 37  # not a multiple of the 128-thread block


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _states(inst, seed: int) -> torch.Tensor:
    W, L = inst.width, inst.field.n_limbs
    x = random_canonical(inst.field, (W, N), np.random.default_rng(seed)).transpose(1, 0, 2).reshape(W * L, N)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["vesta", "pallas", "bn_254", "bls12_377"])
@pytest.mark.parametrize("iname,k", [("anemoi_2_1", 2), ("anemoi_4_3", 2), ("anemoi_4_3", 4)])
def test_jive_kernel_by_modulus_shape(card, field, iname, k):
    inst = get_instance(field, iname)
    x = _states(inst, 23 + k).to(card)
    before = cuda_backend.launch_counts()
    got = cuda_backend.jive(inst, k, x)
    after = cuda_backend.launch_counts()
    assert after["jive"] == before["jive"] + 1
    assert after["jive_pasta"] == before["jive_pasta"] + (field in ("vesta", "pallas"))
    assert torch.equal(got, cuda_backend.jive_plain(inst, k, x))
