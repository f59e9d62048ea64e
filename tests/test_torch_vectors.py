"""The port's plain Jive against the SAGE vectors of all seven fields, and
the plain path's cost in tensor calls.

Tolerance: exact (the vectors' field elements).
"""

import numpy as np
import pytest
from torch.overrides import TorchFunctionMode

from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.fields.params import FIELD_NAMES, get_instance
from anemoi_tpu_torch.modes.batched import decode_states, encode_states, jive_compress_batch_fn

from .vector_loader import load_vectors


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_plain_jive_vectors(field):
    for iname in ("anemoi_2_1", "anemoi_4_3"):
        inst = get_instance(field, iname)
        for pair, k in zip(load_vectors(field, iname)["jive"], [2, 4]):
            x = encode_states(inst, pair["input"], device="cpu")
            got = decode_states(inst, jive_compress_batch_fn(inst, k, device="cpu")(x))
            assert got == pair["output"], (field, iname, k)


def test_plain_jive_call_count(capsys):
    """The plain path's tensor calls in one Vesta 2_1 Jive: its cost on the
    card, where each call is at most one launch."""

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    inst = get_instance("vesta", "anemoi_2_1")
    rng = np.random.default_rng(9)
    x = encode_states(inst, [[int(v) for v in rng.integers(0, 2**62, 2)]], device="cpu").reshape(40, 1)
    with Count():
        cuda_backend.jive_plain(inst, 2, x)
    with capsys.disabled():
        print(f"\nplain Vesta 2_1 Jive: {Count.n} torch calls")
    assert Count.n < 1_200_000
