"""Jive-k of the port against the JAX package, on the CPU, and the port's
entry points.

Tolerance: exact (integer arithmetic, canonical int32 arrays).  Inputs are
canonical states from numpy seeds, at the batch shape tests/test_jnp_backend.py
compiles (4 lanes), so the JAX side's compiled programs are shared; the
Vesta 2_1 program also takes the first 4 lanes of ``graft_entry.entry()``'s
example.  The
4-to-1 case is held against the JAX package's golden model: compiling its
jnp program for a new shape takes minutes on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.modes import batched as jbm
from anemoi_tpu_torch import graft_entry
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.merkle.tree import MerkleTree
from anemoi_tpu_torch.modes.batched import decode_states, encode_states, jive_compress_batch_fn


def _states(inst, n, seed):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(40), "little") % inst.field.p for _ in range(inst.width)] for _ in range(n)]


@pytest.mark.parametrize("iname", ["anemoi_2_1", "anemoi_4_3"])
def test_plain_jive_matches_jax(iname):
    inst = get_instance("vesta", iname)
    states = _states(inst, 4, 7)
    states[0] = [0] * inst.width
    states[1] = [inst.field.p - 1] * inst.width
    x = encode_states(inst, states, device="cpu")
    jax_fn = jax.jit(jbm.jive_compress_batch_fn(jparams.get_instance("vesta", iname), 2))
    want = jax_fn(x.numpy())
    got = jive_compress_batch_fn(inst, 2, device="cpu")(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if iname == "anemoi_2_1":
        # the port's entry point on the first 4 lanes of its canonical example,
        # through the program compiled above: the same shape, no new compile
        fn, (example,) = graft_entry.entry(device="cpu")
        lanes = example[:, :, :4].contiguous()
        np.testing.assert_array_equal(fn(lanes).numpy(), np.asarray(jax_fn(lanes.numpy())))


def test_plain_jive_matches_jax_bls12_381():
    """A 30-limb field: the SAGE jive vector's input through JAX
    ``instance("bls12_381", "anemoi_2_1").batch.compress_k(arr, 2)`` (the
    call and shape tests/test_jnp_backend.py compiles) and through the
    port's plain path."""
    import anemoi_tpu as at
    from anemoi_tpu.modes import batched as jbm

    from .vector_loader import load_vectors

    pair = load_vectors("bls12_381", "anemoi_2_1")["jive"][0]
    ref = at.instance("bls12_381", "anemoi_2_1")
    want = np.asarray(ref.batch.compress_k(jbm.encode_states(ref.params, pair["input"]), 2))
    inst = get_instance("bls12_381", "anemoi_2_1")
    got = jive_compress_batch_fn(inst, 2, device="cpu")(encode_states(inst, pair["input"], device="cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert decode_states(inst, got) == pair["output"]


def test_plain_jive_4_to_1_matches_golden():
    inst = get_instance("vesta", "anemoi_4_3")
    ref = jparams.get_instance("vesta", "anemoi_4_3")
    states = _states(inst, 3, 8)
    got = decode_states(inst, jive_compress_batch_fn(inst, 4, device="cpu")(encode_states(inst, states, device="cpu")))
    assert got == [golden.jive_compress_k(ref, s, 4) for s in states]


def test_jive_wrapper_rejects_bad_input():
    inst = get_instance("vesta", "anemoi_2_1")
    good = torch.zeros(40, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_backend.jive(inst, 2, good.long())
    with pytest.raises(ValueError):
        cuda_backend.jive(inst, 2, good[:39])
    with pytest.raises(ValueError):
        cuda_backend.jive(inst, 4, good)
    with pytest.raises(ValueError):
        jive_compress_batch_fn(inst, 2, device="cpu")(good)  # needs [WIDTH, L, B]
    assert cuda_backend.jive(inst, 2, good[:, :0]).shape == (20, 0)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst = get_instance("vesta", "anemoi_2_1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jive_compress_batch_fn(inst)
    with pytest.raises(RuntimeError):
        MerkleTree(inst)
    with pytest.raises(RuntimeError):
        encode_states(inst, [[1, 2]])
    jive_compress_batch_fn(inst, device="cpu")


def test_cuda_tensor_goes_to_the_kernel_or_raises(monkeypatch):
    """The wrapper never falls back to the plain path for a CUDA tensor."""
    inst = get_instance("vesta", "anemoi_2_1")

    class FakeCudaTensor(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.zeros(40, 2, dtype=torch.int32).as_subclass(FakeCudaTensor)
    monkeypatch.setattr(cuda_backend, "jive_plain", lambda *a: pytest.fail("plain path taken"))

    def no_library(words):
        assert words == 8
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(cuda_backend, "library", no_library)
    with pytest.raises(RuntimeError, match="no kernel library"):
        cuda_backend.jive(inst, 2, x)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from anemoi_tpu_torch.ff.limb_ops import random_canonical

    rng = np.random.default_rng(12)
    shapes = [("anemoi_2_1", 2), ("anemoi_4_3", 2), ("anemoi_4_3", 4)]
    for field, (iname, k) in [(f, s) for f in ("vesta", "bls12_381") for s in shapes]:
        inst = get_instance(field, iname)
        W, L = inst.width, inst.field.n_limbs
        x = torch.from_numpy(random_canonical(inst.field, (W, 131), rng).transpose(1, 0, 2).copy())
        x = x.reshape(W * L, 131).cuda()
        got = jive_compress_batch_fn(inst, k)(x.reshape(W, L, 131))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.reshape(-1, 131).cpu().numpy(), cuda_backend.jive_plain(inst, k, x).cpu().numpy())
