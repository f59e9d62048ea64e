"""The port's sponge path on the CPU against the JAX package: its copy of
the golden model for all 14 instances, and the plain versions of the
permutation and sponge kernels (the wrappers' CPU path) with the JAX
dispatch around them.

Tolerance: exact (integer arithmetic, canonical int32 arrays).  Inputs come
from numpy seeds.  The JAX jit sponge is compiled at one shape only, the
one tests/test_bytes_pipeline.py compiles (Vesta 4_3, E = 4, B = 4); the
other cases are held against the JAX package's golden model.
"""

import dataclasses
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.modes import batched as jbm
from anemoi_tpu_torch.ff import cuda_backend, golden
from anemoi_tpu_torch.fields.params import all_instances, get_instance
from anemoi_tpu_torch.modes.batched import decode_states, encode_states, merge_batch_fn, sponge_hash_batch_fn

ALL = [(i.field.name, i.name) for i in all_instances()]


def _ints(inst, n, rng):
    return [int.from_bytes(rng.bytes(56), "little") % inst.field.p for _ in range(n)]


@pytest.mark.parametrize("field,iname", ALL)
def test_golden_copy_matches_jax(field, iname):
    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    rng = np.random.default_rng(ALL.index((field, iname)))
    W, ds, rate, chunk = inst.width, inst.digest_size, inst.rate, inst.field.byte_chunk
    for state in ([0] * W, _ints(inst, W, rng)):
        assert golden.permutation(inst, state) == jgolden.permutation(ref, state)
        assert golden.sbox_layer(inst, state) == jgolden.sbox_layer(ref, state)
        assert golden.round_fn(inst, state, 1) == jgolden.round_fn(ref, state, 1)
        for k in (2, 4)[: W // 2]:
            assert golden.jive_compress_k(inst, state, k) == jgolden.jive_compress_k(ref, state, k)
    for n in (0, 1, rate, rate + 1, 7):
        elems = _ints(inst, n, rng)
        assert golden.hash_field(inst, elems) == jgolden.hash_field(ref, elems), n
    for n in (0, 5, chunk, chunk + 1, 100):
        data = rng.bytes(n)
        assert golden.bytes_to_elements(inst, data) == jgolden.bytes_to_elements(ref, data)
        assert golden.hash_bytes(inst, data) == jgolden.hash_bytes(ref, data), n
    d0, d1 = _ints(inst, ds, rng), _ints(inst, ds, rng)
    assert golden.merge(inst, d0, d1) == jgolden.merge(ref, d0, d1)
    assert golden.merge_reference_quirk(inst, d0, d1) == jgolden.merge_reference_quirk(ref, d0, d1)
    assert golden.digest_to_bytes(inst, d0) == jgolden.digest_to_bytes(ref, d0)


@pytest.mark.parametrize("cols", [3, 4, 5, 6, "matrix"])
def test_golden_wide_mds_matches_jax(cols):
    """The wide-MDS helpers on synthetic instances, as tests/test_mds_wide.py
    builds them; "matrix" is the generic fallback with an explicit matrix."""
    mds = tuple(range(1, 50)) if cols == "matrix" else None
    c = 7 if cols == "matrix" else cols
    wide = lambda base: dataclasses.replace(base, name=f"synthetic_{2 * c}", width=2 * c, rate=2 * c - 1,
                                            columns=c, mds=mds)
    inst, ref = wide(get_instance("vesta", "anemoi_2_1")), wide(jparams.get_instance("vesta", "anemoi_2_1"))
    rng = np.random.default_rng(31)
    for _ in range(3):
        state = _ints(inst, 2 * c, rng)
        assert golden.mds_layer(inst, state) == jgolden.mds_layer(ref, state)


def _messages(iname, E, B=4, seed=41):
    inst = get_instance("vesta", iname)
    rng = np.random.default_rng(seed + E)
    msgs = [_ints(inst, E, rng) for _ in range(B)]
    msgs[0] = [inst.field.p - 1] * E
    return inst, msgs


def _encode_messages(inst, msgs):
    """B messages of E plain ints -> int32 [E, L, B] Montgomery limbs on the CPU."""
    E = len(msgs[0])
    if E == 0:
        return torch.zeros((0, inst.field.n_limbs, len(msgs)), dtype=torch.int32)
    return encode_states(inst, msgs, device="cpu")


@lru_cache(maxsize=None)
def _plain_digests(iname, E):
    inst, msgs = _messages(iname, E)
    return sponge_hash_batch_fn(inst, E, device="cpu")(_encode_messages(inst, msgs))


@pytest.mark.parametrize("iname,E", [("anemoi_4_3", E) for E in range(5)] + [("anemoi_2_1", 0), ("anemoi_2_1", 2)])
def test_plain_sponge_matches_golden(iname, E):
    inst, msgs = _messages(iname, E)
    ref = jparams.get_instance("vesta", iname)
    got = _plain_digests(iname, E)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 20, 4)
    assert decode_states(inst, got) == [jgolden.hash_field(ref, m) for m in msgs]
    if E == 0:
        assert not got.any()


def test_plain_sponge_matches_jax_jit():
    inst, msgs = _messages("anemoi_4_3", 4)
    x = _encode_messages(inst, msgs).numpy()
    want = jax.jit(jbm.sponge_hash_batch_fn(jparams.get_instance("vesta", "anemoi_4_3"), 4, backend="jit"))(x)
    np.testing.assert_array_equal(_plain_digests("anemoi_4_3", 4).numpy(), np.asarray(want))


@pytest.mark.parametrize("E,kernel", [(0, None), (1, "permutation"), (2, "permutation"), (3, "sponge"), (4, "sponge")])
def test_sponge_dispatch(monkeypatch, E, kernel):
    """The JAX package's dispatch: E >= rate is one sponge call, 0 < E < rate
    one permutation of the state (elements, then sigma, in the rate), E = 0
    no call."""
    calls = []
    monkeypatch.setattr(cuda_backend, "permutation", lambda inst, x: calls.append(("permutation", x)) or x)
    monkeypatch.setattr(cuda_backend, "sponge", lambda inst, n, x: calls.append(("sponge", x)) or x[:20])
    inst, msgs = _messages("anemoi_4_3", E, B=2)
    x = _encode_messages(inst, msgs)
    sponge_hash_batch_fn(inst, E, device="cpu")(x)
    assert [name for name, _ in calls] == ([kernel] if kernel else [])
    if kernel == "permutation":
        state = calls[0][1].reshape(4, 20, 2)
        one = encode_states(inst, [[1], [1]], device="cpu")[0]
        torch.testing.assert_close(state[:E], x, rtol=0, atol=0)
        torch.testing.assert_close(state[E], one, rtol=0, atol=0)
        assert not state[E + 1:].any()


@pytest.mark.parametrize("iname", ["anemoi_2_1", "anemoi_4_3"])
def test_plain_permutation_and_merge_match_golden(iname):
    inst = get_instance("vesta", iname)
    W = inst.width
    rng = np.random.default_rng(43)
    states = [[0] * W, _ints(inst, W, rng)]
    x = encode_states(inst, states, device="cpu")
    got = cuda_backend.permutation(inst, x.reshape(W * 20, 2)).reshape(W, 20, 2)
    assert decode_states(inst, got) == [golden.permutation(inst, s) for s in states]
    d0, d1 = x[:1], x[1:2]
    merged = merge_batch_fn(inst, device="cpu")(d0, d1)
    want = [golden.merge(inst, [s[0]], [s[1]]) for s in states]
    assert decode_states(inst, merged) == want


def test_wrappers_reject_bad_input():
    inst = get_instance("vesta", "anemoi_4_3")
    good = torch.zeros(80, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_backend.permutation(inst, good.long())
    with pytest.raises(ValueError):
        cuda_backend.permutation(inst, good[:60])
    with pytest.raises(ValueError, match="E >= rate"):
        cuda_backend.sponge(inst, 2, good[:40])
    with pytest.raises(ValueError):
        cuda_backend.sponge(inst, 4, good[:60])
    with pytest.raises(ValueError):
        sponge_hash_batch_fn(inst, 4, device="cpu")(good)  # needs [E, L, B]
    with pytest.raises(ValueError):
        merge_batch_fn(inst, device="cpu")(good[:20], good[:20])  # needs [DIGEST, L, B]
    assert cuda_backend.permutation(inst, good[:, :0]).shape == (80, 0)
    assert cuda_backend.sponge(inst, 4, good[:, :0]).shape == (20, 0)


class _FakeCudaTensor(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensors_go_to_the_kernels_or_raise(monkeypatch):
    """The wrappers never fall back to the plain path for a CUDA tensor:
    with no library to load, as here, they raise.  A 30-limb field asks for
    the 12-word library, a 20-limb one for the 8-word library."""
    monkeypatch.setattr(cuda_backend, "permutation_plain", lambda *a: pytest.fail("plain path taken"))
    monkeypatch.setattr(cuda_backend, "sponge_plain", lambda *a: pytest.fail("plain path taken"))
    asked = []

    def no_library(words):
        asked.append(words)
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(cuda_backend, "sponge_library", no_library)
    inst = get_instance("vesta", "anemoi_4_3")
    fake = lambda rows: torch.zeros(rows, 2, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    with pytest.raises(RuntimeError, match="no kernel library"):
        cuda_backend.permutation(inst, fake(80))
    with pytest.raises(RuntimeError, match="no kernel library"):
        cuda_backend.sponge(inst, 4, fake(80))
    wide = get_instance("bls12_381", "anemoi_4_3")
    with pytest.raises(RuntimeError, match="no kernel library"):
        cuda_backend.permutation(wide, fake(120))
    with pytest.raises(RuntimeError, match="no kernel library"):
        cuda_backend.sponge(wide, 3, fake(90))
    assert asked == [8, 8, 12, 12]


def test_permutation_counts_the_kernel_it_launches(monkeypatch):
    """A CUDA tensor goes to the library's one launcher: ``permutation`` lets
    it pick the kernel by N, ``permutation_with`` names the kernel.
    ``permutation`` counts one launch a call in ``launch_counts()``, and
    in its "four_lane" those that the launcher reports it sent to the
    four-lane kernel; ``permutation_with`` counts nothing."""
    launched = []

    def launcher(lib, name, x, out, width, kernel, consts, picked):
        # as anemoi_permute, with a crossover of 3 states
        picked.contents.value = int(x.shape[1] <= 3) if kernel < 0 else kernel
        launched.append((name, x.shape[1], kernel))

    monkeypatch.setattr(cuda_backend, "sponge_library", lambda words: type("Built", (), {"cdll": None})())
    monkeypatch.setattr(cuda_backend, "_launch", launcher)
    # the fake launches count in a table of their own, not in the process's
    monkeypatch.setattr(cuda_backend, "_launches", dict.fromkeys(cuda_backend._launches, 0))
    before = cuda_backend.launch_counts()
    inst = get_instance("vesta", "anemoi_4_3")
    fake = lambda n: torch.zeros(80, n, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    for n in (1, 3, 4, 0):
        cuda_backend.permutation(inst, fake(n))
    for group in (True, False):
        cuda_backend.permutation_with(inst, fake(5), group)
    assert launched == [("anemoi_permute", 1, -1), ("anemoi_permute", 3, -1), ("anemoi_permute", 4, -1),
                        ("anemoi_permute", 5, 1), ("anemoi_permute", 5, 0)]
    after = cuda_backend.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "permutation": 3, "four_lane": 2}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from anemoi_tpu_torch.ff.limb_ops import random_canonical

    rng = np.random.default_rng(44)
    cases = [("anemoi_2_1", 2), ("anemoi_4_3", 3), ("anemoi_4_3", 4)]
    for field, (iname, E) in [(f, c) for f in ("vesta", "bls12_377") for c in cases]:
        inst = get_instance(field, iname)
        W, L = inst.width, inst.field.n_limbs
        x = torch.from_numpy(random_canonical(inst.field, (W, 131), rng).transpose(1, 0, 2).copy())
        x = x.reshape(W * L, 131).cuda()
        plain = cuda_backend.permutation_plain(inst, x).cpu().numpy()
        np.testing.assert_array_equal(cuda_backend.permutation(inst, x).cpu().numpy(), plain)
        for group in (True, False):
            np.testing.assert_array_equal(cuda_backend.permutation_with(inst, x, group).cpu().numpy(), plain)
        m = torch.from_numpy(random_canonical(inst.field, (E, 131), rng).transpose(1, 0, 2).copy())
        m = m.reshape(E * L, 131).cuda()
        np.testing.assert_array_equal(cuda_backend.sponge(inst, E, m).cpu().numpy(),
                                      cuda_backend.sponge_plain(inst, E, m).cpu().numpy())
