"""The JAX package's keyword arguments through the port's entry points, on
the CPU.

Tolerance: exact.  Every call the port used to reject with a TypeError
(``backend``, ``chunk_b``, ``block_b``, ``mul_impl``, ``ladder``,
``unroll``) now runs on the plain path and returns the reference's
outputs, which are its golden model's (``anemoi_tpu.ff.golden``): names
change no output.  A ``mul_impl`` or ``ladder`` name that the JAX package
rejects (``anemoi_tpu.ff.limb_ops.field_consts``) raises ValueError in
the port's ``MerkleTree`` too, and in ``cuda_backend``'s ``jive``,
``permutation`` and ``sponge``, which route an "mxu" name on the card to
the tensor-core kernels; the verifier hands its ``--mul-impl`` to the
permutation and the sponge as ``verify_tpu.py`` does.
"""

import functools

import numpy as np
import pytest
import torch

import anemoi_tpu_torch as att
from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.ff import limb_ops as jlo
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch import bench
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.merkle.tree import MerkleTree
from anemoi_tpu_torch.modes import batched as bm
from anemoi_tpu_torch.modes.bytes_pipeline import hash_bytes_batch
from anemoi_tpu_torch.modes.streaming import BatchedSponge
from anemoi_tpu_torch.permutation.batched import permutation_fn
from anemoi_tpu_torch.tools import verify_cuda

from .test_torch_bench import oracle_plain  # noqa: F401  (a fixture)
from .test_torch_sponge import _FakeCudaTensor


def _ref(field, iname):
    return jparams.get_instance(field, iname)


def _states(inst, n, seed):
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, 2**62)) for _ in range(inst.width)] for _ in range(n)]


@pytest.mark.parametrize("backend", ["jit", "pallas", "cuda", "xla"])
def test_batch_hash_bytes_backend(backend):
    """att.vesta.anemoi_4_3.batch.hash_bytes([b"abc", b""], backend=...):
    "pallas" names the TPU kernel, "jit" the XLA graph, "cuda" the port's
    kernels, and the reference hashes any other name as "jit"."""
    obj = att.vesta.anemoi_4_3
    msgs = [b"abc", b""]
    got = obj.batch.decode_states(obj.batch.hash_bytes(msgs, backend=backend, device="cpu"))
    assert got == [jgolden.hash_bytes(_ref("vesta", "anemoi_4_3"), m) for m in msgs]


def test_hash_bytes_batch_and_sponge_fn_backend():
    inst = get_instance("vesta", "anemoi_2_1")
    ref = _ref("vesta", "anemoi_2_1")
    msgs = [b"x" * 20, b"y" * 20]  # one element each
    got = bm.decode_states(inst, hash_bytes_batch(inst, msgs, backend="pallas", device="cpu"))
    assert got == [jgolden.hash_bytes(ref, m) for m in msgs]
    elems = [[5], [7]]  # two messages of one element: [E=1, L, B=2]
    fn = bm.sponge_hash_batch_fn(inst, 1, backend="pallas", block_b=256, device="cpu")
    got = bm.decode_states(inst, fn(bm.encode_states(inst, elems, device="cpu")))
    assert got == [jgolden.hash_field(ref, e) for e in elems]


def test_batched_sponge_backend():
    inst = get_instance("vesta", "anemoi_2_1")
    elems = [[11], [13]]
    sponge = BatchedSponge(inst, 2, backend="jit", block_b=64, device="cpu")
    sponge.absorb(bm.encode_states(inst, elems, device="cpu"))
    got = bm.decode_states(inst, sponge.finalize())
    assert got == [jgolden.hash_field(_ref("vesta", "anemoi_2_1"), e) for e in elems]


def test_merkle_tree_keywords():
    """MerkleTree(inst, backend=, chunk_b=, mul_impl=, ladder=) on a
    2-leaf tree, and the names the reference rejects."""
    inst = get_instance("vesta", "anemoi_2_1")
    leaves = [3, 4]
    tree = MerkleTree(inst, backend="jit", chunk_b=8, mul_impl="cios2", ladder="sw4", device="cpu")
    got = lo.decode_ints(tree.root(lo.encode_ints(leaves, inst.field)), inst.field)
    assert got == jgolden.jive_compress_k(_ref("vesta", "anemoi_2_1"), leaves, 2)
    for kw in ({"mul_impl": "mxu"}, {"mul_impl": "cios7"}, {"ladder": "chainseg"}, {"ladder": "chainseg12"},
               {"ladder": "chain3", "mul_impl": "parallel"}):
        MerkleTree(inst, backend="pallas", device="cpu", **kw)
        jlo.field_consts(jparams.get_field("vesta"), kw.get("mul_impl", "cios"), kw.get("ladder", "fixed4"))


@pytest.mark.parametrize("kw", [{"mul_impl": "karatsuba"}, {"mul_impl": "ciosx"}, {"ladder": "fixed8"},
                                {"ladder": "chainseg0"}, {"ladder": "chainsegx"}])
def test_rejected_tuning_names(kw):
    inst = get_instance("vesta", "anemoi_2_1")
    with pytest.raises(ValueError):
        MerkleTree(inst, backend="pallas", device="cpu", **kw)
    with pytest.raises(ValueError):
        jlo.field_consts(jparams.get_field("vesta"), kw.get("mul_impl", "cios"), kw.get("ladder", "fixed4"))


def test_unroll():
    """jive_compress_batch_fn(inst, 2, unroll=False), merge_batch_fn(inst,
    unroll=True) and permutation_fn(inst, unroll=True)."""
    two, four = get_instance("vesta", "anemoi_2_1"), get_instance("vesta", "anemoi_4_3")
    ref2, ref4 = _ref("vesta", "anemoi_2_1"), _ref("vesta", "anemoi_4_3")
    states = _states(two, 2, 1)
    got = bm.decode_states(two, bm.jive_compress_batch_fn(two, 2, unroll=False, device="cpu")(
        bm.encode_states(two, states, device="cpu")))
    assert got == [jgolden.jive_compress_k(ref2, s, 2) for s in states]
    d0, d1 = [[1], [2]], [[3], [4]]
    enc = lambda ds: bm.encode_states(four, ds, device="cpu")
    got = bm.decode_states(four, bm.merge_batch_fn(four, unroll=True, device="cpu")(enc(d0), enc(d1)))
    assert got == [jgolden.merge(ref4, a, b) for a, b in zip(d0, d1)]
    states = _states(four, 2, 2)
    got = bm.decode_states(four, permutation_fn(four, unroll=True)(enc(states)))
    assert got == [jgolden.permutation(ref4, s) for s in states]


def test_merkle_tree_mxu_gives_the_default_root():
    """MerkleTree(mul_impl="mxuf") on the CPU: the default tree's root and
    the golden model's."""
    inst = get_instance("vesta", "anemoi_2_1")
    leaves = lo.encode_ints([5, 6], inst.field)
    got = MerkleTree(inst, mul_impl="mxuf", device="cpu").root(leaves)
    assert got.equal(MerkleTree(inst, device="cpu").root(leaves))
    assert lo.decode_ints(got, inst.field) == jgolden.jive_compress_k(_ref("vesta", "anemoi_2_1"), [5, 6], 2)


def test_bench_and_verifier_mxu_give_the_default_outputs(oracle_plain, capsys):  # noqa: F811
    """bench --impl mxuf and verify_cuda --mul-impl mxu on the CPU: the
    default's checksum and parity, and ALL PASS."""
    runs = [bench.bench_jive(n=16, reps=1, device="cpu", mul_impl=impl) for impl in (None, "mxuf")]
    assert runs[0]["checksum"] == runs[1]["checksum"] and runs[1]["parity"] == "ok"
    assert bench.main(["--device", "cpu", "--n", "16", "--reps", "1", "--headline-only", "--impl", "mxuf"]) == 0
    capsys.readouterr()
    assert verify_cuda.main(["--device", "cpu", "--fields", "vesta", "--mul-impl", "mxu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].endswith("ALL PASS") and '"jive_mma": 0' in lines[-2]


def test_rejected_mul_impl_in_the_jive_entry_points():
    inst = get_instance("vesta", "anemoi_2_1")
    for bad in ("mxq", "karatsuba"):
        with pytest.raises(ValueError):
            bm.jive_compress_batch_fn(inst, 2, device="cpu", mul_impl=bad)
        with pytest.raises(ValueError):
            MerkleTree(inst, mul_impl=bad, device="cpu")
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--impl", "mxq"])
    with pytest.raises(SystemExit):
        verify_cuda.main(["--device", "cpu", "--mul-impl", "mxq"])


def test_cuda_tensors_with_mxu_go_to_the_tensor_core_kernel(monkeypatch):
    """A CUDA tensor with an "mxu" name asks for jive_mma.cu's library of its
    word count, any other name for jive.cu's; neither falls back to the
    plain path (here, with no library to load, both raise)."""
    monkeypatch.setattr(cuda_backend, "jive_plain", lambda *a: pytest.fail("plain path taken"))
    asked = []

    def no_library(source):
        def load(words):
            asked.append((source, words))
            raise RuntimeError("no kernel library here")
        return load

    monkeypatch.setattr(cuda_backend, "library", no_library("jive.cu"))
    monkeypatch.setattr(cuda_backend, "mma_library", no_library("jive_mma.cu"))
    fake = lambda rows: torch.zeros(rows, 2, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    for inst, impl in [(get_instance("vesta", "anemoi_2_1"), "mxuf"), (get_instance("vesta", "anemoi_2_1"), None),
                       (get_instance("bls12_381", "anemoi_2_1"), "mxu"), (get_instance("vesta", "anemoi_4_3"), "cios2")]:
        with pytest.raises(RuntimeError, match="no kernel library"):
            cuda_backend.jive(inst, 2, fake(inst.width * inst.field.n_limbs), impl)
    assert asked == [("jive_mma.cu", 8), ("jive.cu", 8), ("jive_mma.cu", 12), ("jive.cu", 8)]


@pytest.mark.parametrize("mul_impl", [None, *lo.MUL_IMPLS, "cios7"])
def test_permutation_and_sponge_take_every_mul_impl(mul_impl, oracle_plain):  # noqa: F811
    """cuda_backend.permutation and sponge take every name the JAX package
    takes; on the CPU each goes to the plain version (here the native
    oracle) and gives the golden model's outputs."""
    inst = get_instance("vesta", "anemoi_4_3")
    ref = _ref("vesta", "anemoi_4_3")
    states = _states(inst, 3, 17)
    x = bm.encode_states(inst, states, device="cpu").reshape(inst.width * inst.field.n_limbs, 3)
    got = bm.decode_states(inst, cuda_backend.permutation(inst, x, mul_impl).reshape(inst.width, -1, 3))
    assert got == [jgolden.permutation(ref, s) for s in states]
    msgs = _states(inst, 2, 18)  # four elements each: a block and a tail
    m = bm.encode_states(inst, msgs, device="cpu").reshape(inst.width * inst.field.n_limbs, 2)
    digests = lo.decode_ints(cuda_backend.sponge(inst, inst.width, m, mul_impl), inst.field)
    assert digests == [jgolden.hash_field(ref, msg)[0] for msg in msgs]


def test_rejected_mul_impl_in_permutation_and_sponge():
    inst = get_instance("vesta", "anemoi_4_3")
    x = torch.zeros(inst.width * inst.field.n_limbs, 1, dtype=torch.int32)
    for bad in ("mxq", "karatsuba"):
        with pytest.raises(ValueError):
            cuda_backend.permutation(inst, x, bad)
        with pytest.raises(ValueError):
            cuda_backend.sponge(inst, inst.width, x, bad)


def test_cuda_tensors_with_mxu_go_to_the_tensor_core_permutation_and_sponge(monkeypatch):
    """A CUDA tensor with an "mxu" name asks for sponge_mma.cu's library of
    its word count, any other name for sponge.cu's; neither falls back to
    the plain path (here, with no library to load, both raise)."""
    for plain in ("permutation_plain", "sponge_plain"):
        monkeypatch.setattr(cuda_backend, plain, lambda *a: pytest.fail("plain path taken"))
    asked = []

    def no_library(source):
        def load(words):
            asked.append((source, words))
            raise RuntimeError("no kernel library here")
        return load

    monkeypatch.setattr(cuda_backend, "sponge_library", no_library("sponge.cu"))
    monkeypatch.setattr(cuda_backend, "sponge_mma_library", no_library("sponge_mma.cu"))
    fake = lambda rows: torch.zeros(rows, 2, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    for inst, impl in [(get_instance("vesta", "anemoi_4_3"), "mxuf"), (get_instance("vesta", "anemoi_4_3"), None),
                       (get_instance("bls12_381", "anemoi_2_1"), "mxu3"), (get_instance("vesta", "anemoi_2_1"), "cios")]:
        rows = inst.width * inst.field.n_limbs
        with pytest.raises(RuntimeError, match="no kernel library"):
            cuda_backend.permutation(inst, fake(rows), impl)
        with pytest.raises(RuntimeError, match="no kernel library"):
            cuda_backend.sponge(inst, inst.width, fake(rows), impl)
    assert asked == [("sponge_mma.cu", 8)] * 2 + [("sponge.cu", 8)] * 2 + [("sponge_mma.cu", 12)] * 2 + [
        ("sponge.cu", 8)] * 2


@pytest.mark.parametrize("mul_impl", ["mxuf", "cios2"])
def test_verifier_passes_mul_impl_to_permutation_and_sponge(mul_impl, oracle_plain, monkeypatch, capsys):  # noqa: F811
    """verify_cuda --mul-impl hands its name to every permutation and sponge
    call, as verify_tpu.py runs permutation_pallas and sponge_pallas under
    it."""
    calls = []

    def recording(name):
        real = getattr(cuda_backend, name)

        @functools.wraps(real)
        def call(*args):
            calls.append((name, args[-1]))
            return real(*args)
        return call

    for name in ("permutation", "sponge"):
        monkeypatch.setattr(cuda_backend, name, recording(name))
    assert verify_cuda.main(["--device", "cpu", "--fields", "vesta", "--mul-impl", mul_impl]) == 0
    assert capsys.readouterr().out.strip().endswith("ALL PASS")
    assert sorted(set(calls)) == [("permutation", mul_impl), ("sponge", mul_impl)]
    assert len(calls) == 3  # the permutation of 2_1 and 4_3, the sponge
