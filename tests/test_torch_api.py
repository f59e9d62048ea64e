"""The port's public instance API against the JAX package's, on the CPU, and
the port's independence from JAX.

Tolerance: exact.  The scalar API of all 14 instances is held against
``anemoi_tpu``'s (both are golden models over Python ints); the ``.batch``
namespace runs the kernels' plain versions on CPU tensors and is held
against the scalar API.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import anemoi_tpu as at
import anemoi_tpu_torch as att
from anemoi_tpu_torch.ff import cuda_backend

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ["bls12_377", "bls12_381", "bn_254", "ed_on_bls12_377", "jubjub", "pallas_field", "vesta"]


def _pairs():
    for f in FIELDS:
        for i in ("anemoi_2_1", "anemoi_4_3"):
            yield getattr(getattr(att, f), i), getattr(getattr(at, f), i)


def test_registry():
    pairs = list(_pairs())
    assert len(pairs) == 14 == len(att.all_instance_objects())
    assert att.instance("vesta", "anemoi_2_1") is att.vesta.anemoi_2_1
    assert att.pallas_field.anemoi_4_3.params.field.name == "pallas"
    for mine, ref in pairs:
        assert isinstance(mine, att.AnemoiInstance)
        for attr in ("STATE_WIDTH", "RATE_WIDTH", "NUM_COLUMNS", "DIGEST_SIZE", "NUM_HASH_ROUNDS"):
            assert getattr(mine, attr) == getattr(ref, attr)


@pytest.mark.parametrize("field", FIELDS)
def test_scalar_api_matches_jax(field):
    for iname in ("anemoi_2_1", "anemoi_4_3"):
        mine, ref = getattr(getattr(att, field), iname), getattr(getattr(at, field), iname)
        p = mine.params.field.p
        rng = np.random.default_rng(61)
        state = [int.from_bytes(rng.bytes(56), "little") % p for _ in range(mine.STATE_WIDTH)]
        for name in ("permutation", "mds_layer", "sbox_layer", "compress"):
            assert getattr(mine, name)(state) == getattr(ref, name)(state), name
        assert mine.round(state, 2) == ref.round(state, 2)
        assert mine.ark_layer(state, 3) == ref.ark_layer(state, 3)
        for k in (2, 4)[: mine.STATE_WIDTH // 2]:
            assert mine.compress_k(state, k) == ref.compress_k(state, k)
        data = rng.bytes(77)
        d0, d1 = mine.hash(data), mine.hash_field(state)
        assert d0.to_elements() == ref.hash(data).to_elements()
        assert d1.as_elements() == ref.hash_field(state).as_elements()
        assert d0.to_bytes() == ref.hash(data).to_bytes()
        assert mine.merge(d0, d1).to_elements() == ref.merge(ref.hash(data), ref.hash_field(state)).to_elements()
        assert (mine.merge_reference_quirk(d0, d1).to_elements()
                == ref.merge_reference_quirk(ref.hash(data), ref.hash_field(state)).to_elements())


def test_digest():
    inst = att.vesta.anemoi_4_3
    d = att.Digest.new([inst.params.field.p + 5], inst)
    assert d.to_elements() == [5] and list(d) == [5] and d.as_elements() == (5,)
    assert att.Digest.digests_to_elements([d, att.Digest.default(inst)]) == [5, 0]
    assert att.Digest.default(inst).to_bytes() == bytes(32)
    with pytest.raises(ValueError):
        att.Digest.new([1, 2], inst)
    assert att.vesta.anemoi_2_1.hash(b"hello world").to_bytes().hex() == (
        "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d")


def test_batch_namespace_on_cpu():
    """Every .batch entry point on CPU tensors (the plain path) against the
    scalar API."""
    inst = att.vesta.anemoi_4_3
    b = inst.batch
    p = inst.params.field.p
    rng = np.random.default_rng(62)
    states = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(4)] for _ in range(2)]
    x = b.encode_states(states, device="cpu")
    assert x.device.type == "cpu" and tuple(x.shape) == (4, 20, 2)
    assert b.decode_states(x) == states
    assert b.decode_states(b.permutation(x)) == [inst.permutation(s) for s in states]
    assert b.decode_states(b.compress_k(x, 4)) == [inst.compress_k(s, 4) for s in states]
    assert b.decode_states(b.merge(x[:1], x[1:2])) == [inst.merge([s[0]], [s[1]]).to_elements() for s in states]
    assert b.decode_states(b.hash_field(x[:3])) == [inst.hash_field(s[:3]).to_elements() for s in states]
    msgs = [b"", b"abc"]
    assert b.decode_states(b.hash_bytes(msgs, device="cpu")) == [inst.hash(m).to_elements() for m in msgs]
    two = att.vesta.anemoi_2_1
    y = two.batch.encode_states([s[:2] for s in states], device="cpu")
    assert two.batch.decode_states(two.batch.compress(y)) == [two.compress(s[:2]) for s in states]


class _FakeCudaTensor(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("field", ["bls12_377", "bls12_381"])
def test_batch_raises_for_30_limb_fields_on_card(monkeypatch, field):
    """.batch on the card takes the 30-limb fields to the 12-word kernel
    libraries and never to the plain path; with no library to load, as
    here, the call raises instead of degrading."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("jive_plain", "permutation_plain", "sponge_plain"):
        monkeypatch.setattr(cuda_backend, name, lambda *a: pytest.fail("plain path taken"))
    asked = []

    def no_library(words):
        asked.append(words)
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(cuda_backend, "library", no_library)
    monkeypatch.setattr(cuda_backend, "sponge_library", no_library)
    b = getattr(att, field).anemoi_4_3.batch
    states = torch.zeros(4, 30, 2, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    with pytest.raises(RuntimeError, match="no kernel library"):
        b.permutation(states)
    with pytest.raises(RuntimeError, match="no kernel library"):
        b.compress(states)
    with pytest.raises(RuntimeError, match="no kernel library"):
        b.hash_field(states)
    assert asked == [12, 12, 12]


def test_import_leaves_out_jax():
    """Importing every module of the port leaves jax and anemoi_tpu out of
    sys.modules."""
    code = textwrap.dedent(
        """
        import pkgutil, sys
        import anemoi_tpu_torch as att
        for m in pkgutil.walk_packages(att.__path__, "anemoi_tpu_torch."):
            __import__(m.name)
        assert att.vesta.anemoi_2_1.hash(b"hello world").to_bytes().hex().startswith("25e16af3")
        att.vesta.anemoi_2_1.batch
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "anemoi_tpu")]
        assert not bad, bad
        new = ["cli", "dist.forest", "dist.mesh", "ff.native", "modes.async_pipeline", "utils.debug",
               "utils.profiling", "bench", "graft_entry", "dist.ranks", "tools.verify_cuda", "tools.multihost_demo"]
        assert all("anemoi_tpu_torch." + m in sys.modules for m in new)
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
