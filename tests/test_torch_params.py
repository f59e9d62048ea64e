"""The port's parameters and plain limb arithmetic against the JAX package,
and the port's independence from it.

Tolerance: exact.  The port's registry, the tables carried over from the
reference's arrays, the 32-bit-word constants of the CUDA kernel, and the
plain PyTorch limb operations on canonical inputs give the same integers
as the JAX package and as Python ints.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import limb_ops as jlo
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.permutation.batched import round_constant_limbs as j_round_constant_limbs
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch.fields import params
from anemoi_tpu_torch.fields.carry import derive_tables, from_reference_arrays

ALL = [(i.field.name, i.name) for i in params.all_instances()]
ROOT = Path(__file__).resolve().parent.parent


def test_registry_matches_reference():
    assert len(ALL) == 14
    for field, iname in ALL:
        mine, ref = params.get_instance(field, iname), jparams.get_instance(field, iname)
        for attr in ("p", "bits", "alpha", "beta", "delta", "inv_alpha", "n_limbs", "R", "R2"):
            assert getattr(mine.field, attr) == getattr(ref.field, attr), (field, attr)
        for attr in ("width", "rate", "columns", "digest_size", "rounds", "C", "D"):
            assert getattr(mine, attr) == getattr(ref, attr), (field, iname, attr)
    with pytest.raises(ValueError):
        params.get_instance("vesta", "anemoi_8_7")


@pytest.mark.parametrize("field,iname", ALL)
def test_carried_tables_equal_own_derivation(field, iname):
    inst = params.get_instance(field, iname)
    ref_inst = jparams.get_instance(field, iname)
    fc = jlo.field_consts(ref_inst.field)
    C, D = j_round_constant_limbs(ref_inst)
    carried = from_reference_arrays(
        inst, C=C, D=D, p=fc.p_limbs, one_mont=fc.one_mont, r2=fc.r2_limbs,
        beta_mont=fc.beta_mont, delta_mont=fc.delta_mont,
    )
    own = derive_tables(inst).arrays()
    got = carried.arrays()
    assert got.keys() == own.keys()
    assert "kernel.p" in own  # every field has the kernels' word tables
    for key in own:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(own[key]), err_msg=key)


@pytest.mark.parametrize("field", params.FIELD_NAMES)
def test_kernel_word_constants(field):
    """8 words and R' = 2^256 for the 20-limb fields (R = 2^260), 12 words
    and R' = 2^384 for the 30-limb ones (R = 2^390)."""
    fp = params.get_field(field)
    nw, rb = (8, 256) if fp.n_limbs == 20 else (12, 384)
    assert (fp.kernel_words, fp.kernel_r_bits) == (nw, rb)
    inst = params.get_instance(field, "anemoi_2_1")
    kc = params.kernel_consts(inst)
    assert kc.p.shape == (nw,) and kc.C.shape == (inst.rounds, 1, nw)
    words = lambda a: sum(int(w) << (32 * i) for i, w in enumerate(np.asarray(a)))
    p = words(kc.p)
    assert p == fp.p and kc.p.dtype == np.uint32
    assert p * kc.n0 % 2**32 == 2**32 - 1  # p * (-p^-1) = -1 mod 2^32
    assert words(kc.r2) == pow(2, 2 * rb, fp.p)
    rl = 13 * fp.n_limbs
    assert words(kc.c_in) == pow(2, 2 * rb - rl, fp.p)
    assert words(kc.c_out) == pow(2, rl, fp.p)
    # a Montgomery product by c_in / c_out moves between R = 2^(13L) and R'
    a = 12345678901234567890123456789 % fp.p
    rinv = pow(2, -rb, fp.p)
    assert (a << rl) % fp.p * words(kc.c_in) * rinv % fp.p == (a << rb) % fp.p
    assert (a << rb) % fp.p * words(kc.c_out) * rinv % fp.p == (a << rl) % fp.p
    assert words(kc.beta) == (fp.beta << rb) % fp.p
    assert words(kc.delta) == (fp.delta << rb) % fp.p
    assert words(kc.inv_alpha) == fp.inv_alpha and kc.inv_alpha_bits == fp.inv_alpha.bit_length()


def _values(fp, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % fp.p for _ in range(n)]
    vals[:4] = [0, 1, fp.p - 1, fp.p // 2]
    return vals


@pytest.mark.parametrize("field", ["vesta", "ed_on_bls12_377"])
def test_limb_ops_match_jax(field):
    import jax

    fp, jfp = params.get_field(field), jparams.get_field(field)
    fc, jfc = lo.field_consts(fp), jlo.field_consts(jfp)
    a, b = _values(fp, 8, 1), _values(fp, 8, 2)[::-1]
    A, B = lo.encode_ints(a, fp), lo.encode_ints(b, fp)
    JA, JB = jlo.encode_ints(a, jfp), jlo.encode_ints(b, jfp)
    np.testing.assert_array_equal(A.numpy(), JA)
    for mine, ref in [(lo.mont_mul, jlo.mont_mul), (lo.add_mod, jlo.add_mod), (lo.sub_mod, jlo.sub_mod)]:
        got = mine(A, B, fc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref(JA, JB, jfc)), err_msg=mine.__name__)
    np.testing.assert_array_equal(lo.mont_sqr(A, fc).numpy(), np.asarray(jlo.mont_sqr(JA, jfc)))
    # the batch shape of tests/test_limb_ops.py's jitted ladder (4 lanes)
    exp = jax.jit(lambda x: jlo.exp_inv_alpha(x, jfc))
    np.testing.assert_array_equal(lo.exp_inv_alpha(A[:, :4], fc).numpy(), np.asarray(exp(JA[:, :4])))
    assert lo.decode_ints(lo.exp_inv_alpha(A[:, :4], fc), fp) == [pow(x, fp.inv_alpha, fp.p) for x in a[:4]]


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_canonicalize_matches_jax(field):
    fp, jfp = params.get_field(field), jparams.get_field(field)
    vals = _values(fp, 8, 3)
    L = fp.n_limbs
    # the same residues as v, v + p and v + 2p: values below 3p, as the
    # lazy domain of the reference's kernels leaves them
    lazy = np.stack([params.limbs_from_int(v + j * fp.p, L) for j in range(3) for v in vals], axis=1)
    got = lo.canonicalize(torch.from_numpy(lazy), lo.field_consts(fp)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlo.canonicalize(lazy, jlo.field_consts(jfp))))
    assert lo.decode_ints(got, fp, mont=False) == vals * 3


def test_random_canonical_is_canonical():
    for field in params.FIELD_NAMES:
        fp = params.get_field(field)
        arr = lo.random_canonical(fp, (3, 50), np.random.default_rng(5))
        assert arr.shape == (fp.n_limbs, 3, 50) and arr.dtype == np.int32
        flat = arr.reshape(fp.n_limbs, -1)
        assert all(params.int_from_limbs(flat[:, i]) < fp.p for i in range(flat.shape[1]))


def test_import_without_jax():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import anemoi_tpu_torch as att
        inst = att.get_instance("vesta", "anemoi_2_1")
        x = att.encode_states(inst, [[1, 1]], device="cpu")
        out = att.decode_states(inst, att.jive_compress_batch_fn(inst, device="cpu")(x))
        assert out == [[1799222279508491238955156019299185816766170120519060796492407909371488003482]], out  # SAGE
        bad = [m for m in sys.modules if m == "anemoi_tpu" or m.startswith("anemoi_tpu.")]
        assert not bad, bad
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
