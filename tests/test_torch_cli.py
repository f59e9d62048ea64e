"""The port's CLI against the golden model, on the CPU (``--device cpu``).

Tolerance: exact.  tests/test_cli.py's inputs: ``hash`` over files of 10
and 100 bytes (two length buckets) against the JAX package's golden model
and ``--backend golden``, and ``merkle`` over 300 bytes (10 elements
padded to 16 leaves) against a golden reduction; the "hello world" digest;
``vectors`` and ``info``.  Without a card, every command exits non-zero
unless ``--device cpu`` is given.
"""

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.ff import native as jnative
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch import cli

HELLO_WORLD = "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d"  # Vesta 2_1


def _run(capsys, argv):
    rc = cli.main(argv)
    captured = capsys.readouterr()
    return rc, captured.out.strip().splitlines(), captured.err


def _files(tmp_path, sizes, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, n in enumerate(sizes):
        f = tmp_path / f"m{i}.bin"
        f.write_bytes(bytes(rng.integers(0, 256, size=n, dtype=np.uint8).tolist()))
        paths.append(str(f))
    return paths


def test_cli_hash_mixed_files_matches_golden(tmp_path, capsys):
    files = _files(tmp_path, [10, 100], 0)
    hello = tmp_path / "hello.bin"
    hello.write_bytes(b"hello world")
    files.append(str(hello))
    inst = jparams.get_instance("vesta", "anemoi_2_1")
    want = [jgolden.digest_to_bytes(inst, jgolden.hash_bytes(inst, open(f, "rb").read())).hex() for f in files]
    assert want[-1] == HELLO_WORLD
    rc, out, err = _run(capsys, ["hash", "--device", "cpu", "--field", "vesta", "--instance", "anemoi_2_1",
                                 "--backend", "jit", "--stats", *files])
    assert rc == 0 and out == want
    assert "launches: jive 0, permutation 0 (four-lane 0), sponge 0" in err  # no kernel on the CPU
    rc, out, _ = _run(capsys, ["hash", "--device", "cpu", "--backend", "golden", *files])
    assert rc == 0 and out == want


def test_cli_merkle_matches_golden_reduction(tmp_path, capsys):
    (f,) = _files(tmp_path, [300], 1)
    rc, out, _ = _run(capsys, ["merkle", "--device", "cpu", "--backend", "auto", f])
    inst = jparams.get_instance("vesta", "anemoi_2_1")
    fp = inst.field
    packed = jnative.pack_bytes(open(f, "rb").read(), fp)
    level = [jparams.int_from_limbs(packed[i]) % fp.p for i in range(packed.shape[0])]
    level += [0] * (16 - len(level))
    while len(level) > 1:
        level = [jgolden.jive_compress_k(inst, level[i : i + 2], 2)[0] for i in range(0, len(level), 2)]
    assert rc == 0 and out == [jgolden.digest_to_bytes(inst, [level[0]]).hex()]


def test_merkle_leaves_pad_with_zero_columns():
    """merkle packs to canonical limbs and pads with zero columns to a power
    of the arity, at least the arity: 0 or 1 element -> 2 leaves, 5 -> 8;
    4_3, 5 -> 16."""
    from anemoi_tpu_torch.fields.params import get_instance

    two, four = get_instance("vesta", "anemoi_2_1"), get_instance("vesta", "anemoi_4_3")
    for inst, n_bytes, n_leaves in ((two, 0, 2), (two, 1, 2), (two, 31 * 5, 8), (four, 31 * 5, 16)):
        leaves = cli.merkle_leaves(inst, b"\x01" * n_bytes, torch.device("cpu"))
        n_elems = -(-n_bytes // 31)
        assert tuple(leaves.shape) == (20, n_leaves) and leaves.dtype == torch.int32
        assert leaves[:, :n_elems].any(dim=0).all() and not leaves[:, n_elems:].any()


def test_cli_vectors_and_info(capsys):
    rc, out, _ = _run(capsys, ["vectors", "--device", "cpu"])
    assert rc == 0 and len(out) == 14 and all(line.startswith("ok ") for line in out)
    rc, out, _ = _run(capsys, ["info", "--device", "cpu"])
    assert rc == 0 and out[0].startswith("device: cpu") and len(out) == 15
    assert "vesta/anemoi_2_1: 255-bit field, L=20 limbs, alpha=5, rounds=21, rate=1" in out


def test_cli_vectors_reports_a_failure(tmp_path):
    """A vector file with one wrong digest fails its line."""
    import json

    vec = json.loads((cli.VECTORS / "vesta_anemoi_2_1.json").read_text())
    vec["hash_field"]["output"][0] = [str(int(vec["hash_field"]["output"][0][0]) + 1)]
    (tmp_path / "vesta_anemoi_2_1.json").write_text(json.dumps(vec))
    (line,) = cli.check_vectors(tmp_path)
    assert line.startswith("FAIL vesta/anemoi_2_1: 31 of 32")


@pytest.mark.parametrize("cmd", [["hash"], ["merkle", "x.bin"], ["vectors"], ["info"]])
def test_cli_needs_a_card_or_cpu(cmd, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, cmd)
    assert rc != 0 and out == [] and "no CUDA device" in err
