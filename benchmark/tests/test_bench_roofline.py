"""The roofline's counts against a hand count."""

import json
from types import SimpleNamespace

import pytest

from benchmark import roofline, spec
from benchmark.reference import anemoi as ref


def test_hand_count_of_a_small_instance():
    # inv_alpha = 0b1011: 3 squarings and 2 products by the binary method,
    # plus the Flystel's 2 squarings and 2 products by g: 9 a column-round
    assert roofline.products_per_permutation(rounds=2, columns=1, inv_alpha=0b1011) == 18
    assert roofline.products_per_permutation(rounds=2, columns=2, inv_alpha=0b1011) == 36
    # 8 words: 32 operand bytes, 2 * 32^2 + 32 = 2,080 byte multiply-adds at 2 ops
    assert roofline.ops_per_product(255) == 4160
    assert roofline.ops_per_product(377) == 2 * (2 * 48 * 48 + 48)
    defn = SimpleNamespace(rounds=2, columns=1, inv_alpha=11, bits=255, n_limbs=20, width=2, rate=1, digest_size=1)
    w = roofline.jive(defn, n=10, k=2)
    assert w.ops == 10 * 18 * 4160
    assert w.bytes == 10 * 80 * (2 + 1)  # 20 int32 limbs an element, 2 in and 1 out
    s = roofline.sponge(defn, n=3, elements=5)
    assert s.ops == 3 * 5 * 18 * 4160 and s.bytes == 3 * 80 * (5 + 1)
    assert roofline.permutations_per_message(7, 3) == 3 and roofline.permutations_per_message(6, 3) == 2


@pytest.mark.parametrize("config,products,least_ms", [("vesta_2_1", 8001, 17.63), ("bls12_377_2_1", 11760, 58.01)])
def test_published_configs(config, products, least_ms):
    cfg = spec.config(config)
    defn = ref.instance(cfg["field"], cfg["instance"])
    assert roofline.products_per_permutation(defn.rounds, defn.columns, defn.inv_alpha) == products
    seconds, term = roofline.least_time(roofline.jive(defn, 1 << 20), "NVIDIA H100 80GB HBM3")
    assert term == "operations" and seconds * 1e3 == pytest.approx(least_ms, rel=1e-3)


def test_bytes_bound_and_unknown_card():
    w = roofline.Work(ops=1.0, bytes=3.35e12)
    assert roofline.least_time(w, "NVIDIA H100 PCIe") == (1.0, "bytes")
    assert roofline.least_time(w, "some other card") is None
    assert json.dumps(roofline.PEAKS)
