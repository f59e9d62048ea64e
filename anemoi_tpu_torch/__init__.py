"""PyTorch / CUDA port of the anemoi_tpu hash library.

It covers the scalar API over the golden model for all 14 instances, and
batched Jive-k, Merkle trees (roots, levels, checkpoints, proofs), the
permutation and the sponge over field elements and bytes (one-shot and
streaming) for all seven fields: plain PyTorch everywhere, and hand-written
CUDA kernels (``csrc/jive.cu``, ``csrc/sponge.cu``, at 8 words for the
20-limb fields and 12 for BLS12-377 and BLS12-381) on an H100.
``microbench.py`` measures the card's integer rate (``csrc/microbench.cu``).
It imports neither JAX nor the ``anemoi_tpu`` package.

    import anemoi_tpu_torch as att
    d = att.vesta.anemoi_2_1.hash(b"hello world")             # scalar, golden model
    digests = att.vesta.anemoi_4_3.batch.hash_bytes(messages)  # on the card

Entry points take ``device=None``, which means the card; pass
``device="cpu"`` to run the plain path without one.
"""

from .fields.params import all_instances, get_field, get_instance
from .instances import (
    AnemoiInstance,
    Digest,
    all_instance_objects,
    bls12_377,
    bls12_381,
    bn_254,
    ed_on_bls12_377,
    instance,
    jubjub,
    pallas_field,
    vesta,
)
from .merkle.tree import MerkleTree
from .modes.batched import decode_states, encode_states, jive_compress_batch_fn

__all__ = [
    "AnemoiInstance",
    "Digest",
    "MerkleTree",
    "all_instance_objects",
    "all_instances",
    "bls12_377",
    "bls12_381",
    "bn_254",
    "decode_states",
    "ed_on_bls12_377",
    "encode_states",
    "get_field",
    "get_instance",
    "instance",
    "jive_compress_batch_fn",
    "jubjub",
    "pallas_field",
    "vesta",
]
