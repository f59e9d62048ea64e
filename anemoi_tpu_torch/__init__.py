"""PyTorch / CUDA port of the anemoi_tpu hash library.

This slice covers batched Jive-k compression and Merkle roots for the
20-limb fields (BN-254, Ed-on-BLS12-377, Jubjub, Pallas, Vesta): plain
PyTorch everywhere, and one hand-written CUDA kernel (``csrc/jive.cu``) on
an H100.  It imports neither JAX nor the ``anemoi_tpu`` package.

Entry points take ``device=None``, which means the card; pass
``device="cpu"`` to run the plain path without one.
"""

from .fields.params import all_instances, get_field, get_instance
from .merkle.tree import MerkleTree
from .modes.batched import decode_states, encode_states, jive_compress_batch_fn

__all__ = [
    "MerkleTree",
    "all_instances",
    "decode_states",
    "encode_states",
    "get_field",
    "get_instance",
    "jive_compress_batch_fn",
]
