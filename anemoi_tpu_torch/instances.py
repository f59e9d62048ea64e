"""User-facing Anemoi instances of the port.

Counterpart of ``anemoi_tpu/instances.py``: the reference's public API
surface (src/lib.rs:21-64: per-field modules, each exporting the two
instantiations with Sponge / Jive / digest operations) as Python objects:

    import anemoi_tpu_torch as att
    d = att.vesta.anemoi_2_1.hash(b"some bytes")          # sponge over bytes
    d = att.vesta.anemoi_2_1.hash_field([1, 2, 3])        # sponge over elements
    c = att.vesta.anemoi_4_3.compress_k([a, b, c, d], 4)  # Jive
    m = att.vesta.anemoi_2_1.merge(d0, d1)                # Merkle 2-to-1

Scalar calls are served by the port's golden model (``ff/golden.py``).
The ``.batch`` namespace runs on limb tensors (see ``modes/batched.py``):
a function that takes a tensor runs where the tensor lies, through a CUDA
kernel on the card or the plain version on the CPU; one that makes
tensors takes ``device=None``, which means the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from types import SimpleNamespace

from .ff import golden
from .fields.params import FIELD_NAMES, INSTANCE_NAMES, InstanceParams, get_instance
from .modes import batched as bm


@dataclass(frozen=True)
class Digest:
    """Fixed-size hash digest (reference: anemoi_*/digest.rs:11-47:
    new / as_elements / to_elements / digests_to_elements / to_bytes)."""

    elements: tuple
    instance: "AnemoiInstance"

    @classmethod
    def new(cls, elements, instance: "AnemoiInstance") -> "Digest":
        if len(elements) != instance.DIGEST_SIZE:
            raise ValueError(f"a digest has {instance.DIGEST_SIZE} elements, got {len(elements)}")
        return cls(tuple(int(e) % instance.params.field.p for e in elements), instance)

    @classmethod
    def default(cls, instance: "AnemoiInstance") -> "Digest":
        """All-zero digest (reference digest.rs derives Default)."""
        return cls((0,) * instance.DIGEST_SIZE, instance)

    def as_elements(self) -> tuple:
        return self.elements

    def to_elements(self) -> list:
        return list(self.elements)

    @staticmethod
    def digests_to_elements(digests: list) -> list:
        """Flatten digests for absorption (reference digest.rs:32-39)."""
        return [e for d in digests for e in d.elements]

    def to_bytes(self) -> bytes:
        return golden.digest_to_bytes(self.instance.params, list(self.elements))

    def __iter__(self):
        return iter(self.elements)


class AnemoiInstance:
    """One Anemoi instantiation: scalar API and batched API."""

    def __init__(self, params: InstanceParams):
        self.params = params
        self.STATE_WIDTH = params.width
        self.RATE_WIDTH = params.rate
        self.NUM_COLUMNS = params.columns
        self.DIGEST_SIZE = params.digest_size
        self.NUM_HASH_ROUNDS = params.rounds

    # ----- scalar API (golden model) ------------------------------------

    def permutation(self, state: list) -> list:
        return golden.permutation(self.params, state)

    def round(self, state: list, round_ctr: int) -> list:
        return golden.round_fn(self.params, state, round_ctr)

    def ark_layer(self, state: list, round_ctr: int) -> list:
        return golden.ark_layer(self.params, state, round_ctr)

    def mds_layer(self, state: list) -> list:
        return golden.mds_layer(self.params, state)

    def sbox_layer(self, state: list) -> list:
        return golden.sbox_layer(self.params, state)

    def hash(self, data: bytes) -> Digest:
        return Digest(tuple(golden.hash_bytes(self.params, data)), self)

    def hash_field(self, elems: list) -> Digest:
        return Digest(tuple(golden.hash_field(self.params, elems)), self)

    def compress(self, elems: list) -> list:
        return golden.jive_compress(self.params, elems)

    def compress_k(self, elems: list, k: int) -> list:
        return golden.jive_compress_k(self.params, elems, k)

    def merge(self, d0: Digest, d1: Digest) -> Digest:
        return Digest(tuple(golden.merge(self.params, list(d0), list(d1))), self)

    def merge_reference_quirk(self, d0: Digest, d1: Digest) -> Digest:
        """Bit-compatible with the reference's 4_3 merge, which absorbs
        digests[0] twice (reference vesta/anemoi_4_3/hasher.rs:136-137)."""
        return Digest(tuple(golden.merge_reference_quirk(self.params, list(d0), list(d1))), self)

    # ----- batched API (CUDA kernels, or their plain versions on the CPU) --

    @cached_property
    def batch(self) -> SimpleNamespace:
        from .ff import cuda_backend
        from .modes.bytes_pipeline import hash_bytes_mixed

        params = self.params
        W, L = params.width, params.field.n_limbs

        @lru_cache(maxsize=None)
        def compress_fn(k, device):
            return bm.jive_compress_batch_fn(params, k, device=device)

        @lru_cache(maxsize=None)
        def sponge_fn(num_elements, device):
            return bm.sponge_hash_batch_fn(params, num_elements, device=device)

        @lru_cache(maxsize=None)
        def merge_fn(device):
            return bm.merge_batch_fn(params, device=device)

        def permutation(states):
            """int32 [WIDTH, L, B] -> int32 [WIDTH, L, B]."""
            B = states.shape[-1]
            return cuda_backend.permutation(params, states.reshape(W * L, B)).reshape(W, L, B)

        return SimpleNamespace(
            permutation=permutation,
            compress=lambda states: compress_fn(2, states.device)(states),
            compress_k=lambda states, k: compress_fn(k, states.device)(states),
            merge=lambda d0, d1: merge_fn(d0.device)(d0, d1),
            hash_field=lambda elems: sponge_fn(int(elems.shape[0]), elems.device)(elems),
            # every backend name hashes alike: the device picks the route
            hash_bytes=lambda messages, backend="jit", device=None: hash_bytes_mixed(
                params, messages, backend=backend, device=device
            ),
            encode_states=lambda states, mont=True, device=None: bm.encode_states(
                params, states, mont=mont, device=device
            ),
            decode_states=lambda arr, mont=True: bm.decode_states(params, arr, mont=mont),
        )


def _build_registry() -> dict:
    return {
        fname: SimpleNamespace(**{iname: AnemoiInstance(get_instance(fname, iname)) for iname in INSTANCE_NAMES})
        for fname in FIELD_NAMES
    }


_FIELDS = _build_registry()

bls12_377 = _FIELDS["bls12_377"]
bls12_381 = _FIELDS["bls12_381"]
bn_254 = _FIELDS["bn_254"]
ed_on_bls12_377 = _FIELDS["ed_on_bls12_377"]
jubjub = _FIELDS["jubjub"]
pallas_field = _FIELDS["pallas"]  # "pallas" the curve, not the TPU kernel language
vesta = _FIELDS["vesta"]


def instance(field: str, name: str) -> AnemoiInstance:
    return getattr(_FIELDS[field], name)


def all_instance_objects() -> list:
    return [getattr(_FIELDS[f], i) for f in FIELD_NAMES for i in INSTANCE_NAMES]
