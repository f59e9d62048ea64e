"""Verification of every kernel of the port on the card, for the fields given.

    python3 -m anemoi_tpu_torch.tools.verify_cuda [--fields vesta,bls12_381 | all] [--device cuda|cpu]

Counterpart of ``tools/verify_tpu.py``: one PASS or FAIL line a check, then
the kernel launches it made (a JSON line of ``cuda_backend.launch_counts()``'s
keys, with ``_w12`` after them for the 12-word fields) and "ALL PASS" (exit 0)
or "FAILURES" (exit 1).  For each field:

  * for anemoi_2_1 and anemoi_4_3: the permutation at 128 states (the
    four-lane kernel) and at 16,384 (above ``permute_group_max``: the
    one-thread kernel; under an "mxu" name the tensor-core kernels' quad
    form and, above ``permute_mma_group_max``, their thread form), and
    Jive-k at 128 states (k = 2 and 4);
  * the anemoi_4_3 sponge over 32 messages of E = 7 elements (two rate
    blocks and a tail);
  * the anemoi_2_1 Merkle root over 2^10 leaves, with its levels.

Each check holds the kernel against the port's golden model (every lane of
the sponge, 32 lanes of each other batch, 16 at each end, and 4 nodes of
every level of the root) and every lane against the native oracle
(``ff/native.py``, C++ on the host's cores; around it, the sponge's rate
adds and sigma in Python ints), and checks that the permutation ran the
kernel ``permute_group_max`` names (or, under an "mxu" name, the
tensor-core form ``permute_mma_group_max`` names).  Inputs are canonical
(``limb_ops.random_canonical``, seeded).

Unlike ``verify_tpu.py``, whose root compares the fused kernel with the
jit backend, the root here is held against the oracle and the golden
model, not a second root on the CPU: the plain PyTorch version takes about
2.5 s a call and 47 ms a Vesta lane on one CPU core, over a minute a field
for 2^10 leaves.  ``--device cpu`` takes the place of ``--interpret``: the
same checks on the plain version, at sizes the CPU finishes (16 states, 8
messages, 2^4 leaves).  ``--mul-impl`` and ``--ladder`` are validated as
the JAX package validates them.  The permutation and the sponge checks
call ``cuda_backend.permutation`` and ``cuda_backend.sponge`` with the
``--mul-impl`` name, as ``verify_tpu.py`` runs ``permutation_pallas`` and
``sponge_pallas`` under it.  A name that starts with "mxu" (the JAX
kernels' product on the TPU's matrix unit, their default) runs every check
on the tensor-core kernels: Jive and the root on ``csrc/jive_mma.cu``, the
permutation and the sponge on ``csrc/sponge_mma.cu``, whose launches the
JSON line counts as "jive_mma", "permutation_mma" (the quad form),
"permutation_mma_thread" and "sponge_mma"; the other names change nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ff import cuda_backend, golden, native
from ..ff import limb_ops as lo
from ..ff.cuda_backend import launch_counts
from ..ff.mxu_ops import selects_mma
from ..ff.native import canonical_host
from ..fields.params import FIELD_NAMES, InstanceParams, get_instance
from ..merkle.tree import MerkleTree, check_levels
from ..modes.batched import decode_states, jive_compress_batch_fn

SIZES = {  # states of each permutation, Jive states, sponge messages, root leaves
    "cuda": {"perm": (128, 16384), "jive": 128, "sponge": 32, "root": 1 << 10},
    "cpu": {"perm": (16,), "jive": 16, "sponge": 8, "root": 1 << 4},
}
SPONGE_E = 7
GOLDEN_LANES = 32


def check(name: str, ok: bool) -> bool:
    print(f"{'PASS' if ok else 'FAIL'} {name}", flush=True)
    return ok


def ends(n: int, k: int = GOLDEN_LANES) -> list[int]:
    """k lanes, half at each end of n (all of them when n <= k)."""
    return sorted(set(range(min(n, k // 2))) | set(range(max(n - k // 2, 0), n)))


class FieldCheck:
    """The checks of one field on one device, with seeded canonical inputs."""

    def __init__(self, field: str, device: torch.device, seed: int = 0, mul_impl: str | None = None):
        self.field, self.device, self.mul_impl = field, device, mul_impl
        self.sizes = SIZES[device.type]
        self.rng = np.random.default_rng(seed)

    def states(self, inst: InstanceParams, rows: int, n: int) -> torch.Tensor:
        """int32 [rows, L, n] random canonical values on the device."""
        arr = lo.random_canonical(inst.field, (rows, n), self.rng).transpose(1, 0, 2)
        return torch.from_numpy(arr.copy()).to(self.device)

    def held(self, inst, x, out, want_golden, want_oracle: np.ndarray, lanes: list) -> tuple[bool, bool]:
        """(the lanes of `out` equal the golden model's on those lanes of x,
        every lane of `out` equals the oracle's)."""
        got = decode_states(inst, out[:, :, lanes])
        gold = got == [want_golden(s) for s in decode_states(inst, x[:, :, lanes])]
        return gold, np.array_equal(canonical_host(inst, out), want_oracle)

    def permutation(self, inst: InstanceParams, n: int) -> bool:
        W, L = inst.width, inst.field.n_limbs
        x = self.states(inst, W, n)
        before = launch_counts()
        out = cuda_backend.permutation(inst, x.reshape(W * L, n), self.mul_impl).reshape(W, L, n)
        after = launch_counts()
        four_lane = after["four_lane"] > before["four_lane"]
        if self.device.type == "cpu":
            kernel, routed = "plain version", True
        elif selects_mma(self.mul_impl):
            quad = after["permutation_mma"] > before["permutation_mma"]
            kernel = f"tensor-core kernel, {'quad' if quad else 'thread'} form"
            routed = (after["permutation_mma"] + after["permutation_mma_thread"]
                      == before["permutation_mma"] + before["permutation_mma_thread"] + 1) and quad == (
                n <= cuda_backend.permute_mma_group_max(inst.field.kernel_words))
        else:
            kernel = "four-lane kernel" if four_lane else "one-thread kernel"
            routed = four_lane == (n <= cuda_backend.permute_group_max(inst.field.kernel_words))
        lanes = ends(n)
        gold, orc = self.held(inst, x, out, lambda s: golden.permutation(inst, s),
                              native.threaded(native.permute_batch_canonical, inst, canonical_host(inst, x)), lanes)
        return check(f"{inst.qualified_name} permutation, {n} states ({kernel}): golden on {len(lanes)} lanes "
                     f"{gold}, native oracle on all {orc}, route {routed}", gold and orc and routed)

    def jive(self, inst: InstanceParams) -> bool:
        n, k = self.sizes["jive"], inst.width // inst.digest_size
        x = self.states(inst, inst.width, n)
        out = jive_compress_batch_fn(inst, k, device=self.device, mul_impl=self.mul_impl)(x)
        lanes = ends(n)
        gold, orc = self.held(inst, x, out, lambda s: golden.jive_compress_k(inst, s, k),
                              native.threaded(native.jive_batch_canonical, inst, canonical_host(inst, x), k), lanes)
        return check(f"{inst.qualified_name} jive-{k}, {n} states: golden on {len(lanes)} lanes {gold}, "
                     f"native oracle on all {orc}", gold and orc)

    def sponge(self) -> bool:
        inst = get_instance(self.field, "anemoi_4_3")
        n = self.sizes["sponge"]
        L = inst.field.n_limbs
        x = self.states(inst, SPONGE_E, n)
        out = cuda_backend.sponge(inst, SPONGE_E, x.reshape(SPONGE_E * L, n), self.mul_impl).reshape(-1, L, n)
        gold, orc = self.held(inst, x, out, lambda m: golden.hash_field(inst, m),
                              native.host_sponge(inst, canonical_host(inst, x)), list(range(n)))
        return check(f"{inst.qualified_name} sponge (E={SPONGE_E}), {n} messages: golden on all {gold}, native "
                     f"oracle on all {orc}", gold and orc)

    def root(self) -> bool:
        inst = get_instance(self.field, "anemoi_2_1")
        n = self.sizes["root"]
        leaves = self.states(inst, 1, n)[0]
        root, levels = MerkleTree(inst, device=self.device, mul_impl=self.mul_impl).root(leaves, return_levels=True)
        try:
            nodes = check_levels(inst, levels)
        except golden.ParityError as e:
            print(f"  {e}", flush=True)
            nodes = 0
        want = native.tree_levels(inst, canonical_host(inst, leaves)[:, 0])
        orc = len(want) == len(levels) - 1 and all(
            np.array_equal(canonical_host(inst, got)[:, 0], w) for got, w in zip(levels[1:], want))
        return check(f"{inst.qualified_name} merkle root, {n} leaves, {len(levels) - 1} levels: golden on "
                     f"{nodes} nodes {nodes > 0}, native oracle on every node {orc}", nodes > 0 and orc)

    def run(self) -> bool:
        ok = True
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            inst = get_instance(self.field, iname)
            for n in self.sizes["perm"]:
                ok &= self.permutation(inst, n)
            ok &= self.jive(inst)
        ok &= self.sponge()
        return self.root() and ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m anemoi_tpu_torch.tools.verify_cuda",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--fields", default="vesta", help="comma-separated field names, or all")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu, the plain version")
    ap.add_argument("--mul-impl", default=None,
                    help="the JAX package's mul impl: mxu, mxuf, mxus, mxu2 or mxu3 runs every check on the tensor-core "
                         "kernels (jive_mma.cu, sponge_mma.cu); the others are validated and change nothing")
    ap.add_argument("--ladder", default=None, help="validated and ignored: the JAX package's exp ladder")
    args = ap.parse_args(argv)
    try:
        lo.check_tuning(args.mul_impl, args.ladder)
    except ValueError as e:
        ap.error(str(e))
    fields = FIELD_NAMES if args.fields == "all" else tuple(args.fields.split(","))
    for f in fields:
        if f not in FIELD_NAMES:
            ap.error(f"unknown field {f!r}; known: {', '.join(FIELD_NAMES)} or all")
    try:
        device = cuda_backend.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"verify_cuda: {e}", file=sys.stderr)
        return 2
    t0 = time.time()
    ok = True
    launches: dict = {}
    for field in fields:
        before = launch_counts()
        ok &= FieldCheck(field, device, mul_impl=args.mul_impl).run()
        after = launch_counts()
        w = "_w12" if get_instance(field, "anemoi_2_1").field.kernel_words == 12 else ""
        for k in after:
            launches[k + w] = launches.get(k + w, 0) + after[k] - before[k]
    print("launches: " + json.dumps(launches), flush=True)
    print(f"done in {time.time() - t0:.0f}s: {'ALL PASS' if ok else 'FAILURES'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
