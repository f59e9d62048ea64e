"""Command-line interface of the port.

    python -m anemoi_tpu_torch.cli hash    [--field F] [--instance I] [--backend B] [--device D] [--stats] [FILE...]
    python -m anemoi_tpu_torch.cli merkle  [--field F] [--instance I] [--backend B] [--device D] [--stats] FILE
    python -m anemoi_tpu_torch.cli vectors [--device D]
    python -m anemoi_tpu_torch.cli info    [--device D]

Counterpart of ``anemoi_tpu/cli.py``, with its arguments.  ``hash``
sponge-hashes each FILE (or standard input) and prints one digest in hex a
line: files of any lengths are bucketed by element count, one sponge
launch a bucket (``hash_bytes_mixed``), and the digests leave Montgomery
form on the device (``digest_export_fn``); ``--backend golden`` runs the
scalar model instead.  ``merkle`` packs FILE into field elements, pads
them with zero leaves to a power of the arity, and prints the Merkle
root: one Jive launch a level.  ``vectors`` checks the golden model
against the SAGE vectors in ``tests/vectors/`` and exits 0 only when all
hold.  ``info`` prints the device and every instance's parameters.

The device runs the work: the card unless ``--device cpu`` is given, and
without a card and without ``--device cpu`` every command exits non-zero.
``--backend auto`` follows the device; "pallas", "jit" and "cuda" all run
the kernels on the card and the plain version on the CPU, with the same
outputs.  ``--stats`` prints the command's seconds and kernel launches to
standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .ff import cuda_backend, golden, native
from .ff import limb_ops as lo
from .fields.params import all_instances, get_instance

VECTORS = Path(__file__).resolve().parent.parent / "tests" / "vectors"
BACKENDS = ("auto", "pallas", "jit", "golden", "cuda")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cmd_hash(args, device: torch.device) -> int:
    from .modes.batched import digest_export_fn, digests_to_bytes
    from .modes.bytes_pipeline import hash_bytes_mixed

    inst = get_instance(args.field, args.instance)
    msgs = [_read(f) for f in args.file] if args.file else [sys.stdin.buffer.read()]
    if args.backend == "golden":
        for m in msgs:
            print(golden.digest_to_bytes(inst, golden.hash_bytes(inst, m)).hex())
        return 0
    digests = hash_bytes_mixed(inst, msgs, backend=args.backend, device=device)
    canon = digest_export_fn(inst)(torch.from_numpy(digests).to(device))
    for b in digests_to_bytes(inst, canon):
        print(b.hex())
    return 0


def merkle_leaves(inst, data: bytes, device: torch.device) -> torch.Tensor:
    """The bytes' field elements as int32 [L, N] Montgomery leaves on
    `device`, padded with zero leaves to N, the least power of the arity
    (at least the arity) that holds them.  The packed limbs stay an array:
    no Python int per leaf."""
    fp = inst.field
    packed = native.pack_bytes(data, fp)  # canonical (E, L)
    n = inst.width
    while n < packed.shape[0]:
        n *= inst.width
    leaves = np.zeros((fp.n_limbs, n), dtype=np.int32)
    leaves[:, : packed.shape[0]] = packed.T
    return lo.to_mont(torch.from_numpy(leaves).to(device), lo.field_consts(fp))


def cmd_merkle(args, device: torch.device) -> int:
    from .merkle.tree import MerkleTree

    inst = get_instance(args.field, args.instance)
    leaves = merkle_leaves(inst, _read(args.file), device)
    backend = "jit" if args.backend == "golden" else args.backend
    tree = MerkleTree(inst, backend=backend, chunk_b=min(1024, leaves.shape[1]), device=device)
    root = lo.decode_ints(tree.root(leaves), inst.field)[0]
    print(golden.digest_to_bytes(inst, [root]).hex())
    return 0


def check_vectors(vector_dir: Path = VECTORS) -> list[str]:
    """The golden model against every SAGE vector file in `vector_dir`
    (sbox, hash_field, hash_bytes, Jive and the 2_1 merge); returns one
    line per file, each starting with "ok" or "FAIL"."""
    paths = sorted(vector_dir.glob("*_anemoi_*.json"))
    if not paths:
        raise FileNotFoundError(f"no vector files in {vector_dir}")
    lines = []
    for path in paths:
        field, iname = path.stem.split("_anemoi_")
        inst = get_instance(field, "anemoi_" + iname)
        vec = json.loads(path.read_text())
        ints = lambda xs: [int(x) for x in xs]
        checks = [golden.sbox_layer(inst, ints(s)) == ints(w)
                  for s, w in zip(vec["sbox"]["input"], vec["sbox"]["output"])]
        checks += [golden.hash_field(inst, ints(e)) == ints(w)
                   for e, w in zip(vec["hash_field"]["input"], vec["hash_field"]["output"])]
        chunk = inst.field.byte_chunk
        checks += [golden.hash_bytes(inst, b"".join(int(x).to_bytes(chunk, "little") for x in e)) == ints(w)
                   for e, w in zip(vec["hash_bytes"]["input"], vec["hash_bytes"]["output"])]
        for pair, k in zip(vec["jive"], (2, 4)):
            checks += [golden.jive_compress_k(inst, ints(e), k) == ints(w)
                       for e, w in zip(pair["input"], pair["output"])]
        if inst.rate == 1:
            checks += [golden.merge(inst, ints(e)[:1], ints(e)[1:]) == ints(w)
                       for e, w in zip(vec["jive"][0]["input"], vec["jive"][0]["output"])]
        ok = all(checks)
        lines.append(f"{'ok' if ok else 'FAIL'} {inst.qualified_name}: {sum(checks)} of {len(checks)} vectors hold")
    return lines


def cmd_vectors(args, device: torch.device) -> int:
    lines = check_vectors()
    print("\n".join(lines))
    return 0 if all(line.startswith("ok") for line in lines) else 1


def cmd_info(args, device: torch.device) -> int:
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}  devices: {torch.cuda.device_count()}")
    else:
        print(f"device: cpu  CUDA devices: {torch.cuda.device_count()}")
    for inst in all_instances():
        fp = inst.field
        print(f"{inst.qualified_name}: {fp.bits}-bit field, L={fp.n_limbs} limbs, "
              f"alpha={fp.alpha}, rounds={inst.rounds}, rate={inst.rate}")
    return 0


def _stats(seconds: float) -> str:
    perm = cuda_backend.permutation
    return (f"seconds: {seconds:.6f}; launches: jive {cuda_backend.jive.launches}, permutation {perm.launches} "
            f"(four-lane {perm.group_launches}), sponge {cuda_backend.sponge.launches}, "
            f"unpack {cuda_backend.unpack.launches}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="anemoi_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("hash", cmd_hash), ("merkle", cmd_merkle), ("vectors", cmd_vectors), ("info", cmd_info)):
        p = sub.add_parser(name)
        p.set_defaults(fn=fn)
        p.add_argument("--device", default=None, help="cuda (the default) or cpu")
        if name in ("hash", "merkle"):
            p.add_argument("--field", default="vesta")
            p.add_argument("--instance", default="anemoi_2_1")
            p.add_argument("--backend", default="auto", choices=BACKENDS,
                           help="auto, pallas, jit and cuda: the kernels on the card, the plain version on the "
                                "CPU; golden: the scalar model")
            p.add_argument("--stats", action="store_true", help="print seconds and kernel launches to stderr")
            p.add_argument("file", nargs="*" if name == "hash" else None)
    args = ap.parse_args(argv)
    try:
        device = cuda_backend.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"anemoi_tpu_torch: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rc = args.fn(args, device)
    if getattr(args, "stats", False):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(_stats(time.perf_counter() - t0), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
