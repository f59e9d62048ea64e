#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Two main paths, through the port's entry points, with random inputs from
``--seed``: batched Vesta anemoi_2_1 Jive 2-to-1 compression and a Merkle
root over 2^20 leaves built on it (``jive_compress_batch_fn``,
``MerkleTree.root``); and the sponge over bytes, 4,096 messages of 10 KB
for Vesta anemoi_4_3 and anemoi_2_1 (``.batch.hash_bytes``) and the
streaming sponge (``BatchedSponge``).  Phases, each printed with its
elapsed seconds:

  1. the card: its name, and name and power limit from nvidia-smi;
  2. the builds, all started together: csrc/jive.cu and csrc/sponge.cu with
     nvcc, timed, with ptxas's report, and the host's byte packer with g++;
  3. the kernel against its plain PyTorch version on the card, bit for bit,
     for Vesta 2_1 (k=2), Vesta 4_3 (k=2, 4) and the 2_1 instance of the
     other four 20-limb fields: 4,099 states, the plain version on 257 of
     them (both ends, so the ragged last block is among them);
  4. the SAGE Jive vectors of the five 20-limb fields x 2 instances;
  5. full size, Vesta 2_1: the main path with every launch count set to 0
     just before and read just after (one Jive over 2^20 states and one
     2^20-leaf root: 1 + 20 launches); then Jive timed with CUDA events,
     1,024 sampled lanes against the plain version, the root timed, up to
     1,024 columns of each of its levels against the plain version, and a
     2^10-leaf root against the plain version's;
  6. the permutation and sponge kernels against their plain versions, bit
     for bit: the permutation of Vesta 2_1 and 4_3 (4,099 states, 257 held
     against the plain version), the sponge over 1,024 messages of Vesta
     4_3 with E = 3 (sigma, no extra permutation) and E = 4 (tail 1) and of
     Vesta 2_1 with E = 2;
  7. the SAGE hash_field and hash_bytes vectors of the five 20-limb fields
     x 2 instances through ``.batch.hash_field`` and ``.batch.hash_bytes``
     on the card, and the Vesta 2_1 digest of b"hello world" through
     ``digest_export_fn`` and ``digests_to_bytes``;
  8. full size, the sponge: 4,096 random 10 KB messages per instance; the
     main path with every launch count set to 0 just before and read just
     after (``.batch.hash_bytes`` for Vesta 4_3 and 2_1: one sponge launch
     each; ``BatchedSponge`` over the 4_3 messages in 4 rate-aligned chunks
     and the tail: one permutation launch per block, 111 in all, digests
     equal to hash_bytes's); then host packing, kernel time (CUDA events)
     and bound; 32 sampled messages per instance against the port's golden
     model; and the sponge kernel alone over 65,536 Vesta 4_3 messages
     made on the card, 4 lanes against the golden model;
  9. one JSON line of kernels: launches, error, times, bound.

The tolerance everywhere is exact: integer arithmetic, canonical outputs.
Where the plain version would take minutes (a 10 KB message is 111 or 331
permutations), outputs are held against the golden model over Python ints
instead, on sampled lanes.
Any failure raises; the last line, printed only when every phase passed, is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

N_CHECK = 4099  # not a multiple of the kernel's 128-thread block
N_PLAIN = 257
N_FULL = 1 << 20
N_SAMPLE = 1024
SMALL_TREE = 1 << 10
REPS = 5
MSG_BYTES = 10 * 1024  # bench.py:210-235, bench_sponge_10kb
N_MSGS = 4096
N_MSGS_FILL = 1 << 16  # enough messages to fill the card
N_SPONGE_PLAIN = 1024
N_GOLDEN = 32
SPONGE_REPS = 3

# H100 SXM: 3.35 TB/s of HBM3; 32-bit integer multiply-adds at 64 per clock
# per SM (compute capability 9.0 throughput table), SM count and clock read
# from the card.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
WORDS = 8
# one CIOS product: 64 a*b and 64 m*p word products (low and high halves)
# and 8 low products m = t0 * n0; a squaring (field32.cuh:f32_mont_sqr)
# forms each of its 36 distinct a_i*a_j once
IMADS_PER_PRODUCT = 2 * 2 * WORDS * WORDS + WORDS
IMADS_PER_SQUARING = 2 * (WORDS * (WORDS + 1) // 2) + 2 * WORDS * WORDS + WORDS
HELLO_WORLD = "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d"  # Vesta 2_1


def permutation_work(inst, chain) -> tuple[int, int]:
    """(squarings, products) of one permutation, counted with the reference
    addition chain: per Flystel the chain for x^(1/alpha), two squarings y^2
    and two products by beta; per MDS layer (rounds + 1 of them) four
    products by beta at width 4 (mul_g in anemoi32.cuh:mds) and none at
    width 2.  The entry and exit conversions (one product per element read
    or written) are a cost of the representation and are left out."""
    flystels = inst.rounds * inst.columns
    squarings = flystels * (sum(op[0] == "sqr" for op in chain) + 2)
    products = flystels * (sum(op[0] == "mul" for op in chain) + 2) + (inst.rounds + 1) * (4 if inst.width == 4 else 0)
    return squarings, products


def golden_hash_bytes(args) -> list:
    """The port's golden model over one message, in a worker process."""
    field, iname, data = args
    sys.path.insert(0, str(ROOT))
    from anemoi_tpu_torch.ff import golden
    from anemoi_tpu_torch.fields.params import get_instance

    return golden.hash_bytes(get_instance(field, iname), data)


def phase(name: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {name}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_ms(fn) -> tuple[float, object]:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import anemoi_tpu_torch as att
    from anemoi_tpu_torch.ff import cuda_backend, golden, native
    from anemoi_tpu_torch.ff import limb_ops as lo
    from anemoi_tpu_torch.ff.limb_ops import random_canonical
    from anemoi_tpu_torch.fields.params import KERNEL_FIELDS, get_instance, inv_alpha_chain
    from anemoi_tpu_torch.merkle.tree import MerkleTree, level_states
    from anemoi_tpu_torch.modes.batched import (
        decode_states,
        digest_export_fn,
        digests_to_bytes,
        encode_states,
        jive_compress_batch_fn,
    )
    from anemoi_tpu_torch.modes.bytes_pipeline import mont_messages, pack_messages
    from anemoi_tpu_torch.modes.streaming import BatchedSponge

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    max_err = {"jive": 0, "permutation": 0, "sponge": 0}

    def canonical_states(inst, n):
        """int32 [WIDTH, L, n] random canonical states on the card."""
        return torch.from_numpy(random_canonical(inst.field, (inst.width, n), rng).transpose(1, 0, 2).copy()).to(dev)

    def held(kernel_out, plain_out, what, kernel="jive"):
        err = int((kernel_out.long() - plain_out.long()).abs().max()) if kernel_out.numel() else 0
        max_err[kernel] = max(max_err[kernel], err)
        if tuple(kernel_out.shape) != tuple(plain_out.shape):
            fail(f"{what}: shapes {tuple(kernel_out.shape)} and {tuple(plain_out.shape)}")
        if err:
            fail(f"{what}: kernel and plain version differ (max abs err {err})")

    # 1 ---------------------------------------------------------------------
    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"device: {kind}, {props.multi_processor_count} SMs, max SM clock {max_sm_mhz:.0f} MHz, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # 2 ---------------------------------------------------------------------
    phase("2 build")
    t = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one compiler process per source, all at once
        jobs = [pool.submit(f) for f in (cuda_backend.library, cuda_backend.sponge_library, native.library)]
        lib, sponge_lib, _ = [job.result() for job in jobs]
    build_s = time.perf_counter() - t
    for built in (lib, sponge_lib):
        print(f"build: nvcc {built.build_seconds if built.build_seconds is not None else 'not run (built earlier)'} s, "
              f"{built.path.name}", flush=True)
        for line in built.ptxas:
            print(f"  {line}", flush=True)
    print(f"builds and loads, all three at once (with the host packer): {build_s:.2f} s", flush=True)

    # 3 ---------------------------------------------------------------------
    phase("3 kernel vs plain version")
    cases = [("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 2), ("vesta", "anemoi_4_3", 4)]
    cases += [(f, "anemoi_2_1", 2) for f in KERNEL_FIELDS if f != "vesta"]
    lanes = torch.cat([torch.arange(N_PLAIN // 2), torch.arange(N_CHECK - (N_PLAIN - N_PLAIN // 2), N_CHECK)]).to(dev)
    for field, iname, k in cases:
        inst = get_instance(field, iname)
        W, L = inst.width, inst.field.n_limbs
        x = canonical_states(inst, N_CHECK).reshape(W * L, N_CHECK)
        out = cuda_backend.jive(inst, k, x)
        plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()))
        held(out[:, lanes], plain, f"{field}/{iname} k={k}")
        if out.min() < 0 or out.max() >= 1 << 13:
            fail(f"{field}/{iname} k={k}: limbs outside 13 bits")
        print(f"  {field}/{iname} k={k}: {N_CHECK} lanes, {N_PLAIN} held against the plain version "
              f"({plain_ms / 1e3:.2f} s): identical", flush=True)

    # 4 ---------------------------------------------------------------------
    phase("4 SAGE vectors")
    for field in KERNEL_FIELDS:
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            inst = get_instance(field, iname)
            vec = json.loads((ROOT / "tests" / "vectors" / f"{field}_{iname}.json").read_text())
            for pair, k in zip(vec["jive"], (2, 4)):
                want = [[int(v) for v in out] for out in pair["output"]]
                states = encode_states(inst, [[int(v) for v in s] for s in pair["input"]], device=dev)
                got = decode_states(inst, jive_compress_batch_fn(inst, k, device=dev)(states))
                if got != want:
                    fail(f"SAGE vector mismatch: {field}/{iname} k={k}")
            print(f"  {field}/{iname}: exact", flush=True)

    # 5 ---------------------------------------------------------------------
    phase("5 full size: Vesta anemoi_2_1")
    inst = get_instance("vesta", "anemoi_2_1")
    W, L = inst.width, inst.field.n_limbs
    compress = jive_compress_batch_fn(inst, 2, device=dev)
    tree = MerkleTree(inst, device=dev)
    states = canonical_states(inst, N_FULL)
    leaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
    torch.cuda.synchronize()

    cuda_backend.jive.launches = 0
    digests = compress(states)
    before_root = cuda_backend.jive.launches
    root = tree.root(leaves)
    torch.cuda.synchronize()
    jive_launches = launches = cuda_backend.jive.launches
    root_launches = launches - before_root
    print(f"  main path: Jive over {N_FULL} states and a {N_FULL}-leaf root: {launches} kernel launches "
          f"({root_launches} for the root)", flush=True)
    if launches == 0:
        fail("the main path launched no kernel")
    if root_launches != tree.num_levels(N_FULL):
        fail(f"the root took {root_launches} launches for {tree.num_levels(N_FULL)} levels")
    if tuple(digests.shape) != (1, L, N_FULL) or tuple(root.shape) != (L, 1):
        fail(f"shapes {tuple(digests.shape)}, {tuple(root.shape)}")

    jive_ms = ms = cuda_time_ms(lambda: compress(states), REPS)
    print(f"  Jive 2-to-1, {N_FULL} states: {ms:.3f} ms per call, {ms * 1e3 / N_FULL:.4f} us per hash, "
          f"{N_FULL / (ms / 1e3):.1f} hashes/s ({smi}; CUDA events, mean of {REPS} after a warm-up)", flush=True)

    sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
    xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
    jive_plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, 2, xs))
    held(digests.reshape(L, N_FULL)[:, sample], plain, "2^20 Jive, sampled lanes")
    print(f"  {N_SAMPLE} sampled lanes held against the plain version ({jive_plain_ms:.1f} ms): identical",
          flush=True)

    root_ms, root2 = host_time_ms(lambda: tree.root(leaves))
    held(root2, root, "2^20 root, repeated")
    print(f"  Merkle root over {N_FULL} leaves: {root_ms:.3f} ms ({smi}; host clock, synchronized)", flush=True)

    # the root's levels again, with the call tree.root makes for each; up to
    # N_SAMPLE columns of every level (all of the small ones) go to the plain
    # version in one call, whose cost is its launch count, not its lanes
    level, ins, outs = leaves, [], []
    while level.shape[1] > 1:
        x = level_states(level, 2)
        level = cuda_backend.jive(inst, 2, x)
        cols = torch.from_numpy(np.sort(rng.choice(x.shape[1], min(x.shape[1], N_SAMPLE), replace=False))).to(dev)
        ins.append(x[:, cols])
        outs.append(level[:, cols])
    held(level, root, "2^20 root, level by level")
    plain_levels = cuda_backend.jive_plain(inst, 2, torch.cat(ins, 1).contiguous())
    held(torch.cat(outs, 1), plain_levels, "2^20 root's levels, sampled columns")
    print(f"  {sum(t.shape[1] for t in ins)} columns from all {len(ins)} levels of the {N_FULL}-leaf root "
          f"held against the plain version: identical", flush=True)

    small = leaves[:, :SMALL_TREE].contiguous()
    level = small
    while level.shape[1] > 1:
        level = cuda_backend.jive_plain(inst, 2, level_states(level, 2))
    held(tree.root(small), level, "2^10-leaf root")
    print(f"  {SMALL_TREE}-leaf root held against the plain version's: identical", flush=True)

    imad_per_s = props.multi_processor_count * IMAD_PER_CLOCK_PER_SM * max_sm_mhz * 1e6

    def bound(inst, n_perms: int, n_bytes: int) -> dict:
        """The least time for n_perms permutations that move n_bytes."""
        squarings, products = permutation_work(inst, inv_alpha_chain(inst.field.name))
        imads = squarings * IMADS_PER_SQUARING + products * IMADS_PER_PRODUCT
        ops_ms = n_perms * imads / imad_per_s * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return {"squarings": squarings, "products": products, "imads": imads, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    def show_bound(what: str, b: dict, ms: float) -> None:
        print(f"  bound, {what}: per permutation {b['squarings']} squarings x {IMADS_PER_SQUARING} + "
              f"{b['products']} products x {IMADS_PER_PRODUCT} = {b['imads']} IMADs at {imad_per_s:.4g}/s: "
              f"{b['ops_ms']:.3f} ms; bytes {b['bytes_ms']:.4f} ms; kernel at {b['bound_ms'] / ms:.1%} of it",
              flush=True)

    def canonical_rows(inst, rows: int, n: int):
        """int32 [rows*L, n] random canonical limb rows on the card."""
        return torch.from_numpy(random_canonical(inst.field, (rows, n), rng).transpose(1, 0, 2).copy()) \
            .reshape(rows * inst.field.n_limbs, n).to(dev)

    # 6 ---------------------------------------------------------------------
    phase("6 permutation and sponge kernels vs plain version")
    plain_times = {}
    for iname in ("anemoi_2_1", "anemoi_4_3"):
        inst = get_instance("vesta", iname)
        x = canonical_rows(inst, inst.width, N_CHECK)
        out = cuda_backend.permutation(inst, x)
        plain_ms, plain = host_time_ms(lambda: cuda_backend.permutation_plain(inst, x[:, lanes].contiguous()))
        plain_times[("permutation", iname)] = plain_ms
        held(out[:, lanes], plain, f"vesta/{iname} permutation", "permutation")
        print(f"  permutation, vesta/{iname}: {N_CHECK} states, {N_PLAIN} held against the plain version "
              f"({plain_ms / 1e3:.2f} s): identical", flush=True)
    for iname, E in (("anemoi_4_3", 3), ("anemoi_4_3", 4), ("anemoi_2_1", 2)):
        inst = get_instance("vesta", iname)
        m = canonical_rows(inst, E, N_SPONGE_PLAIN)
        out = cuda_backend.sponge(inst, E, m)
        plain_ms, plain = host_time_ms(lambda: cuda_backend.sponge_plain(inst, E, m))
        plain_times[("sponge", iname, E)] = plain_ms
        held(out, plain, f"vesta/{iname} sponge E={E}", "sponge")
        print(f"  sponge, vesta/{iname}, E={E}: {N_SPONGE_PLAIN} messages held against the plain version "
              f"({plain_ms / 1e3:.2f} s): identical", flush=True)

    # 7 ---------------------------------------------------------------------
    phase("7 SAGE sponge vectors and the hello-world digest, through .batch")
    for field in KERNEL_FIELDS:
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            obj = att.instance(field, iname)
            fp = obj.params.field
            vec = json.loads((ROOT / "tests" / "vectors" / f"{field}_{iname}.json").read_text())
            for elems, want in zip(vec["hash_field"]["input"], vec["hash_field"]["output"]):
                x = obj.batch.encode_states([[int(e) for e in elems]], device=dev)  # [E, L, 1]
                if obj.batch.decode_states(obj.batch.hash_field(x)) != [[int(w) for w in want]]:
                    fail(f"SAGE hash_field mismatch: {field}/{iname}, {len(elems)} elements")
            data = [b"".join(int(e).to_bytes(fp.byte_chunk, "little") for e in elems)
                    for elems in vec["hash_bytes"]["input"]]
            got = obj.batch.decode_states(obj.batch.hash_bytes(data))
            if got != [[int(w) for w in want] for want in vec["hash_bytes"]["output"]]:
                fail(f"SAGE hash_bytes mismatch: {field}/{iname}")
            print(f"  {field}/{iname}: {len(vec['hash_field']['input'])} hash_field and {len(data)} hash_bytes "
                  f"vectors exact", flush=True)
    two = att.vesta.anemoi_2_1
    hello = torch.from_numpy(two.batch.hash_bytes([b"hello world"])).to(dev)
    hello_hex = digests_to_bytes(two.params, digest_export_fn(two.params)(hello))[0].hex()
    if hello_hex != HELLO_WORLD:
        fail(f"vesta/anemoi_2_1 digest of b'hello world' is {hello_hex}, not {HELLO_WORLD}")
    print(f"  vesta/anemoi_2_1 hash_bytes(b'hello world') -> export -> bytes: {hello_hex}", flush=True)

    # 8 ---------------------------------------------------------------------
    phase(f"8 full size: the sponge over {N_MSGS} messages of {MSG_BYTES} bytes")
    objs = {iname: att.instance("vesta", iname) for iname in ("anemoi_4_3", "anemoi_2_1")}
    msgs = [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
    E = native.num_elements(MSG_BYTES, objs["anemoi_4_3"].params.field)
    rate43 = objs["anemoi_4_3"].params.rate
    blocks = E // rate43
    chunks = [blocks // 4 + (i < blocks % 4) for i in range(4)]  # rate-blocks per chunk
    torch.cuda.synchronize()

    for counter in (cuda_backend.jive, cuda_backend.permutation, cuda_backend.sponge):
        counter.launches = 0
    first_ms, full = {}, {}
    for iname, obj in objs.items():
        first_ms[iname], full[iname] = host_time_ms(lambda: obj.batch.hash_bytes(msgs))
    sponge_launches = cuda_backend.sponge.launches
    stream = BatchedSponge(objs["anemoi_4_3"].params, N_MSGS, device=dev)
    mont = mont_messages(objs["anemoi_4_3"].params, pack_messages(objs["anemoi_4_3"].params, msgs), dev)
    start = 0
    for n in chunks:
        stream.absorb(mont[start:start + n * rate43])
        start += n * rate43
    streamed = stream.finalize(mont[start:])
    torch.cuda.synchronize()
    perm_launches = cuda_backend.permutation.launches
    print(f"  main path: hash_bytes for vesta/anemoi_4_3 and vesta/anemoi_2_1 over {N_MSGS} x {MSG_BYTES} bytes "
          f"({E} elements each), BatchedSponge over the 4_3 messages in chunks of {chunks} rate-blocks and a "
          f"tail of {E - start}: {sponge_launches} sponge launches, {perm_launches} permutation launches, "
          f"{cuda_backend.jive.launches} Jive launches", flush=True)
    if sponge_launches != len(objs):
        fail(f"hash_bytes took {sponge_launches} sponge launches for {len(objs)} calls")
    if perm_launches != blocks + (E % rate43 > 0):
        fail(f"BatchedSponge took {perm_launches} permutation launches for {blocks} blocks and a tail")
    for iname, out in full.items():
        if out.shape != (1, L, N_MSGS):
            fail(f"{iname}: digests of shape {out.shape}")
    held(streamed.cpu(), torch.from_numpy(full["anemoi_4_3"]), "BatchedSponge against hash_bytes", "permutation")
    print("  BatchedSponge digests equal hash_bytes's", flush=True)

    sponge_ms, sponge_bound, e2e_ms = {}, {}, {}
    for iname, obj in objs.items():
        inst = obj.params
        e2e_ms[iname] = host_time_ms(lambda: obj.batch.hash_bytes(msgs))[0]
        pack_ms = time.perf_counter()
        packed = pack_messages(inst, msgs)
        pack_ms = (time.perf_counter() - pack_ms) * 1e3
        x = mont_messages(inst, packed, dev).reshape(E * L, N_MSGS)
        ms = sponge_ms[iname] = cuda_time_ms(lambda: cuda_backend.sponge(inst, E, x), SPONGE_REPS)
        perms = -(-E // inst.rate)
        b = sponge_bound[iname] = bound(inst, N_MSGS * perms, N_MSGS * (E + inst.digest_size) * L * 4)
        print(f"  vesta/{iname}: host packing {pack_ms:.1f} ms; sponge kernel {ms:.3f} ms ({SPONGE_REPS} calls "
              f"after a warm-up, CUDA events; {perms} permutations a message); end to end {e2e_ms[iname]:.1f} ms "
              f"(host clock around .batch.hash_bytes, synchronized; {first_ms[iname]:.1f} ms in the main-path "
              f"run, the first); {N_MSGS / (e2e_ms[iname] / 1e3):.1f} msgs/s, "
              f"{N_MSGS * MSG_BYTES / (e2e_ms[iname] / 1e3) / 1e6:.3f} MB/s end to end; kernel alone "
              f"{N_MSGS / (ms / 1e3):.1f} msgs/s ({smi})", flush=True)
        show_bound(f"vesta/{iname} sponge, {N_MSGS} messages", b, ms)

    # the golden model over sampled messages, in one worker process per core
    # (a 10 KB message takes it 0.5 to 1 s)
    picks = sorted(rng.choice(N_MSGS, N_GOLDEN, replace=False).tolist())
    with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        for iname, out in full.items():
            want = pool.map(golden_hash_bytes, [("vesta", iname, msgs[i]) for i in picks])
            got = decode_states(objs[iname].params, out[:, :, picks])
            if got != want:
                fail(f"vesta/{iname}: sampled 10 KB digests differ from the golden model")
            print(f"  vesta/{iname}: {N_GOLDEN} sampled messages held against the golden model: identical", flush=True)

    # the card filled: 65,536 Vesta 4_3 messages made on the card, kernel alone
    inst = objs["anemoi_4_3"].params
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    big = torch.randint(0, 1 << 13, (E, L, N_MSGS_FILL), generator=gen, device=dev, dtype=torch.int32)
    top = L - 1  # clear every bit from 2^(bits(p) - 1) up: canonical values
    big[:, top] &= (1 << (inst.field.p.bit_length() - 1 - 13 * top)) - 1
    big = big.reshape(E * L, N_MSGS_FILL)
    fill_ms = cuda_time_ms(lambda: cuda_backend.sponge(inst, E, big), 2)
    fill_bound = bound(inst, N_MSGS_FILL * -(-E // inst.rate), N_MSGS_FILL * (E + 1) * L * 4)
    print(f"  vesta/anemoi_4_3, {N_MSGS_FILL} messages made on the card: sponge kernel {fill_ms:.3f} ms "
          f"(2 calls after a warm-up, CUDA events), {N_MSGS_FILL / (fill_ms / 1e3):.1f} msgs/s; at {N_MSGS} "
          f"messages {N_MSGS / (sponge_ms['anemoi_4_3'] / 1e3):.1f} msgs/s ({smi})", flush=True)
    show_bound(f"vesta/anemoi_4_3 sponge, {N_MSGS_FILL} messages", fill_bound, fill_ms)
    fill_out = cuda_backend.sponge(inst, E, big)
    cols = [0, 1, N_MSGS_FILL // 2, N_MSGS_FILL - 1]
    elems = big.reshape(E, L, N_MSGS_FILL)[:, :, cols].cpu()
    for j, col in enumerate(cols):
        message = lo.decode_ints(elems[:, :, j].T.contiguous(), inst.field)
        if lo.decode_ints(fill_out[:, col:col + 1], inst.field) != golden.hash_field(inst, message):
            fail(f"65,536-message sponge: lane {col} differs from the golden model")
    print(f"  lanes {cols} held against the golden model: identical", flush=True)
    del big, fill_out

    # the permutation at the shape BatchedSponge gives it
    x = canonical_rows(inst, inst.width, N_MSGS)
    perm_ms = cuda_time_ms(lambda: cuda_backend.permutation(inst, x), REPS)
    perm_bound = bound(inst, N_MSGS, N_MSGS * 2 * inst.width * L * 4)
    print(f"  permutation, vesta/anemoi_4_3, {N_MSGS} states: {perm_ms:.3f} ms ({REPS} calls after a warm-up, "
          f"CUDA events)", flush=True)
    show_bound(f"vesta/anemoi_4_3 permutation, {N_MSGS} states", perm_bound, perm_ms)

    # 9 ---------------------------------------------------------------------
    phase("9 kernels")
    inst = get_instance("vesta", "anemoi_2_1")
    jive_bound = bound(inst, N_FULL, N_FULL * (inst.width + 1) * L * 4)
    show_bound(f"vesta/anemoi_2_1 Jive, {N_FULL} states", jive_bound, jive_ms)

    def entry(name, source, replaces, launches, ms, plain_ms, b, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("jive", "anemoi_tpu_torch/csrc/jive.cu", "anemoi_tpu/ff/pallas_backend.py:707", jive_launches,
              jive_ms, jive_plain_ms, jive_bound, lanes=N_FULL, plain_lanes=N_SAMPLE, root_ms=root_ms,
              build_s=lib.build_seconds),
        entry("permutation", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:430",
              perm_launches, perm_ms, plain_times[("permutation", "anemoi_4_3")], perm_bound,
              instance="vesta/anemoi_4_3", lanes=N_MSGS, plain_lanes=N_PLAIN, build_s=sponge_lib.build_seconds),
        entry("sponge", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:610",
              sponge_launches, sponge_ms["anemoi_4_3"], plain_times[("sponge", "anemoi_4_3", 4)],
              sponge_bound["anemoi_4_3"], instance="vesta/anemoi_4_3", messages=N_MSGS, elements=E,
              plain_messages=N_SPONGE_PLAIN, plain_elements=4, ms_2_1=sponge_ms["anemoi_2_1"],
              bound_ms_2_1=sponge_bound["anemoi_2_1"]["bound_ms"], ms_65536=fill_ms,
              bound_ms_65536=fill_bound["bound_ms"], e2e_ms=e2e_ms, build_s=sponge_lib.build_seconds),
    ]}), flush=True)
    phase("done")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
