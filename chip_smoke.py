#!/usr/bin/env python3
"""Checks the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases N,N,...]

The on-card check of the port: every kernel against its plain PyTorch
version, the native oracle (``ff/native.py``: 64-bit Montgomery words in
C++ on the host, independent of the port's limb code and kernels), the
golden model and the SAGE vectors, bit for bit; the builds' spills and
the tensor-core kernels' IMMA; the launches of every main path; and the
port's programs (the CLI, the bench, the verifier, the demo, the entry),
each run as its users run it.  It times nothing: the benchmark
(``python3 -m benchmark.run``) times the cells, and
``anemoi_tpu_torch.bounds_sweep``, ``.microbench`` and ``.sass`` the
kernels alone.  Inputs are random, from ``--seed``.  Phases, each printed
with its elapsed seconds:

  1. the card: its name, and name and power limit from nvidia-smi;
  2. the builds, all started together: csrc/jive.cu, csrc/sponge.cu,
     csrc/jive_mma.cu and csrc/sponge_mma.cu with nvcc for 8 and 12 words,
     csrc/microbench.cu, and the host's byte packer with g++; each Jive,
     permutation and sponge kernel's registers and spills (ptxas); a Jive
     or one-thread permutation kernel that spills fails;
  3. the Jive kernels against the plain version, 4,099 states (the ragged
     last block among the 257 held, at both ends): Vesta 2_1 (k=2) and 4_3
     (k=2, 4) in ``jive_pasta_kernel``, BN-254 4_3 (k=2, 4) in
     ``jive_kernel``, each launch's kernel checked; the other four 20-limb
     fields' 2_1, every lane against the native oracle;
  4. the SAGE Jive vectors of the five 20-limb fields x 2 instances;
  5. full size, Vesta 2_1: the main path (a Jive over 2^20 states and a
     2^20-leaf root: every launch ``jive_pasta_kernel``, one a level);
     1,024 sampled lanes against the plain version and 65,536 (both ends)
     against the native oracle; the root again, level by level with up to
     1,024 columns of each level against the plain version; a 16-leaf root
     against the plain version's and a 2^14-leaf root against a reduction
     by the native oracle;
  6. both permutation kernels of Vesta 2_1 and 4_3 through ``permutation``
     at N = 5, 4,099, the crossover X, X - 3, X + 1 and 65,536, and through
     ``permutation_with`` each at 4,099: 257 lanes of each N (both ends)
     against the plain version and every lane up to X + 1 against the
     native oracle; the sponge over 1,024 Vesta 4_3 messages of E = 3 (all
     held), 4,099 of E = 4 and 4,099 Vesta 2_1 messages of E = 2 (257
     held), every message against a host sponge over the oracle;
  7. the SAGE hash_field and hash_bytes vectors of the 20-limb fields
     through ``.batch`` (one unpack launch a bucket) and the Vesta 2_1
     digest of b"hello world";
  8. full size, 4,096 random 10 KB messages: ``.batch.hash_bytes`` for
     Vesta 4_3 and 2_1 (one unpack and one sponge launch each), the byte
     route phase by phase with ``unpack_kernel`` against ``unpack_plain``
     on the card, ``BatchedSponge`` over the 4_3 elements in four
     rate-aligned chunks and a tail (one four-lane permutation launch a
     block) equal to hash_bytes's; 32 sampled messages an instance against
     the golden model; 65,536 messages made on the card through the sponge
     kernel (4 lanes against the golden model) and ``BatchedSponge`` over
     them (8 rate-blocks and a tail: 9 one-thread launches) equal to it;
  9. the 12-word kernels against their plain versions, 4,099 lanes (257
     held): Jive (2,2), (4,2), (4,4) for BLS12-381, both permutation
     kernels of BLS12-377 2_1 and 4_3 as in phase 6, the sponge for
     BLS12-381 4_3 (E = 3, 4) and 2_1 (E = 2);
 10. the SAGE jive, hash_field and hash_bytes vectors of BLS12-377 and
     BLS12-381 through ``.batch``;
 11. full size, BLS12-381 2_1: the main path (1 + 20 launches), 1,024
     sampled lanes against the plain version and 16,384 against the native
     oracle, the root with ``return_levels``, ``prove`` and ``verify`` for 8
     leaves and a tampered leaf that must fail; the BLS12-377 2_1 Jive over
     2^20 states, 256 lanes against the golden model and 16,384 against the
     native oracle;
 12. checkpoints: a 2^12-leaf BLS12-381 tree resumed from its lowest three
     level files: the root and levels equal the fresh run's, one launch a
     level left;
 13. phase 8 for BLS12-381 4_3 (218 elements of 47 bytes; the byte route
     also at E = 331): one unpack and one sponge launch, 73 four-lane
     permutation launches, 32 messages against the golden model, 65,536
     streams in 9 one-thread launches;
 14. the microbenchmarks' kernels: the squaring chain 8 deep against Python
     ints (Vesta, BLS12-381) and against its plain version, the multiply-add
     loop against its plain version;
 16. the CLI as a process on the card: 256 files of 8 lengths from 0 to
     10 KB for Vesta 2_1 and BLS12-381 4_3 (digests equal
     ``.batch.hash_bytes``'s, 16 the golden model's, "hello world" among
     them; its ``--stats`` launches), ``merkle`` over 2^20 - 1 elements and
     a zero leaf (the root equals ``MerkleTree.root``'s, 20 Jive launches),
     ``info`` and ``vectors``; ``AsyncByteHasher`` over phase 8's messages
     in 4 batches (4 unpack and 4 sponge launches, digests equal
     ``.batch.hash_bytes``'s); the forest over 2^20 Vesta 2_1 leaves on one
     NCCL rank (20 Jive launches, the root equal); one 2^20 Jive under
     ``utils.profiling.trace`` (the trace names the kernel) and
     ``utils.debug.check_limbs``;
 17. the programs, each a process of its own: the default bench (the
     headline and the 7 secondary configs of ``bench.py:620-660`` with
     their parity, the dry run's collectives, 2 + 2 x 12 launches of the
     arity-4 tree over 2^24 leaves; in this process the tree's first level,
     Jive-4 over 2^22 states, 257 lanes at both ends against the plain
     version and 65,536 against the native oracle, and the 14
     instantiations at 2^18 states, 4,096 lanes each against the oracle),
     the matrix (14 rows, 4 lanes held each), the verifier (ALL PASS), the
     demo (2 gloo workers and 1 NCCL rank) and the entry (bit-identical to
     its function on the CPU, one launch; ``dryrun_multichip(2)``);
 18. the tensor-core Jive kernel (``csrc/jive_mma.cu``, ``mul_impl="mxuf"``):
     IMMA in its SASS at 8 and 12 words, or the phase fails; the card's
     mma.sync m16n8k32 and m16n8k16 against the fragment layouts of
     ``ff/mxu_ops.py``; the main path (1 + 20 jive_mma launches and no
     other Jive launch; digests and root equal the default ones); 2^20
     Jives of Vesta, BLS12-381 and BLS12-377 2_1, every lane against
     ``jive_kernel`` and 65,536 against the native oracle; 4,099 states of
     5 instantiations against ``jive_kernel`` and the plain version, the
     other 20-limb fields' 2_1 against the oracle; ``bench --impl mxuf`` as
     a process (jive_mma launches only, parity ok);
 19. the tensor-core permutation and sponge (``csrc/sponge_mma.cu``): IMMA
     in the SASS of its three kernels; the main path at 8 and 12 words
     (Vesta and BLS12-381 4_3 permutations of 4,096 states, the quad form,
     and 65,536, the thread form, each on its side of
     ``PERMUTE_MMA_GROUP_MAX``; the sponge over 4,096 x 10 KB of Vesta 4_3
     and 2_1 and BLS12-381 4_3; only those kernels launched); both forms
     at 4,096 to 65,536 states against the main path's output; every lane
     against the integer kernels (ragged 4,099 states and messages of
     rate, 2 rate and rate + 1 elements among them) and 257 at both ends
     against the plain version; ``verify_cuda --mul-impl mxuf`` as a
     process (ALL PASS, each tensor-core kernel launched).

Where the plain version would take minutes (a 10 KB message is 73 to 331
permutations), outputs are held against the golden model over Python ints
on sampled lanes, or against the native oracle on thousands.  Any failure
raises; the last line, printed only when every phase passed, is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this file, it exits non-zero before printing any result.

For development, ``--phases 6,8`` runs only the phases named, with phases
1 and 2 (the device, the builds) and what they need (12 needs 11).  Such a
run prints no result line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

N_CHECK = 4099  # not a multiple of the kernel's 128-thread block
N_PLAIN = 257
N_FULL = 1 << 20
N_SAMPLE = 1024
SMALL_TREE = 1 << 4  # its root against the plain version's: one plain call per level
N_ORACLE_FULL = 1 << 16  # phase 5: lanes of the 2^20 Vesta Jive against the native oracle, half at each end
ORACLE_TREE = 1 << 14  # phase 5: a root against a reduction by the native oracle
N_ORACLE_W12 = 1 << 14  # phase 11: lanes of each 2^20 BLS12 Jive against the native oracle, half at each end
MSG_BYTES = 10 * 1024  # bench.py:210-235, bench_sponge_10kb
N_MSGS = 4096
N_MSGS_FILL = 1 << 16  # enough messages to fill the card
N_SPONGE_PLAIN = 1024
N_GOLDEN = 32

N_PROOFS = 8
N_GOLDEN_JIVE = 256
CKPT_TREE = 1 << 12
CKPT_KEEP = 3  # level files left before the resume
HELLO_WORLD = "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d"  # Vesta 2_1

# the one-thread Jive kernels of jive.cu: any modulus, and the Pasta moduli's shape (Vesta, Pallas)
JIVE_KERNELS = ("jive_kernel", "jive_pasta_kernel")
N_CLI_FILES = 256  # phase 16: files hashed by the CLI
CLI_LENGTHS = (0, 1, 31, 32, 100, 1000, 4097, MSG_BYTES)  # their byte lengths, 32 files each: 7 element counts
N_CLI_GOLDEN = 16  # of them held against the golden model
CLI_MERKLE_BYTES = (1 << 20) * 31 - 40  # packs to 2^20 - 1 Vesta elements: one zero leaf pads it to 2^20
ASYNC_BATCH = 1024  # AsyncByteHasher's batch: phase 8's 4,096 messages in 4 batches
STREAM_BLOCKS = 8  # BatchedSponge's second path: the rate-blocks it absorbs, then a tail of one element
BENCH_CONFIGS = ("multichip_dryrun_collective_bytes_per_device", "vesta_anemoi_4_3_jive_2to1",
                 "bls12_377_anemoi_2_1_jive_2to1", "vesta_anemoi_4_3_sponge_10kb", "bls12_377_anemoi_4_3_sponge_10kb",
                 "vesta_anemoi_2_1_merkle_2p20_arity2", "vesta_anemoi_4_3_merkle_2p24_arity4")  # bench.py:620-656
TREE_LEAVES = 1 << 24  # BASELINE config 4: the arity-4 Vesta 4_3 tree
MATRIX_N = 1 << 18
N_ORACLE_MATRIX = 1 << 12  # phase 17: lanes of each instantiation's Jive at MATRIX_N against the native oracle
DEMO_LEAVES = 64
MMA_IMPL = "mxuf"  # phase 18: the JAX package's default product, which selects the tensor-core Jive kernel
MMA_FIELDS = ("vesta", "bls12_381", "bls12_377")  # phase 18's full-size Jive, each 2_1 over N_FULL states
MMA_PERMS = (("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_4_3"))  # phase 19: the tensor-core permutation's cases,
MMA_PERM_NS = (N_MSGS, N_MSGS_FILL)  # at BatchedSponge's batch and a full card; N_CHECK too
MMA_SPONGES = (("vesta", "anemoi_4_3"), ("vesta", "anemoi_2_1"), ("bls12_381", "anemoi_4_3"))  # x 4,096 x 10 KB
MMA_FORM_NS = (4096, 8192, 16384, 65536)  # phase 19: both forms of the permutation at each N


def golden_hash_bytes(args) -> list:
    """The port's golden model over one message, in a worker process."""
    field, iname, data = args
    sys.path.insert(0, str(ROOT))
    from anemoi_tpu_torch.ff import golden
    from anemoi_tpu_torch.fields.params import get_instance

    return golden.hash_bytes(get_instance(field, iname), data)


ALL_PHASES = frozenset(range(1, 20)) - {15}  # no phase 15: the others keep the numbers the documents name
PHASE_NEEDS = {12: {11}}  # 12 resumes 11's tree


def run_module(module: str, *args: str) -> subprocess.Popen:
    """``python -m MODULE ARGS`` from the checkout, a process of its own."""
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))


def run_cli(*args: str) -> subprocess.Popen:
    """``python -m anemoi_tpu_torch.cli ARGS`` from the checkout, on the card."""
    return run_module("anemoi_tpu_torch.cli", *args)


def module_result(proc: subprocess.Popen, what: str, timeout: float = 600) -> list[str]:
    """Waits for a program run by ``run_module``; fails on a non-zero exit.
    Returns its lines of output."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        fail(f"{what} exited {proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    return out.splitlines()


def cli_result(proc: subprocess.Popen, what: str, timeout: float = 600) -> tuple[list[str], dict]:
    """Waits for a CLI run: its lines of output, and the launches its
    ``--stats`` line reports on standard error (empty without one)."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        fail(f"{what}: the CLI exited {proc.returncode}:\n{err[-4000:]}")
    stats = {}
    for line in err.splitlines():
        if line.startswith("seconds: "):
            launches = line.split("; launches: ")[1]
            for part in launches.replace(" (four-lane", ", four-lane").replace(")", "").split(", "):
                name, n = part.rsplit(" ", 1)
                stats[name] = int(n)
    return out.splitlines(), stats


def phase_list(text: str) -> frozenset:
    """--phases 6,8: those phases, the device and the builds (1, 2), and
    the phases they need."""
    chosen = {1, 2} | {int(x) for x in text.split(",") if x.strip()}
    if not chosen <= ALL_PHASES:
        raise argparse.ArgumentTypeError(f"phases are {', '.join(map(str, sorted(ALL_PHASES)))}")
    for n in list(chosen):
        chosen |= PHASE_NEEDS.get(n, set())
    return frozenset(chosen)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", type=phase_list, default=ALL_PHASES, metavar="N,N,...",
                    help="for development: only these phases, with the device, the builds and what they need; "
                         "such a run prints no result line")
    args = ap.parse_args()
    run = args.phases.__contains__

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import anemoi_tpu_torch as att
    from anemoi_tpu_torch import microbench as mb
    from anemoi_tpu_torch import sass
    from anemoi_tpu_torch.ff import cuda_backend, golden, native
    from anemoi_tpu_torch.ff import limb_ops as lo
    from anemoi_tpu_torch.ff.limb_ops import random_canonical
    from anemoi_tpu_torch.ff.native import canonical_host
    from anemoi_tpu_torch.fields.params import FIELD_NAMES, FIELDS_20, FIELDS_30, INSTANCE_NAMES, get_instance
    from anemoi_tpu_torch.merkle.tree import MerkleTree, level_states
    from anemoi_tpu_torch.modes.batched import (
        decode_states,
        digest_export_fn,
        digests_to_bytes,
        encode_states,
        jive_compress_batch_fn,
    )
    from anemoi_tpu_torch.modes.bytes_pipeline import bucket_messages, gather_messages
    from anemoi_tpu_torch.modes.streaming import BatchedSponge

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)

    def launches_since(before: dict) -> dict:
        """The launches since ``before = cuda_backend.launch_counts()``, by
        ``launch_counts``'s keys."""
        now = cuda_backend.launch_counts()
        return {k: now[k] - before[k] for k in now}

    def canonical_states(inst, n):
        """int32 [WIDTH, L, n] random canonical states on the card."""
        return torch.from_numpy(random_canonical(inst.field, (inst.width, n), rng).transpose(1, 0, 2).copy()).to(dev)

    def held(kernel_out, plain_out, what):
        if tuple(kernel_out.shape) != tuple(plain_out.shape):
            fail(f"{what}: shapes {tuple(kernel_out.shape)} and {tuple(plain_out.shape)}")
        err = int((kernel_out.long() - plain_out.long()).abs().max()) if kernel_out.numel() else 0
        if err:
            fail(f"{what}: kernel and plain version differ (max abs err {err})")

    sponge_msgs = None  # phase 8's messages, which phase 16 hashes again

    def oracle_jive(inst, states, k: int) -> np.ndarray:
        """Jive-k of int32 [W, L, n] Montgomery states on the card by the
        native oracle: canonical int32 [n, W/k, L]."""
        return native.threaded(native.jive_batch_canonical, inst, canonical_host(inst, states), k)

    def held_oracle(kernel_canon: np.ndarray, want: np.ndarray, what: str) -> None:
        held(torch.from_numpy(np.ascontiguousarray(kernel_canon)), torch.from_numpy(np.ascontiguousarray(want)),
             f"{what}, against the native oracle")

    # lanes held against the plain version: both ends of N_CHECK, the ragged last block among them
    lanes = torch.cat([torch.arange(N_PLAIN // 2), torch.arange(N_CHECK - (N_PLAIN - N_PLAIN // 2), N_CHECK)]).to(dev)

    def canonical_rows(inst, rows: int, n: int):
        """int32 [rows*L, n] random canonical limb rows on the card."""
        return torch.from_numpy(random_canonical(inst.field, (rows, n), rng).transpose(1, 0, 2).copy()) \
            .reshape(rows * inst.field.n_limbs, n).to(dev)

    def ends(n: int):
        """N_PLAIN lanes at both ends of n (all of them when n is smaller)."""
        return torch.cat([torch.arange(min(n, N_PLAIN // 2)),
                          torch.arange(max(n - (N_PLAIN - N_PLAIN // 2), 0), n)]).unique()

    def hold_permutation(inst) -> None:
        """Both permutation kernels against the plain version, bit for bit:
        through ``permutation`` at N = 5 (under one warp's 8 states), N_CHECK,
        the crossover X, X - 3 (ragged, the four-lane kernel), X + 1 (ragged,
        the one-thread kernel) and N_MSGS_FILL (the one-thread kernel at the
        N of BatchedSponge's second path), and through ``permutation_with``
        each kernel at N_CHECK.  Every N is a prefix of the same states, so
        one plain call over the lanes held (both ends of each N) covers them
        all, and one call of the native oracle over the first X + 1 states
        covers every lane of each N up to X + 1 (and the first X + 1 of
        N_MSGS_FILL)."""
        top = cuda_backend.permute_group_max(inst.field.kernel_words)
        ns = sorted({5, N_CHECK, top - 3, top, top + 1, N_MSGS_FILL})
        x = canonical_rows(inst, inst.width, ns[-1])
        cols = torch.cat([ends(n) for n in ns]).unique()
        plain = cuda_backend.permutation_plain(inst, x[:, cols.to(dev)].contiguous())
        at = {int(c): i for i, c in enumerate(cols)}
        runs = [(n, n <= top, "permutation", cuda_backend.permutation(inst, x[:, :n].contiguous())) for n in ns]
        runs += [(N_CHECK, g, "permutation_with", cuda_backend.permutation_with(inst, x[:, :N_CHECK].contiguous(), g))
                 for g in (True, False)]
        first = top + 1
        want = native.threaded(native.permute_batch_canonical, inst, canonical_host(inst, x[:, :first]))
        for n, group, how, out in runs:
            held_cols = ends(n)
            what = f"{inst.qualified_name} permutation, N = {n}, {'four-lane' if group else 'one-thread'} kernel"
            held(out[:, held_cols.to(dev)], plain[:, torch.tensor([at[int(c)] for c in held_cols], device=dev)], what)
            m = min(n, first)
            held_oracle(canonical_host(inst, out[:, :m]), want[:m], what)
            print(f"  {what} (through {how}): {len(held_cols)} lanes held against the plain version, "
                  f"{'all' if m == n else f'the first {m}'} against the native oracle: identical", flush=True)

    def run_stream(inst, mont, chunks):
        """BatchedSponge over int32 [E, L, B] elements: the rate-aligned chunks
        of `chunks` rate-blocks each, then the rest as the tail."""
        stream = BatchedSponge(inst, mont.shape[-1], device=dev)
        start = 0
        for n in chunks:
            stream.absorb(mont[start:start + n * inst.rate])
            start += n * inst.rate
        return stream.finalize(mont[start:])

    def unpack_route(inst, msgs, what: str) -> torch.Tensor:
        """.batch.hash_bytes's byte route over `msgs` (one bucket) step by step: ``bucket_messages``,
        ``gather_messages`` into page-locked memory, the copy to the card, and ``cuda_backend.unpack``, one launch
        of unpack_kernel, held bit for bit against ``unpack_plain`` on the card.  Returns the int32 [E, L, B]
        Montgomery elements on the card, the sponge's input."""
        lengths, buckets = bucket_messages(inst, msgs)
        (E, idxs), = buckets.items()
        data, spans = gather_messages(msgs, lengths, idxs, pin=True)
        data, spans = data.to(dev, non_blocking=True), spans.to(dev)
        before = cuda_backend.launch_counts()
        elems = cuda_backend.unpack(inst, E, data, spans)
        if launches_since(before)["unpack"] != 1:
            fail(f"{what}: unpack took {launches_since(before)['unpack']} launches, not 1")
        held(elems, cuda_backend.unpack_plain(inst, E, data, spans), f"{what}: unpack_kernel against unpack_plain")
        print(f"  {what}, the byte route over {len(msgs)} x {len(msgs[0])} bytes ({E} elements each): "
              f"unpack_kernel in one launch, equal to unpack_plain on the card bit for bit", flush=True)
        return elems

    def random_on_card(inst, rows: int, n: int, seed: int):
        """int32 [rows, L, n] random canonical elements made on the card."""
        L = inst.field.n_limbs
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(0, 1 << 13, (rows, L, n), generator=gen, device=dev, dtype=torch.int32)
        keep = np.clip(inst.field.p.bit_length() - 1 - 13 * np.arange(L), 0, 13)  # below 2^(bits(p) - 1)
        return x & torch.from_numpy(((1 << keep) - 1).astype(np.int32)).to(dev).view(1, L, 1)

    def thread_path(inst, elems, what: str) -> None:
        """BatchedSponge's second path: N_MSGS_FILL streams, above the
        crossover, so its permutations run the one-thread kernel:
        STREAM_BLOCKS rate-blocks and a tail of one element, its launches
        counted; the digests held against the sponge kernel over the same
        elements."""
        L, n = inst.field.n_limbs, elems.shape[-1]
        before = cuda_backend.launch_counts()
        digest = run_stream(inst, elems, [STREAM_BLOCKS])
        torch.cuda.synchronize()
        c = launches_since(before)
        total, group = c["permutation"], c["four_lane"]
        print(f"  main path: BatchedSponge over {n} {what} streams of {elems.shape[0]} elements (a chunk of "
              f"{STREAM_BLOCKS} rate-blocks and a tail of 1): {total} permutation launches, {group} of them four-lane, "
              f"{c['sponge']} sponge launches", flush=True)
        if total != STREAM_BLOCKS + 1 or group != 0:
            fail(f"BatchedSponge over {n} streams took {total} permutation launches, {group} four-lane")
        want = cuda_backend.sponge(inst, elems.shape[0], elems.reshape(-1, n).contiguous())
        held(digest.reshape(L, n), want, f"BatchedSponge over {n} streams against the sponge kernel")
        print("  its digests equal the sponge kernel's over the same elements", flush=True)

    def sage_jive(fields) -> None:
        for field in fields:
            for iname in ("anemoi_2_1", "anemoi_4_3"):
                inst = get_instance(field, iname)
                vec = json.loads((ROOT / "tests" / "vectors" / f"{field}_{iname}.json").read_text())
                for pair, k in zip(vec["jive"], (2, 4)):
                    want = [[int(v) for v in out] for out in pair["output"]]
                    states = encode_states(inst, [[int(v) for v in s] for s in pair["input"]], device=dev)
                    got = decode_states(inst, jive_compress_batch_fn(inst, k, device=dev)(states))
                    if got != want:
                        fail(f"SAGE vector mismatch: {field}/{iname} k={k}")
                print(f"  {field}/{iname}: {len(vec['jive'])} jive vectors exact", flush=True)

    def sage_sponge(fields) -> None:
        for field in fields:
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
                before = cuda_backend.launch_counts()
                got = obj.batch.decode_states(obj.batch.hash_bytes(data))
                buckets = len({native.num_elements(len(d), fp) for d in data} - {0})
                unpacks = launches_since(before)["unpack"]
                if unpacks != buckets:
                    fail(f"SAGE hash_bytes, {field}/{iname}: {unpacks} unpack launches for {buckets} buckets")
                if got != [[int(w) for w in want] for want in vec["hash_bytes"]["output"]]:
                    fail(f"SAGE hash_bytes mismatch: {field}/{iname}")
                print(f"  {field}/{iname}: {len(vec['hash_field']['input'])} hash_field and {len(data)} "
                      f"hash_bytes vectors exact; {buckets} unpack launches, one a bucket", flush=True)

    def hash_bytes_path(objs: dict, msgs: list, what: str, crossover: int):
        """Phases 8 and 13's main path over `msgs` (one bucket): ``.batch.hash_bytes`` for each instance of
        `objs` (one unpack and one sponge launch each), the byte route step by step for the first, and
        ``BatchedSponge`` over its elements in 4 rate-aligned chunks and the tail (one permutation launch a
        block, all four-lane at N_MSGS messages up to the crossover), equal to hash_bytes's.  Returns the
        digests by instance name and the first instance's elements on the card."""
        first = next(iter(objs.values())).params
        L, rate = first.field.n_limbs, first.rate
        E = native.num_elements(len(msgs[0]), first.field)
        blocks = E // rate
        chunks = [blocks // 4 + (i < blocks % 4) for i in range(4)]  # rate-blocks per chunk
        torch.cuda.synchronize()
        before = cuda_backend.launch_counts()
        full = {iname: obj.batch.hash_bytes(msgs) for iname, obj in objs.items()}
        c = launches_since(before)
        if c["unpack"] != len(objs):
            fail(f"hash_bytes took {c['unpack']} unpack launches for {len(objs)} calls of one bucket")
        if c["sponge"] != len(objs):
            fail(f"hash_bytes took {c['sponge']} sponge launches for {len(objs)} calls")
        mont = unpack_route(first, msgs, what)
        streamed = run_stream(first, mont, chunks)
        torch.cuda.synchronize()
        c = launches_since(before)
        print(f"  main path: hash_bytes for {', '.join(f'{what}/{i}' for i in objs)} over {len(msgs)} x {len(msgs[0])} "
              f"bytes ({E} elements each), BatchedSponge over the first's in chunks of {chunks} rate-blocks and a "
              f"tail of {E - sum(chunks) * rate}: {c['unpack']} unpack and {c['sponge']} sponge launches, "
              f"{c['permutation']} permutation launches ({c['four_lane']} four-lane), {c['jive']} Jive launches",
              flush=True)
        if c["permutation"] != blocks + (E % rate > 0):
            fail(f"BatchedSponge took {c['permutation']} permutation launches for {blocks} blocks and a tail")
        if c["four_lane"] != (c["permutation"] if len(msgs) <= crossover else 0):
            fail(f"{c['four_lane']} of {c['permutation']} permutation launches went to the four-lane kernel")
        for iname, out in full.items():
            if out.shape != (1, L, len(msgs)):
                fail(f"{iname}: digests of shape {out.shape}")
        held(streamed.cpu(), torch.from_numpy(next(iter(full.values()))), "BatchedSponge against hash_bytes")
        print("  BatchedSponge digests equal hash_bytes's", flush=True)
        return full, mont

    def golden_sample(field: str, objs: dict, full: dict, msgs: list) -> None:
        """N_GOLDEN sampled messages of each instance against the golden model, in one worker process per
        core (a 10 KB message takes it 0.5 to 1 s)."""
        picks = sorted(rng.choice(len(msgs), N_GOLDEN, replace=False).tolist())
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
            for iname, out in full.items():
                want = pool.map(golden_hash_bytes, [(field, iname, msgs[i]) for i in picks])
                if decode_states(objs[iname].params, out[:, :, picks]) != want:
                    fail(f"{field}/{iname}: sampled 10 KB digests differ from the golden model")
                print(f"  {field}/{iname}: {N_GOLDEN} sampled messages held against the golden model: identical",
                      flush=True)

    # 1 ---------------------------------------------------------------------
    if run(1):
        phase("1 device")
        kind = torch.cuda.get_device_name(0)
        print(f"device: {kind}, {torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        print(nvidia_smi("name,power.limit"), flush=True)

    # 2 ---------------------------------------------------------------------
    if run(2):
        phase("2 build")
        builds = {
            "jive.cu, 8 words": lambda: cuda_backend.library(8),
            "jive.cu, 12 words": lambda: cuda_backend.library(12),
            "sponge.cu, 8 words": lambda: cuda_backend.sponge_library(8),
            "sponge.cu, 12 words": lambda: cuda_backend.sponge_library(12),
            "microbench.cu": mb.library,
            "jive_mma.cu, 8 words": lambda: cuda_backend.mma_library(8),
            "jive_mma.cu, 12 words": lambda: cuda_backend.mma_library(12),
            "sponge_mma.cu, 8 words": lambda: cuda_backend.sponge_mma_library(8),
            "sponge_mma.cu, 12 words": lambda: cuda_backend.sponge_mma_library(12),
        }
        with ThreadPoolExecutor(len(builds) + 1) as pool:  # one compiler process per build, all at once
            jobs = {name: pool.submit(fn) for name, fn in builds.items()}
            packer = pool.submit(native.library)
            built = {name: job.result() for name, job in jobs.items()}
            packer.result()
        mma_libs = {w: built[f"jive_mma.cu, {w} words"] for w in (8, 12)}  # phase 18 reads them
        sponge_mma_libs = {w: built[f"sponge_mma.cu, {w} words"] for w in (8, 12)}  # phase 19 reads them
        for name, b in built.items():
            print(f"build: {name}: {b.path.name}", flush=True)
        crossover = {w: cuda_backend.permute_group_max(w) for w in cuda_backend.KERNEL_WORDS}
        print(f"kernels by ptxas (registers, spill store and load bytes); the permutation launches its four-lane "
              f"kernel up to {crossover[8]} states at 8 words and {crossover[12]} at 12:", flush=True)
        for words in cuda_backend.KERNEL_WORDS:
            for b in (built[f"jive.cu, {words} words"], built[f"sponge.cu, {words} words"]):
                for name, (regs, st, ld) in sorted(sass.ptxas_table(b.ptxas).items()):
                    print(f"  {words} words, {name}: {regs} registers, spills {st}/{ld} bytes", flush=True)
                    if name.startswith((*JIVE_KERNELS, "permute_kernel")) and st + ld:
                        fail(f"{name} at {words} words spills ({st}/{ld} bytes): the one-thread kernels build "
                             f"without spills")

    # 3 ---------------------------------------------------------------------
    if run(3):
        phase("3 kernel vs plain version")
        # each 8-word kernel at both widths: Vesta's modulus takes jive_pasta_kernel, BN-254's jive_kernel
        cases = [("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 2), ("vesta", "anemoi_4_3", 4),
                 ("bn_254", "anemoi_4_3", 2), ("bn_254", "anemoi_4_3", 4)]
        for field, iname, k in cases:
            inst = get_instance(field, iname)
            W, L = inst.width, inst.field.n_limbs
            x = canonical_states(inst, N_CHECK).reshape(W * L, N_CHECK)
            before = cuda_backend.launch_counts()
            out = cuda_backend.jive(inst, k, x)
            kernel = JIVE_KERNELS[launches_since(before)["jive_pasta"]]
            if kernel != JIVE_KERNELS[field == "vesta"]:
                fail(f"{field}/{iname} k={k} went to {kernel}")
            held(out[:, lanes], cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()), f"{field}/{iname} k={k}")
            if out.min() < 0 or out.max() >= 1 << 13:
                fail(f"{field}/{iname} k={k}: limbs outside 13 bits")
            print(f"  {field}/{iname} k={k} ({kernel}<{W},{k}>): {N_CHECK} lanes, {N_PLAIN} held against the "
                  f"plain version: identical", flush=True)
        # the other 20-limb fields at width 2 with their own constants (Pallas
        # in jive_pasta_kernel as Vesta, the others in jive_kernel as BN-254);
        # every lane goes to the native oracle, whose calls cost a millisecond
        # a lane on one core where the plain version's cost seconds
        for field in FIELDS_20:
            if field == "vesta":
                continue
            inst = get_instance(field, "anemoi_2_1")
            states = canonical_states(inst, N_CHECK)
            out = jive_compress_batch_fn(inst, 2, device=dev)(states)
            held_oracle(canonical_host(inst, out), oracle_jive(inst, states, 2), f"{field}/anemoi_2_1 k=2")
            print(f"  {field}/anemoi_2_1 k=2: all {N_CHECK} lanes held against the native oracle: identical",
                  flush=True)

    # 4 ---------------------------------------------------------------------
    if run(4):
        phase("4 SAGE vectors")
        sage_jive(FIELDS_20)

    # 5 ---------------------------------------------------------------------
    if run(5):
        phase("5 full size: Vesta anemoi_2_1")
        inst = get_instance("vesta", "anemoi_2_1")
        W, L = inst.width, inst.field.n_limbs
        compress = jive_compress_batch_fn(inst, 2, device=dev)
        tree = MerkleTree(inst, device=dev)
        states = canonical_states(inst, N_FULL)
        leaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
        torch.cuda.synchronize()

        before = cuda_backend.launch_counts()
        digests = compress(states)
        before_root = cuda_backend.launch_counts()
        root = tree.root(leaves)
        torch.cuda.synchronize()
        c = launches_since(before)
        launches, root_launches = c["jive"], launches_since(before_root)["jive"]
        print(f"  main path: Jive over {N_FULL} states and a {N_FULL}-leaf root: {launches} kernel launches "
              f"({root_launches} for the root), {c['jive_pasta']} of them jive_pasta_kernel", flush=True)
        if launches == 0:
            fail("the main path launched no kernel")
        if c["jive_pasta"] != launches:
            fail(f"Vesta took jive_pasta_kernel in {c['jive_pasta']} of {launches} launches")
        if root_launches != tree.num_levels(N_FULL):
            fail(f"the root took {root_launches} launches for {tree.num_levels(N_FULL)} levels")
        if tuple(digests.shape) != (1, L, N_FULL) or tuple(root.shape) != (L, 1):
            fail(f"shapes {tuple(digests.shape)}, {tuple(root.shape)}")

        sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
        xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
        held(digests.reshape(L, N_FULL)[:, sample], cuda_backend.jive_plain(inst, 2, xs), "2^20 Jive, sampled lanes")
        print(f"  {N_SAMPLE} sampled lanes held against the plain version: identical", flush=True)
        half = N_ORACLE_FULL // 2
        cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
        held_oracle(canonical_host(inst, digests[:, :, cols]), oracle_jive(inst, states[:, :, cols], 2),
                    f"2^20 Jive, {N_ORACLE_FULL} lanes")
        print(f"  {N_ORACLE_FULL} lanes ({half} at each end) held against the native oracle: identical", flush=True)

        held(tree.root(leaves), root, "2^20 root, repeated")
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
        print(f"  the root again equal; {sum(t.shape[1] for t in ins)} columns from all {len(ins)} levels of the "
              f"{N_FULL}-leaf root held against the plain version: identical", flush=True)

        small = leaves[:, :SMALL_TREE].contiguous()
        level = small
        while level.shape[1] > 1:
            level = cuda_backend.jive_plain(inst, 2, level_states(level, 2))
        held(tree.root(small), level, f"{SMALL_TREE}-leaf root")
        print(f"  {SMALL_TREE}-leaf root held against the plain version's: identical", flush=True)
        first = leaves[:, :ORACLE_TREE].contiguous()
        want = native.tree_levels(inst, canonical_host(inst, first)[:, 0])[-1][0]
        held_oracle(canonical_host(inst, tree.root(first))[0, 0], want, f"{ORACLE_TREE}-leaf root")
        print(f"  {ORACLE_TREE}-leaf root (the first leaves) held against a reduction by the native oracle: "
              f"identical", flush=True)

    # 6 ---------------------------------------------------------------------
    if run(6):
        phase("6 permutation and sponge kernels vs plain version")
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            hold_permutation(get_instance("vesta", iname))
        # 1,024 messages all held; then 4,099, which fill neither the last warp (8 messages) nor the last
        # block (32), with 257 held at both ends
        for iname, E, n in (("anemoi_4_3", 3, N_SPONGE_PLAIN), ("anemoi_4_3", 4, N_CHECK), ("anemoi_2_1", 2, N_CHECK)):
            inst = get_instance("vesta", iname)
            m = canonical_rows(inst, E, n)
            out = cuda_backend.sponge(inst, E, m)
            cols = lanes if n == N_CHECK else torch.arange(n, device=dev)
            held(out[:, cols], cuda_backend.sponge_plain(inst, E, m[:, cols].contiguous()),
                 f"vesta/{iname} sponge E={E}")
            want = native.host_sponge(inst, canonical_host(inst, m))
            held_oracle(canonical_host(inst, out), want, f"vesta/{iname} sponge E={E}")
            print(f"  sponge, vesta/{iname}, E={E}: {n} messages, {len(cols)} held against the plain version, all "
                  f"{n} against a host sponge over the native oracle's permutation: identical", flush=True)

    # 7 ---------------------------------------------------------------------
    if run(7):
        phase("7 SAGE sponge vectors and the hello-world digest, through .batch")
        sage_sponge(FIELDS_20)
        two = att.vesta.anemoi_2_1
        hello = torch.from_numpy(two.batch.hash_bytes([b"hello world"])).to(dev)
        hello_hex = digests_to_bytes(two.params, digest_export_fn(two.params)(hello))[0].hex()
        if hello_hex != HELLO_WORLD:
            fail(f"vesta/anemoi_2_1 digest of b'hello world' is {hello_hex}, not {HELLO_WORLD}")
        print(f"  vesta/anemoi_2_1 hash_bytes(b'hello world') -> export -> bytes: {hello_hex}", flush=True)

    # 8 ---------------------------------------------------------------------
    if run(8):
        phase(f"8 full size: the sponge over {N_MSGS} messages of {MSG_BYTES} bytes")
        objs = {iname: att.instance("vesta", iname) for iname in ("anemoi_4_3", "anemoi_2_1")}
        msgs = sponge_msgs = [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
        full, mont = hash_bytes_path(objs, msgs, "vesta", crossover[8])
        golden_sample("vesta", objs, full, msgs)

        # the card filled: 65,536 Vesta 4_3 messages made on the card
        inst = objs["anemoi_4_3"].params
        E, L = mont.shape[0], inst.field.n_limbs
        del mont
        big = random_on_card(inst, E, N_MSGS_FILL, args.seed).reshape(E * L, N_MSGS_FILL)
        fill_out = cuda_backend.sponge(inst, E, big)
        cols = [0, 1, N_MSGS_FILL // 2, N_MSGS_FILL - 1]
        elems = big.reshape(E, L, N_MSGS_FILL)[:, :, cols].cpu()
        for j, col in enumerate(cols):
            message = lo.decode_ints(elems[:, :, j].T.contiguous(), inst.field)
            if lo.decode_ints(fill_out[:, col:col + 1], inst.field) != golden.hash_field(inst, message):
                fail(f"65,536-message sponge: lane {col} differs from the golden model")
        print(f"  vesta/anemoi_4_3, {N_MSGS_FILL} messages made on the card through the sponge kernel: lanes {cols} "
              f"held against the golden model: identical", flush=True)
        thread_path(inst, big.reshape(E, L, N_MSGS_FILL)[:STREAM_BLOCKS * inst.rate + 1], "random")
        del big, fill_out

    # 9 ---------------------------------------------------------------------
    if run(9):
        phase("9 the 12-word kernels vs plain version")
        for field, iname, k in (("bls12_381", "anemoi_2_1", 2), ("bls12_381", "anemoi_4_3", 2),
                                ("bls12_381", "anemoi_4_3", 4)):
            inst = get_instance(field, iname)
            x = canonical_rows(inst, inst.width, N_CHECK)
            out = cuda_backend.jive(inst, k, x)
            held(out[:, lanes], cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()), f"{field}/{iname} k={k}")
            print(f"  Jive, {field}/{iname} k={k}: {N_CHECK} lanes, {N_PLAIN} held against the plain version: "
                  f"identical", flush=True)
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            hold_permutation(get_instance("bls12_377", iname))
        for iname, E in (("anemoi_4_3", 3), ("anemoi_4_3", 4), ("anemoi_2_1", 2)):
            inst = get_instance("bls12_381", iname)
            m = canonical_rows(inst, E, N_CHECK)
            out = cuda_backend.sponge(inst, E, m)
            held(out[:, lanes], cuda_backend.sponge_plain(inst, E, m[:, lanes].contiguous()),
                 f"bls12_381/{iname} sponge E={E}")
            print(f"  sponge, bls12_381/{iname}, E={E}: {N_CHECK} messages, {N_PLAIN} held against the plain version: "
                  f"identical", flush=True)

    # 10 --------------------------------------------------------------------
    if run(10):
        phase("10 SAGE vectors of the 30-limb fields, through .batch")
        sage_jive(FIELDS_30)
        sage_sponge(FIELDS_30)

    # 11 --------------------------------------------------------------------
    if run(11):
        phase("11 full size: BLS12-381 anemoi_2_1")
        inst = get_instance("bls12_381", "anemoi_2_1")
        W, L = inst.width, inst.field.n_limbs
        compress = jive_compress_batch_fn(inst, 2, device=dev)
        tree = MerkleTree(inst, device=dev)
        states = canonical_states(inst, N_FULL)
        leaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
        torch.cuda.synchronize()

        before = cuda_backend.launch_counts()
        digests = compress(states)
        before_root = cuda_backend.launch_counts()
        root = tree.root(leaves)
        torch.cuda.synchronize()
        launches, root_launches = launches_since(before)["jive"], launches_since(before_root)["jive"]
        print(f"  main path: Jive over {N_FULL} states and a {N_FULL}-leaf root: {launches} kernel launches "
              f"({root_launches} for the root)", flush=True)
        if launches != 1 + tree.num_levels(N_FULL):
            fail(f"the main path took {launches} launches, not 1 + {tree.num_levels(N_FULL)}")
        if tuple(digests.shape) != (1, L, N_FULL) or tuple(root.shape) != (L, 1):
            fail(f"shapes {tuple(digests.shape)}, {tuple(root.shape)}")

        sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
        xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
        held(digests.reshape(L, N_FULL)[:, sample], cuda_backend.jive_plain(inst, 2, xs),
             "BLS12-381 2^20 Jive, sampled lanes")
        print(f"  {N_SAMPLE} sampled lanes held against the plain version: identical", flush=True)
        half = N_ORACLE_W12 // 2
        oracle_cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
        held_oracle(canonical_host(inst, digests[:, :, oracle_cols]), oracle_jive(inst, states[:, :, oracle_cols], 2),
                    "BLS12-381 2^20 Jive")
        print(f"  {N_ORACLE_W12} lanes ({half} at each end) held against the native oracle: identical", flush=True)

        root2, levels = tree.root(leaves, return_levels=True)
        held(root2, root, "BLS12-381 2^20 root with return_levels")
        if len(levels) != tree.num_levels(N_FULL) + 1 or not torch.equal(levels[-1], root):
            fail("return_levels: wrong levels")
        print(f"  Merkle root over {N_FULL} leaves with return_levels: equal to the root; {len(levels)} levels on "
              f"{levels[1].device}", flush=True)
        picks = [0, N_FULL - 1] + sorted(rng.choice(np.arange(1, N_FULL - 1), N_PROOFS - 2, replace=False).tolist())
        for idx in picks:
            path = tree.prove(levels, idx)
            if len(path) != tree.num_levels(N_FULL) or not tree.verify(root, leaves[:, idx], idx, path):
                fail(f"the proof of leaf {idx} does not verify")
        path = tree.prove(levels, picks[2])
        if tree.verify(root, leaves[:, picks[2] ^ 1], picks[2], path):
            fail("a tampered leaf verified")
        print(f"  prove and verify (golden model) for leaves {picks}: all verify; leaf {picks[2] ^ 1} in place of "
              f"{picks[2]} fails", flush=True)
        del states, digests, levels, root2

        inst = get_instance("bls12_377", "anemoi_2_1")
        states = canonical_states(inst, N_FULL)
        out = jive_compress_batch_fn(inst, 2, device=dev)(states)
        cols = np.sort(rng.choice(N_FULL, N_GOLDEN_JIVE, replace=False))
        ins = decode_states(inst, states[:, :, torch.from_numpy(cols).to(dev)])
        got = decode_states(inst, out[:, :, torch.from_numpy(cols).to(dev)])
        if got != [golden.jive_compress_k(inst, s, 2) for s in ins]:
            fail("BLS12-377 2^20 Jive: sampled lanes differ from the golden model")
        held_oracle(canonical_host(inst, out[:, :, oracle_cols]), oracle_jive(inst, states[:, :, oracle_cols], 2),
                    "BLS12-377 2^20 Jive")
        print(f"  BLS12-377 Jive 2-to-1, {N_FULL} states: {N_GOLDEN_JIVE} sampled lanes held against the golden "
              f"model and {N_ORACLE_W12} ({half} at each end) against the native oracle: identical", flush=True)
        del states, out

    # 12 --------------------------------------------------------------------
    if run(12):
        phase(f"12 checkpoints on the card: a {CKPT_TREE}-leaf BLS12-381 tree")
        small = leaves[:, :CKPT_TREE].contiguous()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = Path(tmp) / "ckpt"
            fresh_root, fresh = tree.root(small, return_levels=True, checkpoint_dir=ckpt)
            n_files = len(list(ckpt.glob("level_*.npy")))
            for lv in range(CKPT_KEEP + 1, tree.num_levels(CKPT_TREE) + 1):
                (ckpt / f"level_{lv}.npy").unlink()
            before = cuda_backend.launch_counts()
            resumed_root, resumed = tree.root(small, return_levels=True, checkpoint_dir=ckpt)
            resumed_launches = launches_since(before)["jive"]
        held(resumed_root, fresh_root, "resumed root")
        if len(resumed) != len(fresh) or not all(torch.equal(a, b) for a, b in zip(resumed, fresh)):
            fail("the resumed levels differ from the fresh ones")
        if resumed_launches != tree.num_levels(CKPT_TREE) - CKPT_KEEP or resumed[1].device != dev:
            fail(f"the resume took {resumed_launches} launches")
        print(f"  {n_files} level files written; all but the lowest {CKPT_KEEP} deleted; the resume loaded those onto "
              f"{resumed[1].device}, took {resumed_launches} launches, and its root and {len(resumed)} levels equal the "
              f"fresh run's", flush=True)
        del leaves, small

    # 13 --------------------------------------------------------------------
    if run(13):
        phase(f"13 full size: the BLS12-381 anemoi_4_3 sponge over {N_MSGS} messages of {MSG_BYTES} bytes")
        objs = {"anemoi_4_3": att.bls12_381.anemoi_4_3}
        inst = objs["anemoi_4_3"].params
        msgs = [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
        full, mont = hash_bytes_path(objs, msgs, "bls12_381", crossover[12])
        del mont
        # and at the 20-limb fields' E: 331 elements of 47 bytes, the last of 10
        unpack_route(inst, [rng.bytes(330 * inst.field.byte_chunk + 10) for _ in range(N_MSGS)], "bls12_381, E = 331")
        golden_sample("bls12_381", objs, full, msgs)
        # BatchedSponge above the crossover: the one-thread kernel's path
        thread_path(inst, random_on_card(inst, STREAM_BLOCKS * inst.rate + 1, N_MSGS_FILL, args.seed + 1), "random")

    # 14 --------------------------------------------------------------------
    if run(14):
        phase("14 the microbenchmarks' kernels")
        for field in ("vesta", "bls12_381"):
            fp = get_instance(field, "anemoi_2_1").field
            mb.check_chain(field, N_PLAIN, dev, seed=args.seed)
            x = torch.from_numpy(random_canonical(fp, (8,), rng)).to(dev)
            held(mb.sqr_chain(fp, x, 8), mb.sqr_chain_plain(fp, x, 8), f"{field} squaring chain")
            print(f"  squaring chain, {field}: 8-deep chain exact on {N_PLAIN} lanes against Python ints, and on 8 "
                  f"lanes against the plain version", flush=True)
        x = torch.from_numpy(np.random.default_rng(args.seed).integers(1, 1000, size=(20, 512), dtype=np.int32))
        held(mb.mad_loop(x.to(dev), 100), mb.mad_loop_plain(x.to(dev), 100), "multiply-add loop")
        print("  multiply-add loop: 10,240 elements x 100 iterations held against the plain version: identical",
              flush=True)

    # 16 --------------------------------------------------------------------
    if run(16):
        phase("16 full width: the CLI, AsyncByteHasher, the forest and the utils")
        import torch.distributed as dist

        from anemoi_tpu_torch.dist import forest, mesh
        from anemoi_tpu_torch.modes.async_pipeline import AsyncByteHasher
        from anemoi_tpu_torch.utils import debug, profiling

        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            files = [tmp / f"m{i:03d}.bin" for i in range(N_CLI_FILES)]
            for i, f in enumerate(files):
                f.write_bytes(b"hello world" if i == 0 else rng.bytes(CLI_LENGTHS[i % len(CLI_LENGTHS)]))
            data = [f.read_bytes() for f in files]
            merkle_file = tmp / "merkle.bin"
            merkle_file.write_bytes(rng.bytes(CLI_MERKLE_BYTES))
            hash_cases = (("vesta", "anemoi_2_1"), ("bls12_381", "anemoi_4_3"))
            # the CLI runs as its users run it: a process of its own on the card; hash, info and vectors at once
            procs = {case: run_cli("hash", "--field", case[0], "--instance", case[1], "--stats", *map(str, files))
                     for case in hash_cases}
            procs["info"], procs["vectors"] = run_cli("info"), run_cli("vectors")
            # the references while the CLI runs: the golden model on 16 files, .batch.hash_bytes on all
            picks = list(range(1, 1 + N_CLI_GOLDEN))  # every length twice
            with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
                gold = pool.map(golden_hash_bytes, [(*case, data[i]) for case in hash_cases for i in picks])
            ours = {case: att.instance(*case).batch.hash_bytes(data) for case in hash_cases}
            results = {key: cli_result(proc, f"cli {key}") for key, proc in procs.items()}
            for j, (field, iname) in enumerate(hash_cases):
                obj = att.instance(field, iname)
                inst, fp = obj.params, obj.params.field
                lines, stats = results[(field, iname)]
                canon = digest_export_fn(inst)(torch.from_numpy(ours[(field, iname)]).to(dev))
                want = [b.hex() for b in digests_to_bytes(inst, canon)]
                if lines != want:
                    fail(f"cli hash {field}/{iname}: digests differ from .batch.hash_bytes's")
                want = [golden.digest_to_bytes(inst, g).hex() for g in gold[j * len(picks):(j + 1) * len(picks)]]
                if [lines[i] for i in picks] != want:
                    fail(f"cli hash {field}/{iname}: digests differ from the golden model")
                counts = {native.num_elements(len(d), fp) for d in data} - {0}
                launches = {"sponge": sum(e >= inst.rate for e in counts), "permutation": sum(e < inst.rate for e in counts),
                            "unpack": len(counts)}
                if any(stats[k] != v for k, v in launches.items()) or stats["jive"]:
                    fail(f"cli hash {field}/{iname}: launches {stats}, expected {launches}")
                print(f"  cli hash, {field}/{iname}: {N_CLI_FILES} files of {len(CLI_LENGTHS)} lengths from 0 to "
                      f"{MSG_BYTES} bytes ({len(counts) + 1} element counts): digests equal .batch.hash_bytes's, "
                      f"{N_CLI_GOLDEN} the golden model's; {stats['unpack']} unpack, {stats['sponge']} sponge and "
                      f"{stats['permutation']} permutation launches", flush=True)
            if results[hash_cases[0]][0][0] != HELLO_WORLD:
                fail(f"cli hash of b'hello world': {results[hash_cases[0]][0][0]}, not {HELLO_WORLD}")
            print(f"  cli hash of b'hello world', vesta/anemoi_2_1: {HELLO_WORLD}", flush=True)
            print(f"  cli info: {results['info'][0][0]}; cli vectors: {len(results['vectors'][0])} files, exit 0",
                  flush=True)

            lines, stats = cli_result(run_cli("merkle", "--stats", str(merkle_file)), "cli merkle")
            inst = get_instance("vesta", "anemoi_2_1")
            fp = inst.field
            packed = native.pack_bytes(merkle_file.read_bytes(), fp)
            if packed.shape[0] != N_FULL - 1:
                fail(f"{CLI_MERKLE_BYTES} bytes packed to {packed.shape[0]} elements")
            leaves = np.zeros((fp.n_limbs, N_FULL), dtype=np.int32)
            leaves[:, : packed.shape[0]] = packed.T
            leaves = lo.to_mont(torch.from_numpy(leaves).to(dev), lo.field_consts(fp))
            want = golden.digest_to_bytes(inst, lo.decode_ints(MerkleTree(inst, device=dev).root(leaves), fp)).hex()
            if lines != [want] or stats["jive"] != 20:
                fail(f"cli merkle: root {lines} against {want}, {stats['jive']} Jive launches")
            print(f"  cli merkle, {CLI_MERKLE_BYTES} bytes ({N_FULL - 1} elements and one zero leaf): root equals "
                  f"MerkleTree.root's over the same leaves, {stats['jive']} Jive launches", flush=True)
            del leaves

        # AsyncByteHasher over phase 8's messages in 4 batches, against .batch.hash_bytes
        msgs = sponge_msgs or [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
        obj = att.vesta.anemoi_4_3
        inst = obj.params
        batches = [msgs[i:i + ASYNC_BATCH] for i in range(0, N_MSGS, ASYNC_BATCH)]
        pipe, got = AsyncByteHasher(inst, device=dev), []
        before = cuda_backend.launch_counts()
        for batch in batches:
            got.extend(pipe.feed(batch))
        got.extend(pipe.drain())
        c = launches_since(before)
        if (c["unpack"], c["sponge"], c["permutation"]) != (len(batches), len(batches), 0):
            fail(f"AsyncByteHasher took launches {c} for {len(batches)} batches")
        want = digest_export_fn(inst)(torch.from_numpy(obj.batch.hash_bytes(msgs)).to(dev)).cpu().numpy()
        if len(got) != len(batches) or not np.array_equal(np.concatenate(got, axis=2), want):
            fail("AsyncByteHasher's digests differ from .batch.hash_bytes's")
        for d in got:
            debug.check_limbs(d, inst.field, what="AsyncByteHasher digests")
        print(f"  AsyncByteHasher, vesta/anemoi_4_3, {N_MSGS} x {MSG_BYTES} bytes in {len(batches)} batches of "
              f"{ASYNC_BATCH}: {c['unpack']} unpack and {c['sponge']} sponge launches; digests equal "
              f".batch.hash_bytes's and pass check_limbs", flush=True)

        # the forest: world size 1 on NCCL, through a file:// store
        inst = get_instance("vesta", "anemoi_2_1")
        fleaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
        with tempfile.TemporaryDirectory() as store:
            mesh.initialize_distributed(init_method=f"file://{store}/store", world_size=1, rank=0, timeout=300)
            try:
                chips = mesh.chip_mesh()
                fn = forest.sharded_merkle_root_fn(inst, chips, N_FULL)
                local = mesh.shard_batch(fleaves, chips)
                torch.cuda.synchronize()
                before = cuda_backend.launch_counts()
                froot = fn(local)
                torch.cuda.synchronize()
                forest_launches = launches_since(before)["jive"]
                held(froot, MerkleTree(inst, device=dev).root(fleaves), "the forest's root")
                if forest_launches != 20:
                    fail(f"the forest took {forest_launches} Jive launches, not 20")
                traffic = mesh.collective_traffic(fn, local)
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
        print(f"  the forest, {N_FULL} Vesta 2_1 leaves over 1 rank ({backend}, file:// store): root equals "
              f"MerkleTree.root's, {forest_launches} Jive launches; collective_traffic: {json.dumps(traffic)}",
              flush=True)

        # the utils: one 2^20 Jive under trace, its digests through check_limbs
        states = canonical_states(inst, N_FULL)
        compress = jive_compress_batch_fn(inst, 2, device=dev)
        untraced = compress(states)
        torch.cuda.synchronize()
        before = cuda_backend.launch_counts()
        with tempfile.TemporaryDirectory() as tdir:
            with profiling.trace(tdir) as prof:
                traced = compress(states)
                torch.cuda.synchronize()
            trace_launches = launches_since(before)["jive"]
            events = json.loads(prof.trace_path.read_text())["traceEvents"]
        names = sorted({name for e in events if any(k in (name := str(e.get("name", ""))) for k in JIVE_KERNELS)})
        if not names or trace_launches != 1:
            fail(f"the trace names no Jive kernel ({trace_launches} launches)")
        held(traced, untraced, "the traced Jive")
        canon = digest_export_fn(inst)(traced)
        debug.check_limbs(canon, inst.field, what="the traced Jive's canonical digests")
        print(f"  trace of one {N_FULL}-state Jive: {len(events)} events, the kernel named {names}; its canonical "
              f"digests pass check_limbs", flush=True)
        del states, untraced, traced, canon, fleaves

    # 17 --------------------------------------------------------------------
    if run(17):
        phase("17 the bench, the matrix, the verifier, the entry and the demo, each a process of its own")
        from anemoi_tpu_torch import graft_entry
        from anemoi_tpu_torch.bench import _ROW, HEADLINE

        # the default bench, alone on the card and the host (its dry run takes the host's cores)
        lines = module_result(run_module("anemoi_tpu_torch.bench"), "the bench", timeout=900)
        docs = [json.loads(line) for line in lines if line.startswith("{")]
        head, doc = docs[0], docs[-1]
        if set(head) != {"metric", "value", "unit", "vs_baseline"} or head["metric"] != HEADLINE or \
                {k: doc.get(k) for k in head} != head:
            fail(f"the bench's first line {head} is not the headline of its last")
        configs = {c["metric"]: c for c in doc["configs"]}
        if [m for m in BENCH_CONFIGS if m not in configs] or len(configs) != len(BENCH_CONFIGS):
            fail(f"the bench reported {sorted(configs)}, not the {len(BENCH_CONFIGS)} configs of bench.py:620-656")
        for c in [doc, *configs.values()]:
            if not (c["value"] > 0 and c.get("parity") == "ok" and c.get("parity_lanes", 0) > 0):
                fail(f"the bench's {c['metric']}: value {c['value']}, parity {c.get('parity')}")
        dry = configs["multichip_dryrun_collective_bytes_per_device"]
        if dry["value"] != dry["n_devices"] * 20 * 4 or dry["collective_counts"] != {"all-gather": 1}:
            fail(f"the dry run's collectives: {dry}")
        tree = configs["vesta_anemoi_4_3_merkle_2p24_arity4"]
        if tree["launches"]["jive"] != 2 + 2 * 12:
            fail(f"the 2^24-leaf tree took {tree['launches']['jive']} Jive launches, not 2 + 2 x 12")
        print(f"  the bench (python3 -m anemoi_tpu_torch.bench, {doc['device']}): the headline and "
              f"{len(configs)} configs, each with its parity ok ({doc['parity_lanes']} lanes of the headline held); "
              f"the dry run's collectives {dry['collective_counts']}; the arity-4 tree over {TREE_LEAVES} leaves "
              f"{tree['launches']['jive']} Jive launches (a 16-leaf warm-up and 2 x 12 levels), "
              f"{tree['parity_lanes']} nodes held against the golden model", flush=True)

        # the tree's first level again, in this process from the bench's leaves (seed 0): Jive-4 over 2^22 states,
        # N_PLAIN lanes at both ends against the plain version and N_ORACLE_FULL against the native oracle
        inst = get_instance("vesta", "anemoi_4_3")
        leaves = torch.from_numpy(random_canonical(inst.field, (TREE_LEAVES,), np.random.default_rng(0))).to(dev)
        x = level_states(leaves, 4)
        del leaves
        n4 = x.shape[1]
        level1 = cuda_backend.jive(inst, 4, x)
        torch.cuda.synchronize()
        cols = ends(n4)
        held(level1[:, cols], cuda_backend.jive_plain(inst, 4, x[:, cols].contiguous()),
             f"the 2^24-leaf tree's first level, {n4} Jive-4 states, both ends")
        half = N_ORACLE_FULL // 2
        cols = torch.cat([torch.arange(half), torch.arange(n4 - half, n4)]).to(dev)
        held_oracle(canonical_host(inst, level1[:, cols]), oracle_jive(inst, x[:, cols], 4),
                    f"the tree's first level, {N_ORACLE_FULL} lanes")
        print(f"  the tree's first level in this process (the bench's leaves): Jive-4 over {n4} states, {N_PLAIN} "
              f"lanes at both ends held against the plain version, {N_ORACLE_FULL} ({half} at each end) against the "
              f"native oracle: identical", flush=True)
        del x, level1

        # the matrix's shape for all 14 instantiations, in this process: Jive-2 over MATRIX_N states made on the
        # card, N_ORACLE_MATRIX lanes at both ends against the native oracle
        half = N_ORACLE_MATRIX // 2
        cols = torch.cat([torch.arange(half), torch.arange(MATRIX_N - half, MATRIX_N)]).to(dev)
        for seed, (field, iname) in enumerate((f, i) for f in FIELD_NAMES for i in INSTANCE_NAMES):
            inst_m = get_instance(field, iname)
            x = random_on_card(inst_m, inst_m.width, MATRIX_N, args.seed + seed)
            out = jive_compress_batch_fn(inst_m, 2, device=dev)(x)
            held_oracle(canonical_host(inst_m, out[:, :, cols]), oracle_jive(inst_m, x[:, :, cols], 2),
                        f"{field}/{iname} Jive over {MATRIX_N}")
        print(f"  the matrix's 14 instantiations in this process: Jive-2 over {MATRIX_N} states each, "
              f"{N_ORACLE_MATRIX} lanes ({half} at each end) held against the native oracle: identical", flush=True)
        del x, out

        # the CPU's work beside the card's: the gloo demo, the dry run and the entry's plain version
        demo_gloo = run_module("anemoi_tpu_torch.tools.multihost_demo", "--procs", "2", "--leaves", str(DEMO_LEAVES),
                               "--device", "cpu")
        try:
            with ThreadPoolExecutor(2) as pool, tempfile.TemporaryDirectory() as tmp:
                dryrun = pool.submit(graft_entry.dryrun_multichip, 2)
                fn_cpu, (example_cpu,) = graft_entry.entry(device="cpu")
                entry_cpu = pool.submit(fn_cpu, example_cpu)

                matrix_path = Path(tmp) / "BENCHMARKS_TORCH.md"
                module_result(run_module("anemoi_tpu_torch.bench", "--matrix", "--n", str(MATRIX_N), "--out",
                                         str(matrix_path)), "the matrix", timeout=900)
                rows = _ROW.findall(matrix_path.read_text())
                if len(rows) != 14 or any(parity != "4 lanes exact" for *_, parity in rows):
                    fail(f"the matrix: {len(rows)} rows, {[r[-1] for r in rows]}")
                print(f"  the matrix (--matrix --n {MATRIX_N}): 14 rows, each with 4 lanes held", flush=True)

                lines = module_result(run_module("anemoi_tpu_torch.tools.verify_cuda", "--fields", "all"),
                                      "the verifier", timeout=900)
                if not lines[-1].endswith("ALL PASS") or any(line.startswith("FAIL") for line in lines):
                    fail("the verifier:\n" + "\n".join(lines))
                passed = sum(line.startswith("PASS") for line in lines)
                print(f"  the verifier (tools.verify_cuda --fields all): {passed} PASS lines, ALL PASS; {lines[-2]}",
                      flush=True)

                lines = module_result(run_module("anemoi_tpu_torch.tools.multihost_demo", "--procs", "1", "--leaves",
                                                 str(DEMO_LEAVES), "--device", "cuda"), "the NCCL demo")
                if lines[-1] != "multihost demo: OK":
                    fail(f"the NCCL demo: {lines}")
                lines = module_result(demo_gloo, "the gloo demo", timeout=900)
                if lines[-1] != "multihost demo: OK":
                    fail(f"the gloo demo: {lines}")
                print(f"  the demo (tools.multihost_demo, {DEMO_LEAVES} leaves): 2 gloo workers OK, 1 NCCL rank OK",
                      flush=True)

                fn, (example,) = graft_entry.entry()
                torch.cuda.synchronize()
                before = cuda_backend.launch_counts()
                out = fn(example)
                torch.cuda.synchronize()
                entry_launches = launches_since(before)["jive"]
                if not torch.equal(example.cpu(), example_cpu) or entry_launches != 1:
                    fail(f"the entry: examples differ or {entry_launches} launches")
                held(out.cpu(), entry_cpu.result(), "the entry on the card against its function on the CPU")
                dryrun.result()
        finally:
            demo_gloo.kill()
            demo_gloo.wait()
        print(f"  the entry: graft_entry.entry() on the card, 1 Jive launch, bit-identical to its function on the CPU "
              f"on all {example.shape[-1]} lanes; dryrun_multichip(2) on 2 gloo ranks ok", flush=True)
        del out, example

    # 18 --------------------------------------------------------------------
    if run(18):
        phase(f"18 the tensor-core Jive kernel (mul_impl {MMA_IMPL!r}): SASS, fragment layouts, the main path, full "
              f"size, holds, the bench")
        from anemoi_tpu_torch.ff import mxu_ops

        for words, b in mma_libs.items():
            for kernel, r in sorted(sass.mma_report(b).items()):
                print(f"  {words} words, {kernel}: {r['registers']} registers, spills {r['spill_store']}/"
                      f"{r['spill_load']} bytes; IMMA {r['whole']['IMMA']:g}", flush=True)
                if not r["whole"]["IMMA"]:
                    fail(f"{kernel} at {words} words has no IMMA instruction")
        # the fragment layouts: the card's mma.sync against the product of the matrices they pack
        for K in (32, 16):
            A, B = rng.integers(0, 256, (16, K)), rng.integers(0, 256, (K, 8))
            pad = lambda x, cols: np.pad(x, ((0, 0), (0, cols - x.shape[1])))
            d = cuda_backend.mma_check(torch.from_numpy(pad(mxu_ops.pack_a(A), 4).view(np.int32)).to(dev),
                                       torch.from_numpy(pad(mxu_ops.pack_b(B), 2).view(np.int32)).to(dev), K)
            if not np.array_equal(mxu_ops.unpack_d(d.cpu().numpy()), A @ B):
                fail(f"mma.sync m16n8k{K} on the card disagrees with the fragment layouts")
        print("  mma.sync m16n8k32 and m16n8k16 (u8) on the card: the fragment layouts of mxu_ops and HostWarp "
              "hold", flush=True)

        # the main path with the tensor-core product: Jive over N_FULL states and the N_FULL-leaf root
        inst = get_instance("vesta", "anemoi_2_1")
        states = canonical_states(inst, N_FULL)
        leaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
        compress = jive_compress_batch_fn(inst, 2, device=dev, mul_impl=MMA_IMPL)
        tree = MerkleTree(inst, device=dev, mul_impl=MMA_IMPL)
        torch.cuda.synchronize()
        before = cuda_backend.launch_counts()
        digests = compress(states)
        root = tree.root(leaves)
        torch.cuda.synchronize()
        c = launches_since(before)
        print(f"  main path, mul_impl {MMA_IMPL!r}: Jive over {N_FULL} states and a {N_FULL}-leaf root: "
              f"{c['jive_mma']} jive_mma launches, {c['jive']} jive_kernel launches", flush=True)
        if c["jive_mma"] != 1 + tree.num_levels(N_FULL) or c["jive"]:
            fail(f"the mxu main path took {c['jive_mma']} jive_mma and {c['jive']} jive_kernel launches")
        held(digests, jive_compress_batch_fn(inst, 2, device=dev)(states), f"{N_FULL} Jive, against jive_kernel")
        held(root, MerkleTree(inst, device=dev).root(leaves), f"the {N_FULL}-leaf root, against the default root")
        print(f"  its {N_FULL} digests equal jive_kernel's; MerkleTree(mul_impl={MMA_IMPL!r}).root equals the default "
              f"root", flush=True)
        del leaves, digests

        # full size: each field's 2_1 Jive over N_FULL states, every lane held against jive_kernel
        outs = {}
        for field in MMA_FIELDS:
            inst = get_instance(field, "anemoi_2_1")
            x = states.reshape(-1, N_FULL) if field == "vesta" else canonical_states(inst, N_FULL).reshape(-1, N_FULL)
            outs[field] = cuda_backend.jive(inst, 2, x, MMA_IMPL), x
            held(outs[field][0], cuda_backend.jive(inst, 2, x),
                 f"{field} {N_FULL} Jive, every lane against jive_kernel")
            print(f"  {field}/anemoi_2_1 Jive over {N_FULL} states ({inst.field.kernel_words} words): every lane "
                  f"equal to jive_kernel's", flush=True)
        del states

        # the bench with the tensor-core product, a process of its own, beside this process's checks
        bench_mma = run_module("anemoi_tpu_torch.bench", "--impl", MMA_IMPL)
        try:
            half = N_ORACLE_FULL // 2
            cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
            for field, (out, x) in outs.items():
                inst = get_instance(field, "anemoi_2_1")
                want = oracle_jive(inst, x.reshape(inst.width, -1, N_FULL)[:, :, cols], 2)
                held_oracle(canonical_host(inst, out[:, cols]), want, f"{field} {N_FULL} Jive, {MMA_IMPL}")
            print(f"  {N_ORACLE_FULL} lanes ({half} at each end) of each held against the native oracle: identical",
                  flush=True)
            del outs

            # 4,099 states (the last warp ragged): every lane against jive_kernel, N_PLAIN at both ends against the
            # plain version; the other 20-limb fields' 2_1, every lane against the native oracle
            for field, iname, k in (("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 2),
                                    ("vesta", "anemoi_4_3", 4), ("bls12_381", "anemoi_2_1", 2),
                                    ("bls12_377", "anemoi_2_1", 2)):
                inst = get_instance(field, iname)
                W, L = inst.width, inst.field.n_limbs
                x = canonical_states(inst, N_CHECK).reshape(W * L, N_CHECK)
                out = cuda_backend.jive(inst, k, x, MMA_IMPL)
                held(out, cuda_backend.jive(inst, k, x), f"{field}/{iname} k={k}, against jive_kernel")
                held(out[:, lanes], cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()),
                     f"{field}/{iname} k={k}, against the plain version")
                print(f"  {field}/{iname} k={k}: {N_CHECK} lanes, all held against jive_kernel and {N_PLAIN} against "
                      f"the plain version: identical", flush=True)
            for field in FIELDS_20:
                if field == "vesta":
                    continue
                inst = get_instance(field, "anemoi_2_1")
                st = canonical_states(inst, N_CHECK)
                out = jive_compress_batch_fn(inst, 2, device=dev, mul_impl=MMA_IMPL)(st)
                held_oracle(canonical_host(inst, out), oracle_jive(inst, st, 2), f"{field}/anemoi_2_1 k=2, {MMA_IMPL}")
            print(f"  the other 20-limb fields' anemoi_2_1, all {N_CHECK} lanes each against the native oracle: "
                  f"identical", flush=True)
            lines = module_result(bench_mma, f"the bench with --impl {MMA_IMPL}", timeout=900)
        finally:
            bench_mma.kill()
            bench_mma.wait()
        doc = json.loads([line for line in lines if line.startswith("{")][-1])
        runs = [doc, *(c for c in doc["configs"] if "launches" in c)]
        if not doc["launches"]["jive_mma"] or doc["launches"]["jive"] or any(
                c.get("parity") != "ok" for c in runs):
            fail(f"the bench with --impl {MMA_IMPL}: headline launches {doc['launches']}, parity "
                 f"{[c.get('parity') for c in runs]}")
        print(f"  the bench (python3 -m anemoi_tpu_torch.bench --impl {MMA_IMPL}, beside this phase's checks): "
              f"{len(runs)} runs with their parity ok, "
              f"{sum(c['launches'].get('jive_mma', 0) for c in runs)} jive_mma launches in all", flush=True)

    # 19 --------------------------------------------------------------------
    if run(19):
        phase(f"19 the tensor-core permutation and sponge (mul_impl {MMA_IMPL!r}): SASS, the main path, both forms, "
              f"holds, the verifier")
        mma_top = {w: cuda_backend.permute_mma_group_max(w) for w in sponge_mma_libs}
        for words, b in sponge_mma_libs.items():
            for kernel, r in sorted(sass.mma_report(b).items()):
                print(f"  {words} words, {kernel}: {r['registers']} registers, spills {r['spill_store']}/"
                      f"{r['spill_load']} bytes; IMMA {r['whole']['IMMA']:g}", flush=True)
                if not r["whole"]["IMMA"]:
                    fail(f"{kernel} at {words} words has no IMMA instruction")
        print(f"  the permutation launches its quad form up to {mma_top[8]} states at 8 words and {mma_top[12]} at 12 "
              f"(PERMUTE_MMA_GROUP_MAX), its thread form above", flush=True)

        # full-size inputs made on the card: the states of each permutation (N_MSGS is a prefix of N_MSGS_FILL,
        # and so is N_CHECK), 4,096 messages of 10 KB for each sponge
        perm_in, sponge_in = {}, {}
        for field, iname in MMA_PERMS:
            inst = get_instance(field, iname)
            x = random_on_card(inst, inst.width, N_MSGS_FILL, args.seed + 19).reshape(-1, N_MSGS_FILL)
            perm_in[field] = {n: x[:, :n].contiguous() for n in (*MMA_PERM_NS, N_CHECK)}
        for field, iname in MMA_SPONGES:
            inst = get_instance(field, iname)
            E = -(-MSG_BYTES // inst.field.byte_chunk)
            sponge_in[(field, iname)] = E, random_on_card(inst, E, N_MSGS, args.seed + 20).reshape(-1, N_MSGS)
        torch.cuda.synchronize()

        # the main path, each word count's launches counted: the permutation at each size and the sponge over
        # 4,096 x 10 KB, through cuda_backend with the name
        outs = {}
        for words in (8, 12):
            perms = [(c, n) for c in MMA_PERMS for n in MMA_PERM_NS if get_instance(*c).field.kernel_words == words]
            sponges = [c for c in MMA_SPONGES if get_instance(*c).field.kernel_words == words]
            before = cuda_backend.launch_counts()
            for (field, iname), n in perms:
                outs[(field, n)] = cuda_backend.permutation(get_instance(field, iname), perm_in[field][n], MMA_IMPL)
            for case in sponges:
                E, m = sponge_in[case]
                outs[case] = cuda_backend.sponge(get_instance(*case), E, m, MMA_IMPL)
            torch.cuda.synchronize()
            counts = launches_since(before)
            print(f"  main path, {words} words, mul_impl {MMA_IMPL!r}: the permutation of "
                  + ", ".join(f"{c[0]}/{c[1]} {n}" for c, n in perms) + " states and the sponge over " + ", ".join(
                      f"{f}/{i}" for f, i in sponges) + f" x {N_MSGS} x {MSG_BYTES} bytes: launches {counts}",
                  flush=True)
            others = {k: v for k, v in counts.items()
                      if k not in ("permutation_mma", "permutation_mma_thread", "sponge_mma") and v}
            quad = sum(n <= mma_top[words] for _, n in perms)
            if (counts["permutation_mma"] != quad or counts["permutation_mma_thread"] != len(perms) - quad
                    or counts["sponge_mma"] != len(sponges) or others):
                fail(f"the mxu path at {words} words took launches {counts}")
            print(f"  each permutation launched its form on its side of the crossover ({mma_top[words]} states): "
                  f"{quad} quad form, {len(perms) - quad} thread form", flush=True)

        # both forms at each N of MMA_FORM_NS, each output held against the main path's (a prefix of its
        # N_MSGS_FILL states, held below against the integer kernel)
        for field, iname in MMA_PERMS:
            inst = get_instance(field, iname)
            x, want = perm_in[field][N_MSGS_FILL], outs[(field, N_MSGS_FILL)]
            for n in MMA_FORM_NS:
                xn = x[:, :n].contiguous()
                for quad in (True, False):
                    held(cuda_backend.permutation_mma_with(inst, xn, quad), want[:, :n], f"{field}/{iname} "
                         f"permutation, {n} states, {'quad' if quad else 'thread'} form, against the main path's")
            print(f"  {field}/{iname} permutation, both forms at {', '.join(map(str, MMA_FORM_NS))} states: equal to "
                  f"the main path's", flush=True)

        # the verifier with the name, a process of its own, beside this process's checks
        verify_mma = run_module("anemoi_tpu_torch.tools.verify_cuda", "--mul-impl", MMA_IMPL, "--fields",
                                "vesta,bls12_381")
        try:
            # every lane against the integer kernel (phases 6, 8 and 13 hold it against the native oracle), the
            # ragged N_CHECK among them; N_PLAIN lanes at both ends of each N against the plain version
            for field, iname in MMA_PERMS:
                inst = get_instance(field, iname)
                top = crossover[inst.field.kernel_words]
                outs[(field, N_CHECK)] = cuda_backend.permutation(inst, perm_in[field][N_CHECK], MMA_IMPL)
                ns = (*MMA_PERM_NS, N_CHECK)
                for n in ns:
                    held(outs[(field, n)], cuda_backend.permutation_with(inst, perm_in[field][n], n <= top),
                         f"{field}/{iname} permutation, {n} states, {MMA_IMPL}, against the integer kernel")
                for quad in (True, False):
                    held(cuda_backend.permutation_mma_with(inst, perm_in[field][N_CHECK], quad), outs[(field, N_CHECK)],
                         f"{field}/{iname} permutation, {N_CHECK} states, {'quad' if quad else 'thread'} form, "
                         f"against the main path's")
                cols = torch.cat([ends(n) for n in ns]).unique()
                plain = cuda_backend.permutation_plain(inst, perm_in[field][N_MSGS_FILL][:, cols.to(dev)].contiguous())
                at = {int(c): i for i, c in enumerate(cols)}
                for n in ns:
                    c = ends(n)
                    held(outs[(field, n)][:, c.to(dev)], plain[:, torch.tensor([at[int(i)] for i in c], device=dev)],
                         f"{field}/{iname} permutation, {n} states, {MMA_IMPL}, against the plain version")
                print(f"  {field}/{iname} permutation at {', '.join(map(str, ns))} states: every lane equal to the "
                      f"integer kernel's, both forms at {N_CHECK} equal, {N_PLAIN} at both ends of each to the plain "
                      f"version ({len(cols)} lanes)", flush=True)
            for case in MMA_SPONGES:
                inst = get_instance(*case)
                E, m = sponge_in[case]
                held(outs[case], cuda_backend.sponge(inst, E, m), f"{case[0]}/{case[1]} sponge, {N_MSGS} x "
                     f"{MSG_BYTES} bytes, {MMA_IMPL}, against sponge_kernel")
                # a ragged N_CHECK at E = rate (sigma not added), 2 rate and rate + 1 (a tail), the last also on
                # N_PLAIN messages at both ends against the plain version, which takes a second a permutation
                r, L = inst.rate, inst.field.n_limbs
                ragged = random_on_card(inst, 2 * r, N_CHECK, args.seed + 21).reshape(-1, N_CHECK)
                sizes = tuple(dict.fromkeys((r, 2 * r, r + 1)))  # r + 1 last: its output meets the plain version
                for e in sizes:
                    x = ragged[:e * L].contiguous()
                    out = cuda_backend.sponge(inst, e, x, MMA_IMPL)
                    held(out, cuda_backend.sponge(inst, e, x), f"{case[0]}/{case[1]} sponge, {N_CHECK} messages "
                         f"of {e}, against sponge_kernel")
                held(out[:, lanes], cuda_backend.sponge_plain(inst, r + 1, x[:, lanes].contiguous()),
                     f"{case[0]}/{case[1]} sponge, {N_PLAIN} of {N_CHECK} messages of {r + 1}, against the plain "
                     f"version")
                print(f"  {case[0]}/{case[1]} sponge: every lane of {N_MSGS} x {E} elements equal to sponge_kernel's; "
                      f"{N_CHECK} messages of {', '.join(map(str, sizes))} elements equal to sponge_kernel's, {N_PLAIN} "
                      f"at both ends of the last to the plain version", flush=True)
            lines = module_result(verify_mma, f"verify_cuda --mul-impl {MMA_IMPL}", timeout=600)
        finally:
            verify_mma.kill()
            verify_mma.wait()
        reported = json.loads([line for line in lines if line.startswith("launches: ")][-1].split(": ", 1)[1])
        if not lines[-1].endswith("ALL PASS") or not all(reported[k] > 0 for k in (
                "permutation_mma", "permutation_mma_thread", "sponge_mma", "permutation_mma_w12",
                "permutation_mma_thread_w12", "sponge_mma_w12")):
            fail(f"verify_cuda --mul-impl {MMA_IMPL}: {lines[-1]!r}, launches {reported}")
        print(f"  python3 -m anemoi_tpu_torch.tools.verify_cuda --mul-impl {MMA_IMPL} --fields vesta,bls12_381 (a "
              f"process, beside these checks): ALL PASS; launches {reported}", flush=True)
        del perm_in, sponge_in, outs

    phase("done")
    if args.phases != ALL_PHASES:
        print(f"chip_smoke: phases {sorted(args.phases)} passed; a partial run prints no result line", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
