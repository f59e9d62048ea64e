#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths on one NVIDIA GPU and checks them.

    python3 chip_smoke.py [--seed N] [--phases N,N,...]

The main paths, through the port's entry points, with random inputs from
``--seed``: batched anemoi_2_1 Jive 2-to-1 compression and a Merkle root
over 2^20 leaves built on it (``jive_compress_batch_fn``,
``MerkleTree.root``), for Vesta (8-word kernels) and BLS12-381 (12-word
kernels, with the root's levels, proofs and checkpoints); and the sponge
over bytes, 4,096 messages of 10 KB (``.batch.hash_bytes``) and the
streaming sponge (``BatchedSponge``), for Vesta anemoi_4_3 and anemoi_2_1
and BLS12-381 anemoi_4_3.  Phases, each printed with its elapsed seconds:

  1. the card: its name, and name and power limit from nvidia-smi;
  2. the builds, all started together: csrc/jive.cu, csrc/sponge.cu,
     csrc/jive_mma.cu and csrc/sponge_mma.cu with nvcc once for 8 words and
     once for 12, csrc/microbench.cu, each timed,
     with ptxas's report, and the host's byte packer with g++; each Jive,
     permutation and sponge kernel's registers and spills beside the
     earlier kernels' (the sponge kernel's code must not change; a Jive
     or one-thread permutation kernel that spills fails), its
     resident blocks per SM, its SASS's local-memory loads and stores,
     shuffles, votes and IMADs, and the four-lane kernels' innermost loop;
     the permutation's crossover (PERMUTE_GROUP_MAX) at 8 and 12 words;
  3. the kernel against its plain PyTorch version on the card, bit for bit,
     for Vesta 2_1 (k=2) and Vesta 4_3 (k=2, 4): 4,099 states, the plain
     version on 257 of them (both ends, so the ragged last block is among
     them); and for the 2_1 instance of the other four 20-limb fields,
     all 4,099 lanes against the native oracle (``ff/native.py``:
     64-bit Montgomery words in C++ on the host, independent of the port's
     limb code and kernels; its calls split over the host's cores);
  4. the SAGE Jive vectors of the five 20-limb fields x 2 instances;
  5. full size, Vesta 2_1: the main path with every launch count set to 0
     just before and read just after (one Jive over 2^20 states and one
     2^20-leaf root: 1 + 20 launches); then Jive timed with CUDA events
     beside the earlier kernels' and its bound, 1,024 sampled lanes
     against the plain version and 65,536 (32,768 at each end) against the
     native oracle, the root timed, up to 1,024 columns of each of its
     levels against the plain version, a 16-leaf root against the plain
     version's and a 2^14-leaf root against a reduction by the oracle;
  6. the permutation and sponge kernels against their plain versions, bit
     for bit: both permutation kernels for Vesta 2_1 and 4_3, through
     ``permutation`` at N = 5, 4,099, the crossover X, X - 3 and X + 1
     (ragged on either side of it) and 65,536 (the one-thread kernel at
     phase 8's second path) and through ``permutation_with`` each kernel
     at 4,099, up to 257 lanes of each N held (both ends), and every lane
     of each N up to X + 1 (the first X + 1 of 65,536) against the native
     oracle; the sponge over 1,024 messages of Vesta
     4_3 with E = 3 (sigma, no extra permutation), all held, and over 4,099
     (not a whole warp of 8 messages nor a block of 32; 257 held at both
     ends) with E = 4 (tail 1) and of Vesta 2_1 with E = 2; every message
     of each also against a host sponge: the rate adds and sigma in Python
     ints, each permutation the native oracle's;
  7. the SAGE hash_field and hash_bytes vectors of the five 20-limb fields
     x 2 instances through ``.batch.hash_field`` and ``.batch.hash_bytes``
     on the card, and the Vesta 2_1 digest of b"hello world" through
     ``digest_export_fn`` and ``digests_to_bytes``;
  8. full size, the sponge: 4,096 random 10 KB messages per instance; the
     main path with every launch count set to 0 just before and read just
     after (``.batch.hash_bytes`` for Vesta 4_3 and 2_1: one sponge launch
     each; ``BatchedSponge`` over the 4_3 messages in 4 rate-aligned chunks
     and the tail: one four-lane permutation launch per block, 111 in all,
     digests equal to hash_bytes's); then host packing, kernel time (CUDA
     events) and bound; 32 sampled messages per instance against the
     port's golden model; the sponge kernel alone over 65,536 Vesta 4_3
     messages made on the card, 4 lanes against the golden model; each
     time beside the earlier kernels'; the kernel over the first 1,024 and
     2,048 of the messages; the second path, counts set to 0 just before
     and read just after: ``BatchedSponge`` over 65,536 of those streams
     (8 rate-blocks and a tail: 9 one-thread permutation launches), its
     digests equal to the sponge kernel's; the permutation at 4,096 states
     beside the earlier kernels', the crossover sweep (both kernels at
     4,096 to 65,536 states) and ``BatchedSponge`` end to end beside its
     launches' time;
  9. the 12-word instantiations against their plain versions, bit for bit,
     4,099 lanes each and 257 of them held: Jive (2,2), (4,2), (4,4) for
     BLS12-381, both permutation kernels of BLS12-377 2_1 and 4_3 as in
     phase 6 (the native oracle too), the sponge for BLS12-381 4_3 with
     E = 3 and E = 4 and 2_1 with E = 2;
 10. the SAGE jive, hash_field and hash_bytes vectors of BLS12-377 and
     BLS12-381 x 2 instances through ``.batch`` on the card;
 11. full size, BLS12-381 2_1: the main path with every launch count set to
     0 just before and read just after (one Jive over 2^20 states and one
     2^20-leaf root: 1 + 20 launches); Jive timed beside the earlier
     kernels' and its bound, 1,024 sampled lanes against the plain
     version and 16,384 (8,192 at each end) against the native oracle; the
     root timed with ``return_levels``;
     ``prove`` and ``verify`` for 8 leaves (0 and 2^20 - 1 among them) and
     a tampered leaf that must fail; then BLS12-377 2_1 Jive over 2^20
     states, timed, 256 sampled lanes against the golden model and 16,384
     against the native oracle;
 12. checkpoints on the card: a 2^12-leaf BLS12-381 tree written to a
     temporary directory, its level files deleted down to the lowest three,
     and resumed: the resumed root and levels equal the fresh ones;
 13. full size, the BLS12-381 4_3 sponge: 4,096 random 10 KB messages
     (218 elements of 47 bytes); the main path with every launch count set
     to 0 just before and read just after (``.batch.hash_bytes``: one
     sponge launch; ``BatchedSponge`` in rate-aligned chunks and the tail:
     73 four-lane permutation launches); host packing, kernel time, end to
     end, the bound and its share, beside the earlier kernels'; 32 sampled
     messages against the golden model; the second path over 65,536
     streams made on the card (9 one-thread launches); the permutation at
     4,096 states, the crossover sweep and ``BatchedSponge`` end to end, as
     in phase 8;
 14. the microbenchmarks (``anemoi_tpu_torch/microbench.py``): the squaring
     chain's 8-deep check against Python ints (Vesta, BLS12-381) and its ns
     per squaring; the multiply-add loop at the JAX tool's shapes and at
     one that fills the card, in iterations per clock per SM, and its SASS;
     each kernel against its plain version on a few lanes;
 16. full width, the fourth slice's paths, each with the launch counts set
     to 0 just before and read just after (run before 15): the CLI
     (``python -m anemoi_tpu_torch.cli``, a process of its own on the card)
     hashing 256 files of 8 lengths from 0 to 10 KB for Vesta 2_1 and
     BLS12-381 4_3 (digests equal ``.batch.hash_bytes``'s, 16 the golden
     model's, "hello world" among them; its ``--stats`` launches), its
     ``merkle`` over 2^20 x 31 - 40 bytes (2^20 - 1 elements and a zero
     leaf: the root equals ``MerkleTree.root``'s, 20 Jive launches, wall
     time), ``info`` and ``vectors``; ``AsyncByteHasher`` over phase 8's
     4,096 x 10 KB Vesta 4_3 messages in 4 batches of 1,024 (4 sponge
     launches, digests equal ``.batch.hash_bytes``'s, its time beside
     theirs and the packing's); the forest over 2^20 Vesta 2_1 leaves on
     one NCCL rank (a ``file://`` store; the root equals
     ``MerkleTree.root``'s, 20 Jive launches, ``collective_traffic``); one
     2^20 Jive under ``utils.profiling.trace`` (the trace names the
     kernel) and ``utils.debug.check_limbs`` on the phase's canonical
     digests;
 17. the fifth slice's programs, each run as its users run it, a process
     of its own (run before 15): the default bench
     (``python3 -m anemoi_tpu_torch.bench``: the headline and all 7
     secondary configs of ``bench.py:620-660`` with their parity checked,
     the headline within 10% of phase 5's rate, the arity-4 tree over 2^24
     leaves beside its bound; in this process, the tree's first level,
     Jive-4 over 2^22 states from the bench's leaves, 257 lanes at both
     ends against the plain version and 65,536 against the native oracle,
     and each of the 14 instantiations at the matrix's 2^18 states, 4,096
     lanes against the oracle), the matrix (``--matrix --n 262144``: 14 rows),
     the verifier (``tools.verify_cuda --fields all``: ALL PASS), the entry
     (``graft_entry.entry()`` on the card bit-identical to its function on
     the CPU on all 256 lanes; ``dryrun_multichip(2)`` on gloo ranks) and
     the demo (``tools.multihost_demo``: 2 gloo workers, then 1 NCCL rank);
     the bench's and the verifier's launches, which they report;
 18. the tensor-core Jive kernel (``csrc/jive_mma.cu``, ``mul_impl="mxuf"``;
     run before 15): its SASS at 8 and 12 words (IMMA in it, or the phase
     fails; registers, spills, the instructions of the window's trip, a
     squaring and a product); the card's mma.sync m16n8k32 and m16n8k16
     against the fragment layouts of ``ff/mxu_ops.py``; the main path with
     every launch count set to 0 just before and read just after
     (``jive_compress_batch_fn`` and ``MerkleTree`` with
     ``mul_impl="mxuf"``: 1 + 20 jive_mma launches, none of jive_kernel),
     its digests equal jive_kernel's and its root the default one; the
     root timed in turns with the default root (CUDA events); Jive over
     2^20 states of Vesta, BLS12-381 (its one launch
     counted alone: the 12-word path) and BLS12-377 2_1, every lane held
     against ``jive_kernel`` and timed in turns with it (CUDA events)
     beside its bound (the IMADs left and the u8 multiply-adds); then,
     beside ``python3 -m anemoi_tpu_torch.bench
     --impl mxuf`` (a process of its own: its parity ok, its jive_mma
     launches), 65,536 lanes of each 2^20 Jive against the native oracle,
     4,099 states (the last warp ragged) of Vesta 2_1, Vesta 4_3 (k = 2,
     4), BLS12-381 and BLS12-377 2_1, every lane against ``jive_kernel`` and
     257 (both ends) against the plain version, and the other four 20-limb
     fields' 2_1, every lane against the native oracle;
 19. the tensor-core permutation and sponge (``csrc/sponge_mma.cu``,
     ``mul_impl="mxuf"``; run before 15): the SASS of its three kernels
     at 8 and 12 words (IMMA in each, or the phase fails; registers,
     spills, blocks per SM, the instructions of one window trip); the main
     path, each word count's run with every launch count set to 0 just
     before and read just after (``cuda_backend.permutation`` and
     ``sponge`` with the name: Vesta and BLS12-381 4_3 permutations of
     4,096 states, the quad form, and 65,536, the thread form, each on its
     side of ``PERMUTE_MMA_GROUP_MAX`` or the phase fails, and the sponge
     over 4,096 x 10 KB messages of Vesta 4_3 and 2_1 and BLS12-381 4_3;
     only ``permutation_mma``, ``permutation_mma_thread`` and
     ``sponge_mma`` launches); each timed in turns with the integer kernel
     the port runs without the name (CUDA events) beside its bound (the
     IMADs left and the u8 multiply-adds); the crossover: both forms
     at 4,096, 8,192, 16,384 and 65,536 states, each output held, the
     largest N at which the quad form wins beside the library's; every lane
     of each against the integer
     kernel, the ragged 4,099 states among them (both forms there) and
     4,099 messages of rate, 2 rate and rate + 1 elements, and 257 lanes at
     both ends against the plain version; beside those checks, ``python3
     -m anemoi_tpu_torch.tools.verify_cuda --mul-impl mxuf`` (a process of
     its own: ALL PASS, each new kernel's launches above 0);
 15. one JSON line of kernels: launches, error, times, bound, with the
     fourth and fifth slices' launches beside; every bound beside the IMAD
     rate that phase 14 measured; the native oracle's seconds.

The tolerance everywhere is exact: integer arithmetic, canonical outputs.
Where the plain version would take minutes (a 10 KB message is 73 to 331
permutations), outputs are held against the golden model over Python ints
instead, on sampled lanes, or against the native oracle on thousands.
Any failure raises; the last line, printed only when every phase passed, is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this file, it exits non-zero before printing any result.

For development, ``--phases 6,8`` runs only the phases named, with phases
1 and 2 (the device, the builds) and what they need (12 needs 11; 15 needs
all; 17 needs 5): a short run on the card; ``--phases 18`` is the
tensor-core Jive kernel alone, ``--phases 19`` the tensor-core permutation
and sponge.  Such a run prints no result line.  Phases run in the order 1
to 14, 16, 17, 18, 19, 15.
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
REPS = 5
MSG_BYTES = 10 * 1024  # bench.py:210-235, bench_sponge_10kb
N_MSGS = 4096
N_MSGS_FILL = 1 << 16  # enough messages to fill the card
N_MSGS_PARTS = (1024, 2048)  # phase 8's kernel alone over fewer messages: 32 and 64 blocks of 32
N_SPONGE_PLAIN = 1024
N_GOLDEN = 32
SPONGE_REPS = 3

N_PROOFS = 8
N_GOLDEN_JIVE = 256
CKPT_TREE = 1 << 12
CKPT_KEEP = 3  # level files left before the resume
MB_LANES = 1 << 16  # squaring chain: lanes that fill the card
CHAIN_TRIPS = (1000, 3000)
MAD_TRIPS = (20000, 60000)  # tools/microbench_layout.py:time_body's n1, n2
MB_REPS = 5

# H100 SXM: 3.35 TB/s of HBM3; 32-bit integer multiply-adds at 64 per clock
# per SM (compute capability 9.0 throughput table), SM count and clock read
# from the card.  The IMADs of one product or squaring are functions of the
# field's words (anemoi_tpu_torch/microbench.py: 264 and 208 at 8 words,
# 588 and 456 at 12); phase 14 measures the rate this assumes.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
HELLO_WORLD = "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d"  # Vesta 2_1


def permutation_work(inst, chain) -> tuple[int, int]:
    """(squarings, products) of one permutation, counted with the field's
    own reference addition chain: per Flystel the chain for x^(1/alpha)
    (Vesta 248 squarings and 45 products, BLS12-381 378 and 76, BLS12-377
    373 and 75), two squarings y^2
    and two products by beta; per MDS layer (rounds + 1 of them) four
    products by beta at width 4 (mul_g in anemoi32.cuh:mds) and none at
    width 2.  The entry and exit conversions (one product per element read
    or written) are a cost of the representation and are left out."""
    flystels = inst.rounds * inst.columns
    squarings = flystels * (sum(op[0] == "sqr" for op in chain) + 2)
    products = flystels * (sum(op[0] == "mul" for op in chain) + 2) + (inst.rounds + 1) * (4 if inst.width == 4 else 0)
    return squarings, products


# The figures of the kernels before the 4-bit window and the four-lane permutation (PERF.md's table; NVIDIA H100 80GB
# HBM3, 700.00 W), printed beside this run's: ptxas registers of every kernel (the sponge kernel's code must not
# change), the binary-ladder kernels' times, and the sponge's, which must stay within 2%.
EARLIER_REGISTERS = {(8, "jive_kernel<2,2>"): 64, (8, "jive_kernel<4,2>"): 126, (8, "jive_kernel<4,4>"): 126,
                 (8, "permute_kernel<4>"): 96, (8, "permute_kernel<2>"): 60,
                 (8, "sponge_kernel<2>"): 44, (8, "sponge_kernel<4>"): 62,
                 (12, "jive_kernel<2,2>"): 92, (12, "jive_kernel<4,2>"): 254, (12, "jive_kernel<4,4>"): 246,
                 (12, "permute_kernel<4>"): 144, (12, "permute_kernel<2>"): 90,
                 (12, "sponge_kernel<2>"): 56, (12, "sponge_kernel<4>"): 78}
EARLIER_MS = {"jive vesta": 199.184, "root vesta": 265.543, "jive bls12_381": 719.984, "root bls12_381": 941.254,
          "jive bls12_377": 696.045, "permutation vesta/anemoi_4_3": 6.373, "permutation bls12_381/anemoi_4_3": 21.262,
          "sponge vesta/anemoi_4_3": 471.496, "sponge vesta/anemoi_2_1": 1205.551,
          "sponge bls12_381/anemoi_4_3": 852.134, "sponge vesta/anemoi_4_3, 65536": 3474.261,
          "e2e vesta/anemoi_4_3": 1051.6, "e2e bls12_381/anemoi_4_3": 1510.4}
N_CLI_FILES = 256  # phase 16: files hashed by the CLI
CLI_LENGTHS = (0, 1, 31, 32, 100, 1000, 4097, MSG_BYTES)  # their byte lengths, 32 files each: 7 element counts
N_CLI_GOLDEN = 16  # of them held against the golden model
CLI_MERKLE_BYTES = (1 << 20) * 31 - 40  # packs to 2^20 - 1 Vesta elements: one zero leaf pads it to 2^20
ASYNC_BATCH = 1024  # AsyncByteHasher's batch: phase 8's 4,096 messages in 4 batches
PERM_SWEEP = (4096, 8192, 16384, 65536)  # the crossover sweep: both permutation kernels at each N
N_STREAMS = 1 << 16  # BatchedSponge's second path: a batch above the crossover, for the one-thread kernel
STREAM_BLOCKS = 8  # rate-blocks it absorbs, then a tail of one element
BENCH_CONFIGS = ("multichip_dryrun_collective_bytes_per_device", "vesta_anemoi_4_3_jive_2to1",
                 "bls12_377_anemoi_2_1_jive_2to1", "vesta_anemoi_4_3_sponge_10kb", "bls12_377_anemoi_4_3_sponge_10kb",
                 "vesta_anemoi_2_1_merkle_2p20_arity2", "vesta_anemoi_4_3_merkle_2p24_arity4")  # bench.py:620-656
HEADLINE_TOLERANCE = 0.10  # the bench's headline against phase 5's rate: both time the same kernel
TREE_LEAVES = 1 << 24  # BASELINE config 4: the arity-4 Vesta 4_3 tree
MATRIX_N = 1 << 18
N_ORACLE_MATRIX = 1 << 12  # phase 17: lanes of each instantiation's Jive at MATRIX_N against the native oracle
DEMO_LEAVES = 64
MMA_IMPL = "mxuf"  # phase 18: the JAX package's default product, which selects the tensor-core Jive kernel
MMA_FIELDS = ("vesta", "bls12_381", "bls12_377")  # phase 18's full-size Jive, each 2_1 over N_FULL states
MMA_REPS = 2  # phase 18's calls of each kernel a turn, after a warm-up: two turns each
# the dense int8 rate of the tensor cores (NVIDIA's H100 SXM data sheet, at 700 W): 1,979 TOPS, two a multiply-add
INT8_MAC_PER_S = 1979e12 / 2
MMA_PERMS = (("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_4_3"))  # phase 19: the tensor-core permutation's cases,
MMA_PERM_NS = (N_MSGS, N_MSGS_FILL)  # at BatchedSponge's batch and a full card; N_CHECK too, untimed
MMA_SPONGES = (("vesta", "anemoi_4_3"), ("vesta", "anemoi_2_1"), ("bls12_381", "anemoi_4_3"))  # x 4,096 x 10 KB
MMA_PERM_REPS, MMA_SPONGE_REPS = 3, 1  # phase 19's calls of each kernel a turn, after a warm-up: two turns each


def was(key: str, ms: float) -> str:
    """This run's time beside the earlier kernels'."""
    return f"earlier: {EARLIER_MS[key]} ms, {EARLIER_MS[key] / ms:.3f}x"


def golden_hash_bytes(args) -> list:
    """The port's golden model over one message, in a worker process."""
    field, iname, data = args
    sys.path.insert(0, str(ROOT))
    from anemoi_tpu_torch.ff import golden
    from anemoi_tpu_torch.fields.params import get_instance

    return golden.hash_bytes(get_instance(field, iname), data)


ALL_PHASES = frozenset(range(1, 20))
# 12 resumes 11's tree; 15 reports every phase; 17 holds the bench's headline against phase 5's time
PHASE_NEEDS = {12: {11}, 15: set(range(3, 20)) - {15}, 17: {5}}


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
            seconds, launches = line.split("; launches: ")
            stats["seconds"] = float(seconds.split()[1])
            for part in launches.replace(" (four-lane", ", four-lane").replace(")", "").split(", "):
                name, n = part.rsplit(" ", 1)
                stats[name] = int(n)
    return out.splitlines(), stats


def phase_list(text: str) -> frozenset:
    """--phases 6,8: those phases, the device and the builds (1, 2), and
    the phases they need."""
    chosen = {1, 2} | {int(x) for x in text.split(",") if x.strip()}
    if not chosen <= ALL_PHASES:
        raise argparse.ArgumentTypeError(f"phases are 1 to {max(ALL_PHASES)}")
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
    from anemoi_tpu_torch.fields.params import (
        FIELD_NAMES,
        FIELDS_20,
        FIELDS_30,
        INSTANCE_NAMES,
        get_instance,
        inv_alpha_chain,
    )
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
    plain_times = {}  # the plain versions' ms, phases 6 and 9
    plain_lanes = {}  # words: the lanes of the 4_3 permutation's plain call, phases 6 and 9
    max_err = dict.fromkeys(["jive", "permutation", "permutation_thread", "sponge", "jive_w12", "permutation_w12",
                             "permutation_thread_w12", "sponge_w12", "sqr_chain", "mad_loop", "jive_mma",
                             "jive_mma_w12", "permutation_mma", "permutation_mma_w12", "permutation_mma_thread",
                             "permutation_mma_thread_w12", "sponge_mma", "sponge_mma_w12"], 0)

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

    oracle_s = {}  # seconds of the native oracle's calls, by check
    sponge_msgs = None  # phase 8's messages, which phase 16 hashes again

    def oracle(fn, *args, what: str):
        """``fn(*args)``, one of ``native``'s oracle calls (``threaded``,
        ``host_sponge``, ``tree_levels``); its seconds go to oracle_s[what]."""
        t = time.perf_counter()
        out = fn(*args)
        oracle_s[what] = oracle_s.get(what, 0.0) + time.perf_counter() - t
        return out

    def oracle_jive(inst, states, k: int, *, what: str) -> np.ndarray:
        """Jive-k of int32 [W, L, n] Montgomery states on the card by the
        native oracle: canonical int32 [n, W/k, L]."""
        return oracle(native.threaded, native.jive_batch_canonical, inst, canonical_host(inst, states), k, what=what)

    def held_oracle(kernel_canon: np.ndarray, want: np.ndarray, what: str, kernel: str) -> None:
        held(torch.from_numpy(np.ascontiguousarray(kernel_canon)), torch.from_numpy(np.ascontiguousarray(want)),
             f"{what}, against the native oracle", kernel)

    # lanes held against the plain version: both ends of N_CHECK, the ragged last block among them
    lanes = torch.cat([torch.arange(N_PLAIN // 2), torch.arange(N_CHECK - (N_PLAIN - N_PLAIN // 2), N_CHECK)]).to(dev)

    def bound(inst, n_perms: int, n_bytes: int) -> dict:
        """The least time for n_perms permutations of `inst` that move
        n_bytes: the larger of the operations at imad_per_s and the bytes
        over the card's memory rate."""
        words = inst.field.kernel_words
        squarings, products = permutation_work(inst, inv_alpha_chain(inst.field.name))
        imads = squarings * mb.imads_per_squaring(words) + products * mb.imads_per_product(words)
        ops_ms = n_perms * imads / imad_per_s * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return {"words": words, "squarings": squarings, "products": products, "imads": imads, "ops_ms": ops_ms,
                "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    def mma_bound(inst, n_perms: int, n_bytes: int) -> dict:
        """The least time for n_perms permutations of `inst` with the tensor-core product that move n_bytes: the
        larger of the IMADs left on the integer pipe (each product's bilinear half: 2 NW^2 for a product, NW (NW +
        1) for a squaring, what microbench's counts keep without the reduction's 2 NW^2 + NW) at imad_per_s, the
        u8 multiply-adds of the reduction's two products (m: 4 NW x 4 NW; U: 4 NW x (4 NW + 2), the columns the
        kernels need) at INT8_MAC_PER_S, and the bytes over the card's memory rate."""
        w = inst.field.kernel_words
        squarings, products = permutation_work(inst, inv_alpha_chain(inst.field.name))
        red = 2 * w * w + w
        imads = squarings * (mb.imads_per_squaring(w) - red) + products * (mb.imads_per_product(w) - red)
        macs = (squarings + products) * (4 * w * 4 * w + 4 * w * (4 * w + 2))
        imad_ms, mac_ms = n_perms * imads / imad_per_s * 1e3, n_perms * macs / INT8_MAC_PER_S * 1e3
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ms = max(imad_ms, mac_ms, bytes_ms)
        return {"words": w, "imads": imads, "macs": macs, "imad_ms": imad_ms, "mac_ms": mac_ms,
                "bytes_ms": bytes_ms, "bound_ms": ms, "bound_by": "bytes" if ms == bytes_ms else "operations",
                "unit": "bytes" if ms == bytes_ms else "IMAD" if ms == imad_ms else "u8 MAC"}

    def show_bound(what: str, b: dict, ms: float) -> None:
        w = b["words"]
        print(f"  bound, {what}: per permutation {b['squarings']} squarings x {mb.imads_per_squaring(w)} + "
              f"{b['products']} products x {mb.imads_per_product(w)} = {b['imads']} IMADs ({w} words) at "
              f"{imad_per_s:.4g}/s: {b['ops_ms']:.3f} ms; bytes {b['bytes_ms']:.4f} ms; kernel at "
              f"{b['bound_ms'] / ms:.1%} of it", flush=True)

    def canonical_rows(inst, rows: int, n: int):
        """int32 [rows*L, n] random canonical limb rows on the card."""
        return torch.from_numpy(random_canonical(inst.field, (rows, n), rng).transpose(1, 0, 2).copy()) \
            .reshape(rows * inst.field.n_limbs, n).to(dev)

    def perm_key(group: bool, words: int) -> str:
        """The kernels line's name: "permutation" for the four-lane kernel,
        which BatchedSponge's 4,096 states run, "permutation_thread" for the
        one-thread one."""
        return ("permutation" if group else "permutation_thread") + ("_w12" if words == 12 else "")

    def mma_key(kind: str, words: int) -> str:
        """The kernels line's name of a tensor-core kernel, phase 19's: for `kind` "permutation" (the quad form),
        "permutation_thread" or "sponge", "permutation_mma", "permutation_mma_thread" or "sponge_mma", with "_w12" at
        12 words."""
        head, _, tail = kind.partition("_")
        return f"{head}_mma" + (f"_{tail}" if tail else "") + ("_w12" if words == 12 else "")

    def ends(n: int):
        """N_PLAIN lanes at both ends of n (all of them when n is smaller)."""
        return torch.cat([torch.arange(min(n, N_PLAIN // 2)),
                          torch.arange(max(n - (N_PLAIN - N_PLAIN // 2), 0), n)]).unique()

    def hold_permutation(inst) -> tuple[float, int]:
        """Both permutation kernels against the plain version, bit for bit:
        through ``permutation`` at N = 5 (under one warp's 8 states), N_CHECK,
        the crossover X, X - 3 (ragged, the four-lane kernel), X + 1 (ragged,
        the one-thread kernel) and N_MSGS_FILL (the one-thread kernel at the
        N of BatchedSponge's second path), and through ``permutation_with``
        each kernel at N_CHECK.  Every N is a prefix of the same states, so
        one plain call over the lanes held (both ends of each N) covers them
        all, and one call of the native oracle over the first X + 1 states
        covers every lane of each N up to X + 1 (and the first X + 1 of
        N_MSGS_FILL).  Returns the plain call's ms and its lanes."""
        words = inst.field.kernel_words
        top = cuda_backend.permute_group_max(words)
        ns = sorted({5, N_CHECK, top - 3, top, top + 1, N_MSGS_FILL})
        x = canonical_rows(inst, inst.width, ns[-1])
        cols = torch.cat([ends(n) for n in ns]).unique()
        plain_ms, plain = host_time_ms(lambda: cuda_backend.permutation_plain(inst, x[:, cols.to(dev)].contiguous()))
        at = {int(c): i for i, c in enumerate(cols)}
        runs = [(n, n <= top, "permutation", cuda_backend.permutation(inst, x[:, :n].contiguous())) for n in ns]
        runs += [(N_CHECK, g, "permutation_with", cuda_backend.permutation_with(inst, x[:, :N_CHECK].contiguous(), g))
                 for g in (True, False)]
        first = top + 1
        key = f"permutation {inst.qualified_name}"
        want = oracle(native.threaded, native.permute_batch_canonical, inst, canonical_host(inst, x[:, :first]),
                      what=key)
        for n, group, how, out in runs:
            held_cols = ends(n)
            what = f"{inst.qualified_name} permutation, N = {n}, {'four-lane' if group else 'one-thread'} kernel"
            held(out[:, held_cols.to(dev)], plain[:, torch.tensor([at[int(c)] for c in held_cols], device=dev)], what,
                 perm_key(group, words))
            m = min(n, first)
            held_oracle(canonical_host(inst, out[:, :m]), want[:m], what, perm_key(group, words))
            print(f"  {what} (through {how}): {len(held_cols)} lanes held against the plain version, "
                  f"{'all' if m == n else f'the first {m}'} against the native oracle: identical", flush=True)
        print(f"  the plain version on all {len(cols)} lanes held: {plain_ms / 1e3:.2f} s; the native oracle on "
              f"{first}: {oracle_s[key]:.2f} s", flush=True)
        return plain_ms, len(cols)

    def run_stream(inst, mont, chunks):
        """BatchedSponge over int32 [E, L, B] elements: the rate-aligned chunks
        of `chunks` rate-blocks each, then the rest as the tail."""
        stream = BatchedSponge(inst, mont.shape[-1], device=dev)
        start = 0
        for n in chunks:
            stream.absorb(mont[start:start + n * inst.rate])
            start += n * inst.rate
        return stream.finalize(mont[start:])

    def random_on_card(inst, rows: int, n: int, seed: int):
        """int32 [rows, L, n] random canonical elements made on the card."""
        L = inst.field.n_limbs
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randint(0, 1 << 13, (rows, L, n), generator=gen, device=dev, dtype=torch.int32)
        keep = np.clip(inst.field.p.bit_length() - 1 - 13 * np.arange(L), 0, 13)  # below 2^(bits(p) - 1)
        return x & torch.from_numpy(((1 << keep) - 1).astype(np.int32)).to(dev).view(1, L, 1)

    def perm_sweep(inst) -> dict:
        """Both permutation kernels at each N of PERM_SWEEP ({N: {group: ms}},
        CUDA events), printed as a table beside the library's crossover."""
        x = canonical_rows(inst, inst.width, PERM_SWEEP[-1])
        top = cuda_backend.permute_group_max(inst.field.kernel_words)
        times = {}
        print(f"  the crossover, {inst.qualified_name} ({REPS} calls of each kernel after a warm-up, CUDA events; "
              f"{smi}):\n    N | four-lane ms | one-thread ms | one-thread / four-lane | permutation() runs",
              flush=True)
        for n in PERM_SWEEP:
            xn = x[:, :n].contiguous()
            t = times[n] = {g: mb.event_ms(lambda: cuda_backend.permutation_with(inst, xn, g), REPS)
                            for g in (True, False)}
            print(f"    {n} | {t[True]:.3f} | {t[False]:.3f} | {t[False] / t[True]:.3f} | "
                  f"{'four-lane' if n <= top else 'one-thread'}", flush=True)
        wins = [n for n in PERM_SWEEP if times[n][True] < times[n][False]]
        best = max(wins) if wins else None
        print(f"  the largest N at which the four-lane kernel wins: {best}; the library's crossover "
              f"(PERMUTE_GROUP_MAX): {top}, {'the same' if best == top else 'DIFFERS'}", flush=True)
        return times

    def thread_path(inst, elems, what: str) -> tuple[int, dict]:
        """BatchedSponge's second path: N_MSGS_FILL streams, above the
        crossover, so its permutations run the one-thread kernel:
        STREAM_BLOCKS rate-blocks and a tail of one element, the launch
        counts set to 0 just before and read just after; the digests held
        against the sponge kernel over the same elements.  Returns the
        one-thread launches, and the bound of one launch."""
        L, n = inst.field.n_limbs, elems.shape[-1]
        for counter in (cuda_backend.jive, cuda_backend.permutation, cuda_backend.sponge):
            counter.launches = 0
        cuda_backend.permutation.group_launches = 0
        digest = run_stream(inst, elems, [STREAM_BLOCKS])
        torch.cuda.synchronize()
        total, group = cuda_backend.permutation.launches, cuda_backend.permutation.group_launches
        print(f"  main path: BatchedSponge over {n} {what} streams of {elems.shape[0]} elements (a chunk of "
              f"{STREAM_BLOCKS} rate-blocks and a tail of 1): {total} permutation launches, {group} of them four-lane, "
              f"{cuda_backend.sponge.launches} sponge launches", flush=True)
        if total != STREAM_BLOCKS + 1 or group != 0:
            fail(f"BatchedSponge over {n} streams took {total} permutation launches, {group} four-lane")
        want = cuda_backend.sponge(inst, elems.shape[0], elems.reshape(-1, n).contiguous())
        held(digest.reshape(L, n), want, f"BatchedSponge over {n} streams against the sponge kernel",
             perm_key(False, inst.field.kernel_words))
        print("  its digests equal the sponge kernel's over the same elements", flush=True)
        return total - group, bound(inst, n, n * 2 * inst.width * L * 4)

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
                got = obj.batch.decode_states(obj.batch.hash_bytes(data))
                if got != [[int(w) for w in want] for want in vec["hash_bytes"]["output"]]:
                    fail(f"SAGE hash_bytes mismatch: {field}/{iname}")
                print(f"  {field}/{iname}: {len(vec['hash_field']['input'])} hash_field and {len(data)} "
                      f"hash_bytes vectors exact", flush=True)

    # 1 ---------------------------------------------------------------------
    if run(1):
        phase("1 device")
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi("name,power.limit")
        props = torch.cuda.get_device_properties(0)
        max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        print(f"device: {kind}, {props.multi_processor_count} SMs, max SM clock {max_sm_mhz:.0f} MHz, "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        print(smi, flush=True)
        imad_per_s = props.multi_processor_count * IMAD_PER_CLOCK_PER_SM * max_sm_mhz * 1e6

    # 2 ---------------------------------------------------------------------
    if run(2):
        phase("2 build")
        t = time.perf_counter()
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
        build_s = time.perf_counter() - t
        lib, sponge_lib = built["jive.cu, 8 words"], built["sponge.cu, 8 words"]
        lib12, sponge_lib12 = built["jive.cu, 12 words"], built["sponge.cu, 12 words"]
        mma_libs = {8: built["jive_mma.cu, 8 words"], 12: built["jive_mma.cu, 12 words"]}  # phase 18 reads them
        sponge_mma_libs = {w: built[f"sponge_mma.cu, {w} words"] for w in (8, 12)}  # phase 19 reads them
        for name, b in built.items():
            print(f"build: {name}: nvcc {b.build_seconds if b.build_seconds is not None else 'not run (built earlier)'} "
                  f"s, {b.path.name}", flush=True)
            for line in b.ptxas:
                print(f"  {line}", flush=True)
        print(f"builds and loads, all {len(builds) + 1} at once (with the host packer): {build_s:.2f} s", flush=True)
        sponge_lanes = sponge_lib.cdll.anemoi_sponge_lanes()
        crossover = {w: cuda_backend.permute_group_max(w) for w in cuda_backend.KERNEL_WORDS}
        print(f"kernels by ptxas (registers, spill store and load bytes), resident blocks of 128 threads per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor) and SASS (instructions, local-memory loads and "
              f"stores, shuffles, votes, IMADs; cuobjdump -sass); the sponge and the four-lane permutation run "
              f"{sponge_lanes} lanes per message or state; the permutation launches its four-lane kernel up to "
              f"{crossover[8]} states at 8 words and {crossover[12]} at 12:", flush=True)

        def blocks_per_sm(b, name: str) -> int:
            kernel, args = name.split("<")
            args = [int(a) for a in args.rstrip(">").split(",")]
            if kernel == "jive_kernel":
                return b.cdll.anemoi_jive_blocks_per_sm(*args)
            which = {"permute_kernel": 0, "permute_group_kernel": 1, "sponge_kernel": 2}[kernel]
            return b.cdll.anemoi_sponge_blocks_per_sm(which, *args)

        for words, libs in ((8, (lib, sponge_lib)), (12, (lib12, sponge_lib12))):
            for b in libs:
                counts = sass.kernel_counts(b.path)
                for name, (regs, st, ld) in sorted(sass.ptxas_table(b.ptxas).items()):
                    before = EARLIER_REGISTERS.get((words, name))
                    c = counts.get(name, {})
                    print(f"  {words} words, {name}: {regs} registers, spills {st}/{ld} bytes"
                          + (" (new)" if before is None else
                             f" (earlier: {before}, {'the same' if before == regs else 'changed'})")
                          + f"; {blocks_per_sm(b, name)} blocks per SM; SASS {c.get('instructions')} instructions, "
                          f"LDL {c.get('LDL')}, STL {c.get('STL')}, SHFL {c.get('SHFL')}, VOTE {c.get('VOTE')}, "
                          f"IMAD {c.get('IMAD')}", flush=True)
                    if name.startswith(("jive_kernel", "permute_kernel")) and st + ld:
                        fail(f"{name} at {words} words spills ({st}/{ld} bytes): the one-thread kernels build "
                             f"without spills")
                    if name.startswith(("sponge_kernel", "permute_group_kernel")):
                        lp = c["loop"]
                        print(f"    its innermost loop (a ladder trip: one {sponge_lanes}-lane product of each "
                              f"column): {lp['instructions']} instructions, LDL {lp['LDL']}, STL {lp['STL']}, "
                              f"SHFL {lp['SHFL']}, VOTE {lp['VOTE']}, IMAD {lp['IMAD']}", flush=True)

    # 3 ---------------------------------------------------------------------
    if run(3):
        phase("3 kernel vs plain version")
        cases = [("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 2), ("vesta", "anemoi_4_3", 4)]
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
        # the other 20-limb fields run the same instantiation with their own
        # constants; every lane goes to the native oracle, whose calls cost
        # a millisecond a lane on one core where the plain version's cost seconds
        for field in FIELDS_20:
            if field == "vesta":
                continue
            inst = get_instance(field, "anemoi_2_1")
            states = canonical_states(inst, N_CHECK)
            out = jive_compress_batch_fn(inst, 2, device=dev)(states)
            t = oracle_s.get("phase 3", 0.0)
            want = oracle_jive(inst, states, 2, what="phase 3")
            held_oracle(canonical_host(inst, out), want, f"{field}/anemoi_2_1 k=2", "jive")
            print(f"  {field}/anemoi_2_1 k=2: all {N_CHECK} lanes held against the native oracle "
                  f"({oracle_s['phase 3'] - t:.2f} s): identical", flush=True)

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

        jive_ms = ms = mb.event_ms(lambda: compress(states), REPS)
        jive_bound = bound(inst, N_FULL, N_FULL * (inst.width + 1) * L * 4)
        print(f"  Jive 2-to-1, {N_FULL} states: {ms:.3f} ms per call, {ms * 1e3 / N_FULL:.4f} us per hash, "
              f"{N_FULL / (ms / 1e3):.1f} hashes/s ({smi}; CUDA events, mean of {REPS} after a warm-up; "
              f"{was('jive vesta', ms)})", flush=True)
        show_bound(f"vesta/anemoi_2_1 Jive, {N_FULL} states", jive_bound, jive_ms)

        sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
        xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
        jive_plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, 2, xs))
        held(digests.reshape(L, N_FULL)[:, sample], plain, "2^20 Jive, sampled lanes")
        print(f"  {N_SAMPLE} sampled lanes held against the plain version ({jive_plain_ms:.1f} ms): identical",
              flush=True)
        half = N_ORACLE_FULL // 2
        cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
        want = oracle_jive(inst, states[:, :, cols], 2, what="phase 5 lanes")
        held_oracle(canonical_host(inst, digests[:, :, cols]), want, f"2^20 Jive, {N_ORACLE_FULL} lanes", "jive")
        print(f"  {N_ORACLE_FULL} lanes ({half} at each end) held against the native oracle "
              f"({oracle_s['phase 5 lanes']:.2f} s): identical", flush=True)

        root_ms, root2 = host_time_ms(lambda: tree.root(leaves))
        held(root2, root, "2^20 root, repeated")
        print(f"  Merkle root over {N_FULL} leaves: {root_ms:.3f} ms ({smi}; host clock, synchronized; "
              f"{was('root vesta', root_ms)})", flush=True)

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
        held(tree.root(small), level, f"{SMALL_TREE}-leaf root")
        print(f"  {SMALL_TREE}-leaf root held against the plain version's: identical", flush=True)
        first = leaves[:, :ORACLE_TREE].contiguous()
        want = oracle(native.tree_levels, inst, canonical_host(inst, first)[:, 0], what="phase 5 root")[-1][0]
        held_oracle(canonical_host(inst, tree.root(first))[0, 0], want, f"{ORACLE_TREE}-leaf root", "jive")
        print(f"  {ORACLE_TREE}-leaf root (the first leaves) held against a reduction by the native oracle "
              f"({oracle_s['phase 5 root']:.2f} s): identical", flush=True)

    # 6 ---------------------------------------------------------------------
    if run(6):
        phase("6 permutation and sponge kernels vs plain version")
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            plain_times[("permutation", iname)], plain_lanes[8] = hold_permutation(get_instance("vesta", iname))
        # 1,024 messages all held; then 4,099, which fill neither the last warp (8 messages) nor the last
        # block (32), with 257 held at both ends
        for iname, E, n in (("anemoi_4_3", 3, N_SPONGE_PLAIN), ("anemoi_4_3", 4, N_CHECK), ("anemoi_2_1", 2, N_CHECK)):
            inst = get_instance("vesta", iname)
            m = canonical_rows(inst, E, n)
            out = cuda_backend.sponge(inst, E, m)
            cols = lanes if n == N_CHECK else torch.arange(n, device=dev)
            plain_ms, plain = host_time_ms(lambda: cuda_backend.sponge_plain(inst, E, m[:, cols].contiguous()))
            plain_times[("sponge", iname, E)] = plain_ms
            held(out[:, cols], plain, f"vesta/{iname} sponge E={E}", "sponge")
            t = oracle_s.get("sponge", 0.0)
            want = oracle(native.host_sponge, inst, canonical_host(inst, m), what="sponge")
            held_oracle(canonical_host(inst, out), want, f"vesta/{iname} sponge E={E}", "sponge")
            print(f"  sponge, vesta/{iname}, E={E}: {n} messages, {len(cols)} held against the plain version "
                  f"({plain_ms / 1e3:.2f} s), all {n} against a host sponge over the native oracle's permutation "
                  f"({oracle_s['sponge'] - t:.2f} s in the oracle): identical", flush=True)

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
        E = native.num_elements(MSG_BYTES, objs["anemoi_4_3"].params.field)
        rate43 = objs["anemoi_4_3"].params.rate
        L = objs["anemoi_4_3"].params.field.n_limbs
        blocks = E // rate43
        chunks = [blocks // 4 + (i < blocks % 4) for i in range(4)]  # rate-blocks per chunk
        torch.cuda.synchronize()

        for counter in (cuda_backend.jive, cuda_backend.permutation, cuda_backend.sponge):
            counter.launches = 0
        cuda_backend.permutation.group_launches = 0
        first_ms, full = {}, {}
        for iname, obj in objs.items():
            first_ms[iname], full[iname] = host_time_ms(lambda: obj.batch.hash_bytes(msgs))
        sponge_launches = cuda_backend.sponge.launches
        inst = objs["anemoi_4_3"].params
        mont = mont_messages(inst, pack_messages(inst, msgs), dev)
        streamed = run_stream(inst, mont, chunks)
        torch.cuda.synchronize()
        perm_launches = cuda_backend.permutation.launches
        perm_group_launches = cuda_backend.permutation.group_launches
        print(f"  main path: hash_bytes for vesta/anemoi_4_3 and vesta/anemoi_2_1 over {N_MSGS} x {MSG_BYTES} bytes "
              f"({E} elements each), BatchedSponge over the 4_3 messages in chunks of {chunks} rate-blocks and a "
              f"tail of {E - sum(chunks) * rate43}: {sponge_launches} sponge launches, {perm_launches} permutation "
              f"launches ({perm_group_launches} four-lane), {cuda_backend.jive.launches} Jive launches", flush=True)
        if sponge_launches != len(objs):
            fail(f"hash_bytes took {sponge_launches} sponge launches for {len(objs)} calls")
        if perm_launches != blocks + (E % rate43 > 0):
            fail(f"BatchedSponge took {perm_launches} permutation launches for {blocks} blocks and a tail")
        if perm_group_launches != (perm_launches if N_MSGS <= crossover[8] else 0):
            fail(f"{perm_group_launches} of {perm_launches} permutation launches went to the four-lane kernel")
        for iname, out in full.items():
            if out.shape != (1, L, N_MSGS):
                fail(f"{iname}: digests of shape {out.shape}")
        held(streamed.cpu(), torch.from_numpy(full["anemoi_4_3"]), "BatchedSponge against hash_bytes",
             perm_key(N_MSGS <= crossover[8], 8))
        print("  BatchedSponge digests equal hash_bytes's", flush=True)

        sponge_ms, sponge_bound, e2e_ms = {}, {}, {}
        for iname, obj in objs.items():
            inst = obj.params
            e2e_ms[iname] = host_time_ms(lambda: obj.batch.hash_bytes(msgs))[0]
            pack_ms = time.perf_counter()
            packed = pack_messages(inst, msgs)
            pack_ms = (time.perf_counter() - pack_ms) * 1e3
            x = mont_messages(inst, packed, dev).reshape(E * L, N_MSGS)
            ms = sponge_ms[iname] = mb.event_ms(lambda: cuda_backend.sponge(inst, E, x), SPONGE_REPS)
            perms = -(-E // inst.rate)
            b = sponge_bound[iname] = bound(inst, N_MSGS * perms, N_MSGS * (E + inst.digest_size) * L * 4)
            print(f"  vesta/{iname}: host packing {pack_ms:.1f} ms; sponge kernel {ms:.3f} ms ({SPONGE_REPS} calls "
                  f"after a warm-up, CUDA events; {perms} permutations a message); end to end {e2e_ms[iname]:.1f} ms "
                  f"(host clock around .batch.hash_bytes, synchronized; {first_ms[iname]:.1f} ms in the main-path "
                  f"run, the first); {N_MSGS / (e2e_ms[iname] / 1e3):.1f} msgs/s, "
                  f"{N_MSGS * MSG_BYTES / (e2e_ms[iname] / 1e3) / 1e6:.3f} MB/s end to end; kernel alone "
                  f"{N_MSGS / (ms / 1e3):.1f} msgs/s ({smi})", flush=True)
            show_bound(f"vesta/{iname} sponge, {N_MSGS} messages", b, ms)
            # fewer messages, the first of the same ones: flat times mean each warp runs alone on its
            # scheduler and its own stream sets the pace
            part = {}
            for n in N_MSGS_PARTS:
                xn = x[:, :n].contiguous()
                part[n] = mb.event_ms(lambda: cuda_backend.sponge(inst, E, xn), 1)
            print(f"  vesta/{iname}: sponge kernel over the first " + ", ".join(
                f"{n} messages {t:.3f} ms" for n, t in part.items()) + f"; {N_MSGS}: {ms:.3f} ms", flush=True)
            key = f"vesta/{iname}"
            print(f"  vesta/{iname}, unchanged: kernel {ms:.3f} ms ({was('sponge ' + key, ms)}); end to end "
                  f"{e2e_ms[iname]:.1f} ms" + (f" ({was('e2e ' + key, e2e_ms[iname])})" if 'e2e ' + key in EARLIER_MS
                                               else ""), flush=True)

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
        big = random_on_card(inst, E, N_MSGS_FILL, args.seed).reshape(E * L, N_MSGS_FILL)
        fill_ms = mb.event_ms(lambda: cuda_backend.sponge(inst, E, big), 2)
        fill_bound = bound(inst, N_MSGS_FILL * -(-E // inst.rate), N_MSGS_FILL * (E + 1) * L * 4)
        print(f"  vesta/anemoi_4_3, {N_MSGS_FILL} messages made on the card: sponge kernel {fill_ms:.3f} ms "
              f"(2 calls after a warm-up, CUDA events), {N_MSGS_FILL / (fill_ms / 1e3):.1f} msgs/s; at {N_MSGS} "
              f"messages {N_MSGS / (sponge_ms['anemoi_4_3'] / 1e3):.1f} msgs/s ({smi})", flush=True)
        show_bound(f"vesta/anemoi_4_3 sponge, {N_MSGS_FILL} messages", fill_bound, fill_ms)
        print(f"  {N_MSGS_FILL} messages, unchanged: kernel {fill_ms:.3f} ms "
              f"({was('sponge vesta/anemoi_4_3, 65536', fill_ms)})", flush=True)
        fill_out = cuda_backend.sponge(inst, E, big)
        cols = [0, 1, N_MSGS_FILL // 2, N_MSGS_FILL - 1]
        elems = big.reshape(E, L, N_MSGS_FILL)[:, :, cols].cpu()
        for j, col in enumerate(cols):
            message = lo.decode_ints(elems[:, :, j].T.contiguous(), inst.field)
            if lo.decode_ints(fill_out[:, col:col + 1], inst.field) != golden.hash_field(inst, message):
                fail(f"65,536-message sponge: lane {col} differs from the golden model")
        print(f"  lanes {cols} held against the golden model: identical", flush=True)
        perm_thread_launches, perm_thread_bound = thread_path(
            inst, big.reshape(E, L, N_MSGS_FILL)[:STREAM_BLOCKS * rate43 + 1], "random")
        perm_thread_launches += perm_launches - perm_group_launches
        del big, fill_out

        # the permutation at the shape BatchedSponge gives it, both kernels at 4,096 to 65,536 states
        x = canonical_rows(inst, inst.width, N_MSGS)
        perm_ms = mb.event_ms(lambda: cuda_backend.permutation(inst, x), REPS)
        perm_bound = bound(inst, N_MSGS, N_MSGS * 2 * inst.width * L * 4)
        print(f"  permutation, vesta/anemoi_4_3, {N_MSGS} states: {perm_ms:.3f} ms ({REPS} calls after a warm-up, "
              f"CUDA events; {was('permutation vesta/anemoi_4_3', perm_ms)}; {smi})", flush=True)
        show_bound(f"vesta/anemoi_4_3 permutation, {N_MSGS} states", perm_bound, perm_ms)
        sweep = perm_sweep(inst)
        perm_thread_ms = sweep[N_MSGS_FILL][False]
        show_bound(f"vesta/anemoi_4_3 one-thread permutation, {N_MSGS_FILL} states", perm_thread_bound, perm_thread_ms)
        stream_ms = host_time_ms(lambda: run_stream(inst, mont, chunks))[0]
        print(f"  BatchedSponge end to end over the {N_MSGS} x {MSG_BYTES}-byte elements already on the card: "
              f"{stream_ms:.1f} ms (host clock, synchronized, the second call); its {perm_launches} permutation "
              f"launches at {perm_ms:.3f} ms: {perm_launches * perm_ms:.1f} ms; the rest (the rate adds, stacking, "
              f"launches): {stream_ms - perm_launches * perm_ms:.1f} ms", flush=True)
        del mont

    # 9 ---------------------------------------------------------------------
    if run(9):
        phase("9 the 12-word kernels vs plain version")
        for field, iname, k in (("bls12_381", "anemoi_2_1", 2), ("bls12_381", "anemoi_4_3", 2),
                                ("bls12_381", "anemoi_4_3", 4)):
            inst = get_instance(field, iname)
            W, L = inst.width, inst.field.n_limbs
            x = canonical_rows(inst, W, N_CHECK)
            out = cuda_backend.jive(inst, k, x)
            plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()))
            held(out[:, lanes], plain, f"{field}/{iname} k={k}", "jive_w12")
            print(f"  Jive, {field}/{iname} k={k}: {N_CHECK} lanes, {N_PLAIN} held against the plain version "
                  f"({plain_ms / 1e3:.2f} s): identical", flush=True)
        for iname in ("anemoi_2_1", "anemoi_4_3"):
            plain_times[("permutation_w12", iname)], plain_lanes[12] = hold_permutation(
                get_instance("bls12_377", iname))
        for iname, E in (("anemoi_4_3", 3), ("anemoi_4_3", 4), ("anemoi_2_1", 2)):
            inst = get_instance("bls12_381", iname)
            m = canonical_rows(inst, E, N_CHECK)
            out = cuda_backend.sponge(inst, E, m)
            plain_ms, plain = host_time_ms(lambda: cuda_backend.sponge_plain(inst, E, m[:, lanes].contiguous()))
            plain_times[("sponge_w12", iname, E)] = plain_ms
            held(out[:, lanes], plain, f"bls12_381/{iname} sponge E={E}", "sponge_w12")
            print(f"  sponge, bls12_381/{iname}, E={E}: {N_CHECK} messages, {N_PLAIN} held against the plain version "
                  f"({plain_ms / 1e3:.2f} s): identical", flush=True)

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

        cuda_backend.jive.launches = 0
        digests = compress(states)
        before_root = cuda_backend.jive.launches
        root = tree.root(leaves)
        torch.cuda.synchronize()
        jive12_launches = launches = cuda_backend.jive.launches
        root_launches = launches - before_root
        print(f"  main path: Jive over {N_FULL} states and a {N_FULL}-leaf root: {launches} kernel launches "
              f"({root_launches} for the root)", flush=True)
        if launches != 1 + tree.num_levels(N_FULL):
            fail(f"the main path took {launches} launches, not 1 + {tree.num_levels(N_FULL)}")
        if tuple(digests.shape) != (1, L, N_FULL) or tuple(root.shape) != (L, 1):
            fail(f"shapes {tuple(digests.shape)}, {tuple(root.shape)}")

        jive12_ms = mb.event_ms(lambda: compress(states), REPS)
        jive12_bound = bound(inst, N_FULL, N_FULL * (inst.width + 1) * L * 4)
        print(f"  Jive 2-to-1, {N_FULL} states: {jive12_ms:.3f} ms per call, {jive12_ms * 1e3 / N_FULL:.4f} us per hash, "
              f"{N_FULL / (jive12_ms / 1e3):.1f} hashes/s ({smi}; CUDA events, mean of {REPS} after a warm-up; "
              f"{was('jive bls12_381', jive12_ms)})", flush=True)
        show_bound(f"bls12_381/anemoi_2_1 Jive, {N_FULL} states", jive12_bound, jive12_ms)
        sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
        xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
        jive12_plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, 2, xs))
        held(digests.reshape(L, N_FULL)[:, sample], plain, "BLS12-381 2^20 Jive, sampled lanes", "jive_w12")
        print(f"  {N_SAMPLE} sampled lanes held against the plain version ({jive12_plain_ms:.1f} ms): identical",
              flush=True)
        half = N_ORACLE_W12 // 2
        oracle_cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
        want = oracle_jive(inst, states[:, :, oracle_cols], 2, what="phase 11 bls12_381")
        held_oracle(canonical_host(inst, digests[:, :, oracle_cols]), want, "BLS12-381 2^20 Jive", "jive_w12")
        print(f"  {N_ORACLE_W12} lanes ({half} at each end) held against the native oracle "
              f"({oracle_s['phase 11 bls12_381']:.2f} s): identical", flush=True)

        root12_ms, (root2, levels) = host_time_ms(lambda: tree.root(leaves, return_levels=True))
        held(root2, root, "BLS12-381 2^20 root with return_levels", "jive_w12")
        if len(levels) != tree.num_levels(N_FULL) + 1 or not torch.equal(levels[-1], root):
            fail("return_levels: wrong levels")
        print(f"  Merkle root over {N_FULL} leaves with return_levels: {root12_ms:.3f} ms ({smi}; host clock, "
              f"synchronized; {was('root bls12_381', root12_ms)}); {len(levels)} levels on {levels[1].device}",
              flush=True)
        picks = [0, N_FULL - 1] + sorted(rng.choice(np.arange(1, N_FULL - 1), N_PROOFS - 2, replace=False).tolist())
        prove_ms = time.perf_counter()
        for idx in picks:
            path = tree.prove(levels, idx)
            if len(path) != tree.num_levels(N_FULL) or not tree.verify(root, leaves[:, idx], idx, path):
                fail(f"the proof of leaf {idx} does not verify")
        prove_ms = (time.perf_counter() - prove_ms) * 1e3
        path = tree.prove(levels, picks[2])
        if tree.verify(root, leaves[:, picks[2] ^ 1], picks[2], path):
            fail("a tampered leaf verified")
        print(f"  prove and verify (golden model) for leaves {picks}: all verify ({prove_ms:.1f} ms); leaf "
              f"{picks[2] ^ 1} in place of {picks[2]} fails", flush=True)
        del states, digests, levels, root2

        inst = get_instance("bls12_377", "anemoi_2_1")
        states = canonical_states(inst, N_FULL)
        compress = jive_compress_batch_fn(inst, 2, device=dev)
        out = compress(states)
        jive377_ms = mb.event_ms(lambda: compress(states), REPS)
        jive377_bound = bound(inst, N_FULL, N_FULL * (inst.width + 1) * L * 4)
        print(f"  BLS12-377 Jive 2-to-1, {N_FULL} states: {jive377_ms:.3f} ms per call, "
              f"{N_FULL / (jive377_ms / 1e3):.1f} hashes/s ({smi}; CUDA events, mean of {REPS} after a warm-up; "
              f"{was('jive bls12_377', jive377_ms)})", flush=True)
        show_bound(f"bls12_377/anemoi_2_1 Jive, {N_FULL} states", jive377_bound, jive377_ms)
        cols = np.sort(rng.choice(N_FULL, N_GOLDEN_JIVE, replace=False))
        ins = decode_states(inst, states[:, :, torch.from_numpy(cols).to(dev)])
        got = decode_states(inst, out[:, :, torch.from_numpy(cols).to(dev)])
        if got != [golden.jive_compress_k(inst, s, 2) for s in ins]:
            fail("BLS12-377 2^20 Jive: sampled lanes differ from the golden model")
        print(f"  {N_GOLDEN_JIVE} sampled lanes held against the golden model: identical", flush=True)
        want = oracle_jive(inst, states[:, :, oracle_cols], 2, what="phase 11 bls12_377")
        held_oracle(canonical_host(inst, out[:, :, oracle_cols]), want, "BLS12-377 2^20 Jive", "jive_w12")
        print(f"  {N_ORACLE_W12} lanes ({half} at each end) held against the native oracle "
              f"({oracle_s['phase 11 bls12_377']:.2f} s): identical", flush=True)
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
            cuda_backend.jive.launches = 0
            resumed_root, resumed = tree.root(small, return_levels=True, checkpoint_dir=ckpt)
            resumed_launches = cuda_backend.jive.launches
        held(resumed_root, fresh_root, "resumed root", "jive_w12")
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
        obj = att.bls12_381.anemoi_4_3
        inst = obj.params
        L, rate = inst.field.n_limbs, inst.rate
        msgs = [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
        E = native.num_elements(MSG_BYTES, inst.field)
        blocks = E // rate
        chunks = [blocks // 4 + (i < blocks % 4) for i in range(4)]
        torch.cuda.synchronize()

        for counter in (cuda_backend.jive, cuda_backend.permutation, cuda_backend.sponge):
            counter.launches = 0
        cuda_backend.permutation.group_launches = 0
        first12_ms, full12 = host_time_ms(lambda: obj.batch.hash_bytes(msgs))
        sponge12_launches = cuda_backend.sponge.launches
        mont = mont_messages(inst, pack_messages(inst, msgs), dev)
        streamed = run_stream(inst, mont, chunks)
        torch.cuda.synchronize()
        perm12_launches = cuda_backend.permutation.launches
        perm12_group_launches = cuda_backend.permutation.group_launches
        print(f"  main path: hash_bytes for bls12_381/anemoi_4_3 over {N_MSGS} x {MSG_BYTES} bytes ({E} elements "
              f"each), BatchedSponge in chunks of {chunks} rate-blocks and a tail of {E - sum(chunks) * rate}: "
              f"{sponge12_launches} sponge launch, {perm12_launches} permutation launches ({perm12_group_launches} "
              f"four-lane), {cuda_backend.jive.launches} Jive launches", flush=True)
        if sponge12_launches != 1:
            fail(f"hash_bytes took {sponge12_launches} sponge launches for one call")
        if perm12_launches != blocks + (E % rate > 0):
            fail(f"BatchedSponge took {perm12_launches} permutation launches for {blocks} blocks and a tail")
        if perm12_group_launches != (perm12_launches if N_MSGS <= crossover[12] else 0):
            fail(f"{perm12_group_launches} of {perm12_launches} permutation launches went to the four-lane kernel")
        if full12.shape != (1, L, N_MSGS):
            fail(f"digests of shape {full12.shape}")
        held(streamed.cpu(), torch.from_numpy(full12), "BLS12-381 BatchedSponge against hash_bytes",
             perm_key(N_MSGS <= crossover[12], 12))
        print("  BatchedSponge digests equal hash_bytes's", flush=True)

        e2e12_ms = host_time_ms(lambda: obj.batch.hash_bytes(msgs))[0]
        pack12_ms = time.perf_counter()
        packed = pack_messages(inst, msgs)
        pack12_ms = (time.perf_counter() - pack12_ms) * 1e3
        x = mont_messages(inst, packed, dev).reshape(E * L, N_MSGS)
        sponge12_ms = mb.event_ms(lambda: cuda_backend.sponge(inst, E, x), SPONGE_REPS)
        perms = -(-E // rate)
        sponge12_bound = bound(inst, N_MSGS * perms, N_MSGS * (E + inst.digest_size) * L * 4)
        print(f"  bls12_381/anemoi_4_3: host packing {pack12_ms:.1f} ms; sponge kernel {sponge12_ms:.3f} ms "
              f"({SPONGE_REPS} calls after a warm-up, CUDA events; {perms} permutations a message); end to end "
              f"{e2e12_ms:.1f} ms (host clock around .batch.hash_bytes, synchronized; {first12_ms:.1f} ms in the "
              f"main-path run, the first); {N_MSGS / (e2e12_ms / 1e3):.1f} msgs/s, "
              f"{N_MSGS * MSG_BYTES / (e2e12_ms / 1e3) / 1e6:.3f} MB/s end to end; kernel alone "
              f"{N_MSGS / (sponge12_ms / 1e3):.1f} msgs/s ({smi})", flush=True)
        show_bound(f"bls12_381/anemoi_4_3 sponge, {N_MSGS} messages", sponge12_bound, sponge12_ms)
        print(f"  bls12_381/anemoi_4_3, unchanged: kernel {sponge12_ms:.3f} ms "
              f"({was('sponge bls12_381/anemoi_4_3', sponge12_ms)}); end to end {e2e12_ms:.1f} ms "
              f"({was('e2e bls12_381/anemoi_4_3', e2e12_ms)})", flush=True)
        del x

        picks = sorted(rng.choice(N_MSGS, N_GOLDEN, replace=False).tolist())
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
            want = pool.map(golden_hash_bytes, [("bls12_381", "anemoi_4_3", msgs[i]) for i in picks])
        if decode_states(inst, full12[:, :, picks]) != want:
            fail("bls12_381/anemoi_4_3: sampled 10 KB digests differ from the golden model")
        print(f"  {N_GOLDEN} sampled messages held against the golden model: identical", flush=True)

        # BatchedSponge above the crossover: the one-thread kernel's path
        perm12_thread_launches, perm12_thread_bound = thread_path(
            inst, random_on_card(inst, STREAM_BLOCKS * rate + 1, N_MSGS_FILL, args.seed + 1), "random")
        perm12_thread_launches += perm12_launches - perm12_group_launches

        # the permutation at the shape BatchedSponge gives it, both kernels at 4,096 to 65,536 states
        x = canonical_rows(inst, inst.width, N_MSGS)
        perm12_ms = mb.event_ms(lambda: cuda_backend.permutation(inst, x), REPS)
        perm12_bound = bound(inst, N_MSGS, N_MSGS * 2 * inst.width * L * 4)
        print(f"  permutation, bls12_381/anemoi_4_3, {N_MSGS} states: {perm12_ms:.3f} ms ({REPS} calls after a "
              f"warm-up, CUDA events; {was('permutation bls12_381/anemoi_4_3', perm12_ms)}; {smi})", flush=True)
        show_bound(f"bls12_381/anemoi_4_3 permutation, {N_MSGS} states", perm12_bound, perm12_ms)
        sweep12 = perm_sweep(inst)
        perm12_thread_ms = sweep12[N_MSGS_FILL][False]
        show_bound(f"bls12_381/anemoi_4_3 one-thread permutation, {N_MSGS_FILL} states", perm12_thread_bound,
                   perm12_thread_ms)
        stream12_ms = host_time_ms(lambda: run_stream(inst, mont, chunks))[0]
        print(f"  BatchedSponge end to end over the {N_MSGS} x {MSG_BYTES}-byte elements already on the card: "
              f"{stream12_ms:.1f} ms (host clock, synchronized, the second call); its {perm12_launches} permutation "
              f"launches at {perm12_ms:.3f} ms: {perm12_launches * perm12_ms:.1f} ms; the rest (the rate adds, "
              f"stacking, launches): {stream12_ms - perm12_launches * perm12_ms:.1f} ms", flush=True)
        del mont

    # 14 --------------------------------------------------------------------
    if run(14):
        phase("14 microbenchmarks")
        sms = props.multi_processor_count
        mb.sqr_chain.launches = mb.mad_loop.launches = 0
        chain, chain_plain_ms = {}, {}
        for field in ("vesta", "bls12_381"):
            fp = get_instance(field, "anemoi_2_1").field
            mb.check_chain(field, N_PLAIN, dev, seed=args.seed)
            x = torch.from_numpy(random_canonical(fp, (8,), rng)).to(dev)
            chain_plain_ms[field], plain = host_time_ms(lambda: mb.sqr_chain_plain(fp, x, 8))
            held(mb.sqr_chain(fp, x, 8), plain, f"{field} squaring chain", "sqr_chain")
            c = chain[field] = mb.measure_chain(field, MB_LANES, *CHAIN_TRIPS, MB_REPS, dev, seed=args.seed)
            print(f"  squaring chain, {field} ({c['words']} words): 8-deep chain exact on {N_PLAIN} lanes against "
                  f"Python ints, and on 8 lanes against the plain version ({chain_plain_ms[field]:.1f} ms); "
                  f"{c['lanes']} lanes, {c['n1']} and {c['n2']} squarings: {c['ms1']:.4f} and {c['ms2']:.4f} ms; "
                  f"{c['ns_per_sqr_per_lane']:.6f} ns per squaring per lane, {c['sqr_per_s']:.6g} squarings/s, "
                  f"{c['imads_per_s']:.6g} IMADs/s at {c['imads_per_sqr']} a squaring "
                  f"({c['imads_per_s'] / (sms * max_sm_mhz * 1e6):.2f} per clock per SM at {max_sm_mhz:.0f} MHz; "
                  f"{smi})", flush=True)
        x = torch.from_numpy(np.random.default_rng(args.seed).integers(1, 1000, size=(20, 512), dtype=np.int32))
        mad_plain_ms, plain = host_time_ms(lambda: mb.mad_loop_plain(x.to(dev), 100))
        held(mb.mad_loop(x.to(dev), 100), plain, "multiply-add loop", "mad_loop")
        print(f"  multiply-add loop: 10,240 elements x 100 iterations held against the plain version "
              f"({mad_plain_ms:.1f} ms): identical", flush=True)
        mad = {}
        for shape in (*mb.MAD_SHAPES, mb.fill_shape(sms)):
            r = mad[shape] = mb.measure_mad(shape, *MAD_TRIPS, MB_REPS, dev, sms=sms, clock_mhz=max_sm_mhz, seed=args.seed)
            print(f"  multiply-add loop, shape {shape}: {r['elements']} elements on {r['busy_sms']} SMs; "
                  f"{r['ns_per_iter']:.4f} ns per iteration, {r['ns_per_elem_iter']:.6f} ns per element-iteration, "
                  f"{r['iters_per_clock_per_sm']:.3f} iterations per clock per busy SM at {max_sm_mhz:.0f} MHz",
                  flush=True)
        fill = mad[mb.fill_shape(sms)]
        mad_rate = fill["iters_per_clock_per_sm"]
        mad_sass = [line for line in mb.mad_sass() if not line.endswith("NOP;")]
        print(f"  mad_loop_kernel SASS ({len(mad_sass)} instructions but NOPs; cuobjdump -sass):", flush=True)
        for line in mad_sass:
            print(f"    {line}", flush=True)
        print(f"  measured: {mad_rate:.3f} multiply-add iterations per clock per SM with the card filled, against "
              f"the {IMAD_PER_CLOCK_PER_SM} IMADs per clock per SM the bound assumes", flush=True)
        mb_launches = {"sqr_chain": mb.sqr_chain.launches, "mad_loop": mb.mad_loop.launches}

    # 16 --------------------------------------------------------------------
    if run(16):
        phase("16 full width: the CLI, AsyncByteHasher, the forest and the utils")
        import torch.distributed as dist

        from anemoi_tpu_torch.dist import forest, mesh
        from anemoi_tpu_torch.modes.async_pipeline import AsyncByteHasher
        from anemoi_tpu_torch.utils import debug, profiling

        def reset_counts():
            for counter in (cuda_backend.jive, cuda_backend.permutation, cuda_backend.sponge):
                counter.launches = 0
            cuda_backend.permutation.group_launches = 0

        slice4 = {}  # this phase's launches, for the kernels line
        t16 = time.perf_counter()
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
                launches = {"sponge": sum(e >= inst.rate for e in counts), "permutation": sum(e < inst.rate for e in counts)}
                if any(stats[k] != v for k, v in launches.items()) or stats["jive"]:
                    fail(f"cli hash {field}/{iname}: launches {stats}, expected {launches}")
                slice4[f"cli_hash {field}/{iname}"] = {k: stats[k] for k in launches}
                print(f"  cli hash, {field}/{iname}: {N_CLI_FILES} files of {len(CLI_LENGTHS)} lengths from 0 to "
                      f"{MSG_BYTES} bytes ({len(counts) + 1} element counts): digests equal .batch.hash_bytes's, "
                      f"{N_CLI_GOLDEN} the golden model's; {stats['sponge']} sponge and {stats['permutation']} "
                      f"permutation launches; {stats['seconds']:.3f} s in the command", flush=True)
            if results[hash_cases[0]][0][0] != HELLO_WORLD:
                fail(f"cli hash of b'hello world': {results[hash_cases[0]][0][0]}, not {HELLO_WORLD}")
            print(f"  cli hash of b'hello world', vesta/anemoi_2_1: {HELLO_WORLD}", flush=True)
            print(f"  cli info: {results['info'][0][0]}; cli vectors: {len(results['vectors'][0])} files, "
                  f"exit 0 ({time.perf_counter() - t16:.1f} s into the phase)", flush=True)

            t = time.perf_counter()
            lines, stats = cli_result(run_cli("merkle", "--stats", str(merkle_file)), "cli merkle")
            merkle_wall_s = time.perf_counter() - t
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
            slice4["cli_merkle"] = {"jive": stats["jive"], "seconds": stats["seconds"], "wall_s": merkle_wall_s}
            print(f"  cli merkle, {CLI_MERKLE_BYTES} bytes ({N_FULL - 1} elements and one zero leaf): root equals "
                  f"MerkleTree.root's over the same leaves, {stats['jive']} Jive launches; {merkle_wall_s:.3f} s "
                  f"wall (the process, from start to exit), {stats['seconds']:.3f} s in the command (read, pack, "
                  f"to Montgomery form, root) ({smi}; {time.perf_counter() - t16:.1f} s into the phase)", flush=True)
            del leaves

        # AsyncByteHasher over phase 8's messages in 4 batches, against .batch.hash_bytes
        msgs = sponge_msgs or [rng.bytes(MSG_BYTES) for _ in range(N_MSGS)]
        obj = att.vesta.anemoi_4_3
        inst = obj.params
        batches = [msgs[i:i + ASYNC_BATCH] for i in range(0, N_MSGS, ASYNC_BATCH)]

        def run_async():
            pipe, got = AsyncByteHasher(inst, device=dev), []
            for batch in batches:
                got.extend(pipe.feed(batch))
            got.extend(pipe.drain())
            return got

        reset_counts()
        first_ms, got = host_time_ms(run_async)
        slice4["async"] = {"sponge": cuda_backend.sponge.launches}
        if cuda_backend.sponge.launches != len(batches) or cuda_backend.permutation.launches:
            fail(f"AsyncByteHasher took {cuda_backend.sponge.launches} sponge launches for {len(batches)} batches")
        want = digest_export_fn(inst)(torch.from_numpy(obj.batch.hash_bytes(msgs)).to(dev)).cpu().numpy()
        if len(got) != len(batches) or not np.array_equal(np.concatenate(got, axis=2), want):
            fail("AsyncByteHasher's digests differ from .batch.hash_bytes's")
        for d in got:
            debug.check_limbs(d, inst.field, what="AsyncByteHasher digests")
        timer = profiling.Timer(device=dev)
        with timer.section("AsyncByteHasher"):
            run_async()
        with timer.section(".batch.hash_bytes"):
            obj.batch.hash_bytes(msgs)
        with timer.section("packing"):
            pack_messages(inst, msgs)
        sec = {k: v * 1e3 for k, v in timer.sections.items()}
        slice4["async"].update({"ms": sec["AsyncByteHasher"], "hash_bytes_ms": sec[".batch.hash_bytes"],
                                "pack_ms": sec["packing"], "first_ms": first_ms})
        print(f"  AsyncByteHasher, vesta/anemoi_4_3, {N_MSGS} x {MSG_BYTES} bytes in {len(batches)} batches of "
              f"{ASYNC_BATCH}: {len(batches)} sponge launches; digests equal .batch.hash_bytes's and pass "
              f"check_limbs; end to end {sec['AsyncByteHasher']:.1f} ms against .batch.hash_bytes's "
              f"{sec['.batch.hash_bytes']:.1f} ms in one call; packing alone {sec['packing']:.1f} ms (utils Timer, "
              f"synchronized, after the main-path run of {first_ms:.1f} ms; {smi}; "
              f"{time.perf_counter() - t16:.1f} s into the phase)", flush=True)

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
                reset_counts()
                froot = fn(local)
                torch.cuda.synchronize()
                slice4["forest"] = {"jive": cuda_backend.jive.launches}
                held(froot, MerkleTree(inst, device=dev).root(fleaves), "the forest's root", "jive")
                if slice4["forest"]["jive"] != 20:
                    fail(f"the forest took {slice4['forest']['jive']} Jive launches, not 20")
                traffic = mesh.collective_traffic(fn, local)
                backend = dist.get_backend()
            finally:
                dist.destroy_process_group()
        print(f"  the forest, {N_FULL} Vesta 2_1 leaves over 1 rank ({backend}, file:// store): root equals "
              f"MerkleTree.root's, {slice4['forest']['jive']} Jive launches; collective_traffic: "
              f"{json.dumps(traffic)} ({time.perf_counter() - t16:.1f} s into the phase)", flush=True)

        # the utils: one 2^20 Jive under trace, its digests through check_limbs
        states = canonical_states(inst, N_FULL)
        compress = jive_compress_batch_fn(inst, 2, device=dev)
        untraced = compress(states)
        torch.cuda.synchronize()
        reset_counts()
        with tempfile.TemporaryDirectory() as tdir:
            with profiling.trace(tdir) as prof:
                traced = compress(states)
                torch.cuda.synchronize()
            slice4["trace"] = {"jive": cuda_backend.jive.launches}
            events = json.loads(prof.trace_path.read_text())["traceEvents"]
        names = sorted({str(e.get("name")) for e in events if "jive_kernel" in str(e.get("name", ""))})
        if not names or slice4["trace"]["jive"] != 1:
            fail(f"the trace names no Jive kernel ({slice4['trace']['jive']} launches)")
        device_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                        for e in prof.key_averages() if "jive_kernel" in e.key)
        held(traced, untraced, "the traced Jive", "jive")
        canon = digest_export_fn(inst)(traced)
        debug.check_limbs(canon, inst.field, what="the traced Jive's canonical digests")
        print(f"  trace of one {N_FULL}-state Jive: {len(events)} events, the kernel named {names}; device time "
              f"{device_us / 1e3:.3f} ms (profiler); its canonical digests pass check_limbs", flush=True)
        del states, untraced, traced, canon, fleaves

    # 17 --------------------------------------------------------------------
    if run(17):
        phase("17 the bench, the matrix, the verifier, the entry and the demo, each a process of its own")
        from anemoi_tpu_torch import graft_entry
        from anemoi_tpu_torch.bench import _ROW, HEADLINE
        from anemoi_tpu_torch.tools.verify_cuda import kernel_launches

        t17 = time.perf_counter()
        since = lambda: f"{time.perf_counter() - t17:.1f} s into the phase"
        slice5 = {"bench": {}}  # the launches the bench and the matrix report, by kernel

        def add_launches(words: int, launches: dict) -> None:
            for k, v in kernel_launches(words, launches).items():
                slice5["bench"][k] = slice5["bench"].get(k, 0) + v

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
        phase5_rate = N_FULL / (jive_ms / 1e3)
        if abs(head["value"] / phase5_rate - 1) > HEADLINE_TOLERANCE:
            fail(f"the bench's headline {head['value']} hashes/s is not within {HEADLINE_TOLERANCE:.0%} of phase 5's "
                 f"{phase5_rate:.1f}: the bench times something other than the kernel")
        dry = configs["multichip_dryrun_collective_bytes_per_device"]
        if dry["value"] != dry["n_devices"] * 20 * 4 or dry["collective_counts"] != {"all-gather": 1}:
            fail(f"the dry run's collectives: {dry}")
        print(f"  the bench (python3 -m anemoi_tpu_torch.bench, {doc['device']}): headline {head['value']} hashes/s "
              f"({doc['ms']:.3f} ms a call, the median of its host-clock reps; vs_baseline {head['vs_baseline']}), "
              f"phase 5's CUDA-event rate {phase5_rate:.1f} ({head['value'] / phase5_rate:.4f}x); "
              f"{doc['parity_lanes']} lanes held; launches {doc['launches']}", flush=True)
        add_launches(doc["words"], doc["launches"])
        for c in configs.values():
            if "launches" in c:
                add_launches(c["words"], c["launches"])
            extra = {k: c[k] for k in ("vs_reference_core", "mb_per_sec", "ms", "n", "parity_lanes", "launches",
                                       "n_devices", "n_leaves", "t1_sec", "tN_sec") if k in c}
            print(f"    {c['metric']}: {c['value']} {c['unit']} {json.dumps(extra)}", flush=True)
        tree = configs["vesta_anemoi_4_3_merkle_2p24_arity4"]
        inst = get_instance("vesta", "anemoi_4_3")
        L = inst.field.n_limbs
        # (4^12 - 1) / 3 Jive-4 nodes, one permutation each; the leaves read once, the root written once
        tree_bound = bound(inst, (TREE_LEAVES - 1) // 3, (TREE_LEAVES + 1) * L * 4)
        slice5.update(tree_ms=tree["ms"], tree_bound=tree_bound, tree_launches=tree["launches"]["jive"])
        print(f"  BASELINE config 4, the arity-4 Vesta 4_3 tree over {TREE_LEAVES} leaves: {tree['ms']:.3f} ms "
              f"({smi}; the median of 2 reps, host clock, synchronized), {tree['launches']['jive']} Jive launches "
              f"(a 16-leaf warm-up and 2 x 12 levels), {tree['parity_lanes']} nodes held against the golden model "
              f"({since()})", flush=True)
        show_bound(f"the arity-4 tree over {TREE_LEAVES} leaves, {(TREE_LEAVES - 1) // 3} permutations", tree_bound,
                   tree["ms"])
        if tree["launches"]["jive"] != 2 + 2 * 12:
            fail(f"the 2^24-leaf tree took {tree['launches']['jive']} Jive launches, not 2 + 2 x 12")

        # the tree's first level again, in this process from the bench's leaves (seed 0): Jive-4 over 2^22 states,
        # N_PLAIN lanes at both ends against the plain version and N_ORACLE_FULL against the native oracle
        leaves = torch.from_numpy(random_canonical(inst.field, (TREE_LEAVES,), np.random.default_rng(0))).to(dev)
        x = level_states(leaves, 4)
        del leaves
        n4 = x.shape[1]
        level1 = cuda_backend.jive(inst, 4, x)
        torch.cuda.synchronize()
        cols = ends(n4)
        plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, 4, x[:, cols].contiguous()))
        held(level1[:, cols], plain, f"the 2^24-leaf tree's first level, {n4} Jive-4 states, both ends", "jive")
        half = N_ORACLE_FULL // 2
        cols = torch.cat([torch.arange(half), torch.arange(n4 - half, n4)]).to(dev)
        want = oracle_jive(inst, x[:, cols], 4, what="phase 17 tree")
        held_oracle(canonical_host(inst, level1[:, cols]), want, f"the tree's first level, {N_ORACLE_FULL} lanes",
                    "jive")
        print(f"  the tree's first level in this process (the bench's leaves): Jive-4 over {n4} states, {N_PLAIN} "
              f"lanes at both ends held against the plain version ({plain_ms / 1e3:.2f} s), {N_ORACLE_FULL} "
              f"({half} at each end) against the native oracle ({oracle_s['phase 17 tree']:.2f} s): identical "
              f"({since()})", flush=True)
        del x, level1

        # the matrix's shape for all 14 instantiations, in this process: Jive-2 over MATRIX_N states made on the
        # card, N_ORACLE_MATRIX lanes at both ends against the native oracle
        half = N_ORACLE_MATRIX // 2
        cols = torch.cat([torch.arange(half), torch.arange(MATRIX_N - half, MATRIX_N)]).to(dev)
        for seed, (field, iname) in enumerate((f, i) for f in FIELD_NAMES for i in INSTANCE_NAMES):
            inst_m = get_instance(field, iname)
            x = random_on_card(inst_m, inst_m.width, MATRIX_N, args.seed + seed)
            out = jive_compress_batch_fn(inst_m, 2, device=dev)(x)
            want = oracle_jive(inst_m, x[:, :, cols], 2, what="phase 17 matrix")
            held_oracle(canonical_host(inst_m, out[:, :, cols]), want, f"{field}/{iname} Jive over {MATRIX_N}",
                        "jive" if inst_m.field.kernel_words == 8 else "jive_w12")
        print(f"  the matrix's 14 instantiations in this process: Jive-2 over {MATRIX_N} states each, "
              f"{N_ORACLE_MATRIX} lanes ({half} at each end) held against the native oracle "
              f"({oracle_s['phase 17 matrix']:.2f} s): identical ({since()})", flush=True)
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
                lines = module_result(run_module("anemoi_tpu_torch.bench", "--matrix", "--n", str(MATRIX_N), "--out",
                                                 str(matrix_path)), "the matrix", timeout=900)
                rows = _ROW.findall(matrix_path.read_text())
                if len(rows) != 14 or any(parity != "4 lanes exact" for *_, parity in rows):
                    fail(f"the matrix: {len(rows)} rows, {[r[-1] for r in rows]}")
                for r in json.loads(lines[-1])["matrix"]:
                    add_launches(r["words"], r["launches"])
                print(f"  the matrix (--matrix --n {MATRIX_N}): 14 rows, each with 4 lanes held ({since()}):",
                      flush=True)
                for f, i, rate, vs, parity in rows:
                    print(f"    | {f} | {i} | {rate} | {vs} | {parity} |", flush=True)

                lines = module_result(run_module("anemoi_tpu_torch.tools.verify_cuda", "--fields", "all"),
                                      "the verifier", timeout=900)
                if not lines[-1].endswith("ALL PASS") or any(line.startswith("FAIL") for line in lines):
                    fail("the verifier:\n" + "\n".join(lines))
                slice5["verify"] = json.loads(lines[-2][len("launches: "):])
                passed = sum(line.startswith("PASS") for line in lines)
                print(f"  the verifier (tools.verify_cuda --fields all): {passed} PASS lines, {lines[-1]}; launches "
                      f"{slice5['verify']} ({since()})", flush=True)
                for line in lines[:-2]:
                    print(f"    {line}", flush=True)

                lines = module_result(run_module("anemoi_tpu_torch.tools.multihost_demo", "--procs", "1", "--leaves",
                                                 str(DEMO_LEAVES), "--device", "cuda"), "the NCCL demo")
                if lines[-1] != "multihost demo: OK":
                    fail(f"the NCCL demo: {lines}")
                lines = module_result(demo_gloo, "the gloo demo", timeout=900)
                if lines[-1] != "multihost demo: OK":
                    fail(f"the gloo demo: {lines}")
                print(f"  the demo (tools.multihost_demo, {DEMO_LEAVES} leaves): 2 gloo workers OK, 1 NCCL rank OK "
                      f"({since()})", flush=True)

                fn, (example,) = graft_entry.entry()
                torch.cuda.synchronize()
                cuda_backend.jive.launches = 0
                out = fn(example)
                torch.cuda.synchronize()
                slice5["entry"] = cuda_backend.jive.launches
                if not torch.equal(example.cpu(), example_cpu) or slice5["entry"] != 1:
                    fail(f"the entry: examples differ or {slice5['entry']} launches")
                held(out.cpu(), entry_cpu.result(), "the entry on the card against its function on the CPU", "jive")
                dryrun.result()
        finally:
            demo_gloo.kill()
            demo_gloo.wait()
        print(f"  the entry: graft_entry.entry() on the card, 1 Jive launch, bit-identical to its function on the CPU "
              f"on all {example.shape[-1]} lanes; dryrun_multichip(2) on 2 gloo ranks ok ({since()})", flush=True)
        del out, example

    # 18 --------------------------------------------------------------------
    if run(18):
        phase(f"18 the tensor-core Jive kernel (mul_impl {MMA_IMPL!r}): SASS, fragment layouts, the main path, full "
              f"size, holds, the bench")
        from anemoi_tpu_torch.ff import mxu_ops

        t18 = time.perf_counter()
        since18 = lambda: f"{time.perf_counter() - t18:.1f} s into the phase"
        mma = {"ms": {}, "jive_ms": {}, "bound": {}, "plain_ms": {}}
        for words, b in mma_libs.items():
            for kernel, r in sorted(sass.mma_report(b).items()):
                width, k = (int(a) for a in kernel.split("<")[1].rstrip(">").split(","))
                print(f"  {words} words, {kernel}: {r['registers']} registers, spills {r['spill_store']}/"
                      f"{r['spill_load']} bytes, {b.cdll.anemoi_jive_mma_blocks_per_sm(width, k)} blocks per SM; "
                      f"SASS {r['whole']['instructions']:g} instructions, IMMA {r['whole']['IMMA']:g}; a product "
                      f"(the window's trip, a squaring and a product, over its 2): "
                      + ", ".join(f"{k} {v:g}" for k, v in r["product"].items()), flush=True)
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
        print(f"  mma.sync m16n8k32 and m16n8k16 (u8) on the card: the fragment layouts of mxu_ops and HostWarp "
              f"hold ({since18()})", flush=True)

        # the main path with the tensor-core product: Jive over N_FULL states and the N_FULL-leaf root
        inst = get_instance("vesta", "anemoi_2_1")
        states = canonical_states(inst, N_FULL)
        leaves = torch.from_numpy(random_canonical(inst.field, (N_FULL,), rng)).to(dev)
        compress = jive_compress_batch_fn(inst, 2, device=dev, mul_impl=MMA_IMPL)
        tree = MerkleTree(inst, device=dev, mul_impl=MMA_IMPL)
        torch.cuda.synchronize()
        cuda_backend.jive.launches = cuda_backend.jive_mma.launches = 0
        digests = compress(states)
        root = tree.root(leaves)
        torch.cuda.synchronize()
        mma["launches"], default_launches = cuda_backend.jive_mma.launches, cuda_backend.jive.launches
        print(f"  main path, mul_impl {MMA_IMPL!r}: Jive over {N_FULL} states and a {N_FULL}-leaf root: "
              f"{mma['launches']} jive_mma launches, {default_launches} jive_kernel launches", flush=True)
        if mma["launches"] != 1 + tree.num_levels(N_FULL) or default_launches:
            fail(f"the mxu main path took {mma['launches']} jive_mma and {default_launches} jive_kernel launches")
        held(digests, jive_compress_batch_fn(inst, 2, device=dev)(states), f"{N_FULL} Jive, against jive_kernel",
             "jive_mma")
        held(root, MerkleTree(inst, device=dev).root(leaves), f"the {N_FULL}-leaf root, against the default root",
             "jive_mma")
        print(f"  its {N_FULL} digests equal jive_kernel's; MerkleTree(mul_impl={MMA_IMPL!r}).root equals the default "
              f"root ({since18()})", flush=True)
        # the root's time, in turns with the default root (CUDA events around each call's levels)
        default_tree = MerkleTree(inst, device=dev)
        r_int = mb.event_ms(lambda: default_tree.root(leaves), MMA_REPS)
        r_mma = mb.event_ms(lambda: tree.root(leaves), MMA_REPS)
        r_mma2 = mb.event_ms(lambda: tree.root(leaves), MMA_REPS)
        r_int2 = mb.event_ms(lambda: default_tree.root(leaves), MMA_REPS)
        mma["root_ms"], mma["root_jive_ms"] = (r_mma + r_mma2) / 2, (r_int + r_int2) / 2
        print(f"  the {N_FULL}-leaf root ({tree.num_levels(N_FULL)} launches; {smi}; CUDA events, {MMA_REPS} calls after "
              f"a warm-up, in turns default, mma, mma, default): mul_impl {MMA_IMPL!r} {r_mma:.3f} and {r_mma2:.3f} ms, "
              f"default (jive_kernel) {r_int:.3f} and {r_int2:.3f} ms "
              f"({mma['root_jive_ms'] / mma['root_ms']:.3f}x) ({since18()})", flush=True)
        del leaves, digests

        # full size, the card to itself: each field's 2_1 Jive over N_FULL states, every lane held against
        # jive_kernel, then both timed in turns (CUDA events); the 12-word path's launch counted alone
        outs = {}
        for field in MMA_FIELDS:
            inst = get_instance(field, "anemoi_2_1")
            words = inst.field.kernel_words
            x = states.reshape(-1, N_FULL) if field == "vesta" else canonical_states(inst, N_FULL).reshape(-1, N_FULL)
            cuda_backend.jive_mma.launches = 0
            outs[field] = cuda_backend.jive(inst, 2, x, MMA_IMPL), x
            torch.cuda.synchronize()
            if field == "bls12_381":
                mma["launches_w12"] = cuda_backend.jive_mma.launches
            held(outs[field][0], cuda_backend.jive(inst, 2, x), f"{field} {N_FULL} Jive, every lane against jive_kernel",
                 "jive_mma" if words == 8 else "jive_mma_w12")
            t_jive = mb.event_ms(lambda: cuda_backend.jive(inst, 2, x), MMA_REPS)
            t_mma = mb.event_ms(lambda: cuda_backend.jive(inst, 2, x, MMA_IMPL), MMA_REPS)
            t_mma2 = mb.event_ms(lambda: cuda_backend.jive(inst, 2, x, MMA_IMPL), MMA_REPS)
            t_jive2 = mb.event_ms(lambda: cuda_backend.jive(inst, 2, x), MMA_REPS)
            mma["ms"][field], mma["jive_ms"][field] = (t_mma + t_mma2) / 2, (t_jive + t_jive2) / 2
            b = mma["bound"][field] = mma_bound(inst, N_FULL, N_FULL * (inst.width + inst.width // 2)
                                                * inst.field.n_limbs * 4)
            print(f"  {field}/anemoi_2_1 Jive over {N_FULL} states, every lane equal to jive_kernel's ({words} words; "
                  f"{smi}; CUDA events, {MMA_REPS} calls after a warm-up, in turns jive_kernel, mma, mma, jive_kernel): "
                  f"tensor-core kernel "
                  f"{t_mma:.3f} and {t_mma2:.3f} ms, jive_kernel {t_jive:.3f} and {t_jive2:.3f} ms "
                  f"({mma['jive_ms'][field] / mma['ms'][field]:.3f}x); bound {b['bound_ms']:.3f} ms by {b['unit']} "
                  f"(per permutation {b['imads']} IMADs left, {b['imad_ms']:.3f} ms; {b['macs']} u8 MACs, "
                  f"{b['mac_ms']:.3f} ms at {INT8_MAC_PER_S:.4g}/s; bytes {b['bytes_ms']:.4f} ms): kernel at "
                  f"{b['bound_ms'] / mma['ms'][field]:.1%} of it ({since18()})", flush=True)
        torch.cuda.synchronize()
        del states

        # the bench with the tensor-core product, a process of its own, beside this process's checks
        bench_mma = run_module("anemoi_tpu_torch.bench", "--impl", MMA_IMPL)
        try:
            half = N_ORACLE_FULL // 2
            cols = torch.cat([torch.arange(half), torch.arange(N_FULL - half, N_FULL)]).to(dev)
            for field, (out, x) in outs.items():
                inst = get_instance(field, "anemoi_2_1")
                want = oracle_jive(inst, x.reshape(inst.width, -1, N_FULL)[:, :, cols], 2, what=f"phase 18 {field}")
                held_oracle(canonical_host(inst, out[:, cols]), want, f"{field} {N_FULL} Jive, {MMA_IMPL}",
                            "jive_mma" if inst.field.kernel_words == 8 else "jive_mma_w12")
            print(f"  {N_ORACLE_FULL} lanes ({half} at each end) of each held against the native oracle ("
                  + ", ".join(f"{f} {oracle_s[f'phase 18 {f}']:.2f} s" for f in outs) + f"): identical ({since18()})",
                  flush=True)
            del outs

            # 4,099 states (the last warp ragged): every lane against jive_kernel, N_PLAIN at both ends against the
            # plain version; the other 20-limb fields' 2_1, every lane against the native oracle
            for field, iname, k in (("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 2),
                                    ("vesta", "anemoi_4_3", 4), ("bls12_381", "anemoi_2_1", 2),
                                    ("bls12_377", "anemoi_2_1", 2)):
                inst = get_instance(field, iname)
                W, L, words = inst.width, inst.field.n_limbs, inst.field.kernel_words
                key = "jive_mma" if words == 8 else "jive_mma_w12"
                x = canonical_states(inst, N_CHECK).reshape(W * L, N_CHECK)
                out = cuda_backend.jive(inst, k, x, MMA_IMPL)
                held(out, cuda_backend.jive(inst, k, x), f"{field}/{iname} k={k}, against jive_kernel", key)
                plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, k, x[:, lanes].contiguous()))
                held(out[:, lanes], plain, f"{field}/{iname} k={k}, against the plain version", key)
                if (iname, k) == ("anemoi_2_1", 2):
                    mma["plain_ms"].setdefault(words, plain_ms)
                print(f"  {field}/{iname} k={k}: {N_CHECK} lanes, all held against jive_kernel and {N_PLAIN} against "
                      f"the plain version ({plain_ms / 1e3:.2f} s): identical", flush=True)
            for field in FIELDS_20:
                if field == "vesta":
                    continue
                inst = get_instance(field, "anemoi_2_1")
                st = canonical_states(inst, N_CHECK)
                out = jive_compress_batch_fn(inst, 2, device=dev, mul_impl=MMA_IMPL)(st)
                want = oracle_jive(inst, st, 2, what="phase 18")
                held_oracle(canonical_host(inst, out), want, f"{field}/anemoi_2_1 k=2, {MMA_IMPL}", "jive_mma")
            print(f"  the other 20-limb fields' anemoi_2_1, all {N_CHECK} lanes each against the native oracle "
                  f"({oracle_s['phase 18']:.2f} s): identical ({since18()})", flush=True)
            lines = module_result(bench_mma, f"the bench with --impl {MMA_IMPL}", timeout=900)
        finally:
            bench_mma.kill()
            bench_mma.wait()
        doc = json.loads([line for line in lines if line.startswith("{")][-1])
        runs = [doc, *(c for c in doc["configs"] if "launches" in c)]
        mma["bench_launches"] = sum(c["launches"].get("jive_mma", 0) for c in runs)
        if not doc["launches"]["jive_mma"] or doc["launches"]["jive"] or any(
                c.get("parity") != "ok" for c in runs):
            fail(f"the bench with --impl {MMA_IMPL}: headline launches {doc['launches']}, parity "
                 f"{[c.get('parity') for c in runs]}")
        print(f"  the bench (python3 -m anemoi_tpu_torch.bench --impl {MMA_IMPL}, beside this phase's checks): "
              f"headline {doc['value']} hashes/s, {len(runs)} runs with their parity ok, {mma['bench_launches']} "
              f"jive_mma launches in all ({since18()})", flush=True)
        print(f"  phase 18: {time.perf_counter() - t18:.1f} s; {time.perf_counter() - T0:.1f} s since the script "
              f"started", flush=True)

    # 19 --------------------------------------------------------------------
    if run(19):
        phase(f"19 the tensor-core permutation and sponge (mul_impl {MMA_IMPL!r}): SASS, the main path, full size "
              f"beside the integer kernels, holds, the verifier")
        t19 = time.perf_counter()
        since19 = lambda: f"{time.perf_counter() - t19:.1f} s into the phase"
        mma19 = {"ms": {}, "int_ms": {}, "bound": {}, "perm_plain": {}, "sponge_plain_ms": {}, "launches": {},
                 "sweep": {}}
        mma_top = {w: cuda_backend.permute_mma_group_max(w) for w in sponge_mma_libs}
        for words, b in sponge_mma_libs.items():
            for kernel, r in sorted(sass.mma_report(b).items()):
                name, width = kernel.split("<")[0], int(kernel.split("<")[1].rstrip(">"))
                which = ("permute_mma_kernel", "sponge_mma_kernel", "permute_mma_thread_kernel").index(name)
                trip = f"{width // 2}-fold product" if name in sass.QUAD_KERNELS else "squaring and product"
                print(f"  {words} words, {kernel}: {r['registers']} registers, spills {r['spill_store']}/"
                      f"{r['spill_load']} bytes, {b.cdll.anemoi_sponge_mma_blocks_per_sm(which, width)} blocks of "
                      f"{b.cdll.anemoi_sponge_mma_block_threads(which)} threads per SM; SASS "
                      f"{r['whole']['instructions']:g} instructions, IMMA {r['whole']['IMMA']:g}; a product (the "
                      f"window's trip, one {trip}, over its products): "
                      + ", ".join(f"{k} {v:g}" for k, v in r["product"].items()), flush=True)
                if not r["whole"]["IMMA"]:
                    fail(f"{kernel} at {words} words has no IMMA instruction")
        print(f"  the permutation launches its quad form up to {mma_top[8]} states at 8 words and {mma_top[12]} at 12 "
              f"(PERMUTE_MMA_GROUP_MAX), its thread form above", flush=True)

        def zero_counts() -> None:
            for counter in (cuda_backend.jive, cuda_backend.jive_mma, cuda_backend.permutation, cuda_backend.sponge,
                            cuda_backend.permutation_mma, cuda_backend.sponge_mma):
                counter.launches = 0
            cuda_backend.permutation.group_launches = cuda_backend.permutation_mma.quad_launches = 0

        def in_turns(kernel, mma_kernel, reps: int) -> tuple[float, float]:
            """The two calls timed with CUDA events in turns kernel, mma, mma, kernel, `reps` calls a turn, after
            one warm-up call of each: the mean ms of each one's two turns."""
            kernel(), mma_kernel()
            ms = {kernel: [], mma_kernel: []}
            for fn in (kernel, mma_kernel, mma_kernel, kernel):
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                ms[fn].append(start.elapsed_time(end) / reps)
            return sum(ms[kernel]) / 2, sum(ms[mma_kernel]) / 2

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

        # the main path, each word count's run with every count set to 0 just before and read just after: the
        # permutation at each size and the sponge over 4,096 x 10 KB, through cuda_backend with the name
        outs = {}
        for words in (8, 12):
            perms = [(c, n) for c in MMA_PERMS for n in MMA_PERM_NS if get_instance(*c).field.kernel_words == words]
            sponges = [c for c in MMA_SPONGES if get_instance(*c).field.kernel_words == words]
            zero_counts()
            for (field, iname), n in perms:
                outs[(field, n)] = cuda_backend.permutation(get_instance(field, iname), perm_in[field][n], MMA_IMPL)
            for case in sponges:
                E, m = sponge_in[case]
                outs[case] = cuda_backend.sponge(get_instance(*case), E, m, MMA_IMPL)
            torch.cuda.synchronize()
            counts = cuda_backend.launch_counts()
            mma19["launches"][words] = counts
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
        print(f"  ({since19()})", flush=True)

        # in turns with the integer kernel the port runs without the name, the card to itself
        for field, iname in MMA_PERMS:
            inst = get_instance(field, iname)
            words, L = inst.field.kernel_words, inst.field.n_limbs
            for n in MMA_PERM_NS:
                x, group = perm_in[field][n], n <= crossover[words]
                t_int, t_mma = in_turns(lambda: cuda_backend.permutation_with(inst, x, group),
                                        lambda: cuda_backend.permutation(inst, x, MMA_IMPL), MMA_PERM_REPS)
                key = (field, n)
                mma19["ms"][key], mma19["int_ms"][key] = t_mma, t_int
                b = mma19["bound"][key] = mma_bound(inst, n, n * 2 * inst.width * L * 4)
                form = "quad" if n <= mma_top[words] else "thread"
                print(f"  {field}/{iname} permutation, {n} states ({words} words; {smi}; CUDA events, "
                      f"{MMA_PERM_REPS} calls a turn after a warm-up, in turns integer, mma, mma, integer): "
                      f"tensor-core kernel ({form} form) {t_mma:.3f} ms, "
                      f"{'four-lane' if group else 'one-thread'} kernel "
                      f"{t_int:.3f} ms ({t_int / t_mma:.3f}x); bound {b['bound_ms']:.3f} ms by {b['unit']} "
                      f"({b['imads']} IMADs left a permutation, {b['imad_ms']:.3f} ms; {b['macs']} u8 MACs, "
                      f"{b['mac_ms']:.3f} ms; bytes {b['bytes_ms']:.4f} ms): kernel at {b['bound_ms'] / t_mma:.1%} "
                      f"of it ({since19()})", flush=True)
        for case in MMA_SPONGES:
            inst = get_instance(*case)
            E, m = sponge_in[case]
            L, perms = inst.field.n_limbs, -(-E // inst.rate)
            t_int, t_mma = in_turns(lambda: cuda_backend.sponge(inst, E, m),
                                    lambda: cuda_backend.sponge(inst, E, m, MMA_IMPL), MMA_SPONGE_REPS)
            mma19["ms"][case], mma19["int_ms"][case] = t_mma, t_int
            b = mma19["bound"][case] = mma_bound(inst, N_MSGS * perms, N_MSGS * (E + inst.digest_size) * L * 4)
            print(f"  {case[0]}/{case[1]} sponge, {N_MSGS} messages of {E} elements ({perms} permutations each; "
                  f"{inst.field.kernel_words} words; {smi}; CUDA events, {MMA_SPONGE_REPS} call a turn after a "
                  f"warm-up, in turns): tensor-core kernel {t_mma:.3f} ms, sponge_kernel "
                  f"{t_int:.3f} ms "
                  f"({t_int / t_mma:.3f}x); bound {b['bound_ms']:.3f} ms by {b['unit']} ({b['imad_ms']:.3f} ms of "
                  f"IMADs, {b['mac_ms']:.3f} ms of u8 MACs): kernel at {b['bound_ms'] / t_mma:.1%} of it "
                  f"({since19()})", flush=True)

        # the crossover: both forms at each N of PERM_SWEEP, each output held against the main path's (a prefix of
        # its N_MSGS_FILL states, held below against the integer kernel)
        for field, iname in MMA_PERMS:
            inst = get_instance(field, iname)
            top, x, want = mma_top[inst.field.kernel_words], perm_in[field][N_MSGS_FILL], outs[(field, N_MSGS_FILL)]
            times = mma19["sweep"][field] = {}
            print(f"  the crossover, {field}/{iname} ({MMA_PERM_REPS} calls of each form after a warm-up, CUDA events; "
                  f"{smi}):\n    N | quad form ms | thread form ms | thread / quad | permutation() runs", flush=True)
            for n in PERM_SWEEP:
                xn = x[:, :n].contiguous()
                for quad in (True, False):
                    held(cuda_backend.permutation_mma_with(inst, xn, quad), want[:, :n], f"{field}/{iname} "
                         f"permutation, {n} states, {'quad' if quad else 'thread'} form, against the main path's",
                         mma_key("permutation" if quad else "permutation_thread", inst.field.kernel_words))
                t = times[n] = {q: mb.event_ms(lambda: cuda_backend.permutation_mma_with(inst, xn, q), MMA_PERM_REPS)
                                for q in (True, False)}
                print(f"    {n} | {t[True]:.3f} | {t[False]:.3f} | {t[False] / t[True]:.3f} | "
                      f"{'quad' if n <= top else 'thread'} form", flush=True)
            wins = [n for n in PERM_SWEEP if times[n][True] < times[n][False]]
            best = max(wins) if wins else None
            print(f"  the largest N at which the quad form wins: {best}; the library's crossover "
                  f"(PERMUTE_MMA_GROUP_MAX): {top}, {'the same' if best == top else 'DIFFERS'} ({since19()})",
                  flush=True)

        # the verifier with the name, a process of its own, beside this process's checks
        verify_mma = run_module("anemoi_tpu_torch.tools.verify_cuda", "--mul-impl", MMA_IMPL, "--fields",
                                "vesta,bls12_381")
        try:
            # every lane against the integer kernel (phases 6, 8 and 13 hold it against the native oracle), the
            # ragged N_CHECK among them; N_PLAIN lanes at both ends of each N against the plain version
            for field, iname in MMA_PERMS:
                inst = get_instance(field, iname)
                key = mma_key("permutation", inst.field.kernel_words)
                thread_key = mma_key("permutation_thread", inst.field.kernel_words)
                top = crossover[inst.field.kernel_words]
                outs[(field, N_CHECK)] = cuda_backend.permutation(inst, perm_in[field][N_CHECK], MMA_IMPL)
                ns = (*MMA_PERM_NS, N_CHECK)
                for n in ns:
                    held(outs[(field, n)], cuda_backend.permutation_with(inst, perm_in[field][n], n <= top),
                         f"{field}/{iname} permutation, {n} states, {MMA_IMPL}, against the integer kernel",
                         key if n <= mma_top[inst.field.kernel_words] else thread_key)
                for quad in (True, False):
                    held(cuda_backend.permutation_mma_with(inst, perm_in[field][N_CHECK], quad), outs[(field, N_CHECK)],
                         f"{field}/{iname} permutation, {N_CHECK} states, {'quad' if quad else 'thread'} form, "
                         f"against the main path's", key if quad else thread_key)
                cols = torch.cat([ends(n) for n in ns]).unique()
                x = perm_in[field][N_MSGS_FILL]
                plain_ms, plain = host_time_ms(lambda: cuda_backend.permutation_plain(inst, x[:, cols.to(dev)]
                                                                                      .contiguous()))
                mma19["perm_plain"][field] = plain_ms, len(cols)
                at = {int(c): i for i, c in enumerate(cols)}
                for n in ns:
                    c = ends(n)
                    held(outs[(field, n)][:, c.to(dev)], plain[:, torch.tensor([at[int(i)] for i in c], device=dev)],
                         f"{field}/{iname} permutation, {n} states, {MMA_IMPL}, against the plain version",
                         key if n <= mma_top[inst.field.kernel_words] else thread_key)
                print(f"  {field}/{iname} permutation at {', '.join(map(str, ns))} states: every lane equal to the "
                      f"integer kernel's, both forms at {N_CHECK} equal, {N_PLAIN} at both ends of each to the plain "
                      f"version ({len(cols)} lanes, {plain_ms / 1e3:.2f} s) ({since19()})", flush=True)
            for case in MMA_SPONGES:
                inst = get_instance(*case)
                key = mma_key("sponge", inst.field.kernel_words)
                E, m = sponge_in[case]
                held(outs[case], cuda_backend.sponge(inst, E, m), f"{case[0]}/{case[1]} sponge, {N_MSGS} x "
                     f"{MSG_BYTES} bytes, {MMA_IMPL}, against sponge_kernel", key)
                # a ragged N_CHECK at E = rate (sigma not added), 2 rate and rate + 1 (a tail), the last also on
                # N_PLAIN messages at both ends against the plain version, which takes a second a permutation
                r, L = inst.rate, inst.field.n_limbs
                ragged = random_on_card(inst, 2 * r, N_CHECK, args.seed + 21).reshape(-1, N_CHECK)
                sizes = tuple(dict.fromkeys((r, 2 * r, r + 1)))  # r + 1 last: its output meets the plain version
                for e in sizes:
                    x = ragged[:e * L].contiguous()
                    out = cuda_backend.sponge(inst, e, x, MMA_IMPL)
                    held(out, cuda_backend.sponge(inst, e, x), f"{case[0]}/{case[1]} sponge, {N_CHECK} messages "
                         f"of {e}, against sponge_kernel", key)
                plain_ms, plain = host_time_ms(lambda: cuda_backend.sponge_plain(inst, r + 1, x[:, lanes]
                                                                                  .contiguous()))
                held(out[:, lanes], plain, f"{case[0]}/{case[1]} sponge, {N_PLAIN} of {N_CHECK} messages of {r + 1}, "
                     f"against the plain version", key)
                mma19["sponge_plain_ms"][case] = plain_ms
                print(f"  {case[0]}/{case[1]} sponge: every lane of {N_MSGS} x {E} elements equal to sponge_kernel's; "
                      f"{N_CHECK} messages of {', '.join(map(str, sizes))} elements equal to sponge_kernel's, {N_PLAIN} "
                      f"at both ends of the last to the plain version ({plain_ms / 1e3:.2f} s) ({since19()})",
                      flush=True)
            lines = module_result(verify_mma, f"verify_cuda --mul-impl {MMA_IMPL}", timeout=600)
        finally:
            verify_mma.kill()
            verify_mma.wait()
        reported = json.loads([line for line in lines if line.startswith("launches: ")][-1].split(": ", 1)[1])
        mma19["verify_launches"] = reported
        if not lines[-1].endswith("ALL PASS") or not all(reported[k] > 0 for k in (
                "permutation_mma", "permutation_mma_thread", "sponge_mma", "permutation_mma_w12",
                "permutation_mma_thread_w12", "sponge_mma_w12")):
            fail(f"verify_cuda --mul-impl {MMA_IMPL}: {lines[-1]!r}, launches {reported}")
        print(f"  python3 -m anemoi_tpu_torch.tools.verify_cuda --mul-impl {MMA_IMPL} --fields vesta,bls12_381 (a "
              f"process, beside these checks): {lines[-1]}; launches {reported} ({since19()})", flush=True)
        del perm_in, sponge_in, outs

    # 15 --------------------------------------------------------------------
    if run(15):
        phase("15 kernels")
        jive43_bound = bound(get_instance("bls12_381", "anemoi_4_3"), N_FULL, 0)
        print(f"  bound, bls12_381/anemoi_4_3 Jive, {N_FULL} states (not run at full size): "
              f"{jive43_bound['ops_ms']:.3f} ms", flush=True)
        chain_bls = chain["bls12_381"]
        chain_bound_ms = MB_LANES * CHAIN_TRIPS[1] * chain_bls["imads_per_sqr"] / imad_per_s * 1e3
        mad_bound_ms = fill["elements"] * MAD_TRIPS[1] / imad_per_s * 1e3
        measured_imad_per_s = mad_rate * sms * max_sm_mhz * 1e6
        print(f"  the bound at the measured rate: {measured_imad_per_s:.4g} IMADs/s ({mad_rate:.3f} per clock per SM) "
              f"against {imad_per_s:.4g}/s ({IMAD_PER_CLOCK_PER_SM}):", flush=True)
        for what, b, ms in (("vesta/anemoi_2_1 Jive", jive_bound, jive_ms),
                            ("bls12_381/anemoi_2_1 Jive", jive12_bound, jive12_ms),
                            ("bls12_377/anemoi_2_1 Jive", jive377_bound, jive377_ms),
                            ("vesta/anemoi_4_3 sponge, 4,096 x 10 KB", sponge_bound["anemoi_4_3"],
                             sponge_ms["anemoi_4_3"]),
                            ("bls12_381/anemoi_4_3 sponge, 4,096 x 10 KB", sponge12_bound, sponge12_ms),
                            ("vesta/anemoi_4_3 permutation, 4,096 states, four-lane", perm_bound, perm_ms),
                            ("bls12_381/anemoi_4_3 permutation, 4,096 states, four-lane", perm12_bound, perm12_ms),
                            ("vesta/anemoi_4_3 permutation, 65,536 states, one-thread", perm_thread_bound,
                             perm_thread_ms),
                            ("bls12_381/anemoi_4_3 permutation, 65,536 states, one-thread", perm12_thread_bound,
                             perm12_thread_ms)):
            at_measured = b["ops_ms"] * IMAD_PER_CLOCK_PER_SM / mad_rate
            print(f"    {what}: {ms:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_ms'] / ms:.1%}); at the measured "
                  f"rate {at_measured:.3f} ms ({at_measured / ms:.1%})", flush=True)

        print(f"  the native oracle's seconds, by check (threads over {os.cpu_count()} cores): "
              + ", ".join(f"{k} {v:.2f}" for k, v in oracle_s.items()) + f"; {sum(oracle_s.values()):.2f} in all",
              flush=True)

        def entry(name, source, replaces, launches, ms, plain_ms, b, **extra):
            return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                    "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
                    "bound_by": b["bound_by"], "library_ms": None, **extra}

        ops = lambda ms: {"bound_ms": ms, "bound_by": "operations"}
        print(json.dumps({"kernels": [
            entry("jive", "anemoi_tpu_torch/csrc/jive.cu", "anemoi_tpu/ff/pallas_backend.py:707", jive_launches,
                  jive_ms, jive_plain_ms, jive_bound, words=8, lanes=N_FULL, plain_lanes=N_SAMPLE, root_ms=root_ms,
                  oracle_lanes=N_ORACLE_FULL, oracle_root_leaves=ORACLE_TREE,
                  cli_merkle_launches=slice4["cli_merkle"]["jive"], cli_merkle_wall_s=slice4["cli_merkle"]["wall_s"],
                  forest_launches=slice4["forest"]["jive"], trace_launches=slice4["trace"]["jive"],
                  bench_launches=slice5["bench"]["jive"], verify_launches=slice5["verify"]["jive"],
                  entry_launches=slice5["entry"], tree_2p24_arity4_ms=slice5["tree_ms"],
                  tree_2p24_arity4_bound_ms=slice5["tree_bound"]["bound_ms"],
                  tree_2p24_arity4_launches=slice5["tree_launches"], build_s=lib.build_seconds),
            entry("permutation", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:430",
                  perm_group_launches, perm_ms, plain_times[("permutation", "anemoi_4_3")], perm_bound, words=8,
                  kernel="permute_group_kernel", instance="vesta/anemoi_4_3", lanes=N_MSGS,
                  plain_lanes=plain_lanes[8], crossover=crossover[8],
                  sweep={n: {"four_lane_ms": t[True], "one_thread_ms": t[False]} for n, t in sweep.items()},
                  batched_sponge_ms=stream_ms, verify_launches=slice5["verify"]["permutation"],
                  build_s=sponge_lib.build_seconds),
            entry("permutation_thread", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:430",
                  perm_thread_launches, perm_thread_ms, plain_times[("permutation", "anemoi_4_3")], perm_thread_bound,
                  words=8, kernel="permute_kernel", instance="vesta/anemoi_4_3", lanes=N_MSGS_FILL,
                  plain_lanes=plain_lanes[8], crossover=crossover[8],
                  verify_launches=slice5["verify"]["permutation_thread"], build_s=sponge_lib.build_seconds),
            entry("sponge", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:610",
                  sponge_launches, sponge_ms["anemoi_4_3"], plain_times[("sponge", "anemoi_4_3", 4)],
                  sponge_bound["anemoi_4_3"], words=8, instance="vesta/anemoi_4_3", messages=N_MSGS,
                  elements=native.num_elements(MSG_BYTES, get_instance("vesta", "anemoi_4_3").field),
                  plain_messages=N_PLAIN, plain_elements=4, ms_2_1=sponge_ms["anemoi_2_1"],
                  bound_ms_2_1=sponge_bound["anemoi_2_1"]["bound_ms"], ms_65536=fill_ms,
                  bound_ms_65536=fill_bound["bound_ms"], e2e_ms=e2e_ms, oracle_messages=N_CHECK,
                  cli_hash_launches=slice4["cli_hash vesta/anemoi_2_1"]["sponge"],
                  async_launches=slice4["async"]["sponge"], async_ms=slice4["async"]["ms"],
                  async_hash_bytes_ms=slice4["async"]["hash_bytes_ms"], bench_launches=slice5["bench"]["sponge"],
                  verify_launches=slice5["verify"]["sponge"], build_s=sponge_lib.build_seconds),
            entry("jive_w12", "anemoi_tpu_torch/csrc/jive.cu", "anemoi_tpu/ff/pallas_backend.py:707", jive12_launches,
                  jive12_ms, jive12_plain_ms, jive12_bound, words=12, instance="bls12_381/anemoi_2_1", lanes=N_FULL,
                  plain_lanes=N_SAMPLE, oracle_lanes=N_ORACLE_W12, root_ms=root12_ms, ms_bls12_377=jive377_ms,
                  bound_ms_bls12_377=jive377_bound["bound_ms"], bench_launches=slice5["bench"]["jive_w12"],
                  verify_launches=slice5["verify"]["jive_w12"], build_s=lib12.build_seconds),
            entry("permutation_w12", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:430",
                  perm12_group_launches, perm12_ms, plain_times[("permutation_w12", "anemoi_4_3")], perm12_bound,
                  words=12, kernel="permute_group_kernel", instance="bls12_381/anemoi_4_3", lanes=N_MSGS,
                  plain_instance="bls12_377/anemoi_4_3", plain_lanes=plain_lanes[12], crossover=crossover[12],
                  cli_hash_launches=slice4["cli_hash bls12_381/anemoi_4_3"]["permutation"],
                  sweep={n: {"four_lane_ms": t[True], "one_thread_ms": t[False]} for n, t in sweep12.items()},
                  batched_sponge_ms=stream12_ms, verify_launches=slice5["verify"]["permutation_w12"],
                  build_s=sponge_lib12.build_seconds),
            entry("permutation_thread_w12", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:430",
                  perm12_thread_launches, perm12_thread_ms, plain_times[("permutation_w12", "anemoi_4_3")],
                  perm12_thread_bound, words=12, kernel="permute_kernel", instance="bls12_381/anemoi_4_3",
                  lanes=N_MSGS_FILL, plain_instance="bls12_377/anemoi_4_3", plain_lanes=plain_lanes[12],
                  crossover=crossover[12], verify_launches=slice5["verify"]["permutation_thread_w12"],
                  build_s=sponge_lib12.build_seconds),
            entry("sponge_w12", "anemoi_tpu_torch/csrc/sponge.cu", "anemoi_tpu/ff/pallas_backend.py:610",
                  sponge12_launches, sponge12_ms, plain_times[("sponge_w12", "anemoi_4_3", 4)], sponge12_bound,
                  words=12, instance="bls12_381/anemoi_4_3", messages=N_MSGS, elements=E, plain_messages=N_PLAIN,
                  plain_elements=4, e2e_ms=e2e12_ms, pack_ms=pack12_ms,
                  cli_hash_launches=slice4["cli_hash bls12_381/anemoi_4_3"]["sponge"],
                  bench_launches=slice5["bench"]["sponge_w12"], verify_launches=slice5["verify"]["sponge_w12"],
                  build_s=sponge_lib12.build_seconds),
            entry("jive_mma", "anemoi_tpu_torch/csrc/jive_mma.cu", "anemoi_tpu/ff/pallas_backend.py:707",
                  mma["launches"], mma["ms"]["vesta"], mma["plain_ms"][8], mma["bound"]["vesta"], words=8,
                  mul_impl=MMA_IMPL, instance="vesta/anemoi_2_1", lanes=N_FULL, jive_kernel_ms=mma["jive_ms"]["vesta"],
                  bound_unit=mma["bound"]["vesta"]["unit"], imad_bound_ms=mma["bound"]["vesta"]["imad_ms"],
                  mac_bound_ms=mma["bound"]["vesta"]["mac_ms"], plain_lanes=N_PLAIN, oracle_lanes=N_ORACLE_FULL,
                  root_launches=mma["launches"] - 1, root_ms=mma["root_ms"], root_jive_kernel_ms=mma["root_jive_ms"],
                  bench_launches=mma["bench_launches"],
                  build_s=mma_libs[8].build_seconds),
            entry("jive_mma_w12", "anemoi_tpu_torch/csrc/jive_mma.cu", "anemoi_tpu/ff/pallas_backend.py:707",
                  mma["launches_w12"], mma["ms"]["bls12_381"], mma["plain_ms"][12], mma["bound"]["bls12_381"],
                  words=12, mul_impl=MMA_IMPL, instance="bls12_381/anemoi_2_1", lanes=N_FULL,
                  jive_kernel_ms=mma["jive_ms"]["bls12_381"], bound_unit=mma["bound"]["bls12_381"]["unit"],
                  imad_bound_ms=mma["bound"]["bls12_381"]["imad_ms"], mac_bound_ms=mma["bound"]["bls12_381"]["mac_ms"],
                  ms_bls12_377=mma["ms"]["bls12_377"], jive_kernel_ms_bls12_377=mma["jive_ms"]["bls12_377"],
                  bound_ms_bls12_377=mma["bound"]["bls12_377"]["bound_ms"], plain_lanes=N_PLAIN,
                  plain_instance="bls12_381/anemoi_2_1", oracle_lanes=N_ORACLE_FULL, build_s=mma_libs[12].build_seconds),
            *(entry(mma_key(kind, words), "anemoi_tpu_torch/csrc/sponge_mma.cu",
                    "anemoi_tpu/ff/pallas_backend.py:430",
                    mma19["launches"][words][mma_key(kind, 8)],
                    mma19["ms"][(field, n)], mma19["perm_plain"][field][0], mma19["bound"][(field, n)],
                    words=words, mul_impl=MMA_IMPL, kernel=kernel, instance=f"{field}/anemoi_4_3", lanes=n,
                    int_kernel="permute_group_kernel" if n <= crossover[words] else "permute_kernel",
                    int_kernel_ms=mma19["int_ms"][(field, n)], bound_unit=mma19["bound"][(field, n)]["unit"],
                    crossover=mma_top[words],
                    sweep={m: {"quad_ms": t[True], "thread_ms": t[False]} for m, t in mma19["sweep"][field].items()},
                    plain_lanes=mma19["perm_plain"][field][1],
                    verify_launches=mma19["verify_launches"][mma_key(kind, words)],
                    build_s=sponge_mma_libs[words].build_seconds)
              for field, words in (("vesta", 8), ("bls12_381", 12))
              for kind, kernel, n in (("permutation", "permute_mma_kernel", N_MSGS),
                                      ("permutation_thread", "permute_mma_thread_kernel", N_MSGS_FILL))),
            *(entry(mma_key("sponge", words), "anemoi_tpu_torch/csrc/sponge_mma.cu",
                    "anemoi_tpu/ff/pallas_backend.py:610", mma19["launches"][words]["sponge_mma"],
                    mma19["ms"][(field, "anemoi_4_3")], mma19["sponge_plain_ms"][(field, "anemoi_4_3")],
                    mma19["bound"][(field, "anemoi_4_3")], words=words, mul_impl=MMA_IMPL, instance=f"{field}/anemoi_4_3",
                    messages=N_MSGS, elements=-(-MSG_BYTES // get_instance(field, "anemoi_4_3").field.byte_chunk),
                    int_kernel="sponge_kernel", int_kernel_ms=mma19["int_ms"][(field, "anemoi_4_3")],
                    bound_unit=mma19["bound"][(field, "anemoi_4_3")]["unit"], plain_messages=N_PLAIN,
                    plain_elements=get_instance(field, "anemoi_4_3").rate + 1,
                    verify_launches=mma19["verify_launches"][mma_key("sponge", words)],
                    build_s=sponge_mma_libs[words].build_seconds,
                    **({"ms_2_1": mma19["ms"][("vesta", "anemoi_2_1")],
                        "int_kernel_ms_2_1": mma19["int_ms"][("vesta", "anemoi_2_1")],
                        "bound_ms_2_1": mma19["bound"][("vesta", "anemoi_2_1")]["bound_ms"]} if words == 8 else {}))
              for field, words in (("vesta", 8), ("bls12_381", 12))),
            entry("sqr_chain", "anemoi_tpu_torch/csrc/microbench.cu", "tools/mxu_prototype.py:110",
                  mb_launches["sqr_chain"], chain_bls["ms2"], chain_plain_ms["bls12_381"], ops(chain_bound_ms),
                  instance="bls12_381", lanes=MB_LANES, squarings=CHAIN_TRIPS[1], plain_lanes=8, plain_squarings=8,
                  ns_per_sqr_per_lane={f: c["ns_per_sqr_per_lane"] for f, c in chain.items()},
                  imads_per_s={f: c["imads_per_s"] for f, c in chain.items()}),
            entry("mad_loop", "anemoi_tpu_torch/csrc/microbench.cu", "tools/microbench_layout.py:44",
                  mb_launches["mad_loop"], fill["ms2"], mad_plain_ms, ops(mad_bound_ms), elements=fill["elements"],
                  iterations=MAD_TRIPS[1], plain_elements=10240, plain_iterations=100,
                  iters_per_clock_per_sm={"x".join(map(str, s)): r["iters_per_clock_per_sm"] for s, r in mad.items()}),
        ]}), flush=True)
    phase("done")
    if args.phases != ALL_PHASES:
        print(f"chip_smoke: phases {sorted(args.phases)} passed; a partial run prints no result line", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
