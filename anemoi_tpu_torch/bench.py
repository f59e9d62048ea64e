"""Benchmark of the port: Vesta Anemoi-2-1 Jive 2-to-1 compressions a second on one card.

    python3 -m anemoi_tpu_torch.bench [--n N] [--reps R] [--headline-only] [--profile DIR] [--device D]
    python3 -m anemoi_tpu_torch.bench --matrix [--n N] [--resume] [--out PATH]
    python3 -m anemoi_tpu_torch.bench --all [--out PATH]

Counterpart of ``bench.py``, with its flags, metric names, units and
ratios to the reference's single-core rates (``vs_baseline``,
``vs_reference_core``).  The default run prints the headline JSON line
first, flushed, then runs the secondary configs of ``bench.py:620-660``
and prints the whole document as the last line.  ``--matrix`` times Jive
for all 14 instantiations and writes a table (``docs/BENCHMARKS_TORCH.md``
unless ``--out``); ``--all`` runs every config of ``bench.py:418-526`` and
writes ``docs/BENCHMARKS_TORCH_ALL.md`` unless ``--out``.  Each table's
header names the card and its power limit, as nvidia-smi reports them.

Where it differs from ``bench.py``, on purpose:

  * Timing: each repetition is bracketed by ``torch.cuda.synchronize()``
    and timed on the host clock, the median taken; one scalar checksum is
    fetched at the end.  A warm-up on the checked lanes alone loads the
    kernel library before the clock starts.
  * Data: ``limb_ops.random_canonical``, whose values are below p for
    every field (``bench.py:121-133`` is not, for BLS12-377).
  * Parity in every config, on lanes of the timed batch: Jive, 4 states
    against the golden model; the sponge, 4 messages against
    ``golden.hash_field``; a root, 4 parents of every level (fewer where
    the level is smaller) recomputed by the golden model from their
    children in the level below; the dry run, the root of the ranks
    against the one-process root.  A mismatch raises ``ParityError`` and
    the program exits non-zero.
  * No fallback: without a card the program exits non-zero unless
    ``--device cpu`` is given, which runs the plain PyTorch version at
    ``bench.py``'s CPU sizes (Jive up to 2^14 states, the sponge up to 64
    messages, roots up to 2^10 leaves) and reports ``"device": "cpu"``.
  * The multi-chip dry run: ``n_ranks`` gloo processes on the CPU (no card
    visible to them) run ``dist/forest.py``; it reports the bytes a rank
    sends through the collectives and the raw times of one forest call on
    one process and on the ranks, and derives no scaling figure.
  * ``--block``, ``--impl`` and ``--ladder`` are accepted (the last two
    validated as the JAX package validates them).  ``--impl`` with a name
    that starts with "mxu" (the JAX kernel's product on its matrix unit)
    runs every Jive config (the headline, the Jive configs, the roots and
    the arity-4 tree, the matrix) on the tensor-core Jive kernel
    (``csrc/jive_mma.cu``), counted as "jive_mma" in each config's
    launches; the other names, ``--block`` and ``--ladder`` change nothing:
    the kernels choose their own blocking and ladder.  No wall-clock
    budget: every config runs, and any failure ends the program.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .ff import cuda_backend, golden
from .ff.golden import ParityError
from .ff.limb_ops import check_tuning, decode_ints, random_canonical
from .fields.params import FIELD_NAMES, INSTANCE_NAMES, get_instance
from .merkle.tree import MerkleTree, check_levels
from .modes.batched import decode_states, encode_states, jive_compress_batch_fn, sponge_hash_batch_fn

ROOT = Path(__file__).resolve().parent.parent
HEADLINE = "vesta_anemoi_2_1_jive_2to1_hashes_per_sec_per_chip"
REFERENCE_RATE = 1.0 / 129.48e-6  # bench.py:34: the reference's Vesta 2_1 Jive 2-to-1 on one CPU core

# bench.py:405-415: the reference's i7-9750H single-core rates (reference README.md:77-85)
_REF_RATES = {
    ("vesta", "anemoi_2_1", "jive"): 1e6 / 129.48,
    ("vesta", "anemoi_4_3", "jive"): 1e6 / 176.58,
    ("bls12_377", "anemoi_2_1", "jive"): 1e6 / 429.61,
    ("bls12_377", "anemoi_4_3", "jive"): 1e6 / 485.99,
    ("vesta", "anemoi_4_3", "sponge10kb"): 1e3 / 20.307,
    ("vesta", "anemoi_2_1", "sponge10kb"): 1e3 / 44.448,
    ("bls12_377", "anemoi_4_3", "sponge10kb"): 1e3 / 35.937,
    ("bls12_377", "anemoi_2_1", "sponge10kb"): 1e3 / 85.369,
}

MSG_BYTES = 10240  # bench.py:217
PARITY = 4  # lanes, messages or parents a level checked against the golden model
CPU_MAX = {"jive": 1 << 14, "sponge": 64, "merkle": 1 << 10}  # bench.py:153, 223, 247
# bench.py runs its dry run over 2^12 leaves on virtual XLA devices; the
# plain PyTorch version costs about 2.5 s a call and 47 ms a Vesta lane on
# one CPU core, so one process would take over 200 s for 2^12 leaves.  The
# dry run's content, the bytes a rank sends (L int32), does not depend on
# the leaves; 2^6 leaves still give every rank of 8 a subtree of 8.
DRYRUN_LEAVES = 1 << 6
MATRIX_OUT = ROOT / "docs" / "BENCHMARKS_TORCH.md"
ALL_OUT = ROOT / "docs" / "BENCHMARKS_TORCH_ALL.md"
_ROW = re.compile(r"^\| (\w+) \| (\w+) \| ([\d,.]+) \| (\S+) \| (.+) \|$", re.M)


def device_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type == "cpu":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _random_ints(rng: np.random.Generator, p: int, n: int) -> list[int]:
    """n canonical field elements, as bench.py:170 draws its parity states."""
    return [int(rng.integers(0, 2**62)) * int(rng.integers(1, 2**62)) % p for _ in range(n)]


def _measure(run, warm, reps: int, device: torch.device, check, n: int, words: int, profile_dir=None) -> dict:
    """Times ``run()`` over `reps` synchronized repetitions (the median, on
    the host clock), after ``warm()`` on the card; fetches one checksum of
    the last output and holds its checked lanes with ``check(out)``, which
    returns the count held or raises ``ParityError``.  "value" is n items
    a second."""
    before = cuda_backend.launch_counts()
    if device.type == "cuda":
        warm()

    def timed_reps():
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            out = run()
            _sync(device)
            times.append(time.perf_counter() - t0)
        return times, out

    if profile_dir:
        from .utils.profiling import trace

        with trace(profile_dir) as prof:
            times, out = timed_reps()
        print(f"[bench] trace written to {prof.trace_path}", file=sys.stderr)
    else:
        times, out = timed_reps()
    checksum = int((out[0] if isinstance(out, tuple) else out).long().sum())
    lanes = check(out)
    after = cuda_backend.launch_counts()
    seconds = float(np.median(times))
    return {"value": n / seconds, "ms": seconds * 1e3, "n": n, "words": words, "times": times, "checksum": checksum,
            "parity": "ok", "parity_lanes": lanes, "launches": {k: after[k] - before[k] for k in after}}


def bench_jive(field="vesta", iname="anemoi_2_1", n=1 << 20, reps=3, device=None, profile_dir=None,
               mul_impl=None) -> dict:
    """Jive 2-to-1 over n canonical states (``jive_compress_batch_fn``, one
    launch a call; ``mul_impl`` as its), its first PARITY lanes checked
    against the golden model.  Returns ``_measure``'s run: "value"
    hashes/s, "ms", "parity_lanes", "launches", "words"."""
    device = cuda_backend.resolve_device(device)
    if device.type == "cpu":
        n = min(n, CPU_MAX["jive"])
    if n < PARITY:
        raise ValueError(f"a batch of at least {PARITY} states, not {n}")
    inst = get_instance(field, iname)
    fp, W = inst.field, inst.width
    rng = np.random.default_rng(0)
    states = torch.from_numpy(random_canonical(fp, (W, n), rng).transpose(1, 0, 2).copy())  # [W, L, n]
    check_states = [_random_ints(rng, fp.p, W) for _ in range(PARITY)]
    states[:, :, :PARITY] = encode_states(inst, check_states, device="cpu")
    states = states.to(device)
    fn = jive_compress_batch_fn(inst, 2, device=device, mul_impl=mul_impl)
    want = [golden.jive_compress(inst, s) for s in check_states]

    def check(out):
        if decode_states(inst, out[:, :, :PARITY]) != want:
            raise ParityError(f"{inst.qualified_name} Jive over {n} states: the checked lanes differ from the golden "
                              f"model")
        return PARITY

    return _measure(lambda: fn(states), lambda: fn(states[:, :, :PARITY].contiguous()), reps, device, check, n,
                    fp.kernel_words, profile_dir)


def bench_sponge_10kb(field="vesta", iname="anemoi_4_3", n_msgs=4096, reps=2, device=None) -> dict:
    """The sponge over n_msgs messages of E = ceil(10240 / byte_chunk)
    canonical elements already on the device (``sponge_hash_batch_fn``:
    the kernel alone, no packing), the first PARITY messages checked
    against ``golden.hash_field``.  "value" is messages/s."""
    device = cuda_backend.resolve_device(device)
    if device.type == "cpu":
        n_msgs = min(n_msgs, CPU_MAX["sponge"])
    if n_msgs < PARITY:
        raise ValueError(f"at least {PARITY} messages, not {n_msgs}")
    inst = get_instance(field, iname)
    fp = inst.field
    E = -(-MSG_BYTES // fp.byte_chunk)
    rng = np.random.default_rng(0)
    elems = torch.from_numpy(random_canonical(fp, (E, n_msgs), rng).transpose(1, 0, 2).copy()).to(device)  # [E, L, n]
    fn = sponge_hash_batch_fn(inst, E, device=device)
    host = elems[:, :, :PARITY].cpu()
    want = [golden.hash_field(inst, decode_ints(host[:, :, j].T.contiguous(), fp)) for j in range(PARITY)]

    def check(out):
        if decode_states(inst, out[:, :, :PARITY]) != want:
            raise ParityError(f"{inst.qualified_name} sponge over {n_msgs} messages of {E} elements: the checked "
                              f"messages differ from the golden model")
        return PARITY

    run = _measure(lambda: fn(elems), lambda: fn(elems[:, :, :PARITY].contiguous()), reps, device, check, n_msgs,
                   fp.kernel_words)
    return {**run, "elements": E}


def bench_merkle(field="vesta", iname="anemoi_2_1", n_leaves=1 << 20, reps=2, device=None, mul_impl=None) -> dict:
    """``MerkleTree.root`` over n_leaves canonical leaves with
    ``return_levels`` (one Jive launch a level; ``mul_impl`` as the tree's),
    PARITY nodes of every level checked by ``merkle.tree.check_levels``.
    "value" is leaves/s."""
    device = cuda_backend.resolve_device(device)
    if device.type == "cpu":
        n_leaves = min(n_leaves, CPU_MAX["merkle"])
    inst = get_instance(field, iname)
    tree = MerkleTree(inst, device=device, mul_impl=mul_impl)
    tree.num_levels(n_leaves)  # raises unless a power of the arity
    leaves = torch.from_numpy(random_canonical(inst.field, (n_leaves,), np.random.default_rng(0))).to(device)
    small = leaves[:, :inst.width**2].contiguous()
    return _measure(lambda: tree.root(leaves, return_levels=True), lambda: tree.root(small), reps, device,
                    lambda out: check_levels(inst, out[1], PARITY), n_leaves, inst.field.kernel_words)


def _dryrun_rank(chips, leaves: str) -> dict:
    """One rank of the dry run: the forest over its share of the leaves
    (one call, timed from a barrier), with its collectives."""
    import torch.distributed as dist

    from .dist.forest import sharded_merkle_root_fn
    from .dist.mesh import shard_batch, summarize_collectives

    arr = np.load(leaves)
    fn = sharded_merkle_root_fn(get_instance("vesta", "anemoi_2_1"), chips, arr.shape[1])
    local = shard_batch(arr, chips)
    dist.barrier()
    t0 = time.perf_counter()
    root = fn(local)
    seconds = time.perf_counter() - t0
    return {"root": root[:, 0].tolist(), "seconds": seconds, "traffic": summarize_collectives(fn.collectives)}


def bench_multichip_dryrun(n_ranks=8, n_leaves=DRYRUN_LEAVES) -> dict:
    """The sharded forest over n_leaves Vesta 2_1 leaves on n_ranks gloo
    processes on the CPU (``dist.ranks``), against the one-process
    ``MerkleTree(device="cpu")`` root.  Returns bench.py's keys: "t1" and
    "tN" (seconds of one forest call on one process and on the ranks, the
    slowest rank), "n_devices", "collective_bytes_per_device",
    "collective_counts", "collective_ops"."""
    from .dist.ranks import run_ranks

    inst = get_instance("vesta", "anemoi_2_1")
    leaves = random_canonical(inst.field, (n_leaves,), np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "leaves.npy")
        np.save(path, leaves)
        ranks = run_ranks("anemoi_tpu_torch.bench:_dryrun_rank", n_ranks, kwargs={"leaves": path})
    t0 = time.perf_counter()
    root = MerkleTree(inst, device="cpu").root(torch.from_numpy(leaves))
    t1 = time.perf_counter() - t0
    want = root[:, 0].tolist()
    for r, res in enumerate(ranks):
        if res["root"] != want or res["traffic"] != ranks[0]["traffic"]:
            raise ParityError(f"dry run: rank {r}'s root or collectives differ from the one-process root or rank 0's")
    traffic = ranks[0]["traffic"]
    return {"t1": t1, "tN": max(r["seconds"] for r in ranks), "n_devices": n_ranks, "n_leaves": n_leaves,
            "collective_bytes_per_device": traffic["total_bytes_per_device"], "collective_counts": traffic["counts"],
            "collective_ops": traffic["ops"]}


def dryrun_entry(d: dict) -> dict:
    """bench.py:620-631's config entry for a dry run."""
    return {"metric": "multichip_dryrun_collective_bytes_per_device", "value": d["collective_bytes_per_device"],
            "unit": "bytes", "n_devices": d["n_devices"], "ok": True, "collective_counts": d["collective_counts"],
            "t1_sec": round(d["t1"], 2), "tN_sec": round(d["tN"], 2), "n_leaves": d["n_leaves"], "parity": "ok",
            "parity_lanes": 1}


def config_entry(metric: str, unit: str, run: dict, ref_key=None, **extra) -> dict:
    """bench.py:613-616's entry: the value to one decimal and its ratio to
    the reference core, with this run's median ms, parity and launches."""
    entry = {"metric": metric, "value": round(run["value"], 1), "unit": unit, **extra}
    ref = _REF_RATES.get(ref_key)
    if ref:
        entry["vs_reference_core"] = round(run["value"] / ref, 2)
    entry.update({k: run[k] for k in ("ms", "n", "words", "parity", "parity_lanes", "launches")})
    print(f"[bench] {metric}: {run['value']:,.1f} {unit} ({run['ms']:.3f} ms, {run['parity_lanes']} checked, "
          f"launches {run['launches']})", file=sys.stderr)
    return entry


def headline_doc(run: dict) -> dict:
    return {"metric": HEADLINE, "value": round(run["value"], 1), "unit": "hashes/s",
            "vs_baseline": round(run["value"] / REFERENCE_RATE, 2)}


def secondary_configs(n: int, device, mul_impl=None) -> list:
    """The default run's secondary configs (bench.py:620-656), in its
    order: (metric, unit, reference key, extra-keys function, run); the
    Jive configs and the roots with ``mul_impl``."""
    sponge_mb = lambda r: {"mb_per_sec": round(r["value"] * MSG_BYTES / 1e6, 1)}
    none = lambda r: {}
    return [
        ("vesta_anemoi_4_3_jive_2to1", "hashes/s", ("vesta", "anemoi_4_3", "jive"), none,
         lambda: bench_jive("vesta", "anemoi_4_3", n=n // 4, reps=2, device=device, mul_impl=mul_impl)),
        ("bls12_377_anemoi_2_1_jive_2to1", "hashes/s", ("bls12_377", "anemoi_2_1", "jive"), none,
         lambda: bench_jive("bls12_377", "anemoi_2_1", n=n // 4, reps=2, device=device, mul_impl=mul_impl)),
        ("vesta_anemoi_4_3_sponge_10kb", "msgs/s", ("vesta", "anemoi_4_3", "sponge10kb"), sponge_mb,
         lambda: bench_sponge_10kb(device=device)),
        ("bls12_377_anemoi_4_3_sponge_10kb", "msgs/s", ("bls12_377", "anemoi_4_3", "sponge10kb"), sponge_mb,
         lambda: bench_sponge_10kb("bls12_377", "anemoi_4_3", n_msgs=1024, device=device)),
        ("vesta_anemoi_2_1_merkle_2p20_arity2", "leaves/s", None, none,
         lambda: bench_merkle(device=device, mul_impl=mul_impl)),
        ("vesta_anemoi_4_3_merkle_2p24_arity4", "leaves/s", None, none,
         lambda: bench_merkle("vesta", "anemoi_4_3", n_leaves=1 << 24, reps=2, device=device, mul_impl=mul_impl)),
    ]


def all_configs(n: int, device, mul_impl=None) -> list:
    """``--all``'s configs after the headline and the dry run (bench.py:468-503)."""
    configs = [(f"{f}_{i}_jive_2to1", "hashes/s", (f, i, "jive"), lambda r: {},
                lambda f=f, i=i: bench_jive(f, i, n=n // 4, reps=2, device=device, mul_impl=mul_impl))
               for f, i in [("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_2_1"), ("bls12_377", "anemoi_2_1"),
                            ("bls12_377", "anemoi_4_3")]]
    configs += [(f"{f}_{i}_sponge_10kb", "msgs/s", (f, i, "sponge10kb"),
                 lambda r: {"mb_per_sec": round(r["value"] * MSG_BYTES / 1e6, 1)},
                 lambda f=f, i=i: bench_sponge_10kb(f, i, n_msgs=4096 if (f, i) == ("vesta", "anemoi_4_3") else 1024,
                                                    device=device))
                for f, i in [("vesta", "anemoi_4_3"), ("vesta", "anemoi_2_1"), ("bls12_377", "anemoi_4_3"),
                             ("bls12_377", "anemoi_2_1")]]
    return configs + secondary_configs(n, device, mul_impl)[4:]  # the two trees


def run_configs(configs: list) -> list:
    """Runs each config in order; returns their entries."""
    entries = []
    for metric, unit, ref, extra, bench in configs:
        run = bench()
        entries.append(config_entry(metric, unit, run, ref, **extra(run)))
    return entries


def bench_matrix(n=1 << 18, reps=2, out_path=MATRIX_OUT, resume=False, device=None, mul_impl=None) -> list:
    """Jive rates of all 14 instantiations (bench.py:275-339), each with its
    PARITY lanes checked; writes a markdown table to out_path after every
    row.  With ``resume``, rows already in out_path are kept and only the
    missing ones measured.  Returns [(field, instance, rate, vs reference
    core, parity, run or None for a kept row)]."""
    device = cuda_backend.resolve_device(device)
    out_path = Path(out_path)
    label = device_label(device)
    total = len(FIELD_NAMES) * len(INSTANCE_NAMES)

    def write(rows):
        lines = [
            "# Benchmark matrix (generated by `python3 -m anemoi_tpu_torch.bench --matrix`)",
            "",
            f"Jive 2-to-1 compressions/s on {label} (batch {n}, the median of {reps} synchronized calls on the "
            f"host clock, {PARITY} lanes of each batch against the golden model).",
            "Reference column: upstream single-core i7-9750H rate where published",
            "(reference README.md:77-78).",
        ] + (["", f"PARTIAL RUN: {len(rows)} of {total} configs measured."] if len(rows) < total else []) + [
            "",
            "| Field | Instance | hashes/s | vs reference core | parity |",
            "|---|---|---|---|---|",
        ]
        lines += [f"| {f} | {i} | {rate:,.1f} | {vs} | {parity} |" for f, i, rate, vs, parity, _ in rows]
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text("\n".join(lines) + "\n")

    done = {}
    if resume and out_path.exists():
        for m in _ROW.finditer(out_path.read_text()):
            done[(m.group(1), m.group(2))] = (float(m.group(3).replace(",", "")), m.group(4), m.group(5))
        print(f"[matrix] resume: keeping {len(done)} measured rows", file=sys.stderr)
    rows = []
    for field in FIELD_NAMES:
        for iname in INSTANCE_NAMES:
            if (field, iname) in done:
                rows.append((field, iname, *done[(field, iname)], None))
                continue
            run = bench_jive(field, iname, n=n, reps=reps, device=device, mul_impl=mul_impl)
            ref = _REF_RATES.get((field, iname, "jive"))  # bench.py:288-289's latencies, as rates
            vs = f"{run['value'] / ref:.1f}x" if ref else "--"
            rows.append((field, iname, run["value"], vs, f"{run['parity_lanes']} lanes exact", run))
            print(f"[matrix] {field}/{iname}: {run['value']:,.1f}/s ({vs} vs ref core; {run['ms']:.3f} ms a call)",
                  file=sys.stderr)
            write(rows)
    write(rows)
    print(f"[matrix] wrote {out_path}", file=sys.stderr)
    return rows


def bench_all(n: int, reps: int, out_path=ALL_OUT, device=None, mul_impl=None) -> dict:
    """Every BASELINE config (bench.py:418-526): the headline JSON line
    first, then one document, also written as a table to out_path."""
    device = cuda_backend.resolve_device(device)
    head = bench_jive(n=n, reps=reps, device=device, mul_impl=mul_impl)
    print(json.dumps(headline_doc(head)), flush=True)
    configs = [config_entry("vesta_anemoi_2_1_jive_2to1", "hashes/s", head, ("vesta", "anemoi_2_1", "jive")),
               dryrun_entry(bench_multichip_dryrun())]
    configs += run_configs(all_configs(n, device, mul_impl))
    doc = {"device": device_label(device), "headline": headline_doc(head), "configs": configs}
    lines = ["# Full benchmark sweep (generated by `python3 -m anemoi_tpu_torch.bench --all`)", "",
             f"Device: {doc['device']}.  Reference column: upstream single-core",
             "i7-9750H rate where published (reference README.md:77-85).", "",
             "| Metric | Value | Unit | vs reference core |", "|---|---|---|---|"]
    lines += [f"| {c['metric']} | {c['value']:,} | {c['unit']} | {c.get('vs_reference_core', '--')} |" for c in configs]
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text("\n".join(lines) + "\n")
    print(json.dumps(doc), flush=True)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m anemoi_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None, help="states of the headline Jive (default 2^20; --matrix: 2^18)")
    ap.add_argument("--block", type=int, default=None,
                    help="accepted and ignored: bench.py's kernel batch tile; the kernels choose their own blocking")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--all", action="store_true",
                    help="bench every BASELINE config; print one JSON doc and write docs/BENCHMARKS_TORCH_ALL.md")
    ap.add_argument("--matrix", action="store_true",
                    help="bench every instantiation and write docs/BENCHMARKS_TORCH.md")
    ap.add_argument("--resume", action="store_true",
                    help="with --matrix: keep rows already in the doc and measure only the missing configs")
    ap.add_argument("--out", default=None, help="the table --matrix or --all writes")
    ap.add_argument("--impl", default=None,
                    help="bench.py's mul impl (cios | cios2 | cios<k> | parallel | mxu...): mxu, mxuf, mxus, mxu2 or "
                         "mxu3 runs the Jive configs on the tensor-core Jive kernel; the others are validated and "
                         "change nothing")
    ap.add_argument("--ladder", default=None,
                    help="validated and ignored: bench.py's exp ladder (fixed4 | sw4 | chain...)")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the secondary BASELINE configs in the default run (headline JSON only)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a Chrome trace of the headline's timed calls into DIR (utils.profiling.trace)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu, which runs the plain version")
    args = ap.parse_args(argv)
    try:
        check_tuning(args.impl, args.ladder)
    except ValueError as e:
        ap.error(str(e))
    try:
        device = cuda_backend.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"anemoi_tpu_torch.bench: {e}", file=sys.stderr)
        return 2

    if args.matrix:
        rows = bench_matrix(n=args.n or 1 << 18, reps=args.reps, out_path=args.out or MATRIX_OUT,
                            resume=args.resume, device=device, mul_impl=args.impl)
        print(json.dumps({"device": device_label(device), "matrix": [
            {"field": f, "instance": i, "value": rate, "vs_reference_core": vs, "parity": parity,
             **({k: run[k] for k in ("ms", "n", "words", "parity_lanes", "launches")} if run else {"kept": True})}
            for f, i, rate, vs, parity, run in rows]}), flush=True)
        return 0
    if args.all:
        bench_all(args.n or 1 << 20, args.reps, args.out or ALL_OUT, device, args.impl)
        return 0

    n = args.n or 1 << 20
    head = bench_jive(n=n, reps=args.reps, device=device, profile_dir=args.profile, mul_impl=args.impl)
    doc = headline_doc(head)
    # the headline first and flushed: a run cut short still leaves it on stdout
    print(json.dumps(doc), flush=True)
    if not args.headline_only:
        doc.update(device=device_label(device), ms=head["ms"], n=n, words=head["words"], parity=head["parity"],
                   parity_lanes=head["parity_lanes"], launches=head["launches"])
        doc["configs"] = [dryrun_entry(bench_multichip_dryrun())] + run_configs(secondary_configs(n, device,
                                                                                                 args.impl))
        print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
