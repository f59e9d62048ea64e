#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

The main path is batched Vesta anemoi_2_1 Jive 2-to-1 compression and a
Merkle root over 2^20 leaves built on it, through the port's entry points
(``jive_compress_batch_fn``, ``MerkleTree.root``), with random canonical
inputs from ``--seed``.  Phases, each printed with its elapsed seconds:

  1. the card: its name, and name and power limit from nvidia-smi;
  2. the build of csrc/jive.cu with nvcc, timed, with ptxas's report;
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
  6. one JSON line of kernels: launches, error, times, bound.

The tolerance everywhere is exact: integer arithmetic, canonical outputs.
Any failure raises; the last line, printed only when every phase passed, is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
package beside this file, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

N_CHECK = 4099  # not a multiple of the kernel's 128-thread block
N_PLAIN = 257
N_FULL = 1 << 20
N_SAMPLE = 1024
SMALL_TREE = 1 << 10
REPS = 5

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
    from anemoi_tpu_torch.ff import cuda_backend
    from anemoi_tpu_torch.ff.limb_ops import random_canonical
    from anemoi_tpu_torch.fields.params import KERNEL_FIELDS, get_instance, inv_alpha_chain
    from anemoi_tpu_torch.merkle.tree import MerkleTree, level_states
    from anemoi_tpu_torch.modes.batched import decode_states, encode_states, jive_compress_batch_fn

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", 0)
    max_err = 0

    def canonical_states(inst, n):
        """int32 [WIDTH, L, n] random canonical states on the card."""
        return torch.from_numpy(random_canonical(inst.field, (inst.width, n), rng).transpose(1, 0, 2).copy()).to(dev)

    def held(kernel_out, plain_out, what):
        nonlocal max_err
        err = int((kernel_out.long() - plain_out.long()).abs().max())
        max_err = max(max_err, err)
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
    lib = cuda_backend.library()
    build_s = time.perf_counter() - t
    print(f"build: nvcc {lib.build_seconds if lib.build_seconds is not None else 'not run (built earlier)'} s, "
          f"load {build_s:.2f} s, {lib.path.name}", flush=True)
    for line in lib.ptxas:
        print(f"  {line}", flush=True)

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
    launches = cuda_backend.jive.launches
    root_launches = launches - before_root
    print(f"  main path: Jive over {N_FULL} states and a {N_FULL}-leaf root: {launches} kernel launches "
          f"({root_launches} for the root)", flush=True)
    if launches == 0:
        fail("the main path launched no kernel")
    if root_launches != tree.num_levels(N_FULL):
        fail(f"the root took {root_launches} launches for {tree.num_levels(N_FULL)} levels")
    if tuple(digests.shape) != (1, L, N_FULL) or tuple(root.shape) != (L, 1):
        fail(f"shapes {tuple(digests.shape)}, {tuple(root.shape)}")

    ms = cuda_time_ms(lambda: compress(states), REPS)
    print(f"  Jive 2-to-1, {N_FULL} states: {ms:.3f} ms per call, {ms * 1e3 / N_FULL:.4f} us per hash, "
          f"{N_FULL / (ms / 1e3):.1f} hashes/s ({smi}; CUDA events, mean of {REPS} after a warm-up)", flush=True)

    sample = torch.from_numpy(np.sort(rng.choice(N_FULL, N_SAMPLE, replace=False))).to(dev)
    xs = states[:, :, sample].reshape(W * L, N_SAMPLE).contiguous()
    plain_ms, plain = host_time_ms(lambda: cuda_backend.jive_plain(inst, 2, xs))
    held(digests.reshape(L, N_FULL)[:, sample], plain, "2^20 Jive, sampled lanes")
    print(f"  {N_SAMPLE} sampled lanes held against the plain version ({plain_ms:.1f} ms): identical", flush=True)

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

    # 6 ---------------------------------------------------------------------
    phase("6 kernels")
    # per Flystel: the reference addition chain, two squarings y^2 and two
    # products by beta
    chain = inv_alpha_chain(inst.field.name)
    flystels = inst.rounds * inst.columns
    squarings = flystels * (sum(op[0] == "sqr" for op in chain) + 2)
    products = flystels * (sum(op[0] == "mul" for op in chain) + 2)
    imads = squarings * IMADS_PER_SQUARING + products * IMADS_PER_PRODUCT
    imad_per_s = props.multi_processor_count * IMAD_PER_CLOCK_PER_SM * max_sm_mhz * 1e6
    ops_ms = N_FULL * imads / imad_per_s * 1e3
    bytes_ms = N_FULL * (W + 1) * L * 4 / HBM_BYTES_PER_S * 1e3
    print(f"  bound: per hash {squarings} squarings x {IMADS_PER_SQUARING} + {products} products x "
          f"{IMADS_PER_PRODUCT} = {imads} IMADs at {imad_per_s:.4g}/s = {ops_ms:.3f} ms; "
          f"bytes {bytes_ms:.4f} ms; kernel at {max(ops_ms, bytes_ms) / ms:.1%} of it", flush=True)
    print(json.dumps({"kernels": [{
        "name": "jive",
        "route": "cuda",
        "source": "anemoi_tpu_torch/csrc/jive.cu",
        "replaces": "anemoi_tpu/ff/pallas_backend.py:707",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "lanes": N_FULL,
        "plain_lanes": N_SAMPLE,
        "root_ms": root_ms,
        "build_s": lib.build_seconds,
    }]}), flush=True)
    phase("done")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
