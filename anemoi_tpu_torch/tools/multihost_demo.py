"""Multi-process Merkle forest demo over ``torch.distributed``.

    python3 -m anemoi_tpu_torch.tools.multihost_demo --procs 2 --leaves 64 [--device cpu]

Counterpart of ``tools/multihost_demo.py``: spawns N processes on this
machine (``dist.ranks.run_ranks``), brings up one process group over them
(gloo on the CPU, NCCL on the cards, one card a process) through a
``file://`` store in a temporary directory, builds the sharded Merkle
forest (``dist/forest.py``: a subtree a rank, one all-gather of the
roots, the top tree on every rank) over M Vesta anemoi_2_1 leaves, and
has every rank check its root against the golden model's chained Jive
over all M leaves.

Exit codes: 0 when every rank's root is right ("multihost demo: OK"), 1
when a root is wrong, 2 when the group does not form (a rank that meets
no other within ``--timeout`` seconds), a rank fails or is killed, or the
machine has too few cards.  The ranks' output goes to files in a
temporary directory; a failed rank's is shown.
"""

from __future__ import annotations

import argparse
import sys

from ..dist.ranks import run_ranks


def demo_rank(chips, n_leaves: int) -> dict:
    """One rank of the demo: the forest's root over the leaves, and whether
    it equals the golden model's."""
    import numpy as np
    import torch.distributed as dist

    from ..dist import forest, mesh
    from ..ff import golden
    from ..ff.limb_ops import decode_ints, encode_ints
    from ..fields.params import get_instance

    inst = get_instance("vesta", "anemoi_2_1")
    fp = inst.field
    rng = np.random.default_rng(0)  # the same leaves on every process
    leaves_int = [int(rng.integers(0, 2**62)) for _ in range(n_leaves)]
    fn = forest.sharded_merkle_root_fn(inst, chips, n_leaves)
    root_int = decode_ints(fn(mesh.shard_batch(encode_ints(leaves_int, fp), chips)), fp)[0]

    # the single-process truth: the golden model's chained Jive
    level = leaves_int
    while len(level) > 1:
        level = [golden.jive_compress(inst, level[i:i + 2])[0] for i in range(0, len(level), 2)]
    return {"ok": root_int == level[0], "backend": dist.get_backend()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m anemoi_tpu_torch.tools.multihost_demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--leaves", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default): NCCL, one card a process, so a one-card machine allows only "
                         "--procs 1; cpu: gloo, the plain version, no card visible to the processes")
    ap.add_argument("--timeout", type=float, default=300, help="seconds a rank waits for the group and a collective")
    args = ap.parse_args(argv)

    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.procs:
            print(f"multihost demo: {args.procs} processes need {args.procs} cards; this machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
    try:
        results = run_ranks("anemoi_tpu_torch.tools.multihost_demo:demo_rank", args.procs, device=args.device,
                            kwargs={"n_leaves": args.leaves}, timeout=args.timeout)
    except RuntimeError as e:
        # a green light that verifies nothing is worse than a red one
        print(f"multihost demo: FAILED: the group of {args.procs} did not form or a rank failed: {e}", flush=True)
        return 2
    for r, res in enumerate(results):
        print(f"[proc {r}] root match: {res['ok']} ({res['backend']}, {args.procs} ranks)", flush=True)
    ok = all(res["ok"] for res in results)
    print("multihost demo:", "OK" if ok else "FAILED: a wrong root", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
