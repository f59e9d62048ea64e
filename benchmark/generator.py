"""The one general generator: a configuration and a traffic file's
parameters -> the calls the window's loop makes, with inputs made from
the seed.

A configuration (``configs/<name>.json``) names a field and an instance;
their sizes (bits, limbs, width, rate, rounds, the byte chunk) are the
definition's, read from the reference's constants.  A traffic file
(``traffic/<name>.json``) names the program's entry point (``"entry"``, a
module of ``entries/``: ``jive``, ``merkle_root``, ``hash_bytes``), the
loop that drives it (``"loop"``, a module of ``loops/``; ``closed`` where
it names none) and its sizes.  ``input_sets`` distinct
inputs are made in set-up and the loop takes them in turn;
``warmup_calls`` calls run before the window; ``check`` sizes the sample
the reference recomputes.  Every seed gives the same sizes.

Each entry yields what the harness and the judge need: ``call(i)`` runs
one call on input set i and returns its output; ``items`` and ``work``
count one call; ``tasks(i, out)`` turns a kept output into reference tasks
and the program's answers to them, on the host.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .reference import anemoi as ref
from .reference.anemoi import limbs_to_ints

LIMB_BITS = 13


@dataclass
class Entry:
    n_sets: int
    call: Callable[[int], object]
    items: dict  # per call: "hashes", "roots", "messages"
    work: dict  # per call: "jive" or "sponge" -> roofline.Work
    tasks: Callable[[int, object], tuple[list, list]]  # -> (reference tasks, answers per task item)
    answers: str  # what an answer is, for the checks' names: "hashes", "nodes", "digests"


def set_seed(seed: int, i: int) -> int:
    """The seed of input set i: 64 bits drawn from (seed, i)."""
    return int(np.random.SeedSequence([seed & (2**64 - 1), i]).generate_state(1, np.uint64)[0])


def canonical(torch, gen, shape: tuple, n_limbs: int, bits: int, device) -> "torch.Tensor":
    """int32 [..., L, n] random 13-bit limbs of values below 2^(bits - 1),
    so below p: canonical Montgomery elements (the limbs axis second to last)."""
    limbs = torch.randint(0, 1 << LIMB_BITS, shape, generator=gen, device=device, dtype=torch.int32)
    keep = np.clip(bits - 1 - LIMB_BITS * np.arange(n_limbs), 0, LIMB_BITS)
    mask = torch.tensor(((1 << keep) - 1).astype(np.int32), device=device).reshape(n_limbs, 1)
    return limbs & mask


def sample(rng: np.random.Generator, n: int, edge: int, total: int) -> np.ndarray:
    """`edge` indices at each end of [0, n) and random ones between, `total`
    in all (or all of them when n is smaller), sorted."""
    if n <= total:
        return np.arange(n)
    edge = min(edge, total // 2)
    ends = np.r_[np.arange(edge), np.arange(n - edge, n)]
    middle = rng.choice(np.arange(edge, n - edge), size=total - 2 * edge, replace=False)
    return np.sort(np.r_[ends, middle])


def host_ints(x, cols) -> list:
    """int32 [L, n] tensor or array -> the integers of the given columns."""
    if hasattr(x, "cpu"):  # a tensor, on any device
        import torch

        arr = x[:, torch.as_tensor(np.asarray(cols), device=x.device)].cpu().numpy()
    else:
        arr = np.asarray(x)[:, cols]
    return limbs_to_ints(arr)


def build(cfg: dict, traffic: dict, seed: int, device) -> Entry:
    """The traffic's entry, ``entries/<entry>.py``'s ``build``, over inputs
    made from the seed, with the configuration's instance as the reference
    defines it."""
    import torch

    import anemoi_tpu_torch as att

    defn = ref.instance(cfg["field"], cfg["instance"])
    module = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    return module.build(torch, att, defn, traffic, seed, device)


def generator(torch, seed: int, i: int, device):
    """The torch.Generator of input set i, on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(set_seed(seed, i))
    return gen


def sample_rng(seed: int, salt: int) -> np.random.Generator:
    """The generator of an entry's sample; `salt` tells the entries apart."""
    return np.random.default_rng([seed & (2**64 - 1), salt])


def digest_answers(out, idx) -> list:
    """int32 [DIGEST, L, B] (array or tensor) -> per message its digest's ints."""
    per = [host_ints(out[d], idx) for d in range(out.shape[0])]
    return [[per[d][j] for d in range(len(per))] for j in range(len(idx))]
