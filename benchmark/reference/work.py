"""The reference's tasks, one picklable call each, for a pool of processes.

A task names its instance and carries Python integers or bytes; it
returns, for each item, the Montgomery integers the program should store
("want") and those of the control, which skips the final reduction of the
last addition ("lazy").  Inputs in Montgomery form are the API's: the
limbs' integer, x R mod p.
"""

from __future__ import annotations

from . import anemoi as ref


def _jive_mont(inst: ref.Instance, state_mont: list, k: int) -> tuple[list, list]:
    terms = ref.jive_terms(inst, [ref.from_mont(inst, v) for v in state_mont], k)
    return [ref.to_mont(inst, sum(t) % inst.p) for t in terms], [ref.lazy_mont(inst, t) for t in terms]


def _digest_mont(inst: ref.Instance, elems: list) -> tuple[list, list]:
    pairs = ref.hash_field(inst, elems, pht_terms=True)
    return [ref.to_mont(inst, (a + b) % inst.p) for a, b in pairs], [ref.lazy_mont(inst, ab) for ab in pairs]


def _tree_mont(inst: ref.Instance, leaves_mont: list, arity: int, k: int) -> tuple[list, list]:
    level = [ref.from_mont(inst, v) for v in leaves_mont]
    while len(level) > arity:
        level = [ref.jive(inst, level[i:i + arity], k)[0] for i in range(0, len(level), arity)]
    return _jive_mont(inst, [ref.to_mont(inst, v) for v in level], k)


def run(task: tuple) -> list:
    """("jive", field, name, k, [state of width Montgomery ints, ...])
    ("tree", field, name, arity, k, [leaf Montgomery ints])  (one item: the root)
    ("field", field, name, [[element Montgomery ints], ...])
    ("bytes", field, name, [message bytes, ...])
    -> [(want, lazy), ...], each a list of Montgomery ints."""
    kind, field, name, *args = task
    inst = ref.instance(field, name)
    if kind == "jive":
        k, states = args
        return [_jive_mont(inst, s, k) for s in states]
    if kind == "tree":
        arity, k, leaves = args
        return [_tree_mont(inst, leaves, arity, k)]
    if kind == "field":
        (messages,) = args
        return [_digest_mont(inst, [ref.from_mont(inst, v) for v in m]) for m in messages]
    if kind == "bytes":
        (messages,) = args
        return [_digest_mont(inst, ref.bytes_to_elements(inst, m)) for m in messages]
    raise ValueError(f"unknown reference task {kind!r}")
