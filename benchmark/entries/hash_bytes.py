"""``inst.batch.hash_bytes(messages)`` over ``messages`` random messages of
``message_bytes`` bytes each, made on the host; the check recomputes
``check.messages`` whole messages of each input set, bytes to digest."""

import numpy as np

from benchmark import roofline
from benchmark.generator import Entry, digest_answers, sample, sample_rng, set_seed


def build(torch, att, defn, traffic, seed, device) -> Entry:
    inst = att.instance(defn.field, defn.name)
    n, nbytes, sets = traffic["messages"], traffic["message_bytes"], traffic["input_sets"]
    messages = []
    for i in range(sets):
        blob = np.random.default_rng(set_seed(seed, i)).bytes(n * nbytes)
        messages.append([blob[j * nbytes:(j + 1) * nbytes] for j in range(n)])
    rng = sample_rng(seed, 1 << 22)
    picks = [sample(rng, n, 2, traffic["check"]["messages"]) for _ in range(sets)]

    def tasks(i, out):
        return ([("bytes", defn.field, defn.name, [messages[i][j]]) for j in picks[i]],
                [[a] for a in digest_answers(out, picks[i])])

    elements = -(-nbytes // defn.byte_chunk)
    return Entry(sets, lambda i: inst.batch.hash_bytes(messages[i], device=device), {"messages": n},
                 {"sponge": roofline.sponge(defn, n, elements)}, tasks, "digests")
