"""``inst.batch.compress_k(states, k)`` over ``states`` canonical Montgomery
states, int32 [width, L, states]; the check recomputes ``check.lanes``
lanes of each input set, the first and last 32 among them."""

from benchmark import roofline
from benchmark.generator import Entry, canonical, generator, host_ints, sample, sample_rng

CHUNK = 64  # lanes a reference task


def build(torch, att, defn, traffic, seed, device) -> Entry:
    inst = att.instance(defn.field, defn.name)
    W, L, n, k, sets = defn.width, defn.n_limbs, traffic["states"], traffic.get("k", 2), traffic["input_sets"]
    states = [canonical(torch, generator(torch, seed, i, device), (W, L, n), L, defn.bits, device)
              for i in range(sets)]
    rng = sample_rng(seed, 1 << 20)
    lanes = [sample(rng, n, 32, traffic["check"]["lanes"]) for _ in range(sets)]

    def tasks(i, out):
        ins = [host_ints(states[i][w], lanes[i]) for w in range(W)]
        got = [host_ints(out[c], lanes[i]) for c in range(out.shape[0])]
        items = [[x[j] for x in ins] for j in range(len(lanes[i]))]
        answers = [[g[j] for g in got] for j in range(len(lanes[i]))]
        starts = range(0, len(items), CHUNK)
        return ([("jive", defn.field, defn.name, k, items[a:a + CHUNK]) for a in starts],
                [answers[a:a + CHUNK] for a in starts])

    return Entry(sets, lambda i: inst.batch.compress_k(states[i], k), {"hashes": n},
                 {"jive": roofline.jive(defn, n, k)}, tasks, "hashes")
