"""The comparison that decides ``correct``.

``gather`` copies, from the last output of each input set, the answers the
sample asks for, with the reference tasks that recompute them; ``compare``
runs the tasks (in a pool of processes when ``workers`` allows) and counts
the answers that differ from the reference.  Every output is exact, so the
limit is 0 wrong answers.  With ``control`` the reference's own answers
with the final reduction skipped stand in the program's place: a judge
that passes them is no judge.
"""

from __future__ import annotations

import multiprocessing
import os

from .reference import work


def gather(entry, kept: dict) -> tuple[list, list]:
    """-> (tasks, answers): per task its call's input set, the task, and
    the program's answer to each of its items."""
    tasks, answers = [], []
    for i, out in sorted(kept.items()):
        ts, ans = entry.tasks(i, out)
        tasks += [(i, t) for t in ts]
        answers += ans
    return tasks, answers


def _pool_size(workers: int | None, n_tasks: int) -> int:
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    return min(workers, n_tasks)


def compare(tasks: list, answers: list, *, workers: int | None = None, control: bool = False) -> dict:
    """-> {"wrong", "compared", "wrong_calls"} over every item of every task."""
    jobs = [t for _, t in tasks]
    size = _pool_size(workers, len(jobs))
    if size > 1:
        # spawned workers import the reference alone, never the program
        with multiprocessing.get_context("spawn").Pool(size) as pool:
            results = pool.map(work.run, jobs, chunksize=1)
            pool.close()
            pool.join()
    else:
        results = [work.run(j) for j in jobs]
    wrong = compared = 0
    bad_sets = set()
    for (i, _), got, res in zip(tasks, answers, results):
        for j, (want, lazy) in enumerate(res):
            answer = lazy if control else (got[j] if j < len(got) else None)
            compared += 1
            if answer != want:
                wrong += 1
                bad_sets.add(i)
    return {"wrong": wrong, "compared": compared, "wrong_calls": len(bad_sets)}
