"""Small CPU versions of the cells, for the tests: the same runners, traffic
and checks at sizes a test run can hold."""

import json
import os
import shutil
import tempfile

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell(name: str, **traffic) -> dict:
    with open(os.path.join(BENCH, "cells", f"{name}.json")) as f:
        c = json.load(f)
    small = {"mmgan.train_none": dict(batch_size=4, steps_per_epoch=6, warm=3),
             "mmgan.serve_n1": dict(warm=1, check_requests=3, requests_pool=8),
             "gandes.serve_n1": dict(warm=1, check_requests=2, requests_pool=8)}
    c["traffic"].update(small.get(name, {}), **traffic)
    return c


def run(name: str, seed: int, seconds: float = 1.0, **traffic):
    from portbench import run as R

    R.fix_caches()
    # a directory of its own, so that test processes running side by side
    # do not share the program's outputs
    run_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return R.run_cell(name, seed, seconds, False, require_cuda=False,
                          cell=cell(name, **traffic), run_dir=run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
