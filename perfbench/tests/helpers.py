"""Runs of a cell on the CPU at a test's size.

``train_bench()`` is BENCHMARK.json with the training cells of the bench
loss, which the benchmark leaves out while the program's grads go
non-finite on some frames (PERF.md, Open questions): the training loop
(perfbench/loops/train.py) is held to its reference and its faults here,
so that those cells come back as entries alone.
"""

import torch

from perfbench import harness

SEED = 5_123_456_789          # more than 32 bits, as benchmark seeds may be
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_rel": 1e-3}
TRAIN_CELLS = [
    {"name": "cornell-train", "config": "cornell", "traffic": "train_closed",
     "chips": 1, "why": "fwd+bwd steps of the bench loss, brute force"},
    {"name": "bunny-train", "config": "bunny", "traffic": "train_closed",
     "chips": 1, "why": "fwd+bwd steps of the bench loss, sweep and B1"},
    {"name": "cornell-train-dp4", "config": "cornell",
     "traffic": "train_sharded4", "chips": 4,
     "why": "the cornell-train steps over 4 ranks, all-reduced"}]


def train_bench():
    bench = harness.spec()
    cells = [c["name"] for c in TRAIN_CELLS]
    return dict(bench, workloads=bench["workloads"] + TRAIN_CELLS,
                end_to_end=bench["end_to_end"] + [
                    {"name": "train_mrays", "unit": "Mrays/s",
                     "better": "higher", "bound": 0.05,
                     "source": "host_clock", "workloads": cells}])


def small(size=16, **traffic):
    return {"render": {"width": size, "height": size},
            "traffic": {"check_steps": 2, "check_frames": 2, **traffic}}


def is_train(name):
    return name in {c["name"] for c in TRAIN_CELLS}


def run_small(name, fault=None, size=16, seconds=1.0, seed=SEED,
              **traffic):
    train = is_train(name)
    ov = dict(small(size, **traffic), **({"limits": TRAIN_LIMITS}
                                         if train else {}))
    ctx = harness.make_ctx(name, seed, seconds, False, torch.device("cpu"),
                           harness.process_started(), fault=fault,
                           overrides=ov,
                           bench=train_bench() if train else None)
    return harness.run_cell(ctx)
