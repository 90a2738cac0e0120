"""A further rank of a multi-card cell, started by rank 0 of the same run:

    python -m perfbench.rank '{"name": ..., "seed": ..., "seconds": ...,
        "trace": ..., "device": "cuda:1", "rank": 1, "init_method": ...,
        "fault": null, "overrides": null}'

It runs the cell's loop as that rank and prints nothing; rank 0 gathers
what it measured.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import torch

    from perfbench import harness

    started = harness.process_started()
    spec = json.loads((argv or sys.argv[1:])[0])
    torch.set_num_threads(4 if spec["device"].startswith("cuda") else 1)
    device = torch.device(spec.pop("device"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ctx = harness.make_ctx(spec.pop("name"), spec.pop("seed"),
                           spec.pop("seconds"), spec.pop("trace"), device,
                           started, **spec)
    harness.run_cell(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
