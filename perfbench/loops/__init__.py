"""Traffic loops, one module per traffic ``kind``, found by that name.
Each defines ``run(ctx) -> harness.Outcome`` (None on a rank other than
0 of a multi-rank cell)."""
