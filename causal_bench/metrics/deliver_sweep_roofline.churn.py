"""Percent of its roofline that ``deliver_sweep`` reaches in the gated
rounds of a churn cell: the bound of the window's launches
(``roofline/deliver_sweep.py``, counted on one more repetition) over their
kernel time in the device trace."""

from causal_bench.harness.readers import roofline_share
from causal_bench.harness.spec import load_roofline

ROOFLINE = "deliver_sweep"


def read(ctx):
    return roofline_share(ctx, ROOFLINE, load_roofline(ROOFLINE))
