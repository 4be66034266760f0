"""Kernel B2's share of its roofline over the traced requests, in percent.

B2's device time is the trace's ``brick_integrate_kernel`` time. The least
time is, for each slice of each traced request, the larger of its bytes at
the memory rate and its operations at the float32 rate
(``portbench/harness/roofline.py``), with the table nodes the slice's rays
touch counted from the reference's own ray geometry. None when the traced
requests launched no B2 (a packed table) or no trace was taken.
"""

from portbench.harness import roofline


def read(ctx):
    if not ctx.trace:
        return None
    kernel_s = sum(t for n, t in ctx.trace['kernels'].items() if 'brick_integrate_kernel' in n)
    if kernel_s <= 0.0:
        return None
    least = sum(roofline.b2_least_seconds(ctx.scene, k) for k in range(ctx.traced))
    return 100.0 * least / kernel_s
