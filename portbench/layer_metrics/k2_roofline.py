"""K2's share of its roofline, in percent: the frozen work model's bound
of the launches the hooks recorded over the profiler's device time of
``rns_pow_kernel``, per launch."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, "k2", "rns_pow_kernel")
