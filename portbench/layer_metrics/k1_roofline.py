"""K1's share of its roofline, in percent: the frozen work model's bound
of the launches the hooks recorded over the profiler's device time of
``rns_verify_kernel``, per launch."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, "k1", "rns_verify_kernel")
