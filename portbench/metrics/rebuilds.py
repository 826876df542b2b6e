"""Cached state built again inside the window: the number of the program's
``srcnn.build.*`` spans that start in it.  The program writes one only
when a cache misses (the kernel library, K2's plan and tables, K1's plan,
K3's launch arguments, the packed weights, the bicubic tables), so a warm
window reads 0.  None where the window holds no ``srcnn.`` span at all: a
program that records no spans cannot say."""

PREFIX = "srcnn."
BUILD = "srcnn.build."


def read(ctx):
    names = [n for n, _, _ in ctx.host_ops if n.startswith(PREFIX)]
    if not names:
        return None
    return sum(n.startswith(BUILD) for n in names)
