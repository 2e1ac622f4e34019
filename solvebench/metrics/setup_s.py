"""Seconds from the start of the process to the first timed solve."""


def read(ctx):
    return ctx.setup_s
