"""The program's preconditioner set-up (`setup_breakdown["precond_s"]`:
for AMG the hierarchy, from the setup cache after a checkout's first run,
and its device layouts), seconds."""


def read(ctx):
    return ctx.setup_breakdown.get("precond_s")
