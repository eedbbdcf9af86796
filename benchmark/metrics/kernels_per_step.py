"""Device kernels a train step launches: every kernel the profiler records
(the port's and the libraries') over the traced steps."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps
