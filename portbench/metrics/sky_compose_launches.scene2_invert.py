"""Kernel launches per step that the host issues inside the port's
"sky_lookup" and "compose" spans (the profiler's cudaLaunchKernel calls
there), in scene2.fit_invert: one a sample where the bilinear sky goes
through the sky compose kernel, the plain lookup's and compose's ops where
it does not. The adjoint's launches lie in "kernel.sky_compose_adjoint" and
the soft silhouettes' own sky lookup in "soft_silhouettes", so neither is
counted. Read in the profiled slice."""

from portbench.program_spans import launches_per_unit


def read(ctx):
    return launches_per_unit(ctx, "train_step", ("sky_lookup", "compose"))
