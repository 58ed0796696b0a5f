"""K1's device time per pixel and object, in ps, in objects1024.render: the
traced K1 launches' device time over their number times the pixels and
objects that the port's "kernel.megakernel_fwd" spans of the slice count.
K1 scans every object for each ray, so this is the time of one pixel's
sample against one object; it carries no roofline, since a traversal
structure over the objects would test fewer than the scan's count. None
where the spans count no objects (a program from before the counts)."""

from portbench.program_spans import spans_of
from portbench.readers import megakernel


def read(ctx):
    spans = spans_of(ctx, "render_image")
    if spans is None:
        return None
    counts = [spans.rows[i][5] for i in spans.outermost(("kernel.megakernel_fwd",))]
    counts = [c for c in counts if "objects" in c and "pixels" in c]
    if not counts:
        return None
    pairs = sum(c["pixels"] * c["objects"] for c in counts) / len(counts)
    ops = ctx.trace.kernels(lambda n: megakernel(n) == "k1")
    if not ops or pairs <= 0:
        return None
    return ctx.trace.seconds(ops) / (len(ops) * pairs) * 1e12
