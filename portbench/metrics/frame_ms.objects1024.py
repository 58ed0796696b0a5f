"""The window's frame_ms, reported per layer, in objects1024.render: two
samples a 1920x1080 frame over 1,024 objects, which the card paces; no time
holds a bound in the benchmark yet."""

from portbench.readers import reading


def read(ctx):
    return reading(ctx, "frame_ms")
