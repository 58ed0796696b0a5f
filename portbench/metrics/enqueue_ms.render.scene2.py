"""The host's time in the render call (render_image_cuda with its uint8
conversion and copy enqueued), per frame, in scene2 cells, whose device
idles most of the window."""

from portbench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "render")
