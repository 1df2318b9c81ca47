"""The card's idle while the runner stitches a batch into the band's
canvases (``wsi.batch.stitch`` the innermost open span on the window's
thread), as a share of the traced slide window, in %."""

from benchmark.spans import idle_share


def read(summary):
    return idle_share(summary, ("wsi.batch.stitch",))
