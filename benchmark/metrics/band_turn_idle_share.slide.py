"""The card's idle while the runner turns from one band to the next: its
plan, the wait for the next band, the finished band's fetch to the host
and the writes into the host maps (``wsi.plan``, ``wsi.band.wait``,
``wsi.band.fetch``, ``wsi.band.write``), as a share of the traced slide
window, in %."""

from benchmark.spans import idle_share


def read(summary):
    return idle_share(summary, ("wsi.plan", "wsi.band.wait",
                                "wsi.band.fetch", "wsi.band.write"))
