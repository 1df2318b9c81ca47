"""The card's idle while the runner issues a batch: cutting its windows
and launching the step (``wsi.batch.cut``, ``wsi.batch.infer``), as a
share of the traced slide window, in %."""

from benchmark.spans import idle_share


def read(summary):
    return idle_share(summary, ("wsi.batch.cut", "wsi.batch.infer"))
