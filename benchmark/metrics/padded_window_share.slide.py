"""Windows run through the model only to be dropped: the runner's batches
in the traced window (``wsi.batch.infer`` calls) at the traffic's batch,
less the slides' windows, over the windows run, in %."""


def read(summary):
    calls = (summary.get("spans") or {}).get("wsi.batch.infer", {}).get(
        "calls")
    if not calls or not summary["work"].get("windows"):
        return None
    run = calls * summary["traffic"]["batch"]
    return 100.0 * (run - summary["work"]["windows"]) / run
