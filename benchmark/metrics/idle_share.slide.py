"""The card's idle share over the traced slide window: 1 − the union of
its operations' intervals over the window's length, in %."""


def read(summary):
    if not summary.get("window_s") or "windows" not in summary["work"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
