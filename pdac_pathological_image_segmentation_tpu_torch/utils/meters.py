"""Meters and early stopping (the JAX package's ``utils/meters.py``).

Early stop, reference semantics (``util.py:29-47``): an epoch counts as no
improvement when ``val_score < best + delta``; ``patience`` such epochs in
a row set ``early_stop``.  ``delta`` raises the bar: a score must beat the
best by at least ``delta`` to reset the count (the reference uses 0.02).
"""

from __future__ import annotations

from typing import Optional


class AverageMeter:
    """Running value/sum/count/average (reference ``util.py:50-64``)."""

    def __init__(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += self.val * n
        self.count += n
        self.avg = self.sum / self.count


class EarlyStop:
    def __init__(self, patience: int = 5, delta: float = 0.0) -> None:
        self.patience = patience
        self.delta = delta
        self.best_score: Optional[float] = None
        self.counter = 0
        self.early_stop = False

    def __call__(self, val_score: float) -> None:
        val_score = float(val_score)
        if self.best_score is None:
            self.best_score = val_score
        elif val_score < self.best_score + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = val_score
            self.counter = 0

    def state_dict(self) -> dict:
        return {"patience": self.patience, "delta": self.delta,
                "best_score": self.best_score, "counter": self.counter,
                "early_stop": self.early_stop}

    def load_state_dict(self, d: dict) -> None:
        self.patience = int(d["patience"])
        self.delta = float(d["delta"])
        self.best_score = d["best_score"]
        self.counter = int(d["counter"])
        self.early_stop = bool(d["early_stop"])
