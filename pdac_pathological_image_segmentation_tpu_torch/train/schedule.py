"""ReduceLROnPlateau with the reference's hyperparameters (the JAX
package's ``train/schedule.py``).

Reference (``train_worker.py:236-244``): mode="max", factor=0.5,
patience=2, threshold=1e-4 in absolute mode, min_lr=1e-10, stepped once
per epoch on the validation score.  An epoch is "bad" unless
``value > best + threshold``; more than ``patience`` bad epochs in a row
multiply the rate by ``factor`` and reset the count.  This is a copy, not
``torch.optim.lr_scheduler.ReduceLROnPlateau``, whose default threshold
mode is relative.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(self, init_lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 2, threshold: float = 1e-4,
                 min_lr: float = 1e-10) -> None:
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be max or min, got {mode!r}")
        self.lr = float(init_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = -float("inf") if mode == "max" else float("inf")
        self.num_bad_epochs = 0

    def _is_better(self, value: float) -> bool:
        if self.mode == "max":
            return value > self.best + self.threshold
        return value < self.best - self.threshold

    def step(self, value: float) -> float:
        """Update on the epoch's validation score; the (possibly reduced)
        learning rate."""
        value = float(value)
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
