"""Tensor ops of the port: the hand-written GroupNorm+ReLU kernel and the
resize helpers, stitching and tissue masks."""
