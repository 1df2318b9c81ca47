"""Inference of the port: artifacts, the HTTP daemon, evaluation and
whole-slide runners."""
