"""Command-line entry points of the port (``python -m ...cli.export`` /
``...cli.serve``)."""
