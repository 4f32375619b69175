"""Command-line entry points of the PyTorch port (run with ``python -m``)."""
