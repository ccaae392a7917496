"""The training loop (``train.loop``)."""
