"""The fleet runtime: the cold and the delta-gated fleet step."""
