"""The online server models: the RoI detector and its reuse cache, and the
RoI-packed transformer serving engine."""
