"""The online server model: the RoI detector and its reuse cache."""
