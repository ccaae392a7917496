"""The dense/vlm transformer: layers, parameters, forward passes, model API."""
